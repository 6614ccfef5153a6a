"""crocoddyl_tpu_torch — the PyTorch/CUDA port of crocoddyl_tpu.

It carries the FDDP solves of the ANYmal walk: robot model and state
manifold, the walking-problem factory, the batch-native ``solve_batch``
over three hand-written CUDA kernels (node linearization, Riccati backward
pass, trial rollout) and the single-problem ``solve`` (the b=1 MPC replan)
over the node kernel and two more (the single-problem Riccati pass and
trial rollout), with a plain PyTorch version of each kernel for CPU
tensors.  Both entry points run on the CUDA device unless the caller
passes ``device="cpu"``.  The package imports no JAX.
"""

from .core.action import NodeDerivs, replicate_model, stack_models
from .core.problem import ShootingProblem
from .core.solvers.fddp import Solution, SolverSettings, solve
from .core.solvers.fddp_batch import solve_batch

__all__ = ["NodeDerivs", "ShootingProblem", "Solution", "SolverSettings",
           "replicate_model", "solve", "solve_batch", "stack_models"]
