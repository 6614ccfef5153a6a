"""crocoddyl_tpu_torch — the PyTorch/CUDA port of crocoddyl_tpu.

The first slice carries the batch-native FDDP solve of the ANYmal walk:
robot model and state manifold, the walking-problem factory, and
``solve_batch`` over three hand-written CUDA kernels (node linearization,
Riccati backward pass, trial rollout) with a plain PyTorch version of
each for CPU tensors.  The package imports no JAX.
"""

from .core.action import NodeDerivs, replicate_model, stack_models
from .core.problem import ShootingProblem
from .core.solvers.fddp import Solution, SolverSettings
from .core.solvers.fddp_batch import solve_batch

__all__ = ["NodeDerivs", "ShootingProblem", "Solution", "SolverSettings",
           "replicate_model", "solve_batch", "stack_models"]
