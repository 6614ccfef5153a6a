"""crocoddyl_tpu_torch — the PyTorch/CUDA port of crocoddyl_tpu.

It carries the rigid-body node (``RigidBodyNode``: free or contact
dynamics with point or placement contacts, armature, Euler or RK4, with
closed-form derivatives for every structure), the true impact knot
(``ImpulseNode``) and problems of several segments, the robot models
(ANYmal B, the programmatic quadruped, the biped, the humanoid, the
quadrotor, the pendulum, double pendulum, cart-pole and 7-DoF arm), the
gait factories (the quadruped's walking, trotting, pacing, bounding,
jumping and CoM problems; the biped's walk, squat, balance, jump and CoM
problems, with the CoP support costs of the thesis; pseudo-impulse or true
impulse foot switches), the RH5 analysis (CoPs, ZMPs, the CSV log), the
MPC horizon rotation (one segment or several) and warm-start shift, the
unicycle and LQR models, the batch-native ``solve_batch`` over three
hand-written CUDA kernels (node linearization, Riccati backward pass,
trial rollout) and the single-problem ``solve``: FDDP, DDP and their
box-constrained variants, the parallel and the sequential line search,
the trace, the multiple-shooting rollout and the associative-scan Riccati
pass, over the node kernel for every block whose structure it admits (the
other blocks give their own derivatives) and, where the problem's
structure admits them and ``fused_scans=True`` asks for them, two more
(the single-problem Riccati pass and trial rollout), and over the generic
passes otherwise, with a plain PyTorch version of each kernel for CPU
tensors.  Two oracles check it: the dense KKT step
(``core/solvers/kkt``) and finite differences (``utils/numdiff``).  Both
entry points run on the CUDA device unless the caller passes
``device="cpu"``.  ``vmap_solve`` runs ``solve`` over a batch of problems
of one structure as one program (the counterpart of ``jax.vmap(solve)``).
``parallel`` shards a batch of problems over GPUs, one process per card
(``torch.distributed``), each solving its slice as one batch; ``io.display`` renders
trajectories, ``utils.aot`` records models with ``torch.export``, and
``utils.callbacks`` prints, saves and plots solutions.  The package imports
no JAX.
"""

from .core.action import (ActionModel, NodeDerivs, replicate_model,
                          stack_models)
from .core.manifolds import StateBase, StateVector, state_vector
from .core.mpc import circular_append, rotate_segmented, shift_warm_start
from .core.problem import ShootingProblem
from .core.solvers.fddp import (Solution, SolverSettings, Trace,
                                box_ddp_settings, box_fddp_settings,
                                ddp_settings, fddp_settings, polish, solve,
                                vmap_solve)
from .core.solvers import boxqp, kkt
from .core.solvers.fddp_batch import solve_batch
from .dynamics import robots
from .dynamics.robots import (arm7, biped, cartpole, double_pendulum,
                              humanoid, pendulum, quadrotor)
from .models.multibody.costs import CostFramePlacement, CostFrameRotation
from .models.multibody.nodes import CostStack, ImpulseNode, RigidBodyNode
from . import parallel
from .utils.casting import cast_floats
from .utils.callbacks import (SolverLog, format_trace, load_solution,
                              plot_convergence, plot_oc_solution,
                              print_trace, save_solution)

__all__ = ["ActionModel", "CostFramePlacement", "CostFrameRotation",
           "CostStack", "ImpulseNode", "NodeDerivs", "RigidBodyNode",
           "ShootingProblem", "Solution", "SolverLog", "SolverSettings",
           "StateBase", "StateVector", "Trace", "arm7", "biped",
           "box_ddp_settings", "box_fddp_settings", "boxqp", "cartpole",
           "cast_floats", "circular_append", "ddp_settings",
           "double_pendulum", "fddp_settings", "format_trace", "humanoid",
           "kkt", "load_solution", "parallel", "pendulum",
           "plot_convergence", "plot_oc_solution", "polish", "print_trace",
           "quadrotor", "replicate_model", "robots", "rotate_segmented",
           "save_solution", "shift_warm_start", "solve", "solve_batch",
           "stack_models", "state_vector", "vmap_solve"]
