"""crocoddyl_tpu_torch — the PyTorch/CUDA port of crocoddyl_tpu.

It carries the rigid-body node (``RigidBodyNode``: free or contact
dynamics with point or placement contacts, armature, Euler or RK4, with
closed-form derivatives for every structure), the robot models (ANYmal B,
the programmatic quadruped, the biped, the humanoid, the quadrotor, the
pendulum, double pendulum, cart-pole and 7-DoF arm), the gait factories
(the quadruped's walking, trotting, pacing, bounding, jumping and CoM
problems; the biped's walk, squat, balance, jump and CoM problems, with
the CoP support costs of the thesis), the RH5 analysis (CoPs, ZMPs, the
CSV log), the MPC horizon rotation and warm-start shift, the unicycle and
LQR models, the batch-native ``solve_batch`` over three hand-written CUDA
kernels (node linearization, Riccati backward pass, trial rollout) and the
single-problem ``solve``: FDDP, DDP and their box-constrained variants,
the parallel and the sequential line search, the trace, over the node
kernel for every stack whose structure it admits (the other stacks give
their own derivatives) and, where the problem's structure admits them and
``fused_scans=True`` asks for them, two more (the single-problem Riccati
pass and trial rollout), and over the generic passes otherwise, with a
plain PyTorch version of each kernel for CPU tensors.  Both entry points
run on the CUDA device unless the caller passes ``device="cpu"``.  The
package imports no JAX.
"""

from .core.action import (ActionModel, NodeDerivs, replicate_model,
                          stack_models)
from .core.manifolds import StateVector
from .core.mpc import circular_append, shift_warm_start
from .core.problem import ShootingProblem
from .core.solvers.fddp import (Solution, SolverSettings, Trace,
                                box_ddp_settings, box_fddp_settings,
                                ddp_settings, fddp_settings, polish, solve)
from .core.solvers.fddp_batch import solve_batch
from .dynamics import robots
from .dynamics.robots import (arm7, biped, cartpole, double_pendulum,
                              humanoid, pendulum, quadrotor)
from .models.multibody.costs import CostFramePlacement, CostFrameRotation
from .models.multibody.nodes import CostStack, RigidBodyNode

__all__ = ["ActionModel", "CostFramePlacement", "CostFrameRotation",
           "CostStack", "NodeDerivs", "RigidBodyNode", "ShootingProblem",
           "Solution", "SolverSettings", "StateVector", "Trace", "arm7",
           "biped", "box_ddp_settings", "box_fddp_settings", "cartpole",
           "circular_append", "ddp_settings", "double_pendulum",
           "fddp_settings", "humanoid", "pendulum", "polish", "quadrotor",
           "replicate_model", "robots", "shift_warm_start", "solve",
           "solve_batch", "stack_models"]
