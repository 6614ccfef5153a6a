"""Robot models (port of crocoddyl_tpu/dynamics/robots.py): the fixed-base
pendulum, double pendulum, cart-pole and 7-DoF arm, ANYmal B from its URDF,
the programmatic ANYmal-style quadruped, the quadrotor with its thrust
map, and the Talos-like biped and humanoid."""

from __future__ import annotations

import os

import numpy as np
import torch

from .model import JointType, ModelBuilder, RobotModel


def pendulum(dtype=torch.float64) -> RobotModel:
    b = ModelBuilder(dtype=dtype)
    j = b.add_joint(JointType.REVOLUTE, -1, "joint1", axis=(0, 1, 0),
                    mass=1.0, com=(0.0, 0.0, -0.5),
                    inertia=np.diag([0.01, 0.01, 0.01]), effort_lim=20.0)
    b.add_frame("tip", j, placement_p=np.array([0.0, 0.0, -1.0]))
    return b.build()


def double_pendulum(dtype=torch.float64) -> RobotModel:
    """Two-link pendulum (robots.py:26-39)."""
    b = ModelBuilder(dtype=dtype)
    j1 = b.add_joint(JointType.REVOLUTE, -1, "joint1", axis=(0, 1, 0),
                     mass=1.0, com=(0.0, 0.0, -0.25),
                     inertia=np.diag([0.02, 0.02, 0.002]), effort_lim=20.0)
    j2 = b.add_joint(JointType.REVOLUTE, j1, "joint2", axis=(0, 1, 0),
                     placement_p=np.array([0.0, 0.0, -0.5]),
                     mass=1.0, com=(0.0, 0.0, -0.25),
                     inertia=np.diag([0.02, 0.02, 0.002]), effort_lim=20.0)
    b.add_frame("tip", j2, placement_p=np.array([0.0, 0.0, -0.5]))
    return b.build()


def cartpole(dtype=torch.float64) -> RobotModel:
    b = ModelBuilder(dtype=dtype)
    cart = b.add_joint(JointType.PRISMATIC, -1, "slider", axis=(1, 0, 0),
                       mass=1.0, com=(0, 0, 0),
                       inertia=np.diag([0.1, 0.1, 0.1]))
    pole = b.add_joint(JointType.REVOLUTE, cart, "pole", axis=(0, 1, 0),
                       mass=0.1, com=(0.0, 0.0, 0.5),
                       inertia=np.diag([0.005, 0.005, 0.0005]))
    b.add_frame("pole_tip", pole, placement_p=np.array([0.0, 0.0, 1.0]))
    return b.build()


def arm7(dtype=torch.float64) -> RobotModel:
    """7-DoF serial arm with Talos-arm-like alternating axes and scales
    (robots.py:53-69)."""
    b = ModelBuilder(dtype=dtype)
    axes = [(0, 0, 1), (0, 1, 0), (0, 0, 1), (0, 1, 0),
            (0, 0, 1), (0, 1, 0), (1, 0, 0)]
    lengths = [0.15, 0.15, 0.25, 0.25, 0.15, 0.1, 0.1]
    masses = [2.0, 2.0, 1.5, 1.5, 1.0, 0.8, 0.5]
    parent = -1
    for i, (ax, L, m) in enumerate(zip(axes, lengths, masses)):
        parent = b.add_joint(
            JointType.REVOLUTE, parent, f"joint{i+1}", axis=ax,
            placement_p=np.array([0.0, 0.0, -L if i else 0.0]),
            mass=m, com=(0.0, 0.0, -L / 2),
            inertia=np.diag([m * L * L / 12] * 2 + [m * 0.001]),
            q_lim=(-2.5, 2.5), v_lim=3.0, effort_lim=60.0)
    b.add_frame("gripper", parent, placement_p=np.array([0.0, 0.0, -0.12]))
    return b.build()


def quadruped(dtype=torch.float64) -> RobotModel:
    """ANYmal-style quadruped: free-flyer base + 4 legs × (HAA, HFE, KFE),
    nq = 19, nv = 18 (robots.py:71-104)."""
    b = ModelBuilder(dtype=dtype)
    base = b.add_joint(JointType.FREE_FLYER, -1, "root", mass=16.0,
                       com=(0.0, 0.0, 0.0),
                       inertia=np.diag([0.25, 0.65, 0.65]))
    x, y = 0.36, 0.20
    hip_len, thigh_len, shank_len = 0.08, 0.285, 0.33
    legs = {"LF": (x, y), "RF": (x, -y), "LH": (-x, y), "RH": (-x, -y)}
    for name, (px, py) in legs.items():
        haa = b.add_joint(JointType.REVOLUTE, base, f"{name}_HAA",
                          axis=(1, 0, 0), placement_p=np.array([px, py, 0.0]),
                          mass=1.5, com=(0.0, np.sign(py) * 0.04, 0.0),
                          inertia=np.diag([0.005, 0.005, 0.005]),
                          q_lim=(-0.7, 0.7), v_lim=10.0, effort_lim=40.0)
        hfe = b.add_joint(JointType.REVOLUTE, haa, f"{name}_HFE",
                          axis=(0, 1, 0),
                          placement_p=np.array([0.0, np.sign(py) * hip_len,
                                                0.0]),
                          mass=1.1, com=(0.0, 0.0, -thigh_len / 2),
                          inertia=np.diag([0.01, 0.01, 0.002]),
                          q_lim=(-2.0, 2.0), v_lim=10.0, effort_lim=40.0)
        kfe = b.add_joint(JointType.REVOLUTE, hfe, f"{name}_KFE",
                          axis=(0, 1, 0),
                          placement_p=np.array([0.0, 0.0, -thigh_len]),
                          mass=0.4, com=(0.0, 0.0, -shank_len / 2),
                          inertia=np.diag([0.004, 0.004, 0.0005]),
                          q_lim=(-2.5, 2.5), v_lim=10.0, effort_lim=40.0)
        b.add_frame(f"{name}_FOOT", kfe,
                    placement_p=np.array([0.0, 0.0, -shank_len]))
    return b.build()


def quadruped_standing_q(model: RobotModel, height=0.5,
                         dtype=torch.float64) -> torch.Tensor:
    """A nominal standing configuration, legs bent with the feet under the
    hips (robots.py:140-151)."""
    q = np.zeros(model.nq)
    q[2] = height
    q[6] = 1.0
    for leg in range(4):
        hind = leg >= 2
        q[8 + 3 * leg] = -0.7 if hind else 0.7       # HFE
        q[9 + 3 * leg] = 1.2 if hind else -1.2       # KFE
    return torch.tensor(q, dtype=dtype)


def anymal(dtype=torch.float64) -> RobotModel:
    """ANYmal B from the vendored URDF (assets/anymal_b.urdf) through the
    native C++ parser.  nq=19, nv=18."""
    from ..io.urdf import load_urdf
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return load_urdf(os.path.join(root, "assets", "anymal_b.urdf"),
                     floating_base=True, dtype=dtype)


def anymal_standing_q(model: RobotModel, dtype=torch.float64) -> torch.Tensor:
    """example-robot-data's ANYmal 'standing' configuration: base at
    z=0.4792, HAA ±0.1 outward, front legs (HFE, KFE)=(0.7, −1.0), hind legs
    (−0.7, 1.0); leg order LF, RF, LH, RH."""
    q = np.zeros(model.nq)
    q[2] = 0.4792
    q[6] = 1.0
    legs = {"LF": (-0.1, 0.7, -1.0), "RF": (0.1, 0.7, -1.0),
            "LH": (-0.1, -0.7, 1.0), "RH": (0.1, -0.7, 1.0)}
    for i, leg in enumerate(("LF", "RF", "LH", "RH")):
        q[7 + 3 * i: 10 + 3 * i] = legs[leg]
    return torch.tensor(q, dtype=dtype)


def quadrotor(dtype=torch.float64) -> RobotModel:
    """Free-flyer quadrotor body with hector-like mass and inertia
    (robots.py:154-164); pair it with ``MultiCopterBaseActuation`` and
    :func:`quadrotor_tau_f`."""
    b = ModelBuilder(dtype=dtype)
    b.add_joint(JointType.FREE_FLYER, -1, "root", mass=1.5,
                com=(0.0, 0.0, 0.0),
                inertia=np.diag([0.0347563, 0.0458929, 0.0977]))
    b.add_frame("base_link", 0)
    return b.build()


def quadrotor_tau_f(d_cog=0.1525, cf=6.6e-5, cm=1e-6,
                    dtype=torch.float64) -> torch.Tensor:
    """(6, 4) thrust map of an X-configuration quadrotor: base wrench =
    tau_f @ u_rotors (robots.py:167-177)."""
    return torch.tensor([
        [0.0, 0.0, 0.0, 0.0],
        [0.0, 0.0, 0.0, 0.0],
        [1.0, 1.0, 1.0, 1.0],
        [0.0, d_cog, 0.0, -d_cog],
        [-d_cog, 0.0, d_cog, 0.0],
        [-cm / cf, cm / cf, -cm / cf, cm / cf],
    ], dtype=dtype)


def _legs(b: ModelBuilder, base: int) -> None:
    """Two 6-joint legs (hip z/x/y, knee, ankle y/x) under ``base``, each
    ending in a ``*_sole`` frame (robots.py:190-226)."""
    for name, sy in (("left", 1.0), ("right", -1.0)):
        hz = b.add_joint(JointType.REVOLUTE, base, f"{name}_hip_z",
                         axis=(0, 0, 1),
                         placement_p=np.array([0.0, 0.09 * sy, -0.1]),
                         mass=1.0, com=(0, 0, 0), inertia=np.diag([0.01] * 3),
                         q_lim=(-0.8, 0.8), effort_lim=100.0)
        hx = b.add_joint(JointType.REVOLUTE, hz, f"{name}_hip_x",
                         axis=(1, 0, 0), mass=1.0, com=(0, 0, 0),
                         inertia=np.diag([0.01] * 3), q_lim=(-0.6, 0.6),
                         effort_lim=100.0)
        hy = b.add_joint(JointType.REVOLUTE, hx, f"{name}_hip_y",
                         axis=(0, 1, 0), mass=3.0, com=(0.0, 0.0, -0.2),
                         inertia=np.diag([0.04, 0.04, 0.01]),
                         q_lim=(-2.0, 0.7), effort_lim=100.0)
        kn = b.add_joint(JointType.REVOLUTE, hy, f"{name}_knee",
                         axis=(0, 1, 0),
                         placement_p=np.array([0.0, 0.0, -0.38]),
                         mass=2.0, com=(0.0, 0.0, -0.19),
                         inertia=np.diag([0.03, 0.03, 0.005]),
                         q_lim=(0.0, 2.6), effort_lim=100.0)
        ay = b.add_joint(JointType.REVOLUTE, kn, f"{name}_ankle_y",
                         axis=(0, 1, 0),
                         placement_p=np.array([0.0, 0.0, -0.38]),
                         mass=0.8, com=(0.0, 0.0, -0.04),
                         inertia=np.diag([0.005] * 3), q_lim=(-1.3, 0.8),
                         effort_lim=100.0)
        ax = b.add_joint(JointType.REVOLUTE, ay, f"{name}_ankle_x",
                         axis=(1, 0, 0), mass=0.6, com=(0.02, 0.0, -0.06),
                         inertia=np.diag([0.003] * 3), q_lim=(-0.5, 0.5),
                         effort_lim=100.0)
        b.add_frame(f"{name}_sole", ax,
                    placement_p=np.array([0.02, 0.0, -0.10]))


def _bent_legs(q: np.ndarray) -> None:
    """Hip y −0.4, knee 0.8, ankle y −0.4 on both legs."""
    for leg in range(2):
        q[9 + 6 * leg: 12 + 6 * leg] = (-0.4, 0.8, -0.4)


def biped(dtype=torch.float64) -> RobotModel:
    """Talos-like biped lower body: free flyer + 2 legs × 6 joints, nq = 19,
    nv = 18, soles ``right_sole`` and ``left_sole`` (robots.py:180-228)."""
    b = ModelBuilder(dtype=dtype)
    base = b.add_joint(JointType.FREE_FLYER, -1, "root", mass=30.0,
                       com=(0.0, 0.0, 0.1),
                       inertia=np.diag([1.0, 1.0, 0.5]))
    _legs(b, base)
    return b.build()


def biped_standing_q(model: RobotModel, height=0.88,
                     dtype=torch.float64) -> torch.Tensor:
    """Standing with bent legs, base at ``height`` (robots.py:231-240)."""
    q = np.zeros(model.nq)
    q[2] = height
    q[6] = 1.0
    _bent_legs(q)
    return torch.tensor(q, dtype=dtype)


def humanoid(dtype=torch.float64) -> RobotModel:
    """Talos-like humanoid: the biped's legs, a torso joint and two 4-DoF
    arms ending in ``*_gripper`` frames; nq = 28, nv = 27
    (robots.py:242-303)."""
    b = ModelBuilder(dtype=dtype)
    base = b.add_joint(JointType.FREE_FLYER, -1, "root", mass=15.0,
                       com=(0.0, 0.0, 0.05),
                       inertia=np.diag([0.4, 0.4, 0.25]))
    _legs(b, base)
    torso = b.add_joint(JointType.REVOLUTE, base, "torso_z", axis=(0, 0, 1),
                        placement_p=np.array([0.0, 0.0, 0.15]),
                        mass=8.0, com=(0.0, 0.0, 0.15),
                        inertia=np.diag([0.2, 0.2, 0.1]), q_lim=(-1.2, 1.2),
                        effort_lim=100.0)
    for name, sy in (("left", 1.0), ("right", -1.0)):
        s1 = b.add_joint(JointType.REVOLUTE, torso, f"{name}_shoulder_y",
                         axis=(0, 1, 0),
                         placement_p=np.array([0.0, 0.2 * sy, 0.3]),
                         mass=1.0, com=(0.0, 0.0, -0.1),
                         inertia=np.diag([0.01] * 3), q_lim=(-2.5, 2.5),
                         effort_lim=50.0)
        s2 = b.add_joint(JointType.REVOLUTE, s1, f"{name}_shoulder_x",
                         axis=(1, 0, 0), mass=0.8, com=(0.0, 0.0, -0.1),
                         inertia=np.diag([0.008] * 3), q_lim=(-2.0, 2.0),
                         effort_lim=50.0)
        s3 = b.add_joint(JointType.REVOLUTE, s2, f"{name}_shoulder_z",
                         axis=(0, 0, 1),
                         placement_p=np.array([0.0, 0.0, -0.15]),
                         mass=0.8, com=(0.0, 0.0, -0.08),
                         inertia=np.diag([0.006] * 3), q_lim=(-2.0, 2.0),
                         effort_lim=50.0)
        el = b.add_joint(JointType.REVOLUTE, s3, f"{name}_elbow",
                         axis=(0, 1, 0),
                         placement_p=np.array([0.0, 0.0, -0.15]),
                         mass=0.6, com=(0.0, 0.0, -0.12),
                         inertia=np.diag([0.005] * 3), q_lim=(-2.3, 0.1),
                         effort_lim=50.0)
        b.add_frame(f"{name}_gripper", el,
                    placement_p=np.array([0.0, 0.0, -0.25]))
    return b.build()


def humanoid_standing_q(model: RobotModel, height=0.88,
                        dtype=torch.float64) -> torch.Tensor:
    """Standing with bent legs and elbows at −0.8 (robots.py:306-320)."""
    q = np.zeros(model.nq)
    q[2] = height
    q[6] = 1.0
    _bent_legs(q)
    for arm in range(2):
        q[7 + 12 + 1 + 4 * arm + 3] = -0.8   # elbow, after the torso joint
    return torch.tensor(q, dtype=dtype)
