"""Locomotion problem factories (port of crocoddyl_tpu/apps/gaits.py:
``_LocomotionFactory``, ``QuadrupedGaitFactory`` and ``BipedGaitFactory``):
the CoM shift, the jump, the quadruped's walking, trotting, pacing and
bounding gaits, and the biped's walk, squat and single-leg balance.

Every rigid-body knot shares ONE structure — a RigidBodyNode with the
full maximal contact set and cost stack — and per-knot differences
(contact activity, task references, weights, dt) are tensor leaves;
``stack_models`` stacks consecutive knots of one type into a segment.
Foot switches are pseudo-impulse knots (dt=0, boosted weights) by default,
which keeps a problem to one segment; with ``pseudo_impulse=False`` they
are true impact knots (``ImpulseNode``), and the problem is a tuple of
rigid-body and impulse segments.  A factory with
``contact_dim = 6`` (the biped) gives placement contacts and placement
foot tasks, and with ``cop_box = (length, width)`` a CoP support cost on
every supporting foot: the CoP-constrained DDP of the thesis.  Everything
is built in float64 on the host; ``tree_map`` moves the problem to a
device or dtype.
"""

from __future__ import annotations

from itertools import groupby
from typing import List, Sequence

import numpy as np
import torch

from ..core.action import stack_models
from ..core.problem import ShootingProblem
from ..dynamics import algorithms as algo
from ..dynamics.model import RobotModel
from ..dynamics.states import StateMultibody
from ..models.multibody.activations import (
    ActivationQuad, ActivationQuadraticBarrier, ActivationWeightedQuad)
from ..models.multibody.actuations import FloatingBaseActuation
from ..models.multibody.contacts import Contact3D, Contact6D, ContactSet
from ..models.multibody.costs import (
    CostCoM, CostContactCoP, CostContactFrictionCone, CostControl,
    CostFramePlacement, CostFrameTranslation, CostFrameVelocity, CostState)
from ..models.multibody.frames import cop_support, friction_cone
from ..models.multibody.nodes import CostStack, ImpulseNode, RigidBodyNode


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float64))


def _fk_positions(model: RobotModel, q, fids):
    """World positions of frames (numpy out)."""
    oMi, _ = algo.forward_kinematics(model, torch.as_tensor(q))
    return [algo.frame_placement(model, oMi, f).p.numpy().copy()
            for f in fids]


class _LocomotionFactory:
    contact_gains = (0.0, 50.0)   # Baumgarte (Kp, Kv)
    contact_dim = 3               # 3: point contact, 6: placement contact
    w_com = 1e6
    w_foot_track = 1e6
    w_foot_track_switch = 1e7
    w_impulse_vel = 1e6
    w_friction = 1e1
    w_state_reg = 1e1
    w_ctrl = 1e-1
    w_ctrl_switch = 1e-3
    w_state_bounds = 0.0
    w_cop = 1e3
    cop_box = None                # (length, width): CoP costs (6D only)

    def __init__(self, model: RobotModel, foot_names: Sequence[str],
                 mu: float = 0.7, default_q=None):
        self.model = model
        self.state = StateMultibody(model=model)
        self.feet = [model.frame_id(n) for n in foot_names]
        self.nfeet = len(self.feet)
        self.mu = mu
        self.cone = friction_cone((0., 0., 1.), mu, nf=4, inner_appr=False)
        nv = model.nv
        q0 = np.asarray(default_q if default_q is not None
                        else model.neutral())
        self.default_state = np.concatenate([q0, np.zeros(nv)])
        self.first_step = True
        self._default_foot_pos = _fk_positions(model, q0, self.feet)

    def _state_weights_running(self):
        nv = self.model.nv
        return np.array([0.] * 3 + [500.] * 3 + [0.01] * (nv - 6)
                        + [10.] * 6 + [1.] * (nv - 6))

    def _state_weights_switch(self):
        nv = self.model.nv
        return np.array([0.] * 3 + [500.] * 3 + [0.01] * (nv - 6)
                        + [10.] * nv)

    def _state_bounds(self):
        m = self.model
        inf = np.inf
        q_lb = np.concatenate([[-inf] * 6, m.q_lb.numpy()[7:]])
        q_ub = np.concatenate([[inf] * 6, m.q_ub.numpy()[7:]])
        v_l = m.v_limit.numpy()
        return (np.concatenate([q_lb, -v_l]), np.concatenate([q_ub, v_l]))

    def _make_contact(self, fid, foot_pos0, on):
        """A point contact at the world origin, or a placement contact at
        the foot's default placement (gaits.py:118-126)."""
        if self.contact_dim == 3:
            return Contact3D(fid=fid, pref=_t(np.zeros(3)),
                             gains=_t(self.contact_gains), active=_t(on))
        return Contact6D(fid=fid, ref_R=_t(np.eye(3)), ref_p=_t(foot_pos0),
                         gains=_t(self.contact_gains), active=_t(on))

    def _make_foot_track_cost(self, fid, ref, w, active):
        """Foot translation task, or placement task with an identity
        rotation (gaits.py:128-136)."""
        if self.contact_dim == 3:
            return CostFrameTranslation(
                fid=fid, pref=_t(ref), activation=ActivationQuad(),
                weight=_t(w), active=_t(active))
        return CostFramePlacement(
            fid=fid, ref_R=_t(np.eye(3)), ref_p=_t(ref),
            activation=ActivationQuad(), weight=_t(w), active=_t(active))

    def _make_node(self, dt, support, com_task=None, foot_tasks=None,
                   switch=False):
        """One knot (quadruped.py createSwingFootModel /
        createPseudoImpulseModel; gaits.py:138-231)."""
        foot_tasks = foot_tasks or {}
        support = set(support)
        nu = self.model.nv - 6
        contacts, cone_costs, track_costs, vel_costs = [], [], [], []
        cop_costs = []
        for i, fid in enumerate(self.feet):
            on = 1.0 if i in support else 0.0
            contacts.append(self._make_contact(fid, self._default_foot_pos[i],
                                               on))
            cone_costs.append(CostContactFrictionCone(
                contact_idx=i, cone=self.cone,
                activation=ActivationQuadraticBarrier(lb=self.cone.lb,
                                                      ub=self.cone.ub),
                weight=_t(self.w_friction), active=_t(on)))
            if self.cop_box is not None and self.contact_dim == 6:
                # the thesis cost: A·f ≥ 0 on every supporting foot
                cop_costs.append(CostContactCoP(
                    contact_idx=i, support=cop_support(*self.cop_box),
                    activation=ActivationQuadraticBarrier(
                        lb=_t(np.zeros(4)), ub=_t(np.full(4, np.inf))),
                    weight=_t(self.w_cop), active=_t(on)))
            tracked = i in foot_tasks
            w_track = self.w_foot_track_switch if switch else self.w_foot_track
            track_costs.append(self._make_foot_track_cost(
                fid, foot_tasks.get(i, np.zeros(3)), w_track,
                1.0 if tracked else 0.0))
            vel_costs.append(CostFrameVelocity(
                fid=fid, vref=_t(np.zeros(6)), activation=ActivationQuad(),
                weight=_t(self.w_impulse_vel),
                active=_t(1.0 if (switch and tracked) else 0.0)))

        sw = (self._state_weights_switch() if switch
              else self._state_weights_running())
        items = [
            CostCoM(cref=_t(com_task if com_task is not None else np.zeros(3)),
                    activation=ActivationQuad(), weight=_t(self.w_com),
                    active=_t(1.0 if com_task is not None else 0.0)),
            *track_costs, *vel_costs, *cone_costs, *cop_costs,
            CostState(xref=_t(self.default_state),
                      activation=ActivationWeightedQuad(weights=_t(sw ** 2)),
                      weight=_t(self.w_state_reg), active=_t(1.0)),
            CostControl(uref=_t(np.zeros(nu)), activation=ActivationQuad(),
                        weight=_t(self.w_ctrl_switch if switch
                                  else self.w_ctrl),
                        active=_t(1.0)),
        ]
        if self.w_state_bounds > 0.0:
            lb, ub = self._state_bounds()
            items.append(CostState(
                xref=_t(np.concatenate([self.model.neutral().numpy(),
                                        np.zeros(self.model.nv)])),
                activation=ActivationQuadraticBarrier(lb=_t(lb), ub=_t(ub)),
                weight=_t(self.w_state_bounds), active=_t(1.0)))
        return RigidBodyNode(
            state_=self.state,
            actuation=FloatingBaseActuation(nv=self.model.nv),
            costs=CostStack(items=tuple(items)),
            contacts=ContactSet(contacts=tuple(contacts)),
            dt=_t(float(dt)))

    def _make_impulse_node(self, support, foot_tasks):
        """The true impulse switch knot (gaits.py:233-262; quadruped.py
        createImpulseModel): an impact over the landing feet, the
        switch-weight foot tracking of the swing feet and the switch-weight
        state regularization."""
        foot_tasks = foot_tasks or {}
        support = set(support)
        impulses, track_costs = [], []
        for i, fid in enumerate(self.feet):
            impulses.append(self._make_contact(
                fid, self._default_foot_pos[i], 1.0 if i in support else 0.0))
            tracked = i in foot_tasks
            track_costs.append(self._make_foot_track_cost(
                fid, foot_tasks.get(i, np.zeros(3)), self.w_foot_track_switch,
                1.0 if tracked else 0.0))
        sw = self._state_weights_switch()
        items = (*track_costs,
                 CostState(xref=_t(self.default_state),
                           activation=ActivationWeightedQuad(
                               weights=_t(sw ** 2)),
                           weight=_t(self.w_state_reg), active=_t(1.0)))
        return ImpulseNode(state_=self.state,
                           impulses=ContactSet(contacts=tuple(impulses)),
                           costs=CostStack(items=items),
                           nu_=self.model.nv - 6, r_coeff=_t(0.0))

    def _footstep_models(self, com_pos0, feet_pos0, step_length, step_height,
                         dt, num_knots, support, swing,
                         pseudo_impulse=True) -> List:
        """Swing-phase knots + the foot switch (quadruped.py
        createFootstepModels; gaits.py:265-300): a pseudo-impulse knot, or
        with ``pseudo_impulse=False`` a true impulse knot over the support
        and the landing feet."""
        num_legs = len(support) + len(swing)
        com_pct = float(len(swing)) / num_legs
        models = []
        ph_knots = num_knots / 2.0
        last_tasks = {}
        for k in range(num_knots):
            tasks = {}
            for i, p in zip(swing, feet_pos0):
                if k < ph_knots:
                    dp = np.array([step_length * (k + 1) / num_knots, 0.,
                                   step_height * k / ph_knots])
                elif k == ph_knots:
                    dp = np.array([step_length * (k + 1) / num_knots, 0.,
                                   step_height])
                else:
                    dp = np.array([step_length * (k + 1) / num_knots, 0.,
                                   step_height
                                   * (1 - (k - ph_knots) / ph_knots)])
                tasks[i] = p + dp
            com_task = (np.array([step_length * (k + 1) / num_knots, 0., 0.])
                        * com_pct + com_pos0)
            models.append(self._make_node(dt, support, com_task=com_task,
                                          foot_tasks=tasks))
            last_tasks = tasks
        if pseudo_impulse:
            models.append(self._make_node(0.0, support,
                                          foot_tasks=last_tasks, switch=True))
        else:
            models.append(self._make_impulse_node(set(support) | set(swing),
                                                  last_tasks))
        com_pos0 += np.array([step_length * com_pct, 0., 0.])
        for p in feet_pos0:
            p += np.array([step_length, 0., 0.])
        return models

    def _problem(self, x0, models) -> ShootingProblem:
        """Consecutive knots of one type stacked into a segment
        (gaits.py:305-312): one segment, or a tuple of them."""
        segments = tuple(stack_models(list(grp))
                         for _, grp in groupby(models, key=type))
        return ShootingProblem(
            x0=torch.as_tensor(x0),
            running=segments[0] if len(segments) == 1 else segments,
            terminal=models[-1])

    def _com_ref(self, q0):
        pos = _fk_positions(self.model, q0, self.feet)
        com_ref = np.mean(pos, axis=0)
        com_ref[2] = float(algo.center_of_mass(self.model,
                                               torch.as_tensor(q0))[2])
        return com_ref, pos

    def com_problem(self, x0, com_go_to: float, dt: float, num_knots: int,
                    forward_back: bool = True) -> ShootingProblem:
        """CoM shift task on all feet (gaits.py:322-337)."""
        x0 = np.asarray(x0)
        com0 = algo.center_of_mass(
            self.model, torch.as_tensor(x0[:self.model.nq])).numpy()
        allfeet = range(self.nfeet)
        models = [self._make_node(dt, allfeet) for _ in range(num_knots)]
        models.append(self._make_node(
            dt, allfeet, com_task=com0 + np.array([com_go_to, 0., 0.])))
        if forward_back:
            models += [self._make_node(dt, allfeet) for _ in range(num_knots)]
            models.append(self._make_node(
                dt, allfeet, com_task=com0 + np.array([-com_go_to, 0., 0.])))
        return self._problem(x0, models)

    def jumping_problem(self, x0, jump_height: float, jump_length,
                        dt: float, ground_knots: int,
                        flying_knots: int) -> ShootingProblem:
        """Takeoff, flight with every contact inactive, a pseudo-impulse
        landing and the landed phase (gaits.py:339-366)."""
        x0 = np.asarray(x0)
        com_ref, pos = self._com_ref(x0[:self.model.nq])
        jump_length = np.asarray(jump_length, float)
        df = jump_length[2] - pos[0][2]
        pos = [np.array([p[0], p[1], 0.0]) for p in pos]
        allfeet = list(range(self.nfeet))
        models = [self._make_node(dt, allfeet) for _ in range(ground_knots)]
        for k in range(flying_knots):
            ct = (np.array([jump_length[0], jump_length[1],
                            jump_length[2] + jump_height])
                  * (k + 1) / flying_knots + com_ref)
            models.append(self._make_node(dt, [], com_task=ct))
        models += [self._make_node(dt, []) for _ in range(flying_knots)]
        foot_tasks = {i: pos[i] + jump_length for i in allfeet}
        models.append(self._make_node(0.0, allfeet, foot_tasks=foot_tasks,
                                      switch=True))
        f0 = jump_length.copy()
        f0[2] = df
        models += [self._make_node(dt, allfeet, com_task=com_ref + f0)
                   for _ in range(ground_knots)]
        return self._problem(x0, models)


class QuadrupedGaitFactory(_LocomotionFactory):
    """Feet order must be (LF, RF, LH, RH)."""

    contact_gains = (0.0, 50.0)
    w_state_bounds = 1e3

    def walking_problem(self, x0, step_length, step_height, dt,
                        step_knots, support_knots,
                        pseudo_impulse=True) -> ShootingProblem:
        """One walking cycle: 2×[double support + 2 footsteps]; footfall
        order RH, RF, LH, LF (gaits.py:379-401); true impulse switch knots
        with ``pseudo_impulse=False``."""
        x0 = np.asarray(x0)
        com_ref, (lf, rf, lh, rh) = self._com_ref(x0[:self.model.nq])
        LF, RF, LH, RH = 0, 1, 2, 3
        first = 0.5 if self.first_step else 1.0
        self.first_step = False
        allfeet = range(self.nfeet)
        models = [self._make_node(dt, allfeet) for _ in range(support_knots)]
        models += self._footstep_models(com_ref, [rh], first * step_length,
                                        step_height, dt, step_knots,
                                        [LF, RF, LH], [RH], pseudo_impulse)
        models += self._footstep_models(com_ref, [rf], first * step_length,
                                        step_height, dt, step_knots,
                                        [LF, LH, RH], [RF], pseudo_impulse)
        models += [self._make_node(dt, allfeet) for _ in range(support_knots)]
        models += self._footstep_models(com_ref, [lh], step_length,
                                        step_height, dt, step_knots,
                                        [LF, RF, RH], [LH], pseudo_impulse)
        models += self._footstep_models(com_ref, [lf], step_length,
                                        step_height, dt, step_knots,
                                        [RF, LH, RH], [LF], pseudo_impulse)
        return self._problem(x0, models)

    def _pairs_problem(self, x0, step_length, step_height, dt, step_knots,
                       support_knots, first_pair, second_pair, half_first):
        """Two phases, each a double support and one step of a pair of
        feet (the other pair in support), the first pair's step halved on
        a factory's first gait when ``half_first``."""
        x0 = np.asarray(x0)
        com_ref, feet = self._com_ref(x0[:self.model.nq])
        first = 1.0
        if half_first:
            first = 0.5 if self.first_step else 1.0
            self.first_step = False
        allfeet = range(self.nfeet)
        models = []
        for pair, length in ((first_pair, first * step_length),
                             (second_pair, step_length)):
            support = [i for i in allfeet if i not in pair]
            models += [self._make_node(dt, allfeet)
                       for _ in range(support_knots)]
            models += self._footstep_models(
                com_ref, [feet[i] for i in pair], length, step_height, dt,
                step_knots, support, list(pair))
        return self._problem(x0, models)

    def trotting_problem(self, x0, step_length, step_height, dt,
                         step_knots, support_knots) -> ShootingProblem:
        """Diagonal pairs RF+LH, then LF+RH (gaits.py:404-421)."""
        return self._pairs_problem(x0, step_length, step_height, dt,
                                   step_knots, support_knots, (1, 2), (0, 3),
                                   half_first=True)

    def pacing_problem(self, x0, step_length, step_height, dt,
                       step_knots, support_knots) -> ShootingProblem:
        """Lateral pairs RF+RH, then LF+LH (gaits.py:423-440)."""
        return self._pairs_problem(x0, step_length, step_height, dt,
                                   step_knots, support_knots, (1, 3), (0, 2),
                                   half_first=True)

    def bounding_problem(self, x0, step_length, step_height, dt,
                         step_knots, support_knots) -> ShootingProblem:
        """Front pair LF+RF, then hind pair LH+RH, full steps
        (gaits.py:442-457)."""
        return self._pairs_problem(x0, step_length, step_height, dt,
                                   step_knots, support_knots, (0, 1), (2, 3),
                                   half_first=False)


class BipedGaitFactory(_LocomotionFactory):
    """SimpleBipedGaitProblem (gaits.py:460-571): feet order (right, left),
    6D sole contacts with zero Baumgarte gains, placement foot tasks."""

    contact_dim = 6
    contact_gains = (0.0, 0.0)
    w_foot_track_switch = 1e8
    w_state_bounds = 0.0

    # biped.py:204: the running knots weigh the state as the switch knots
    _state_weights_running = _LocomotionFactory._state_weights_switch

    def walking_problem(self, x0, step_length, step_height, dt,
                        step_knots, support_knots,
                        pseudo_impulse=True) -> ShootingProblem:
        """Double support, right step, double support, left step
        (gaits.py:483-504); true impulse switch knots with
        ``pseudo_impulse=False``."""
        x0 = np.asarray(x0)
        com_ref, (rf, lf) = self._com_ref(x0[:self.model.nq])
        R, L = 0, 1
        first = 0.5 if self.first_step else 1.0
        self.first_step = False
        both = (R, L)
        models = [self._make_node(dt, both) for _ in range(support_knots)]
        models += self._footstep_models(com_ref, [rf], first * step_length,
                                        step_height, dt, step_knots, [L], [R],
                                        pseudo_impulse)
        models += [self._make_node(dt, both) for _ in range(support_knots)]
        models += self._footstep_models(com_ref, [lf], step_length,
                                        step_height, dt, step_knots, [R], [L],
                                        pseudo_impulse)
        return self._problem(x0, models)

    def squat_problem(self, x0, height_change, num_knots, dt,
                      recovery_knots: int = 20) -> ShootingProblem:
        """The CoM descends ``height_change`` over the first half of the
        horizon and returns over the second, then holds the reference for
        ``recovery_knots`` knots (gaits.py:509-530)."""
        x0 = np.asarray(x0)
        com_ref, _ = self._com_ref(x0[:self.model.nq])
        both = (0, 1)
        models = []
        ph = num_knots / 2
        for k in range(num_knots):
            if k < ph:
                dz = -height_change * (k + 1) / ph
            elif k == ph:
                dz = -height_change
            else:
                dz = -height_change * (1 - (k - ph) / ph)
            models.append(self._make_node(
                dt, both, com_task=com_ref + np.array([0.0, 0.0, dz])))
        models += [self._make_node(dt, both, com_task=com_ref)
                   for _ in range(recovery_knots)]
        return self._problem(x0, models)

    def balancing_problem(self, x0, support_knots, shift_knots,
                          balance_knots, dt, lift=(0.0, -0.05, 0.05),
                          pseudo_impulse: bool = True) -> ShootingProblem:
        """Shift the CoM over the left foot, raise the right foot along
        ``lift`` and bring it back, replant it with a pseudo-impulse knot
        (a true impulse knot with ``pseudo_impulse=False``), shift the CoM
        back and hold the default pose (gaits.py:532-571)."""
        R, L = 0, 1
        x0 = np.asarray(x0)
        com_ref, (rf, lf) = self._com_ref(x0[:self.model.nq])
        both = (R, L)
        models = [self._make_node(dt, both) for _ in range(support_knots)]
        com_y = lf[1] - com_ref[1]
        for k in range(shift_knots):
            models.append(self._make_node(dt, both, com_task=com_ref
                                          + np.array([0.0, com_y * (k + 1)
                                                      / shift_knots, 0.0])))
        com_over_lf = np.array([com_ref[0], lf[1], com_ref[2]])
        lift = np.asarray(lift, np.float64)
        ph = balance_knots / 2
        for k in range(balance_knots):
            if k < ph:
                ft = rf + lift * ((k + 1) / ph)
            elif k == ph:
                ft = rf + lift
            else:
                ft = rf + lift * (1 - (k - ph) / ph)
            models.append(self._make_node(dt, (L,), com_task=com_over_lf,
                                          foot_tasks={R: ft}))
        if pseudo_impulse:
            models.append(self._make_node(0.0, both, foot_tasks={R: rf},
                                          switch=True))
        else:
            models.append(self._make_impulse_node(both, {R: rf}))
        for k in range(shift_knots):
            models.append(self._make_node(dt, both, com_task=com_ref
                                          + np.array([0.0, com_y * (1 - k
                                                      / shift_knots), 0.0])))
        models += [self._make_node(dt, both, com_task=com_ref)
                   for _ in range(support_knots)]
        return self._problem(x0, models)
