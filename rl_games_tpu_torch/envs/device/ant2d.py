"""Ant2D — a device-resident planar quadruped, batched over envs.

Port of rl_games_tpu/envs/jax/ant2d.py. A free-floating torso (x, z,
pitch) with 4 legs × 2 hinged links: 11 generalized coordinates, 8
actuated. Equations of motion M q̈ + b = τ + J_cᵀ f_contact come from the
Lagrangian factors (lagrangian.py), fed with the kinematics' Jacobian and
J̇q̇ in closed form (``_kinematics``); ground contact is a penalty
spring-damper per foot with Coulomb-style tangential friction. Reward is
forward velocity + alive bonus − control cost; an episode terminates when
the torso falls or flips.

The JAX package unrolls an 11×11 Cholesky in scalar form to suit the TPU's
lanes; here the factorization and solves are batched library calls
(``torch.linalg.cholesky_ex`` without its error check, which would cost a
device sync per step, and ``torch.cholesky_solve``). As in the JAX package
the mass matrix and contact Jacobian are computed once per control step
and held across its integration substeps.
"""

import dataclasses

import torch

from rl_games_tpu_torch.envs.device.base import DeviceEnv
from rl_games_tpu_torch.envs.device.lagrangian import lagrangian_factors_2d
from rl_games_tpu_torch.envs.spaces import Box, EnvInfo
from rl_games_tpu_torch.utils.device import resolve_device

NQ = 11  # x, z, pitch, 4 x (hip, knee)
N_LEGS = 4
TORSO_M = 1.0
TORSO_I = 0.05
LINK_M = 0.15
LINK_L = 0.28
LINK_I = LINK_M * LINK_L**2 / 12.0
HIP_X = (-0.25, -0.08, 0.08, 0.25)  # hip attachment points along the torso
GRAVITY = 9.81
DT = 0.02
SUBSTEPS = 4
JOINT_DAMPING = 0.08
TORQUE_SCALE = 2.2
K_GROUND = 900.0
D_GROUND = 9.0
MU_FRICTION = 0.9
JOINT_LIMIT = 1.2  # rad, soft
MASSES = (TORSO_M,) + (LINK_M,) * (2 * N_LEGS)
INERTIAS = (TORSO_I,) + (LINK_I,) * (2 * N_LEGS)


def _link_frames(q, hip_x):
    """Centers and angles of the 9 bodies and the 4 foot tips, batched.

    q: [N, 11]; hip_x: [4]. Body order: torso, 4 thighs, 4 shins. Returns
    (coms [N, 9, 2], angles [N, 9], feet [N, 4, 2]).
    """
    th = q[:, 2]
    torso = q[:, 0:2]
    hip_q = q[:, 3::2]  # [N, 4]
    knee_q = q[:, 4::2]
    ca, sa = torch.cos(th), torch.sin(th)
    anchors = torso[:, None, :] + hip_x[None, :, None] * torch.stack([ca, sa], dim=-1)[:, None, :]
    a1 = th[:, None] + hip_q  # the thigh hangs at this angle from -z
    dir1 = torch.stack([torch.sin(a1), -torch.cos(a1)], dim=-1)  # [N, 4, 2]
    thigh_com = anchors + 0.5 * LINK_L * dir1
    knees = anchors + LINK_L * dir1
    a2 = a1 + knee_q
    dir2 = torch.stack([torch.sin(a2), -torch.cos(a2)], dim=-1)
    shin_com = knees + 0.5 * LINK_L * dir2
    feet = knees + LINK_L * dir2
    coms = torch.cat([torso[:, None, :], thigh_com, shin_com], dim=1)
    angles = torch.cat([th[:, None], a1, a2], dim=1)
    return coms, angles, feet


def _angle_jacobian(**f32):
    """∂(angles)/∂q, constant: the torso's pitch, then θ + hip_i, then
    θ + hip_i + knee_i."""
    J = torch.zeros((1 + 2 * N_LEGS, NQ), **f32)
    J[:, 2] = 1.0
    for i in range(N_LEGS):
        J[1 + i, 3 + 2 * i] = 1.0
        J[1 + N_LEGS + i, 3 + 2 * i:5 + 2 * i] = 1.0
    return J


def _kinematics(q, qd, hip_x, angle_jac):
    """The flattened kinematics of ``_link_frames``, its Jacobian and J̇q̇,
    in closed form for a batch: (x [N, 35], J = ∂x/∂q [N, 35, 11],
    J̇q̇ [N, 35]), x = [COMs (9 × 2), angles (9), feet (4 × 2)].

    Each leg point is P = anchor + c1·L·u(a1) + c2·L·u(a2) with
    anchor = torso + hip_x·(cos θ, sin θ), u(a) = (sin a, -cos a), a1 = θ +
    hip, a2 = a1 + knee, and (c1, c2) = (½, 0) for the thigh COM, (1, ½)
    for the shin COM, (1, 1) for the foot. Then ∂P/∂knee = c2·L·u'(a2),
    ∂P/∂hip = c1·L·u'(a1) + ∂P/∂knee, ∂P/∂θ = hip_x·(-sin θ, cos θ) +
    ∂P/∂hip, and, since u'' = -u, J̇q̇ = -(hip_x·(cos θ, sin θ)·θ̇² +
    c1·L·u(a1)·ȧ1² + c2·L·u(a2)·ȧ2²). The angles are linear in q.
    """
    n = q.shape[0]
    th, thd = q[:, 2:3], qd[:, 2:3]  # [N, 1]
    a1, a1d = th + q[:, 3::2], thd + qd[:, 3::2]  # [N, 4]
    a2, a2d = a1 + q[:, 4::2], a1d + qd[:, 4::2]
    ct, st = torch.cos(th)[..., None], torch.sin(th)[..., None]  # [N, 1, 1]
    hx = hip_x[None, :, None]
    lever = hx * torch.cat([ct, st], dim=-1)  # anchor - torso, [N, 4, 2]
    dlever = hx * torch.cat([-st, ct], dim=-1)  # its ∂/∂θ
    s1, c1_ = torch.sin(a1), torch.cos(a1)
    s2, c2_ = torch.sin(a2), torch.cos(a2)
    u1 = LINK_L * torch.stack([s1, -c1_], dim=-1)  # L·u(a1), [N, 4, 2]
    u2 = LINK_L * torch.stack([s2, -c2_], dim=-1)
    du1 = LINK_L * torch.stack([c1_, s1], dim=-1)  # L·u'(a1)
    du2 = LINK_L * torch.stack([c2_, s2], dim=-1)
    anchors = q[:, None, 0:2] + lever
    lever_acc = lever * torch.square(thd)[..., None]
    acc1, acc2 = u1 * torch.square(a1d)[..., None], u2 * torch.square(a2d)[..., None]
    leg = torch.eye(N_LEGS, dtype=q.dtype, device=q.device)[:, None, :]  # [4, 1, 4]
    base = torch.eye(2, dtype=q.dtype, device=q.device).expand(n, N_LEGS, 2, 2)

    pos, jac, acc = [], [], []
    for c1, c2 in ((0.5, 0.0), (1.0, 0.5), (1.0, 1.0)):  # thigh COM, shin COM, foot
        dknee = c2 * du2
        dhip = c1 * du1 + dknee
        joints = torch.stack([dhip[..., None] * leg, dknee[..., None] * leg], dim=-1)
        jac.append(torch.cat(
            [base, (dlever + dhip)[..., None], joints.reshape(n, N_LEGS, 2, 2 * N_LEGS)], dim=-1
        ))  # [N, 4, 2, 11]
        pos.append(anchors + c1 * u1 + c2 * u2)
        acc.append(-(lever_acc + c1 * acc1 + c2 * acc2))

    torso_jac = torch.eye(2, NQ, dtype=q.dtype, device=q.device).expand(n, 1, 2, NQ)
    zeros = torch.zeros_like(q[:, None, 0:2])
    x = torch.cat([
        torch.cat([q[:, None, 0:2], pos[0], pos[1]], dim=1).reshape(n, -1),
        th, a1, a2,
        pos[2].reshape(n, -1),
    ], dim=-1)
    J = torch.cat([
        torch.cat([torso_jac, jac[0], jac[1]], dim=1).reshape(n, -1, NQ),
        angle_jac.expand(n, -1, -1),
        jac[2].reshape(n, -1, NQ),
    ], dim=1)
    a = torch.cat([
        torch.cat([zeros, acc[0], acc[1]], dim=1).reshape(n, -1),
        torch.zeros_like(x[:, :1 + 2 * N_LEGS]),
        acc[2].reshape(n, -1),
    ], dim=-1)
    return x, J, a


@dataclasses.dataclass
class Ant2DState:
    q: torch.Tensor  # [N, 11]
    qd: torch.Tensor  # [N, 11]
    last_x: torch.Tensor  # [N]


class Ant2D(DeviceEnv):
    """Planar quadruped locomotion. obs 26, act 8, episode 1000 steps."""

    max_episode_steps = 1000
    OBS_DIM = 26  # z, pitch(sin,cos), 8 joints, 11 velocities, 4 contacts

    def __init__(self, device=None):
        self.device = resolve_device(device)
        f32 = dict(dtype=torch.float32, device=self.device)
        self.hip_x = torch.tensor(HIP_X, **f32)
        self.masses = torch.tensor(MASSES, **f32)
        self.inertias = torch.tensor(INERTIAS, **f32)
        self.reg = 1e-6 * torch.eye(NQ, **f32)
        self.init_joints = torch.tensor((0.25, -0.5) * N_LEGS, **f32)
        self.angle_jac = _angle_jacobian(**f32)

    def env_info(self):
        return EnvInfo(
            observation_space=Box(shape=(self.OBS_DIM,)),
            action_space=Box(shape=(2 * N_LEGS,), low=-1.0, high=1.0),
        )

    def link_frames(self, q):
        return _link_frames(q, self.hip_x)

    def kinematics(self, q, qd):
        return _kinematics(q, qd, self.hip_x, self.angle_jac)

    def _obs(self, q, qd):
        feet = self.link_frames(q)[2]
        contacts = (feet[..., 1] < 0.005).to(torch.float32)
        return torch.cat(
            [
                q[:, 1:2],  # torso height
                torch.sin(q[:, 2:3]),
                torch.cos(q[:, 2:3]),
                q[:, 3:],  # joint angles
                torch.clamp(qd, -10.0, 10.0),  # all velocities
                contacts,
            ],
            dim=-1,
        )

    def reset(self, num_envs, generator):
        f32 = dict(dtype=torch.float32, device=self.device)
        joint_noise = torch.randn((num_envs, 2 * N_LEGS), generator=generator, **f32)
        qd = 0.02 * torch.randn((num_envs, NQ), generator=generator, **f32)
        q = torch.zeros((num_envs, NQ), **f32)
        q[:, 1] = LINK_L * 1.6  # torso height: legs slightly bent
        q[:, 3:] = self.init_joints + 0.08 * joint_noise
        state = Ant2DState(q=q, qd=qd, last_x=q[:, 0].clone())
        return state, self._obs(q, qd)

    def step_factors(self, q, qd):
        """Cholesky factor of M(q), bias, foot Jacobian and foot points, once
        per control step (ant2d.py _step_factors)."""
        M, bias, feet_jac, feet0 = lagrangian_factors_2d(
            self.kinematics, self.masses, self.inertias, q, qd, GRAVITY
        )
        chol, _ = torch.linalg.cholesky_ex(M + self.reg)
        return chol, bias, feet_jac, feet0

    def substep_qdd(self, q, qd, action, chol, bias, feet_jac, feet):
        """Per-substep forces (torque, damping, joint limits, contacts) and
        the solve M q̈ = rhs (ant2d.py _substep_qdd)."""
        joint_q = q[:, 3:]
        limit_force = -8.0 * (
            torch.clamp(joint_q - JOINT_LIMIT, min=0.0) + torch.clamp(joint_q + JOINT_LIMIT, max=0.0)
        )
        tau_joints = TORQUE_SCALE * action + (-JOINT_DAMPING * qd[:, 3:]) + limit_force
        tau = torch.cat([torch.zeros_like(q[:, :3]), tau_joints], dim=-1)

        feet_vel = torch.einsum("nfcq,nq->nfc", feet_jac, qd)  # [N, 4, 2]
        depth = torch.clamp(-feet[..., 1], min=0.0)
        in_contact = (depth > 0.0).to(q.dtype)
        fn_mag = K_GROUND * depth - D_GROUND * feet_vel[..., 1] * in_contact
        fn_mag = torch.clamp(fn_mag, min=0.0) * in_contact
        ft = -MU_FRICTION * fn_mag * torch.tanh(feet_vel[..., 0] * 10.0)
        f_contact = torch.stack([ft, fn_mag], dim=-1)  # [N, 4, 2]
        tau_contact = torch.einsum("nfcq,nfc->nq", feet_jac, f_contact)

        rhs = tau + tau_contact - bias
        return torch.cholesky_solve(rhs[..., None], chol).squeeze(-1)

    def step(self, estate: Ant2DState, actions):
        action = torch.clamp(actions, -1.0, 1.0)
        q, qd = estate.q, estate.qd
        h = DT / SUBSTEPS
        q0 = q
        chol, bias, feet_jac, feet0 = self.step_factors(q, qd)
        for _ in range(SUBSTEPS):
            # feet advance by the held Jacobian, not a fresh kinematics pass
            feet = feet0 + torch.einsum("nfcq,nq->nfc", feet_jac, q - q0)
            qdd = self.substep_qdd(q, qd, action, chol, bias, feet_jac, feet)
            qd = torch.clamp(qd + h * qdd, -50.0, 50.0)
            q = q + h * qd

        fwd_vel = (q[:, 0] - estate.last_x) / DT
        ctrl_cost = 0.25 * torch.sum(torch.square(action), dim=-1)
        reward = fwd_vel + 0.5 - ctrl_cost

        terminated = (q[:, 1] < 0.12) | (torch.abs(q[:, 2]) > 1.3)
        state = Ant2DState(q=q, qd=qd, last_x=q[:, 0])
        return state, self._obs(q, qd), reward, terminated, {}
