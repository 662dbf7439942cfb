"""Planar legged locomotion, batched over envs: ``PlanarWalker`` and its
morphologies ``Walker2D`` and ``Cheetah2D`` (and ``Ant2D``, ant2d.py).

Port of rl_games_tpu/envs/jax/locomotion2d.py. A free torso (x, z, pitch)
with N legs × (hip, knee) hinges: 3 + 2N generalized coordinates, 2N
actuated. Equations of motion M q̈ + b = τ + J_cᵀ f_contact come from the
planar Lagrangian factors (lagrangian.py), fed with the kinematics'
Jacobian and J̇q̇ in closed form (``planar_kinematics``); ground contact is
a penalty spring-damper per foot with Coulomb-style tangential friction.
Reward is forward velocity + alive bonus − control cost; an episode
terminates when the torso falls or pitches past its limit.
"""

import torch

from rl_games_tpu_torch.envs.device.lagrangian import (
    LagrangianEnv,
    LocomotionState,
    lagrangian_factors_2d,
    soft_limit_force,
)
from rl_games_tpu_torch.envs.spaces import Box, EnvInfo
from rl_games_tpu_torch.utils.device import resolve_device

WalkerState = LocomotionState


def planar_link_frames(q, hip_x, link_l):
    """Centers and angles of the 1 + 2N bodies and the N foot tips, batched.

    q: [B, 3 + 2N]; hip_x: [N]. Body order: torso, N thighs, N shins.
    Returns (coms [B, 1 + 2N, 2], angles [B, 1 + 2N], feet [B, N, 2]).
    """
    th = q[:, 2]
    torso = q[:, 0:2]
    hip_q = q[:, 3::2]  # [B, N]
    knee_q = q[:, 4::2]
    ca, sa = torch.cos(th), torch.sin(th)
    anchors = torso[:, None, :] + hip_x[None, :, None] * torch.stack([ca, sa], dim=-1)[:, None, :]
    a1 = th[:, None] + hip_q  # the thigh hangs at this angle from -z
    dir1 = torch.stack([torch.sin(a1), -torch.cos(a1)], dim=-1)  # [B, N, 2]
    thigh_com = anchors + 0.5 * link_l * dir1
    knees = anchors + link_l * dir1
    a2 = a1 + knee_q
    dir2 = torch.stack([torch.sin(a2), -torch.cos(a2)], dim=-1)
    shin_com = knees + 0.5 * link_l * dir2
    feet = knees + link_l * dir2
    coms = torch.cat([torso[:, None, :], thigh_com, shin_com], dim=1)
    angles = torch.cat([th[:, None], a1, a2], dim=1)
    return coms, angles, feet


def angle_jacobian(n_legs, **f32):
    """∂(angles)/∂q, constant: the torso's pitch, then θ + hip_i, then
    θ + hip_i + knee_i."""
    nq = 3 + 2 * n_legs
    J = torch.zeros((1 + 2 * n_legs, nq), **f32)
    J[:, 2] = 1.0
    for i in range(n_legs):
        J[1 + i, 3 + 2 * i] = 1.0
        J[1 + n_legs + i, 3 + 2 * i:5 + 2 * i] = 1.0
    return J


def planar_kinematics(q, qd, hip_x, link_l, angle_jac):
    """The flattened kinematics of ``planar_link_frames``, its Jacobian and
    J̇q̇, in closed form for a batch: (x [B, K], J = ∂x/∂q [B, K, 3 + 2N],
    J̇q̇ [B, K]), x = [COMs ((1 + 2N) × 2), angles (1 + 2N), feet (N × 2)],
    K = 3(1 + 2N) + 2N.

    Each leg point is P = anchor + c1·L·u(a1) + c2·L·u(a2) with
    anchor = torso + hip_x·(cos θ, sin θ), u(a) = (sin a, -cos a), a1 = θ +
    hip, a2 = a1 + knee, and (c1, c2) = (½, 0) for the thigh COM, (1, ½)
    for the shin COM, (1, 1) for the foot. Then ∂P/∂knee = c2·L·u'(a2),
    ∂P/∂hip = c1·L·u'(a1) + ∂P/∂knee, ∂P/∂θ = hip_x·(-sin θ, cos θ) +
    ∂P/∂hip, and, since u'' = -u, J̇q̇ = -(hip_x·(cos θ, sin θ)·θ̇² +
    c1·L·u(a1)·ȧ1² + c2·L·u(a2)·ȧ2²). The angles are linear in q.
    """
    n, nq = q.shape
    n_legs = hip_x.shape[0]
    th, thd = q[:, 2:3], qd[:, 2:3]  # [B, 1]
    a1, a1d = th + q[:, 3::2], thd + qd[:, 3::2]  # [B, N]
    a2, a2d = a1 + q[:, 4::2], a1d + qd[:, 4::2]
    ct, st = torch.cos(th)[..., None], torch.sin(th)[..., None]  # [B, 1, 1]
    hx = hip_x[None, :, None]
    lever = hx * torch.cat([ct, st], dim=-1)  # anchor - torso, [B, N, 2]
    dlever = hx * torch.cat([-st, ct], dim=-1)  # its ∂/∂θ
    s1, c1_ = torch.sin(a1), torch.cos(a1)
    s2, c2_ = torch.sin(a2), torch.cos(a2)
    u1 = link_l * torch.stack([s1, -c1_], dim=-1)  # L·u(a1), [B, N, 2]
    u2 = link_l * torch.stack([s2, -c2_], dim=-1)
    du1 = link_l * torch.stack([c1_, s1], dim=-1)  # L·u'(a1)
    du2 = link_l * torch.stack([c2_, s2], dim=-1)
    anchors = q[:, None, 0:2] + lever
    lever_acc = lever * torch.square(thd)[..., None]
    acc1, acc2 = u1 * torch.square(a1d)[..., None], u2 * torch.square(a2d)[..., None]
    leg = torch.eye(n_legs, dtype=q.dtype, device=q.device)[:, None, :]  # [N, 1, N]
    base = torch.eye(2, dtype=q.dtype, device=q.device).expand(n, n_legs, 2, 2)

    pos, jac, acc = [], [], []
    for c1, c2 in ((0.5, 0.0), (1.0, 0.5), (1.0, 1.0)):  # thigh COM, shin COM, foot
        dknee = c2 * du2
        dhip = c1 * du1 + dknee
        joints = torch.stack([dhip[..., None] * leg, dknee[..., None] * leg], dim=-1)
        jac.append(torch.cat(
            [base, (dlever + dhip)[..., None], joints.reshape(n, n_legs, 2, 2 * n_legs)], dim=-1
        ))  # [B, N, 2, nq]
        pos.append(anchors + c1 * u1 + c2 * u2)
        acc.append(-(lever_acc + c1 * acc1 + c2 * acc2))

    torso_jac = torch.eye(2, nq, dtype=q.dtype, device=q.device).expand(n, 1, 2, nq)
    zeros = torch.zeros_like(q[:, None, 0:2])
    x = torch.cat([
        torch.cat([q[:, None, 0:2], pos[0], pos[1]], dim=1).reshape(n, -1),
        th, a1, a2,
        pos[2].reshape(n, -1),
    ], dim=-1)
    J = torch.cat([
        torch.cat([torso_jac, jac[0], jac[1]], dim=1).reshape(n, -1, nq),
        angle_jac.expand(n, -1, -1),
        jac[2].reshape(n, -1, nq),
    ], dim=1)
    a = torch.cat([
        torch.cat([zeros, acc[0], acc[1]], dim=1).reshape(n, -1),
        torch.zeros_like(x[:, :1 + 2 * n_legs]),
        acc[2].reshape(n, -1),
    ], dim=-1)
    return x, J, a


class PlanarWalker(LagrangianEnv):
    """Free torso (x, z, pitch) + N legs × (hip, knee) hinges
    (locomotion2d.py PlanarWalker :30-194); the defaults are Ant2D's."""

    max_episode_steps = 1000
    factors = staticmethod(lagrangian_factors_2d)
    joint_damping = 0.08  # dt, substeps and the ground's constants: LagrangianEnv's

    def __init__(self, hip_x, link_l=0.28, link_m=0.15, torso_m=1.0,
                 torso_i=0.05, torque_scale=2.2, joint_limit=1.2,
                 alive_bonus=0.5, ctrl_cost=0.25, init_height_factor=1.6,
                 crash_height=0.12, crash_pitch=1.3, device=None):
        self.device = resolve_device(device)
        f32 = dict(dtype=torch.float32, device=self.device)
        self.hip_x = torch.tensor(hip_x, **f32)
        self.n_legs = len(hip_x)
        self.nq = 3 + 2 * self.n_legs
        self.link_l = float(link_l)
        self.torque_scale = float(torque_scale)
        self.joint_limit = float(joint_limit)
        self.alive_bonus = float(alive_bonus)
        self.ctrl_cost = float(ctrl_cost)
        self.init_height = float(init_height_factor) * self.link_l
        self.crash_height = float(crash_height)
        self.crash_pitch = float(crash_pitch)
        link_i = link_m * link_l**2 / 12.0
        self.masses = torch.tensor([torso_m] + [link_m] * (2 * self.n_legs), **f32)
        self.inertias = torch.tensor([torso_i] + [link_i] * (2 * self.n_legs), **f32)
        self.obs_dim = 3 + 2 * self.n_legs + self.nq + self.n_legs
        self.reg = 1e-6 * torch.eye(self.nq, **f32)
        self.init_joints = torch.tensor((0.25, -0.5) * self.n_legs, **f32)
        self.angle_jac = angle_jacobian(self.n_legs, **f32)

    def env_info(self):
        return EnvInfo(
            observation_space=Box(shape=(self.obs_dim,)),
            action_space=Box(shape=(2 * self.n_legs,), low=-1.0, high=1.0),
        )

    def link_frames(self, q):
        return planar_link_frames(q, self.hip_x, self.link_l)

    def kinematics(self, q, qd):
        return planar_kinematics(q, qd, self.hip_x, self.link_l, self.angle_jac)

    def joint_torques(self, q, qd, action):
        limit = soft_limit_force(q[:, 3:], -self.joint_limit, self.joint_limit, 8.0)
        tau_joints = self.torque_scale * action + (-self.joint_damping * qd[:, 3:]) + limit
        return torch.cat([torch.zeros_like(q[:, :3]), tau_joints], dim=-1)

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
        joint_noise = torch.randn((num_envs, 2 * self.n_legs), generator=generator, **f32)
        qd = 0.02 * torch.randn((num_envs, self.nq), generator=generator, **f32)
        q = torch.zeros((num_envs, self.nq), **f32)
        q[:, 1] = self.init_height
        q[:, 3:] = self.init_joints + 0.08 * joint_noise
        state = LocomotionState(q=q, qd=qd, last_x=q[:, 0].clone())
        return state, self._obs(q, qd)

    def terminated(self, q):
        return (q[:, 1] < self.crash_height) | (torch.abs(q[:, 2]) > self.crash_pitch)


def Walker2D(device=None):
    """Planar upright biped (locomotion2d.py Walker2D :196-213): short hip
    spacing, strict pitch limit."""
    return PlanarWalker(
        hip_x=[-0.08, 0.08], link_l=0.35, link_m=0.18, torso_m=1.5, torso_i=0.1,
        torque_scale=2.6, joint_limit=1.2, alive_bonus=1.0, ctrl_cost=0.15,
        init_height_factor=1.75, crash_height=0.45, crash_pitch=0.7, device=device,
    )


def Cheetah2D(device=None):
    """Planar sprinter biped (locomotion2d.py Cheetah2D :216-230): two long
    legs at the torso ends, higher torque, laxer pitch limit."""
    return PlanarWalker(
        hip_x=[-0.5, 0.5], link_l=0.4, link_m=0.2, torso_m=1.2, torso_i=0.12,
        torque_scale=3.0, joint_limit=1.4, alive_bonus=0.3, ctrl_cost=0.1,
        crash_pitch=1.6, device=device,
    )
