"""Ant3D — a full 3D device-resident quadruped, batched over envs.

Port of rl_games_tpu/envs/jax/ant3d.py. A free-floating spherical torso (6
DOF: x, y, z, roll, pitch, yaw) with 4 legs × (hip swing + knee bend) = 8
actuated hinges, 14 generalized coordinates, 3D penalty contacts under the
feet. The equations of motion come from the 3D Lagrangian factors
(lagrangian.py), fed with the kinematics, J and J̇q̇ of one pass over jets
of q; rotational kinetic energy uses ‖Ṙ‖²_F = 2|ω|² (isotropic inertia).
The base orientation is z-y-x Euler; an episode ends at |roll| or |pitch|
> 0.9 rad, far from the gimbal singularity. Reward: forward velocity + 1
alive − 0.25 ctrl. The 14×14 solve is ``cholesky_ex``/``cholesky_solve``.
"""

import math

import torch

from rl_games_tpu_torch.envs.device.base import standard_normal
from rl_games_tpu_torch.envs.device.lagrangian import (
    LagrangianEnv,
    LocomotionState,
    cat,
    euler_zyx,
    jet_kinematics,
    rot_y,
    rot_z,
    soft_limit_force,
)
from rl_games_tpu_torch.envs.spaces import Box, EnvInfo
from rl_games_tpu_torch.utils.device import resolve_device

NQ = 14  # x, y, z, roll, pitch, yaw, 4 x (hip, knee)
N_LEGS = 4
TORSO_M = 1.0
TORSO_I = 0.05
TORSO_R = 0.25  # hip anchors sit on this radius
LINK_M = 0.15
LINK_L = 0.28
LINK_I = LINK_M * LINK_L**2 / 12.0
# leg azimuths in the torso frame (front-left, back-left, back-right,
# front-right: the MuJoCo Ant layout)
LEG_AZIMUTH = tuple(f * math.pi for f in (0.25, 0.75, 1.25, 1.75))
GRAVITY = 9.81
JOINT_DAMPING = 0.08
TORQUE_SCALE = 2.2
# per-joint soft limits: hips swing ±0.7 rad, knees bend 0.25..1.45 rad
JOINT_LO = (-0.7, 0.25) * N_LEGS
JOINT_HI = (0.7, 1.45) * N_LEGS
KNEE_INIT = 0.9
MASSES = (TORSO_M,) + (LINK_M,) * (2 * N_LEGS)
INERTIAS = (TORSO_I,) + (LINK_I,) * (2 * N_LEGS)


def link_frames(q, azimuth):
    """COMs and orientations of the 9 bodies and the 4 foot tips
    (ant3d.py _link_frames :89-141), for a tensor q [N, 14] or a Jet of it.

    Body order: torso, 4 thighs, 4 shins. Thighs extend horizontally
    outward (torso frame) at azimuth + hip; shins continue in the same
    vertical plane, tilted knee below horizontal. Returns
    (coms [N, 9, 3], Rs [N, 9, 3, 3], feet [N, 4, 3]).
    """
    pos = q[:, 0:3]
    R = euler_zyx(q[:, 3], q[:, 4], q[:, 5])
    # world-from-link: thigh = R @ Rz(azimuth + hip), shin = thigh @
    # rot_y(-knee); the minus sign keeps the shin's frame turning with the
    # shin (ant3d.py:121-129). The thigh and shin directions are the
    # frames' x axes.
    thigh_R = R[:, None] @ rot_z(azimuth + q[:, 6::2])  # [N, 4, 3, 3]
    shin_R = thigh_R @ rot_y(-q[:, 7::2])
    d1w, d2w = thigh_R[..., 0], shin_R[..., 0]  # [N, 4, 3]
    anchor = pos[:, None] + TORSO_R * d1w
    thigh_com = anchor + (0.5 * LINK_L) * d1w
    knee = anchor + LINK_L * d1w
    shin_com = knee + (0.5 * LINK_L) * d2w
    feet = knee + LINK_L * d2w
    coms = cat([pos[:, None], thigh_com, shin_com], dim=1)
    Rs = cat([R[:, None], thigh_R, shin_R], dim=1)
    return coms, Rs, feet


class Ant3D(LagrangianEnv):
    """3D quadruped locomotion. obs 33, act 8, episode 1000 steps."""

    max_episode_steps = 1000
    # z, orientation 6D (first two R columns), 8 joints, 14 velocities,
    # 4 contacts
    OBS_DIM = 33
    reset_noise_shape = (2 * N_LEGS + NQ + 3,)  # joint angles, velocities, tilt
    alive_bonus = 1.0
    ctrl_cost = 0.25

    def __init__(self, device=None):
        self.device = resolve_device(device)
        f32 = dict(dtype=torch.float32, device=self.device)
        self.azimuth = torch.tensor(LEG_AZIMUTH, **f32)
        self.masses = torch.tensor(MASSES, **f32)
        self.inertias = torch.tensor(INERTIAS, **f32)
        self.joint_lo = torch.tensor(JOINT_LO, **f32)
        self.joint_hi = torch.tensor(JOINT_HI, **f32)
        self.reg = 1e-6 * torch.eye(NQ, **f32)
        self.init_joints = torch.tensor((0.0, KNEE_INIT) * N_LEGS, **f32)

    def env_info(self):
        return EnvInfo(
            observation_space=Box(shape=(self.OBS_DIM,)),
            action_space=Box(shape=(2 * N_LEGS,), low=-1.0, high=1.0),
        )

    def link_frames(self, q):
        return link_frames(q, self.azimuth)

    def kinematics(self, q, qd):
        return jet_kinematics(self.link_frames, q, qd)

    def joint_torques(self, q, qd, action):
        limit = soft_limit_force(q[:, 6:], self.joint_lo, self.joint_hi, 8.0)
        tau_joints = TORQUE_SCALE * action + (-JOINT_DAMPING * qd[:, 6:]) + limit
        return torch.cat([torch.zeros_like(q[:, :6]), tau_joints], dim=-1)

    def _obs(self, q, qd):
        _, Rs, feet = self.link_frames(q)
        R = Rs[:, 0]
        contacts = (feet[..., 2] < 0.005).to(torch.float32)
        return torch.cat(
            [
                q[:, 2:3],  # torso height
                R[:, :, 0], R[:, :, 1],  # orientation (6D rotation rep)
                q[:, 6:],  # joint angles
                torch.clamp(qd, -10.0, 10.0),  # all velocities
                contacts,
            ],
            dim=-1,
        )

    def reset_from(self, noise):
        num_envs = noise.shape[0]
        joint_noise, qd, tilt = standard_normal(noise).split([2 * N_LEGS, NQ, 3], dim=1)
        qd = 0.02 * qd
        q = torch.zeros((num_envs, NQ), dtype=torch.float32, device=self.device)
        # feet at z = base_z - L sin(knee): start just touching the ground
        q[:, 2] = LINK_L * math.sin(KNEE_INIT) + 0.01
        q[:, 3:6] = 0.02 * tilt
        q[:, 6:] = self.init_joints + 0.08 * joint_noise
        state = LocomotionState(q=q, qd=qd, last_x=q[:, 0].clone())
        return state, self._obs(q, qd)

    def terminated(self, q):
        # tipping over also keeps pitch far from the ±π/2 Euler singularity
        return (q[:, 2] < 0.11) | (torch.abs(q[:, 3]) > 0.9) | (torch.abs(q[:, 4]) > 0.9)

