"""Humanoid3D — a full 3D device-resident biped, batched over envs.

Port of rl_games_tpu/envs/jax/humanoid3d.py. A free-floating pelvis (6
DOF) + 2-DOF abdomen carrying the torso, two 3-DOF legs (hip pitch + hip
roll + knee) ending in heel/toe ground contacts, and two 2-DOF arms
(shoulder pitch + elbow): 12 actuated hinges, 18 generalized coordinates,
10 bodies, 4 contact points. Dynamics as in Ant3D (lagrangian.py: one
pass over jets of q gives x, J and J̇q̇; ``cholesky_ex``/``cholesky_solve``
on the 18×18 mass matrix). Reward mirrors MuJoCo Humanoid-v5: 1.25 ×
forward velocity + 5 alive − 0.1 × ctrl; an episode ends when the pelvis
drops below 0.42 or |roll| or |pitch| exceeds 0.8.
"""

import torch

from rl_games_tpu_torch.envs.device.lagrangian import (
    LagrangianEnv,
    LocomotionState,
    cat,
    euler_zyx,
    jet_kinematics,
    rot_x,
    rot_y,
    soft_limit_force,
    stack,
)
from rl_games_tpu_torch.envs.spaces import Box, EnvInfo
from rl_games_tpu_torch.utils.device import resolve_device

NQ = 18  # x y z, roll pitch yaw, ab_pitch ab_roll, 2x(hip_p hip_r knee),
#          2x(shoulder_p elbow)
NU = 12  # actuated = q[6:]
N_CONTACTS = 4  # heel + toe per foot

PELVIS_M, PELVIS_I = 3.0, 0.06
TORSO_M, TORSO_I = 3.0, 0.08
TORSO_Z = 0.25  # abdomen joint -> torso COM offset
THIGH_M, THIGH_L = 0.8, 0.34
SHIN_M, SHIN_L = 0.5, 0.30
UARM_M, UARM_L = 0.25, 0.26
FARM_M, FARM_L = 0.15, 0.24
HIP_Y = 0.10  # lateral hip offset from pelvis center
SH_Y, SH_Z = 0.18, 0.12  # shoulder anchor in torso frame
TOE_L, HEEL_L = 0.12, 0.06

GRAVITY = 9.81
JOINT_DAMPING = 0.15
# per-joint torque gears: abdomen x2, per leg (hip_p, hip_r, knee) x2,
# per arm (shoulder_p, elbow) x2
GEAR = (3.0, 3.0, 4.0, 2.5, 4.0, 4.0, 2.5, 4.0, 1.2, 1.0, 1.2, 1.0)
K_GROUND = 1500.0
D_GROUND = 14.0
MU_FRICTION = 1.0
LIMIT_K = 20.0
# soft joint limits, same order as GEAR
JOINT_LO = (-0.5, -0.4, -0.9, -0.4, 0.0, -0.9, -0.4, 0.0, -1.2, 0.0, -1.2, 0.0)
JOINT_HI = (0.6, 0.4, 1.1, 0.4, 1.8, 1.1, 0.4, 1.8, 1.2, 1.8, 1.2, 1.8)
HIP_P_INIT = 0.12
KNEE_INIT = 0.25
ELBOW_INIT = 0.3

MASSES = (PELVIS_M, TORSO_M, THIGH_M, THIGH_M, SHIN_M, SHIN_M, UARM_M, UARM_M, FARM_M, FARM_M)
INERTIAS = (
    (PELVIS_I, TORSO_I)
    + (THIGH_M * THIGH_L**2 / 12.0,) * 2
    + (SHIN_M * SHIN_L**2 / 12.0,) * 2
    + (UARM_M * UARM_L**2 / 12.0,) * 2
    + (FARM_M * FARM_L**2 / 12.0,) * 2
)

Humanoid3DState = LocomotionState


def link_frames(q, side):
    """COMs and orientations of the 10 bodies and the 4 foot contact points
    (humanoid3d.py _link_frames :100-175), for a tensor q [N, 18] or a Jet
    of it; ``side`` = (1, -1) indexes (left, right).

    Body order: pelvis, torso, thighL, thighR, shinL, shinR, uarmL, uarmR,
    farmL, farmR; contacts heelL, toeL, heelR, toeR. Positive hip pitch
    swings a leg forward (+x), positive knee bends the shin backward, the
    rigid foot reaches TOE_L forward and HEEL_L back along the shin frame's
    x axis; positive elbow bends the forearm forward. Returns
    (coms [N, 10, 3], Rs [N, 10, 3, 3], contacts [N, 4, 3]).
    """
    pos = q[:, 0:3]
    R_p = euler_zyx(q[:, 3], q[:, 4], q[:, 5])
    R_t = R_p @ (rot_y(q[:, 6]) @ rot_x(q[:, 7]))
    # R @ (0, 0, z) is z times R's third column, and so on below
    torso_com = pos + TORSO_Z * R_t[..., 2]

    # legs, left and right along dim 1
    hp, hr, kn = q[:, 8:14:3], q[:, 9:14:3], q[:, 10:14:3]
    anchor = pos[:, None] + (HIP_Y * side)[:, None] * R_p[:, None, :, 1]
    R_hr = R_p[:, None] @ rot_x(hr)
    R_th = R_hr @ rot_y(hp)
    R_sh = R_hr @ rot_y(hp - kn)
    d_th, d_sh = -R_th[..., 2], -R_sh[..., 2]  # the links hang along -z
    thigh_com = anchor + (0.5 * THIGH_L) * d_th
    knee = anchor + THIGH_L * d_th
    shin_com = knee + (0.5 * SHIN_L) * d_sh
    ankle = knee + SHIN_L * d_sh
    f_dir = R_sh[..., 0]
    heel = ankle + (-HEEL_L) * f_dir
    toe = ankle + TOE_L * f_dir

    # arms
    sp, el = q[:, 14::2], q[:, 15::2]
    anchor = torso_com[:, None] + (
        (SH_Y * side)[:, None] * R_t[:, None, :, 1] + SH_Z * R_t[:, None, :, 2]
    )
    R_ua = R_t[:, None] @ rot_y(sp)
    R_fa = R_t[:, None] @ rot_y(sp + el)
    d_ua, d_fa = -R_ua[..., 2], -R_fa[..., 2]
    uarm_com = anchor + (0.5 * UARM_L) * d_ua
    elbow = anchor + UARM_L * d_ua
    farm_com = elbow + (0.5 * FARM_L) * d_fa

    coms = cat([pos[:, None], torso_com[:, None], thigh_com, shin_com, uarm_com, farm_com], dim=1)
    Rs = cat([R_p[:, None], R_t[:, None], R_th, R_sh, R_ua, R_fa], dim=1)
    contacts = stack([heel, toe], dim=2)  # [N, 2 legs, 2, 3]
    return coms, Rs, contacts.reshape(-1, N_CONTACTS, 3)


class Humanoid3D(LagrangianEnv):
    """3D biped locomotion. obs 41, act 12, episode 1000 steps."""

    max_episode_steps = 1000
    # z, pelvis orientation 6D (first two R columns), 12 joints,
    # 18 velocities, 4 contacts
    OBS_DIM = 41
    k_ground = K_GROUND
    d_ground = D_GROUND
    mu_friction = MU_FRICTION
    # MuJoCo Humanoid-v5: 1.25 forward velocity + 5 alive - 0.1 ctrl
    forward_scale = 1.25
    alive_bonus = 5.0
    ctrl_cost = 0.1

    def __init__(self, device=None):
        self.device = resolve_device(device)
        f32 = dict(dtype=torch.float32, device=self.device)
        self.side = torch.tensor((1.0, -1.0), **f32)
        self.masses = torch.tensor(MASSES, **f32)
        self.inertias = torch.tensor(INERTIAS, **f32)
        self.gear = torch.tensor(GEAR, **f32)
        self.joint_lo = torch.tensor(JOINT_LO, **f32)
        self.joint_hi = torch.tensor(JOINT_HI, **f32)
        self.reg = 1e-6 * torch.eye(NQ, **f32)
        self.init_q = self._init_q()

    def _init_q(self):
        """Nominal slightly-knees-bent standing pose with both feet touching
        (humanoid3d.py _init_q :238-248)."""
        q = torch.zeros((1, NQ), dtype=torch.float32, device=self.device)
        for base in (8, 11):  # legs: hip pitched forward, knee bent
            q[0, base], q[0, base + 2] = HIP_P_INIT, KNEE_INIT
        q[0, 15] = q[0, 17] = ELBOW_INIT
        # pelvis height: the lowest contact point just at the ground
        lowest = self.link_frames(q)[2][0, :, 2].min()
        q[0, 2] += -lowest + 0.005
        return q[0]

    def env_info(self):
        return EnvInfo(
            observation_space=Box(shape=(self.OBS_DIM,)),
            action_space=Box(shape=(NU,), low=-1.0, high=1.0),
        )

    def link_frames(self, q):
        return link_frames(q, self.side)

    def kinematics(self, q, qd):
        return jet_kinematics(self.link_frames, q, qd)

    def joint_torques(self, q, qd, action):
        limit = soft_limit_force(q[:, 6:], self.joint_lo, self.joint_hi, LIMIT_K)
        tau_joints = self.gear * action + (-JOINT_DAMPING * qd[:, 6:]) + limit
        return torch.cat([torch.zeros_like(q[:, :6]), tau_joints], dim=-1)

    def _obs(self, q, qd):
        _, Rs, pts = self.link_frames(q)
        R = Rs[:, 0]
        contacts = (pts[..., 2] < 0.005).to(torch.float32)
        return torch.cat(
            [
                q[:, 2:3],  # pelvis height
                R[:, :, 0], R[:, :, 1],  # orientation (6D rotation rep)
                q[:, 6:],  # joint angles
                torch.clamp(qd, -10.0, 10.0),  # all velocities
                contacts,
            ],
            dim=-1,
        )

    def reset(self, num_envs, generator):
        f32 = dict(dtype=torch.float32, device=self.device)
        joint_noise = torch.randn((num_envs, NU), generator=generator, **f32)
        qd = 0.01 * torch.randn((num_envs, NQ), generator=generator, **f32)
        tilt = torch.randn((num_envs, 3), generator=generator, **f32)
        q = self.init_q.expand(num_envs, NQ).clone()
        q[:, 6:] += 0.03 * joint_noise
        q[:, 3:6] += 0.01 * tilt
        state = LocomotionState(q=q, qd=qd, last_x=q[:, 0].clone())
        return state, self._obs(q, qd)

    def terminated(self, q):
        # tipping over also keeps pitch far from the ±π/2 Euler singularity
        return (q[:, 2] < 0.42) | (torch.abs(q[:, 3]) > 0.8) | (torch.abs(q[:, 4]) > 0.8)
