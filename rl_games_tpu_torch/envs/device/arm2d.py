"""Planar arm tasks, batched over envs: ``Arm2D`` (reach) and ``Grasp2D``
(pick and place).

Port of rl_games_tpu/envs/jax/arm2d.py. An N-link torque-controlled planar
arm on a fixed base, no contacts: M(q) q̈ = τ − b(q, q̇). The JAX package
takes M from ``jax.hessian`` of the kinetic energy and b from its grads;
here M = JᵀWJ and b = JᵀW·J̇q̇ + ∇V come from the planar Lagrangian factors
(lagrangian.py) over one pass of the kinematics on jets of q: the same
quantities. As in the JAX package they are recomputed at every substep.
Arm2D: reward −distance + reach bonus − ctrl cost, 150 steps, a random
target per episode. Grasp2D adds a free object that a closed gripper
latches within ``grab_radius``, 200 steps.
"""

import dataclasses
import math

import torch

from rl_games_tpu_torch.envs.device.base import DeviceEnv, standard_normal
from rl_games_tpu_torch.envs.device.lagrangian import (
    Jet,
    cat,
    lagrangian_factors_2d,
    sincos,
    stack,
)
from rl_games_tpu_torch.envs.spaces import Box, EnvInfo
from rl_games_tpu_torch.utils.device import resolve_device

GRAVITY = 9.81


@dataclasses.dataclass
class ArmState:
    q: torch.Tensor  # [N, n] joint angles
    qd: torch.Tensor  # [N, n]
    target: torch.Tensor  # [N, 2]


@dataclasses.dataclass
class GraspState:
    q: torch.Tensor  # [N, n] joint angles
    qd: torch.Tensor  # [N, n]
    obj: torch.Tensor  # [N, 2] object position
    objd: torch.Tensor  # [N, 2] object velocity
    target: torch.Tensor  # [N, 2] place target
    held: torch.Tensor  # [N] bool: object latched to the gripper


class Arm2D(DeviceEnv):
    """N-link planar reacher (arm2d.py Arm2D :34-159)."""

    max_episode_steps = 150

    def __init__(self, n_links=3, link_l=0.35, link_m=0.4,
                 torque_scale=6.0, dt=0.02, substeps=4, joint_damping=0.35,
                 ctrl_cost=0.05, reach_radius=0.08, reach_bonus=2.0,
                 gravity=True, device=None):
        self.device = resolve_device(device)
        f32 = dict(dtype=torch.float32, device=self.device)
        self.n = int(n_links)
        self.link_l = float(link_l)
        self.torque_scale = float(torque_scale)
        self.dt = float(dt)
        self.substeps = int(substeps)
        self.joint_damping = float(joint_damping)
        self.ctrl_cost = float(ctrl_cost)
        self.reach_radius = float(reach_radius)
        self.reach_bonus = float(reach_bonus)
        self.g = GRAVITY if gravity else 0.0
        link_i = link_m * link_l**2 / 12.0
        self.masses = torch.full((self.n,), link_m, **f32)
        self.inertias = torch.full((self.n,), link_i, **f32)
        self.reg = 1e-6 * torch.eye(self.n, **f32)
        self.reach = self.n * self.link_l
        self.reset_noise_shape = (self.n + 2,)  # joint angles, the target's radius and angle
        # obs: [sin q, cos q, qd, target, ee, target - ee]
        self.obs_dim = 3 * self.n + 6

    # -- kinematics / dynamics ------------------------------------------
    def frames(self, q):
        """(coms [N, n, 2], angles [N, n], end effector [N, 2]) for a tensor
        q [N, n] or a Jet of it (arm2d.py _frames :69-77)."""
        angles = q.cumsum(1)
        s, c = sincos(angles)
        dirs = stack([c, s], dim=-1)
        joints = (self.link_l * dirs).cumsum(1)  # the joint after each link
        coms = joints - (0.5 * self.link_l) * dirs
        return coms, angles, joints[:, -1]

    def kinematics(self, q, qd):
        """x = [COMs, angles] with J and J̇q̇, for the factors; no contacts
        (the end effector is read from ``frames`` on plain tensors)."""
        n = q.shape[0]
        coms, angles, _ = self.frames(Jet.variables(q, qd))
        flat = cat([coms.reshape(n, -1), angles], dim=1)
        return flat.value, flat.jacobian, flat.curvature

    def qdd(self, q, qd, action):
        M, bias, _, _ = lagrangian_factors_2d(
            self.kinematics, self.masses, self.inertias, q, qd, self.g
        )
        chol, _ = torch.linalg.cholesky_ex(M + self.reg)
        tau = self.torque_scale * action - self.joint_damping * qd
        return torch.cholesky_solve((tau - bias)[..., None], chol).squeeze(-1)

    def integrate(self, q, qd, action):
        h = self.dt / self.substeps
        for _ in range(self.substeps):
            qd = torch.clamp(qd + h * self.qdd(q, qd, action), -30.0, 30.0)
            q = q + h * qd
        return q, qd

    # -- env API --------------------------------------------------------
    def env_info(self):
        return EnvInfo(
            observation_space=Box(shape=(self.obs_dim,)),
            action_space=Box(shape=(self.n,), low=-1.0, high=1.0),
        )

    def _obs(self, state: ArmState):
        ee = self.frames(state.q)[2]
        return torch.cat(
            [
                torch.sin(state.q),
                torch.cos(state.q),
                torch.clamp(state.qd, -20.0, 20.0),
                state.target,
                ee,
                state.target - ee,
            ],
            dim=-1,
        )

    def _target(self, u):
        """A target at a random radius and angle from two uniforms [N, 2]."""
        r = 0.3 * self.reach + (0.95 * self.reach - 0.3 * self.reach) * u[:, 0]
        a = 2.0 * math.pi * u[:, 1]
        return r[:, None] * torch.stack([torch.cos(a), torch.sin(a)], dim=-1)

    def _reset_q(self, u):
        """Joint angles 0.1 N(0, 1) from n uniforms [N, n], at rest."""
        q = 0.1 * standard_normal(u)
        return q, torch.zeros_like(q)

    def reset_from(self, noise):
        q, qd = self._reset_q(noise[:, :self.n])
        state = ArmState(q=q, qd=qd, target=self._target(noise[:, self.n:]))
        return state, self._obs(state)

    def step(self, estate: ArmState, actions, noise=None):
        action = torch.clamp(actions, -1.0, 1.0)
        q, qd = self.integrate(estate.q, estate.qd, action)
        state = ArmState(q=q, qd=qd, target=estate.target)
        ee = self.frames(q)[2]
        dist = torch.linalg.vector_norm(state.target - ee, dim=-1)
        reward = (
            -dist
            + self.reach_bonus * (dist < self.reach_radius).to(torch.float32)
            - self.ctrl_cost * torch.sum(torch.square(action), dim=-1)
        )
        return state, self._obs(state), reward, torch.zeros_like(reward, dtype=torch.bool), {}


class Grasp2D(Arm2D):
    """Planar pick-and-place (arm2d.py Grasp2D :173-278): the last action
    channel is the gripper; closing it within ``grab_radius`` of the object
    latches the object to the end effector, opening releases it into free
    fall onto a table at y = -reach/2. Reward: -dist(ee, obj) while free,
    -dist(obj, target) + carry bonus while held, + place bonus when the
    held object reaches the target."""

    max_episode_steps = 200

    def __init__(self, grab_radius=0.12, place_radius=0.1,
                 carry_bonus=0.5, place_bonus=4.0, **kw):
        super().__init__(**kw)
        self.grab_radius = float(grab_radius)
        self.place_radius = float(place_radius)
        self.carry_bonus = float(carry_bonus)
        self.place_bonus = float(place_bonus)
        # obs: arm (sin q, cos q, qd) + ee + obj + objd + target + held
        self.obs_dim = 3 * self.n + 9
        self.floor = -0.5 * self.reach  # a virtual table inside the workspace
        self.reset_noise_shape = (self.n + 3,)  # joint angles, the object's x, the target
        f32 = dict(dtype=torch.float32, device=self.device)
        self.fall = torch.tensor([0.0, -self.dt * self.g], **f32)
        self.bounce = torch.tensor([0.8, 0.0], **f32)

    def env_info(self):
        return EnvInfo(
            observation_space=Box(shape=(self.obs_dim,)),
            # n joint torques + 1 gripper channel
            action_space=Box(shape=(self.n + 1,), low=-1.0, high=1.0),
        )

    def _obs(self, state: GraspState):
        ee = self.frames(state.q)[2]
        return torch.cat(
            [
                torch.sin(state.q),
                torch.cos(state.q),
                torch.clamp(state.qd, -20.0, 20.0),
                ee,
                state.obj - ee,
                torch.clamp(state.objd, -10.0, 10.0),
                state.target - state.obj,
                state.held.to(torch.float32)[:, None],
            ],
            dim=-1,
        )

    def reset_from(self, noise):
        num_envs = noise.shape[0]
        q, qd = self._reset_q(noise[:, :self.n])
        # the object rests on the table at a random reachable x
        ox = -0.7 * self.reach + 1.4 * self.reach * noise[:, self.n]
        obj = torch.stack([ox, torch.full_like(ox, self.floor)], dim=-1)
        # the place target lies in the reachable upper half-plane
        target = self._target(noise[:, self.n + 1:])
        target = torch.stack([target[:, 0], torch.abs(target[:, 1])], dim=-1)
        state = GraspState(
            q=q, qd=qd, obj=obj, objd=torch.zeros_like(obj), target=target,
            held=torch.zeros((num_envs,), dtype=torch.bool, device=self.device),
        )
        return state, self._obs(state)

    def step(self, estate: GraspState, actions, noise=None):
        action = torch.clamp(actions, -1.0, 1.0)
        tau_a, grip = action[:, :self.n], action[:, self.n]
        q, qd = self.integrate(estate.q, estate.qd, tau_a)
        ee = self.frames(q)[2]

        # the latch: closing the gripper near the object grabs it, opening
        # releases it
        near = torch.linalg.vector_norm(estate.obj - ee, dim=-1) < self.grab_radius
        held = (grip > 0.0) & (estate.held | near)
        # a held object rides the end effector; a free one falls under
        # gravity and stops on the table, keeping 0.8 of its x velocity
        free_objd = estate.objd + self.fall
        free_obj = estate.obj + self.dt * free_objd
        bounced = free_obj[:, 1] < self.floor
        free_obj = torch.stack([free_obj[:, 0], torch.clamp(free_obj[:, 1], min=self.floor)], dim=-1)
        free_objd = torch.where(
            bounced[:, None], free_objd * self.bounce, free_objd
        )
        obj = torch.where(held[:, None], ee, free_obj)
        objd = torch.where(held[:, None], torch.zeros_like(free_objd), free_objd)

        d_obj = torch.linalg.vector_norm(obj - ee, dim=-1)
        d_target = torch.linalg.vector_norm(obj - estate.target, dim=-1)
        placed = held & (d_target < self.place_radius)
        reward = (
            torch.where(held, -d_target + self.carry_bonus, -d_obj)
            + self.place_bonus * placed.to(torch.float32)
            - self.ctrl_cost * torch.sum(torch.square(tau_a), dim=-1)
        )
        state = GraspState(q=q, qd=qd, obj=obj, objd=objd, target=estate.target, held=held)
        return state, self._obs(state), reward, torch.zeros_like(held), {}
