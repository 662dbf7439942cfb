"""Classic-control environments, batched over envs.

Port of rl_games_tpu/envs/jax/classic.py (:26-159): CartPole-v1,
Pendulum-v1 and MountainCarContinuous-v0 with gymnasium's dynamics, in the
JAX package's float32 arithmetic and order of operations. Each reset is
``reset_from`` of uniforms in [0, 1) (``DeviceEnv.reset``).
"""

import dataclasses
import math

import torch

from rl_games_tpu_torch.envs.device.base import DeviceEnv, uniform_between
from rl_games_tpu_torch.envs.spaces import Box, Discrete, EnvInfo
from rl_games_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class ArrayState:
    x: torch.Tensor  # [N, k]


class CartPole(DeviceEnv):
    """CartPole-v1: state = [x, x_dot, theta, theta_dot], reward 1/step."""

    max_episode_steps = 500
    reset_noise_shape = (4,)

    GRAVITY = 9.8
    MASSCART = 1.0
    MASSPOLE = 0.1
    TOTAL_MASS = MASSCART + MASSPOLE
    LENGTH = 0.5
    POLEMASS_LENGTH = MASSPOLE * LENGTH
    FORCE_MAG = 10.0
    TAU = 0.02
    THETA_LIMIT = 12 * 2 * math.pi / 360
    X_LIMIT = 2.4

    def __init__(self, device=None):
        self.device = resolve_device(device)
        # a device tensor: PyTorch's CUDA kernels turn a division by a Python
        # number into a product with its reciprocal, one more rounding
        self._total_mass = torch.tensor(self.TOTAL_MASS, dtype=torch.float32, device=self.device)

    def env_info(self):
        return EnvInfo(observation_space=Box(shape=(4,)), action_space=Discrete(n=2))

    def reset_from(self, noise):
        x = uniform_between(noise, -0.05, 0.05)
        return ArrayState(x=x), x

    def step(self, estate, actions, noise=None):
        x, x_dot, theta, theta_dot = estate.x.unbind(-1)
        force = torch.where(actions == 1, self.FORCE_MAG, -self.FORCE_MAG)
        costheta = torch.cos(theta)
        sintheta = torch.sin(theta)
        temp = (force + self.POLEMASS_LENGTH * (theta_dot * theta_dot) * sintheta) / self._total_mass
        thetaacc = (self.GRAVITY * sintheta - costheta * temp) / (
            self.LENGTH * (4.0 / 3.0 - self.MASSPOLE * (costheta * costheta) / self._total_mass)
        )
        xacc = temp - self.POLEMASS_LENGTH * thetaacc * costheta / self._total_mass
        x = x + self.TAU * x_dot
        x_dot = x_dot + self.TAU * xacc
        theta = theta + self.TAU * theta_dot
        theta_dot = theta_dot + self.TAU * thetaacc
        new = torch.stack([x, x_dot, theta, theta_dot], dim=-1)
        terminated = (torch.abs(x) > self.X_LIMIT) | (torch.abs(theta) > self.THETA_LIMIT)
        reward = torch.ones_like(x)
        return ArrayState(x=new), new, reward, terminated, {}


class Pendulum(DeviceEnv):
    """Pendulum-v1: obs [cos, sin, thdot], continuous torque in [-2, 2]."""

    max_episode_steps = 200
    reset_noise_shape = (2,)

    MAX_SPEED = 8.0
    MAX_TORQUE = 2.0
    DT = 0.05
    G = 10.0
    M = 1.0
    L = 1.0

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def env_info(self):
        return EnvInfo(observation_space=Box(shape=(3,)),
                       action_space=Box(shape=(1,), low=-2.0, high=2.0))

    @staticmethod
    def _obs(th, thdot):
        return torch.stack([torch.cos(th), torch.sin(th), thdot], dim=-1)

    def reset_from(self, noise):
        th = uniform_between(noise[:, 0], -math.pi, math.pi)
        thdot = uniform_between(noise[:, 1], -1.0, 1.0)
        return ArrayState(x=torch.stack([th, thdot], dim=-1)), self._obs(th, thdot)

    def step(self, estate, actions, noise=None):
        th, thdot = estate.x.unbind(-1)
        u = torch.clamp(actions[:, 0], -self.MAX_TORQUE, self.MAX_TORQUE)
        th_norm = torch.remainder(th + math.pi, 2 * math.pi) - math.pi
        costs = th_norm * th_norm + 0.1 * (thdot * thdot) + 0.001 * (u * u)
        newthdot = thdot + (
            3.0 * self.G / (2.0 * self.L) * torch.sin(th) + 3.0 / (self.M * self.L**2) * u
        ) * self.DT
        newthdot = torch.clamp(newthdot, -self.MAX_SPEED, self.MAX_SPEED)
        newth = th + newthdot * self.DT
        state = ArrayState(x=torch.stack([newth, newthdot], dim=-1))
        return state, self._obs(newth, newthdot), -costs, torch.zeros_like(th, dtype=torch.bool), {}


class MountainCarContinuous(DeviceEnv):
    """MountainCarContinuous-v0."""

    max_episode_steps = 999
    reset_noise_shape = (1,)

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def env_info(self):
        return EnvInfo(observation_space=Box(shape=(2,)),
                       action_space=Box(shape=(1,), low=-1.0, high=1.0))

    def reset_from(self, noise):
        pos = uniform_between(noise[:, 0], -0.6, -0.4)
        s = torch.stack([pos, torch.zeros_like(pos)], dim=-1)
        return ArrayState(x=s), s

    def step(self, estate, actions, noise=None):
        position, velocity = estate.x.unbind(-1)
        force = torch.clamp(actions[:, 0], -1.0, 1.0)
        velocity = velocity + force * 0.0015 - 0.0025 * torch.cos(3 * position)
        velocity = torch.clamp(velocity, -0.07, 0.07)
        position = torch.clamp(position + velocity, -1.2, 0.6)
        velocity = torch.where((position <= -1.2) & (velocity < 0), 0.0, velocity)
        terminated = (position >= 0.45) & (velocity >= 0.0)
        reward = torch.where(terminated, 100.0, 0.0) - 0.1 * (force * force)
        s = torch.stack([position, velocity], dim=-1)
        return ArrayState(x=s), s, reward, terminated, {}
