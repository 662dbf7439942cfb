"""Device-resident vectorized environment core.

Port of rl_games_tpu/envs/jax/base.py ``JaxVecEnv`` (:58-162). The JAX
package writes one environment's dynamics and vmaps it; here a
``DeviceEnv`` writes its dynamics batched over the env axis directly:

    env_info() -> EnvInfo                        (static spaces)
    reset_from(noise) -> (estate, obs)
    step(estate, actions, noise) -> (estate, obs, reward, terminated, info)

``estate`` is a dataclass of [N, ...] tensors. ``DeviceVecEnv`` adds
time-limit truncation and in-step autoreset (a done env's returned obs is
its next episode's first obs), and reports ``time_outs`` for the value
bootstrap (a2c_common.py:813-814) and the true ``final_observation``.
Random numbers come from the ``torch.Generator`` the state carries, and an
env never draws them itself: its reset and its step get them as ``noise``,
uniforms in [0, 1) of shape [N, *reset_noise_shape] and
[N, *step_noise_shape]. ``reset(num_envs, generator)`` draws the reset's and
the vec env the step's (a re-serve inside a pixel game's substep); envs
whose step draws nothing declare no step shape and get None. So a test can
hand an env the very numbers the JAX env draws from its keys.
"""

import dataclasses
import math
from typing import Any, Optional, Tuple

import numpy as np
import torch

from rl_games_tpu_torch.envs.spaces import EnvInfo


class DeviceEnv:
    """Batched dynamics over an env axis. Subclasses hold only constants."""

    max_episode_steps: Optional[int] = None
    step_noise_shape: Optional[Tuple[int, ...]] = None  # per env; None: the step draws nothing
    reset_noise_shape: Tuple[int, ...] = ()
    device: torch.device

    def env_info(self) -> EnvInfo:
        raise NotImplementedError

    def reset(self, num_envs: int, generator: torch.Generator):
        """``reset_from`` of the reset's uniforms drawn from ``generator``."""
        return self.reset_from(uniform(num_envs, self.reset_noise_shape, generator, self.device))

    def reset_from(self, noise: torch.Tensor):
        raise NotImplementedError

    def step(self, estate, actions, noise: Optional[torch.Tensor] = None):
        raise NotImplementedError


def uniform(num_envs: int, shape, generator: torch.Generator, device) -> torch.Tensor:
    """[num_envs, *shape] float32 uniforms in [0, 1)."""
    return torch.rand((num_envs, *shape), generator=generator, device=device)


def standard_normal(u):
    """u in [0, 1) mapped to standard normals through the inverse CDF,
    sqrt(2) erfinv(2u - 1), taken in float64 at u + 2^-25: strictly inside
    (0, 1), so every value is finite."""
    return (math.sqrt(2.0) * torch.erfinv(2.0 * (u.double() + 2.0 ** -25) - 1.0)).float()


def uniform_between(u, low: float, high: float):
    """u in [0, 1) mapped to [low, high) as jax.random.uniform maps it:
    max(low, u * (high - low) + low) with the span taken in float32 and the
    product and sum rounded once, as XLA fuses them (a multiply-add). The
    product of two float32s is exact in float64, so the sum is taken there
    and rounded to float32 once."""
    span = float(np.float32(high) - np.float32(low))
    low32 = float(np.float32(low))
    return torch.clamp((u.double() * span + low32).float(), min=low)


@dataclasses.dataclass
class VecEnvState:
    estate: Any  # dataclass of [N, ...] tensors
    generator: torch.Generator  # reset noise
    steps: torch.Tensor  # [N] int32 steps-in-episode


def _pick(done, new, old):
    """where(done, new, old) row-wise, over a tensor or a dataclass of them."""
    if dataclasses.is_dataclass(old):
        return dataclasses.replace(old, **{
            f.name: _pick(done, getattr(new, f.name), getattr(old, f.name))
            for f in dataclasses.fields(old)
        })
    d = done.reshape(done.shape + (1,) * (old.dim() - 1))
    return torch.where(d, new, old)


class DeviceVecEnv:
    """Batched autoresetting wrapper around a DeviceEnv.

    step(state, actions) -> (state, obs, rewards [N], dones [N] bool,
    infos) with infos = {'time_outs': [N] bool, 'final_observation'}.
    """

    def __init__(self, env: DeviceEnv, num_envs: int,
                 max_episode_steps: Optional[int] = None):
        self.env = env
        self.num_envs = num_envs
        self.max_episode_steps = (
            max_episode_steps if max_episode_steps is not None else env.max_episode_steps
        )

    def get_env_info(self) -> EnvInfo:
        return self.env.env_info()

    def reset(self, generator: torch.Generator):
        estate, obs = self.env.reset(self.num_envs, generator)
        steps = torch.zeros(self.num_envs, dtype=torch.int32, device=obs.device)
        return VecEnvState(estate=estate, generator=generator, steps=steps), obs

    def step(self, state: VecEnvState, actions):
        shape = self.env.step_noise_shape
        noise = None if shape is None else uniform(self.num_envs, shape, state.generator, self.env.device)
        estate, obs, reward, terminated, info = self.env.step(state.estate, actions, noise)
        steps = state.steps + 1
        terminated = terminated.to(torch.bool)
        if self.max_episode_steps is not None:
            truncated = steps >= self.max_episode_steps
        else:
            truncated = torch.zeros_like(terminated)
        done = terminated | truncated
        time_outs = truncated & ~terminated

        # in-step autoreset: every env draws a fresh episode and the done
        # rows take it; a data-dependent subset would cost a device sync
        r_estate, r_obs = self.env.reset(self.num_envs, state.generator)
        final_obs = obs  # the true final observation, before the autoreset
        estate = _pick(done, r_estate, estate)
        obs = _pick(done, r_obs, obs)
        steps = torch.where(done, torch.zeros_like(steps), steps)

        infos = dict(info or {})
        infos["time_outs"] = time_outs
        infos["final_observation"] = final_obs
        new_state = VecEnvState(estate=estate, generator=state.generator, steps=steps)
        return new_state, obs, reward, done, infos
