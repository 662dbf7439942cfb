"""Device-resident vectorized environment core.

Port of rl_games_tpu/envs/jax/base.py ``JaxVecEnv`` (:34-162). The JAX
package writes one environment's dynamics and vmaps it; here a
``DeviceEnv`` writes its dynamics batched over the env axis directly:

    env_info() -> EnvInfo                        (static spaces)
    reset_from(noise) -> (estate, obs)
    step(estate, actions, noise) -> (estate, obs, reward, terminated, info)

``estate`` is a dataclass of [N, ...] tensors; ``obs`` a tensor or the
asymmetric envs' {'obs', 'states'} dict of them. An env with
``has_action_masks`` serves ``action_masks(estate)``. ``DeviceVecEnv`` adds
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
from rl_games_tpu_torch.parallel.mesh import draw_rows, shard_rows


class DeviceEnv:
    """Batched dynamics over an env axis. Subclasses hold only constants."""

    max_episode_steps: Optional[int] = None
    step_noise_shape: Optional[Tuple[int, ...]] = None  # per env; None: the step draws nothing
    reset_noise_shape: Tuple[int, ...] = ()
    has_action_masks: bool = False
    device: torch.device

    def env_info(self) -> EnvInfo:
        raise NotImplementedError

    def action_masks(self, estate):
        """[N, num_actions] bool, the valid actions of each env (the
        reference's IVecEnv.get_action_masks, common/ivecenv.py:24-26)."""
        raise NotImplementedError(f"{type(self).__name__} serves no action masks")

    def reset(self, num_envs: int, generator: torch.Generator):
        """``reset_from`` of the reset's uniforms drawn from ``generator``."""
        return self.reset_from(uniform(num_envs, self.reset_noise_shape, generator, self.device))

    def reset_from(self, noise: torch.Tensor):
        raise NotImplementedError

    def step(self, estate, actions, noise: Optional[torch.Tensor] = None):
        raise NotImplementedError


def uniform(num_envs: int, shape, generator: torch.Generator, device) -> torch.Tensor:
    """[num_envs, *shape] float32 uniforms in [0, 1); from a data-parallel
    rank's generator, its block of the world's draw (parallel/mesh.py)."""
    return draw_rows(torch.rand, (num_envs, *shape), generator, device=device)


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


def uniform_int(u, low: int, n: int):
    """u in [0, 1) mapped to the integers low .. low + n - 1, int32: what
    the JAX package draws with ``jax.random.randint(low, low + n)``."""
    return (low + torch.clamp(torch.floor(u * n), max=n - 1)).to(torch.int32)


@dataclasses.dataclass
class VecEnvState:
    estate: Any  # dataclass of [N, ...] tensors
    generator: torch.Generator  # reset noise
    steps: torch.Tensor  # [N] int32 steps-in-episode


def _pick(done, new, old):
    """where(done, new, old) row-wise, over a tensor or a dataclass or dict
    of them (the {'obs', 'states'} observations)."""
    if dataclasses.is_dataclass(old):
        return dataclasses.replace(old, **{
            f.name: _pick(done, getattr(new, f.name), getattr(old, f.name))
            for f in dataclasses.fields(old)
        })
    if isinstance(old, dict):
        return {k: _pick(done, new[k], v) for k, v in old.items()}
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
        self.env_offset = 0  # the first env of a data-parallel rank's block
        self.max_episode_steps = (
            max_episode_steps if max_episode_steps is not None else env.max_episode_steps
        )

    def get_env_info(self) -> EnvInfo:
        return self.env.env_info()

    @property
    def has_action_masks(self) -> bool:
        return self.env.has_action_masks

    def get_action_masks(self, state: "VecEnvState"):
        """[N, num_actions] bool valid-action masks of the envs' current
        states (base.py:81-87)."""
        return self.env.action_masks(state.estate)

    def reset(self, generator: torch.Generator):
        estate, obs = self.env.reset(self.num_envs, generator)
        steps = torch.zeros(self.num_envs, dtype=torch.int32, device=self.env.device)
        return VecEnvState(estate=estate, generator=generator, steps=steps), obs

    def take_rows(self, state: VecEnvState, lo: int, hi: int) -> VecEnvState:
        """This vec env cut to envs [lo, hi) of its ``num_envs``, one rank's
        block of a data-parallel world (parallel/mesh.py): returns the
        state's rows, whose generator draws the world's rows and keeps
        these, so the block steps as the single process's envs [lo, hi)."""
        state = shard_rows(state, lo, hi, self.num_envs)
        self.num_envs, self.env_offset = hi - lo, self.env_offset + lo
        return state

    def _env_step(self, state: VecEnvState, actions, noise):
        """The env's batched step; a subclass threads extra per-step inputs
        through here (the self-play opponent's actions) without forking the
        autoreset contract of ``step`` (base.py:118-122)."""
        return self.env.step(state.estate, actions, noise)

    def _next_state(self, state: VecEnvState, estate, steps):
        """The vec-env state after a step; a subclass carries its extra
        fields through here, past the autoreset (base.py:124-126)."""
        return VecEnvState(estate=estate, generator=state.generator, steps=steps)

    def step(self, state: VecEnvState, actions):
        shape = self.env.step_noise_shape
        noise = None if shape is None else uniform(self.num_envs, shape, state.generator, self.env.device)
        estate, obs, reward, terminated, info = self._env_step(state, actions, noise)
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
        return self._next_state(state, estate, steps), obs, reward, done, infos
