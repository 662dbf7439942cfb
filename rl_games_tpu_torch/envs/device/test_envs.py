"""Device-resident test environments, batched over envs.

Port of rl_games_tpu/envs/jax/test_envs.py (the reference's
rl_games/envs/test/ fixtures):

* ``MemoryEnv`` — the credit-assignment task (:26-158; the reference's
  rnn_env.py:5-158): a goal is shown at the start and, with
  ``hide_object``, hidden after the first step; the agent walks to it.
  Flags: ``multi_discrete_space`` (MultiDiscrete (2, 3) actions: head 0
  +x/-x, head 1 +y/-y/no move), ``multi_head_value`` (value_size 2, the
  reward [win, distance penalty]), ``use_central_value`` (observations
  {'obs', 'states'}, the state never hiding the goal),
  ``apply_dist_reward``. Every step reports ``infos['scores']``, 1 where the
  goal was reached.
* ``DictObsMemoryEnv`` (:160-201) — MemoryEnv with dict observations
  {'pos': 2, 'info': 4} and, with ``aux_loss``, 'aux_target' (1): the
  squared distance to the goal over (max_dist - min_dist)².
* ``MaskedMemoryEnv`` (:204-222) — MemoryEnv with action masks: a move along
  an axis is valid while the agent is inside ±max_dist on it.
* ``AsymmetricEnv`` (:225-256) — CartPole whose actor observation hides the
  velocities; the full state goes beside it as {'obs', 'states'}.
* ``ContinuousAsymmetricEnv`` (:259-296) — the same over Pendulum, hiding
  the angular velocity.

A reset takes uniforms (``reset_from``, ``DeviceEnv.reset``); where the JAX
package draws integers with ``jax.random.randint``, the port maps a uniform
with ``base.uniform_int``.
"""

import dataclasses

import torch

from rl_games_tpu_torch.envs.device.base import DeviceEnv, uniform_int
from rl_games_tpu_torch.envs.device.classic import CartPole, Pendulum
from rl_games_tpu_torch.envs.spaces import Box, DictSpace, Discrete, EnvInfo, MultiDiscrete
from rl_games_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class MemoryState:
    pos: torch.Tensor  # [N, 2] int32
    goal: torch.Tensor  # [N, 2] int32
    steps: torch.Tensor  # [N] int32


class MemoryEnv(DeviceEnv):
    """Reach a goal shown only at the start (``hide_object``); reward 1 on
    reaching it. Discrete(4) moves in ±x / ±y from the second step on."""

    # the goal's two directions, then its two distances
    reset_noise_shape = (4,)

    def __init__(self, max_steps=21, hide_object=True, min_dist=2, max_dist=8,
                 apply_dist_reward=False, multi_discrete_space=False,
                 multi_head_value=False, use_central_value=False, device=None):
        self.device = resolve_device(device)
        self.max_steps = max_steps
        self.hide_object = bool(hide_object)
        self.min_dist = int(min_dist)
        self.max_dist = int(max_dist)
        self.apply_dist_reward = bool(apply_dist_reward)
        self.multi_discrete_space = bool(multi_discrete_space)
        self.multi_head_value = bool(multi_head_value)
        self.use_central_value = bool(use_central_value)
        self.max_episode_steps = max_steps
        # a device tensor: PyTorch's CUDA kernels turn a division by a Python
        # number into a product with its reciprocal, one more rounding
        self._max_dist = torch.tensor(float(self.max_dist), dtype=torch.float32, device=self.device)

    def env_info(self):
        action_space = MultiDiscrete(nvec=(2, 3)) if self.multi_discrete_space else Discrete(n=4)
        return EnvInfo(
            observation_space=Box(shape=(6,)),
            action_space=action_space,
            state_space=Box(shape=(6,)) if self.use_central_value else None,
            value_size=2 if self.multi_head_value else 1,
        )

    def _obs(self, state: MemoryState):
        hidden = (state.steps > 0) if self.hide_object else torch.zeros_like(state.steps, dtype=torch.bool)
        show = torch.where(hidden, 0.0, 1.0)
        return torch.cat([state.pos.float(), state.goal.float() * show[:, None],
                          torch.stack([show, state.steps.float()], dim=-1)], dim=-1)

    def _state_obs(self, state: MemoryState):
        """The central value's state: the goal always shown (rnn_env.py:139-141)."""
        return torch.cat([state.pos.float(), state.goal.float(),
                          torch.stack([torch.ones_like(state.steps, dtype=torch.float32),
                                       state.steps.float()], dim=-1)], dim=-1)

    def _wrap(self, obs, state):
        if self.use_central_value:
            return {"obs": obs, "states": self._state_obs(state)}
        return obs

    def reset_from(self, noise):
        rand_dir = 1 - 2 * uniform_int(noise[:, 0:2], 0, 2)
        dist = uniform_int(noise[:, 2:4], self.min_dist, self.max_dist + 1 - self.min_dist)
        n = noise.shape[0]
        state = MemoryState(
            pos=torch.zeros((n, 2), dtype=torch.int32, device=noise.device),
            goal=(rand_dir * dist).to(torch.int32),
            steps=torch.zeros(n, dtype=torch.int32, device=noise.device),
        )
        # the reset observation always shows the goal, with flags [1, 0]
        flags = torch.tensor([1.0, 0.0], device=noise.device).expand(n, 2)
        obs = torch.cat([torch.zeros((n, 2), device=noise.device), state.goal.float(), flags], dim=-1)
        return state, self._wrap(obs, state)

    def _delta(self, actions):
        def plus_minus(plus, minus):
            return plus.to(torch.int32) - minus.to(torch.int32)

        if self.multi_discrete_space:
            a0, a1 = actions[:, 0], actions[:, 1]
            return torch.stack([plus_minus(a0 == 0, a0 == 1), plus_minus(a1 == 0, a1 == 1)], dim=-1)
        return torch.stack([plus_minus(actions == 0, actions == 1), plus_minus(actions == 2, actions == 3)], dim=-1)

    def step(self, estate: MemoryState, actions, noise=None):
        steps = estate.steps + 1
        # moves only from the second step on (rnn_env.py:74-84)
        can_move = (steps > 1)[:, None]
        pos = estate.pos + torch.where(can_move, self._delta(actions), 0)
        state = MemoryState(pos=pos, goal=estate.goal, steps=steps)
        dist = pos - estate.goal
        reached = (dist * dist).sum(-1) < 1
        win_reward = torch.where(reached, 1.0, 0.0)
        if self.apply_dist_reward:
            dist_reward = -0.1 * dist.abs().sum(-1).float() / self._max_dist
        else:
            dist_reward = torch.zeros_like(win_reward)
        if self.multi_head_value:
            reward = torch.stack([win_reward, dist_reward], dim=-1)
        else:
            reward = win_reward + dist_reward
        return state, self._wrap(self._obs(state), state), reward, reached, {"scores": win_reward}


class DictObsMemoryEnv(MemoryEnv):
    """MemoryEnv with dict observations {'pos': 2, 'info': 4 (+ 'aux_target':
    1)} (the reference's multi_obs_space variant, rnn_env.py:31-45): 'pos'
    is the position, 'info' the goal and the two flags; 'aux_target' the
    squared distance to the goal over (max_dist - min_dist)², the target
    of testnet_aux_loss's auxiliary head."""

    def __init__(self, aux_loss=False, device=None, **kwargs):
        super().__init__(device=device, **kwargs)
        self.aux_loss = bool(aux_loss)
        # XLA compiles the JAX env's division by the constant (max_dist -
        # min_dist)² into a product with its float32 reciprocal; the same
        # product here, by a device tensor
        self._inv_bound_sq = torch.tensor(1.0 / (self.max_dist - self.min_dist) ** 2, dtype=torch.float32,
                                          device=self.device)

    def env_info(self):
        spaces = {"pos": Box(shape=(2,)), "info": Box(shape=(4,))}
        if self.aux_loss:
            spaces["aux_target"] = Box(shape=(1,))
        return EnvInfo(observation_space=DictSpace.create(spaces), action_space=Discrete(n=4))

    def _split(self, obs, state: MemoryState):
        out = {"pos": obs[:, :2], "info": obs[:, 2:]}
        if self.aux_loss:
            d = state.goal - state.pos
            out["aux_target"] = (d * d).sum(-1, keepdim=True).float() * self._inv_bound_sq
        return out

    def reset_from(self, noise):
        state, obs = super().reset_from(noise)
        return state, self._split(obs, state)

    def step(self, estate: MemoryState, actions, noise=None):
        state, obs, reward, terminated, info = super().step(estate, actions, noise)
        return state, self._split(obs, state), reward, terminated, info


class MaskedMemoryEnv(MemoryEnv):
    """MemoryEnv with action masks: a move along an axis is valid while the
    agent is inside ±max_dist on it (the role SMAC plays for the
    reference's CategoricalMasked path)."""

    has_action_masks = True

    def action_masks(self, estate: MemoryState):
        """[N, 4] bool: +x, -x, +y, -y."""
        x, y, lim = estate.pos[:, 0], estate.pos[:, 1], self.max_dist
        return torch.stack([x < lim, x > -lim, y < lim, y > -lim], dim=-1)


class _Asymmetric(DeviceEnv):
    """An inner env whose actor observation is its own times ``mask``, with
    the full observation beside it as 'states'."""

    def __init__(self, inner: DeviceEnv, mask, device=None):
        self.inner = inner
        self.device = inner.device
        self.max_episode_steps = inner.max_episode_steps
        self.reset_noise_shape = inner.reset_noise_shape
        self.step_noise_shape = inner.step_noise_shape
        self.mask = torch.tensor(mask, dtype=torch.float32, device=self.device)

    def env_info(self):
        inner = self.inner.env_info()
        return EnvInfo(observation_space=inner.observation_space, action_space=inner.action_space,
                       state_space=inner.observation_space)

    def _wrap(self, obs):
        return {"obs": obs * self.mask, "states": obs}

    def reset_from(self, noise):
        estate, obs = self.inner.reset_from(noise)
        return estate, self._wrap(obs)

    def step(self, estate, actions, noise=None):
        estate, obs, reward, terminated, info = self.inner.step(estate, actions, noise)
        return estate, self._wrap(obs), reward, terminated, info


class AsymmetricEnv(_Asymmetric):
    """CartPole with the velocities hidden from the actor
    (MaskVelocityWrapper's mask for CartPole, wrappers.py:581-601)."""

    def __init__(self, device=None):
        super().__init__(CartPole(device=device), [1.0, 0.0, 1.0, 0.0])


class ContinuousAsymmetricEnv(_Asymmetric):
    """Pendulum with the angular velocity hidden from the actor."""

    def __init__(self, device=None):
        super().__init__(Pendulum(device=device), [1.0, 1.0, 0.0])
