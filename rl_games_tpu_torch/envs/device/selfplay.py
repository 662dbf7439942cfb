"""Self-play device environment: competitive foraging with an embedded
opponent policy.

Port of rl_games_tpu/envs/jax/selfplay.py. The reference closes the
self-play loop through RayWorker.set_weights (common/vecenv.py:141-152): the
manager pushes the learner's weights into worker processes that run the
opponent. Here the opponent's weights lie on the device in the vec-env
state: one slot per env, each a copy of the learner's ``state_dict``
(weights and normalizer stats) stacked over the env axis, which the step
applies to each env's opponent seat and which ``set_weights(indices, ...)``
overwrites for a rotating subset of envs (utils/self_play.SelfPlayManager).
The slots lie beside the env's own state, so the autoreset carries them
through unchanged (``_next_state``).

Game (:51-98): two players race to a food dot in a [-1, 1]² arena. Both
seats see the same observation layout ([own_pos, other - own, food - own],
6-dim) and move continuously, so the learner's weights drop straight into
the opponent seat. The reward is the zero-sum closeness differential plus
a terminal ±1 for reaching the food first.
"""

import dataclasses
from typing import Optional

import torch
from torch import nn

from rl_games_tpu_torch.envs.device.base import DeviceEnv, DeviceVecEnv, VecEnvState, uniform_between
from rl_games_tpu_torch.envs.spaces import Box, EnvInfo
from rl_games_tpu_torch.utils.device import resolve_device

STEP_SIZE = 0.12
CATCH_RADIUS = 0.15


@dataclasses.dataclass
class ForageState:
    self_pos: torch.Tensor  # [N, 2]
    opp_pos: torch.Tensor  # [N, 2]
    food: torch.Tensor  # [N, 2]


@dataclasses.dataclass
class SelfPlayVecEnvState(VecEnvState):
    # the opponents' slots: the learner's state_dict keys, each [N, ...]
    opp_weights: Optional[dict] = None


class CompetitiveForage(DeviceEnv):
    """Two-seat foraging race; the opponent seat's actions come from the
    vec env (``opp_actions``). The reset's uniforms are [N, 3, 2]: the
    learner's position, the opponent's and the food's (the JAX env's three
    keys, in split order)."""

    max_episode_steps = 64
    OBS_DIM = 6
    reset_noise_shape = (3, 2)

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def env_info(self):
        return EnvInfo(
            observation_space=Box(shape=(self.OBS_DIM,)),
            action_space=Box(shape=(2,), low=-1.0, high=1.0),
        )

    @staticmethod
    def obs_for(me, other, food):
        return torch.cat([me, other - me, food - me], dim=-1)

    def reset_from(self, noise):
        state = ForageState(
            self_pos=uniform_between(noise[:, 0], -1.0, 1.0),
            opp_pos=uniform_between(noise[:, 1], -1.0, 1.0),
            food=uniform_between(noise[:, 2], -0.7, 0.7),
        )
        return state, self.obs_for(state.self_pos, state.opp_pos, state.food)

    def step(self, estate: ForageState, actions, noise=None, opp_actions=None):
        """Both seats move at once (:74-98)."""
        action = torch.clamp(actions, -1.0, 1.0)
        opp_action = torch.clamp(opp_actions, -1.0, 1.0)
        self_pos = torch.clamp(torch.add(estate.self_pos, action, alpha=STEP_SIZE), -1.0, 1.0)
        opp_pos = torch.clamp(torch.add(estate.opp_pos, opp_action, alpha=STEP_SIZE), -1.0, 1.0)
        d_self = torch.linalg.vector_norm(self_pos - estate.food, dim=-1)
        d_opp = torch.linalg.vector_norm(opp_pos - estate.food, dim=-1)
        self_reach = d_self < CATCH_RADIUS
        opp_reach = d_opp < CATCH_RADIUS
        reward = torch.add(self_reach.to(torch.float32), d_opp - d_self, alpha=0.1) - opp_reach.to(torch.float32)
        state = ForageState(self_pos=self_pos, opp_pos=opp_pos, food=estate.food)
        obs = self.obs_for(self_pos, opp_pos, state.food)
        return state, obs, reward, self_reach | opp_reach, {
            "scores": (self_reach & ~opp_reach).to(torch.float32)
        }


class SelfPlayVecEnv(DeviceVecEnv):
    """A DeviceVecEnv whose step drives the opponent seat from the per-env
    slots in the vec-env state (:101-185)."""

    def __init__(self, env: CompetitiveForage, num_envs: int, max_episode_steps=None):
        super().__init__(env, num_envs, max_episode_steps)
        self._policy = None

    # -- wiring --------------------------------------------------------------
    def bind_policy(self, model: nn.Module):
        """Bound by the agent (and the player) once its model exists: the
        opponent seat applies the architecture the learner trains."""
        self._policy = model

    def init_opponent(self, env_state: VecEnvState, weights: dict) -> SelfPlayVecEnvState:
        """``weights`` (a ``state_dict``) copied into every env's slot."""
        stacked = {k: v[None].expand(self.num_envs, *v.shape).clone() for k, v in weights.items()}
        return SelfPlayVecEnvState(estate=env_state.estate, generator=env_state.generator,
                                   steps=env_state.steps, opp_weights=stacked)

    def set_weights(self, indices, weights: dict, env_state: Optional[SelfPlayVecEnvState] = None):
        """``weights`` into the slots of the envs ``indices`` (the self-play
        manager's protocol); every other slot stays as it was. Returns the
        new env state; ``env_state`` is left unchanged."""
        if env_state is None:
            raise ValueError("device self-play env needs env_state= to push weights into")
        # the manager's indices are global; a data-parallel rank fills the
        # slots of its own block of envs
        idx = torch.as_tensor(indices, dtype=torch.int64).to(self.env.device) - self.env_offset
        idx = idx[(idx >= 0) & (idx < self.num_envs)]
        new = {}
        for k, cur in env_state.opp_weights.items():
            cur = cur.clone()
            cur[idx] = weights[k].to(cur.device, cur.dtype)
            new[k] = cur
        return dataclasses.replace(env_state, opp_weights=new)

    # -- stepping ------------------------------------------------------------
    def _opp_actions(self, state: SelfPlayVecEnvState):
        """Each env's opponent action, deterministic, from its own slot: the
        policy's forward vmapped over the env axis (each linear layer one
        batched product over the slots; a fused MLP one grouped launch of its
        kernel over every slot's weights; :148-164)."""
        if self._policy is None:
            raise RuntimeError("bind_policy was never called")
        est = state.estate
        obs = CompetitiveForage.obs_for(est.opp_pos, est.self_pos, est.food)

        def one(weights, o):
            res = torch.func.functional_call(self._policy, weights, ("forward_play", o[None]),
                                             {"deterministic": True})
            return res["actions"][0]

        with torch.no_grad():
            return torch.func.vmap(one)(state.opp_weights, obs)

    def reset(self, generator: torch.Generator):
        state, obs = super().reset(generator)
        return SelfPlayVecEnvState(estate=state.estate, generator=state.generator, steps=state.steps), obs

    # step() itself is DeviceVecEnv's: only the env call (the opponent's
    # actions threaded in) and the state rebuild (the slots carried) differ
    def _env_step(self, state: SelfPlayVecEnvState, actions, noise):
        return self.env.step(state.estate, actions, noise, self._opp_actions(state))

    def _next_state(self, state: SelfPlayVecEnvState, estate, steps):
        return SelfPlayVecEnvState(estate=estate, generator=state.generator, steps=steps,
                                   opp_weights=state.opp_weights)
