"""Multi-agent device-resident environments.

Port of rl_games_tpu/envs/jax/multiagent.py. The reference's multi-agent
path (SMAC, MultiWalker) presents N envs x A agents as one batch of N·A
rows with a done shared by each env's rows (a2c_common.py:825-827:
env_done_indices = all_done_indices[::num_agents]). A ``MultiAgentDeviceEnv``
writes its dynamics over [N, A, ...] tensors; ``MultiAgentDeviceVecEnv``
flattens them into [N·A, ...] rows, agents-minor (:29-60), and repeats each
env's done, ``time_outs`` over its agent rows.
"""

import dataclasses

import torch

from rl_games_tpu_torch.envs.device.base import DeviceEnv, DeviceVecEnv, uniform_between
from rl_games_tpu_torch.envs.spaces import Box, EnvInfo
from rl_games_tpu_torch.utils.device import resolve_device


class MultiAgentDeviceEnv(DeviceEnv):
    """Batched multi-agent dynamics: observations, actions and rewards carry
    an agents axis after the env axis; terminated is per env."""

    num_agents: int = 1


class MultiAgentDeviceVecEnv(DeviceVecEnv):
    """[N, A, ...] → [N·A, ...] rows, agents-minor (the reference's batch
    layout). Actions come in as rows and go to the env as [N, A, ...]."""

    def __init__(self, env: MultiAgentDeviceEnv, num_envs: int, max_episode_steps=None):
        super().__init__(env, num_envs, max_episode_steps)
        self.num_agents = env.num_agents

    def _flatten(self, x):
        rows = self.num_envs * self.num_agents
        if isinstance(x, dict):
            return {k: v.reshape(rows, *v.shape[2:]) for k, v in x.items()}
        return x.reshape(rows, *x.shape[2:])

    def reset(self, generator: torch.Generator):
        state, obs = super().reset(generator)
        return state, self._flatten(obs)

    def step(self, state, actions):
        actions = actions.reshape(self.num_envs, self.num_agents, *actions.shape[1:])
        state, obs, rewards, done, infos = super().step(state, actions)
        infos = dict(infos)
        infos["time_outs"] = torch.repeat_interleave(infos["time_outs"], self.num_agents)
        infos["final_observation"] = self._flatten(infos["final_observation"])
        return (state, self._flatten(obs), rewards.reshape(self.num_envs * self.num_agents),
                torch.repeat_interleave(done, self.num_agents), infos)


# ---------------------------------------------------------------------------
# Cooperative test env (:63-120; the MultiWalker / test-fixture role,
# envs/multiwalker.py:6-81): A point-mass agents on a line meet their
# per-episode random targets; a shared reward; the central state sees every
# agent's position and target.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GatherState:
    pos: torch.Tensor  # [N, A]
    targets: torch.Tensor  # [N, A]
    steps: torch.Tensor  # [N] int32


class CooperativeGather(MultiAgentDeviceEnv):
    """Each agent sees only its own position and target; the shared reward
    is -mean(|pos - target|), so the agents must act together. The reset's
    uniforms are [N, 2, A]: the positions', then the targets' (the JAX
    env's two keys, in split order)."""

    num_agents = 3
    max_episode_steps = 64

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.reset_noise_shape = (2, self.num_agents)

    def env_info(self):
        a = self.num_agents
        return EnvInfo(
            observation_space=Box(shape=(2,)),
            action_space=Box(shape=(1,), low=-1.0, high=1.0),
            state_space=Box(shape=(2 * a,)),
            agents=a,
        )

    def _obs(self, s: GatherState):
        central = torch.cat([s.pos, s.targets], dim=-1)  # [N, 2A]
        return {
            "obs": torch.stack([s.pos, s.targets], dim=-1),  # [N, A, 2]
            "states": central[:, None, :].expand(-1, self.num_agents, -1),  # [N, A, 2A]
        }

    def reset_from(self, noise):
        s = GatherState(
            pos=uniform_between(noise[:, 0], -1.0, 1.0),
            targets=uniform_between(noise[:, 1], -1.0, 1.0),
            steps=torch.zeros(noise.shape[0], dtype=torch.int32, device=noise.device),
        )
        return s, self._obs(s)

    def step(self, estate: GatherState, actions, noise=None):
        # actions [N, A, 1]
        pos = torch.clamp(torch.add(estate.pos, actions[..., 0], alpha=0.1), -2.0, 2.0)
        s = GatherState(pos=pos, targets=estate.targets, steps=estate.steps + 1)
        # the mean as XLA computes it: the sum times the reciprocal of A
        dist = torch.abs(pos - estate.targets).sum(dim=-1) * (1.0 / self.num_agents)  # [N]
        reward = (-dist)[:, None].expand(-1, self.num_agents)
        return s, self._obs(s), reward, dist < 0.05, {}
