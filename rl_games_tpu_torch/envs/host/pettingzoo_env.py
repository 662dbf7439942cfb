"""PettingZoo multi-agent host envs.

Port of rl_games_tpu/envs/host/pettingzoo_env.py (:1-206; the reference's
rl_games/envs/multiwalker.py: the 3-agent continuous SISL multiwalker with an
optional central-value state, previous actions in the observation and
one-hot agent ids, driven through the Ray workers, common/vecenv.py:70-178).
N multiwalker instances step in-process behind the host vec-env contract:
rows agents-minor ([env0·walker0, env0·walker1, ...], as
``envs/device/multiagent.MultiAgentDeviceVecEnv`` lays them out),
same-step reset on done with ``infos['final_observation']``,
``infos['time_outs']`` per row and per-row central states. Everything is
numpy, as the JAX package's; pettingzoo is imported where it is used.
"""

from typing import Optional

import numpy as np

from rl_games_tpu_torch.envs.spaces import Box, EnvInfo


class MultiWalkerVecEnv:
    """N pettingzoo multiwalker_v9 parallel envs as one row-batched vec env.

    env_config keys mirror the reference's (envs/multiwalker.py:11-14 +
    configs/ppo_multiwalker.yaml): ``central_value``, ``use_prev_actions``,
    ``apply_agent_ids``, plus pass-through multiwalker kwargs (n_walkers,
    terminate_on_fall, …).
    """

    is_host_env = True
    autoreset_mode = "same_step"

    def __init__(self, num_actors: int, *, central_value: bool = False,
                 use_prev_actions: bool = False, apply_agent_ids: bool = False,
                 n_walkers: int = 3, seed: Optional[int] = None, **kwargs):
        from pettingzoo.sisl import multiwalker_v9

        self.num_envs = num_actors
        self.num_agents = n_walkers
        self.use_central_value = central_value
        self.use_prev_actions = use_prev_actions
        self.apply_agent_ids = apply_agent_ids
        self.seed = seed
        self.envs = [
            multiwalker_v9.parallel_env(n_walkers=n_walkers, **kwargs)
            for _ in range(num_actors)
        ]
        probe = self.envs[0]
        # agent name list is only populated after reset
        probe.reset(seed=0)
        self.agent_names = list(probe.agents)
        self.action_dim = int(probe.action_space(self.agent_names[0]).shape[0])
        base_dim = int(
            probe.observation_space(self.agent_names[0]).shape[0]
        )
        self._core_dim = base_dim + (
            self.action_dim if use_prev_actions else 0
        )
        self.obs_dim = self._core_dim + (n_walkers if apply_agent_ids else 0)
        self.state_dim = self._core_dim * n_walkers
        self._ids = np.eye(n_walkers, dtype=np.float32)
        self._prev_actions = np.zeros(
            (num_actors, n_walkers, self.action_dim), np.float32
        )
        # per-env episode counter folded into reset seeds: a fixed
        # `seed + i` would replay the identical episode initialization
        # after every autoreset (Connect4SelfPlayVecEnv does the same)
        self._ep_count = np.zeros(num_actors, np.int64)

    # -- row building -------------------------------------------------
    def _env_rows(self, env_i, obs_dict):
        """[A, core_dim] per-agent matrix for one env (missing agents --
        pettingzoo removes dead ones -- fill zeros, matching the static-row
        contract)."""
        rows = np.zeros((self.num_agents, self._core_dim), np.float32)
        for a, name in enumerate(self.agent_names):
            if name in obs_dict:
                vec = np.asarray(obs_dict[name], np.float32).reshape(-1)
                if self.use_prev_actions:
                    vec = np.concatenate([vec, self._prev_actions[env_i, a]])
                rows[a] = vec
        return rows

    def _batch(self, per_env_rows):
        """[N, A, core] -> obs rows [N*A, obs_dim] (+ per-row states)."""
        core = np.stack(per_env_rows)  # [N, A, core]
        obs = core
        if self.apply_agent_ids:
            ids = np.broadcast_to(
                self._ids, (self.num_envs, self.num_agents, self.num_agents)
            )
            obs = np.concatenate([core, ids], axis=-1)
        obs = obs.reshape(self.num_envs * self.num_agents, self.obs_dim)
        if not self.use_central_value:
            return obs
        states = core.reshape(self.num_envs, self.state_dim)
        states = np.repeat(states, self.num_agents, axis=0)
        return {"obs": obs, "states": states}

    # -- vec-env surface ----------------------------------------------
    def get_env_info(self) -> EnvInfo:
        return EnvInfo(
            observation_space=Box(shape=(self.obs_dim,), low=-1.0, high=1.0),
            action_space=Box(shape=(self.action_dim,), low=-1.0, high=1.0),
            state_space=(
                Box(shape=(self.state_dim,), low=-1.0, high=1.0)
                if self.use_central_value else None
            ),
            agents=self.num_agents,
        )

    def _reset_one(self, i):
        seed = (
            None if self.seed is None
            else self.seed + i + 7919 * int(self._ep_count[i])
        )
        self._ep_count[i] += 1
        obs, _ = self.envs[i].reset(seed=seed)
        self._prev_actions[i] = 0.0
        return self._env_rows(i, obs)

    def reset(self):
        return self._batch([self._reset_one(i) for i in range(self.num_envs)])

    def step(self, actions):
        actions = np.asarray(actions, np.float32).reshape(
            self.num_envs, self.num_agents, self.action_dim
        )
        per_env, rewards, dones, time_outs = [], [], [], []
        final_rows = []
        any_done = False
        for i, env in enumerate(self.envs):
            act = {
                name: np.clip(actions[i, a], -1.0, 1.0)
                for a, name in enumerate(self.agent_names)
                if name in env.agents
            }
            obs, rew, term, trunc, _ = env.step(act)
            self._prev_actions[i] = actions[i]
            row_done = np.array(
                [
                    bool(term.get(n, True)) or bool(trunc.get(n, True))
                    for n in self.agent_names
                ]
            )
            row_to = np.array(
                [
                    bool(trunc.get(n, False)) and not bool(term.get(n, False))
                    for n in self.agent_names
                ]
            )
            rewards.append(
                np.array(
                    [float(rew.get(n, 0.0)) for n in self.agent_names],
                    np.float32,
                )
            )
            # any agent terminating (or pettingzoo removing one, e.g.
            # terminate_on_fall=False dropping a fallen walker) ends the
            # episode for the whole env: the framework's rows are static
            # per agent, and streaming zero-obs "alive" rows for a dead
            # agent would feed fabricated transitions into GAE. (The
            # reference adapter, envs/multiwalker.py:35-38, KeyErrors in
            # this case.) With the default terminate_on_fall=True all
            # agents terminate together, so this matches all-done exactly.
            episode_done = (
                bool(row_done.any()) or len(env.agents) < self.num_agents
            )
            if episode_done:
                # same_step autoreset: surface the true final rows, return
                # the fresh episode's first rows (RayWorker, vecenv.py:105-116)
                final_rows.append(self._env_rows(i, obs))
                per_env.append(self._reset_one(i))
                # agents still alive when the env force-ends are cut off,
                # not terminated: flag time_outs so their value bootstraps
                row_to = row_to | ~row_done
                row_done = np.ones(self.num_agents, bool)
                any_done = True
            else:
                final_rows.append(None)
                per_env.append(self._env_rows(i, obs))
                row_done = np.zeros(self.num_agents, bool)
                row_to = np.zeros(self.num_agents, bool)
            dones.append(row_done)
            time_outs.append(row_to)

        obs = self._batch(per_env)
        infos = {
            "time_outs": np.concatenate(time_outs),
        }
        if any_done:
            final = [
                f if f is not None else p
                for f, p in zip(final_rows, per_env)
            ]
            infos["final_observation"] = self._batch(final)
        return (
            obs,
            np.concatenate(rewards),
            np.concatenate(dones),
            infos,
        )

    def close(self):
        for env in self.envs:
            env.close()
