"""Host-side gymnasium vectorized environments.

Port of rl_games_tpu/envs/host/gymnasium_env.py (:1-320; the reference's
common/gymnasium_vecenv.py): gymnasium.vector.{Sync,Async}VectorEnv, or an
in-process thread pool, behind the reference's 4-tuple vec-env contract —
``step(actions)`` → (obs, rewards, dones, infos) with dones = terminated |
truncated and ``infos['time_outs']`` = truncated ∧ ¬terminated
(common/ivecenv.py:12-20) — and gymnasium's spaces converted into the
port's ``envs/spaces.py``. Everything is numpy; the trainer moves it to
the device. gymnasium is imported where it is used, so that importing
this module does not need it.
"""

import os
from typing import Optional

import numpy as np

from rl_games_tpu_torch.envs.spaces import Box, DictSpace, Discrete, EnvInfo, MultiDiscrete


def convert_space(space):
    """A gymnasium space as the port's space description (:25-48)."""
    import gymnasium as gym

    if isinstance(space, gym.spaces.Box):
        # per-dimension bounds stay arrays when they are not uniform:
        # collapsing them to scalars would mis-scale actions for envs with
        # asymmetric or per-dim ranges (SAC action_scale/bias, PPO rescale)
        low, high = np.asarray(space.low), np.asarray(space.high)
        return Box(
            shape=tuple(space.shape),
            low=float(low.flat[0]) if np.all(low == low.flat[0]) else low.astype(np.float32),
            high=float(high.flat[0]) if np.all(high == high.flat[0]) else high.astype(np.float32),
        )
    if isinstance(space, gym.spaces.Discrete):
        return Discrete(n=int(space.n))
    if isinstance(space, gym.spaces.MultiDiscrete):
        return MultiDiscrete(nvec=tuple(int(n) for n in space.nvec))
    if isinstance(space, gym.spaces.Dict):
        return DictSpace.create({k: convert_space(v) for k, v in space.spaces.items()})
    raise ValueError(f"unsupported gymnasium space: {space}")


class _ThreadedSameStepVec:
    """In-process threaded vectorization (:51-131), the envpool role for any
    gymnasium env: MuJoCo and classic-control cores release the GIL inside
    their C step, so a persistent thread pool steps them in parallel
    without a process per env. Same-step autoreset as the reference's
    RayWorker (common/vecenv.py:70-178): on done the worker resets in
    place, the returned row is the new episode's first observation and the
    true final one travels in ``infos['final_obs']``. Speaks the slice of
    the gym.vector API the bridge uses (single_*_space, reset(seed), the
    5-tuple step, .envs, close)."""

    def __init__(self, thunks, num_threads):
        from concurrent.futures import ThreadPoolExecutor

        self.envs = [t() for t in thunks]
        self.single_observation_space = self.envs[0].observation_space
        self.single_action_space = self.envs[0].action_space
        n = len(self.envs)
        k = max(1, min(int(num_threads), n))
        bounds = np.linspace(0, n, k + 1).astype(int)
        self._blocks = [range(bounds[i], bounds[i + 1]) for i in range(k) if bounds[i] < bounds[i + 1]]
        self._pool = ThreadPoolExecutor(len(self._blocks))

    def reset(self, seed=None):
        obs = [e.reset(seed=None if seed is None else seed + i)[0] for i, e in enumerate(self.envs)]
        return self._stack(obs), {}

    @staticmethod
    def _stack(rows):
        if isinstance(rows[0], dict):
            return {k: _ThreadedSameStepVec._stack([r[k] for r in rows]) for k in rows[0]}
        return np.stack(rows)

    def step(self, actions):
        n = len(self.envs)
        obs = [None] * n
        rewards = np.zeros(n, np.float64)
        terminated = np.zeros(n, bool)
        truncated = np.zeros(n, bool)
        final = [None] * n

        def run_block(idx):
            for i in idx:
                o, r, te, tr, _ = self.envs[i].step(actions[i])
                rewards[i] = r
                terminated[i] = te
                truncated[i] = tr
                if te or tr:
                    final[i] = o
                    o = self.envs[i].reset()[0]
                obs[i] = o

        list(self._pool.map(run_block, self._blocks))  # list() raises a worker's exception
        infos = {}
        if any(f is not None for f in final):
            fo = np.empty(n, object)
            for i, f in enumerate(final):
                fo[i] = f
            infos["final_obs"] = fo
        return self._stack(obs), rewards, terminated, truncated, infos

    def close(self):
        self._pool.shutdown(wait=False)
        for e in self.envs:
            e.close()


class GymnasiumVecEnv:
    """The single-agent host bridge (:133-320; gymnasium_vecenv.py:100-258).

    The default autoreset is same-step (reset on done), as the reference's
    RayWorker does it (common/vecenv.py:70-178): the row after a done is a
    new episode's first row, so a PPO dataset holds no rows from after an
    episode's end, and the true final observation of each done row is in
    ``infos['final_observation']`` (SAC's replay bootstraps from it).
    ``autoreset_mode='next_step'`` gives envpool's semantics instead; the
    SAC trainer takes both, the PPO host path only same-step."""

    is_host_env = True

    def __init__(self, env_id: str, num_actors: int, *, use_async: bool = False, num_threads: int = 0,
                 seed: Optional[int] = None, wrappers=None, autoreset_mode: str = "same_step",
                 **env_kwargs):
        import gymnasium as gym

        self.num_envs = num_actors
        self.env_id = env_id
        self.autoreset_mode = autoreset_mode

        def make(i):
            def thunk():
                env = gym.make(env_id, **env_kwargs)
                for w in wrappers or []:
                    env = w(env)
                return env

            return thunk

        if num_threads and use_async:
            raise ValueError(
                "env_config: pick one of num_threads (in-process thread pool) or use_async "
                "(process-per-env) vectorization"
            )
        if num_threads:
            if autoreset_mode != "same_step":
                raise ValueError("num_threads vectorization implements same_step (reset-on-done) autoreset only")
            if num_threads < 0:  # -1 = one thread per host core
                num_threads = os.cpu_count() or 1
            self.env = _ThreadedSameStepVec([make(i) for i in range(num_actors)], num_threads)
        else:
            gym_mode = (gym.vector.AutoresetMode.SAME_STEP if autoreset_mode == "same_step"
                        else gym.vector.AutoresetMode.NEXT_STEP)
            cls = gym.vector.AsyncVectorEnv if use_async else gym.vector.SyncVectorEnv
            self.env = cls([make(i) for i in range(num_actors)], autoreset_mode=gym_mode)
        self.seed = seed
        self._action_is_discrete = isinstance(self.env.single_action_space, gym.spaces.Discrete)
        low = getattr(self.env.single_action_space, "low", None)
        high = getattr(self.env.single_action_space, "high", None)
        self._action_low = None if low is None else np.asarray(low, np.float32)
        self._action_high = None if high is None else np.asarray(high, np.float32)
        # the episode limit from the registry's spec (holds for Sync and Async)
        try:
            self.max_episode_steps = gym.spec(env_id).max_episode_steps
        except gym.error.Error:
            self.max_episode_steps = None

    def get_env_info(self) -> EnvInfo:
        return EnvInfo(
            observation_space=convert_space(self.env.single_observation_space),
            action_space=convert_space(self.env.single_action_space),
        )

    @staticmethod
    def _cast(obs):
        """Dict obs pass through per key; uint8 image obs stay uint8 (the
        trainer casts them on the device, a2c_common.py:540-575), the rest
        become float32 (:215-222)."""
        if isinstance(obs, dict):
            return {k: GymnasiumVecEnv._cast(v) for k, v in obs.items()}
        a = np.asarray(obs)
        return a if a.dtype == np.uint8 else a.astype(np.float32)

    def reset(self):
        obs, _ = self.env.reset(seed=self.seed)
        return self._cast(obs)

    def step(self, actions):
        actions = np.asarray(actions)
        if self._action_is_discrete:
            actions = actions.astype(np.int64)
        elif self._action_low is not None:  # (:230-240)
            actions = np.clip(actions.astype(np.float32), self._action_low, self._action_high)
        obs, rewards, terminated, truncated, infos = self.env.step(actions)
        dones = np.logical_or(terminated, truncated)
        out_infos = {"time_outs": np.logical_and(truncated, ~terminated)}
        # the final observation of done rows (:246-266): under gymnasium 1.x
        # next-step autoreset the obs returned at the done step is the true
        # final one (the reset comes with the following step); the same-step
        # vectorizations hand it over in the infos
        final = None
        for key in ("final_obs", "final_observation"):
            if key in infos:
                final = infos[key]
                break
        obs = self._cast(obs)
        if final is not None and not isinstance(obs, dict):
            final_obs = np.array(obs, copy=True)
            for i, f in enumerate(final):
                if f is not None:
                    final_obs[i] = f
            out_infos["final_observation"] = final_obs
        elif final is not None and isinstance(obs, dict):
            final_obs = {k: np.array(v, copy=True) for k, v in obs.items()}
            for i, f in enumerate(final):
                if f is not None:
                    for k in final_obs:
                        final_obs[k][i] = f[k]
            out_infos["final_observation"] = final_obs
        elif dones.any():
            out_infos["final_observation"] = obs
        return obs, np.asarray(rewards, np.float32), dones, out_infos

    def supports_action_masks(self) -> bool:
        """Whether masks can be served (:273-283): sync vectorization (async
        sub-envs live in other processes) and sub-envs that expose
        get_action_mask."""
        return hasattr(self.env, "envs") and all(
            hasattr(e.unwrapped, "get_action_mask") for e in self.env.envs
        )

    def get_action_masks(self):
        """RayWorker.get_action_mask analog (common/vecenv.py:132-139): the
        sub-envs' masks, stacked (sync vectorization only)."""
        if not hasattr(self.env, "envs"):
            raise ValueError(
                "use_action_masks requires sync vectorization (env_config use_async: False): "
                "AsyncVectorEnv sub-envs are in other processes and unreachable for masks"
            )
        return np.stack([e.unwrapped.get_action_mask() for e in self.env.envs])

    def set_weights(self, indices, weights):
        """RayWorker.set_weights analog (common/vecenv.py:141-152, :295):
        push opponent weights, as CPU tensors, into the sub-envs at
        ``indices`` (sync vectorization; async broadcasts to every sub-env).
        Sub-envs without ``set_weights`` are skipped."""
        from rl_games_tpu_torch.utils.checkpoint import tree_to_plain

        w = tree_to_plain(weights)
        if hasattr(self.env, "envs"):
            # the first provider of set_weights down each wrapper chain
            for i in indices:
                target = self.env.envs[i]
                while target is not None and not hasattr(target, "set_weights"):
                    target = getattr(target, "env", None)
                if target is not None:
                    target.set_weights(w)
        else:
            # process-per-env vectorization has no per-index call: broadcast,
            # the reference's common case of pushing to every worker
            # (vecenv.py:154-162)
            self.env.call("set_weights", w)

    def close(self):
        self.env.close()
