"""DeepMind Control Suite host adapter.

Port of rl_games_tpu/envs/host/dm_control_env.py (:1-165). The reference
reaches dm_control through envpool's C++ build (rl_games/envs/envpool.py:
1-27, ``flatten_obs=True``) or through shimmy's gymnasium registrations
(configs/dm_control/cartpole_balance.yaml: ``dm_control/cartpole-balance-v0``).
This adapter wraps ``dm_control.suite`` tasks in the gymnasium 5-tuple API,
so that the host bridge (``GymnasiumVecEnv``: reset on done, time_outs,
final_observation) runs them unchanged.

Semantics:
- observation = the flat float32 concatenation of the suite's ordered
  Dict obs (envpool's ``flat_observation`` layout);
- episode end: dm_env marks the final timestep with ``last()``; an end with
  ``discount == 0`` is a true termination, one with ``discount > 0`` is the
  suite's own time limit → gymnasium ``truncated`` (infos['time_outs'],
  the value bootstrap of a2c_common.py:813-814);
- envpool-style ids (``WalkerWalk-v1``) and shimmy-style ids
  (``dm_control/walker-walk-v0``) both resolve to (domain, task).

This module needs gymnasium and imports dm_control where it is used; the
registry imports it only for a DMCONTROL config.
"""

import re

import gymnasium as gym
import numpy as np

# envpool-style CamelCase id -> (domain, task); the 16 tasks of the
# reference's configs/dm_control/ family plus the rest of the suite's
# benchmarking set resolve via the generic parser below; this table pins
# the irregular names.
_IRREGULAR = {
    "BallInCupCatch": ("ball_in_cup", "catch"),
    "PointMassEasy": ("point_mass", "easy"),
    "PointMassHard": ("point_mass", "hard"),
    "CartpoleThreePoles": ("cartpole", "three_poles"),
    "CartpoleTwoPoles": ("cartpole", "two_poles"),
    "CartpoleBalanceSparse": ("cartpole", "balance_sparse"),
    "CartpoleSwingupSparse": ("cartpole", "swingup_sparse"),
    "FingerTurnEasy": ("finger", "turn_easy"),
    "FingerTurnHard": ("finger", "turn_hard"),
    "ManipulatorBringBall": ("manipulator", "bring_ball"),
    "ManipulatorBringPeg": ("manipulator", "bring_peg"),
    "ManipulatorInsertBall": ("manipulator", "insert_ball"),
    "ManipulatorInsertPeg": ("manipulator", "insert_peg"),
    "HumanoidRunPureState": ("humanoid", "run_pure_state"),
    "HumanoidCMURun": ("humanoid_CMU", "run"),
    "HumanoidCMUStand": ("humanoid_CMU", "stand"),
}


def resolve_task(env_id: str):
    """'WalkerWalk-v1' / 'dm_control/walker-walk-v0' -> ('walker', 'walk')."""
    from dm_control import suite

    name = env_id
    if name.startswith("dm_control/"):
        name = name[len("dm_control/"):]
        name = re.sub(r"-v\d+$", "", name)
        domain, _, task = name.partition("-")
        return domain, task.replace("-", "_")
    name = re.sub(r"-v\d+$", "", name)
    if name in _IRREGULAR:
        return _IRREGULAR[name]
    words = re.findall(r"[A-Z][a-z0-9]*", name)
    domains = {d for d, _ in suite.ALL_TASKS}
    # longest domain prefix wins (Cartpole vs CartpoleBalance ambiguity)
    for split in range(len(words) - 1, 0, -1):
        domain = "_".join(w.lower() for w in words[:split])
        if domain in domains:
            task = "_".join(w.lower() for w in words[split:])
            return domain, task
    raise ValueError(f"cannot resolve dm_control task from id {env_id!r}")


class DMControlGymEnv(gym.Env):
    """Single dm_control suite task behind the gymnasium core-env API
    (reset(seed=…) -> (obs, info); step -> 5-tuple)."""

    metadata = {"render_modes": []}

    def __init__(self, domain: str, task: str, seed=None, **task_kwargs):
        from dm_control import suite

        self._domain, self._task = domain, task
        self._task_kwargs = dict(task_kwargs)
        self._env = suite.load(
            domain, task,
            task_kwargs={**task_kwargs, "random": seed},
        )
        spec = self._env.action_spec()
        self.action_space = gym.spaces.Box(
            low=np.asarray(spec.minimum, np.float32),
            high=np.asarray(spec.maximum, np.float32),
            shape=spec.shape, dtype=np.float32,
        )
        obs_spec = self._env.observation_spec()
        dim = int(sum(
            max(1, int(np.prod(s.shape))) for s in obs_spec.values()
        ))
        self.observation_space = gym.spaces.Box(
            low=-np.inf, high=np.inf, shape=(dim,), dtype=np.float32,
        )

    @staticmethod
    def _flatten(obs_dict):
        return np.concatenate(
            [np.asarray(v, np.float32).reshape(-1) for v in obs_dict.values()]
        )

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            from dm_control import suite

            self._env = suite.load(
                self._domain, self._task,
                task_kwargs={**self._task_kwargs, "random": seed},
            )
        ts = self._env.reset()
        return self._flatten(ts.observation), {}

    def step(self, action):
        ts = self._env.step(np.asarray(action, np.float64))
        terminated = bool(ts.last() and ts.discount == 0.0)
        truncated = bool(ts.last() and not terminated)
        return (
            self._flatten(ts.observation),
            float(ts.reward or 0.0),
            terminated,
            truncated,
            {},
        )

    def close(self):
        self._env.close()


def create_dmcontrol_vecenv(cfg, num_actors, **kwargs):
    """vecenv-type factory ('DMCONTROL'): N suite tasks behind the standard
    host bridge. Reference analog: envpool dm_control ids bound through
    Envpool(flatten_obs=True) (envs/envpool.py, configs/dm_control/*.yaml)."""
    from rl_games_tpu_torch.envs.host.gymnasium_env import GymnasiumVecEnv

    merged = {**cfg.get("env_config", {}), **kwargs}
    env_id = merged.pop("env_name", None) or cfg["env_id"]
    merged.pop("flatten_obs", None)  # always flattened here
    domain, task = resolve_task(env_id)
    seed = merged.pop("seed", None)
    use_async = merged.pop("use_async", False)

    # an id of the port's own in gymnasium's process-wide registry, so that
    # it never resolves to another package's adapter of the same task
    gym_id = f"rl_games_tpu_torch-dmc-{domain}-{task}-v0"
    if gym_id not in gym.registry:
        gym.register(
            id=gym_id,
            entry_point=lambda domain=domain, task=task, **kw: DMControlGymEnv(domain, task, **kw),
        )
    return GymnasiumVecEnv(gym_id, num_actors, seed=seed, use_async=use_async, **merged)
