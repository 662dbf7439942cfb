"""Environment registry.

Port of the device-env part of rl_games_tpu/envs/registry.py
(``create_vec_env`` :28-44 and the Ant2D entry :106-112; the reference's
env_configurations.py:363-371 + vecenv.py:368-391): env name → a creator of
a batched device env, wrapped in a ``DeviceVecEnv``. Only device envs are
ported; host (gymnasium / cpuenv) vec env types are not.
"""

from typing import Dict

from rl_games_tpu_torch.envs.device.base import DeviceVecEnv

ENV_CONFIGURATIONS: Dict[str, dict] = {}


def register(name: str, config: dict):
    """env_configurations.register (:363-371): {'vecenv_type', 'env_creator'}."""
    ENV_CONFIGURATIONS[name] = config


def create_vec_env(env_name: str, num_actors: int, vecenv_type: str = None,
                   device=None, **kwargs):
    """A DeviceVecEnv of ``num_actors`` envs on ``device`` (CUDA when None)."""
    if env_name not in ENV_CONFIGURATIONS:
        raise NotImplementedError(
            f"env '{env_name}' is not ported to rl_games_tpu_torch yet (see ROADMAP.md)"
        )
    cfg = ENV_CONFIGURATIONS[env_name]
    vtype = vecenv_type or cfg.get("vecenv_type", "DEVICE")
    if vtype not in ("DEVICE", "JAX"):
        raise NotImplementedError(f"vecenv_type '{vtype}' is not ported yet (see ROADMAP.md)")
    kwargs.pop("seed", None)  # device envs draw from the agent's generator
    env = cfg["env_creator"](device=device, **{**cfg.get("env_config", {}), **kwargs})
    return DeviceVecEnv(env, num_actors, max_episode_steps=cfg.get("max_episode_steps"))


def _create_ant2d(device=None):
    from rl_games_tpu_torch.envs.device.ant2d import Ant2D

    return Ant2D(device=device)


register("Ant2D", {"vecenv_type": "DEVICE", "env_creator": _create_ant2d})
