"""Environment registry.

Port of the device-env part of rl_games_tpu/envs/registry.py
(``create_vec_env`` :28-44, the classic, pixel and physics entries
:95-168; the reference's env_configurations.py:363-371 + vecenv.py:368-391):
env name → a creator of a batched device env, wrapped in a
``DeviceVecEnv``. Only device envs are ported; host (gymnasium / cpuenv)
vec env types are not.
"""

import importlib
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


def _creator(module: str, name: str):
    """A creator that imports its env class at first use; ``env_config``
    entries become its constructor's keyword arguments."""

    def create(device=None, **kwargs):
        return getattr(importlib.import_module(f"rl_games_tpu_torch.envs.device.{module}"), name)(
            device=device, **kwargs
        )

    return create


for _name, _module, _cls in (
    ("CartPole-v1", "classic", "CartPole"),
    ("Pendulum-v1", "classic", "Pendulum"),
    ("MountainCarContinuous-v0", "classic", "MountainCarContinuous"),
    ("PixelCatcher-v0", "pixel", "PixelCatcher"),
    ("DevicePong-v0", "pong", "DevicePong"),
    ("DeviceBreakout-v0", "breakout", "DeviceBreakout"),
    ("Ant2D", "ant2d", "Ant2D"),
    ("Ant3D", "ant3d", "Ant3D"),
    ("Humanoid3D", "humanoid3d", "Humanoid3D"),
    ("Cheetah2D", "locomotion2d", "Cheetah2D"),
    ("Walker2D", "locomotion2d", "Walker2D"),
    ("Arm2D", "arm2d", "Arm2D"),
    ("Grasp2D", "arm2d", "Grasp2D"),
):
    register(_name, {"vecenv_type": "DEVICE", "env_creator": _creator(_module, _cls)})
