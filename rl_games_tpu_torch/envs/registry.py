"""Environment registries.

Port of rl_games_tpu/envs/registry.py (the reference's
env_configurations.py:363-371 + vecenv.py:368-391): two levels, env name →
its configuration (``vecenv_type`` and, for device envs, ``env_creator``)
and vecenv type → the constructor of a vec env. ``DEVICE`` (also spelled
``JAX``, as the JAX package's configs name it) wraps a batched device env
in a ``DeviceVecEnv`` on the agent's device; the host types build numpy vec
envs that the trainers step on the host: ``GYMNASIUM`` (gymnasium's
vector envs or a thread pool), ``CPUENV`` (the native C++ stepper),
``DMCONTROL`` (dm_control suite tasks), ``MASKED_VELOCITY_CARTPOLE`` and
``ATARI`` (the deepmind wrapper stack), ``MULTIWALKER`` and ``CONNECT4``
(pettingzoo's multiwalker and connect-four). ``JAX_MULTIAGENT`` flattens a
multi-agent device env's agents into rows and ``JAX_SELFPLAY`` carries a
self-play env's opponent slots. Each host type imports its module, and with
it gymnasium, dm_control or pettingzoo, only when it is used. An unknown
name with no ``vecenv_type`` goes to GYMNASIUM, as in the JAX package
(:28-44).
"""

import importlib
import os
from typing import Callable, Dict

ENV_CONFIGURATIONS: Dict[str, dict] = {}
VECENV_TYPES: Dict[str, Callable] = {}


def register(name: str, config: dict):
    """env_configurations.register (:363-371): {'vecenv_type', 'env_creator'}."""
    ENV_CONFIGURATIONS[name] = config


def register_vecenv_type(name: str, func: Callable):
    """vecenv.register (:368-374): ``func(cfg, num_actors, device=..., **kwargs)``."""
    VECENV_TYPES[name] = func


def create_vec_env_from_config(config: dict, num_actors: int, device=None):
    """``create_vec_env`` for a config's ``env_name``, ``vecenv_type`` and
    ``env_config``. A config that needs a missing simulator gets its
    ImportError first: such an env_config may hold the simulator's own
    ``device`` or ``env_name``, which are no keywords here."""
    kwargs = dict(config.get("env_config", {}) or {})
    env_name, vecenv_type = config["env_name"], config.get("vecenv_type")
    vtype = vecenv_type or ENV_CONFIGURATIONS.get(env_name, {}).get("vecenv_type")
    if vtype in MISSING_SIMULATOR_TYPES:
        VECENV_TYPES[vtype]({"env_id": env_name}, num_actors)
    return create_vec_env(env_name, num_actors, vecenv_type=vecenv_type, device=device, **kwargs)


def create_vec_env(env_name: str, num_actors: int, vecenv_type: str = None, device=None, **kwargs):
    """vecenv.create_vec_env (:379-391): a vec env of ``num_actors`` envs.
    A device env lies on ``device`` (CUDA when None); a host env lies on
    the host whatever ``device`` is."""
    if env_name in ENV_CONFIGURATIONS:
        cfg = dict(ENV_CONFIGURATIONS[env_name])
        vtype = vecenv_type or cfg.get("vecenv_type", "DEVICE")
    else:
        cfg = {}
        vtype = vecenv_type or "GYMNASIUM"
    cfg.setdefault("env_id", env_name)
    if vtype not in VECENV_TYPES:
        raise ValueError(f"unknown vecenv_type '{vtype}' (registered: {sorted(VECENV_TYPES)})")
    return VECENV_TYPES[vtype](cfg, num_actors, device=device, **kwargs)


def _create_device_vecenv(cfg, num_actors, device=None, **kwargs):
    from rl_games_tpu_torch.envs.device.base import DeviceVecEnv

    kwargs.pop("seed", None)  # device envs draw from the agent's generator
    if "env_creator" not in cfg:
        raise ValueError(
            f"env '{cfg['env_id']}' is not a registered device env: the DEVICE vecenv type needs "
            "an 'env_creator' (envs.registry.register(name, {'vecenv_type': 'DEVICE', "
            "'env_creator': ...})); name a host vecenv_type to reach a gymnasium env"
        )
    env = cfg["env_creator"](device=device, **{**cfg.get("env_config", {}), **kwargs})
    return DeviceVecEnv(env, num_actors, max_episode_steps=cfg.get("max_episode_steps"))


def _create_gymnasium_vecenv(cfg, num_actors, device=None, **kwargs):
    from rl_games_tpu_torch.envs.host.gymnasium_env import GymnasiumVecEnv

    return GymnasiumVecEnv(cfg["env_id"], num_actors, **{**cfg.get("env_config", {}), **kwargs})


def _create_cpu_vecenv(cfg, num_actors, device=None, **kwargs):
    from rl_games_tpu_torch.envs.host.cpuenv import CpuVecEnv

    return CpuVecEnv(cfg["env_id"], num_actors, **{**cfg.get("env_config", {}), **kwargs})


def _create_dmcontrol_vecenv(cfg, num_actors, device=None, **kwargs):
    from rl_games_tpu_torch.envs.host.dm_control_env import create_dmcontrol_vecenv

    return create_dmcontrol_vecenv(cfg, num_actors, **kwargs)


def _create_masked_velocity_vecenv(cfg, num_actors, device=None, **kwargs):
    """CartPoleMaskedVelocity-v1: CartPole with its velocities zeroed
    (:345-366; env_configurations.py + wrappers.MaskVelocityWrapper
    :581-601)."""
    from functools import partial

    from rl_games_tpu_torch.envs.host.gymnasium_env import GymnasiumVecEnv
    from rl_games_tpu_torch.envs.host.wrappers import MaskVelocityWrapper

    wrapper = partial(MaskVelocityWrapper, name="CartPole-v1")
    return GymnasiumVecEnv("CartPole-v1", num_actors, wrappers=[wrapper],
                           **{**cfg.get("env_config", {}), **kwargs})


def _atari_ale_id(name: str) -> str:
    """Reference-era Atari ids ('BreakoutNoFrameskip-v4' (gym), 'Breakout-v5'
    (envpool)) as the ale_py registrations ('ALE/Breakout-v5')."""
    if name.startswith("ALE/"):
        return name
    base = name
    for suffix in ("NoFrameskip-v4", "Deterministic-v4", "-v4", "-v5", "-v0"):
        if base.endswith(suffix):
            base = base[: -len(suffix)]
            break
    return f"ALE/{base}-v5"


def _create_atari_vecenv(cfg, num_actors, device=None, **kwargs):
    """Deepmind-wrapped Atari over the gymnasium bridge (:369-424; the
    reference's atari factories, common/wrappers.py:663-721). It needs
    ale_py. The reference's atari configs put the gym id in
    ``env_config['name']`` and the wrapper options (skip, episode_life, ...)
    beside it (configs/atari/ppo_breakout.yaml)."""
    import functools

    from rl_games_tpu_torch.envs.host.gymnasium_env import GymnasiumVecEnv
    from rl_games_tpu_torch.envs.host.wrappers import wrap_deepmind

    try:
        import ale_py
        import gymnasium as gym

        gym.register_envs(ale_py)
    except ImportError as e:
        raise ImportError(
            "Atari envs need the ale_py package (not present in this image); the config and "
            "wrapper stack are ready for it"
        ) from e

    kwargs = {**cfg.get("env_config", {}), **kwargs}
    name = kwargs.pop("name", None) or cfg["env_id"]
    wrap_kwargs = {k: kwargs.pop(k) for k in ("skip", "episode_life", "clip_rewards", "frame_stack",
                                              "scale", "warp") if k in kwargs}
    kwargs.setdefault("wrappers", [functools.partial(wrap_deepmind, **wrap_kwargs)])
    # ALE v5 ids skip frames themselves and default to sticky actions; the
    # reference's NoFrameskip-v4 semantics are frameskip=1 (MaxAndSkipEnv
    # skips) with sticky actions off
    kwargs.setdefault("frameskip", 1)
    kwargs.setdefault("repeat_action_probability", 0.0)
    return GymnasiumVecEnv(_atari_ale_id(name), num_actors, **kwargs)


def _missing_sim(name: str, package: str, hint: str = ""):
    """A vecenv type that raises, naming the simulator a config needs (the
    JAX package's stubs, :266-302; the reference fails the same way at its
    lazy imports, vecenv.py:196-219)."""
    def create(cfg, num_actors, device=None, **kwargs):
        raise ImportError(
            f"env '{name}' needs the external '{package}' simulator, which is not in this image.{hint}"
        )

    return create


register_vecenv_type("DEVICE", _create_device_vecenv)
register_vecenv_type("JAX", _create_device_vecenv)
register_vecenv_type("GYMNASIUM", _create_gymnasium_vecenv)
register_vecenv_type("CPUENV", _create_cpu_vecenv)
register_vecenv_type("DMCONTROL", _create_dmcontrol_vecenv)
register_vecenv_type("MASKED_VELOCITY_CARTPOLE", _create_masked_velocity_vecenv)
register_vecenv_type("ATARI", _create_atari_vecenv)


def _creator(module: str, name: str):
    """A creator that imports its env class at first use; ``env_config``
    entries become its constructor's keyword arguments."""

    def create(device=None, **kwargs):
        return getattr(importlib.import_module(f"rl_games_tpu_torch.envs.device.{module}"), name)(
            device=device, **kwargs
        )

    return create


# --- device envs (:95-168) ---------------------------------------------------
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

# --- named gym ids (:216-232; the reference's env_configurations table,
# env_configurations.py:198-331). Unknown names also reach GYMNASIUM, so
# these rows document the zoo the host path covers -----------------------
for _gym_id in ("LunarLander-v3", "LunarLanderContinuous-v3", "BipedalWalker-v3",
                "BipedalWalkerHardcore-v3", "CarRacing-v3", "Acrobot-v1", "MountainCar-v0", "Ant-v5",
                "HalfCheetah-v5", "Hopper-v5", "Humanoid-v5", "Walker2d-v5", "Reacher-v5"):
    register(_gym_id, {"vecenv_type": "GYMNASIUM"})

# the native stepper's own env, with no gymnasium counterpart (:235)
register("Hopper2D-v0", {"vecenv_type": "CPUENV"})

# the reference's dm_control zoo (:245-257; configs/dm_control/*.yaml reach
# these envpool ids through Envpool(flatten_obs=True))
for _dmc_id in ("AcrobotSwingup-v1", "BallInCupCatch-v1", "CartpoleBalance-v1", "CartpoleSwingup-v1",
                "CheetahRun-v1", "FishSwim-v1", "HopperHop-v1", "HopperStand-v1", "HumanoidRun-v1",
                "HumanoidStand-v1", "HumanoidWalk-v1", "ManipulatorBringBall-v1", "PendulumSwingup-v1",
                "ReacherEasy-v1", "ReacherHard-v1", "WalkerRun-v1", "WalkerStand-v1", "WalkerWalk-v1"):
    register(_dmc_id, {"vecenv_type": "DMCONTROL"})

register("CartPoleMaskedVelocity-v1", {"vecenv_type": "MASKED_VELOCITY_CARTPOLE"})

# external-simulator bindings that the reference reaches through packages
# outside this image (:266-302): their configs resolve to an ImportError
# naming the missing dependency instead of a gym.make failure
MISSING_SIMULATOR_TYPES = set()
for _sim_name, _pkg, _hint in (
    ("smac", "SMAC (StarCraft II)", ""),
    ("smac_cnn", "SMAC (StarCraft II)", ""),
    ("smac_v2", "SMACv2 (StarCraft II)", ""),
    ("maniskill", "mani_skill", ""),
    ("myo_gym", "myosuite", ""),
    ("envpool", "envpool", " The GYMNASIUM / CPUENV / DMCONTROL backends cover its env zoo in-tree."),
    ("brax", "brax", " The device envs (Ant2D, Cheetah2D, Walker2D) are the in-tree brax-class analogs."),
    ("minigrid", "minigrid", ""),
    ("minigrid_env", "minigrid", ""),
    ("mjlab_go1_velocity", "mjlab (MuJoCo-Warp)", ""),
    ("mjlab_g1_velocity", "mjlab (MuJoCo-Warp)", ""),
    ("mjlab_lift_cube_yam", "mjlab (MuJoCo-Warp)", ""),
    ("mjlab_wujihand_reorient", "mjlab (MuJoCo-Warp)", ""),
    ("mjlab", "mjlab (MuJoCo-Warp)", ""),
):
    _vt = f"_MISSING_{_sim_name.upper()}"
    register_vecenv_type(_vt, _missing_sim(_sim_name, _pkg, _hint))
    register(_sim_name, {"vecenv_type": _vt})
    MISSING_SIMULATOR_TYPES.add(_vt)
# the reference's vecenv type of the mjlab configs (vecenv_type: MJLAB)
register_vecenv_type("MJLAB", _missing_sim("mjlab", "mjlab (MuJoCo-Warp)"))
MISSING_SIMULATOR_TYPES.add("MJLAB")



# --- the multi-agent and self-play envs, device and host ---------------------
def _create_multiagent_vecenv(cfg, num_actors, device=None, **kwargs):
    """A multi-agent device env (:305-316): ``num_actors`` envs of
    ``env.num_agents`` agent rows each, on ``device``."""
    from rl_games_tpu_torch.envs.device.multiagent import MultiAgentDeviceVecEnv

    kwargs.pop("seed", None)  # device envs draw from the agent's generator
    env = cfg["env_creator"](device=device, **{**cfg.get("env_config", {}), **kwargs})
    return MultiAgentDeviceVecEnv(env, num_actors, max_episode_steps=cfg.get("max_episode_steps"))


def _create_selfplay_vecenv(cfg, num_actors, device=None, **kwargs):
    """A self-play device env with embedded opponent slots (:477-495): the
    contract of the DEVICE type; a JAX_SELFPLAY registration may name its
    own ``env_creator``, else it is CompetitiveForage (whatever the env's
    name, as in the JAX package)."""
    from rl_games_tpu_torch.envs.device.selfplay import CompetitiveForage, SelfPlayVecEnv

    kwargs.pop("seed", None)
    creator = cfg.get("env_creator", CompetitiveForage)
    env = creator(device=device, **{**cfg.get("env_config", {}), **kwargs})
    return SelfPlayVecEnv(env, num_actors, max_episode_steps=cfg.get("max_episode_steps"))


def _create_multiwalker_vecenv(cfg, num_actors, device=None, **kwargs):
    """PettingZoo SISL multiwalker (:426-437; the reference's multiwalker_env
    binding, envs/multiwalker.py), stepped on the host."""
    from rl_games_tpu_torch.envs.host.pettingzoo_env import MultiWalkerVecEnv

    merged = {**cfg.get("env_config", {}), **kwargs}
    merged.pop("env_name", None)
    return MultiWalkerVecEnv(num_actors, **merged)


REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _create_connect4_vecenv(cfg, num_actors, device=None, **kwargs):
    """Connect-four self-play over pettingzoo.classic (:440-474; the
    reference's ma/ppo_connect4_self_play.yaml 'connect4_env' binding). The
    opponent's network comes from env_config['network_params'] or the
    training YAML at env_config['config_path'] (a path that does not exist
    as given is read against the repo root); it sits where the host path
    puts the policy (``host_inference_device`` of that YAML, on ``device``)."""
    from rl_games_tpu_torch.common.host_inference import rollout_device
    from rl_games_tpu_torch.envs.host.connect4_env import Connect4SelfPlayVecEnv
    from rl_games_tpu_torch.utils.device import resolve_device

    merged = {**cfg.get("env_config", {}), **kwargs}
    for k in ("name", "env_name", "self_play", "is_human", "random_agent"):
        merged.pop(k, None)
    network_params = merged.pop("network_params", None)
    config_path = merged.pop("config_path", None)
    if network_params is None and config_path:
        import yaml

        path = config_path if os.path.exists(config_path) else os.path.join(REPO_ROOT, config_path)
        with open(path) as f:
            network_params = yaml.safe_load(f)["params"]
    opp_device = None
    if network_params is not None:
        preference = (network_params.get("config") or {}).get("host_inference_device", "auto")
        opp_device = rollout_device(preference, resolve_device(device), network_params.get("network", {}))
    return Connect4SelfPlayVecEnv(num_actors, network_params=network_params, device=opp_device, **merged)


register_vecenv_type("JAX_MULTIAGENT", _create_multiagent_vecenv)
register_vecenv_type("JAX_SELFPLAY", _create_selfplay_vecenv)
register_vecenv_type("MULTIWALKER", _create_multiwalker_vecenv)
register_vecenv_type("CONNECT4", _create_connect4_vecenv)
register("cooperative_gather", {"vecenv_type": "JAX_MULTIAGENT",
                                "env_creator": _creator("multiagent", "CooperativeGather")})
register("competitive_forage", {"vecenv_type": "JAX_SELFPLAY"})
register("multiwalker_env", {"vecenv_type": "MULTIWALKER"})
register("connect4_env", {"vecenv_type": "CONNECT4"})


def _create_test_env(device=None, name="TestRnnEnv-v0", multi_obs_space=False, aux_loss=False, **kwargs):
    """The reference's ``test_env`` binding (:330-342): one flag-parameterized
    MemoryEnv; its env_config keys (hide_object, min_dist, max_dist,
    apply_dist_reward, multi_discrete_space, multi_head_value,
    use_central_value) pass through. ``multi_obs_space`` gives the
    dict-observation variant (which drops use_central_value), with
    ``aux_loss`` its 'aux_target'."""
    from rl_games_tpu_torch.envs.device import test_envs

    if multi_obs_space:
        kwargs.pop("use_central_value", None)
        return test_envs.DictObsMemoryEnv(aux_loss=aux_loss, device=device, **kwargs)
    return test_envs.MemoryEnv(device=device, **kwargs)


# the test envs (:497-533)
register("test_env", {"vecenv_type": "DEVICE", "env_creator": _create_test_env})
for _name, _cls in (("test_rnn_env", "MemoryEnv"), ("test_asymmetric_env", "AsymmetricEnv"),
                    ("test_masked_env", "MaskedMemoryEnv"), ("test_dict_obs_env", "DictObsMemoryEnv"),
                    ("test_asymmetric_continuous_env", "ContinuousAsymmetricEnv")):
    register(_name, {"vecenv_type": "DEVICE", "env_creator": _creator("test_envs", _cls)})
