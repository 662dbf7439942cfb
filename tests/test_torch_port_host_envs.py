"""The port's host envs against the JAX package's, on the same inputs.

- CPUENV: the port's ctypes bridge (its library built by
  ``utils/native_build.py`` into ``build/native/``) against the JAX
  package's ``CpuVecEnv`` on all five native envs: same seed, same actions,
  bit for bit. The JAX bridge is pointed at a copy of ``native/cpuenv``
  under pytest's temporary directory, where its own ``make`` builds it, so
  this file never runs a build under ``native/`` beside tests/test_cpuenv.py.
- GYMNASIUM: ``GymnasiumVecEnv`` against the JAX one on CartPole-v1,
  Pendulum-v1 and HalfCheetah-v5 (2 envs), same-step and next-step
  autoreset, threaded against sync: obs, rewards, dones, time_outs and the
  final observations exactly.
- DMCONTROL: CartpoleBalance-v1 through both registries, exactly.
- The wrappers, each against its JAX counterpart on tests/test_wrappers.py's
  fake image env, exactly.
- The registry: the host types, the JAX package's fallback to GYMNASIUM,
  and what still raises.

Every JAX CpuVecEnv here (the registry's too) loads the library built in
the temporary copy: the tests that make one take the ``jax_cpuenv``
fixture.
"""

import shutil
from pathlib import Path

import gymnasium as gym
import numpy as np
import pytest
import torch

from rl_games_tpu.envs import registry as jregistry
from rl_games_tpu.envs.host import cpuenv as jcpuenv
from rl_games_tpu.envs.host import wrappers as JW
from rl_games_tpu.envs.host.gymnasium_env import GymnasiumVecEnv as JGymnasiumVecEnv
from rl_games_tpu_torch.envs import registry
from rl_games_tpu_torch.envs.host import wrappers as W
from rl_games_tpu_torch.envs.host.cpuenv import CpuVecEnv
from rl_games_tpu_torch.envs.host.gymnasium_env import GymnasiumVecEnv
from rl_games_tpu_torch.utils import native_build

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# CPUENV
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_cpuenv(tmp_path_factory):
    """The JAX package's CpuVecEnv over a library its own Makefile builds in
    a copy of native/cpuenv."""
    native = tmp_path_factory.mktemp("native") / "cpuenv"
    native.mkdir()
    for name in ("Makefile", "cpuenv.cc"):
        shutil.copy(ROOT / "native" / "cpuenv" / name, native / name)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcpuenv, "_NATIVE_DIR", str(native))
        mp.setattr(jcpuenv, "_LIB_PATH", str(native / "libcpuenv.so"))
        mp.setattr(jcpuenv, "_lib", None)
        jcpuenv.load_library()
        yield jcpuenv.CpuVecEnv


def random_actions(space, n, rng):
    if hasattr(space, "n"):
        return rng.integers(0, space.n, size=n).astype(np.float32)
    # beyond the bounds too: the C++ envs clip what they take
    return (rng.normal(size=(n, space.shape[0])) * 1.5).astype(np.float32)


@pytest.mark.parametrize("env_id, steps", [("CartPole-v1", 120), ("Pendulum-v1", 420), ("Acrobot-v1", 520),
                                           ("MountainCarContinuous-v0", 1010), ("Hopper2D-v0", 200)])
def test_cpuenv_matches_jax_bit_for_bit(jax_cpuenv, env_id, steps):
    port, jax_env = CpuVecEnv(env_id, 6, seed=11, num_threads=2), jax_cpuenv(env_id, 6, seed=11, num_threads=1)
    assert repr(port.get_env_info()) == repr(jax_env.get_env_info())
    assert port.max_episode_steps == jax_env.max_episode_steps
    np.testing.assert_array_equal(port.reset(), jax_env.reset())
    rng = np.random.default_rng(3)
    dones = time_outs = 0
    for _ in range(steps):
        a = random_actions(port.get_env_info().action_space, 6, rng)
        got, want = port.step(a), jax_env.step(a)
        for x, y in zip(got[:3], want[:3]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        assert got[3].keys() == want[3].keys()
        for k in got[3]:
            np.testing.assert_array_equal(got[3][k], want[3][k], err_msg=k)
        dones, time_outs = dones + int(got[2].sum()), time_outs + int(got[3]["time_outs"].sum())
    # every run ends episodes; Pendulum's and MountainCarContinuous's end at their step limits
    assert dones > 0 and (time_outs > 0 or env_id not in ("Pendulum-v1", "MountainCarContinuous-v0"))
    port.close()
    jax_env.close()


def test_cpuenv_is_built_under_build_not_native():
    path = native_build.library_path("cpuenv")
    assert path.parent == ROOT / "build" / "native" and path.name.startswith("libcpuenv_")
    CpuVecEnv("CartPole-v1", 2, num_threads=1).close()
    assert path.exists()


def test_native_build_without_a_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native_build.build("cpuenv")
    assert not any(tmp_path.iterdir())


def test_cpuenv_rejects_unknown_env():
    with pytest.raises(ValueError, match="unsupported env"):
        CpuVecEnv("Walker2d-v5", 2, num_threads=1)


# ---------------------------------------------------------------------------
# GYMNASIUM
# ---------------------------------------------------------------------------

GYM_CASES = {
    "CartPole-v1": {},
    "Pendulum-v1": {"max_episode_steps": 25},
    "HalfCheetah-v5": {"max_episode_steps": 20},
}


def assert_same_step(got, want):
    for x, y in zip(got[:3], want[:3]):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert got[3].keys() == want[3].keys()
    for k in got[3]:
        np.testing.assert_array_equal(got[3][k], want[3][k], err_msg=k)


@pytest.mark.parametrize("env_id", list(GYM_CASES))
@pytest.mark.parametrize("mode", ["same_step", "next_step", "threaded"])
def test_gymnasium_matches_jax(env_id, mode):
    kwargs = dict(GYM_CASES[env_id], seed=5)
    if mode == "threaded":
        kwargs["num_threads"] = 2
    else:
        kwargs["autoreset_mode"] = mode
    port, jax_env = GymnasiumVecEnv(env_id, 2, **kwargs), JGymnasiumVecEnv(env_id, 2, **kwargs)
    assert repr(port.get_env_info()) == repr(jax_env.get_env_info()) and port.autoreset_mode == jax_env.autoreset_mode
    np.testing.assert_array_equal(port.reset(), jax_env.reset())
    # the threaded vectorization against gymnasium's sync one, same-step
    sync = GymnasiumVecEnv(env_id, 2, **GYM_CASES[env_id], seed=5) if mode == "threaded" else None
    if sync is not None:
        np.testing.assert_array_equal(sync.reset(), port.reset())
        jax_env.reset()
    rng = np.random.default_rng(1)
    space = port.get_env_info().action_space
    dones = 0
    for _ in range(45):
        a = (rng.integers(0, 2, size=2) if hasattr(space, "n")
             else (rng.normal(size=(2, space.shape[0])) * 2).astype(np.float32))  # clipped by the bridge
        got = port.step(a)
        assert_same_step(got, jax_env.step(a))
        if sync is not None:
            assert_same_step(got, sync.step(a))
        dones += int(got[2].sum())
    assert dones > 0
    for env in (port, jax_env, sync):
        if env is not None:
            env.close()


def test_threaded_vecenv_rejects_bad_combos():
    with pytest.raises(ValueError):
        GymnasiumVecEnv("CartPole-v1", 2, num_threads=2, use_async=True)
    with pytest.raises(ValueError):
        GymnasiumVecEnv("CartPole-v1", 2, num_threads=2, autoreset_mode="next_step")


def test_gymnasium_same_step_resets_on_done():
    """The obs of a done row is the new episode's first; the true final obs
    is in the infos (test_host_envs.py's counterpart)."""
    env = GymnasiumVecEnv("CartPole-v1", 2, seed=0)
    env.reset()
    for _ in range(100):
        obs, rewards, dones, infos = env.step(np.ones(2, np.int64))
        if dones.any():
            i = int(np.flatnonzero(dones)[0])
            assert np.abs(infos["final_observation"][i][2]) > 0.2 and np.abs(obs[i][2]) < 0.1
            break
    else:
        pytest.fail("no episode ended")
    env.close()


def test_gymnasium_set_weights_reaches_sub_envs():
    class _OpponentEnv(gym.Env):
        observation_space = gym.spaces.Box(-1, 1, (2,), np.float32)
        action_space = gym.spaces.Discrete(2)

        def __init__(self):
            self.received = None

        def set_weights(self, weights):
            self.received = weights

        def reset(self, *, seed=None, options=None):
            return np.zeros(2, np.float32), {}

        def step(self, action):
            return np.zeros(2, np.float32), 0.0, False, False, {}

    gym.register(id="PortSetWeightsProbe-v0", entry_point=_OpponentEnv)
    try:
        env = GymnasiumVecEnv("PortSetWeightsProbe-v0", 3)
        env.set_weights([0, 2], {"w": torch.ones(4)})
        received = [e.unwrapped.received for e in env.env.envs]
        assert received[1] is None
        for r in (received[0], received[2]):
            assert r["w"].device.type == "cpu" and torch.equal(r["w"], torch.ones(4))
    finally:
        del gym.registry["PortSetWeightsProbe-v0"]


def test_action_masks_are_served_by_sync_sub_envs():
    class _MaskedEnv(gym.Env):
        observation_space = gym.spaces.Box(-1, 1, (2,), np.float32)
        action_space = gym.spaces.Discrete(3)

        def get_action_mask(self):
            return np.array([True, False, True])

        def reset(self, *, seed=None, options=None):
            return np.zeros(2, np.float32), {}

        def step(self, action):
            return np.zeros(2, np.float32), 0.0, False, False, {}

    gym.register(id="PortMaskProbe-v0", entry_point=_MaskedEnv)
    try:
        env = GymnasiumVecEnv("PortMaskProbe-v0", 2)
        assert env.supports_action_masks()
        np.testing.assert_array_equal(env.get_action_masks(), [[True, False, True]] * 2)
        assert not GymnasiumVecEnv("CartPole-v1", 2).supports_action_masks()
    finally:
        del gym.registry["PortMaskProbe-v0"]


# ---------------------------------------------------------------------------
# DMCONTROL
# ---------------------------------------------------------------------------


def test_dm_control_matches_jax():
    port = registry.create_vec_env("CartpoleBalance-v1", 2, seed=4)
    jax_env = jregistry.create_vec_env("CartpoleBalance-v1", 2, seed=4)
    assert type(port).__module__.startswith("rl_games_tpu_torch")
    assert repr(port.get_env_info()) == repr(jax_env.get_env_info())
    np.testing.assert_array_equal(port.reset(), jax_env.reset())
    rng = np.random.default_rng(2)
    for _ in range(20):
        a = (rng.normal(size=(2, 1)) * 1.5).astype(np.float32)
        assert_same_step(port.step(a), jax_env.step(a))
    port.close()
    jax_env.close()


@pytest.mark.parametrize("env_id", ["WalkerWalk-v1", "BallInCupCatch-v1", "CartpoleSwingupSparse-v1",
                                    "dm_control/walker-walk-v0", "HumanoidCMURun-v1"])
def test_dm_control_task_names_match_jax(env_id):
    from rl_games_tpu.envs.host.dm_control_env import resolve_task as jresolve
    from rl_games_tpu_torch.envs.host.dm_control_env import resolve_task

    assert resolve_task(env_id) == jresolve(env_id)


# ---------------------------------------------------------------------------
# wrappers (each against its JAX counterpart)
# ---------------------------------------------------------------------------


class FakeImageEnv(gym.Env):
    """tests/test_wrappers.py's fake env: 64x48 RGB frames encoding the step
    counter; lives."""

    def __init__(self, episode_len=20, lives=3):
        self.observation_space = gym.spaces.Box(0, 255, shape=(48, 64, 3), dtype=np.uint8)
        self.action_space = gym.spaces.Discrete(4)
        self.episode_len = episode_len
        self._lives = lives
        self.t = 0

    def lives(self):
        return self._lives

    def reset(self, **kwargs):
        super().reset(seed=kwargs.get("seed"))
        self.t = 0
        self._lives = 3
        return self._frame(), {}

    def _frame(self):
        return np.full((48, 64, 3), self.t % 256, np.uint8)

    def step(self, action):
        self.t += 1
        if self.t % 7 == 0:
            self._lives -= 1
        terminated = self._lives <= 0 or self.t >= self.episode_len
        return self._frame(), float(self.t), terminated, False, {}


WRAPPED = {
    "noop_reset": lambda M: M.NoopResetEnv(FakeImageEnv(episode_len=200), noop_max=5),
    "fire_reset": lambda M: M.FireResetEnv(FakeImageEnv()),
    "episodic_life": lambda M: M.EpisodicLifeEnv(FakeImageEnv(episode_len=100)),
    "max_and_skip": lambda M: M.MaxAndSkipEnv(FakeImageEnv(), skip=4),
    "clip_reward": lambda M: M.ClipRewardEnv(FakeImageEnv()),
    "warp_frame": lambda M: M.WarpFrame(FakeImageEnv()),
    "warp_color": lambda M: M.WarpFrame(FakeImageEnv(), width=40, height=30, grayscale=False),
    "frame_stack": lambda M: M.FrameStack(M.WarpFrame(FakeImageEnv()), 4),
    "frame_stack_flat": lambda M: M.FrameStack(gym.make("CartPole-v1"), k=3, flat=True),
    "scaled_float": lambda M: M.ScaledFloatFrame(FakeImageEnv()),
    "time_limit": lambda M: M.TimeLimit(FakeImageEnv(episode_len=1000), max_episode_steps=5),
    "mask_velocity": lambda M: M.MaskVelocityWrapper(gym.make("CartPole-v1"), "CartPole-v1"),
    "deepmind": lambda M: M.wrap_deepmind(FakeImageEnv(episode_len=200)),
    "deepmind_scaled": lambda M: M.wrap_deepmind(FakeImageEnv(episode_len=60), episode_life=False, scale=True,
                                                  clip_rewards=False),
}


def assert_equal_values(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_equal_values(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_equal_values(a[k], b[k])
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(WRAPPED))
def test_wrapper_matches_jax(name):
    port, jax_env = WRAPPED[name](W), WRAPPED[name](JW)
    assert port.observation_space == jax_env.observation_space
    for episode in range(2):
        assert_equal_values(port.reset(seed=episode), jax_env.reset(seed=episode))
        for i in range(30):
            a = i % port.action_space.n
            got, want = port.step(a), jax_env.step(a)
            for x, y in zip(got, want):
                assert_equal_values(x, y)
            if got[2] or got[3]:
                break


def test_mask_velocity_rejects_unknown_env():
    with pytest.raises(ValueError):
        W.MaskVelocityWrapper(gym.make("CartPole-v1"), "NotAnEnv-v0")


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name, vtype, cls", [
    ("CartPole-v1", "GYMNASIUM", GymnasiumVecEnv),
    ("CartPole-v1", "CPUENV", CpuVecEnv),
    ("Hopper2D-v0", None, CpuVecEnv),
    ("HalfCheetah-v5", None, GymnasiumVecEnv),
    ("InvertedPendulum-v5", None, GymnasiumVecEnv),  # unknown: GYMNASIUM, as in the JAX package
])
def test_registry_host_types(jax_cpuenv, name, vtype, cls):
    kwargs = {"seed": 1, **({"num_threads": 1} if cls is CpuVecEnv else {})}  # one worker under xdist
    env = registry.create_vec_env(name, 2, vecenv_type=vtype, device="cpu", **kwargs)
    jenv = jregistry.create_vec_env(name, 2, vecenv_type=vtype, **kwargs)
    assert isinstance(env, cls) and env.is_host_env and type(jenv).__name__ == cls.__name__
    assert repr(env.get_env_info()) == repr(jenv.get_env_info())
    env.close()
    jenv.close()


def test_masked_velocity_cartpole_matches_jax():
    port = registry.create_vec_env("CartPoleMaskedVelocity-v1", 2, seed=3)
    jax_env = jregistry.create_vec_env("CartPoleMaskedVelocity-v1", 2, seed=3)
    obs = port.reset()
    np.testing.assert_array_equal(obs, jax_env.reset())
    assert (obs[:, [1, 3]] == 0).all()
    for i in range(30):
        a = np.array([i % 2, (i // 3) % 2])
        assert_same_step(port.step(a), jax_env.step(a))


def test_atari_raises_the_jax_import_error():
    with pytest.raises(ImportError) as port_err:
        registry.create_vec_env("BreakoutNoFrameskip-v4", 2, vecenv_type="ATARI")
    with pytest.raises(ImportError) as jax_err:
        jregistry.create_vec_env("BreakoutNoFrameskip-v4", 2, vecenv_type="ATARI")
    assert str(port_err.value) == str(jax_err.value) and "ale_py" in str(port_err.value)


@pytest.mark.parametrize("name", ["envpool", "brax", "smac", "mjlab_go1_velocity"])
def test_external_simulators_raise_import_error(name):
    with pytest.raises(ImportError, match="not in this image"):
        registry.create_vec_env(name, 2)


def space_summary(space):
    """A space's kind and shapes (a dict space's per key), its discrete
    sizes and bounds, comparable across the two packages."""
    if hasattr(space, "spaces"):
        return {k: space_summary(v) for k, v in space.spaces}
    return (type(space).__name__, getattr(space, "shape", None), getattr(space, "n", None),
            np.asarray(getattr(space, "low", 0.0)).tolist(), np.asarray(getattr(space, "high", 0.0)).tolist())


@pytest.mark.parametrize("name, vtype, item", [
    ("multiwalker_env", None, "A12"),
    ("connect4_env", None, "A12"),
    ("CartPole-v1", "JAX_SELFPLAY", "A12"),
    ("test_dict_obs_env", None, "A8"),
], ids=["multiwalker_env-None-A12", "connect4_env-None-A12", "CartPole-v1-JAX_SELFPLAY-A12",
        "test_dict_obs_env-None-A8"])
def test_unported_envs_raise(name, vtype, item):
    """The registry refuses none of these now; ``item`` names the ROADMAP
    item that ported each. Each binds the env the JAX registry binds, with
    its env_info: the multiwalker and connect-four host envs and, under
    JAX_SELFPLAY, the self-play vec env around the name's registered env
    (CartPole here, in both packages; CompetitiveForage for a name without
    a creator) (A12's second part); test_dict_obs_env's dict observation
    space (A8 (a))."""
    from rl_games_tpu.envs import registry as jregistry

    env = registry.create_vec_env(name, 2, vecenv_type=vtype, device="cpu")
    jenv = jregistry.create_vec_env(name, 2, vecenv_type=vtype)
    info, jinfo = env.get_env_info(), jenv.get_env_info()
    for field in ("observation_space", "action_space", "state_space"):
        got, want = getattr(info, field), getattr(jinfo, field)
        assert (got is None) == (want is None), field
        if got is not None:
            assert space_summary(got) == space_summary(want), field
    assert (info.agents, info.value_size) == (jinfo.agents, jinfo.value_size)
    assert type(env.env if hasattr(env, "env") else env).__name__ == type(jenv.env if hasattr(jenv, "env")
                                                                            else jenv).__name__
    if name == "test_dict_obs_env":
        assert {k: v.shape for k, v in info.observation_space.spaces} == {"info": (4,), "pos": (2,)}
        assert info.action_space.n == 4
    for e in (env, jenv):
        if hasattr(e, "close"):
            e.close()


def test_device_type_needs_a_registered_env():
    with pytest.raises(ValueError, match="not a registered device env"):
        registry.create_vec_env("HalfCheetah-v5", 2, vecenv_type="DEVICE", device="cpu")

