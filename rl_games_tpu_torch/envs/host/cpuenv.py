"""ctypes bridge to the native C++ threaded env stepper (native/cpuenv).

Port of rl_games_tpu/envs/host/cpuenv.py (:1-143), the package's envpool
analog (the reference reaches C++ vec envs through envpool,
rl_games/envs/envpool.py:1-139): batched stepping over a persistent pool of
worker threads, same-step autoreset with the true final observation kept
for each done row, time-outs, behind the host vec-env contract
(``reset()`` → obs; ``step(actions)`` → obs, rewards, dones, infos with
``time_outs`` and ``final_observation``, all numpy). The library is built
from ``native/cpuenv/cpuenv.cc`` into ``build/native/`` at first use
(``utils/native_build.py``); CartPole-v1, Pendulum-v1, Acrobot-v1,
MountainCarContinuous-v0 and Hopper2D-v0 run in it.
"""

import ctypes

import numpy as np

from rl_games_tpu_torch.envs.spaces import Box, Discrete, EnvInfo
from rl_games_tpu_torch.utils import native_build

_lib = None


def load_library():
    """The stepper's library with every function's argument and result types
    declared (built first if needed)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = native_build.load("cpuenv")
    lib.cpuenv_create.restype = ctypes.c_void_p
    lib.cpuenv_create.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_uint64, ctypes.c_int]
    for fn in ("cpuenv_obs_dim", "cpuenv_act_dim", "cpuenv_discrete", "cpuenv_num_actions",
               "cpuenv_max_steps"):
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    for fn in ("cpuenv_act_low", "cpuenv_act_high"):
        getattr(lib, fn).restype = ctypes.c_float
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.cpuenv_reset.restype = None
    lib.cpuenv_reset.argtypes = [ctypes.c_void_p, f32p]
    lib.cpuenv_step.restype = None
    lib.cpuenv_step.argtypes = [ctypes.c_void_p, f32p, f32p, f32p, u8p, u8p, f32p]
    lib.cpuenv_destroy.restype = None
    lib.cpuenv_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class CpuVecEnv:
    """Native threaded vec env behind the host contract. ``num_threads`` 0
    takes one worker per core the C++ runtime sees
    (``std::thread::hardware_concurrency``)."""

    is_host_env = True
    autoreset_mode = "same_step"

    def __init__(self, env_id: str, num_actors: int, *, seed: int = 0, num_threads: int = 0, **_):
        lib = load_library()
        self._lib = lib
        self._h = lib.cpuenv_create(env_id.encode(), num_actors, seed, num_threads)
        if not self._h:
            raise ValueError(f"cpuenv: unsupported env '{env_id}'")
        self.num_envs = num_actors
        self.obs_dim = lib.cpuenv_obs_dim(self._h)
        self.act_dim = lib.cpuenv_act_dim(self._h)
        self.discrete = bool(lib.cpuenv_discrete(self._h))
        self.num_actions = lib.cpuenv_num_actions(self._h)
        self.max_episode_steps = lib.cpuenv_max_steps(self._h)
        n = num_actors
        self._obs = np.zeros((n, self.obs_dim), np.float32)
        self._final = np.zeros((n, self.obs_dim), np.float32)
        self._rew = np.zeros(n, np.float32)
        self._done = np.zeros(n, np.uint8)
        self._timeout = np.zeros(n, np.uint8)

    def get_env_info(self) -> EnvInfo:
        if self.discrete:
            action_space = Discrete(n=self.num_actions)
        else:
            # scalar bounds, as the JAX bridge gives them (ROADMAP.md §3,
            # fault 2: Hopper2D's scale is 1 and Pendulum has one dim)
            action_space = Box(
                shape=(self.act_dim,),
                low=float(self._lib.cpuenv_act_low(self._h)),
                high=float(self._lib.cpuenv_act_high(self._h)),
            )
        return EnvInfo(observation_space=Box(shape=(self.obs_dim,)), action_space=action_space)

    def reset(self):
        self._lib.cpuenv_reset(self._h, self._obs)
        return self._obs.copy()

    def step(self, actions):
        actions = np.ascontiguousarray(np.asarray(actions, np.float32).reshape(self.num_envs, -1))
        self._lib.cpuenv_step(self._h, actions, self._obs, self._rew, self._done, self._timeout,
                              self._final)
        infos = {
            "time_outs": self._timeout.astype(bool),
            "final_observation": self._final.copy(),
        }
        return self._obs.copy(), self._rew.copy(), self._done.astype(bool), infos

    def close(self):
        if self._h:
            self._lib.cpuenv_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter teardown: the library may be gone
            pass
