"""Host-env wrapper stack.

Port of rl_games_tpu/envs/host/wrappers.py (:1-269; the reference's
common/wrappers.py: the Atari deepmind stack :45-420, TimeLimit with
time_outs :524-548, MaskVelocityWrapper :581-601) on gymnasium's wrapper
API, numpy only. The wrappers are env-agnostic, so the Atari stack runs on
any image-observation env. This module needs gymnasium; the registry
imports it only when a config asks for a wrapped env.
"""

from collections import deque

import gymnasium as gym
import numpy as np


class NoopResetEnv(gym.Wrapper):
    """Random number of no-ops after reset (wrappers.py:45-77)."""

    def __init__(self, env, noop_max=30, noop_action=0):
        super().__init__(env)
        self.noop_max = noop_max
        self.noop_action = noop_action

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        noops = self.np_random.integers(1, self.noop_max + 1)
        for _ in range(noops):
            obs, _, terminated, truncated, info = self.env.step(
                self.noop_action
            )
            if terminated or truncated:
                obs, info = self.env.reset(**kwargs)
        return obs, info


class FireResetEnv(gym.Wrapper):
    """Press FIRE on reset for envs that need it (wrappers.py:80-100)."""

    def __init__(self, env, fire_action=1):
        super().__init__(env)
        self.fire_action = fire_action

    def reset(self, **kwargs):
        self.env.reset(**kwargs)
        obs, _, terminated, truncated, info = self.env.step(self.fire_action)
        if terminated or truncated:
            obs, info = self.env.reset(**kwargs)
        return obs, info


class EpisodicLifeEnv(gym.Wrapper):
    """End episodes on life loss, reset only on true game over
    (wrappers.py:103-146)."""

    def __init__(self, env):
        super().__init__(env)
        self.lives = 0
        self.was_real_done = True

    def _get_lives(self):
        ale = getattr(self.env.unwrapped, "ale", None)
        if ale is not None:
            return ale.lives()
        return getattr(self.env.unwrapped, "lives", lambda: 0)()

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self.was_real_done = terminated or truncated
        lives = self._get_lives()
        if 0 < lives < self.lives:
            terminated = True
        self.lives = lives
        return obs, reward, terminated, truncated, info

    def reset(self, **kwargs):
        if self.was_real_done:
            obs, info = self.env.reset(**kwargs)
        else:
            obs, _, _, _, info = self.env.step(0)
        self.lives = self._get_lives()
        return obs, info


class MaxAndSkipEnv(gym.Wrapper):
    """Repeat action `skip` frames, max over the last two
    (wrappers.py:149-180)."""

    def __init__(self, env, skip=4):
        super().__init__(env)
        self._skip = skip
        self._obs_buffer = deque(maxlen=2)

    def step(self, action):
        total_reward = 0.0
        terminated = truncated = False
        info = {}
        for _ in range(self._skip):
            obs, reward, terminated, truncated, info = self.env.step(action)
            self._obs_buffer.append(obs)
            total_reward += float(reward)
            if terminated or truncated:
                break
        max_frame = np.max(np.stack(self._obs_buffer), axis=0)
        return max_frame, total_reward, terminated, truncated, info

    def reset(self, **kwargs):
        self._obs_buffer.clear()
        obs, info = self.env.reset(**kwargs)
        self._obs_buffer.append(obs)
        return obs, info


class ClipRewardEnv(gym.RewardWrapper):
    """Reward → sign(reward) (wrappers.py:183-192)."""

    def reward(self, reward):
        return float(np.sign(reward))


class WarpFrame(gym.ObservationWrapper):
    """Grayscale + resize to 84x84 (wrappers.py:195-230)."""

    def __init__(self, env, width=84, height=84, grayscale=True):
        super().__init__(env)
        self.width = width
        self.height = height
        self.grayscale = grayscale
        channels = 1 if grayscale else 3
        self.observation_space = gym.spaces.Box(
            low=0, high=255, shape=(height, width, channels), dtype=np.uint8
        )

    def observation(self, frame):
        import cv2

        if self.grayscale and frame.ndim == 3 and frame.shape[-1] == 3:
            frame = cv2.cvtColor(frame, cv2.COLOR_RGB2GRAY)
        frame = cv2.resize(
            frame, (self.width, self.height), interpolation=cv2.INTER_AREA
        )
        if self.grayscale:
            frame = np.expand_dims(frame, -1)
        return frame.astype(np.uint8)


class FrameStack(gym.Wrapper):
    """Stack last k observations along the channel axis (wrappers.py:233-274,
    flat mode for vector obs)."""

    def __init__(self, env, k=4, flat=False):
        super().__init__(env)
        self.k = k
        self.flat = flat
        self.frames = deque(maxlen=k)
        space = env.observation_space
        if flat:
            shape = (k * int(np.prod(space.shape)),)
        else:
            shape = space.shape[:-1] + (space.shape[-1] * k,)
        self.observation_space = gym.spaces.Box(
            low=float(np.min(space.low)), high=float(np.max(space.high)),
            shape=shape, dtype=space.dtype,
        )

    def _get_obs(self):
        if self.flat:
            return np.concatenate([np.ravel(f) for f in self.frames])
        return np.concatenate(list(self.frames), axis=-1)

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        for _ in range(self.k):
            self.frames.append(obs)
        return self._get_obs(), info

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self.frames.append(obs)
        return self._get_obs(), reward, terminated, truncated, info


class ScaledFloatFrame(gym.ObservationWrapper):
    """uint8 → float32 / 255 (wrappers.py:420-432)."""

    def __init__(self, env):
        super().__init__(env)
        self.observation_space = gym.spaces.Box(
            low=0.0, high=1.0, shape=env.observation_space.shape,
            dtype=np.float32,
        )

    def observation(self, obs):
        return np.asarray(obs, np.float32) / 255.0


class TimeLimit(gym.Wrapper):
    """Truncate at max_episode_steps, flagging info['time_outs']
    (wrappers.py:524-548)."""

    def __init__(self, env, max_episode_steps):
        super().__init__(env)
        self._max_episode_steps = max_episode_steps
        self._elapsed = 0

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self._elapsed += 1
        if self._elapsed >= self._max_episode_steps and not terminated:
            truncated = True
            info["time_outs"] = True
        return obs, reward, terminated, truncated, info

    def reset(self, **kwargs):
        self._elapsed = 0
        return self.env.reset(**kwargs)


MASK_VELOCITY_MASKS = {
    # wrappers.py:581-601
    "CartPole-v1": np.asarray([1.0, 0.0, 1.0, 0.0]),
    "Pendulum-v1": np.asarray([1.0, 1.0, 0.0]),
    "LunarLander-v3": np.asarray([1, 1, 0, 0, 1, 0, 1, 1], np.float32),
    "LunarLanderContinuous-v3": np.asarray(
        [1, 1, 0, 0, 1, 0, 1, 1], np.float32
    ),
}


class MaskVelocityWrapper(gym.ObservationWrapper):
    """Zero out velocity components — POMDP-ifies classic control."""

    def __init__(self, env, name):
        super().__init__(env)
        if name not in MASK_VELOCITY_MASKS:
            raise ValueError(f"MaskVelocityWrapper: unsupported env {name}")
        self.mask = MASK_VELOCITY_MASKS[name]

    def observation(self, obs):
        return np.asarray(obs) * self.mask


def wrap_deepmind(env, episode_life=True, clip_rewards=True, frame_stack=True,
                  scale=False, skip=4, warp=True):
    """The deepmind Atari stack (wrappers.py:663-700)."""
    env = NoopResetEnv(env, noop_max=30)
    env = MaxAndSkipEnv(env, skip=skip)
    if episode_life:
        env = EpisodicLifeEnv(env)
    # FIRE-gated games (Breakout-class) need the launch pressed on every
    # reset, incl. EpisodicLife pseudo-resets (wrappers.py:687-688)
    try:
        meanings = env.unwrapped.get_action_meanings()
    except AttributeError:
        meanings = ()
    if "FIRE" in meanings:
        env = FireResetEnv(env)
    if warp:
        env = WarpFrame(env)
    if scale:
        env = ScaledFloatFrame(env)
    if clip_rewards:
        env = ClipRewardEnv(env)
    if frame_stack:
        env = FrameStack(env, 4)
    return env
