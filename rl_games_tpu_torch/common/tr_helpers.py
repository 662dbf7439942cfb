"""Training helpers: reward shaping, flatten utilities.

Port of rl_games_tpu/common/tr_helpers.py (the reference's tr_helpers.py
and a2c_common.py:33-48).
"""

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class DefaultRewardsShaper:
    """tr_helpers.py:16-41 — shift → scale → clip → optional log."""

    scale_value: float = 1.0
    shift_value: float = 0.0
    min_val: float = -math.inf
    max_val: float = math.inf
    log_val: bool = False

    def __call__(self, reward):
        reward = reward + self.shift_value
        reward = reward * self.scale_value
        reward = torch.clamp(reward, self.min_val, self.max_val)
        if self.log_val:
            reward = torch.log(reward)
        return reward


def build_reward_shaper(config: dict) -> DefaultRewardsShaper:
    cfg = config.get("reward_shaper", {}) or {}
    return DefaultRewardsShaper(
        scale_value=float(cfg.get("scale_value", 1.0)),
        shift_value=float(cfg.get("shift_value", 0.0)),
        min_val=float(cfg.get("min_val", -math.inf)),
        max_val=float(cfg.get("max_val", math.inf)),
        log_val=bool(cfg.get("log_val", False)),
    )


def swap_and_flatten01(arr):
    """[T, N, ...] → [N*T, ...] env-major (a2c_common.py:33-40)."""
    if arr is None:
        return arr
    s = arr.shape
    return arr.transpose(0, 1).reshape(s[0] * s[1], *s[2:])


def rescale_actions(low, high, action):
    """Map [-1, 1] policy output to the env's action bounds
    (a2c_common.py:43-47)."""
    d = (high - low) / 2.0
    m = (high + low) / 2.0
    return action * d + m
