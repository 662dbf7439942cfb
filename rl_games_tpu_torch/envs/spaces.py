"""Minimal space descriptions (gym-free for the device-resident path).

Port of rl_games_tpu/envs/spaces.py. The reference leans on gym spaces
(env_configurations.get_env_info, experience buffer allocation); the device
path only needs static shape/dtype metadata, so these frozen dataclasses
stand in.
"""

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class Box:
    shape: Tuple[int, ...]
    low: float = -np.inf
    high: float = np.inf
    dtype: Any = np.float32

    @property
    def size(self):
        return int(np.prod(self.shape))


@dataclass(frozen=True)
class Discrete:
    n: int
    shape: Tuple[int, ...] = ()
    dtype: Any = np.int32


@dataclass(frozen=True)
class MultiDiscrete:
    nvec: Tuple[int, ...]
    dtype: Any = np.int32

    @property
    def shape(self):
        return (len(self.nvec),)


@dataclass(frozen=True)
class DictSpace:
    spaces: Tuple[Tuple[str, Any], ...]

    @staticmethod
    def create(d: Dict[str, Any]):
        return DictSpace(tuple(sorted(d.items())))

    def as_dict(self):
        return dict(self.spaces)


@dataclass(frozen=True)
class EnvInfo:
    """Mirror of IVecEnv.get_env_info (common/ivecenv.py, env_configurations.py:
    333-352): spaces plus agents / value_size / optional central state space."""

    observation_space: Any
    action_space: Any
    state_space: Optional[Any] = None
    agents: int = 1
    value_size: int = 1
    use_global_observations: bool = False


def obs_shape_of(space) -> Any:
    if isinstance(space, DictSpace):
        return {k: v.shape for k, v in space.spaces}
    return space.shape


def actions_num_of(space):
    if isinstance(space, Box):
        return space.shape[0]
    if isinstance(space, Discrete):
        return space.n
    if isinstance(space, MultiDiscrete):
        return tuple(space.nvec)
    raise ValueError(f"unsupported action space {space}")
