"""Grid-style experiment sweeps.

Port of rl_games_tpu/common/experiment.py (the reference's
common/experiment.py:4-70): mutates a base config along a list of
{name, values} axes, yielding one config per grid point via
``get_next_config``. Dotted names address nested keys
('config.learning_rate').
"""

import copy
import itertools
from typing import List, Optional


def _set_by_path(cfg: dict, dotted: str, value):
    node = cfg
    keys = dotted.split(".")
    for k in keys[:-1]:
        node = node[k]
    node[keys[-1]] = value


class Experiment:
    def __init__(self, base_config: dict, experiment_config: List[dict]):
        """experiment_config: [{'name': 'config.learning_rate',
        'values': [1e-4, 3e-4]}, ...]"""
        self.base_config = base_config
        self.axes = experiment_config
        names = [a["name"] for a in self.axes]
        value_lists = [a["values"] for a in self.axes]
        self._grid = [dict(zip(names, combo)) for combo in itertools.product(*value_lists)]
        self._idx = 0

    def __len__(self):
        return len(self._grid)

    def get_next_config(self) -> Optional[dict]:
        if self._idx >= len(self._grid):
            return None
        cfg = copy.deepcopy(self.base_config)
        for dotted, value in self._grid[self._idx].items():
            _set_by_path(cfg, dotted, value)
        self._idx += 1
        return cfg

    def __iter__(self):
        while True:
            cfg = self.get_next_config()
            if cfg is None:
                return
            yield cfg
