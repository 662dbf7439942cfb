"""Population-Based Training over a shared-filesystem protocol.

Port of rl_games_tpu/utils/pbt.py (the reference's common/pbt/: pbt.py,
mutation.py, pbt_cfg.py): N independent training processes coordinate only
through records in a shared workspace. Every ``interval_steps`` frames each
member saves {weights, score, params}; underperformers (score below the
population band) load a random leader's weights, mutate selected
hyperparameters multiplicatively, and go on training. The band rule is the
reference's:
leaders  score > max(mean + k*std, mean + abs_margin),
laggards score < min(mean - k*std, mean - abs_margin).

The random draws are Python's ``random`` module's, in the JAX package's
order (``random.uniform`` then ``random.random`` in ``mutate_float``, one
``random.random`` per mutable key in ``mutate``, ``random.choice`` of the
leader), so that under the same ``random.seed`` both packages pick the same
leader and the same mutation.

A member's record (``policy_{idx:03d}.pbt``, written atomically through a
``.tmp`` file and ``os.replace``) is ``torch.save`` of plain containers: the
weights as CPU tensors (``utils/checkpoint.tree_to_plain``), the score, the
frame and the mutable params. It is read back with ``torch.load(...,
weights_only=True)``. The JAX package pickles its records, so a port member
does not read a JAX member's record (it counts as missing), nor the reverse.
"""

import os
import pickle
import random
import sys
import time
from dataclasses import dataclass, field, fields
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from rl_games_tpu_torch.utils import checkpoint as ckpt


# ---------------------------------------------------------------------------
# Mutations (common/pbt/mutation.py)
# ---------------------------------------------------------------------------


def mutate_float(x: float, change_min: float = 1.1, change_max: float = 1.5):
    k = random.uniform(change_min, change_max)
    return x / k if random.random() < 0.5 else x * k


def mutate_discount(x: float, **kwargs):
    """Mutate (1 - gamma) with conservative [1.1, 1.2] steps."""
    inv = 1.0 - x
    return 1.0 - mutate_float(inv, change_min=1.1, change_max=1.2)


MUTATION_FUNCS: Dict[str, Callable] = {
    "mutate_float": mutate_float,
    "mutate_discount": mutate_discount,
}


def mutate(params: Dict[str, Any], mutations: Dict[str, str],
           mutation_rate: float, change_range: Tuple[float, float]):
    """mutation.py:35-54: per-key coin-flip mutation."""
    cmin, cmax = change_range
    out = {}
    for name, val in params.items():
        fn_name = mutations.get(name)
        if fn_name is None or random.random() > mutation_rate:
            out[name] = val
            continue
        fn = MUTATION_FUNCS.get(fn_name)
        if fn is None:
            raise KeyError(f"Unknown mutation function: {fn_name!r}")
        out[name] = fn(val, change_min=cmin, change_max=cmax)
    return out


# ---------------------------------------------------------------------------
# Config (common/pbt/pbt_cfg.py)
# ---------------------------------------------------------------------------


@dataclass
class PbtCfg:
    enabled: bool = False
    policy_idx: int = 0
    num_policies: int = 8
    directory: str = ""
    workspace: str = "pbt_workspace"
    objective: str = "mean_rewards"
    interval_steps: int = 100_000
    threshold_std: float = 0.10
    threshold_abs: float = 0.05
    mutation_rate: float = 0.25
    change_range: Tuple[float, float] = (1.1, 2.0)
    mutation: Dict[str, str] = field(default_factory=dict)
    restart_with_execv: bool = False

    def __post_init__(self):
        self.change_range = tuple(self.change_range)

    @classmethod
    def from_dict(cls, d: dict):
        known = {f.name for f in fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            print(f"PbtCfg: ignoring unknown config keys {unknown}")
        return cls(**{k: v for k, v in d.items() if k in known})


# ---------------------------------------------------------------------------
# Population coordination
# ---------------------------------------------------------------------------


def _member_path(workspace: str, idx: int) -> str:
    return os.path.join(workspace, f"policy_{idx:03d}.pbt")


def save_member(workspace: str, idx: int, score: float, frame: int,
                weights: Any, params: Dict[str, Any]):
    os.makedirs(workspace, exist_ok=True)
    payload = {
        "score": float(score),
        "frame": int(frame),
        "weights": ckpt.tree_to_plain(weights),
        "params": dict(params),
        "time": time.time(),
    }
    tmp = _member_path(workspace, idx) + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, _member_path(workspace, idx))


def load_population(workspace: str, num_policies: int):
    """Read every member's latest record; a missing or unreadable member
    (a JAX member's pickle among them) is None."""
    members = []
    for i in range(num_policies):
        try:
            members.append(torch.load(_member_path(workspace, i), map_location="cpu", weights_only=True))
        except (OSError, RuntimeError, EOFError, ValueError, pickle.UnpicklingError):
            members.append(None)
    return members


def classify(scores, threshold_std: float, threshold_abs: float):
    """Return (leader_cut, laggard_cut) from the band rule (pbt_cfg.py:10-16)."""
    s = np.asarray(scores, np.float64)
    mean, std = s.mean(), s.std()
    leader_cut = max(mean + threshold_std * std, mean + threshold_abs)
    laggard_cut = min(mean - threshold_std * std, mean - threshold_abs)
    return leader_cut, laggard_cut


class PbtManager:
    """Per-member PBT driver; call ``step(algo, state, metrics)`` each epoch
    with the epoch's metrics on the host.

    ``algo`` is the port's PPOAgent, whose weights live in its model: the
    manager reads them with ``algo.get_weights()`` (the model's
    ``state_dict``: the JAX package's ``params`` and ``norm``) and adopts a
    leader's with ``algo.set_weights(weights)``, neither taking the train
    state, where the JAX package's ``get_weights(state)`` /
    ``set_weights(state, weights)`` do. Then ``reset_optimizer(state)`` and
    ``set_param(key, value, state)`` for each mutated key, as there."""

    def __init__(self, cfg: PbtCfg, mutable_params: Dict[str, Any],
                 restart_fn: Optional[Callable] = None, mesh=None):
        self.cfg = cfg
        # a member trained by a data-parallel world: rank 0 writes its
        # record, and every rank reads the population after it
        self.mesh = mesh
        self.mutable_params = dict(mutable_params)
        self.last_interval = 0
        self.restart_fn = restart_fn or self._default_restart
        root = cfg.directory or "."
        self.workspace = os.path.join(root, cfg.workspace)

    def _default_restart(self, new_params: Dict[str, Any]):
        """Re-exec with key=value overrides (pbt.py:129-272 behavior)."""
        argv = [sys.executable] + sys.argv + [
            f"{k}={v}" for k, v in new_params.items()
        ]
        os.execv(sys.executable, argv)

    def step(self, algo, state, metrics):
        """Save own record at each interval; maybe adopt a leader."""
        frame = int(metrics["frame"])
        if frame - self.last_interval < self.cfg.interval_steps:
            return state
        self.last_interval = frame
        objective = metrics.get(self.cfg.objective, metrics.get("mean_rewards"))
        score = float(np.asarray(objective).reshape(-1)[0])
        if self.mesh is None or self.mesh.rank == 0:
            save_member(
                self.workspace, self.cfg.policy_idx, score, frame,
                algo.get_weights(), self.mutable_params,
            )
        if self.mesh is not None:
            torch.distributed.barrier()
        members = load_population(self.workspace, self.cfg.num_policies)
        valid = [(i, m) for i, m in enumerate(members) if m is not None]
        if len(valid) < max(2, self.cfg.num_policies // 2):
            return state
        scores = [m["score"] for _, m in valid]
        leader_cut, laggard_cut = classify(
            scores, self.cfg.threshold_std, self.cfg.threshold_abs
        )
        if score >= laggard_cut:
            return state
        leaders = [
            (i, m) for i, m in valid
            if m["score"] > leader_cut and i != self.cfg.policy_idx
        ]
        if not leaders:
            return state
        li, leader = random.choice(leaders)
        print(
            f"PBT: policy {self.cfg.policy_idx} (score {score:.3f}) adopting "
            f"leader {li} (score {leader['score']:.3f})"
        )
        new_params = mutate(
            leader["params"], self.cfg.mutation, self.cfg.mutation_rate,
            self.cfg.change_range,
        )
        if self.cfg.restart_with_execv:
            self.restart_fn(new_params)
            return state  # unreachable after execv
        # in-process adoption: the leader's weights, fresh Adam moments
        # (the reference's execv restart gets them for free) and the mutated
        # hyperparameters through set_param, so that config-level params
        # (gamma, tau, e_clip, ...) mutate too; the port reads them each epoch
        algo.set_weights(leader["weights"])
        if hasattr(algo, "reset_optimizer"):
            state = algo.reset_optimizer(state)
        self.mutable_params = new_params
        if hasattr(algo, "set_param"):
            for key, value in new_params.items():
                try:
                    state = algo.set_param(key, value, state)
                except NotImplementedError:
                    pass
        return state
