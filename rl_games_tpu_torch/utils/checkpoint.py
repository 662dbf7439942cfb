"""Checkpoint I/O.

Port of rl_games_tpu/utils/checkpoint.py (the reference's torch_ext.py:54-112,
a2c_common.py:650-723): single-file checkpoints holding the full training
state, written atomically, with retrying filesystem operations for flaky
shared storage.

A checkpoint is ``torch.save`` of plain containers of tensors:

    {"model": model.state_dict(),      # the reference's .pth layout
     "state": the train state as nested dicts/lists of tensors,
     "meta":  {"epoch", "frame", "last_mean_rewards", ...}}

so a player (and the reference's own loader) reads the weights from
``"model"`` without knowing the trainer's state. A SAC checkpoint holds
the reference SAC layout's sections instead of ``"model"``: top-level
``"actor"``, ``"critic"``, ``"critic_target"``, ``"log_alpha"`` and, with
an input normalizer, ``"running_mean_std"``. ``tree_to_plain`` turns a
train state (dataclasses of tensors, lists and ``torch.Generator``s) into
such containers, and ``tree_from_plain`` restores them into the structure
of an example state (``agent.init_state()``), on the example's device.
"""

import dataclasses
import os
import time
from typing import Any, Callable, Optional

import torch


def safe_filesystem_op(func: Callable, *args, num_attempts: int = 5, **kwargs):
    """Retry with backoff (torch_ext.py:54-71)."""
    for attempt in range(num_attempts):
        try:
            return func(*args, **kwargs)
        except Exception:
            if attempt == num_attempts - 1:
                raise
            time.sleep(0.1 * 2**attempt)


def tree_to_plain(obj: Any):
    """Nested dicts/lists of CPU tensors from a tree of dataclasses, dicts,
    lists, tensors and generators (a generator is stored as its state)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, torch.Generator):
        return obj.get_state().clone()
    if dataclasses.is_dataclass(obj):
        return {f.name: tree_to_plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: tree_to_plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [tree_to_plain(v) for v in obj]
    return obj


def tree_from_plain(example: Any, plain: Any):
    """``plain`` restored into the structure of ``example``: tensors take
    the example's device and dtype, generators are set to the stored state
    (and stay the example's objects)."""
    if isinstance(example, torch.Tensor):
        if tuple(plain.shape) != tuple(example.shape):
            raise ValueError(f"checkpoint tensor has shape {tuple(plain.shape)}, "
                             f"the state expects {tuple(example.shape)}")
        return plain.to(device=example.device, dtype=example.dtype).clone()
    if isinstance(example, torch.Generator):
        example.set_state(plain.cpu())
        return example
    if dataclasses.is_dataclass(example):
        return dataclasses.replace(example, **{
            f.name: tree_from_plain(getattr(example, f.name), plain[f.name])
            for f in dataclasses.fields(example)
        })
    if isinstance(example, dict):
        return {k: tree_from_plain(v, plain[k]) for k, v in example.items()}
    if isinstance(example, (list, tuple)):
        if len(example) != len(plain):
            raise ValueError(f"checkpoint list has {len(plain)} entries, the state expects {len(example)}")
        return type(example)(tree_from_plain(e, p) for e, p in zip(example, plain))
    return plain


def save_checkpoint(path: str, state: Any, meta: Optional[dict] = None, weights: Any = None,
                    sections: Optional[dict] = None):
    """Write a train state (+ metadata) to ``path``, atomically.

    ``weights`` is the model's ``state_dict()``, stored under ``"model"``
    beside the full state so players restore the weights without the
    trainer's state (the reference's get_weights vs get_full_state_weights
    split, a2c_common.py:650-710). ``sections`` are further top-level
    entries (SAC's ``"actor"``, ``"critic"``, ...).
    """
    payload = {"state": tree_to_plain(state), "meta": dict(meta or {})}
    if weights is not None:
        payload["model"] = tree_to_plain(weights)
    for name, section in (sections or {}).items():
        payload[name] = tree_to_plain(section)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"

    def write():
        torch.save(payload, tmp)
        os.replace(tmp, path)

    safe_filesystem_op(write)


def read_payload(path: str) -> dict:
    """The raw checkpoint payload, on the CPU; pass it to ``load_checkpoint``
    via ``payload=`` to read a large file once."""
    return safe_filesystem_op(torch.load, path, map_location="cpu", weights_only=True)


def peek_meta(path: str) -> dict:
    """Just the metadata dict."""
    return read_payload(path).get("meta", {})


def load_checkpoint(path: str, example_state: Any, payload: Optional[dict] = None):
    """Restore into the structure (and onto the device) of
    ``example_state``; returns (state, meta)."""
    if payload is None:
        payload = read_payload(path)
    if "state" not in payload:
        raise ValueError(f"checkpoint {path} has no train state; it holds weights only")
    return tree_from_plain(example_state, payload["state"]), payload.get("meta", {})


def load_checkpoint_weights(path: str, payload: Optional[dict] = None):
    """Just the model weights section (a ``state_dict`` on the CPU; a
    module's ``load_state_dict`` copies it to the module's device);
    returns (weights, meta). Reads any file with the reference's
    ``{"model": state_dict}`` layout."""
    if payload is None:
        payload = read_payload(path)
    if "model" not in payload:
        raise ValueError(
            f"checkpoint {path} has no weights section; restore the full "
            "train state instead"
        )
    return payload["model"], payload.get("meta", {})
