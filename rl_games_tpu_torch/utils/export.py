"""Policy export for deployment.

Port of rl_games_tpu/utils/export.py (:19-79). The JAX package serializes
the deterministic policy (obs -> env-space action, the normalizers and the
action rescale folded in) through ``jax.export`` to a StableHLO artifact;
the port traces the same function with ``torch.export`` and saves the
``ExportedProgram`` (``torch.export.save``, a ``.pt2`` archive) with a
dynamic batch dimension, so that one artifact serves any batch. Any
PyTorch process can load it with ``torch.export.load``: the weights, the
normalizer statistics and the bounds are inside it.

A ``network.mlp.fused`` policy's chain is the registered operator
``rl_games_tpu_torch::fused_mlp`` (ops/fused_mlp.py) in the exported graph,
so the loaded program launches the CUDA kernel on the card and takes the
plain chain on the CPU. Loading needs that operator registered: importing
this module does it (it imports ``ops.fused_mlp`` and nothing else of the
port).

Differences from the JAX package: discrete actions are the argmax as
int64 (JAX gives int32), and the artifact is a ``.pt2`` file, not
``.stablehlo``. As in the JAX package, a recurrent policy starts every call
from zero states, and continuous actions are clipped to [-1, 1] and
rescaled to the bounds only when both bounds are finite.

``torch.export`` specializes a dimension whose example size is 0 or 1, so
``export_policy_fn`` traces from a batch of at least 2 (it repeats a
single example row) and declares the batch dynamic from 1 up.
"""

import io
import warnings

import numpy as np
import torch

from rl_games_tpu_torch.ops import fused_mlp  # noqa: F401  (registers rl_games_tpu_torch::fused_mlp)


class DeterministicPolicy(torch.nn.Module):
    """obs -> deterministic env-space action (mu, or the argmax of the
    logits) of an A2C model (``forward_play(obs, deterministic=True)``);
    with a Box ``action_space`` whose bounds are both finite, the actions
    clipped to [-1, 1] and rescaled to them (export.py:25-41)."""

    def __init__(self, model, action_space=None):
        super().__init__()
        self.model = model
        low, high = getattr(action_space, "low", None), getattr(action_space, "high", None)
        self.rescale = (low is not None and bool(np.all(np.isfinite(low)))
                        and bool(np.all(np.isfinite(high))))
        if self.rescale:
            device = next(model.parameters()).device
            self.register_buffer("low", torch.as_tensor(np.asarray(low, np.float32), device=device))
            self.register_buffer("high", torch.as_tensor(np.asarray(high, np.float32), device=device))

    def forward(self, obs):
        actions = self.model.forward_play(obs, deterministic=True)["actions"]
        if self.rescale:
            a = torch.clamp(actions, -1.0, 1.0)
            actions = a * (self.high - self.low) / 2.0 + (self.high + self.low) / 2.0
        return actions


def make_deterministic_policy_fn(model, action_space=None) -> torch.nn.Module:
    """The module obs -> deterministic env-space action of ``model`` (its
    normalizers inside it); ``action_space`` gives the bounds to rescale to."""
    return DeterministicPolicy(model, action_space)


def _device_of(module: torch.nn.Module):
    for t in (*module.parameters(), *module.buffers()):
        return t.device
    return torch.device("cpu")


def export_policy_fn(policy: torch.nn.Module, example_obs) -> bytes:
    """Trace ``policy`` (obs [B, ...] -> actions) with ``torch.export`` at
    the example's trailing shape, the batch dynamic (1 and up), and return
    the saved ``ExportedProgram``'s bytes. Dead nodes (the value head, a
    separate critic trunk) are dropped, so the program computes the actions
    alone."""
    example = torch.as_tensor(example_obs if torch.is_tensor(example_obs) else np.asarray(example_obs),
                              dtype=torch.float32, device=_device_of(policy))
    if example.shape[0] < 2:  # a size of 0 or 1 would fix the batch
        row = example[:1] if example.shape[0] else torch.zeros((1, *example.shape[1:]), device=example.device)
        example = torch.cat([row, row])
    batch = torch.export.Dim("batch", min=1)
    program = torch.export.export(policy, (example,), dynamic_shapes=({0: batch},))
    with warnings.catch_warnings():  # PyTorch's own pytree deprecation notice, raised inside
        warnings.filterwarnings("ignore", message=".*LeafSpec.*", category=FutureWarning)
        program = program.run_decompositions({})  # no decomposition: dead-code elimination only
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def export_policy(model, example_obs, action_space=None) -> bytes:
    """Serialize ``model``'s deterministic policy (``export_policy_fn``)."""
    return export_policy_fn(make_deterministic_policy_fn(model, action_space), example_obs)


def load_policy(blob: bytes):
    """The exported program in ``blob`` as a callable obs -> actions. It
    takes a tensor, or an array that it places on the program's device, and
    runs without autograd."""
    module = torch.export.load(io.BytesIO(blob)).module()
    device = _device_of(module)

    def policy(obs):
        if not torch.is_tensor(obs):
            obs = torch.as_tensor(np.asarray(obs, np.float32), device=device)
        with torch.no_grad():
            return module(obs)

    return policy


def save_policy(path: str, model, example_obs, action_space=None) -> str:
    """Export ``model``'s deterministic policy to the file ``path``."""
    blob = export_policy(model, example_obs, action_space)
    with open(path, "wb") as f:
        f.write(blob)
    return path
