"""Data parallelism over torch.distributed: the port's counterpart of
rl_games_tpu/parallel/mesh.py.

The JAX package runs one SPMD program on a ``jax.sharding.Mesh``: the env
axis is sharded over 'data', everything else replicated, and XLA inserts
the collectives, so N devices compute the one-device program by
construction. Here every rank is a process of its own (NCCL on the card,
gloo on the CPU; the reference's torchrun layer, a2c_common.py:109,
:362-378) and the equality is kept by two rules:

(a) every random draw is global: each generator is seeded alike on every
    rank, each row-indexed draw is taken at the world's shape [N, ...] and
    the rank keeps its block of rows (``RowGenerator``, ``draw_rows``), so
    rank r's rollout is the single process's on envs [r·N/W, (r+1)·N/W);
(b) the update runs the single process's global minibatches: the ranks
    gather the trajectory (``gather_rows``), each runs the same dataset
    preparation on it, computes the loss on an equal 1/W slice of each
    minibatch and averages the gradients, with the scalars that must be
    global beside them, in one flat-buffer all-reduce
    (``all_reduce_mean_``).

``Mesh`` is the handle the trainers take as ``make_train_fn(mesh=...)``:
rank, size, device and backend of the default process group. The backend
is chosen by the caller, never by a fallback: NCCL for CUDA ranks on cards
of their own, gloo for CPU ranks (and for several ranks sharing one card,
where it reduces CUDA tensors through the host). ``LOCAL`` is the trivial
world of one process with no process group, the trainers' default: its
gather, reduce and broadcast return their input, so a single process runs
the world's code path.
"""

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist

# fields of PPOTrainState whose leading axis is the env (row) axis; the
# recurrent states hold it on axis 1 ([layers, N, units]); everything else
# (the optimizers, lr, counters, meters) is replicated
_PPO_DATA_FIELDS = (
    "env_state",
    "obs",
    "dones",
    "current_rewards",
    "current_shaped_rewards",
    "current_lengths",
)
_PPO_RNN_FIELDS = ("rnn_states", "cv_rnn_states")

# fields of SACTrainState with a leading env axis. The JAX package also
# shards the episode accumulators and the replay's capacity; here each step's
# transitions are gathered, so the accumulators, the meters and the whole
# replay ring are replicated, bit-equal to the single process's
_SAC_DATA_FIELDS = (
    "env_state",
    "obs",
)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a data-parallel world."""

    rank: int
    size: int
    device: Optional[torch.device]
    backend: Optional[str]  # None: no process group (``LOCAL``)

    def block(self, total: int, what: str = "rows"):
        """(lo, hi): this rank's contiguous block of ``total`` rows, the
        blocks P('data') gives. Raises ValueError unless the size divides
        ``total``."""
        if total % self.size:
            raise ValueError(f"{what} ({total}) must be divisible by the world size ({self.size})")
        n = total // self.size
        return self.rank * n, (self.rank + 1) * n


LOCAL = Mesh(rank=0, size=1, device=None, backend=None)


def initialize_multihost(init_method: str, world_size: int, rank: int, backend: str):
    """Join the world (the JAX package's ``jax.distributed.initialize``):
    ``init_process_group`` with the caller's init method (``tcp://host:port``
    or ``file://path``), size, rank and backend. Returns (rank, size)."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', not {backend!r}")
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    return dist.get_rank(), dist.get_world_size()


def create_mesh(device=None) -> Mesh:
    """The handle of the world ``initialize_multihost`` formed; ``device``
    is where this rank's trainer runs. NCCL needs a CUDA device."""
    if not dist.is_initialized():
        raise RuntimeError("create_mesh: no process group; call initialize_multihost first")
    backend = str(dist.get_backend())
    device = torch.device(device if device is not None else ("cuda" if backend == "nccl" else "cpu"))
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("an NCCL world needs CUDA devices")
    return Mesh(rank=dist.get_rank(), size=dist.get_world_size(), device=device, backend=backend)


# ---------------------------------------------------------------------------
# rule (a): global draws, sliced
# ---------------------------------------------------------------------------


class RowGenerator(torch.Generator):
    """A generator whose row-indexed draws (``draw_rows``) are taken at the
    world's ``total`` rows and cut to this rank's rows [lo, hi), so that the
    stream advances as the single process's does."""

    def __new__(cls, device, lo: int, hi: int, total: int):
        out = super().__new__(cls, device)
        out.lo, out.hi, out.total = lo, hi, total
        return out


def row_generator(generator: torch.Generator, lo: int, hi: int, total: int) -> RowGenerator:
    """A ``RowGenerator`` over rows [lo, hi) of ``total`` in ``generator``'s
    state."""
    out = RowGenerator(generator.device, lo, hi, total)
    out.set_state(generator.get_state())
    return out


def draw_rows(sampler, shape: Sequence[int], generator: Optional[torch.Generator], **kwargs):
    """``sampler(shape, generator=generator, **kwargs)``: ``torch.rand``,
    ``torch.randn`` and the like. From a ``RowGenerator`` the draw is taken
    at the world's rows and this rank's block is returned."""
    if not isinstance(generator, RowGenerator):
        return sampler(tuple(shape), generator=generator, **kwargs)
    if shape[0] != generator.hi - generator.lo:
        raise ValueError(f"a draw of {shape[0]} rows from a generator over rows "
                         f"[{generator.lo}, {generator.hi}) of {generator.total}")
    return sampler((generator.total, *shape[1:]), generator=generator, **kwargs)[generator.lo:generator.hi]


def shard_rows(x, lo: int, hi: int, total: int, axis: int = 0):
    """Rows [lo, hi) of ``total`` along ``axis`` of a tensor, or of every
    tensor in a dict, tuple or dataclass (the counterpart of placing a tree
    on P('data')): 0-d tensors and other leaves are replicated, and
    generators become ``RowGenerator``s over the same rows. None stays
    None."""
    if x is None:
        return None
    if isinstance(x, torch.Generator):
        return row_generator(x, lo, hi, total)
    if isinstance(x, dict):
        return {k: shard_rows(v, lo, hi, total, axis) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(shard_rows(v, lo, hi, total, axis) for v in x)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: shard_rows(getattr(x, f.name), lo, hi, total, axis)
                                         for f in dataclasses.fields(x)})
    if torch.is_tensor(x) and x.dim() > 0:
        if x.shape[axis] != total:
            raise ValueError(f"a tensor of shape {tuple(x.shape)} has no {total} rows on axis {axis}")
        return x.narrow(axis, lo, hi - lo).clone()
    return x


def unshard_rows(x, mesh: "Mesh", axis: int = 0):
    """The inverse of ``shard_rows`` over a tree, on every rank: each tensor
    with rows gathered from every rank's block along ``axis``; 0-d tensors,
    generators and other leaves as they are (replicated). ``x`` itself in
    ``LOCAL``."""
    if mesh.backend is None:
        return x
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: unshard_rows(getattr(x, f.name), mesh, axis)
                                         for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: unshard_rows(v, mesh, axis) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(unshard_rows(v, mesh, axis) for v in x)
    if torch.is_tensor(x) and x.dim() > 0:
        return gather_rows(x, mesh, axis)
    return x


# ---------------------------------------------------------------------------
# rule (b): the gather and the flat-buffer all-reduce
# ---------------------------------------------------------------------------
def gather_rows(x, mesh: Mesh, axis: int = 0):
    """Every rank's block of ``x`` concatenated along ``axis`` in rank order
    (the inverse of ``shard_rows``), on every rank; over a dict or a tuple
    leaf by leaf. bool tensors travel as uint8. ``x`` itself in ``LOCAL``."""
    if mesh.backend is None:
        return x
    if isinstance(x, dict):
        return {k: gather_rows(v, mesh, axis) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(gather_rows(v, mesh, axis) for v in x)
    home, dtype = x.device, x.dtype
    # NCCL gathers on the card; gloo on the host (it takes CUDA tensors
    # for all_reduce and broadcast only)
    y = x.to(mesh.device if mesh.backend == "nccl" else "cpu").contiguous()
    if dtype == torch.bool:
        y = y.to(torch.uint8)
    parts = [torch.empty_like(y) for _ in range(mesh.size)]
    dist.all_gather(parts, y)
    return torch.cat(parts, dim=axis).to(home, dtype)


def all_reduce_mean_(tensors: Sequence[torch.Tensor], mesh: Mesh):
    """The mean over the ranks of each float32 tensor, written back in
    place, through ONE all-reduce of a flat buffer holding them all (the
    reference's flat bucket, a2c_common.py:362-378). Returns ``tensors``,
    untouched in ``LOCAL``."""
    if mesh.backend is None:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    flat /= mesh.size
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
    return tensors


def broadcast_(tensors: Sequence[torch.Tensor], src: int, mesh: Mesh):
    """Rank ``src``'s values of each tensor into every rank's, in place,
    through one broadcast of a flat buffer for each dtype among them;
    untouched in ``LOCAL``, whose one rank is 0."""
    if mesh.backend is None:
        return tensors
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        group = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in group]).to(mesh.device)
        dist.broadcast(flat, src=src)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view(t.shape))
            offset += t.numel()
    return tensors
