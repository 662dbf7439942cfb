"""Fully-fused sequential MLP forward.

Port of rl_games_tpu/ops/fused_mlp.py: the whole chain

    h <- act(h @ W_i.T + b_i)    for every layer, the last one too

in one kernel launch, with the intermediate activations kept on chip.
The kernel makes its products on the tensor cores as 3xTF32 (each operand
split into two TF32 halves, three products, float32 accumulate), which keeps
float32-grade results: it is held to ``plain_mlp`` at rtol = atol = 2e-5.
Shapes: x [B, D_0]; ws[i] [D_{i+1}, D_i] (``torch.nn.Linear``'s layout, the
transpose of the JAX package's kernels); bs[i] [D_{i+1}]; returns [B, D_L].

``fused_mlp`` dispatches on the tensor's device only: a CPU tensor takes
``plain_mlp`` (the plain PyTorch chain, in x's dtype), a CUDA tensor takes
the hand-written kernel ``csrc/fused_mlp.cu`` through ``fused_mlp_cuda``,
which raises on any input it does not take. There is no fallback between the
two and no switch that turns the kernel off. As the JAX package's Pallas
call does, the CUDA route takes any floating dtype: inputs that are not
float32 are cast to it and the result back to x's dtype.

The kernel takes a chain of any depth and width: ``launch_plan`` cuts it
into launches of at most ``MAX_LAYERS`` layers whose held widths fit a
block's shared memory. A layer whose input no buffer holds (the 3136 inputs
behind the nature-CNN) is a launch of its own, of the streamed kernel
(clusters of blocks that split its outputs, bulk tensor copies, a deep
ring: ``stream_plan``); a width between two launches goes through device
memory. A chain that one launch takes is one launch. A held launch over few
rows (below a crossover measured on the card: the rollout's 16 rows, the
host path's 64, an exported policy's one action) runs as the cluster kernel
(``cluster_plan``): a cluster of blocks splits each layer's outputs, every
block fetches its share of the weights at once, and the activations pass
between them through distributed shared memory. A held launch over many
rows whose widths are at most 256 (from ``WGMMA_MIN_ROWS``, measured on the
card: the flagship torso's rollout and minibatches, the 3D configs', the
deep torso's) runs as the wgmma kernel (``wgmma_plan``): persistent blocks of
64 rows whose two consumer warpgroups make the products with the warpgroup
instruction, while a producer warpgroup streams the weights through a ring
of slots by bulk tensor copies multicast over a cluster. A grouped launch at few
rows a set (the self-play opponents' one row) runs as the sets kernel
(``sets_plan``): persistent blocks stream whole sets' weights through a ring
of stages by bulk copies and make the products on the CUDA cores in float32.
Gradients are exact: the backward
recomputes through ``plain_mlp``, as the JAX package's custom VJP does, so
the kernel is the forward (rollout, player, loss forward) path.

The chain is also a registered PyTorch operator,
``torch.ops.rl_games_tpu_torch.fused_mlp(x, ws, bs, activation)`` (CUDA: the
kernel; CPU: ``plain_mlp``; a fake implementation for tracing; the backward
above), so that ``torch.export`` records it in an exported policy and the
exported program launches the kernel on the card (``utils/export.py``).
Importing this module registers it.

Over G weight sets at once (a self-play env's opponents: the policy under
``torch.func.vmap`` over each env's own slot, as the JAX package runs its
Pallas call under ``jax.vmap``), the operator's vmap rule makes one grouped
call: ``fused_mlp_grouped`` (x [G, B, D_0] or a shared [B, D_0]; each
weight [G, out, in] or a shared [out, in]; each bias [G, out] or a shared
[out]; returns [G, B, D_L]), which on the card is one grouped launch for
each entry of ``grouped_launch_plan`` (``fused_mlp_grouped_cuda``: the held
kernel, each set a row of blocks, or at few rows a set the sets kernel; a
shared tensor at set stride 0) and ``plain_mlp_grouped`` on the CPU. It is a
registered operator too, ``rl_games_tpu_torch::fused_mlp_grouped``, whose
backward recomputes through ``plain_mlp_grouped``.
"""

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from rl_games_tpu_torch.utils import cuda_build

# Launches of the CUDA kernel in this process, ordinary and grouped;
# ``fused_mlp_cuda`` and ``fused_mlp_grouped_cuda`` add one per launch (a
# chain that ``launch_plan`` cuts in two counts 2) and nothing else touches
# it except a caller resetting it.
fused_mlp_launches = 0
# The grouped launches among them (``fused_mlp_grouped_cuda`` adds one here too).
fused_mlp_grouped_launches = 0
# The launches of the cluster kernel among them (``_launch`` adds one here too).
fused_mlp_cluster_launches = 0
# The launches of the sets kernel among the grouped ones (``_launch`` adds one here too).
fused_mlp_sets_launches = 0
# The launches of the wgmma kernel among the ordinary ones (``_launch`` adds one here too).
fused_mlp_wgmma_launches = 0

# The kernel's limits.
MAX_LAYERS = 8  # layers a launch: their pointers travel in the kernel's argument block
MAX_GROUPS = 65_535  # weight sets a grouped launch takes: the grid's second axis
MAX_SHARED_BYTES = 232_448  # shared memory one block may use on sm_90
# Rows of x per block that the kernel is built for, with the smallest batch
# at which each is taken: 32 rows once 16-row tiles would no longer all be
# resident at once (two blocks on each of the card's 132 SMs). The smaller
# tile halves each warp's register tile, so it pays more shared-memory loads
# and operand splits per tensor-core product and serves small batches only.
TILE_ROWS = {32: 132 * 2 * 16, 16: 0}
# the ring of staged weight tiles (csrc/fused_mlp.cu: kStages * TN * WS)
_WEIGHT_RING_FLOATS = 3 * 128 * 40
# The streamed kernel (csrc/fused_mlp.cu fused_mlp_stream_kernel): rows a
# block it is built for, the largest first, each with its ring's stages (as
# many as a block's shared memory holds: 128 x 32 floats of W and rows x 32
# of x a stage, two 8-byte barriers, 1 KB to align the first stage).
STREAM_STAGES = {64: 9, 32: 11, 16: 12}
MAX_CLUSTER = 8  # blocks a cluster: the portable limit
# What the plan weighs, measured on an NVIDIA H100 80GB HBM3 by
# tools/fused_mlp_ab.py --sweep (PERF.md §6): the blocks the card holds at
# once (one streamed block an SM; in clusters of 4 or 8 only 120 of the 132
# SMs take one), and the products a block of 16, 32 or 64 rows makes in a
# given time, relative to 64 rows (a larger block splits each operand for
# more products: the kernel is bound by the rate of its 3xTF32 mma.sync).
STREAM_WAVE_BLOCKS = {1: 132, 2: 132, 4: 120, 8: 120}
STREAM_RATE = {64: 1.0, 32: 0.72, 16: 0.49}
# The cluster kernel (csrc/fused_mlp.cu fused_mlp_cluster_kernel): a held
# launch over few rows, each layer's outputs split over the blocks of a
# cluster that shares a 16-row tile. Measured on an NVIDIA H100 80GB HBM3 at
# 700 W by tools/fused_mlp_ab.py --sweep (PERF.md §6): (most rows, blocks a
# cluster) in order of rows, the cluster size that ran fastest at those
# rows; past the last row count the held kernel ran faster.
CLUSTER_SHAPES = ((64, 8), (256, 4), (1024, 2))
# A chain whose held launch walks fewer weight tiles (128 outputs x 32
# inputs) than this stays held at every batch: its one block has little to
# wait for, and the cluster kernel did not beat it (the same sweep).
CLUSTER_MIN_TILES = 3
CLUSTER_BLOCKS = (1, 2, 4, 8, 16)  # clusters the kernel takes (16 as a non-portable size)
# csrc/fused_mlp.cu: two 8-byte barriers a layer, and the static table of
# MAX_LAYERS records of ClusterLayerArgs (two pointers and seven ints: 48 bytes)
_CLUSTER_BARRIER_FLOATS, _CLUSTER_TABLE_BYTES = 2 * 2 * MAX_LAYERS, MAX_LAYERS * 48
# The sets kernel (csrc/fused_mlp.cu fused_mlp_sets_kernel): a grouped launch
# at few rows a set, persistent blocks that stream whole sets through a ring
# of stages, its 8 multiplying warps in groups that take a set each. Its
# instances (rows a set it is built for). Measured on an NVIDIA H100 80GB HBM3
# at 700 W by tools/fused_mlp_ab.py --sweep sets (the forage chain 6 -> 128 ->
# 64 at 1-16 rows a set over 64-1024 sets; PERF.md §6): the ring's stages and
# the warps a set that ran fastest at one row a set over 1024 sets (2 and 4:
# three blocks an SM, six sets at once), and, for each instance's rows, the
# fewest sets from which it beat the held grouped launch at every count the
# sweep ran; at 8 and 16 rows a set the held kernel was faster at every count.
SETS_ROWS = (1, 2, 4, 8, 16)
SETS_STAGES = 2
SETS_WARPS = 4
SETS_MIN_GROUPS = {1: 256, 2: 256, 4: 512}
SETS_MAX_ROWS = max(SETS_MIN_GROUPS)
SETS_MULTIPLYING_WARPS = 8  # csrc/fused_mlp.cu kSetsWarps
MAX_SETS_STAGES = 16  # csrc/fused_mlp.cu kMaxSetsStages
# csrc/fused_mlp.cu: the static table of 1 + 2 MAX_LAYERS records of
# SetsTensor (a pointer, a set stride, two ints: 24 bytes) and the widths
_SETS_TABLE_BYTES = (1 + 2 * MAX_LAYERS) * 24 + 4 * (MAX_LAYERS + 1)
# The wgmma kernel (csrc/fused_mlp.cu fused_mlp_wgmma_kernel): a held,
# ungrouped launch over many rows, a block a tile of 64 rows whose two
# consumer warpgroups split each layer's outputs, the products by wgmma, the
# weights streamed through a ring of slots of 128 rows by 32 inputs and
# their lo tile (bulk tensor copies multicast over a cluster, or cp.async).
# Its limits: every width at most 256; each warpgroup's share of a layer's
# outputs one of the instruction widths below.
WGMMA_ROWS = 64
WGMMA_MAX_WIDTH = 256
WGMMA_HALVES = (16, 32, 64, 128)
WGMMA_CLUSTERS = (1, 2)  # blocks a cluster the kernel takes
WGMMA_SLOT_ROWS = 128  # csrc/fused_mlp.cu kWgSlotRows
WGMMA_SLOTS_RANGE = (2, 6)  # csrc/fused_mlp.cu: 2 to kWgMaxSlots
WGMMA_MAX_STAGE_BYTES = 65536  # csrc/fused_mlp.cu kWgMaxStageBytes: a weight staged whole
# Measured on an NVIDIA H100 80GB HBM3 at 700 W by tools/fused_mlp_ab.py
# --sweep wgmma (PERF.md §6): the fewest rows from which the wgmma kernel
# beat the held kernel on every chain at every larger batch the sweep ran;
# the fewest multiply-adds a row of a chain it takes (the self-play
# learner's 8,960 lost at 8192 rows in one sweep: below 16,384 the held
# kernel stays, on the safe side); the blocks a cluster and the ring's slots
# that ran fastest (as many slots as fit a block, at most WGMMA_SLOTS).
WGMMA_MIN_ROWS = 8192
WGMMA_MIN_ROW_MACS = 16384
WGMMA_CLUSTER = 2
WGMMA_SLOTS = 4
# activation name -> the kernel's integer code (csrc/fused_mlp.cu ``Act``)
ACTIVATION_CODES = {
    "None": 0, None: 0, "relu": 1, "elu": 2, "selu": 3, "softplus": 4,
    "gelu": 5, "sigmoid": 6, "swish": 7, "silu": 7, "tanh": 8,
}

_PLAIN_ACTS = {
    0: lambda x: x,
    1: F.relu,
    2: F.elu,
    3: F.selu,
    4: F.softplus,
    5: lambda x: F.gelu(x, approximate="tanh"),
    6: torch.sigmoid,
    7: F.silu,
    8: torch.tanh,
}

_forward = None
_stream_forward = None
_cluster_forward = None
_sets_forward = None
_wgmma_forward = None


def _activation_code(activation) -> int:
    if activation not in ACTIVATION_CODES:
        raise ValueError(f"fused_mlp has no activation {activation!r}; it has "
                         f"{sorted(k for k in ACTIVATION_CODES if k)} and None")
    return ACTIVATION_CODES[activation]


def plain_mlp(x, ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor], activation):
    """The plain PyTorch chain: Linear -> activation per layer (the
    arithmetic of ``models.layers.build_mlp``'s Sequential)."""
    f = _PLAIN_ACTS[_activation_code(activation)]
    for w, b in zip(ws, bs):
        x = f(F.linear(x, w, b))
    return x


def grouped_dims(x, ws, bs) -> Tuple[int, List[int]]:
    """(G, the chain's widths) of a chain over G weight sets: x [G, B, D_0]
    or [B, D_0], each weight [G, out, in] or [out, in], each bias [G, out]
    or [out], where a tensor without the set axis is shared by every set.
    Raises ValueError on shapes the chain does not take, and where no
    tensor has a set axis."""
    if len(ws) != len(bs):
        raise ValueError(f"{len(ws)} weights but {len(bs)} biases")
    if x.dim() not in (2, 3):
        raise ValueError(f"x must be [G, B, D] or [B, D], got {tuple(x.shape)}")
    sets = {"x": x.shape[0]} if x.dim() == 3 else {}
    dims = [x.shape[-1]]
    for i, (w, b) in enumerate(zip(ws, bs)):
        if w.dim() not in (2, 3) or w.shape[-1] != dims[-1]:
            raise ValueError(f"ws[{i}] must be [G, out, {dims[-1]}] or [out, {dims[-1]}], got {tuple(w.shape)}")
        if b.dim() not in (1, 2) or b.shape[-1] != w.shape[-2]:
            raise ValueError(f"bs[{i}] must be [G, {w.shape[-2]}] or [{w.shape[-2]}], got {tuple(b.shape)}")
        if w.dim() == 3:
            sets[f"ws[{i}]"] = w.shape[0]
        if b.dim() == 2:
            sets[f"bs[{i}]"] = b.shape[0]
        dims.append(w.shape[-2])
    counts = list(sets.values())
    if not counts or any(c != counts[0] for c in counts[1:]):
        raise ValueError(f"the set axes must agree, and one tensor at least must have one: {sets}")
    return counts[0], dims


def plain_mlp_grouped(x, ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor], activation):
    """The plain chain over G weight sets (shapes: ``grouped_dims``): one
    batched product a layer over the set axis, a shared tensor broadcast.
    Returns [G, B, D_L]."""
    groups, _ = grouped_dims(x, ws, bs)
    f = _PLAIN_ACTS[_activation_code(activation)]
    if x.dim() == 2:
        x = x.expand(groups, *x.shape)
    for w, b in zip(ws, bs):
        x = f(torch.baddbmm(b.unsqueeze(-2), x, w.transpose(-1, -2).expand(groups, -1, -1)))
    return x


def _buffer_stride(widths: Sequence[int]) -> int:
    """Row stride, in floats, of a shared-memory buffer that holds rows of
    the given widths: the widest rounded up to 8 (the depth of a tensor-core
    product; the kernel zero-fills up to there) and then to 8 * odd: the
    4 rows x 4 pairs of inputs that half a warp loads for a fragment then
    fall on 32 different banks."""
    if not widths:
        return 0
    eights = (max(widths) + 7) // 8
    return 8 * (eights if eights % 2 else eights + 1)


def _strides(dims: Sequence[int]) -> Tuple[int, int]:
    """Row strides of the even- and odd-width buffers of one held launch:
    layer i reads widths[i] from one and writes widths[i + 1] to the other,
    and the last layer writes to device memory."""
    inner = list(dims[:-1])
    return _buffer_stride(inner[0::2]), _buffer_stride(inner[1::2])


def _shared_bytes(rows: int, stride0: int, stride1: int) -> int:
    """Both activation buffers and the ring of weight tiles of a tile of
    ``rows`` rows (csrc/fused_mlp.cu ``smem_bytes_for``)."""
    return 4 * (rows * (stride0 + stride1) + _WEIGHT_RING_FLOATS)


def _fits(dims: Sequence[int]) -> bool:
    """Whether one held launch of widths ``dims`` fits a block at the smallest tile."""
    return _shared_bytes(min(TILE_ROWS), *_strides(dims)) <= MAX_SHARED_BYTES


class StreamPlan(NamedTuple):
    """A streamed launch's shape: rows a block; the blocks a row tile's
    output tiles are split over (``split``: block n takes tiles n,
    n + split, ...); the blocks of a cluster among them (x's stage is
    multicast to them); and the shared bytes a block takes."""
    rows: int
    split: int
    cluster: int
    shared: int


def stream_plan(dims: Sequence[int], batch: int) -> StreamPlan:
    """The streamed launch of one layer of widths ``dims`` = (K, N) over
    ``batch`` rows (all sets' rows for a grouped launch). Of the shapes the
    kernel takes (rows a block, a split that divides the output tiles of
    128, a cluster of 1, 2, 4 or 8 that divides the split) it picks the one
    that the measured model (STREAM_WAVE_BLOCKS, STREAM_RATE) says ends
    first: waves of blocks times the output tiles a block walks times rows
    over the rate at those rows. Of equal ones, the fewest waves, then the
    largest cluster and rows. The shared bytes are the ring's stages, their
    barriers and 1 KB to align the first stage (csrc/fused_mlp.cu
    ``StreamShape``)."""
    if len(dims) != 2:
        raise ValueError(f"a streamed launch takes one layer, got widths {list(dims)}")
    tiles = -(-dims[1] // 128)
    best = None
    for rows in STREAM_STAGES:
        row_tiles = max(1, -(-batch // rows))
        for split in (d for d in range(1, MAX_CLUSTER + 1) if tiles % d == 0):
            for cluster in (c for c in STREAM_WAVE_BLOCKS if split % c == 0):
                waves = -(-row_tiles * split // STREAM_WAVE_BLOCKS[cluster])
                time = waves * (tiles // split) * rows / STREAM_RATE[rows]
                key = (time, waves, -cluster, -rows)
                if best is None or key < best[0]:
                    best = key, (rows, split, cluster)
    rows, split, cluster = best[1]
    return StreamPlan(rows, split, cluster, 1024 + STREAM_STAGES[rows] * (4 * 32 * (128 + rows) + 16))


def kernel_plan(dims: Sequence[int], batch: int, streamed: bool = False):
    """For one launch over a chain of widths ``dims``: held, (rows per
    block, stride of the even-width buffer, stride of the odd-width buffer,
    shared bytes); streamed, ``stream_plan`` of its one layer.

    Layer i reads widths[i] from one buffer and writes widths[i + 1] to the
    other; the last layer writes to device memory. A held launch takes the
    largest tile that fits a block's shared memory and whose minimum batch
    (TILE_ROWS) is reached, else the smallest that fits. Raises ValueError
    beyond one launch's limits."""
    if streamed:
        return stream_plan(dims, batch)
    n_layers = len(dims) - 1
    if not 1 <= n_layers <= MAX_LAYERS:
        raise ValueError(f"fused_mlp takes 1 to {MAX_LAYERS} layers, got {n_layers}")
    stride0, stride1 = _strides(dims)
    fitting = [rows for rows in TILE_ROWS if _shared_bytes(rows, stride0, stride1) <= MAX_SHARED_BYTES]
    if not fitting:
        raise ValueError(
            f"fused_mlp: widths {list(dims)} need "
            f"{_shared_bytes(min(TILE_ROWS), stride0, stride1)} bytes of shared "
            f"memory at the smallest tile ({min(TILE_ROWS)} rows), above the block limit of "
            f"{MAX_SHARED_BYTES}"
        )
    rows = next((r for r in fitting if batch >= TILE_ROWS[r]), fitting[-1])
    return rows, stride0, stride1, _shared_bytes(rows, stride0, stride1)


class ClusterPlan(NamedTuple):
    """A held launch run as the cluster kernel: the blocks of a cluster
    (each owns a 1/cluster share of every layer's outputs, in whole 8-wide
    tiles) and the shared bytes a block takes."""
    cluster: int
    shared: int


def cluster_tiles(dims: Sequence[int], cluster: int) -> List[int]:
    """The 8-wide output tiles a block of a cluster of ``cluster`` owns in
    each layer: ceil(ceil(N / 8) / cluster), the last blocks fewer or none
    (block r owns tiles r S .. r S + S - 1 of the layer)."""
    return [-(-(-(-n // 8)) // cluster) for n in dims[1:]]


def cluster_shared_bytes(dims: Sequence[int], cluster: int) -> int:
    """The cluster kernel's shared memory for one launch of widths ``dims``:
    dynamic (csrc/fused_mlp.cu ``cluster_layout``), the held kernel's two
    activation buffers at 16 rows, then per layer the block's share of W
    (room for its rows at the 8 * odd stride of ``_buffer_stride``) and of
    b, and two 8-byte barriers for each of ``MAX_LAYERS``; and static, the
    kernel's table of layers."""
    stride0, stride1 = _strides(dims)
    floats = 16 * (stride0 + stride1)
    for k, tiles in zip(dims[:-1], cluster_tiles(dims, cluster)):
        floats += 8 * tiles * (_buffer_stride([k]) + 1)
    return 4 * (floats + _CLUSTER_BARRIER_FLOATS) + _CLUSTER_TABLE_BYTES


def held_weight_tiles(dims: Sequence[int]) -> int:
    """The weight tiles (128 outputs x 32 inputs) that one held launch of
    widths ``dims`` walks through its ring, one after another."""
    return sum(-(-n // 128) * -(-k // 32) for k, n in zip(dims[:-1], dims[1:]))


def cluster_plan(dims: Sequence[int], batch: int) -> Optional[ClusterPlan]:
    """The cluster kernel's shape for a held launch of widths ``dims`` over
    ``batch`` rows, or None where the held kernel runs it: a batch past the
    crossover (CLUSTER_SHAPES), a chain of fewer weight tiles than
    CLUSTER_MIN_TILES, or shares that do not fit a block's shared memory."""
    if held_weight_tiles(dims) < CLUSTER_MIN_TILES:
        return None
    cluster = next((cluster for most, cluster in CLUSTER_SHAPES if batch <= most), None)
    if cluster is None:
        return None
    shared = cluster_shared_bytes(dims, cluster)
    return ClusterPlan(cluster, shared) if shared <= MAX_SHARED_BYTES else None


class SetsPlan(NamedTuple):
    """A grouped launch run as the sets kernel: its instance's rows a set
    (``SETS_ROWS``, at least the batch), the ring's stages, the multiplying
    warps a set (a group of them takes each set; the stages a multiple of
    the groups) and the dynamic shared bytes a block takes."""
    rows: int
    stages: int
    warps: int
    shared: int


def _up4(floats: int) -> int:
    return -(-floats // 4) * 4


def sets_tensor_floats(dims: Sequence[int], batch: int) -> List[int]:
    """The floats of one set of each tensor of a sets launch, in the
    kernel's order: x's rows, then W_0, b_0, W_1, b_1, ..."""
    return [batch * dims[0]] + [f for k, n in zip(dims[:-1], dims[1:]) for f in (n * k, n)]


class SetsLayout(NamedTuple):
    """Where the sets kernel keeps a launch in shared memory, in floats
    (csrc/fused_mlp.cu ``sets_layout``): each tensor's offset (a shared one
    from the start of shared memory, the others from their stage's start),
    the two activation buffers, the ring and the whole."""
    offsets: Tuple[int, ...]
    act_off: int
    act_floats: int
    ring_off: int
    stage_floats: int
    floats: int


def sets_layout(dims: Sequence[int], batch: int, stages: int, shared: Optional[Sequence[bool]] = None,
                warps: int = SETS_MULTIPLYING_WARPS) -> SetsLayout:
    """The sets kernel's shared memory for one launch of widths ``dims``
    over sets of ``batch`` rows: a full and an empty barrier a stage and one
    more (8 bytes each), the tensors every set shares (``shared``: a flag
    per tensor of ``sets_tensor_floats``, True at set stride 0; None: none),
    two activation buffers of ``batch`` rows of the widest inner width for
    each group of ``warps`` multiplying warps, then ``stages`` stages of the
    other tensors; every region a multiple of 4 floats (16 bytes)."""
    floats = sets_tensor_floats(dims, batch)
    shared = tuple(shared) if shared is not None else (False,) * len(floats)
    offsets = [0] * len(floats)
    off = _up4(2 * (2 * stages + 1))
    for k, f in enumerate(floats):
        if shared[k]:
            offsets[k], off = off, off + _up4(f)
    act_off, act_floats = off, _up4(batch * max(dims[1:-1], default=0))
    ring_off = act_off + 2 * (SETS_MULTIPLYING_WARPS // warps) * act_floats
    stage = 0
    for k, f in enumerate(floats):
        if not shared[k]:
            offsets[k], stage = stage, stage + _up4(f)
    return SetsLayout(tuple(offsets), act_off, act_floats, ring_off, stage, ring_off + stages * stage)


def sets_shared_bytes(dims: Sequence[int], batch: int, stages: int, shared: Optional[Sequence[bool]] = None,
                      warps: int = SETS_MULTIPLYING_WARPS) -> int:
    """The sets kernel's dynamic shared memory in bytes (``sets_layout``)."""
    return 4 * sets_layout(dims, batch, stages, shared, warps).floats


def sets_warps(stages: int, warps: int = SETS_WARPS) -> int:
    """The multiplying warps a set at ``stages`` stages: ``warps``, or as
    many more (doubled) as make the stages a multiple of the groups."""
    while SETS_MULTIPLYING_WARPS // warps > stages or stages % (SETS_MULTIPLYING_WARPS // warps):
        warps *= 2
    return warps


def sets_plan(dims: Sequence[int], batch: int, groups: int,
              shared: Optional[Sequence[bool]] = None) -> Optional[SetsPlan]:
    """The sets kernel's shape for a held grouped launch of widths ``dims``
    over ``groups`` sets of ``batch`` rows (``shared`` as
    ``sets_shared_bytes``'), or None where the held kernel runs it: more
    than SETS_MAX_ROWS rows a set, fewer sets than SETS_MIN_GROUPS gives the
    instance's rows (G = 1 is the ordinary launch), or a set whose tensors
    do not fit two stages in a block's shared memory. The ring takes
    SETS_STAGES stages, or as many as fit, and SETS_WARPS warps a set, or
    more where the stages would not be a multiple of the groups
    (``sets_warps``)."""
    if not 1 <= batch <= SETS_MAX_ROWS or not 1 <= len(dims) - 1 <= MAX_LAYERS:
        return None
    rows = next(r for r in SETS_ROWS if r >= batch)
    if groups < SETS_MIN_GROUPS[rows]:
        return None
    for stages in range(SETS_STAGES, 1, -1):
        warps = sets_warps(stages)
        shared_bytes = sets_shared_bytes(dims, batch, stages, shared, warps)
        if shared_bytes + _SETS_TABLE_BYTES <= MAX_SHARED_BYTES:
            return SetsPlan(rows, stages, warps, shared_bytes)
    return None


def sets_copy(address: int, floats: int):
    """How the sets kernel copies one set of a tensor, ``floats`` floats at
    byte ``address``: "bulk" (one bulk copy: a 16-byte aligned address and
    a multiple of 16 bytes), else the width in bytes (16, 8 or 4) of the
    cp.async that the address allows, the floats past the last whole copy
    going 4 bytes a copy (csrc/fused_mlp.cu ``sets_copy``)."""
    if address % 16 == 0 and floats % 4 == 0:
        return "bulk"
    return 16 if address % 16 == 0 else 8 if address % 8 == 0 else 4


def sets_copy_modes(address: int, set_stride: int, floats: int, groups: int) -> list:
    """``sets_copy`` of each set of a tensor at byte ``address`` whose sets
    lie ``set_stride`` floats apart; a shared tensor (set stride 0) is
    copied once, so it has one."""
    return [sets_copy(address + 4 * g * set_stride, floats) for g in range(groups if set_stride else 1)]


class WgmmaPlan(NamedTuple):
    """A held launch run as the wgmma kernel: the blocks of a cluster (a
    weight tile is multicast to them), the ring's slots and the dynamic
    shared bytes a block takes."""
    cluster: int
    slots: int
    shared: int


def wgmma_half(n: int) -> int:
    """The outputs that one consumer warpgroup of the wgmma kernel takes of
    a layer of ``n`` outputs: half of them rounded up to 8, then to an
    instruction width of ``WGMMA_HALVES`` (csrc/fused_mlp.cu
    ``wgmma_half``). Rows of W past n are zero-filled."""
    half = -(-n // 16) * 8
    return next(h for h in WGMMA_HALVES if h >= half)


def wgmma_width(dims: Sequence[int]) -> int:
    """Floats of a row of the wgmma kernel's activation buffer: x's inputs
    rounded up to 32 and every layer's outputs but the last's written up to
    twice its half (the next layer's zero-filled inputs)."""
    return max([-(-dims[0] // 32) * 32] + [2 * wgmma_half(n) for n in dims[1:-1]])


def wgmma_stage_bytes(n: int, k: int) -> int:
    """The bytes of a layer's W [n, k] in the wgmma kernel's staging buffer:
    where bulk tensor copies can never take its rows (k not a multiple of 4)
    and one bulk copy takes it whole (its bytes a multiple of 16, at most
    WGMMA_MAX_STAGE_BYTES), else 0 (csrc/fused_mlp.cu ``wg_stage_bytes``)."""
    nbytes = 4 * n * k
    return nbytes if k % 4 and nbytes % 16 == 0 and nbytes <= WGMMA_MAX_STAGE_BYTES else 0


def wgmma_shared_bytes(dims: Sequence[int], slots: int) -> int:
    """The wgmma kernel's dynamic shared memory (csrc/fused_mlp.cu
    ``wgmma_layout``): 1 KB to align to the swizzle's 1024 bytes, the
    activation buffer (64 rows of ``wgmma_width``), ``slots`` slots of 128
    rows of W by 32 inputs and their lo tile, the staging buffer (the
    largest ``wgmma_stage_bytes`` of a layer), three 8-byte barriers a slot
    (full, empty, ready) and the staging buffer's two."""
    stage = max(wgmma_stage_bytes(dims[i + 1], dims[i]) for i in range(len(dims) - 1))
    return (1024 + 4 * (WGMMA_ROWS * wgmma_width(dims) + slots * 2 * WGMMA_SLOT_ROWS * 32) + stage
            + 3 * 8 * slots + 2 * 8)


def row_macs(dims: Sequence[int]) -> int:
    """The multiply-adds a row of the chain ``dims`` takes."""
    return sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))


def wgmma_takes(dims: Sequence[int]) -> bool:
    """Whether the wgmma kernel takes one launch of widths ``dims``: 1 to
    MAX_LAYERS layers, every width 1 to 256."""
    return 1 <= len(dims) - 1 <= MAX_LAYERS and all(1 <= d <= WGMMA_MAX_WIDTH for d in dims)


def wgmma_plan(dims: Sequence[int], batch: int, cluster: int = None, slots: int = None) -> Optional[WgmmaPlan]:
    """The wgmma kernel's shape for a held, ungrouped launch of widths
    ``dims`` over ``batch`` rows, or None where another kernel runs it: a
    batch below the crossover (WGMMA_MIN_ROWS), a chain of fewer than
    WGMMA_MIN_ROW_MACS multiply-adds a row, or widths it does not take.
    The cluster is WGMMA_CLUSTER and the ring as many slots as fit a block,
    at most WGMMA_SLOTS; ``cluster`` and ``slots`` force either (the
    sweep's shapes, at any batch and chain)."""
    routed = batch >= WGMMA_MIN_ROWS and row_macs(dims) >= WGMMA_MIN_ROW_MACS
    if not wgmma_takes(dims) or (cluster is None and slots is None and not routed):
        return None
    cluster = WGMMA_CLUSTER if cluster is None else cluster
    lowest, highest = WGMMA_SLOTS_RANGE
    if slots is None:
        slots = next((s for s in range(min(WGMMA_SLOTS, highest), lowest - 1, -1)
                      if wgmma_shared_bytes(dims, s) <= MAX_SHARED_BYTES), 0)
    shared = wgmma_shared_bytes(dims, slots)
    if not lowest <= slots <= highest or shared > MAX_SHARED_BYTES or cluster not in WGMMA_CLUSTERS:
        return None
    return WgmmaPlan(cluster, slots, shared)


def wgmma_copy(address: int, n: int, k: int):
    """How the wgmma kernel brings W [n, k] at byte ``address`` into shared
    memory: "tensor map" (bulk tensor copies of its slices: a 16-byte
    aligned address and rows of a multiple of 16 bytes), "staged" (one bulk
    copy of the whole weight into the staging buffer, whose rows the
    splitting warps swizzle into the ring: a 16-byte aligned address and
    ``wgmma_stage_bytes``), else the width in bytes (16, 8 or 4) of the
    cp.async that the address and the rows allow (csrc/fused_mlp.cu
    ``fused_mlp_wgmma_forward``, ``wg_copy``)."""
    if address % 16 == 0 and k % 4 == 0:
        return "tensor map"
    if address % 16 == 0 and wgmma_stage_bytes(n, k):
        return "staged"
    return 8 if address % 8 == 0 and k % 2 == 0 else 4


def wgmma_copy_modes(x, ws) -> list:
    """The cp.async width (16, 8 or 4 bytes) of x's rows and ``wgmma_copy``
    of each weight of a launch."""
    address, k = x.data_ptr(), x.shape[-1]
    x_mode = 16 if address % 16 == 0 and k % 4 == 0 else 8 if address % 8 == 0 and k % 2 == 0 else 4
    return [x_mode] + [wgmma_copy(w.data_ptr(), *w.shape[-2:]) for w in ws]


class Launch(NamedTuple):
    """One launch of a chain: layers ``first`` .. ``last`` - 1, held or (one
    layer) streamed, its ``kernel_plan``; a held launch that runs as the
    cluster kernel also its ``cluster_plan``, a held grouped launch that
    runs as the sets kernel its ``sets_plan``, a held launch that runs as
    the wgmma kernel its ``wgmma_plan`` (None: the held kernel)."""
    first: int
    last: int
    streamed: bool
    plan: tuple
    cluster: Optional[ClusterPlan] = None
    sets: Optional[SetsPlan] = None
    wgmma: Optional[WgmmaPlan] = None


def launch_plan(dims: Sequence[int], batch: int, cluster: bool = True) -> List[Launch]:
    """The launches of a chain of widths ``dims`` in order, each over at
    most ``MAX_LAYERS`` consecutive layers whose held widths fit a block's
    shared memory. A launch ends before an inner width that no buffer holds
    beside the others and writes it to device memory; a layer whose input
    no buffer holds is a streamed launch of its own. A chain that one
    launch takes is one launch, with ``kernel_plan(dims, batch)``. With
    ``cluster`` a held launch takes ``cluster_plan`` (the cluster kernel
    where it picks one) or else ``wgmma_plan`` (the wgmma kernel where it
    picks one); without (the grouped launches), every held launch is the
    held kernel's. Every call of the kernel asks, so the plan is kept by
    the widths, the batch and ``cluster``: a call pays a lookup, not the
    plans' sums."""
    return list(_launch_plan(tuple(dims), batch, cluster))


@functools.lru_cache(maxsize=1024)
def _launch_plan(dims: Tuple[int, ...], batch: int, cluster: bool) -> Tuple[Launch, ...]:
    n_layers = len(dims) - 1
    if n_layers < 1:
        raise ValueError(f"fused_mlp takes 1 layer at least, got {n_layers}")
    launches: List[Launch] = []
    first = 0
    while first < n_layers:
        last = first
        while last < n_layers and last - first < MAX_LAYERS and _fits(dims[first:last + 2]):
            last += 1
        streamed = last == first
        last = max(last, first + 1)
        held = None if streamed or not cluster else cluster_plan(dims[first:last + 1], batch)
        wgmma = None if streamed or not cluster or held else wgmma_plan(dims[first:last + 1], batch)
        launches.append(Launch(first, last, streamed, kernel_plan(dims[first:last + 1], batch, streamed), held,
                               wgmma=wgmma))
        first = last
    return tuple(launches)


def grouped_launch_plan(dims: Sequence[int], batch: int, groups: int,
                        shared: Optional[Sequence[bool]] = None) -> List[Launch]:
    """The launches of a chain of widths ``dims`` over ``groups`` sets of
    ``batch`` rows (``shared`` as ``sets_shared_bytes``', for the whole
    chain): ``launch_plan``'s cuts without the cluster kernel, which takes
    one weight set; a set of at most 16 rows planned as one 16-row tile,
    where a 32-row tile would only idle more rows, else over all rows. Each
    held launch that ``sets_plan`` takes runs as the sets kernel; the
    input of a launch after the first is a scratch of each set's own."""
    launches = launch_plan(dims, groups * batch if batch > 16 else 0, cluster=False)
    shared = tuple(shared) if shared is not None else (False,) * (2 * len(dims) - 1)
    return [launch if launch.streamed else launch._replace(sets=sets_plan(
        dims[launch.first:launch.last + 1], batch, groups,
        (shared[0] and launch.first == 0,) + shared[1 + 2 * launch.first:1 + 2 * launch.last]))
        for launch in launches]


def stream_grid(plan: StreamPlan, batch: int, groups: int = 1) -> Tuple[int, int]:
    """The grid of a streamed launch over ``groups`` sets of ``batch`` rows:
    (row tiles times the split, groups)."""
    return -(-batch // plan.rows) * plan.split, groups


def stream_copy(x, w, x_set: int = 0, w_set: int = 0) -> int:
    """The copy mode of a streamed launch over x [.., B, K] and W [.., N, K]
    at set strides (floats) ``x_set`` and ``w_set``: bit 0 set where x's
    rows go by bulk tensor copies, bit 1 W's. Those need a 16-byte aligned
    address, row stride and set stride; other rows take the kernel's own
    ``cp.async`` copies (3134 and 3135 inputs: 8 and 4 bytes wide)."""
    def bulk(t, set_stride):
        return t.shape[-1] % 4 == 0 and t.data_ptr() % 16 == 0 and set_stride % 4 == 0

    return int(bulk(x, x_set)) | 2 * int(bulk(w, w_set))


def stream_copy_name(copy: int) -> str:
    """A copy mode of ``stream_copy`` in words."""
    return ", ".join(f"{name} {'bulk tensor copies' if copy & bit else 'cp.async'}"
                     for name, bit in (("x", 1), ("W", 2)))


def _kernel():
    global _forward
    if _forward is None:
        fn = cuda_build.load("fused_mlp").fused_mlp_forward
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ]
        fn.restype = ctypes.c_int
        _forward = fn
    return _forward


def _stream_kernel():
    global _stream_forward
    if _stream_forward is None:
        fn = cuda_build.load("fused_mlp").fused_mlp_stream_forward
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ]
        fn.restype = ctypes.c_int
        _stream_forward = fn
    return _stream_forward


# csrc/fused_mlp.cu fused_mlp_cluster_forward(x, out, B, n_layers, dims, ws,
# bs, act, cluster, stride0, stride1, stream, attr_err)
CLUSTER_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
)


def _cluster_kernel():
    global _cluster_forward
    if _cluster_forward is None:
        fn = cuda_build.load("fused_mlp").fused_mlp_cluster_forward
        fn.argtypes = list(CLUSTER_ARGTYPES)
        fn.restype = ctypes.c_int
        _cluster_forward = fn
    return _cluster_forward


# csrc/fused_mlp.cu fused_mlp_sets_forward(x, out, B, n_layers, dims, ws, bs,
# act, rows, stages, warps, groups, x_set, out_set, w_set, b_set, stream,
# attr_err)
SETS_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
)


def _sets_kernel():
    global _sets_forward
    if _sets_forward is None:
        fn = cuda_build.load("fused_mlp").fused_mlp_sets_forward
        fn.argtypes = list(SETS_ARGTYPES)
        fn.restype = ctypes.c_int
        _sets_forward = fn
    return _sets_forward


# csrc/fused_mlp.cu fused_mlp_wgmma_forward(x, out, B, n_layers, dims, ws, bs,
# act, cluster, slots, stream, attr_err)
WGMMA_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
)


def _wgmma_kernel():
    global _wgmma_forward
    if _wgmma_forward is None:
        fn = cuda_build.load("fused_mlp").fused_mlp_wgmma_forward
        fn.argtypes = list(WGMMA_ARGTYPES)
        fn.restype = ctypes.c_int
        _wgmma_forward = fn
    return _wgmma_forward


def wgmma_grid(plan: WgmmaPlan, batch: int) -> int:
    """The blocks of a wgmma launch over ``batch`` rows: a block a row tile
    of 64, at most as many whole clusters as the card holds at once
    (cudaOccupancyMaxActiveClusters; builds the kernel)."""
    fn = cuda_build.load("fused_mlp").fused_mlp_wgmma_grid
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    grid = fn(batch, plan.cluster, plan.shared)
    if grid < 1:
        raise RuntimeError(f"fused_mlp_wgmma_grid failed for {plan}, B = {batch}")
    return grid


def wgmma_empty_launch(plan: WgmmaPlan, batch: int) -> None:
    """An empty kernel at the block, grid, cluster and shared memory of a
    wgmma launch over ``batch`` rows on the current stream: the floor under
    its time (chip_smoke.py and tools/fused_mlp_ab.py time it). Not a launch
    of the kernel: it counts nowhere."""
    fn = cuda_build.load("fused_mlp").fused_mlp_wgmma_empty
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(batch, plan.cluster, plan.shared, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp_wgmma_empty failed with CUDA error {err}")


def sets_grid(plan: SetsPlan, groups: int) -> int:
    """The blocks of a sets launch over ``groups`` sets: as many as the card
    holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor at the
    plan's shared memory), at most one a set (builds the kernel)."""
    fn = cuda_build.load("fused_mlp").fused_mlp_sets_grid
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    grid = fn(plan.rows, groups, plan.shared)
    if grid < 1:
        raise RuntimeError(f"fused_mlp_sets_grid failed for {plan}, {groups} sets")
    return grid


def sets_empty_launch(plan: SetsPlan, groups: int) -> None:
    """An empty kernel at the block, grid and shared memory of a sets launch
    over ``groups`` sets on the current stream: the floor under its time
    (chip_smoke.py and tools/fused_mlp_ab.py time it). Not a launch of the
    kernel: it counts nowhere."""
    fn = cuda_build.load("fused_mlp").fused_mlp_sets_empty
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(sets_grid(plan, groups), plan.shared, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp_sets_empty failed with CUDA error {err}")


def cluster_grid(plan: ClusterPlan, batch: int) -> int:
    """The blocks of a cluster launch over ``batch`` rows: a cluster a
    16-row tile."""
    return -(-batch // 16) * plan.cluster


def cluster_empty_launch(plan: ClusterPlan, batch: int) -> None:
    """An empty kernel at the grid, cluster and shared memory of a cluster
    launch over ``batch`` rows on the current stream: the floor under its
    time (chip_smoke.py and tools/fused_mlp_ab.py time it). Not a launch of
    the kernel: it counts nowhere."""
    fn = cuda_build.load("fused_mlp").fused_mlp_cluster_empty
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(batch, plan.cluster, plan.shared, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp_cluster_empty failed with CUDA error {err}")


def stream_clusters(rows: int, cluster: int) -> int:
    """How many clusters of ``cluster`` streamed blocks of ``rows`` rows the
    card holds at once (cudaOccupancyMaxActiveClusters; builds the kernel)."""
    fn = cuda_build.load("fused_mlp").fused_mlp_stream_clusters
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(rows, cluster)


def _rows_contiguous(t) -> bool:
    """Whether t's last two dims (a vector's one) are contiguous: a set's
    rows, as the kernel walks them."""
    if t.is_contiguous():  # the common case, without the loop's host time
        return True
    expected = 1
    for size, stride in zip(reversed(t.shape[-2:]), reversed(t.stride()[-2:])):
        if size != 1 and stride != expected:
            return False
        expected *= size
    return True


def _check_tensors(x, ws, bs):
    """Type, row layout and device of the chain's tensors: float32, the last
    two dims (a set's rows) contiguous, every tensor on x's CUDA device."""
    names = ["x"] + [f"ws[{i}]" for i in range(len(ws))] + [f"bs[{i}]" for i in range(len(bs))]
    for name, t in zip(names, (x, *ws, *bs)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not _rows_contiguous(t):
            raise ValueError(f"{name} must be contiguous in its last {min(t.dim(), 2)} dims")
    if not x.is_cuda:
        raise ValueError(f"x must lie on a CUDA device, got {x.device}")
    for name, t in zip(names, (x, *ws, *bs)):
        if t.device != x.device:
            raise ValueError(f"{name} must lie on {x.device}, got {t.device}")


def _launch(x, out, batch, dims, ws, bs, act, launch, groups, set_strides):
    """One launch of the kernel over ``groups`` weight sets: the chain
    ``dims`` / ``ws`` / ``bs`` of ``launch`` (a ``launch_plan`` entry).
    ``set_strides``: (x's, out's, [each weight's], [each bias's]), in
    floats."""
    global fused_mlp_launches, fused_mlp_cluster_launches, fused_mlp_sets_launches, fused_mlp_wgmma_launches
    n = len(ws)
    x_set, out_set, w_sets, b_sets = set_strides
    attr_err = ctypes.c_int(0)
    for kernel, plan in (("cluster", launch.cluster), ("wgmma", launch.wgmma)):
        if plan is not None and groups != 1:
            raise ValueError(f"the {kernel} kernel takes one weight set, got {groups}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if launch.sets is not None:
            rows, stages, warps, shared = launch.sets
            c_dims = (ctypes.c_int * (n + 1))(*dims)
            c_ws = (ctypes.c_void_p * n)(*(w.data_ptr() for w in ws))
            c_bs = (ctypes.c_void_p * n)(*(b.data_ptr() for b in bs))
            c_w_sets = (ctypes.c_longlong * n)(*w_sets)
            c_b_sets = (ctypes.c_longlong * n)(*b_sets)
            err = _sets_kernel()(
                x.data_ptr(), out.data_ptr(), batch, n,
                ctypes.cast(c_dims, ctypes.c_void_p), ctypes.cast(c_ws, ctypes.c_void_p),
                ctypes.cast(c_bs, ctypes.c_void_p),
                act, rows, stages, warps, groups, x_set, out_set,
                ctypes.cast(c_w_sets, ctypes.c_void_p), ctypes.cast(c_b_sets, ctypes.c_void_p),
                stream, ctypes.byref(attr_err),
            )
        elif launch.wgmma is not None:
            cluster, slots, shared = launch.wgmma
            c_dims = (ctypes.c_int * (n + 1))(*dims)
            c_ws = (ctypes.c_void_p * n)(*(w.data_ptr() for w in ws))
            c_bs = (ctypes.c_void_p * n)(*(b.data_ptr() for b in bs))
            err = _wgmma_kernel()(
                x.data_ptr(), out.data_ptr(), batch, n,
                ctypes.cast(c_dims, ctypes.c_void_p), ctypes.cast(c_ws, ctypes.c_void_p),
                ctypes.cast(c_bs, ctypes.c_void_p),
                act, cluster, slots, stream, ctypes.byref(attr_err),
            )
        elif launch.cluster is not None:
            rows, stride0, stride1, _ = launch.plan
            cluster, shared = launch.cluster
            c_dims = (ctypes.c_int * (n + 1))(*dims)
            c_ws = (ctypes.c_void_p * n)(*(w.data_ptr() for w in ws))
            c_bs = (ctypes.c_void_p * n)(*(b.data_ptr() for b in bs))
            err = _cluster_kernel()(
                x.data_ptr(), out.data_ptr(), batch, n,
                ctypes.cast(c_dims, ctypes.c_void_p), ctypes.cast(c_ws, ctypes.c_void_p),
                ctypes.cast(c_bs, ctypes.c_void_p),
                act, cluster, stride0, stride1, stream, ctypes.byref(attr_err),
            )
        elif launch.streamed:
            rows, split, cluster, shared = launch.plan
            err = _stream_kernel()(
                x.data_ptr(), out.data_ptr(), batch, dims[0], dims[1], ws[0].data_ptr(), bs[0].data_ptr(),
                act, rows, split, cluster, groups, x_set, out_set, w_sets[0], b_sets[0],
                stream_copy(x, ws[0], x_set, w_sets[0]), stream, ctypes.byref(attr_err),
            )
        else:
            rows, stride0, stride1, shared = launch.plan
            c_dims = (ctypes.c_int * (n + 1))(*dims)
            c_ws = (ctypes.c_void_p * n)(*(w.data_ptr() for w in ws))
            c_bs = (ctypes.c_void_p * n)(*(b.data_ptr() for b in bs))
            c_w_sets = (ctypes.c_longlong * n)(*w_sets)
            c_b_sets = (ctypes.c_longlong * n)(*b_sets)
            err = _kernel()(
                x.data_ptr(), out.data_ptr(), batch, n,
                ctypes.cast(c_dims, ctypes.c_void_p), ctypes.cast(c_ws, ctypes.c_void_p),
                ctypes.cast(c_bs, ctypes.c_void_p),
                act, rows, stride0, stride1, groups, x_set, out_set,
                ctypes.cast(c_w_sets, ctypes.c_void_p), ctypes.cast(c_b_sets, ctypes.c_void_p),
                stream, ctypes.byref(attr_err),
            )
    name = ("fused_mlp_sets_forward" if launch.sets is not None
            else "fused_mlp_wgmma_forward" if launch.wgmma is not None
            else "fused_mlp_cluster_forward" if launch.cluster is not None
            else "fused_mlp_stream_forward" if launch.streamed else "fused_mlp_forward")
    if (launch.sets is not None or launch.wgmma is not None) and attr_err.value == -1:
        raise RuntimeError(f"{name}: the card holds no block of {shared} bytes of dynamic shared memory")
    if attr_err.value == -3:
        kernel = "wgmma" if launch.wgmma is not None else f"{rows}-row"
        raise RuntimeError(f"{name}: the {kernel} kernel was not built with the 168 registers a thread "
                           "that its exchange of registers between warpgroups (setmaxnreg) counts on")
    if attr_err.value != 0:
        raise RuntimeError(f"{name}: cudaFuncSetAttribute({shared} bytes of dynamic "
                           f"shared memory) failed with CUDA error {attr_err.value}")
    if err == -2:
        raise RuntimeError(f"{name}: the tensor maps of the bulk copies could not be encoded")
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    fused_mlp_launches += 1
    if launch.cluster is not None:
        fused_mlp_cluster_launches += 1
    if launch.sets is not None:
        fused_mlp_sets_launches += 1
    if launch.wgmma is not None:
        fused_mlp_wgmma_launches += 1


def _run_chain(x, out, batch, dims, ws, bs, act, launches, groups=1, set_strides=None):
    """The chain through ``launch_plan``'s ``launches`` into ``out``, each
    width between two launches in a scratch [G, B, D] on the card (set
    stride B * D). ``set_strides`` as ``_launch``'s; None: all 0, the
    ordinary chain (G = 1)."""
    n = len(ws)
    x_set, out_set, w_sets, b_sets = set_strides or (0, 0, [0] * n, [0] * n)
    h = x
    for launch in launches:
        a, b = launch.first, launch.last
        if b == n:
            dst, dst_set = out, out_set
        else:
            dst = torch.empty((groups, batch, dims[b]), dtype=torch.float32, device=x.device)
            dst_set = dst.stride(0)
        _launch(h, dst, batch, dims[a:b + 1], ws[a:b], bs[a:b], act, launch, groups,
                (x_set, dst_set, w_sets[a:b], b_sets[a:b]))
        h, x_set = dst, dst_set


def fused_mlp_cuda(x, ws, bs, activation):
    """The chain through the CUDA kernel (``launch_plan``'s launches); raises
    on anything it does not take."""
    act = _activation_code(activation)
    ws, bs = tuple(ws), tuple(bs)
    if len(ws) != len(bs):
        raise ValueError(f"{len(ws)} weights but {len(bs)} biases")
    if x.dim() != 2:
        raise ValueError(f"x must be [B, D], got {tuple(x.shape)}")
    dims = [x.shape[1]]
    for i, (w, b) in enumerate(zip(ws, bs)):
        if w.dim() != 2 or w.shape[1] != dims[-1]:
            raise ValueError(f"ws[{i}] must be [out, {dims[-1]}], got {tuple(w.shape)}")
        if tuple(b.shape) != (w.shape[0],):
            raise ValueError(f"bs[{i}] must be [{w.shape[0]}], got {tuple(b.shape)}")
        dims.append(w.shape[0])
    if min(dims) < 1:
        raise ValueError(f"every width must be at least 1, got {dims}")
    _check_tensors(x, ws, bs)
    batch = x.shape[0]
    launches = launch_plan(dims, batch)
    out = torch.empty((batch, dims[-1]), dtype=torch.float32, device=x.device)
    if batch > 0:
        _run_chain(x, out, batch, dims, ws, bs, act, launches)
    return out


def grouped_set_strides(x, ws, bs, out):
    """The set strides (floats) of a grouped chain's tensors, as ``_launch``
    takes them: (x's, out's, [each weight's], [each bias's]); a tensor
    without the set axis at 0."""
    def set_stride(t, batched_dims):
        return t.stride(0) if t.dim() == batched_dims else 0

    return set_stride(x, 3), out.stride(0), [set_stride(w, 3) for w in ws], [set_stride(b, 2) for b in bs]


def set_strides_shared(set_strides) -> Tuple[bool, ...]:
    """For each tensor of ``sets_tensor_floats`` (x, W_0, b_0, ...), whether
    its set stride is 0 (no set axis, or an expanded one): shared by every
    set, so the sets kernel copies it once."""
    x_set, _, w_sets, b_sets = set_strides
    return (x_set == 0,) + tuple(s == 0 for pair in zip(w_sets, b_sets) for s in pair)


def fused_mlp_grouped_cuda(x, ws, bs, activation):
    """The chain over G weight sets (shapes: ``grouped_dims``) through the
    CUDA kernel, each launch of ``grouped_launch_plan`` one grouped launch:
    the held kernel (a set a row of blocks) or, at few rows a set, the sets
    kernel; a tensor without the set axis goes in at set stride 0, shared
    and copied once. Returns [G, B, D_L]; raises on anything it does not
    take, and on a G beyond MAX_GROUPS."""
    global fused_mlp_grouped_launches
    act = _activation_code(activation)
    ws, bs = tuple(ws), tuple(bs)
    groups, dims = grouped_dims(x, ws, bs)
    if min(dims) < 1:
        raise ValueError(f"every width must be at least 1, got {dims}")
    if groups > MAX_GROUPS:
        raise ValueError(f"fused_mlp takes at most {MAX_GROUPS} weight sets a launch, got {groups}")
    _check_tensors(x, ws, bs)
    batch = x.shape[-2]
    out = torch.empty((groups, batch, dims[-1]), dtype=torch.float32, device=x.device)
    set_strides = grouped_set_strides(x, ws, bs, out)
    launches = grouped_launch_plan(dims, batch, groups, set_strides_shared(set_strides))
    if groups == 0 or batch == 0:
        return out
    _run_chain(x, out, batch, dims, ws, bs, act, launches, groups, set_strides)
    fused_mlp_grouped_launches += len(launches)
    return out


def _in_float32(cuda, x, ws, bs, activation):
    """``cuda`` (a chain through the kernel, which takes float32 alone) on
    inputs of any floating dtype, as ``fused_mlp_pallas`` takes them: each
    floating tensor that is not float32 cast to float32, the result cast
    back to x's dtype."""
    if all(t.dtype == torch.float32 for t in (x, *ws, *bs)):
        return cuda(x, ws, bs, activation)

    def f32(t):
        return t.float() if t.is_floating_point() else t

    return cuda(f32(x), [f32(w) for w in ws], [f32(b) for b in bs], activation).to(x.dtype)


# ---------------------------------------------------------------------------
# The registered operator rl_games_tpu_torch::fused_mlp: what torch.export
# records in a graph (a ctypes call is opaque to its tracer), and the route of
# every forward that needs gradients. Its CUDA implementation is the kernel
# (``fused_mlp_cuda``, looked up when called, on float32 copies of inputs of
# another floating dtype), its CPU implementation
# ``plain_mlp``; its fake implementation gives tracing the output's shape; its
# backward recomputes through ``plain_mlp``, as the JAX package's custom VJP
# does (rl_games_tpu/ops/fused_mlp.py:189-212).
# ---------------------------------------------------------------------------


@torch.library.custom_op("rl_games_tpu_torch::fused_mlp", mutates_args=(), device_types="cuda")
def fused_mlp_op(x: torch.Tensor, ws: List[torch.Tensor], bs: List[torch.Tensor], activation: str) -> torch.Tensor:
    return _in_float32(fused_mlp_cuda, x, ws, bs, activation)


@fused_mlp_op.register_kernel("cpu")
def _fused_mlp_cpu(x, ws, bs, activation):
    return plain_mlp(x, ws, bs, activation)


@fused_mlp_op.register_fake
def _fused_mlp_fake(x, ws, bs, activation):
    return x.new_empty((x.shape[0], ws[-1].shape[0]))


def _setup_context(ctx, inputs, output):
    x, ws, bs, activation = inputs
    ctx.activation, ctx.n = activation, len(ws)
    ctx.save_for_backward(x, *ws, *bs)


def _recomputing_backward(plain):
    """The backward of an operator over the chain: exact gradients through
    a recomputed ``plain`` chain, for the inputs that need them."""

    def backward(ctx, grad_out):
        need_x, need_ws, need_bs, _ = ctx.needs_input_grad
        needs = [need_x, *need_ws, *need_bs]
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need) for t, need in zip(saved, needs)]
            n = ctx.n
            y = plain(leaves[0], leaves[1:1 + n], leaves[1 + n:], ctx.activation)
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, grad_out))
        full = [next(grads) if need else None for need in needs]
        return full[0], full[1:1 + n], full[1 + n:], None

    return backward


fused_mlp_op.register_autograd(_recomputing_backward(plain_mlp), setup_context=_setup_context)


@torch.library.custom_op("rl_games_tpu_torch::fused_mlp_grouped", mutates_args=(), device_types="cuda")
def fused_mlp_grouped_op(x: torch.Tensor, ws: List[torch.Tensor], bs: List[torch.Tensor],
                         activation: str) -> torch.Tensor:
    return _in_float32(fused_mlp_grouped_cuda, x, ws, bs, activation)


@fused_mlp_grouped_op.register_kernel("cpu")
def _fused_mlp_grouped_cpu(x, ws, bs, activation):
    return plain_mlp_grouped(x, ws, bs, activation)


@fused_mlp_grouped_op.register_fake
def _fused_mlp_grouped_fake(x, ws, bs, activation):
    groups, dims = grouped_dims(x, ws, bs)
    return x.new_empty((groups, x.shape[-2], dims[-1]))


fused_mlp_grouped_op.register_autograd(_recomputing_backward(plain_mlp_grouped), setup_context=_setup_context)


def _sets_first(t, dim):
    """t with its vmapped dim ``dim`` first and its last two dims
    contiguous (a copy only where they are not); t as it is when it is not
    vmapped (``dim`` None: shared by every set)."""
    if dim is None:
        return t
    t = t.movedim(dim, 0)
    return t if _rows_contiguous(t) else t.contiguous()


@fused_mlp_op.register_vmap
def _fused_mlp_vmap(info, in_dims, x, ws, bs, activation):
    """``torch.func.vmap`` of the chain. With one weight set for every
    vmapped call (only x vmapped), the vmapped axis folds into the rows of
    one ordinary call; with a weight or bias vmapped (a weight set a call),
    one grouped call takes every set, the unvmapped tensors shared."""
    x_dim, w_dims, b_dims, _ = in_dims
    if all(d is None for d in (*w_dims, *b_dims)):
        xs = x.movedim(x_dim, 0)
        out = fused_mlp(xs.reshape(-1, xs.shape[-1]), ws, bs, activation)
        return out.reshape(*xs.shape[:-1], out.shape[-1]), 0
    return fused_mlp_grouped(_sets_first(x, x_dim), [_sets_first(w, d) for w, d in zip(ws, w_dims)],
                             [_sets_first(b, d) for b, d in zip(bs, b_dims)], activation), 0


def _dispatch(op, cuda, plain, x, ws, bs, activation):
    """A forward that needs gradients, any forward that ``torch.export``
    traces and any forward under a ``torch.func`` transform (whose tensors
    have no storage to hand the kernel) goes through the registered
    operator ``op``; an eager forward without autograd (the rollout's and
    the player's) calls the same implementation directly, ``cuda`` on a
    CUDA tensor (on float32 copies of inputs of another floating dtype) and
    ``plain`` on a CPU one, and skips the operator's dispatch on the host."""
    transformed = torch._C._functorch.peek_interpreter_stack() is not None
    if torch.is_grad_enabled() or torch.compiler.is_exporting() or transformed:
        return op(x, list(ws), list(bs), str(activation))
    if x.is_cuda:
        return _in_float32(cuda, x, ws, bs, activation)
    if x.device.type == "cpu":
        return plain(x, ws, bs, activation)
    raise ValueError(f"no fused MLP for tensors on {x.device}")


def fused_mlp(x, ws, bs, activation):
    """The chain on the tensor's device: ``plain_mlp`` on the CPU, the CUDA
    kernel on a CUDA device (which raises rather than fall back; a floating
    dtype other than float32 goes through it as float32 and comes back in
    x's dtype). Under ``torch.func.vmap`` the operator's vmap rule makes one
    grouped call over a weight set a vmapped call."""
    return _dispatch(fused_mlp_op, fused_mlp_cuda, plain_mlp, x, ws, bs, activation)


def fused_mlp_grouped(x, ws, bs, activation):
    """The chain over G weight sets (shapes: ``grouped_dims``) on the
    tensors' device: ``plain_mlp_grouped`` on the CPU, one grouped launch of
    the CUDA kernel on a CUDA device."""
    return _dispatch(fused_mlp_grouped_op, fused_mlp_grouped_cuda, plain_mlp_grouped, x, ws, bs, activation)
