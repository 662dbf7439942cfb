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
``plain_mlp`` (the plain PyTorch chain), a CUDA tensor takes the
hand-written kernel ``csrc/fused_mlp.cu`` through ``fused_mlp_cuda``, which
raises on any input it does not take. There is no fallback between the two
and no switch that turns the kernel off. Gradients are exact: the backward
recomputes through ``plain_mlp``, as the JAX package's custom VJP does, so
the kernel is the forward (rollout, player, loss forward) path.
"""

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from rl_games_tpu_torch.utils import cuda_build

# Launches of the CUDA kernel in this process; ``fused_mlp_cuda`` adds one per
# launch and nothing else touches it except a caller resetting it.
fused_mlp_launches = 0

# The kernel's limits.
MAX_LAYERS = 8  # layer pointers travel in the kernel's argument block
MAX_SHARED_BYTES = 232_448  # shared memory one block may use on sm_90
# Rows of x per block that the kernel is built for, with the smallest batch
# at which each is taken: 32 rows once 16-row tiles would no longer all be
# resident at once (two blocks on each of the card's 132 SMs). The smaller
# tile halves each warp's register tile, so it pays more shared-memory loads
# and operand splits per tensor-core product and serves small batches only.
TILE_ROWS = {32: 132 * 2 * 16, 16: 0}
# the ring of staged weight tiles (csrc/fused_mlp.cu: kStages * TN * WS)
_WEIGHT_RING_FLOATS = 3 * 128 * 40

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


def kernel_plan(dims: Sequence[int], batch: int) -> Tuple[int, int, int, int]:
    """(rows per block, stride of the even-width buffer, stride of the
    odd-width buffer, shared bytes) for a chain of widths ``dims``.

    Layer i reads widths[i] from one buffer and writes widths[i + 1] to the
    other; the last layer writes to device memory. Takes the largest tile
    that fits a block's shared memory and whose minimum batch (TILE_ROWS)
    is reached, else the smallest that fits. Raises ValueError beyond the
    kernel's limits."""
    n_layers = len(dims) - 1
    if not 1 <= n_layers <= MAX_LAYERS:
        raise ValueError(f"fused_mlp takes 1 to {MAX_LAYERS} layers, got {n_layers}")
    inner = list(dims[:-1])
    stride0, stride1 = _buffer_stride(inner[0::2]), _buffer_stride(inner[1::2])

    def shared_bytes(rows):
        return 4 * (rows * (stride0 + stride1) + _WEIGHT_RING_FLOATS)

    fitting = [rows for rows in TILE_ROWS if shared_bytes(rows) <= MAX_SHARED_BYTES]
    if not fitting:
        raise ValueError(
            f"fused_mlp: widths {list(dims)} need {shared_bytes(min(TILE_ROWS))} bytes of shared "
            f"memory at the smallest tile ({min(TILE_ROWS)} rows), above the block limit of "
            f"{MAX_SHARED_BYTES}"
        )
    rows = next((r for r in fitting if batch >= TILE_ROWS[r]), fitting[-1])
    return rows, stride0, stride1, shared_bytes(rows)


def _kernel():
    global _forward
    if _forward is None:
        fn = cuda_build.load("fused_mlp").fused_mlp_forward
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ]
        fn.restype = ctypes.c_int
        _forward = fn
    return _forward


def fused_mlp_cuda(x, ws, bs, activation):
    """The chain through the CUDA kernel; raises on anything it does not
    take."""
    global fused_mlp_launches
    act = _activation_code(activation)
    ws, bs = tuple(ws), tuple(bs)
    if len(ws) != len(bs):
        raise ValueError(f"{len(ws)} weights but {len(bs)} biases")
    if x.dim() != 2:
        raise ValueError(f"x must be [B, D], got {tuple(x.shape)}")
    if not x.is_cuda:
        raise ValueError(f"x must lie on a CUDA device, got {x.device}")
    dims = [x.shape[1]]
    for i, (w, b) in enumerate(zip(ws, bs)):
        if w.dim() != 2 or w.shape[1] != dims[-1]:
            raise ValueError(f"ws[{i}] must be [out, {dims[-1]}], got {tuple(w.shape)}")
        if tuple(b.shape) != (w.shape[0],):
            raise ValueError(f"bs[{i}] must be [{w.shape[0]}], got {tuple(b.shape)}")
        dims.append(w.shape[0])
    if min(dims) < 1:
        raise ValueError(f"every width must be at least 1, got {dims}")
    names = ["x"] + [f"ws[{i}]" for i in range(len(ws))] + [f"bs[{i}]" for i in range(len(bs))]
    for name, t in zip(names, (x, *ws, *bs)):
        if t.device != x.device:
            raise ValueError(f"{name} must lie on {x.device}, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    batch = x.shape[0]
    rows, stride0, stride1, shared = kernel_plan(dims, batch)
    out = torch.empty((batch, dims[-1]), dtype=torch.float32, device=x.device)
    if batch == 0:
        return out
    n = len(ws)
    c_dims = (ctypes.c_int * (n + 1))(*dims)
    c_ws = (ctypes.c_void_p * n)(*(w.data_ptr() for w in ws))
    c_bs = (ctypes.c_void_p * n)(*(b.data_ptr() for b in bs))
    attr_err = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel()(
            x.data_ptr(), out.data_ptr(), batch, n,
            ctypes.cast(c_dims, ctypes.c_void_p), ctypes.cast(c_ws, ctypes.c_void_p),
            ctypes.cast(c_bs, ctypes.c_void_p),
            act, rows, stride0, stride1, stream, ctypes.byref(attr_err),
        )
    if attr_err.value != 0:
        raise RuntimeError(f"fused_mlp_forward: cudaFuncSetAttribute({shared} bytes of dynamic "
                           f"shared memory) failed with CUDA error {attr_err.value}")
    if err != 0:
        raise RuntimeError(f"fused_mlp_forward launch failed with CUDA error {err}")
    fused_mlp_launches += 1
    return out


class _FusedMLP(torch.autograd.Function):
    """forward: the kernel (CUDA) or the plain chain (CPU); backward: exact
    gradients through a recomputed plain chain."""

    @staticmethod
    def forward(ctx, activation, x, *params):
        n = len(params) // 2
        ctx.activation = activation
        ctx.save_for_backward(x, *params)
        return _chain(x, params[:n], params[n:], activation)

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        wanted = [i for i, need in enumerate(ctx.needs_input_grad[1:]) if need]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(i in wanted) for i, t in enumerate(saved)]
            n = (len(leaves) - 1) // 2
            y = plain_mlp(leaves[0], leaves[1:1 + n], leaves[1 + n:], ctx.activation)
            grads = torch.autograd.grad(y, [leaves[i] for i in wanted], grad_out)
        full = [None] * len(saved)
        for i, g in zip(wanted, grads):
            full[i] = g
        return (None, *full)


def _chain(x, ws, bs, activation):
    if x.is_cuda:
        return fused_mlp_cuda(x, ws, bs, activation)
    if x.device.type == "cpu":
        return plain_mlp(x, ws, bs, activation)
    raise ValueError(f"no fused MLP for tensors on {x.device}")


def fused_mlp(x, ws, bs, activation):
    """The chain on the tensor's device: ``plain_mlp`` on the CPU, the CUDA
    kernel on a CUDA device (which raises rather than fall back). Without
    autograd (the rollout's and the player's forwards) it skips the
    autograd.Function and the host time of its bookkeeping."""
    if not torch.is_grad_enabled():
        return _chain(x, ws, bs, activation)
    return _FusedMLP.apply(activation, x, *ws, *bs)
