"""Generalized Advantage Estimation.

Port of rl_games_tpu/ops/gae.py. Semantics (the reference's
triton_kernels/gae_kernel.py:16-79, a2c_common.py:595-600):

    for t in reversed(range(T)):
        nextnonterminal = 1 - (dones[t+1] if t < T-1 else last_dones)
        nextvalues     = values[t+1] if t < T-1 else last_values
        delta  = rewards[t] + gamma * nextvalues * nextnonterminal - values[t]
        adv[t] = lastgaelam = delta + gamma * lam * nextnonterminal * lastgaelam

Shapes: rewards, values [T, N, V]; dones [T, N] (dones entering step t);
last_values [N, V]; last_dones [N]. Returns advantages [T, N, V].

``compute_gae`` dispatches on the tensors' device only: a CPU tensor takes
``gae_plain`` (a reverse loop equal to the JAX ``gae_scan``), a CUDA tensor
takes the hand-written kernel ``csrc/gae.cu`` through ``gae_cuda``, which
raises on any input it does not take. There is no fallback between the two.
"""

import ctypes

import torch

from rl_games_tpu_torch.utils import cuda_build

# Launches of the CUDA kernel in this process; ``gae_cuda`` adds one per
# launch and nothing else touches it except a caller resetting it.
gae_launches = 0

_gae_forward = None
_gae_empty_launch = None


def _shifted_next(values, dones, last_values, last_dones):
    """next_values[t] = values[t+1] (last row: last_values); same for dones."""
    next_values = torch.cat([values[1:], last_values[None]], dim=0)
    next_dones = torch.cat([dones[1:], last_dones[None].to(dones.dtype)], dim=0)
    next_nonterminal = 1.0 - next_dones.to(values.dtype)
    return next_values, next_nonterminal


def gae_plain(rewards, values, dones, last_values, last_dones, gamma, lam):
    """Reverse-loop GAE in plain PyTorch, the arithmetic of ``gae_scan``."""
    next_values, next_nonterminal = _shifted_next(values, dones, last_values, last_dones)
    nnt = next_nonterminal[..., None]  # [T, N, 1] broadcasts over V
    deltas = rewards + gamma * next_values * nnt - values
    advs = torch.empty_like(deltas)
    lastgaelam = torch.zeros_like(last_values)
    for t in reversed(range(rewards.shape[0])):
        lastgaelam = deltas[t] + gamma * lam * nnt[t] * lastgaelam
        advs[t] = lastgaelam
    return advs


def _kernel():
    global _gae_forward
    if _gae_forward is None:
        fn = cuda_build.load("gae").gae_forward
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _gae_forward = fn
    return _gae_forward


def gae_cuda(rewards, values, dones, last_values, last_dones, gamma, lam):
    """GAE through the CUDA kernel; raises on anything it does not take."""
    global gae_launches
    args = (rewards, values, dones, last_values, last_dones)
    if rewards.dim() != 3:
        raise ValueError(f"rewards must be [T, N, V], got {tuple(rewards.shape)}")
    T, N, V = rewards.shape
    expected = ((T, N, V), (T, N, V), (T, N), (N, V), (N,))
    names = ("rewards", "values", "dones", "last_values", "last_dones")
    for name, x, shape in zip(names, args, expected):
        if not x.is_cuda or x.device != rewards.device:
            raise ValueError(f"{name} must lie on {rewards.device}, got {x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    adv = torch.empty_like(rewards)
    with torch.cuda.device(rewards.device):
        stream = torch.cuda.current_stream(rewards.device).cuda_stream
        err = _kernel()(
            *(x.data_ptr() for x in args), adv.data_ptr(),
            T, N, V, float(gamma), float(lam), stream,
        )
    if err != 0:
        raise RuntimeError(f"gae_forward launch failed with CUDA error {err}")
    gae_launches += 1
    return adv


def launch_floor_cuda(num_envs: int, value_size: int, device="cuda"):
    """Launches ``csrc/gae.cu``'s empty kernel over the grid that ``gae_cuda``
    takes for ``num_envs * value_size`` columns. Timing it gives the floor
    that launch latency sets under the GAE kernel's own time; nothing is
    computed and ``gae_launches`` does not move."""
    global _gae_empty_launch
    if _gae_empty_launch is None:
        fn = cuda_build.load("gae").gae_empty_launch
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _gae_empty_launch = fn
    device = torch.device(device)
    with torch.cuda.device(device):
        err = _gae_empty_launch(num_envs, value_size, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gae_empty_launch failed with CUDA error {err}")


def compute_gae(rewards, values, dones, last_values, last_dones, gamma, lam):
    """GAE on the tensors' device: the plain loop on the CPU, the CUDA kernel
    on a CUDA device (which raises rather than fall back)."""
    if rewards.is_cuda:
        return gae_cuda(rewards, values, dones, last_values, last_dones, gamma, lam)
    if rewards.device.type == "cpu":
        return gae_plain(rewards, values, dones, last_values, last_dones, gamma, lam)
    raise ValueError(f"no GAE for tensors on {rewards.device}")


def discounted_returns(rewards, dones, last_values, last_dones, gamma):
    """Plain discounted return R_t = r_t + gamma * (1 - done_{t+1}) * R_{t+1},
    bootstrapped from last_values: GAE with zero values and lam = 1."""
    zeros = torch.zeros_like(rewards)
    return compute_gae(rewards, zeros, dones, last_values, last_dones, gamma, 1.0)
