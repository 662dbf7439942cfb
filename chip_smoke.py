"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py              # the check: build, compare, train, play, report
    python3 chip_smoke.py --profile    # the same, plus a torch.profiler epoch and a
                                       # count of the profiler sessions that lose events

Phases, each of which raises on failure (nothing falls back to the CPU or
to a plain version):

1. device    — a CUDA card must be present; prints its name and power limit.
2. build     — compiles every CUDA source with nvcc, all at once.
3. kernels   — each kernel against its plain PyTorch version on the card, at
               the main paths' shapes and ragged ones (the fused MLP over all
               nine activations, with inputs and weights beyond the init
               scale, and its gradients); device time per call
               (torch.profiler) and time per call between CUDA events, with
               the least time the card could take on the unit the kernel uses
               beside them, and for GAE the time of an empty kernel over the
               same grid (what a launch alone costs).
4. reference — the CUDA path of the port against its CPU path on a small
               input (one Ant2D step, one PPO update from one trajectory,
               the fused model's forward).
5. envs      — every other physics env (Ant3D, Humanoid3D, Walker2D,
               Cheetah2D, Arm2D, Grasp2D): one control step on the card
               against the same step on the CPU; then, with Ant2D beside
               them, the wall time of one vec-env step at 4096 envs and of
               the kinematics with J and J̇q̇ alone, with the device kernels
               each launches.
6. trainer   — the flagship workload at full width: continuous PPO on 8192
               Ant2D envs, MLP [256, 128, 64], horizon 16, 4 mini-epochs of
               4 minibatches of 32768, through PPOAgent.train_epoch.
7. runner    — the same workload with network.mlp.fused: true through the
               normal entry points: Runner.run({"train": True}) writes
               checkpoints, Runner.run({"play": True, "checkpoint": ...})
               plays the last one back on 8192 envs.
8. humanoid3d — rl_games_tpu/configs/ppo_humanoid3d.yaml at full width
               (4096 envs, horizon 16, minibatch 32768, 4 mini-epochs, MLP
               [256, 128, 64]) with network.mlp.fused: true,
               use_diagnostics: true and a DefaultAlgoObserver, trained
               through Runner.run and its last checkpoint played back.
9. ant3d     — rl_games_tpu/configs/ppo_ant3d.yaml at full width, plain MLP,
               through PPOAgent.train_epoch.

Launch counts are zeroed just before each of phases 6-9's runs and read
just after, and are held to the counts the code implies.

Prints a {"kernels": [...]} line, then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import argparse
import collections
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12  # H100 SXM tensor cores, TF32 operands, dense


def flagship_params(num_actors: int) -> dict:
    """The flagship continuous PPO config: the JAX package's
    __graft_entry__._flagship_params(num_actors) with bench.py's overrides
    (Ant2D, minibatch = batch / 4, 4 mini-epochs)."""
    return {
        "algo": {"name": "a2c_continuous"},
        "model": {"name": "continuous_a2c_logstd"},
        "network": {
            "name": "actor_critic",
            "separate": False,
            "mlp": {"units": [256, 128, 64], "activation": "elu",
                    "initializer": {"name": "default"}},
            "space": {"continuous": {
                "mu_activation": "None", "sigma_activation": "None",
                "mu_init": {"name": "default"},
                "sigma_init": {"name": "const_initializer", "val": 0.0},
                "fixed_sigma": True,
            }},
        },
        "config": {
            "env_name": "Ant2D", "num_actors": num_actors, "horizon_length": 16,
            "minibatch_size": num_actors * 16 // 4, "mini_epochs": 4,
            "learning_rate": 3e-4, "lr_schedule": "adaptive", "kl_threshold": 0.008,
            "e_clip": 0.2, "clip_value": True, "gamma": 0.99, "tau": 0.95,
            "critic_coef": 2.0, "entropy_coef": 0.0, "grad_norm": 1.0,
            "truncate_grads": True, "normalize_advantage": True,
            "normalize_input": True, "normalize_value": True,
            "bounds_loss_coef": 0.0001, "value_bootstrap": True, "seed": 7,
        },
    }


def cuda_time_ms(fn, reps: int) -> float:
    """Mean time per call of fn() between CUDA events over reps calls, after
    a warm-up. Where the host enqueues more slowly than the card runs, this
    is the host's rate, not the card's."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_events(fn, reps: int):
    """The device events of one torch.profiler session over reps calls of fn()."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def device_time_ms(fn, reps: int):
    """(mean device time of the kernels fn() launches, kernels per call),
    from torch.profiler's CUDA activity: the card's own time, without the
    host's gaps between launches. About one session in a hundred comes back
    with some or all of its device events missing, two or three sessions in
    a row (phase_profiler_sessions counts them), and would read too low. So
    a session counts only if it holds the same number of events for every
    call; any other is announced and taken again, five times at most. (Not
    for use after phase_profile: see phase_profiler_sessions.)"""
    fn()
    torch.cuda.synchronize()
    for attempt in range(5):
        kernels = device_events(fn, reps)
        if kernels and len(kernels) % reps == 0:
            total_us = sum(e.time_range.elapsed_us() for e in kernels)
            return total_us / reps / 1e3, len(kernels) // reps
        print(f"[kernels] torch.profiler kept {len(kernels)} device events of {reps} calls "
              f"(attempt {attempt + 1}), profiling again")
    raise AssertionError("torch.profiler lost device events in five sessions in a row")


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {smi}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}, {torch.cuda.device_count()} card(s)")
    return smi


def phase_build():
    from rl_games_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    logs = cuda_build.build_all()  # one nvcc per source, started together
    print(f"[build] {len(logs)} sources ({', '.join(logs)}) in {time.perf_counter() - t0:.2f} s, built at once")
    for name, log in logs.items():
        print(f"[build] {name}: {'compiled now' if log is not None else 'library was current'}, "
              f"flags {' '.join(cuda_build.nvcc_flags(name))}")
        for line in (log or "").splitlines():
            # "N bytes stack frame, N bytes spill stores, N bytes spill loads" has no prefix
            if "spill" in line or ("ptxas info" in line and any(w in line for w in ("registers", "smem", "Compiling"))):
                print(f"[build] {name}: {line.strip()}")
    if sorted(logs) != ["fused_mlp", "gae"]:
        raise AssertionError(f"expected the sources fused_mlp and gae, built {sorted(logs)}")


def gae_inputs(T, N, V, gen, device):
    f32 = dict(dtype=torch.float32, device=device)
    r = torch.randn((T, N, V), generator=gen, **f32)
    v = torch.randn((T, N, V), generator=gen, **f32)
    d = (torch.rand((T, N), generator=gen, **f32) < 0.05).to(torch.float32)
    lv = torch.randn((N, V), generator=gen, **f32)
    ld = (torch.rand((N,), generator=gen, **f32) < 0.05).to(torch.float32)
    ld[::7] = 1.0  # make sure some last dones are set
    return r, v, d, lv, ld


def bound_ms(nbytes: int, flops: int, peak_flops: float = PEAK_F32_FLOPS):
    """(least time the card could take in ms, what bounds it): ``nbytes``
    over the memory rate against ``flops`` over the peak of the unit that
    does them."""
    bound = {"bytes": nbytes / PEAK_BYTES_PER_S * 1e3, "operations": flops / peak_flops * 1e3}
    by = max(bound, key=bound.get)
    return bound[by], by


def time_gae(T, N, V, gen, dev):
    """Device time of the GAE kernel, of the plain chain and of an empty
    kernel over the kernel's grid at one shape, beside the bound."""
    from rl_games_tpu_torch.ops import gae

    args = gae_inputs(T, N, V, gen, dev)
    kernel, plain = (lambda: gae.gae_cuda(*args, 0.99, 0.95)), (lambda: gae.gae_plain(*args, 0.99, 0.95))
    kernel_ms, kernel_n = device_time_ms(kernel, 100)
    plain_ms, plain_n = device_time_ms(plain, 20)
    kernel_call_ms, plain_call_ms = cuda_time_ms(kernel, 200), cuda_time_ms(plain, 20)
    # what a launch alone costs: the source's empty kernel over the same grid
    floor_ms, _ = device_time_ms(lambda: gae.launch_floor_cuda(N, V), 100)
    nbytes = 4 * (3 * T * N * V + T * N + N * V + N)
    flops = 8 * T * N * V
    bound, bound_by = bound_ms(nbytes, flops)
    print(f"[kernels] gae [{T},{N},{V}] device time: kernel {kernel_ms * 1e3:.2f} us ({kernel_n:.0f} kernel/call), "
          f"empty kernel of the same grid {floor_ms * 1e3:.2f} us, "
          f"plain {plain_ms * 1e3:.2f} us ({plain_n:.0f} kernels/call); "
          f"bound {bound * 1e3:.3f} us ({nbytes} B, by {bound_by}); kernel at {bound / kernel_ms:.3f} of the bound's rate")
    print(f"[kernels] gae [{T},{N},{V}] per call between CUDA events, host included: "
          f"kernel {kernel_call_ms * 1e3:.2f} us, plain {plain_call_ms * 1e3:.2f} us")
    return {"shape": [T, N, V], "ms": kernel_ms, "plain_ms": plain_ms, "call_ms": kernel_call_ms,
            "plain_call_ms": plain_call_ms, "bound_ms": bound, "bound_by": bound_by,
            "share_of_bound": bound / kernel_ms, "launch_floor_ms": floor_ms}


def phase_kernel_gae():
    from rl_games_tpu_torch.ops import gae

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    # the main paths' shapes (the flagship's, the 3D configs'), then horizons
    # that take every branch of the kernel's sweep: one chunk of 16; the
    # row-by-row tail alone; 16 + 8 + 5
    for T, N, V in ((16, 8192, 1), (16, 4096, 1), (16, 1000, 2), (7, 33, 3), (29, 777, 2)):
        args = gae_inputs(T, N, V, gen, dev)
        got = gae.gae_cuda(*args, 0.99, 0.95)
        want = gae.gae_plain(*args, 0.99, 0.95)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        print(f"[kernels] gae [{T},{N},{V}] max |kernel - plain| = {err:.3e}")
        if err != 0.0:  # same products and sums in the same order: bit for bit
            raise AssertionError(f"gae kernel disagrees with gae_plain at [{T},{N},{V}]: {err}")
        worst = max(worst, err)

    flagship = time_gae(16, 8192, 1, gen, dev)
    return {
        "name": "gae",
        "route": "cuda",
        "source": "rl_games_tpu_torch/csrc/gae.cu",
        "replaces": "rl_games_tpu/ops/gae.py:97 (_gae_pallas_kernel, pallas_call at :159)",
        **flagship,
        "max_abs_err": worst,
        "kernel_ms": flagship["ms"],
        "unit": f"device memory at {PEAK_BYTES_PER_S:.3g} B/s",
        "library_ms": None,
        "library_note": "no single PyTorch call computes GAE",
        # the 3D configs' shape (4096 envs)
        "other_shapes": [time_gae(16, 4096, 1, gen, dev)],
    }


ACTIVATIONS = ("relu", "elu", "selu", "softplus", "gelu", "sigmoid", "swish", "tanh", "None")
FLAGSHIP_DIMS = (26, 256, 128, 64)
ANT3D_DIMS = (33, 256, 128, 64)  # ppo_ant3d.yaml: obs 33
HUMANOID3D_DIMS = (41, 256, 128, 64)  # ppo_humanoid3d.yaml: obs 41


def mlp_inputs(dims, batch, gen, device):
    """x ~ N(0, 1); weights [out, in] ~ U(+-1/sqrt(in)), as the model's
    default init draws them, so activations stay of order 1 and an absolute
    tolerance of 2e-5 is a float32 statement; biases ~ 0.1 N(0, 1)."""
    f32 = dict(dtype=torch.float32, device=device)
    ws = [(torch.rand((dims[i + 1], dims[i]), generator=gen, **f32) * 2 - 1) / math.sqrt(dims[i])
          for i in range(len(dims) - 1)]
    bs = [torch.randn((dims[i + 1],), generator=gen, **f32) * 0.1 for i in range(len(dims) - 1)]
    return torch.randn((batch, dims[0]), generator=gen, **f32), ws, bs


def time_fused(dims, batch, gen, dev):
    """Device time of the fused kernel and of the plain chain at one shape,
    in turns (plain, kernel, kernel, plain), beside the 3xTF32 bound."""
    from rl_games_tpu_torch.ops import fused_mlp as fm

    x, ws, bs = mlp_inputs(dims, batch, gen, dev)
    kernel, plain = (lambda: fm.fused_mlp_cuda(x, ws, bs, "elu")), (lambda: fm.plain_mlp(x, ws, bs, "elu"))
    plain_a, plain_n = device_time_ms(plain, 50)
    kernel_a, _ = device_time_ms(kernel, 50)
    kernel_b, _ = device_time_ms(kernel, 50)
    plain_b, _ = device_time_ms(plain, 50)
    kernel_ms, plain_ms = (kernel_a + kernel_b) / 2, (plain_a + plain_b) / 2
    n_weights = sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))
    flops = 3 * 2 * batch * n_weights
    nbytes = 4 * (x.numel() + batch * dims[-1] + n_weights + sum(dims[1:]))
    bound, bound_by = bound_ms(nbytes, flops, PEAK_TF32_FLOPS)
    rows = fm.kernel_plan(dims, batch)
    print(f"[kernels] fused_mlp {'x'.join(map(str, dims))} B={batch} ({rows[0]} rows/block) device time: "
          f"kernel {kernel_ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us ({plain_n:.0f} kernels/call); "
          f"bound {bound * 1e3:.2f} us ({flops} TF32 flop, {nbytes} B, by {bound_by}); "
          f"kernel at {bound / kernel_ms:.3f} of the bound's rate")
    return {"shape": [batch, *dims], "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "share_of_bound": bound / kernel_ms}


def phase_kernel_fused_mlp():
    from rl_games_tpu_torch.ops import fused_mlp as fm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    # the shape sets of the JAX package's kernel test, then the flagship
    # torso at the rollout's and the minibatch's batch size
    # (the next two beyond the init scale: inputs 30 times, weights 8 times
    # as large), then a batch that takes the 32-row blocks and ends inside one
    shapes = [((37, 50, 33, 7), 19, 1.0, 1.0), (FLAGSHIP_DIMS, 512, 1.0, 1.0), ((4, 8), 1, 1.0, 1.0),
              ((130, 257), 1030, 1.0, 1.0), (FLAGSHIP_DIMS, 8192, 1.0, 1.0), (FLAGSHIP_DIMS, 32768, 1.0, 1.0),
              (FLAGSHIP_DIMS, 512, 30.0, 1.0), ((130, 257), 1030, 1.0, 8.0), (FLAGSHIP_DIMS, 5001, 1.0, 1.0)]
    # the 3D configs' torsos at the rollout's and the minibatch's batch size
    shapes += [(dims, batch, 1.0, 1.0) for dims in (ANT3D_DIMS, HUMANOID3D_DIMS) for batch in (4096, 32768)]
    if fm.kernel_plan(FLAGSHIP_DIMS, 5001)[0] != 32:
        raise AssertionError("B = 5001 was chosen to take the 32-row blocks with a ragged last block")
    worst, worst_ratio = 0.0, 0.0
    for i, (dims, batch, x_scale, w_scale) in enumerate(shapes):
        x, ws, bs = mlp_inputs(dims, batch, gen, dev)
        x, ws = x * x_scale, [w * w_scale for w in ws]
        for activation in (ACTIVATIONS if i == 0 else ("elu",)):
            got = fm.fused_mlp_cuda(x, ws, bs, activation)
            want = fm.plain_mlp(x, ws, bs, activation)
            torch.cuda.synchronize()
            diff = (got - want).abs()
            err = float(diff.max())
            ratio = float((diff / (2e-5 + 2e-5 * want.abs())).max())  # <= 1: rtol = atol = 2e-5
            scale = "" if x_scale == w_scale == 1.0 else f" (x * {x_scale:g}, weights * {w_scale:g})"
            print(f"[kernels] fused_mlp {'x'.join(map(str, dims))} B={batch} {activation}{scale}: "
                  f"max |kernel - plain| = {err:.3e} ({ratio:.3f} of the tolerance)")
            if not (math.isfinite(ratio) and ratio <= 1.0):
                raise AssertionError(f"fused_mlp kernel disagrees with plain_mlp at {dims}, B={batch}, "
                                     f"{activation}: max abs {err}, {ratio} of rtol = atol = 2e-5")
            worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)

    # gradients: fused_mlp (kernel forward, plain-chain backward) against
    # autograd through plain_mlp, rtol 1e-5 / atol 1e-6
    x, ws, bs = mlp_inputs((9, 24, 5), 17, gen, dev)
    leaves = [t.requires_grad_(True) for t in (x, *ws, *bs)]
    g_fused = torch.autograd.grad((fm.fused_mlp(leaves[0], leaves[1:3], leaves[3:], "elu") ** 2).sum(), leaves)
    g_plain = torch.autograd.grad((fm.plain_mlp(leaves[0], leaves[1:3], leaves[3:], "elu") ** 2).sum(), leaves)
    for a, b in zip(g_fused, g_plain):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    print(f"[kernels] fused_mlp gradients agree with autograd through plain_mlp (rtol 1e-5, atol 1e-6), "
          f"max abs diff {max(float((a - b).abs().max()) for a, b in zip(g_fused, g_plain)):.3e}")

    # refusals: a CUDA tensor the kernel does not take raises, nothing falls back
    x, ws, bs = mlp_inputs((8, 8), 4, gen, dev)
    wide = torch.cat([x, x], dim=1)
    for bad, exc in ((wide[:, ::2], ValueError), (x.double(), TypeError)):
        try:
            fm.fused_mlp_cuda(bad, ws, bs, "elu")
        except exc:
            continue
        raise AssertionError("fused_mlp_cuda took an input it must refuse")

    entry = {
        "name": "fused_mlp",
        "route": "cuda",
        "source": "rl_games_tpu_torch/csrc/fused_mlp.cu",
        "replaces": "rl_games_tpu/ops/fused_mlp.py:112 (_fused_kernel, pallas_call at :170)",
        "max_abs_err": worst,
        "max_err_over_tolerance": worst_ratio,
        "unit": f"tensor cores at {PEAK_TF32_FLOPS:.3g} flop/s with TF32 operands, "
                "three products per multiply-add (3xTF32)",
        "library_ms": None,
        "library_note": "no single PyTorch call computes the chain; plain_ms is addmm + activation per layer",
    }
    entry["other_shapes"] = [time_fused(dims, batch, gen, dev)
                             for dims in (ANT3D_DIMS, HUMANOID3D_DIMS) for batch in (4096, 32768)]
    n_weights = sum(FLAGSHIP_DIMS[i] * FLAGSHIP_DIMS[i + 1] for i in range(3))
    for batch, suffix in ((8192, ""), (32768, "_minibatch")):
        x, ws, bs = mlp_inputs(FLAGSHIP_DIMS, batch, gen, dev)
        kernel, plain = (lambda: fm.fused_mlp_cuda(x, ws, bs, "elu")), (lambda: fm.plain_mlp(x, ws, bs, "elu"))
        # in turns: plain, kernel, kernel, plain
        plain_a, plain_n = device_time_ms(plain, 50)
        kernel_a, kernel_n = device_time_ms(kernel, 50)
        kernel_b, _ = device_time_ms(kernel, 50)
        plain_b, _ = device_time_ms(plain, 50)
        kernel_ms, plain_ms = (kernel_a + kernel_b) / 2, (plain_a + plain_b) / 2
        kernel_call_ms, plain_call_ms = cuda_time_ms(kernel, 200), cuda_time_ms(plain, 200)
        # the same launch without an activation: what the products, copies and
        # stores take, and so what elu (expm1f) costs on top
        linear_ms, _ = device_time_ms(lambda: fm.fused_mlp_cuda(x, ws, bs, "None"), 50)
        # the kernel makes every product three times on the tensor cores
        # (3xTF32), so its bound is three times the chain's operations over
        # the TF32 rate
        flops = 3 * 2 * batch * n_weights
        nbytes = 4 * (x.numel() + batch * FLAGSHIP_DIMS[-1] + n_weights + sum(FLAGSHIP_DIMS[1:]))
        bound, bound_by = bound_ms(nbytes, flops, PEAK_TF32_FLOPS)
        rows = fm.kernel_plan(FLAGSHIP_DIMS, batch)
        print(f"[kernels] fused_mlp 26x256x128x64 B={batch} ({rows[0]} rows/block, {rows[3]} B shared) device time: "
              f"kernel {kernel_ms * 1e3:.2f} us ({kernel_n:.0f} kernel/call), "
              f"plain {plain_ms * 1e3:.2f} us ({plain_n:.0f} kernels/call); bound {bound * 1e3:.2f} us "
              f"({flops} TF32 flop = 3 x the chain's, {nbytes} B, by {bound_by}); "
              f"kernel at {bound / kernel_ms:.3f} of the bound's rate")
        print(f"[kernels] fused_mlp B={batch} device time with activation None: {linear_ms * 1e3:.2f} us "
              f"(elu adds {(kernel_ms - linear_ms) * 1e3:.2f} us)")
        print(f"[kernels] fused_mlp B={batch} per call between CUDA events, host included: "
              f"kernel {kernel_call_ms * 1e3:.2f} us, plain {plain_call_ms * 1e3:.2f} us")
        entry.update({
            f"shape{suffix}": [batch, *FLAGSHIP_DIMS],
            f"ms{suffix}": kernel_ms, f"kernel_ms{suffix}": kernel_ms, f"plain_ms{suffix}": plain_ms,
            f"call_ms{suffix}": kernel_call_ms, f"plain_call_ms{suffix}": plain_call_ms,
            f"bound_ms{suffix}": bound, f"bound_by{suffix}": bound_by,
            f"share_of_bound{suffix}": bound / kernel_ms,
            f"no_activation_ms{suffix}": linear_ms,
        })
    return entry


def phase_reference():
    """The CUDA path against the port's CPU path (itself held against the
    JAX package by tests/test_torch_*.py) on a small input."""
    from rl_games_tpu_torch.algos.ppo import PPOAgent
    from rl_games_tpu_torch.envs.device.ant2d import Ant2D, Ant2DState

    # one Ant2D control step from the same states
    cpu_env, gpu_env = Ant2D("cpu"), Ant2D("cuda")
    state, _ = cpu_env.reset(64, torch.Generator().manual_seed(1))
    state.qd += 0.5 * torch.randn(state.qd.shape, generator=torch.Generator().manual_seed(2))
    actions = torch.rand((64, 8), generator=torch.Generator().manual_seed(3)) * 2.6 - 1.3
    want = cpu_env.step(state, actions)
    gpu_state = Ant2DState(*(x.cuda() for x in (state.q, state.qd, state.last_x)))
    got = gpu_env.step(gpu_state, actions.cuda())
    dq = float((got[0].q.cpu() - want[0].q).abs().max())
    dobs = float((got[1].cpu() - want[1]).abs().max())
    print(f"[reference] Ant2D step cuda vs cpu: max |dq| {dq:.2e}, max |dobs| {dobs:.2e}")
    if not (dq < 1e-4 and dobs < 1e-3):
        raise AssertionError("Ant2D step on the card disagrees with the CPU step")

    # one PPO update from one trajectory, same weights on both devices
    params = flagship_params(16)
    params["network"]["mlp"]["units"] = [32, 16]
    params["config"]["minibatch_size"] = 64
    gpu, cpu = PPOAgent("ref", params, device="cuda"), PPOAgent("ref", params, device="cpu")
    gstate, cstate = gpu.init_state(), cpu.init_state()
    cpu.model.load_state_dict({k: v.cpu() for k, v in gpu.model.state_dict().items()})
    traj, last_values = gpu._rollout(gstate)
    cstate.dones = gstate.dones.cpu()
    gstate, gm = gpu._finish_epoch(gstate, traj, last_values)
    cstate, cm = cpu._finish_epoch(cstate, {k: v.cpu() for k, v in traj.items()}, last_values.cpu())
    csd = cpu.model.state_dict()
    dp = max(float((v.cpu().double() - csd[k].double()).abs().max()) for k, v in gpu.model.state_dict().items())
    dl = abs(float(gm["c_loss"]) - float(cm["c_loss"])) / max(abs(float(cm["c_loss"])), 1e-6)
    print(f"[reference] PPO update cuda vs cpu: max |dparam| {dp:.2e}, c_loss rel diff {dl:.2e}")
    if not (dp < 1e-5 and dl < 1e-4):
        raise AssertionError("PPO update on the card disagrees with the CPU update")

    # the fused model's forward (the kernel) against the same weights on the
    # CPU (the plain chain), at the flagship widths
    params = flagship_params(16)
    params["network"]["mlp"]["fused"] = True
    gpu, cpu = PPOAgent("ref", params, device="cuda"), PPOAgent("ref", params, device="cpu")
    gpu.init_state()
    cpu.model.load_state_dict({k: v.cpu() for k, v in gpu.model.state_dict().items()})
    obs = torch.randn((300, 26), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        got = gpu.model.forward_play(obs.cuda(), deterministic=True)
        want = cpu.model.forward_play(obs, deterministic=True)
    diffs = {k: float((got[k].cpu() - want[k]).abs().max()) for k in ("actions", "values", "neglogpacs")}
    print(f"[reference] fused model forward cuda vs cpu: " + ", ".join(f"max |d{k}| {v:.2e}" for k, v in diffs.items()))
    if not all(v < 2e-5 for v in diffs.values()):
        raise AssertionError("the fused model's forward on the card disagrees with the CPU forward")


ENV_NAMES = ("Ant3D", "Humanoid3D", "Walker2D", "Cheetah2D", "Arm2D", "Grasp2D")


def state_to(state, device):
    """An env state dataclass with every tensor moved to ``device``."""
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).to(device) for f in dataclasses.fields(state)
    })


def phase_envs():
    """Each env's step on the card against its step on the CPU (itself held
    against the JAX package by tests/test_torch_port_envs{2d,3d}.py); then
    the wall time and device kernels of a step at 4096 envs."""
    from rl_games_tpu_torch.envs import registry

    for name in ENV_NAMES:
        create = registry.ENV_CONFIGURATIONS[name]["env_creator"]
        cpu_env, gpu_env = create(device="cpu"), create(device="cuda")
        n = 64
        state, _ = cpu_env.reset(n, torch.Generator().manual_seed(1))
        state.qd += 0.5 * torch.randn(state.qd.shape, generator=torch.Generator().manual_seed(2))
        width = cpu_env.env_info().action_space.shape[0]
        actions = torch.rand((n, width), generator=torch.Generator().manual_seed(3)) * 2.6 - 1.3
        want = cpu_env.step(state, actions)
        got = gpu_env.step(state_to(state, "cuda"), actions.cuda())
        dq = float((got[0].q.cpu() - want[0].q).abs().max())
        dobs = float((got[1].cpu() - want[1]).abs().max())
        drew = float((got[2].cpu() - want[2]).abs().max())
        same_done = bool(torch.equal(got[3].cpu(), want[3]))
        print(f"[envs] {name} step cuda vs cpu ({n} envs): max |dq| {dq:.2e}, max |dobs| {dobs:.2e}, "
              f"max |dreward| {drew:.2e}, terminations equal: {same_done}")
        if not (dq < 1e-4 and dobs < 1e-3 and drew < 1e-3 and same_done):
            raise AssertionError(f"{name} step on the card disagrees with the CPU step")

    rows = {}
    for name in ("Ant2D",) + ENV_NAMES:
        n = 4096
        vec = registry.create_vec_env(name, n)  # the default device: the card
        state, _ = vec.reset(torch.Generator(device="cuda").manual_seed(0))
        width = vec.get_env_info().action_space.shape[0]
        actions = torch.rand((n, width), generator=torch.Generator(device="cuda").manual_seed(1),
                             device="cuda") * 2 - 1
        q, qd = state.estate.q, state.estate.qd
        step = lambda: vec.step(state, actions)  # noqa: E731
        kinematics = lambda: vec.env.kinematics(q, qd)  # noqa: E731
        row = {}
        for what, fn in (("step", step), ("kinematics", kinematics)):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) / 20 * 1e3
            device_ms, kernels = device_time_ms(fn, 5)
            row[what] = {"wall_ms": wall_ms, "device_ms": device_ms, "kernels": kernels}
        rows[name] = row
        print(f"[envs] {name} at {n} envs: vec-env step {row['step']['wall_ms']:.2f} ms wall, "
              f"{row['step']['device_ms']:.3f} ms device, {row['step']['kernels']} device kernels; "
              f"kinematics with J and J̇q̇ {row['kinematics']['wall_ms']:.2f} ms wall, "
              f"{row['kinematics']['device_ms']:.3f} ms device, {row['kinematics']['kernels']} device kernels")
    return rows


def load_config(name: str) -> dict:
    """A YAML config of the repo, read in place."""
    import yaml

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "rl_games_tpu", "configs", name)
    with open(path) as f:
        return yaml.safe_load(f)


class ScalarLog:
    """A writer that keeps every scalar, by tag."""

    def __init__(self):
        self.tags = {}

    def add_scalar(self, tag, value, step):
        self.tags.setdefault(tag, []).append(float(value))

    def flush(self):
        pass

    def close(self):
        pass


def phase_trainer(epochs: int):
    from rl_games_tpu_torch.algos.ppo import PPOAgent
    from rl_games_tpu_torch.ops import fused_mlp, gae

    num_actors = 8192
    t0 = time.perf_counter()
    agent = PPOAgent("chip_smoke", flagship_params(num_actors))
    state = agent.init_state()
    torch.cuda.synchronize()
    print(f"[trainer] built agent + init_state in {time.perf_counter() - t0:.2f} s; "
          f"batch {agent.batch_size}, {agent.num_minibatches} minibatches x {agent.mini_epochs_num} mini-epochs")

    gae.gae_launches = fused_mlp.fused_mlp_launches = 0  # the main path's run starts here
    times = []
    for epoch in range(epochs):
        t0 = time.perf_counter()
        state, m = agent.train_epoch(state)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        times.append(dt)
        a_loss, c_loss = float(m["a_loss"]), float(m["c_loss"])
        print(f"[trainer] epoch {epoch + 1}: {dt * 1e3:.1f} ms, {agent.batch_size / dt:,.0f} env-steps/s, "
              f"a_loss {a_loss:.4f}, c_loss {c_loss:.4f}, kl {float(m['kl']):.4f}, "
              f"lr {float(m['lr']):.2e}, mean_rewards {float(m['mean_rewards'][0]):.3f}, "
              f"games {int(m['games_played'])}")
        if not (math.isfinite(a_loss) and math.isfinite(c_loss)):
            raise AssertionError(f"non-finite losses in epoch {epoch + 1}")
    # read right after the main path
    launches = {"gae": gae.gae_launches, "fused_mlp": fused_mlp.fused_mlp_launches}
    if launches != {"gae": epochs, "fused_mlp": 0}:
        raise AssertionError(f"plain trainer: launches {launches} in {epochs} epochs, expected gae {epochs}, fused_mlp 0")
    if int(state.epoch) != epochs or int(state.frame) != epochs * agent.batch_size:
        raise AssertionError("epoch/frame counters are off")
    steady = times[1:] or times
    print(f"[trainer] steady epoch {np.median(steady) * 1e3:.1f} ms (median of {len(steady)}), "
          f"{agent.batch_size / np.median(steady):,.0f} env-steps/s; first epoch {times[0] * 1e3:.1f} ms")
    print(f"[trainer] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return agent, state, launches, float(np.median(steady))


def phase_runner(epochs: int, plain_epoch_s: float):
    """The fused flagship config through Runner.run: train, then play the
    last checkpoint back. Returns the launch counts of the two runs and the
    player's step count."""
    from rl_games_tpu_torch.ops import fused_mlp, gae
    from rl_games_tpu_torch.runner import Runner

    num_actors, play_steps = 8192, 200
    params = flagship_params(num_actors)
    params["seed"] = 7
    params["network"]["mlp"]["fused"] = True
    epoch_ends = []

    def mark_epoch(agent):  # stop_fn: consulted after every epoch, never stops
        torch.cuda.synchronize()
        epoch_ends.append(time.perf_counter())
        return False

    with tempfile.TemporaryDirectory() as train_dir:
        params["config"].update({
            "name": "chip_smoke_fused", "train_dir": train_dir, "max_epochs": epochs,
            "save_frequency": max(1, epochs - 1), "save_best_after": 1,
            "player": {"num_actors": num_actors, "games_num": num_actors, "max_steps": play_steps,
                       "deterministic": True},
        })
        runner = Runner()  # the default device: the card
        runner.load({"params": params})

        gae.gae_launches = fused_mlp.fused_mlp_launches = 0  # the training run starts here
        t0 = time.perf_counter()
        last_mean, epoch_num = runner.run({"train": True, "stop_fn": mark_epoch})
        torch.cuda.synchronize()
        train_launches = {"gae": gae.gae_launches, "fused_mlp": fused_mlp.fused_mlp_launches}  # read right after
        # per epoch: 16 rollout forwards + 1 bootstrap forward at B = 8192 and
        # 4 mini-epochs x 4 minibatch forwards at B = 32768; GAE once
        expected = {"gae": epochs, "fused_mlp": (16 + 1 + 4 * 4) * epochs}
        if train_launches != expected or epoch_num != epochs:
            raise AssertionError(f"fused trainer: launches {train_launches} in {epoch_num} epochs, expected {expected}")
        times = np.diff([t0, *epoch_ends])
        steady = times[1:] if len(times) > 1 else times
        fused_epoch_s = float(np.median(steady))
        batch = num_actors * 16
        print(f"[runner] trained {epoch_num} epochs through Runner.run: launches {train_launches}; "
              f"steady epoch {fused_epoch_s * 1e3:.1f} ms (median of {len(steady)}), {batch / fused_epoch_s:,.0f} env-steps/s, "
              f"first epoch {times[0] * 1e3:.1f} ms; plain trainer in this call {plain_epoch_s * 1e3:.1f} ms, "
              f"{batch / plain_epoch_s:,.0f} env-steps/s")
        nn_dir = os.path.join(train_dir, "chip_smoke_fused", "nn")
        names = sorted(os.listdir(nn_dir))
        final = [n for n in names if f"_ep_{epochs}_rew_" in n]
        print(f"[runner] checkpoints: {names}")
        if len(final) != 1:
            raise AssertionError(f"no final checkpoint among {names}")
        checkpoint = os.path.join(nn_dir, final[0])

        steps = runner.create_player().steps_needed(num_actors)
        gae.gae_launches = fused_mlp.fused_mlp_launches = 0  # the player's run starts here
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            mean_reward = runner.run({"play": True, "checkpoint": checkpoint})
        torch.cuda.synchronize()
        play_s = time.perf_counter() - t0
        play_launches = {"gae": gae.gae_launches, "fused_mlp": fused_mlp.fused_mlp_launches}  # read right after
        sys.stdout.write(out.getvalue())

        # the steady step without set-up: a second player on the same
        # checkpoint, the start of each env step stamped on the host's clock
        player = runner.create_player()
        player.restore(checkpoint)
        env_step, stamps = player.vec_env.step, []

        def stamped_step(*args, **kwargs):
            stamps.append(time.perf_counter())
            return env_step(*args, **kwargs)

        player.vec_env.step = stamped_step
        with contextlib.redirect_stdout(io.StringIO()):
            player.run()
        torch.cuda.synchronize()
        warm = min(20, len(stamps) - 1)
        steady_step_s = (time.perf_counter() - stamps[warm]) / (len(stamps) - warm)
    games = re.search(r"games played: (\d+)", out.getvalue())
    # one policy forward per env step, nothing else
    if play_launches != {"gae": 0, "fused_mlp": steps} or steps != play_steps:
        raise AssertionError(f"player: launches {play_launches} in {steps} steps")
    if games is None or int(games.group(1)) <= 0 or not math.isfinite(mean_reward):
        raise AssertionError(f"player: mean reward {mean_reward}, output {out.getvalue()!r}")
    print(f"[runner] played {steps} steps x {num_actors} envs through Runner.run: launches {play_launches}, "
          f"{int(games.group(1))} games in the meter, mean reward {mean_reward:.3f}; {play_s:.2f} s with set-up, "
          f"{steps / play_s:.1f} steps/s, {steps * num_actors / play_s:,.0f} env-steps/s; steady step without set-up "
          f"{steady_step_s * 1e3:.2f} ms (mean of steps {warm + 1}-{len(stamps)} of a second run), "
          f"{num_actors / steady_step_s:,.0f} env-steps/s")
    return train_launches, play_launches, steps


def phase_humanoid3d(epochs: int, play_steps: int = 100):
    """ppo_humanoid3d.yaml at full width with the fused MLP, diagnostics and
    an observer, through Runner.run: train, then play the last checkpoint."""
    from rl_games_tpu_torch.algos import ppo as ppo_module
    from rl_games_tpu_torch.ops import fused_mlp, gae
    from rl_games_tpu_torch.runner import Runner
    from rl_games_tpu_torch.utils.observers import DefaultAlgoObserver

    class CountingObserver(DefaultAlgoObserver):
        """The default observer, counting the hooks the trainer calls."""

        def __init__(self):
            super().__init__()
            self.calls = collections.Counter()

        def before_init(self, *args):
            self.calls["before_init"] += 1
            super().before_init(*args)

        def after_init(self, algo):
            self.calls["after_init"] += 1
            super().after_init(algo)

        def after_epoch(self, metrics):
            self.calls["after_epoch"] += 1
            super().after_epoch(metrics)

        def after_print_stats(self, *args):
            self.calls["after_print_stats"] += 1
            super().after_print_stats(*args)

    params = load_config("ppo_humanoid3d.yaml")["params"]
    params["network"]["mlp"]["fused"] = True
    num_actors, horizon = params["config"]["num_actors"], params["config"]["horizon_length"]
    minibatch, mini_epochs = params["config"]["minibatch_size"], params["config"]["mini_epochs"]
    observer, log, epoch_ends, batches = CountingObserver(), ScalarLog(), [], []

    def mark_epoch(agent):  # stop_fn: consulted after every epoch, never stops
        torch.cuda.synchronize()
        epoch_ends.append(time.perf_counter())
        return False

    def counted(x, *args):  # the batch of every kernel launch
        batches.append(x.shape[0])
        return launch(x, *args)

    launch, create_writer = fused_mlp.fused_mlp_cuda, ppo_module.create_writer
    fused_mlp.fused_mlp_cuda, ppo_module.create_writer = counted, (lambda _dir: log)
    torch.cuda.reset_peak_memory_stats()
    try:
        with tempfile.TemporaryDirectory() as train_dir:
            params["config"].update({
                "name": "chip_smoke_humanoid3d", "train_dir": train_dir, "max_epochs": epochs,
                "use_diagnostics": True, "save_best_after": 1,
                "player": {**params["config"]["player"], "max_steps": play_steps},
            })
            runner = Runner(algo_observer=observer)  # the default device: the card
            runner.load({"params": params})
            gae.gae_launches = fused_mlp.fused_mlp_launches = 0  # the training run starts here
            t0 = time.perf_counter()
            _, epoch_num = runner.run({"train": True, "stop_fn": mark_epoch})
            torch.cuda.synchronize()
            train_launches = {"gae": gae.gae_launches, "fused_mlp": fused_mlp.fused_mlp_launches}  # read right after
            train_batches = {b: batches.count(b) for b in sorted(set(batches))}
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            nn_dir = os.path.join(train_dir, "chip_smoke_humanoid3d", "nn")
            final = [n for n in sorted(os.listdir(nn_dir)) if f"_ep_{epochs}_rew_" in n]
            if len(final) != 1:
                raise AssertionError(f"no final checkpoint among {os.listdir(nn_dir)}")

            batches.clear()
            gae.gae_launches = fused_mlp.fused_mlp_launches = 0  # the player's run starts here
            out = io.StringIO()
            t1 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                mean_reward = runner.run({"play": True, "checkpoint": os.path.join(nn_dir, final[0])})
            torch.cuda.synchronize()
            play_s = time.perf_counter() - t1
            play_launches = {"gae": gae.gae_launches, "fused_mlp": fused_mlp.fused_mlp_launches}  # read right after
    finally:
        fused_mlp.fused_mlp_cuda, ppo_module.create_writer = launch, create_writer

    # per epoch: horizon rollout forwards + 1 bootstrap forward at B =
    # num_actors, and mini_epochs x (batch / minibatch) minibatch forwards;
    # use_diagnostics times 4 rollouts once before the first epoch
    per_rollout = horizon + 1
    minibatches = mini_epochs * num_actors * horizon // minibatch
    expected = {"gae": epochs, "fused_mlp": 4 * per_rollout + (per_rollout + minibatches) * epochs}
    expected_batches = {num_actors: per_rollout * (epochs + 4), minibatch: minibatches * epochs}
    if train_launches != expected or train_batches != expected_batches or epoch_num != epochs:
        raise AssertionError(f"humanoid3d trainer: launches {train_launches} at batches {train_batches} in "
                             f"{epoch_num} epochs, expected {expected} at {expected_batches}")
    if play_launches != {"gae": 0, "fused_mlp": play_steps} or set(batches) != {num_actors}:
        raise AssertionError(f"humanoid3d player: launches {play_launches} in {play_steps} steps")
    wanted_tags = ([f"diagnostics/kl/{i}" for i in range(mini_epochs)]
                   + [f"diagnostics/clip_frac/{i}" for i in range(mini_epochs)]
                   + [f"diagnostics/{k}" for k in ("obs_rms_mean", "obs_rms_var", "value_rms_mean", "value_rms_var")])
    for tag in wanted_tags:
        values = log.tags.get(tag, [])
        if len(values) != epochs or not all(math.isfinite(v) for v in values):
            raise AssertionError(f"scalar {tag}: {values}, expected {epochs} finite values")
    hooks = {k: observer.calls.get(k, 0) for k in ("before_init", "after_init", "after_epoch", "after_print_stats")}
    if hooks != {"before_init": 1, "after_init": 1, "after_epoch": epochs, "after_print_stats": epochs}:
        raise AssertionError(f"observer hooks fired {hooks}")
    times = np.diff([t0, *epoch_ends])
    steady = times[1:] if len(times) > 1 else times
    epoch_s, batch = float(np.median(steady)), num_actors * horizon
    kl = log.tags["diagnostics/kl/0"]
    print(f"[humanoid3d] trained {epoch_num} epochs of ppo_humanoid3d.yaml (fused) through Runner.run: launches "
          f"{train_launches} at batches {train_batches}; steady epoch {epoch_s * 1e3:.1f} ms (median of "
          f"{len(steady)}), {batch / epoch_s:,.0f} env-steps/s; first epoch (with the rollout timing of "
          f"use_diagnostics) {times[0] * 1e3:.1f} ms; step rate of the timed rollout "
          f"{log.tags['performance/step_fps'][-1]:,.0f} env-steps/s; peak device memory {peak_gib:.2f} GiB")
    print(f"[humanoid3d] diagnostics/kl/0..{mini_epochs - 1} of the last epoch "
          f"{[round(log.tags[f'diagnostics/kl/{i}'][-1], 6) for i in range(mini_epochs)]}, kl/0 per epoch "
          f"{[round(v, 6) for v in kl]}; observer hooks {hooks}; rewards/iter {log.tags.get('rewards/iter')}")
    print(f"[humanoid3d] played {play_steps} steps x {num_actors} envs: launches {play_launches}, "
          f"mean reward {mean_reward:.3f}, {play_s:.2f} s with set-up")
    if not math.isfinite(mean_reward):
        raise AssertionError(f"humanoid3d player: mean reward {mean_reward}")
    return train_launches, play_launches, epoch_s


def phase_ant3d(epochs: int):
    """ppo_ant3d.yaml at full width, plain MLP, through PPOAgent.train_epoch."""
    from rl_games_tpu_torch.algos.ppo import PPOAgent
    from rl_games_tpu_torch.ops import fused_mlp, gae

    agent = PPOAgent("chip_smoke_ant3d", load_config("ppo_ant3d.yaml")["params"])
    state = agent.init_state()
    gae.gae_launches = fused_mlp.fused_mlp_launches = 0  # the main path's run starts here
    times = []
    for epoch in range(epochs):
        t0 = time.perf_counter()
        state, m = agent.train_epoch(state)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if not (math.isfinite(float(m["a_loss"])) and math.isfinite(float(m["c_loss"]))):
            raise AssertionError(f"ant3d: non-finite losses in epoch {epoch + 1}")
    launches = {"gae": gae.gae_launches, "fused_mlp": fused_mlp.fused_mlp_launches}  # read right after
    if launches != {"gae": epochs, "fused_mlp": 0}:
        raise AssertionError(f"ant3d trainer: launches {launches} in {epochs} epochs")
    steady = times[1:] or times
    epoch_s = float(np.median(steady))
    print(f"[ant3d] {epochs} epochs of ppo_ant3d.yaml (plain MLP) through train_epoch: launches {launches}; "
          f"steady epoch {epoch_s * 1e3:.1f} ms (median of {len(steady)}), "
          f"{agent.batch_size / epoch_s:,.0f} env-steps/s; first epoch {times[0] * 1e3:.1f} ms; "
          f"mean_rewards {float(m['mean_rewards'][0]):.3f}, games {int(m['games_played'])}")
    return launches, epoch_s


def phase_profile(agent, state):
    """One epoch under torch.profiler: device time by kernel and the
    device's idle share of the epoch's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        traj, last_values = agent._rollout(state)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        agent._finish_epoch(state, traj, last_values)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    # device activity only: key_averages() also credits each kernel's time
    # to the CPU op that launched it, so summing its rows counts it twice
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.time_range.elapsed_us() for e in kernels)  # one stream: no overlap
    wall_us = (t2 - t0) * 1e6
    print(f"[profile] epoch wall {wall_us / 1e3:.1f} ms (rollout {(t1 - t0) * 1e3:.1f} ms, "
          f"gae+update {(t2 - t1) * 1e3:.1f} ms, profiler on); device busy {device_us / 1e3:.1f} ms, "
          f"idle share {max(0.0, 1 - device_us / wall_us):.3f}; {len(kernels)} device kernels")
    for line in prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=30).splitlines():
        print(f"[profile] {line}")


def phase_profiler_sessions(sessions: int = 300, reps: int = 50):
    """How often torch.profiler loses device events: sessions of reps plain
    six-kernel chains each, counted as whole, partial or empty, with the
    host time of the sessions that lost events beside the median. It runs
    before phase_profile: once a session has also recorded CPU activity,
    every later CUDA-only session of the process lacks one event."""
    dev = torch.device("cuda")
    from rl_games_tpu_torch.ops import fused_mlp as fm

    x, ws, bs = mlp_inputs(FLAGSHIP_DIMS, 8192, torch.Generator(device=dev).manual_seed(2), dev)
    counts, seconds = [], []
    for _ in range(sessions):
        t0 = time.perf_counter()
        counts.append(len(device_events(lambda: fm.plain_mlp(x, ws, bs, "elu"), reps)))
        seconds.append(time.perf_counter() - t0)
    lost = [i for i, n in enumerate(counts) if n != 6 * reps]
    print(f"[kernels] {sessions} profiler sessions of {reps} plain chains: {sum(n == 0 for n in counts)} empty, "
          f"{sum(0 < n < 6 * reps for n in counts)} partial, at sessions {lost} "
          f"with {[counts[i] for i in lost]} of {6 * reps} events in {[round(seconds[i] * 1e3) for i in lost]} ms "
          f"(median session {np.median(seconds) * 1e3:.1f} ms)")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--epochs", type=int, default=5)
    parser.add_argument("--profile", action="store_true")
    args = parser.parse_args()

    phase_device()
    phase_build()
    gae_entry, fused_entry = phase_kernel_gae(), phase_kernel_fused_mlp()
    if args.profile:
        phase_profiler_sessions()  # before phase_profile: see its docstring
    phase_reference()
    phase_envs()
    agent, state, plain_launches, plain_epoch_s = phase_trainer(args.epochs)
    if args.profile:
        phase_profile(agent, state)
    del agent, state
    train_launches, play_launches, play_steps = phase_runner(args.epochs, plain_epoch_s)
    h_train, h_play, _ = phase_humanoid3d(args.epochs)
    a3_launches, _ = phase_ant3d(args.epochs)

    # launches of the main paths' runs, each counted from 0: the plain
    # trainer, the fused trainer and its player, the Humanoid3D trainer and
    # its player, the Ant3D trainer
    gae_entry["launches"] = (plain_launches["gae"] + train_launches["gae"] + h_train["gae"]
                             + a3_launches["gae"])
    gae_entry["launches_per_epoch"] = gae_entry["launches"] / (4 * args.epochs)
    fused_entry["launches"] = (train_launches["fused_mlp"] + play_launches["fused_mlp"]
                               + h_train["fused_mlp"] + h_play["fused_mlp"])
    fused_entry["launches_per_epoch"] = train_launches["fused_mlp"] / args.epochs
    fused_entry["launches_per_player_step"] = play_launches["fused_mlp"] / play_steps
    fused_entry["launches_humanoid3d"] = {"train": h_train["fused_mlp"], "play": h_play["fused_mlp"]}
    print(json.dumps({"kernels": [gae_entry, fused_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
