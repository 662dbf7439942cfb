"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py              # the check: build, compare, train, report
    python3 chip_smoke.py --profile    # the same, plus a torch.profiler epoch

Phases, each of which raises on failure (nothing falls back to the CPU or
to a plain version):

1. device    — a CUDA card must be present; prints its name and power limit.
2. build     — compiles every CUDA source of the path with nvcc.
3. kernels   — each kernel against its plain PyTorch version on the card, at
               the main path's shape and ragged ones; device time per call
               (torch.profiler) and time per call between CUDA events.
4. reference — the CUDA path of the port against its CPU path on a small
               input (one Ant2D step, one PPO update from one trajectory).
5. trainer   — the flagship workload at full width: continuous PPO on 8192
               Ant2D envs, MLP [256, 128, 64], horizon 16, 4 mini-epochs of
               4 minibatches of 32768; launch counts are zeroed just before
               and read just after, and every kernel of the path must have
               launched.

Prints a {"kernels": [...]} line, then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores


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


def device_time_ms(fn, reps: int):
    """(mean device time of the kernels fn() launches, kernels per call),
    from torch.profiler's CUDA activity: the card's own time, without the
    host's gaps between launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise AssertionError("torch.profiler recorded no device activity")
    total_us = sum(e.time_range.elapsed_us() for e in kernels)
    return total_us / reps / 1e3, len(kernels) / reps


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

    sources = sorted(p.stem for p in cuda_build.CSRC_DIR.glob("*.cu"))
    for name in sources:
        t0 = time.perf_counter()
        log = cuda_build.build(name)
        print(f"[build] {name} in {time.perf_counter() - t0:.2f} s "
              f"({'compiled now' if log is not None else 'library was current'})")
        for line in (log or "").splitlines():
            if "ptxas info" in line and ("registers" in line or "Compiling" in line):
                print(f"[build] {name}: {line.strip()}")


def gae_inputs(T, N, V, gen, device):
    f32 = dict(dtype=torch.float32, device=device)
    r = torch.randn((T, N, V), generator=gen, **f32)
    v = torch.randn((T, N, V), generator=gen, **f32)
    d = (torch.rand((T, N), generator=gen, **f32) < 0.05).to(torch.float32)
    lv = torch.randn((N, V), generator=gen, **f32)
    ld = (torch.rand((N,), generator=gen, **f32) < 0.05).to(torch.float32)
    ld[::7] = 1.0  # make sure some last dones are set
    return r, v, d, lv, ld


def phase_kernels():
    from rl_games_tpu_torch.ops import gae

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    for T, N, V in ((16, 8192, 1), (16, 1000, 2), (7, 33, 3)):
        args = gae_inputs(T, N, V, gen, dev)
        got = gae.gae_cuda(*args, 0.99, 0.95)
        want = gae.gae_plain(*args, 0.99, 0.95)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        print(f"[kernels] gae [{T},{N},{V}] max |kernel - plain| = {err:.3e}")
        if not math.isfinite(err) or err > 1e-5:
            raise AssertionError(f"gae kernel disagrees with gae_plain at [{T},{N},{V}]: {err}")
        worst = max(worst, err)

    T, N, V = 16, 8192, 1
    args = gae_inputs(T, N, V, gen, dev)
    kernel, plain = (lambda: gae.gae_cuda(*args, 0.99, 0.95)), (lambda: gae.gae_plain(*args, 0.99, 0.95))
    kernel_ms, kernel_n = device_time_ms(kernel, 100)
    plain_ms, plain_n = device_time_ms(plain, 20)
    kernel_call_ms, plain_call_ms = cuda_time_ms(kernel, 200), cuda_time_ms(plain, 20)
    nbytes = 4 * (3 * T * N * V + T * N + N * V + N)
    flops = 8 * T * N * V
    bound = {"bytes": nbytes / PEAK_BYTES_PER_S * 1e3, "operations": flops / PEAK_F32_FLOPS * 1e3}
    bound_by = max(bound, key=bound.get)
    print(f"[kernels] gae [16,8192,1] device time: kernel {kernel_ms * 1e3:.2f} us ({kernel_n:.0f} kernel/call), "
          f"plain {plain_ms * 1e3:.2f} us ({plain_n:.0f} kernels/call); "
          f"bound {bound[bound_by] * 1e3:.3f} us ({nbytes} B, by {bound_by})")
    print(f"[kernels] gae [16,8192,1] per call between CUDA events, host included: "
          f"kernel {kernel_call_ms * 1e3:.2f} us, plain {plain_call_ms * 1e3:.2f} us")
    return {
        "name": "gae",
        "route": "cuda",
        "source": "rl_games_tpu_torch/csrc/gae.cu",
        "replaces": "rl_games_tpu/ops/gae.py:97 (_gae_pallas_kernel, pallas_call at :159)",
        "shape": [T, N, V],
        "max_abs_err": worst,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "call_ms": kernel_call_ms,
        "plain_call_ms": plain_call_ms,
        "bound_ms": bound[bound_by],
        "bound_by": bound_by,
        "library_ms": None,
        "library_note": "no single PyTorch call computes GAE",
    }


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


def phase_trainer(epochs: int):
    from rl_games_tpu_torch.algos.ppo import PPOAgent
    from rl_games_tpu_torch.ops import gae

    num_actors = 8192
    t0 = time.perf_counter()
    agent = PPOAgent("chip_smoke", flagship_params(num_actors))
    state = agent.init_state()
    torch.cuda.synchronize()
    print(f"[trainer] built agent + init_state in {time.perf_counter() - t0:.2f} s; "
          f"batch {agent.batch_size}, {agent.num_minibatches} minibatches x {agent.mini_epochs_num} mini-epochs")

    gae.gae_launches = 0  # the main path's run starts here
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
    launches = {"gae": gae.gae_launches}  # read right after the main path
    if launches["gae"] != epochs:
        raise AssertionError(f"gae launched {launches['gae']} times in {epochs} epochs")
    if int(state.epoch) != epochs or int(state.frame) != epochs * agent.batch_size:
        raise AssertionError("epoch/frame counters are off")
    steady = times[1:] or times
    print(f"[trainer] steady epoch {np.median(steady) * 1e3:.1f} ms (median of {len(steady)}), "
          f"{agent.batch_size / np.median(steady):,.0f} env-steps/s; first epoch {times[0] * 1e3:.1f} ms")
    print(f"[trainer] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return agent, state, launches


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


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--epochs", type=int, default=5)
    parser.add_argument("--profile", action="store_true")
    args = parser.parse_args()

    phase_device()
    phase_build()
    gae_entry = phase_kernels()
    phase_reference()
    agent, state, launches = phase_trainer(args.epochs)
    if args.profile:
        phase_profile(agent, state)

    gae_entry["launches"] = launches["gae"]
    gae_entry["launches_per_epoch"] = launches["gae"] / args.epochs
    print(json.dumps({"kernels": [gae_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
