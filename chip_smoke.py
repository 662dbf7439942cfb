"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py              # the check: build, compare, train, play, report
    python3 chip_smoke.py --profile    # the same, plus torch.profiler epochs (flagship,
                                       # Breakout, SAC) and a count of the profiler
                                       # sessions that lose events

Phases, each of which raises on failure (nothing falls back to the CPU or
to a plain version):

1. device    — a CUDA card must be present; prints its name and power limit.
2. build     — compiles every CUDA source with nvcc and the native env
               stepper (native/cpuenv/cpuenv.cc) with g++, all at once;
               prints each kernel's registers and spills (ptxas) and fails
               where a fused-MLP kernel spills.
3. kernels   — each kernel against its plain PyTorch version on the card, at
               the main paths' shapes and ragged ones (the fused MLP over all
               nine activations, with inputs and weights beyond the init
               scale, and its gradients; its grouped launch over G weight
               sets against plain_mlp_grouped: the self-play opponents'
               6->128->64 at G = 1024 and 512, B = 1, timed, the JAX
               test shapes at G = 3, shared weights, biases and x, set
               strides that break 16-byte alignment, G = 1 bit for bit the
               ordinary launch; the sets kernel, which the grouped launch
               takes at few rows a set over many sets (the opponents at
               G = 1024 and 512), against plain_mlp_grouped and two calls
               bit for bit, timed beside the held grouped launch on the same
               inputs, an empty launch of its grid and its bound, and at the
               grouped shapes it does not take through a plan handed to it
               (the copy modes of skewed set strides); the chains one launch
               with x held does not
               take, held to the chain in float64: the nature-CNN's
               3136->512 at B = 512, 4096 and 4099, x * 30, elu and tanh,
               3134 and 3135 inputs, (64, 4096, 4096, 8), 10 and 17 layers
               of 256, grouped deep and 3136-wide chains, bf16 and fp16 x;
               a chain with a streamed launch twice, bit for bit; each timed
               beside the plain chain and, for one layer, torch.addmm, its
               launches' shapes beside (a streamed one's split, cluster,
               grid, waves and copy mode); the host time of a streamed
               call beside a held one's); device time per call
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
10. pong     — rl_games_tpu/configs/ppo_pong_device.yaml as shipped (512
               DevicePong envs, 84x84x2 frames, horizon 64, nature-CNN,
               4 x 8 minibatches of 4096) through Runner.run: trained, then
               its last checkpoint played back on 512 envs.
10a. pong_fused — the same config with network.mlp.fused: true (its 3136->512
               torso one launch that streams its input) through Runner.run,
               trained and played: 97 fused launches an epoch (65 at B = 512,
               32 at 4096), 1 a player step, GAE once an epoch, held exact;
               the fused model's forward and first update on the card against
               the CPU; its steady epoch beside [pong]'s.
10b. deep_torso — the flagship with a fused torso of 10 layers of 256 (two
               launches a forward), 2 epochs through PPOAgent.train_epoch:
               finite losses, 66 fused launches an epoch.
11. breakout — ppo_breakout_device.yaml as shipped through
               PPOAgent.train_epoch.
12. cartpole — ppo_cartpole.yaml with network.mlp.fused: true through
               Runner.run: trained, then played back.
13. sac      — rl_games_tpu/configs/sac_ant2d.yaml as shipped (1024 Ant2D
               envs, replay ring of 1e6 rows, batch 2048, 8 env steps and 64
               updates an epoch) through Runner.run: its 50 warmup epochs
               and --epochs epochs of updates, then its last checkpoint played
               back; the device kernels and time of an env step and of an
               update. It launches neither kernel (plain MLPs, no GAE). It
               runs right after phase 5, before any profiled phase.
14. host_ppo — rl_games_tpu/configs/ref/mujoco/halfcheetah.yaml at full
               width (64 envs x horizon 256, MLP [128, 64, 32] elu,
               5 x 8 minibatches of 2048) with its env swapped for the native
               stepper's Hopper2D-v0 (vecenv_type CPUENV: the card's machine
               has no MuJoCo), through Runner.run, trained and played three
               times: host_inference_device default, cpu, and default with
               network.mlp.fused: true. Per run: epoch times, the env step /
               rollout / update split, launches (GAE once per epoch at
               [256, 64, 1]; fused: 256 rollout + 1 bootstrap forwards at
               B = 64 and 40 minibatch forwards at B = 2048 per epoch, one per
               player step), the player's step; under --profile the device's
               idle share of one epoch. Then the default and the cpu runs'
               trained agents take 10 epochs each, interleaved; fails when the
               faster of them (the median of their ratio a round) is not the
               one host_inference_device auto takes. Then the plain and
               the fused policy side by side, interleaved: the host time of a
               forward, of the MLP torso and of the chain alone, a rollout's
               step and the device events per step.
15. host_pixel — the other side of auto's choice: ref/atari/ppo_breakout.yaml
               as shipped (nature-CNN, 64 envs x horizon 128 of 84x84x4
               frames) over a host env without an emulator, through
               PPOAgent.host_train_epoch with the policy on the card and on
               its CPU copy; fails when the faster is not auto's.
16. host_sac — rl_games_tpu/configs/sac_ant.yaml at full width (32 envs,
               MLPs [256, 256], batch 256, 32 updates per env step, a ring of
               1e6 rows, 5000 warmup frames) on Hopper2D-v0 the same way,
               through Runner.run: its warmup and 8 update epochs (256
               updates), the replay rows against the env steps less the one
               pending transition, then played. No kernel.
17. heads    — the test envs and the remaining heads at their configs' own
               widths, each trained --epochs epochs through Runner.run and
               played: (a) ref/test/test_discrete.yaml (separate relu
               [32, 32], test_env's {'obs', 'states'} observations and
               scores, 16 envs x 512 steps, 4 x 4 minibatches of 2048);
               (b) the same on test_masked_env with use_action_masks (no
               masked action sampled in training, play, or at the masks'
               corner); (c) ref/test/test_discrete_multidiscrete_mhv.yaml
               with multi_head_value (MultiDiscrete (2, 3), value_size 2);
               (d) ref/ppo_pendulum.yaml with mlp.fused on the device
               Pendulum-v1 (separate trunks, a state-dependent sigma; 2
               fused launches a forward); (e) ref/ppo_pendulum_torch.yaml
               as continuous_a2c and continuous_a2c_tanh. Each run's steady
               epoch, env-steps/s and launches per epoch and player step.
18. rnn      — the recurrent torsos, the central value net and PPO's other
               options at their configs' own widths, each trained 3 epochs
               through Runner.run and played: (a) ref/test/test_rnn.yaml
               (separate LSTM trunks, 16 envs x 512, seq_length 32);
               (b) ref/test/test_asymmetric_continuous.yaml (LSTM trunks with
               a layer norm, an LSTM central value net, 16 x 256); (c)
               ref/test/test_asymmetric_discrete_mhv.yaml with
               multi_head_value (the central value net at value_size 2);
               (d) ref/ppo_walker_rnn.yaml on the device Walker2D with
               mlp.fused (the MLP [256, 128, 64] in one launch into the GRU
               64, seq_length 32); (f) ppo_cartpole.yaml with RND, Gaussian
               soft augmentation, permute_batches and RMS advantages; and
               (e) the fused flagship under mixed_precision, 3 epochs through
               train_epoch. Each run's steady epoch, rollout step and its
               device kernels, the kernels of a core step, the player's
               step, and the GAE and fused launches, held exact.
19. dict     — dict observations and the custom test networks at their
               configs' own widths, each trained 3 epochs through Runner.run
               (import_modules naming rl_games_tpu.models.test_network,
               mapped to the port's) and played: (mops)
               ref/test/test_asymmetric_discrete_mhv_mops.yaml (testnet_dict
               over test_dict_obs_env's {'pos', 'info'}) and (aux)
               ref/test/test_discrite_testnet_aux_loss.yaml (testnet_aux_loss,
               'aux_target' and the aux loss), 16 envs x 256 steps, 4 x 2
               minibatches of 2048: steady epoch, rollout step and its
               kernels, the idle share of an epoch, 1 GAE launch an epoch at
               [256, 16, 1], no fused one.
20. sac_norm — ref/mujoco/sac_ant_tuned.yaml's separate layer-norm
               [256, 256] trunks (32 envs, batch 256, 32 updates per env
               step, 10000 warmup frames) on Hopper2D-v0 (CPUENV) as
               host_sac runs sac_ant.yaml: its warmup and 8 update epochs
               through Runner.run, then played. No kernel.
21. impala   — the Impala tower: (a) ref/atari/ppo_breakout_torch_impala.yaml
               as shipped (resnet_actor_critic, depths 16/32/32, MLP 512,
               LSTM 256; 16 envs x 256 steps, seq_length 8, 3 mini-epochs of
               minibatch 512) over PixelHostEnv's 84x84x4 frames (the card's
               machine has no ale_py), registered as a vecenv type; (b) the
               same with cnn.use_attention. Each trained 3 epochs through
               Runner.run and played: steady epoch, env-steps/s, the host
               rollout's step and its device kernels, the idle share of an
               epoch; 1 GAE launch an epoch at [256, 16, 1], none fused.
               Its profiler sessions meet PERF.md §7's lost events: in the
               runs PERF.md §6 records each lost one (the kernels a step
               read one event over 16 steps, 0.06, low).
22. twohot   — ppo_cartpole.yaml with network.value_head: twohot and
               mlp.fused: true through Runner.run, 3 epochs, then played:
               [cartpole]'s launch count (1 GAE at [32, 16, 1] an epoch, the
               fused launches at B = 16 and 64, 1 a player step).

23. population — multi-seed training and PBT (after every profiled phase,
               as [reference]'s A8 (b) checks): (a) benchruns/pbt_ant2d_ab.yaml
               as shipped (4 members of 2048 Ant2D envs x 16, MLP [256, 128,
               64] elu, minibatch 16384, its pbt block) through Runner.run
               with --seeds 7,11,17,23 for 8 epochs, interval_steps shrunk to
               2 epochs of a member's frames (a pbt_step every second epoch),
               then a member's checkpoint played: population and member
               epoch, 4 GAE launches at [16, 2048, 1] an epoch, none fused;
               (b) a 2-member MultiSeedTrainer of the fused flagship, 2
               epochs, each member against a solo run of its seed (bit for
               bit unless two solo runs differ; 1 GAE and 33 fused a member
               epoch); (c) PopulationTrainer.pbt_step over 3 such members with
               tests/test_multiseed.py's fake metrics; (d) PbtManager through
               Runner.run with pbt.enabled against a leader's record (the
               leader's weights, fresh Adam, gamma mutated); (e)
               sac_ant2d.yaml with --seeds 2,4 (a ring of 1e6 rows a member;
               no kernel); (f) SAC's set_param over [host_sac]'s host env,
               the pending transition kept.
24. selfplay — self-play and multi-agent PPO: (a) benchruns/selfplay_forage.yaml
               as shipped (1024 competitive_forage envs x 32, MLP [128, 64]
               elu, 2 x 4 minibatches of 8192, the self-play manager as
               configured; each env's opponent from its own slot of the
               learner's weights, a vmapped forward) through Runner.run for
               --epochs epochs, then its last checkpoint played as a mirror
               match (its weights in every opponent seat) through Runner.run:
               steady epoch, env-steps/s, peak memory, the rollout step's wall
               time and device kernels with the opponents' forward apart, the
               player's step; 1 GAE at [32, 1024, 1] an epoch, none fused;
               (b) a forced push on (a)'s agent (SelfPlayManager, update_score
               -100 over 1 game, 512 envs a push): slots 0-511 the learner's,
               512-1023 bit for bit, the opponents' actions on the card
               within 1e-5 of the CPU's; (c) cooperative_gather at 1024 envs x
               3 agents x 16 with tests/test_multiagent.py's networks and its
               central value net, 4 minibatches of 12,288 rows, 3 epochs: 1
               GAE at [16, 3072, 1] an epoch, games_played counting envs, not
               rows; (f) (a) and (b) with network.mlp.fused: true, 3 epochs:
               the opponents' forward one grouped launch of the fused kernel
               over the 1024 slots a step (41 ordinary and 32 grouped launches
               an epoch, one of each a player step, held exact; the grouped
               ones launches of the sets kernel, counted, and the opponents'
               device time beside the held grouped launch's in its place),
               the pushed
               opponents' actions on the card within 1e-5 of the CPU's, one
               gradient through torch.func.vmap of the operator against a
               loop over the sets (rtol 1e-5, atol 1e-6), the opponents'
               forward's kernels and time beside (a)'s. The connect-four and
               multiwalker host envs need pettingzoo and Box2D, which the
               card's machine lacks: they run in the CPU tests alone.

25. export  — policy export through torch.export (A12's last part): (a) the
               fused flagship (8192 Ant2D envs) trained 1 epoch through
               Runner.run, exported through Runner.run({"export": True}) to a
               .pt2 and loaded in this process: at B = 1, 7 and 8192 its
               actions against the player's deterministic forward within
               rtol = atol = 2e-5, one fused launch a call (the chain is the
               registered operator rl_games_tpu_torch::fused_mlp in the
               exported graph), a call at 8192 timed beside the player's
               forward; (b) sac_ant2d.yaml after its warmup and 1 update
               epoch, the actions inside the bounds (no kernel); (c)
               ref/ppo_walker_rnn.yaml fused ([rnn] (d)'s config) from zero
               states; (d) (a)'s artifact in a fresh process that imports only
               rl_games_tpu_torch.utils.export; and the operator's host cost
               against a direct call at B = 16 and 8192.
26. jax_ckpt — tests/data/jax_ppo_cartpole_fused.ckpt (the JAX package's
               ppo_cartpole.yaml, fused, after 2 epochs; written by
               tools/write_jax_ckpt_fixture.py) restored on the card and on the
               CPU: 200 deterministic steps with equal actions, --play, 2
               resumed epochs through Runner.run (epochs 3 and 4; 1 GAE and 65
               fused launches an epoch), --export of the fixture.
27. replay   — common/experience.py's prioritized replay at capacity 65,536,
               observations of 27, batch 256, on the card against the CPU with
               the same noise: indexes equal, weights within 1e-6.
28. mesh     — data parallelism over torch.distributed (parallel/mesh.py):
               (a) the flagship at 8192 Ant2D envs through an NCCL world of 1
               in this process, 3 epochs, bit for bit the plain process:
               weights, normalizers, Adam state, lr, every metric and the
               meters; (b) a world of 2 processes sharing the card through
               gloo over CUDA tensors: the flagship, the fused flagship and
               sac_ant2d.yaml at its own widths (warmup cut to 1 epoch, then
               3 epochs of 64 updates), each epoch's losses at rtol 1e-3 /
               atol 1e-5 (PPO a_loss and c_loss, SAC critic_loss and
               actor_loss; log_alpha at rtol 1e-4) against the plain
               process's epoch from the same state: the plain run's own first
               epoch, and for a later epoch one the plain process runs from
               the world's state at that epoch's start (gathered on rank 0),
               since after an update the world's weights differ by rounding,
               which the contact dynamics amplify from epoch to epoch; the two ranks bit for bit; GAE and the fused kernel
               launched in each rank and counted per rank; each world's
               steady epoch beside the plain one.

Phases 3-5 also hold the discrete slice: GAE at [64, 512, 1] and [32, 16,
1], the fused MLP at 4->32->32 relu (CartPole) at the batches its paths
give it, the Pong model's forward and one minibatch update on the card
against the CPU (where a TF32 convolution would show), and DevicePong,
DeviceBreakout, PixelCatcher and the classic envs on the card against the
CPU from the same state and draws, with a vec-env step at 512 and 4096
envs. Phase 4 also holds one SAC update of sac_ant2d.yaml's networks (a
batch of 2048) on the card against the CPU.

Phases 3 and 4 also hold [heads]: GAE at [512, 16, 2], [512, 16, 1] and
[128, 16, 1] and the fused MLP at 3->32->32 elu at B = 16 and 1024, and one
update of (c)'s and of (d)'s model on the card against the CPU.

Phases 3 and 4 also hold [rnn]: GAE at [256, 16, 1], the fused MLP at
16->256->128->64 elu at B = 16 and 2048 and the flagship chain with
bfloat16-rounded weights at B = 8192 and 32768, and one update of (b)'s and
(d)'s model on the card against the CPU ((b) with its central value net's
first minibatch).

Phases 3 and 4 also hold [dict] and [sac_norm]: GAE at [256, 16, 1] (held
for [rnn] already), one update of (aux)'s model over a trajectory of dict
observations and one SAC update of sac_ant_tuned.yaml's layer-norm networks
on the card against the CPU.

[reference] also holds [impala] and [twohot], after phase 22 (their GAE and
fused shapes are held for [rnn] and [cartpole] already; these checks come
after every profiled phase, see main()): one minibatch update of [impala]
(a)'s model on the card against the CPU (float32 convolutions), the same
tower with use_bn and use_zero_init and weight_decay 0.01 (the frozen
statistics moved by the decay alone, alike on both), one update of the
two-hot CartPole model, and connect4net's forward and gradients
(ref/ma/ppo_connect4_self_play_resnet.yaml's 5 blocks of 128 channels).

Phases 3 and 4 also hold [selfplay]: GAE at [32, 1024, 1] and [16, 3072, 1]
(bit for bit, timed), and one multi-agent update with the central value net
(64 envs x 3 agents) on the card against the CPU.

Phases 3 and 4 also hold the host path: GAE at [256, 64, 1] and the fused
MLP at 5->128->64->32 elu at B = 64 and 2048, and one host PPO rollout of
phase 14's config on the card against the CPU (same weights, CPUENV seed
and action noise), then one Adam step of its first minibatch.

Launch counts are zeroed just before each of phases 6-28's runs and read
just after, and are held to the counts the code implies. The script imports
neither gymnasium nor dm_control: on the card the host path runs through
the native stepper.

Prints a {"kernels": [...]} line (GAE, the fused MLP, and its sets kernel
apart), then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import argparse
import collections
import contextlib
import copy
import dataclasses
import functools
import io
import json
import math
import os
import re
import shutil
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


def idle_share(fn):
    """(the device's idle share of a call of fn(), its busy seconds, the
    call's wall seconds): the wall time of one call without the profiler
    (a CUDA-only torch.profiler session slows an eager epoch's host side
    about tenfold), the device's busy time of the next call under one."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy = sum(e.time_range.elapsed_us() for e in device_events(fn, 1)) / 1e6
    return 1 - busy / wall, busy, wall


def device_time_ms(fn, reps: int, sessions: int = 8):
    """(mean device time of the kernels fn() launches, kernels per call),
    from torch.profiler's CUDA activity: the card's own time, without the
    host's gaps between launches. The profiler loses device events: about
    one session in a hundred comes back with some or all of them missing,
    two or three sessions in a row, and a process can come to lose one or
    a few events in every CUDA-only session (PERF.md §7; see
    phase_profiler_sessions). So a session counts whole if it holds the
    same number of events for every call, and up to ``sessions`` are taken
    until one is, or until two in a row keep the same number short of
    whole. Failing that, the fullest session is read: its kernels per
    call are its events over reps rounded up, and its time reads low by at
    most the missing events times its longest kernel, over reps; both are
    printed. Where no session held an event at all, the time is taken
    between CUDA events, host gaps included, and the kernels per call are
    not measured (nan). (Not for use after phase_profile: see
    phase_profiler_sessions.)"""
    fn()
    torch.cuda.synchronize()
    fullest = []
    for attempt in range(sessions):
        kernels = device_events(fn, reps)
        if kernels and len(kernels) % reps == 0:
            return sum(e.time_range.elapsed_us() for e in kernels) / reps / 1e3, len(kernels) // reps
        print(f"[kernels] torch.profiler kept {len(kernels)} device events of {reps} calls "
              f"(session {attempt + 1} of {sessions})")
        if kernels and len(kernels) == len(fullest):
            break  # the same loss twice in a row: the process's steady mode, which more sessions keep
        if len(kernels) > len(fullest):
            fullest = kernels
    if not fullest:
        ms = cuda_time_ms(fn, reps)
        print(f"[kernels] no device events in {sessions} profiler sessions: {ms * 1e3:.1f} us a call between "
              f"CUDA events, host gaps included; kernels per call not measured")
        return ms, float("nan")
    per_call = -(-len(fullest) // reps)
    times = [e.time_range.elapsed_us() for e in fullest]
    missing = per_call * reps - len(fullest)
    print(f"[kernels] no whole profiler session: the fullest kept {len(fullest)} events, {per_call} kernels "
          f"a call; its time per call reads low by at most {missing * max(times) / reps:.1f} us "
          f"({missing} missing events times its longest kernel, over {reps} calls)")
    return sum(times) / reps / 1e3, per_call


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
    from concurrent.futures import ThreadPoolExecutor

    from rl_games_tpu_torch.utils import cuda_build, native_build

    t0 = time.perf_counter()
    # the native env stepper (g++) beside the CUDA sources (one nvcc each),
    # all started together
    with ThreadPoolExecutor(1) as pool:
        native = pool.submit(native_build.build, "cpuenv")
        logs = cuda_build.build_all()
        native_log = native.result()
    print(f"[build] {len(logs)} sources ({', '.join(logs)}) and native/cpuenv/cpuenv.cc in "
          f"{time.perf_counter() - t0:.2f} s, built at once; cpuenv "
          f"{'compiled now' if native_log is not None else 'library was current'} with g++ "
          f"{' '.join(native_build.CXX_FLAGS)} into {native_build.library_path('cpuenv')}")
    for name, log in logs.items():
        print(f"[build] {name}: {'compiled now' if log is not None else 'library was current'}, "
              f"flags {' '.join(cuda_build.nvcc_flags(name))}")
        for line in (log or "").splitlines():
            # "N bytes stack frame, N bytes spill stores, N bytes spill loads" has no prefix
            if "spill" in line or ("ptxas info" in line and any(w in line for w in ("registers", "smem", "Compiling"))):
                print(f"[build] {name}: {line.strip()}")
        kernels = ptxas_kernels(log or "")
        if kernels:
            print(f"[build] {name} registers and spill stores / loads (bytes) per kernel: "
                  + "; ".join(f"{k} {v['registers']} regs, {v['spill_stores']} / {v['spill_loads']}"
                              for k, v in kernels.items()))
        spilled = {k: v for k, v in kernels.items() if v["spill_stores"] or v["spill_loads"]}
        if name == "fused_mlp" and spilled:
            raise AssertionError(f"fused_mlp kernels spill registers: {spilled}")
    if sorted(logs) != ["fused_mlp", "gae"]:
        raise AssertionError(f"expected the sources fused_mlp and gae, built {sorted(logs)}")


def ptxas_kernels(log: str) -> dict:
    """{kernel: {registers, spill_stores, spill_loads}} from ``nvcc
    -Xptxas=-v``'s output, a kernel named by its function and template
    arguments where the mangled name shows them (fused_mlp_stream_kernel<16>)."""
    kernels, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = kernel_name(entry.group(1))
            kernels[name] = {"registers": None, "spill_stores": 0, "spill_loads": 0}
            continue
        if name is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            kernels[name].update(spill_stores=int(spill.group(1)), spill_loads=int(spill.group(2)))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            kernels[name]["registers"] = int(used.group(1))
    return kernels


def kernel_name(mangled: str) -> str:
    """The last name of a mangled kernel (its length-prefixed components
    after _ZN, or the one after _Z) and its integer template arguments:
    fused_mlp_stream_kernel<16>."""
    i = mangled.find("N", 2) + 1 if mangled.startswith("_ZN") else 2
    name = mangled
    while i < len(mangled) and mangled[i].isdigit():
        digits = re.match(r"\d+", mangled[i:]).group(0)
        start = i + len(digits)
        name, i = mangled[start:start + int(digits)], start + int(digits)
    args = re.match(r"I((?:Li-?\d+E)+)E", mangled[i:])
    return f"{name}<{', '.join(re.findall(r'Li(-?[0-9]+)E', args.group(1)))}>" if args else name


# GAE's [T, N·A, V] on [selfplay]'s two paths: benchruns/selfplay_forage.yaml's and cooperative_gather's
SELFPLAY_SHAPE, MULTIAGENT_SHAPE = (32, 1024, 1), (16, 3072, 1)


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
    # the plain loop launches 4 T + 8 kernels a call: at horizon 512 twenty
    # calls come to about 41,000 events, where a session starts to drop some
    # (and the sessions after it too), so long sweeps take fewer calls
    plain_reps = 20 if T <= 256 else 5
    plain_ms, plain_n = device_time_ms(plain, plain_reps)
    kernel_call_ms, plain_call_ms = cuda_time_ms(kernel, 200), cuda_time_ms(plain, plain_reps)
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
    # the main paths' shapes (the flagship's, the 3D configs', Pong's and
    # Breakout's, CartPole's, the host path's halfcheetah.yaml and
    # ppo_breakout.yaml), then horizons that take every branch of the
    # kernel's sweep: one chunk of 16; the row-by-row tail alone; 16 + 8 + 5
    for T, N, V in ((16, 8192, 1), (16, 4096, 1), (16, 2048, 1), (64, 512, 1), (32, 16, 1), (256, 64, 1), (128, 64, 1),
                    (512, 16, 2), (512, 16, 1), (128, 16, 1), (256, 16, 1), SELFPLAY_SHAPE, MULTIAGENT_SHAPE,
                    (16, 1000, 2), (7, 33, 3), (29, 777, 2)):
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
        # the 3D configs' shape (4096 envs), the pixel configs' (512 envs,
        # horizon 64), CartPole's, the host path's (64 envs, horizon 256:
        # 256 dependent steps over one block of 64 threads; [host_pixel]'s 128)
        # [heads]: the multi-head value's [512, 16, 2] (test_discrete_multidiscrete_mhv.yaml),
        # test_discrete.yaml's [512, 16, 1], the Pendulum configs' [128, 16, 1]
        "other_shapes": [time_gae(16, 4096, 1, gen, dev), time_gae(64, 512, 1, gen, dev),
                         time_gae(32, 16, 1, gen, dev), time_gae(256, 64, 1, gen, dev),
                         time_gae(128, 64, 1, gen, dev), time_gae(512, 16, 2, gen, dev),
                         time_gae(512, 16, 1, gen, dev), time_gae(128, 16, 1, gen, dev),
                         # [rnn]: test_asymmetric_continuous.yaml's and ppo_walker_rnn.yaml's 16 envs x 256
                         time_gae(256, 16, 1, gen, dev),
                         # [population] (a): benchruns/pbt_ant2d_ab.yaml's 2048 envs x 16, once a member epoch
                         time_gae(16, 2048, 1, gen, dev),
                         # [selfplay] (a): benchruns/selfplay_forage.yaml's 1024 envs x 32; (c): cooperative_gather's
                         # 1024 envs x 3 agents x 16; each once an epoch
                         time_gae(*SELFPLAY_SHAPE, gen, dev), time_gae(*MULTIAGENT_SHAPE, gen, dev)],
    }


ACTIVATIONS = ("relu", "elu", "selu", "softplus", "gelu", "sigmoid", "swish", "tanh", "None")
FLAGSHIP_DIMS = (26, 256, 128, 64)
ANT3D_DIMS = (33, 256, 128, 64)  # ppo_ant3d.yaml: obs 33
HUMANOID3D_DIMS = (41, 256, 128, 64)  # ppo_humanoid3d.yaml: obs 41
CARTPOLE_DIMS = (4, 32, 32)  # ppo_cartpole.yaml: obs 4, mlp [32, 32] relu
HOPPER_DIMS = (5, 128, 64, 32)  # ref/mujoco/halfcheetah.yaml's mlp [128, 64, 32] elu on Hopper2D's 5 obs
# ref/ppo_walker_rnn.yaml's mlp [256, 128, 64] elu on the device Walker2D's 16 observations, in front of its GRU
WALKER_DIMS = (16, 256, 128, 64)
# benchruns/selfplay_forage.yaml's mlp [128, 64] elu on competitive_forage's 6 observations: the opponents'
# chain, one weight set an env's slot
FORAGE_DIMS = (6, 128, 64)


def mlp_inputs(dims, batch, gen, device, bf16_weights=False):
    """x ~ N(0, 1); weights [out, in] ~ U(+-1/sqrt(in)), as the model's
    default init draws them, so activations stay of order 1 and an absolute
    tolerance of 2e-5 is a float32 statement; biases ~ 0.1 N(0, 1). With
    ``bf16_weights`` the weights and biases are rounded to bfloat16 and
    back, as mixed_precision hands them to the kernel."""
    f32 = dict(dtype=torch.float32, device=device)
    ws = [(torch.rand((dims[i + 1], dims[i]), generator=gen, **f32) * 2 - 1) / math.sqrt(dims[i])
          for i in range(len(dims) - 1)]
    bs = [torch.randn((dims[i + 1],), generator=gen, **f32) * 0.1 for i in range(len(dims) - 1)]
    if bf16_weights:
        ws, bs = ([p.to(torch.bfloat16).to(torch.float32) for p in ps] for ps in (ws, bs))
    return torch.randn((batch, dims[0]), generator=gen, **f32), ws, bs


def time_fused(dims, batch, gen, dev, activation="elu", bf16_weights=False):
    """Device time of the fused kernel and of the plain chain at one shape,
    in turns (plain, kernel, kernel, plain), beside the 3xTF32 bound."""
    from rl_games_tpu_torch.ops import fused_mlp as fm

    x, ws, bs = mlp_inputs(dims, batch, gen, dev, bf16_weights)
    kernel = lambda: fm.fused_mlp_cuda(x, ws, bs, activation)  # noqa: E731
    plain = lambda: fm.plain_mlp(x, ws, bs, activation)  # noqa: E731
    plain_a, plain_n = device_time_ms(plain, 50)
    kernel_a, _ = device_time_ms(kernel, 50)
    kernel_b, _ = device_time_ms(kernel, 50)
    plain_b, _ = device_time_ms(plain, 50)
    kernel_ms, plain_ms = (kernel_a + kernel_b) / 2, (plain_a + plain_b) / 2
    n_weights = sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))
    flops = 3 * 2 * batch * n_weights
    nbytes = 4 * (x.numel() + batch * dims[-1] + n_weights + sum(dims[1:]))
    bound, bound_by = bound_ms(nbytes, flops, PEAK_TF32_FLOPS)
    (launch, *_) = fm.launch_plan(dims, batch)
    how = (f"the cluster kernel, clusters of {launch.cluster.cluster}" if launch.cluster is not None
           else f"the wgmma kernel, clusters of {launch.wgmma.cluster}, {launch.wgmma.slots} slots"
           if launch.wgmma is not None else f"{launch.plan[0]} rows/block")
    print(f"[kernels] fused_mlp {'x'.join(map(str, dims))} B={batch} {activation}"
          f"{' bfloat16-rounded weights' if bf16_weights else ''} ({how}) device time: "
          f"kernel {kernel_ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us ({plain_n:.0f} kernels/call); "
          f"bound {bound * 1e3:.2f} us ({flops} TF32 flop, {nbytes} B, by {bound_by}); "
          f"kernel at {bound / kernel_ms:.3f} of the bound's rate")
    return {"shape": [batch, *dims], "activation": activation, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "share_of_bound": bound / kernel_ms,
            **({"weights": "bfloat16-rounded"} if bf16_weights else {})}


# The main paths' small batches: the walker GRU's rollout (B = 16), the host path's (64), the flagship torso of an
# exported policy and a player (1, 7, 16), Pendulum's (PENDULUM_DIMS, defined further down) and CartPole's rollouts
# (16; 16 and 64: two weight tiles, which the plan keeps on the held kernel), the self-play learner's rollout (1024),
# a 512 -> 64 layer held behind a streamed one (512)
CLUSTER_CASES = ((WALKER_DIMS, 16, "elu"), (HOPPER_DIMS, 64, "elu"), (FLAGSHIP_DIMS, 1, "elu"), (FLAGSHIP_DIMS, 7, "elu"),
                 (FLAGSHIP_DIMS, 16, "elu"), ((3, 32, 32), 16, "elu"), (CARTPOLE_DIMS, 16, "relu"),
                 (CARTPOLE_DIMS, 64, "relu"), (FORAGE_DIMS, 1024, "elu"), ((512, 64), 512, "elu"))


def kernel_fused_mlp_cluster(gen, dev):
    """Each of CLUSTER_CASES through fused_mlp_cuda (launch_plan's route: the
    cluster kernel where it picks it) against plain_mlp at rtol = atol =
    2e-5 and against the held kernel on the same inputs (a held Launch
    handed to _run_chain: the same sums in the same order, so 0), two calls
    bit for bit, its launches of the cluster kernel counted; then timed in
    turns (plain, held, routed, routed, held, plain; a one-layer chain with
    torch.addmm of the same layer beside) beside the bound (each input read
    once, the output written once, against 3xTF32 products) and an empty
    launch of the same grid, cluster and shared memory."""
    from rl_games_tpu_torch.ops import fused_mlp as fm

    rows, worst, worst_ratio, worst_held = [], 0.0, 0.0, 0.0
    for dims, batch, activation in CLUSTER_CASES:
        x, ws, bs = mlp_inputs(dims, batch, gen, dev)
        act = fm.ACTIVATION_CODES[activation]
        (launch,) = fm.launch_plan(dims, batch)
        held_launch = launch._replace(cluster=None)
        held_out = torch.empty((batch, dims[-1]), device=dev)
        routed = lambda: fm.fused_mlp_cuda(x, ws, bs, activation)  # noqa: E731
        held = lambda: fm._run_chain(x, held_out, batch, list(dims), ws, bs, act, [held_launch])  # noqa: E731
        plain = lambda: fm.plain_mlp(x, ws, bs, activation)  # noqa: E731
        before = fm.fused_mlp_cluster_launches
        got = routed()
        torch.cuda.synchronize()
        cluster_launches = fm.fused_mlp_cluster_launches - before
        again = routed()
        held()
        want = plain()
        torch.cuda.synchronize()
        diff = (got - want).abs()
        err, ratio = float(diff.max()), float((diff / (2e-5 + 2e-5 * want.abs())).max())
        from_held, same = float((got - held_out).abs().max()), torch.equal(got, again)
        name = f"{'x'.join(map(str, dims))} B={batch} {activation}"
        if not (math.isfinite(ratio) and ratio <= 1.0 and same and from_held == 0.0
                and cluster_launches == int(launch.cluster is not None)):
            raise AssertionError(f"fused_mlp cluster {name}: {ratio} of rtol = atol = 2e-5 from plain_mlp, "
                                 f"{from_held} from the held kernel, two calls equal {same}, {cluster_launches} "
                                 f"cluster launches (plan {launch.cluster})")
        worst, worst_ratio, worst_held = max(worst, err), max(worst_ratio, ratio), max(worst_held, from_held)
        turns = [("plain", plain), ("held", held), ("routed", routed)] if launch.cluster else [("plain", plain),
                                                                                              ("held", held)]
        if len(dims) == 2:  # one layer: torch.addmm computes its products and bias in one call (the yardstick)
            turns.append(("addmm", lambda: torch.addmm(bs[0], x, ws[0].t())))
        times = {key: [] for key, _ in turns}
        for key, fn in (*turns, *reversed(turns)):
            times[key].append(device_time_ms(fn, 20)[0])
        ms = {key: sum(t) / len(t) for key, t in times.items()}
        floor_ms = device_time_ms(lambda: fm.cluster_empty_launch(launch.cluster, batch), 20)[0] if launch.cluster \
            else None
        n_weights = sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))
        flops = 3 * 2 * batch * n_weights
        nbytes = 4 * (x.numel() + batch * dims[-1] + n_weights + sum(dims[1:]))
        bound, bound_by = bound_ms(nbytes, flops, PEAK_TF32_FLOPS)
        kernel_ms = ms.get("routed", ms["held"])
        print(f"[kernels] fused_mlp cluster {name}: "
              + (f"the cluster kernel (clusters of {launch.cluster.cluster}, grid {fm.cluster_grid(launch.cluster, batch)}"
                 f", {launch.cluster.shared} B shared) {ms['routed'] * 1e3:.2f} us, the held kernel "
                 f"{ms['held'] * 1e3:.2f} us ({ms['routed'] / ms['held']:.3f}x), empty launch of its grid "
                 f"{floor_ms * 1e3:.2f} us" if launch.cluster else
                 f"the plan keeps the held kernel: {ms['held'] * 1e3:.2f} us")
              + f", plain {ms['plain'] * 1e3:.2f} us"
              + (f", torch.addmm {ms['addmm'] * 1e3:.2f} us" if "addmm" in ms else "")
              + f"; bound {bound * 1e3:.3f} us ({nbytes} B, {flops} TF32 flop, by "
              f"{bound_by}); max |kernel - plain| {err:.3e} ({ratio:.3f} of the tolerance), max |kernel - held| "
              f"{from_held:.1e}, two calls bit for bit equal {same}, {cluster_launches} cluster launch a call")
        rows.append({"shape": [batch, *dims], "activation": activation, "cluster": launch.cluster.cluster
                     if launch.cluster else None, "ms": kernel_ms, "held_ms": ms["held"], "plain_ms": ms["plain"],
                     "floor_ms": floor_ms, "bound_ms": bound, "bound_by": bound_by, "share_of_bound": bound / kernel_ms,
                     "library_ms": ms.get("addmm"), "max_abs_err": err, "max_abs_diff_from_held": from_held,
                     "launches_per_call": cluster_launches})
    return {"cluster_shapes": rows, "cluster_max_abs_err": worst, "cluster_max_err_over_tolerance": worst_ratio,
            "cluster_max_abs_diff_from_held": worst_held}


# The wgmma kernel's main-path shapes: the flagship torso at the rollout's B = 8192 and the minibatch's 32768
# ([runner], [rnn] (e)), at 4224 (66 row tiles: 33 clusters of two) and a ragged 5001 (below WGMMA_MIN_ROWS: the
# kernel handed them); the 3D configs' torsos at their rollout's 4096 (the route keeps the held kernel there) and
# minibatch's 32768 ([humanoid3d]); the deep torso's 10 layers of 256 at 8192, two launches ([deep_torso]). Each held
# to plain_mlp (the deep torso to the exact chain) and timed beside the held kernel.
WGMMA_CASES = ((FLAGSHIP_DIMS, 8192), (FLAGSHIP_DIMS, 32768), (FLAGSHIP_DIMS, 4224), (FLAGSHIP_DIMS, 5001),
               (ANT3D_DIMS, 4096), (ANT3D_DIMS, 32768), (HUMANOID3D_DIMS, 4096), (HUMANOID3D_DIMS, 32768),
               ((256,) * 11, 8192))


def kernel_fused_mlp_wgmma(gen, dev):
    """The wgmma kernel (csrc/fused_mlp.cu fused_mlp_wgmma_kernel) through
    fused_mlp_cuda (launch_plan's route) at WGMMA_CASES, with x * 30 through
    the flagship, Humanoid3D and deep torsos, weights * 8 through each of
    their layers (over a chain of them the float32 chain itself misses the
    tolerance: tests/test_torch_port_fused_mlp_wgmma.py), every activation
    at the flagship's and 37x50x33x7's widths, and bf16 and fp16 x and
    weights through fused_mlp and the registered operator. Each against
    plain_mlp at rtol = atol = 2e-5 (the scaled and deep chains against the
    exact chain), two calls bit for bit, the kernel's launches a call held
    to launch_plan's. Each of WGMMA_CASES then timed in turns (plain, held,
    wgmma, wgmma, held, plain; the held kernel by the plan's launches with
    the wgmma plan taken out, handed to _run_chain) beside the bound (each
    input read once, the output written once, against 3xTF32 products), an
    empty launch of its grid, cluster and shared memory, and the host's
    time a call of each (the enqueue alone, in turns)."""
    from rl_games_tpu_torch.ops import fused_mlp as fm

    worst, worst_ratio, checked = 0.0, 0.0, 0

    def check(tag, x, ws, bs, activation="elu", exact=False):
        nonlocal worst, worst_ratio, checked
        dims, batch = [x.shape[1]] + [w.shape[0] for w in ws], x.shape[0]
        plan = fm.launch_plan(dims, batch)
        routed = any(p.wgmma is not None for p in plan)
        if not routed:
            # a shape the route leaves to another kernel (few multiply-adds a row): the wgmma kernel handed it
            plan = [p._replace(wgmma=fm.wgmma_plan(dims[p.first:p.last + 1], batch, cluster=fm.WGMMA_CLUSTER))
                    for p in plan]
            tag += " (handed a wgmma plan)"

        def run():
            if routed:
                return fm.fused_mlp_cuda(x, ws, bs, activation)
            out = torch.empty((batch, dims[-1]), device=x.device)
            fm._run_chain(x, out, batch, dims, ws, bs, fm.ACTIVATION_CODES[activation], plan)
            return out

        expected = sum(p.wgmma is not None for p in plan)
        before = fm.fused_mlp_wgmma_launches
        got = run()
        torch.cuda.synchronize()
        made = fm.fused_mlp_wgmma_launches - before
        same = torch.equal(got, run())
        want = exact_chain(x, ws, bs, activation) if exact else fm.plain_mlp(x, ws, bs, activation).double()
        err, ratio = float((got.double() - want).abs().max()), tolerance_share(got, want)
        print(f"[kernels] fused_mlp wgmma {tag} {activation}: {made} wgmma launches a call; max |kernel - "
              f"{'exact' if exact else 'plain'}| {err:.3e} ({ratio:.3f} of rtol = atol = 2e-5), two calls bit for bit "
              f"equal {same}")
        if not (expected >= 1 and made == expected and same and math.isfinite(ratio) and ratio <= 1.0):
            raise AssertionError(f"fused_mlp wgmma {tag} {activation}: {made} wgmma launches (expected {expected}), "
                                 f"{ratio} of the tolerance, two calls equal {same}")
        worst, worst_ratio, checked = max(worst, err), max(worst_ratio, ratio), checked + 1
        return err, ratio

    rows = []
    act = fm.ACTIVATION_CODES["elu"]
    for dims, batch in WGMMA_CASES:
        x, ws, bs = mlp_inputs(dims, batch, gen, dev)
        name = f"{'x'.join(map(str, dims))} B={batch}" if len(dims) < 6 else f"{len(dims) - 1} layers of 256 B={batch}"
        err, ratio = check(name, x, ws, bs, exact=len(dims) > 4)
        plan = fm.launch_plan(dims, batch)
        held_plan = [p._replace(wgmma=None) for p in plan]
        held_out = torch.empty((batch, dims[-1]), device=dev)
        taken = any(p.wgmma is not None for p in plan)
        if taken:
            routed = lambda: fm.fused_mlp_cuda(x, ws, bs, "elu")  # noqa: E731
        else:
            # the route keeps the held kernel at this batch (the sweep measured it faster): the wgmma kernel handed
            # the shape, timed beside it all the same
            plan = [p._replace(wgmma=fm.wgmma_plan(dims[p.first:p.last + 1], batch, cluster=fm.WGMMA_CLUSTER))
                    for p in plan]
            forced_out = torch.empty((batch, dims[-1]), device=dev)
            routed = lambda: fm._run_chain(x, forced_out, batch, list(dims), ws, bs, act, plan)  # noqa: E731
        held = lambda: fm._run_chain(x, held_out, batch, list(dims), ws, bs, act, held_plan)  # noqa: E731
        plain = lambda: fm.plain_mlp(x, ws, bs, "elu")  # noqa: E731
        turns = (("plain", plain), ("held", held), ("wgmma", routed))
        times = {key: [] for key, _ in turns}
        for key, fn in (*turns, *reversed(turns)):
            times[key].append(device_time_ms(fn, 20)[0])
        ms = {key: sum(t) / len(t) for key, t in times.items()}
        # the held kernel in the wgmma kernel's place is right too (5001: 32-row blocks, the last one ragged)
        held_ratio = tolerance_share(held_out, exact_chain(x, ws, bs, "elu") if len(dims) > 4
                                     else fm.plain_mlp(x, ws, bs, "elu").double())
        if not held_ratio <= 1.0:
            raise AssertionError(f"the held kernel at {name}: {held_ratio} of the tolerance")
        host = {key: [] for key in ("held", "wgmma")}
        for key, fn in (("held", held), ("wgmma", routed), ("wgmma", routed), ("held", held)):
            host[key].append(host_us_per_call(fn))
        host_us = {key: float(np.median(t)) for key, t in host.items()}
        plans = [p.wgmma for p in plan]
        floor_ms = sum(device_time_ms(functools.partial(fm.wgmma_empty_launch, wp, batch), 20)[0] for wp in plans)
        n_weights = sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))
        flops = 3 * 2 * batch * n_weights
        nbytes = 4 * (x.numel() + batch * dims[-1] + n_weights + sum(dims[1:]))
        bound, bound_by = bound_ms(nbytes, flops, PEAK_TF32_FLOPS)
        grids = [fm.wgmma_grid(wp, batch) for wp in plans]
        copies = fm.wgmma_copy_modes(x, ws[:plan[0].last])  # the first launch's x and weights
        print(f"[kernels] fused_mlp wgmma {name}{'' if taken else ' (the route keeps the held kernel)'}: the wgmma "
              f"kernel ({len(plans)} launch(es): clusters of "
              f"{[wp.cluster for wp in plans]}, {[wp.slots for wp in plans]} slots, grid {grids}, "
              f"{[wp.shared for wp in plans]} B shared; copies of x and each W {copies}) {ms['wgmma'] * 1e3:.2f} us, "
              f"the held kernel "
              f"{ms['held'] * 1e3:.2f} us ({ms['wgmma'] / ms['held']:.3f}x), plain {ms['plain'] * 1e3:.2f} us, empty "
              f"launch of its grid {floor_ms * 1e3:.2f} us; bound {bound * 1e3:.2f} us ({flops} TF32 flop, {nbytes} B, "
              f"by {bound_by}), the kernel at {bound / ms['wgmma']:.3f} of it; host {host_us['wgmma']:.2f} us a call "
              f"(held {host_us['held']:.2f} us)")
        rows.append({"shape": [batch, *dims], "activation": "elu", "routed": taken,
                     "clusters": [wp.cluster for wp in plans],
                     "copies": copies,
                     "slots": [wp.slots for wp in plans], "grids": grids, "shared": [wp.shared for wp in plans],
                     "ms": ms["wgmma"], "held_ms": ms["held"], "plain_ms": ms["plain"], "floor_ms": floor_ms,
                     "bound_ms": bound, "bound_by": bound_by, "share_of_bound": bound / ms["wgmma"],
                     "host_us": host_us["wgmma"], "held_host_us": host_us["held"], "max_abs_err": err,
                     "err_over_tolerance": ratio, "launches_per_call": len(plans)})
    # beyond the model's scales, against the exact chain
    for dims in (FLAGSHIP_DIMS, HUMANOID3D_DIMS, (256,) * 11):
        x, ws, bs = mlp_inputs(dims, 8192, gen, dev)
        check(f"{dims[0]}->...->{dims[-1]} ({len(dims) - 1} layers) B=8192 (x * 30)", x * 30.0, ws, bs, exact=True)
    for dims in ((26, 256), (256, 128), (128, 64), (41, 256), (256, 256)):
        x, ws, bs = mlp_inputs(dims, 8192, gen, dev)
        check(f"{dims[0]}x{dims[1]} B=8192 (weights * 8)", x, [w * 8.0 for w in ws], bs, exact=True)
    for dims in (FLAGSHIP_DIMS, (37, 50, 33, 7)):
        x, ws, bs = mlp_inputs(dims, 8192, gen, dev)
        for activation in ACTIVATIONS:
            check(f"{'x'.join(map(str, dims))} B=8192", x, ws, bs, activation)
    # a first weight that neither bulk copy takes (250 x 25 floats: 25,000 bytes), so the kernel's own cp.async,
    # each of a step's two slots copied by one pair of the producer's warps; and one 4 bytes past an aligned address
    x, ws, bs = mlp_inputs((25, 250, 64), 8192, gen, dev)
    check("25x250x64 B=8192 (cp.async)", x, ws, bs)
    x, ws, bs = mlp_inputs(FLAGSHIP_DIMS, 8192, gen, dev)
    w0 = torch.empty(ws[0].numel() + 1, device=dev)[1:].view_as(ws[0])
    w0.copy_(ws[0])
    if fm.wgmma_copy_modes(x, [w0])[1] != 4:
        raise AssertionError("the shifted first weight was meant to take 4-byte copies")
    check("26x256x128x64 B=8192 (the first weight 4 bytes past an aligned address: cp.async)", x, [w0, *ws[1:]], bs)
    # bf16 and fp16 through fused_mlp and the registered operator: x's dtype back, the kernel's values on float32
    # copies cast back, one wgmma launch a call
    x, ws, bs = mlp_inputs(FLAGSHIP_DIMS, 8192, gen, dev)
    for dtype in (torch.bfloat16, torch.float16):
        xh, wh, bh = x.to(dtype), [w.to(dtype) for w in ws], [b.to(dtype) for b in bs]
        want = fm.fused_mlp_cuda(xh.float(), [w.float() for w in wh], [b.float() for b in bh], "elu").to(dtype)
        before = fm.fused_mlp_wgmma_launches
        with torch.no_grad():
            eager = fm.fused_mlp(xh, wh, bh, "elu")
            op = fm.fused_mlp_op(xh, list(wh), list(bh), "elu")
        torch.cuda.synchronize()
        made = fm.fused_mlp_wgmma_launches - before
        same = eager.dtype == op.dtype == dtype and torch.equal(eager, want) and torch.equal(op, want)
        print(f"[kernels] fused_mlp wgmma 26x256x128x64 B=8192 {dtype} x and weights: {made} wgmma launches in the "
              f"eager call and the operator's, outputs {eager.dtype} / {op.dtype}, equal to the kernel on float32 "
              f"copies cast back: {same}")
        if not (same and made == 2):
            raise AssertionError(f"fused_mlp wgmma on {dtype}: {made} wgmma launches, equal {same}")
    main = rows[0]
    return {"name": "fused_mlp_wgmma_kernel", "route": "cuda", "source": "rl_games_tpu_torch/csrc/fused_mlp.cu",
            "replaces": "rl_games_tpu/ops/fused_mlp.py:112 (_fused_kernel, pallas_call at :170): its held launches "
                        "over many rows (ops/fused_mlp.wgmma_plan)",
            "shape": main["shape"], "max_abs_err": worst, "max_err_over_tolerance": worst_ratio, "checked": checked,
            "ms": main["ms"], "held_ms": main["held_ms"], "plain_ms": main["plain_ms"], "floor_ms": main["floor_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "share_of_bound": main["share_of_bound"],
            "host_us": main["host_us"], "held_host_us": main["held_host_us"], "library_ms": None,
            "library_note": "no single PyTorch call computes the chain; plain_ms is addmm + activation per layer",
            "min_rows": fm.WGMMA_MIN_ROWS, "cluster": fm.WGMMA_CLUSTER, "slots": fm.WGMMA_SLOTS,
            "wgmma_shapes": rows}


def wgmma_launches_expected(dims, batches: dict) -> int:
    """The wgmma kernel's launches that calls of fused_mlp_cuda over the
    chain ``dims`` at these batches ({batch: calls}) make, as launch_plan
    plans them."""
    from rl_games_tpu_torch.ops import fused_mlp as fm

    return sum(calls * sum(p.wgmma is not None for p in fm.launch_plan(dims, batch))
               for batch, calls in batches.items())


# each main path's launches of the wgmma kernel ({path: {run: count}}), for the kernels line
WGMMA_PATH_LAUNCHES = {}


def check_wgmma_launches(tag, dims, runs: dict) -> dict:
    """Each run's wgmma launches ({name: (counted, {batch: calls})}) against
    wgmma_launches_expected; prints them, keeps them for the kernels line
    and returns the counts."""
    from rl_games_tpu_torch.ops import fused_mlp as fm

    got = {name: counted for name, (counted, _) in runs.items()}
    want = {name: wgmma_launches_expected(dims, batches) for name, (_, batches) in runs.items()}
    print(f"[{tag}] launches of the wgmma kernel: " + ", ".join(f"{name} {n}" for name, n in got.items())
          + f" ({'x'.join(map(str, dims[:4]))}{'...' if len(dims) > 4 else ''}; launch_plan takes it from "
          f"B = {fm.WGMMA_MIN_ROWS})")
    if got != want:
        raise AssertionError(f"{tag}: wgmma kernel launches {got}, expected {want} from the batches")
    WGMMA_PATH_LAUNCHES[tag] = got
    return got


def grouped_inputs(dims, groups, batch, gen, device):
    """G weight sets at mlp_inputs' scales: x [G, B, D_0], weights
    [G, out, in], biases [G, out]."""
    f32 = dict(dtype=torch.float32, device=device)
    ws = [(torch.rand((groups, dims[i + 1], dims[i]), generator=gen, **f32) * 2 - 1) / math.sqrt(dims[i])
          for i in range(len(dims) - 1)]
    bs = [torch.randn((groups, dims[i + 1]), generator=gen, **f32) * 0.1 for i in range(len(dims) - 1)]
    return torch.randn((groups, batch, dims[0]), generator=gen, **f32), ws, bs


def check_grouped(tag, x, ws, bs, activation):
    """The grouped launch against plain_mlp_grouped on the same inputs at
    rtol = atol = 2e-5; returns (max abs error, its share of the tolerance)."""
    from rl_games_tpu_torch.ops import fused_mlp as fm

    got = fm.fused_mlp_grouped_cuda(x, ws, bs, activation)
    want = fm.plain_mlp_grouped(x, ws, bs, activation)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    err = float(diff.max())
    ratio = float((diff / (2e-5 + 2e-5 * want.abs())).max())
    print(f"[kernels] fused_mlp grouped {tag} {activation}: max |kernel - plain| = {err:.3e} "
          f"({ratio:.3f} of the tolerance)")
    if not (math.isfinite(ratio) and ratio <= 1.0):
        raise AssertionError(f"grouped fused_mlp disagrees with plain_mlp_grouped at {tag}, {activation}: "
                             f"max abs {err}, {ratio} of rtol = atol = 2e-5")
    return err, ratio


def time_fused_grouped(tag, x, ws, bs, activation="elu"):
    """Device time of the grouped launch and of plain_mlp_grouped in turns
    (plain, kernel, kernel, plain), beside the bound: each tensor read once
    (a shared one once), the output written once, against 3xTF32 products."""
    from rl_games_tpu_torch.ops import fused_mlp as fm

    groups, dims = fm.grouped_dims(x, ws, bs)
    batch = x.shape[-2]
    kernel = lambda: fm.fused_mlp_grouped_cuda(x, ws, bs, activation)  # noqa: E731
    plain = lambda: fm.plain_mlp_grouped(x, ws, bs, activation)  # noqa: E731
    plain_a, plain_n = device_time_ms(plain, 50)
    kernel_a, kernel_n = device_time_ms(kernel, 50)
    kernel_b, _ = device_time_ms(kernel, 50)
    plain_b, _ = device_time_ms(plain, 50)
    kernel_ms, plain_ms = (kernel_a + kernel_b) / 2, (plain_a + plain_b) / 2
    flops = 3 * 2 * groups * batch * sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))
    nbytes = 4 * (x.numel() + sum(t.numel() for t in (*ws, *bs)) + groups * batch * dims[-1])
    bound, bound_by = bound_ms(nbytes, flops, PEAK_TF32_FLOPS)
    print(f"[kernels] fused_mlp grouped {tag} ({'x'.join(map(str, dims))} {activation}, G={groups}, B={batch}) "
          f"device time: kernel {kernel_ms * 1e3:.2f} us ({kernel_n:.0f} kernel/call), plain {plain_ms * 1e3:.2f} us "
          f"({plain_n:.0f} kernels/call); bound {bound * 1e3:.2f} us ({nbytes} B, {flops} TF32 flop, by {bound_by}); "
          f"kernel at {bound / kernel_ms:.3f} of the bound's rate")
    return {"shape": [groups, batch, *dims], "activation": activation, "ms": kernel_ms, "plain_ms": plain_ms,
            "plain_kernels": plain_n, "bound_ms": bound, "bound_by": bound_by, "share_of_bound": bound / kernel_ms}


def set_strided(t, stride, offset=0):
    """t [G, ...] copied into a buffer whose sets lie ``stride`` floats apart
    from ``offset`` on, each set's rows contiguous."""
    buf = torch.zeros(offset + stride * t.shape[0], dtype=t.dtype, device=t.device)
    out = buf.as_strided(t.shape, (stride, *t[0].stride()), offset)
    out.copy_(t)
    return out


def kernel_us_cold(fn, name, write: bool, reps: int = 20, sessions: int = 4) -> float:
    """Mean device time (us) of the kernels whose profiler name holds
    ``name`` that fn() launches, each call after 128 MB that evict the
    card's 50 MB L2 cache pass through it (their own kernels not counted):
    fn's inputs then come from device memory, as a first call finds them.
    With ``write`` the 128 MB are written, and the kernel's reads meet the
    write-back of their dirty lines; else read (a sum), and the lines they
    leave are clean. Takes the first of ``sessions`` profiler sessions that
    kept one such event a call, else the fullest (over the events it kept)."""
    scratch = torch.ones(32 << 20, device="cuda")

    def cold():
        if write:
            scratch.fill_(1.0)
        else:
            scratch.sum()
        fn()

    cold()
    torch.cuda.synchronize()
    fullest = []
    for _ in range(sessions):
        events = [e for e in device_events(cold, reps) if name in e.name]
        if len(events) == reps:
            fullest = events
            break
        fullest = max(fullest, events, key=len)
    if not fullest:
        raise AssertionError(f"no device event of {name} in {sessions} profiler sessions")
    return sum(e.time_range.elapsed_us() for e in fullest) / len(fullest)


def sets_cases(gen, dev):
    """The grouped shapes that kernel_fused_mlp_grouped and
    kernel_fused_mlp_sets check, on the same tensors: (tag, x, ws, bs,
    activations). The forage opponents at G = 1024 and 512, B = 1; a
    layer's weights, x or the biases shared at G = 64, B = 3; the 6 -> 7 ->
    5 sets of 42 and 35 floats; the skewed 4x4x8 strides at B = 5 (last)."""
    cases = []
    for groups in (1024, 512):
        cases.append((f"forage opponents G={groups} B=1", *grouped_inputs(FORAGE_DIMS, groups, 1, gen, dev), ("elu",)))
    x, ws, bs = grouped_inputs(FORAGE_DIMS, 64, 3, gen, dev)
    cases += [("ws[0] shared G=64 B=3", x, [ws[0][0], ws[1]], bs, ("elu",)),
              ("x shared G=64 B=3", x[0], ws, bs, ("elu",)),
              ("biases shared G=64 B=3", x, ws, [b[0] for b in bs], ("elu",))]
    x, ws, bs = grouped_inputs((6, 7, 5), 9, 3, gen, dev)
    cases.append(("6x7x5 (sets of 42 and 35 floats) G=9 B=3", x, ws, bs, ("elu", "tanh")))
    x, ws, bs = grouped_inputs((4, 4, 8), 9, 5, gen, dev)
    cases.append(("4x4x8 set strides 21 (x) and 17 (ws[0]) floats, ws[1] one float off G=9 B=5", set_strided(x, 5 * 4 + 1),
                  [set_strided(ws[0], 17), set_strided(ws[1], 8 * 4, offset=1)], bs, ("elu", "relu")))
    return cases


def kernel_fused_mlp_grouped(gen, dev, cases):
    """The grouped launch (the held kernel, a weight set a row of blocks, or
    the sets kernel where grouped_launch_plan takes it) against
    plain_mlp_grouped at rtol = atol = 2e-5 at every shape of ``cases``
    (sets_cases: the forage opponents' chain at G = 1024 and 512, half the
    slots as after a push, B = 1, timed; a layer's weights, x or the biases
    shared (set stride 0); set strides that break the 16-byte alignment of a
    set's rows: a 6 -> 7 layer's 42 floats, a 4-wide layer's sets 17 floats
    apart, x's rows one float past a multiple of 4, a weight whose base lies
    one float past an aligned address), and the JAX package's kernel test
    shapes at G = 3, B = 19 over every activation; G = 1 against the
    ordinary launch of the held kernel bit for bit; the refusals."""
    from rl_games_tpu_torch.ops import fused_mlp as fm

    worst, worst_ratio, timed = 0.0, 0.0, []

    def check(tag, x, ws, bs, activations=("elu",)):
        nonlocal worst, worst_ratio
        for activation in activations:
            err, ratio = check_grouped(tag, x, ws, bs, activation)
            worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)

    for tag, x, ws, bs, activations in cases:
        check(tag, x, ws, bs, activations)
        if tag.startswith("forage opponents"):
            timed.append(time_fused_grouped("forage opponents", x, ws, bs))
    _, skewed_x, (skewed_w0, skewed_w1), _, _ = cases[-1]
    if skewed_x.stride(0) % 4 == 0 or skewed_w0.stride(0) % 4 == 0 or skewed_w1.data_ptr() % 16 == 0:
        raise AssertionError("the skewed sets were meant to break 16-byte alignment")
    x, ws, bs = grouped_inputs((37, 50, 33, 7), 3, 19, gen, dev)
    check("37x50x33x7 G=3 B=19", x, ws, bs, ACTIVATIONS)

    # G = 1: the grouped entry is the ordinary launch of the held kernel (where the ordinary route takes the
    # wgmma kernel, as at the flagship's 8192 rows, the held kernel handed the same launches), bit for bit
    for dims, batch in ((FLAGSHIP_DIMS, 8192), ((37, 50, 33, 7), 19)):
        x, ws, bs = mlp_inputs(dims, batch, gen, dev)
        one = fm.fused_mlp_grouped_cuda(x[None], [w[None] for w in ws], [b[None] for b in bs], "elu")[0]
        ordinary = torch.empty((batch, dims[-1]), device=dev)
        fm._run_chain(x, ordinary, batch, list(dims), ws, bs, fm.ACTIVATION_CODES["elu"],
                      [p._replace(wgmma=None) for p in fm.launch_plan(dims, batch)])
        same = torch.equal(one, ordinary)
        print(f"[kernels] fused_mlp grouped G=1 {'x'.join(map(str, dims))} B={batch}: bit for bit the ordinary "
              f"launch of the held kernel {same}")
        if not same:
            raise AssertionError(f"the grouped launch at G = 1 differs from the ordinary one at {dims}, B={batch}")

    # refusals: nothing falls back
    x, ws, bs = grouped_inputs(FORAGE_DIMS, 4, 1, gen, dev)
    many = fm.MAX_GROUPS + 1  # one set expanded: no memory
    bad = (((x.cpu(), [w.cpu() for w in ws], [b.cpu() for b in bs]), ValueError),
           ((x.double(), ws, bs), TypeError),
           ((x[0].expand(many, 1, FORAGE_DIMS[0]), [ws[0][0].expand(many, 128, 6), ws[1][0]], [b[0] for b in bs]),
            ValueError))
    for args, exc in bad:
        try:
            fm.fused_mlp_grouped_cuda(*args, "elu")
        except exc:
            continue
        raise AssertionError("fused_mlp_grouped_cuda took an input it must refuse")
    return {"grouped_shapes": timed, "grouped_max_abs_err": worst, "grouped_max_err_over_tolerance": worst_ratio,
            "grouped_g1_bit_for_bit": True}


def kernel_fused_mlp_sets(cases):
    """The sets kernel (csrc/fused_mlp.cu fused_mlp_sets_kernel) at every
    shape of ``cases`` (sets_cases) that grouped_launch_plan sends to it, through
    fused_mlp_grouped_cuda: against plain_mlp_grouped at rtol = atol = 2e-5,
    two calls bit for bit, its launches counted (at a shape the route leaves
    to the held kernel, the same checks through a Launch with a sets plan
    handed to _run_chain, untimed); then timed in turns (plain,
    held, sets, sets, held, plain) beside the held grouped launch on the same
    inputs (the plan's launches with the sets plan taken out, handed to
    _run_chain), an empty launch of its grid and shared memory, and the
    bound: each tensor read once (a shared one once), the output written
    once, against the chain's float32 FMAs on the CUDA cores; and the sets
    and held kernels each with the L2 cache emptied before every call, by a
    read and by a write of 128 MB (kernel_us_cold)."""
    from rl_games_tpu_torch.ops import fused_mlp as fm

    rows, worst, worst_ratio = [], 0.0, 0.0
    for tag, x, ws, bs, activations in cases:
        dev = x.device
        groups, dims = fm.grouped_dims(x, ws, bs)
        batch = x.shape[-2]
        held_out = torch.empty((groups, batch, dims[-1]), device=dev)
        strides = fm.grouped_set_strides(x, ws, bs, held_out)
        launches = fm.grouped_launch_plan(dims, batch, groups, fm.set_strides_shared(strides))
        routed = [launch.sets for launch in launches if launch.sets is not None]
        held_launches = [launch._replace(sets=None) for launch in launches]
        if not routed:
            # a shape the route leaves to the held kernel: the sets kernel held to the chain there all the same,
            # through a Launch with the sets plan's stages and warps handed to _run_chain (its copy modes)
            plan = fm.SetsPlan(next(r for r in fm.SETS_ROWS if r >= batch), fm.SETS_STAGES, fm.sets_warps(fm.SETS_STAGES),
                               fm.sets_shared_bytes(dims, batch, fm.SETS_STAGES, fm.set_strides_shared(strides),
                                                    fm.sets_warps(fm.SETS_STAGES)))
            forced = [launch._replace(sets=plan) for launch in held_launches]
            # the bound of the held grouped launch that keeps the shape: each tensor read once (a shared one once),
            # the output written once, against its 3xTF32 products
            bound, bound_by = bound_ms(4 * (x.numel() + sum(t.numel() for t in (*ws, *bs)) + held_out.numel()),
                                       3 * 2 * groups * batch * sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1)),
                                       PEAK_TF32_FLOPS)
            print(f"[kernels] fused_mlp sets {tag}: kept held; the held grouped launch's bound {bound * 1e3:.4f} us "
                  f"(by {bound_by})")
            for activation in activations:
                run = lambda: fm._run_chain(x, held_out, batch, dims, ws, bs, fm.ACTIVATION_CODES[activation],  # noqa: E731
                                            forced, groups, strides)
                run()
                got = held_out.clone()
                run()
                want = fm.plain_mlp_grouped(x, ws, bs, activation)
                torch.cuda.synchronize()
                diff = (got - want).abs()
                err, ratio = float(diff.max()), float((diff / (2e-5 + 2e-5 * want.abs())).max())
                same = torch.equal(got, held_out)
                print(f"[kernels] fused_mlp sets {tag} {activation}: the plan keeps the held kernel; the sets kernel "
                      f"handed the shape ({plan.rows}-row instance, {plan.stages} stages, {plan.warps} warps a set): "
                      f"max |kernel - plain| {err:.3e} ({ratio:.3f} of the tolerance), two calls bit for bit equal "
                      f"{same}")
                if not (math.isfinite(ratio) and ratio <= 1.0 and same):
                    raise AssertionError(f"fused_mlp sets {tag} {activation} (not routed): {ratio} of rtol = atol = "
                                         f"2e-5 from plain_mlp_grouped, two calls equal {same}")
                worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
            continue
        for activation in activations:
            act = fm.ACTIVATION_CODES[activation]
            sets = lambda: fm.fused_mlp_grouped_cuda(x, ws, bs, activation)  # noqa: E731
            held = lambda: fm._run_chain(x, held_out, batch, dims, ws, bs, act, held_launches, groups, strides)  # noqa: E731
            plain = lambda: fm.plain_mlp_grouped(x, ws, bs, activation)  # noqa: E731
            before = fm.fused_mlp_sets_launches
            got = sets()
            torch.cuda.synchronize()
            launches_per_call = fm.fused_mlp_sets_launches - before
            again = sets()
            want = plain()
            torch.cuda.synchronize()
            diff = (got - want).abs()
            err, ratio = float(diff.max()), float((diff / (2e-5 + 2e-5 * want.abs())).max())
            same = torch.equal(got, again)
            if not (math.isfinite(ratio) and ratio <= 1.0 and same and launches_per_call == len(routed)):
                raise AssertionError(f"fused_mlp sets {tag} {activation}: {ratio} of rtol = atol = 2e-5 from "
                                     f"plain_mlp_grouped, two calls equal {same}, {launches_per_call} sets launches "
                                     f"(plan {routed})")
            worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
            if activation != activations[0]:
                print(f"[kernels] fused_mlp sets {tag} {activation}: max |kernel - plain| {err:.3e} ({ratio:.3f} of "
                      f"the tolerance), two calls bit for bit equal {same}")
                continue
            turns = (("plain", plain), ("held", held), ("sets", sets))
            times = {key: [] for key, _ in turns}
            for key, fn in (*turns, *reversed(turns)):
                times[key].append(device_time_ms(fn, 20)[0])
            ms = {key: sum(t) / len(t) for key, t in times.items()}
            plan = routed[0]
            floor_ms = device_time_ms(lambda: fm.sets_empty_launch(plan, groups), 20)[0]
            # the same two launches with the L2 cache emptied before each, by a read and by a write (the timings
            # above repeat calls on the same inputs, which the 50 MB L2 partly keeps: 37.8 MB at G = 1024)
            cold_us = {f"{key}_{way}": kernel_us_cold(fn, name, way == "write")
                       for way in ("read", "write")
                       for key, fn, name in (("sets", sets, "fused_mlp_sets_kernel"), ("held", held, "fused_mlp_kernel<"))}
            grid = fm.sets_grid(plan, groups)
            flops = 2 * groups * batch * sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))
            nbytes = 4 * (x.numel() + sum(t.numel() for t in (*ws, *bs)) + groups * batch * dims[-1])
            bound, bound_by = bound_ms(nbytes, flops)
            print(f"[kernels] fused_mlp sets {tag} {activation}: the sets kernel ({plan.rows}-row instance, "
                  f"{plan.stages} stages, {plan.warps} warps a set, grid {grid}, {plan.shared} B shared) {ms['sets'] * 1e3:.2f} us, the held "
                  f"grouped launch {ms['held'] * 1e3:.2f} us ({ms['sets'] / ms['held']:.3f}x), empty launch of its "
                  f"grid {floor_ms * 1e3:.2f} us, plain {ms['plain'] * 1e3:.2f} us; after a read of 128 MB the sets "
                  f"kernel {cold_us['sets_read']:.2f} us, the held {cold_us['held_read']:.2f} us, after a write of "
                  f"128 MB {cold_us['sets_write']:.2f} / {cold_us['held_write']:.2f} us; bound {bound * 1e3:.2f} us "
                  f"({nbytes} B, {flops} float32 flop, by {bound_by}): {bound / ms['sets']:.3f} of the bound's rate; "
                  f"max |kernel - plain| {err:.3e} ({ratio:.3f} of the tolerance), two calls bit for bit equal "
                  f"{same}, {launches_per_call} sets launch a call")
            rows.append({"tag": tag, "shape": [groups, batch, *dims], "activation": activation, "rows": plan.rows,
                         "stages": plan.stages, "warps": plan.warps, "grid": grid, "shared": plan.shared, "ms": ms["sets"],
                         "held_ms": ms["held"], "plain_ms": ms["plain"], "floor_ms": floor_ms,
                         **{f"cold_{key}_ms": us / 1e3 for key, us in cold_us.items()}, "bound_ms": bound,
                         "bound_by": bound_by, "share_of_bound": bound / ms["sets"], "max_abs_err": err,
                         "err_over_tolerance": ratio, "launches_per_call": launches_per_call})
    if not rows or not rows[0]["tag"].startswith("forage opponents G=1024"):
        raise AssertionError("the sets kernel does not take the forage opponents at G = 1024, B = 1")
    main = rows[0]
    return {"name": "fused_mlp_sets_kernel", "route": "cuda", "source": "rl_games_tpu_torch/csrc/fused_mlp.cu",
            "replaces": "rl_games_tpu/ops/fused_mlp.py:112 (_fused_kernel, pallas_call at :170) under jax.vmap over "
                        "stacked weights (rl_games_tpu/envs/jax/selfplay.py:148-162)",
            "shape": main["shape"], "max_abs_err": worst, "max_err_over_tolerance": worst_ratio, "ms": main["ms"],
            "held_ms": main["held_ms"], "plain_ms": main["plain_ms"], "floor_ms": main["floor_ms"],
            **{key: main[key] for key in main if key.startswith("cold_")},
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "share_of_bound": main["share_of_bound"],
            "library_ms": None,
            "library_note": "no single PyTorch call computes the chain; plain_ms is baddbmm + activation per layer",
            "sets_max_rows": fm.SETS_MAX_ROWS, "sets_stages": fm.SETS_STAGES, "sets_warps": fm.SETS_WARPS,
            "sets_shapes": rows}


# the nature-CNN torso (ppo_pong_device.yaml, ppo_breakout_device.yaml with mlp.fused: the conv stack's 7x7x64
# flatten into mlp [512] elu): one launch that streams its input
NATURE_DIMS = (3136, 512)
WIDE_DIMS = (64, 4096, 4096, 8)  # inner widths that no buffer holds: three launches
DEEP10_DIMS, DEEP17_DIMS = (256,) * 11, (256,) * 18  # 10 and 17 layers of 256: two and three launches


def exact_chain(x, ws, bs, activation):
    """The plain chain (plain_mlp, or plain_mlp_grouped for x [G, B, D])
    in float64 on the same inputs: the exact result to float32's grade. At
    3136 inputs of 30 the float32 chain misses it by most of the tolerance
    itself (0.83-0.95 on the CPU: tests/test_torch_port_fused_mlp.py), so
    the wide cases are held to it."""
    from rl_games_tpu_torch.ops import fused_mlp as fm

    plain = fm.plain_mlp if chain_plan(x, ws, bs)[0] is None else fm.plain_mlp_grouped
    return plain(x.double(), [w.double() for w in ws], [b.double() for b in bs], activation)


def tolerance_share(got, want) -> float:
    """The largest |got - want| over 2e-5 + 2e-5 |want|: at most 1 within rtol = atol = 2e-5."""
    return float(((got.double() - want).abs() / (2e-5 + 2e-5 * want.abs())).max())


def chain_plan(x, ws, bs):
    """(G or None for an ordinary chain, the widths, B, launch_plan's
    launches) as fused_mlp_cuda or, for a grouped chain (x [G, B, D] or a
    weight [G, out, in]), fused_mlp_grouped_cuda plans them."""
    from rl_games_tpu_torch.ops import fused_mlp as fm

    batch = x.shape[-2]
    if x.dim() == 3 or any(w.dim() == 3 for w in ws):
        groups, dims = fm.grouped_dims(x, ws, bs)
        return groups, dims, batch, fm.launch_plan(dims, groups * batch if batch > 16 else 0, cluster=False)
    dims = [x.shape[1]] + [w.shape[0] for w in ws]
    return None, dims, batch, fm.launch_plan(dims, batch)


def check_wide(tag, run, x, ws, bs, activation, launches):
    """run() (a chain through the kernel) against exact_chain at
    rtol = atol = 2e-5, the float32 plain chain's own distance from it
    printed beside; the launches of the call held to ``launches``. Returns
    (max abs error, its share of the tolerance)."""
    from rl_games_tpu_torch.ops import fused_mlp as fm

    before = fm.fused_mlp_launches
    got = run()
    torch.cuda.synchronize()
    made = fm.fused_mlp_launches - before
    want = exact_chain(x, ws, bs, activation)
    plain = (fm.plain_mlp if chain_plan(x, ws, bs)[0] is None else fm.plain_mlp_grouped)(x, ws, bs, activation)
    err, share = float((got.double() - want).abs().max()), tolerance_share(got, want)
    print(f"[kernels] fused_mlp {tag} {activation}: {made} launches; max |kernel - exact| = {err:.3e} ({share:.3f} "
          f"of rtol = atol = 2e-5); the float32 plain chain {tolerance_share(plain, want):.3f}, kernel against it "
          f"{tolerance_share(got, plain.double()):.3f}")
    if made != launches or not (math.isfinite(share) and share <= 1.0):
        raise AssertionError(f"fused_mlp {tag} {activation}: {made} launches (expected {launches}), "
                             f"{share} of rtol = atol = 2e-5 from the exact chain")
    return err, share


def time_wide(tag, x, ws, bs, activation="elu"):
    """Device time of the chain through the kernel (fused_mlp_cuda, or
    fused_mlp_grouped_cuda for x [G, B, D]) and of the float32 plain chain
    in turns (plain, kernel, kernel, plain); for a one-layer chain also
    torch.addmm of the same product alone (the library's call); beside the
    bound: each input read once and the output written once, against the
    3xTF32 products. Launches a call from the launch counter."""
    from rl_games_tpu_torch.ops import fused_mlp as fm

    groups, dims, batch, plan = chain_plan(x, ws, bs)
    grouped = groups is not None
    groups = groups or 1
    shapes = launch_shapes_of(x, ws, plan, groups, batch)
    cuda, plain_fn = (fm.fused_mlp_grouped_cuda, fm.plain_mlp_grouped) if grouped else (fm.fused_mlp_cuda, fm.plain_mlp)
    kernel, plain = (lambda: cuda(x, ws, bs, activation)), (lambda: plain_fn(x, ws, bs, activation))
    before = fm.fused_mlp_launches
    kernel()
    launches = fm.fused_mlp_launches - before
    plain_a, plain_n = device_time_ms(plain, 20)
    kernel_a, kernel_n = device_time_ms(kernel, 20)
    kernel_b, _ = device_time_ms(kernel, 20)
    plain_b, _ = device_time_ms(plain, 20)
    kernel_ms, plain_ms = (kernel_a + kernel_b) / 2, (plain_a + plain_b) / 2
    library_ms = None
    if len(ws) == 1 and not grouped:
        w, b = ws[0], bs[0]
        library_ms, _ = device_time_ms(lambda: torch.addmm(b, x, w.t()), 20)
    flops = 3 * 2 * groups * batch * sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))
    nbytes = 4 * (x.numel() + sum(t.numel() for t in (*ws, *bs)) + groups * batch * dims[-1])
    bound, bound_by = bound_ms(nbytes, flops, PEAK_TF32_FLOPS)
    print(f"[kernels] fused_mlp {tag} ({len(dims) - 1} layers {dims[0]}->...->{dims[-1]}, G={groups}, B={batch}, "
          f"{activation}) device time: kernel {kernel_ms * 1e3:.2f} us ({launches} launches, {kernel_n} kernels/call; "
          f"launches {'; '.join(describe_launch(d) for d in shapes)}), plain {plain_ms * 1e3:.2f} us "
          f"({plain_n} kernels/call)" + (f", addmm {library_ms * 1e3:.2f} us" if library_ms is not None else "")
          + f"; bound {bound * 1e3:.2f} us ({flops} TF32 flop, {nbytes} B, by {bound_by}); kernel at "
          f"{bound / kernel_ms:.3f} of the bound's rate")
    return {"tag": tag, "shape": [groups, batch, *dims] if grouped else [batch, *dims], "activation": activation,
            "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms, "launches_per_call": launches,
            "launch_shapes": shapes, "bound_ms": bound, "bound_by": bound_by, "share_of_bound": bound / kernel_ms}


def launch_shapes_of(x, ws, plan, groups, batch):
    """Each launch of ``plan`` (launch_plan's, over ``groups`` sets of
    ``batch`` rows of x and the weights ws) as the wrapper makes it: its
    layers, rows a block and shared bytes; a streamed one's split (blocks a
    row tile's outputs go to), cluster, grid, the clusters the card holds at
    once and so its waves, and the copy mode of x and W (x is the chain's
    own for the first launch, else the contiguous scratch between launches);
    a held launch run as the cluster kernel its cluster and grid."""
    from rl_games_tpu_torch.ops import fused_mlp as fm

    shapes = []
    for p in plan:
        shape = {"layers": [p.first, p.last], "streamed": p.streamed, "rows": p.plan[0], "shared": p.plan[3]}
        if p.cluster is not None:
            shape.update(cluster_kernel=True, cluster=p.cluster.cluster, grid=[fm.cluster_grid(p.cluster, batch), 1],
                         rows=16, shared=p.cluster.shared)
        if p.wgmma is not None:
            shape.update(wgmma_kernel=True, cluster=p.wgmma.cluster, slots=p.wgmma.slots,
                         grid=[fm.wgmma_grid(p.wgmma, batch), 1], rows=fm.WGMMA_ROWS, shared=p.wgmma.shared)
        if p.streamed:
            grid = fm.stream_grid(p.plan, batch, groups)
            w = ws[p.first]
            x_in = x if p.first == 0 else torch.empty((groups, batch, w.shape[-1]), device=x.device)
            x_set = x_in.stride(0) if x_in.dim() == 3 else 0
            w_set = w.stride(0) if w.dim() == 3 else 0
            clusters = fm.stream_clusters(p.plan.rows, p.plan.cluster)
            shape.update(split=p.plan.split, cluster=p.plan.cluster, grid=list(grid), clusters_at_once=clusters,
                         waves=grid[0] * grid[1] / (clusters * p.plan.cluster) if clusters > 0 else None,
                         copy=fm.stream_copy_name(fm.stream_copy(x_in, w, x_set, w_set)))
        shapes.append(shape)
    return shapes


def describe_launch(d) -> str:
    """A launch_shapes_of entry in words."""
    kind = ("streamed" if d["streamed"] else "held, the cluster kernel" if d.get("cluster_kernel")
            else "held, the wgmma kernel" if d.get("wgmma_kernel") else "held")
    text = f"layers {d['layers'][0]}-{d['layers'][1]} {kind}, {d['rows']} rows a block"
    if d.get("cluster_kernel"):
        text += f", clusters of {d['cluster']} (grid {d['grid'][0]})"
    if d.get("wgmma_kernel"):
        text += f", clusters of {d['cluster']}, {d['slots']} slots (grid {d['grid'][0]})"
    if d["streamed"]:
        waves = f"{d['waves']:.2f}" if d["waves"] is not None else "not known"
        text += (f", outputs split over {d['split']} blocks, clusters of {d['cluster']}, grid {d['grid'][0]}x"
                 f"{d['grid'][1]} ({d['clusters_at_once']} clusters at once: {waves} waves), {d['copy']}")
    return text + f", {d['shared']} B shared"


def kernel_fused_mlp_wide(gen, dev):
    """The chains that one launch with x held does not take, against the
    exact chain at rtol = atol = 2e-5, each call's launches held to
    launch_plan's: the nature-CNN torso 3136 -> 512 (one launch that
    streams its input) at the rollout's B = 512, the minibatch's 4096 and a
    ragged 4099, at the init scale and with x * 30, elu and tanh; 3134 and
    3135 inputs (rows that take 8- and 4-byte copies); (64, 4096, 4096, 8)
    at B = 1024 (three launches: 4096 held by no buffer); 10 and 17 layers
    of 256 at B = 8192 (two and three launches); a deep chain and a 3136-wide
    one grouped over G = 4, one weight shared and the others per set; bf16
    and fp16 x through fused_mlp and the registered operator (x's dtype
    back, equal to the kernel on the float32-cast inputs cast back). Each
    shape timed (time_wide)."""
    from rl_games_tpu_torch.ops import fused_mlp as fm

    worst, worst_share, timed = 0.0, 0.0, []

    def check(tag, x, ws, bs, activations=("elu",)):
        nonlocal worst, worst_share
        groups, _, _, plan = chain_plan(x, ws, bs)
        cuda = fm.fused_mlp_grouped_cuda if groups is not None else fm.fused_mlp_cuda
        launches = len(plan)
        for activation in activations:
            run = lambda: cuda(x, ws, bs, activation)  # noqa: E731
            err, share = check_wide(tag, run, x, ws, bs, activation, launches)
            worst, worst_share = max(worst, err), max(worst_share, share)
            if any(p.streamed for p in plan):
                # no sum is split across blocks or left to an atomic: the same bits every call
                same = torch.equal(run(), run())
                print(f"[kernels] fused_mlp {tag} {activation}: two calls bit for bit equal: {same}")
                if not same:
                    raise AssertionError(f"fused_mlp {tag} {activation}: two calls on the same inputs differ")

    host = {}
    for batch in (512, 4096, 4099):
        x, ws, bs = mlp_inputs(NATURE_DIMS, batch, gen, dev)
        for x_scale in (1.0, 30.0):
            check(f"3136x512 B={batch}{'' if x_scale == 1 else ' (x * 30)'}", x * x_scale, ws, bs, ("elu", "tanh"))
        timed.append(time_wide("nature-CNN torso", x, ws, bs))
        if batch == 512:
            # the host's share of a streamed call (two tensor maps encoded a call) beside a held launch's (the
            # route every chain took before the streamed kernel: the flagship torso, B = 8192), in turns
            xf, wf, bf = mlp_inputs(FLAGSHIP_DIMS, 8192, gen, dev)
            calls = {"streamed 3136x512 B=512": lambda: fm.fused_mlp_cuda(x, ws, bs, "elu"),
                     "held 26x256x128x64 B=8192": lambda: fm.fused_mlp_cuda(xf, wf, bf, "elu")}
            times = {name: [] for name in calls}
            for name in (*calls, *reversed(calls)):
                times[name].append(host_us_per_call(calls[name]))
            host = {name: float(np.median(t)) for name, t in times.items()}
            print("[kernels] fused_mlp host time a call of fused_mlp_cuda (the enqueue alone, medians of 2 runs of "
                  "200 calls in turns): " + ", ".join(f"{name} {us:.2f} us" for name, us in host.items()))
    for dims in ((3134, 512), (3135, 512)):
        x, ws, bs = mlp_inputs(dims, 512, gen, dev)
        check(f"{dims[0]}x512 B=512 ({8 if dims[0] % 2 == 0 else 4}-byte copies of x)", x, ws, bs)
        timed.append(time_wide(f"{dims[0]} inputs", x, ws, bs))
    x, ws, bs = mlp_inputs(WIDE_DIMS, 1024, gen, dev)
    check("64x4096x4096x8 B=1024", x, ws, bs, ("elu", "tanh"))
    timed.append(time_wide("wide inner layers", x, ws, bs))
    for dims in (DEEP10_DIMS, DEEP17_DIMS):
        x, ws, bs = mlp_inputs(dims, 8192, gen, dev)
        check(f"{len(dims) - 1} layers of 256 B=8192", x, ws, bs, ("elu", "relu"))
        timed.append(time_wide(f"{len(dims) - 1} layers", x, ws, bs))
    # grouped: a deep chain with its first weight shared, the torso with its 3136-wide weight shared (the per-set
    # weight is a 512 -> 64 head)
    for dims, shared, tag in ((DEEP10_DIMS, 0, "deep"), (NATURE_DIMS + (64,), 0, "3136-wide")):
        x, ws, bs = grouped_inputs(dims, 4, 256, gen, dev)
        ws = [w[0] if i == shared else w for i, w in enumerate(ws)]
        check(f"grouped {tag} G=4 B=256, ws[{shared}] shared", x, ws, bs, ("elu", "tanh"))
        timed.append(time_wide(f"grouped {tag}", x, ws, bs))

    # inputs that are not float32 through fused_mlp (the eager route and the registered operator): x's dtype back,
    # the values those of the kernel on the float32-cast inputs
    for dims, batch in ((NATURE_DIMS, 512), (FLAGSHIP_DIMS, 8192)):
        x, ws, bs = mlp_inputs(dims, batch, gen, dev)
        for dtype in (torch.bfloat16, torch.float16):
            for params, kind in (((ws, bs), "float32 weights"),
                                 (([w.to(dtype) for w in ws], [b.to(dtype) for b in bs]), f"{dtype} weights")):
                xh, (wh, bh) = x.to(dtype), params
                want = fm.fused_mlp_cuda(xh.float(), [w.float() for w in wh], [b.float() for b in bh], "elu").to(dtype)
                with torch.no_grad():
                    eager = fm.fused_mlp(xh, wh, bh, "elu")
                    op = fm.fused_mlp_op(xh, list(wh), list(bh), "elu")
                torch.cuda.synchronize()
                same = eager.dtype == op.dtype == dtype and torch.equal(eager, want) and torch.equal(op, want)
                print(f"[kernels] fused_mlp {'x'.join(map(str, dims))} B={batch} {dtype} x, {kind}: output "
                      f"{eager.dtype} / {op.dtype} (eager / operator), equal to the kernel on float32 copies cast "
                      f"back: {same}")
                if not same:
                    raise AssertionError(f"fused_mlp on {dtype} x ({kind}) is not the float32 kernel cast back")
    return {"wide_shapes": timed, "wide_max_abs_err": worst, "wide_max_err_over_tolerance": worst_share,
            "host_us_per_call": host}


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
    # CartPole's relu torso at the player's, the rollout's and the minibatch's batch size
    shapes += [(CARTPOLE_DIMS, batch, 1.0, 1.0) for batch in (1, 16, 64)]
    # the host path's torso at the rollout's (and player's) and the minibatch's batch size
    shapes += [(HOPPER_DIMS, batch, 1.0, 1.0) for batch in (64, 2048)]
    # [heads] (d): ref/ppo_pendulum.yaml's trunks at the rollout's and the minibatch's batch size
    shapes += [(PENDULUM_DIMS, batch, 1.0, 1.0) for batch in (16, 1024)]
    # [rnn] (d): ref/ppo_walker_rnn.yaml's MLP in front of the GRU at the rollout's and the minibatch's batch size
    shapes += [(WALKER_DIMS, batch, 1.0, 1.0) for batch in (16, 2048)]
    # [selfplay] (f): benchruns/selfplay_forage.yaml's torso fused, the learner's rollout and minibatch batch size
    shapes += [(FORAGE_DIMS, batch, 1.0, 1.0) for batch in (1024, 8192)]
    # the flagship torso at an exported policy's batches (1, 7) and a player's 16: the cluster kernel
    shapes += [(FLAGSHIP_DIMS, batch, 1.0, 1.0) for batch in (1, 7, 16)]
    if fm.kernel_plan(FLAGSHIP_DIMS, 5001)[0] != 32:
        raise AssertionError("B = 5001 was chosen to take the 32-row blocks with a ragged last block")
    worst, worst_ratio = 0.0, 0.0
    # [rnn] (e): the flagship torso with bfloat16-rounded weights (mixed_precision)
    # at the rollout's and the minibatch's batch size
    shapes += [(FLAGSHIP_DIMS, batch, 1.0, "bf16") for batch in (8192, 32768)]
    for i, (dims, batch, x_scale, w_scale) in enumerate(shapes):
        x, ws, bs = mlp_inputs(dims, batch, gen, dev, bf16_weights=w_scale == "bf16")
        if w_scale != "bf16":
            x, ws = x * x_scale, [w * w_scale for w in ws]
        for activation in (ACTIVATIONS if i == 0 else ("relu",) if dims == CARTPOLE_DIMS else ("elu",)):
            got = fm.fused_mlp_cuda(x, ws, bs, activation)
            want = fm.plain_mlp(x, ws, bs, activation)
            torch.cuda.synchronize()
            diff = (got - want).abs()
            err = float(diff.max())
            ratio = float((diff / (2e-5 + 2e-5 * want.abs())).max())  # <= 1: rtol = atol = 2e-5
            scale = ("" if x_scale == w_scale == 1.0 else " (bfloat16-rounded weights)" if w_scale == "bf16"
                     else f" (x * {x_scale:g}, weights * {w_scale:g})")
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
    entry["other_shapes"] += [time_fused(CARTPOLE_DIMS, batch, gen, dev, "relu") for batch in (16, 64)]
    entry["other_shapes"] += [time_fused(HOPPER_DIMS, batch, gen, dev) for batch in (64, 2048)]
    entry["other_shapes"] += [time_fused(PENDULUM_DIMS, batch, gen, dev) for batch in (16, 1024)]
    entry["other_shapes"] += [time_fused(WALKER_DIMS, batch, gen, dev) for batch in (16, 2048)]
    entry["other_shapes"] += [time_fused(FLAGSHIP_DIMS, batch, gen, dev, bf16_weights=True) for batch in (8192, 32768)]
    # [selfplay] (f): the learner's fused chain at the rollout's and the minibatch's batch size
    entry["other_shapes"] += [time_fused(FORAGE_DIMS, batch, gen, dev) for batch in (1024, 8192)]
    # the cluster kernel at the main paths' small batches, beside the held kernel
    entry.update(kernel_fused_mlp_cluster(gen, dev))
    # the wgmma kernel at the main paths' large batches, beside the held kernel (its own entry on the kernels line)
    entry["wgmma_kernel"] = kernel_fused_mlp_wgmma(gen, dev)
    # the grouped launch: the self-play opponents' chain over every env's own weight set; then the sets kernel at
    # the grouped shapes it takes, beside the held grouped launch (its own entry on the kernels line)
    cases = sets_cases(gen, dev)
    entry.update(kernel_fused_mlp_grouped(gen, dev, cases))
    entry["sets_kernel"] = kernel_fused_mlp_sets(cases)
    del cases
    # the chains one launch with x held does not take: a streamed first layer, several launches, other dtypes
    entry.update(kernel_fused_mlp_wide(gen, dev))
    entry["max_abs_err"] = max(entry["max_abs_err"], entry["cluster_max_abs_err"], entry["grouped_max_abs_err"],
                               entry["wide_max_abs_err"])
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
        (launch,) = fm.launch_plan(FLAGSHIP_DIMS, batch)
        how = (f"the wgmma kernel, clusters of {launch.wgmma.cluster}, {launch.wgmma.slots} slots, "
               f"{launch.wgmma.shared} B shared" if launch.wgmma is not None
               else f"{launch.plan[0]} rows/block, {launch.plan[3]} B shared")
        print(f"[kernels] fused_mlp 26x256x128x64 B={batch} ({how}) device time: "
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

    print(f"[reference] Pong model cuda vs cpu: {pong_reference()}")
    reference_sac()
    reference_host_ppo()
    reference_heads()
    reference_rnn()
    reference_dict()
    reference_sac("sac_norm")
    reference_multiagent()


def pong_reference(fused: bool = False) -> str:
    """The Pong model (ppo_pong_device.yaml: nature-CNN, 84x84x2 frames;
    with ``fused`` its 3136 -> 512 torso through the fused kernel): its
    forward on 128 of its own rollout's frames, then one minibatch update of
    128, card against CPU from the same weights. The convolutions run in
    float32 on both (a TF32 convolution keeps about three digits and would
    show here). Returns a summary; raises on a disagreement."""
    from rl_games_tpu_torch.algos.ppo import PPOAgent

    params = load_config("ppo_pong_device.yaml")["params"]
    params["network"]["mlp"]["fused"] = fused
    params["config"].update(num_actors=16, horizon_length=8, minibatch_size=128, mini_epochs=1)
    gpu, cpu = PPOAgent("ref", params, device="cuda"), PPOAgent("ref", params, device="cpu")
    gstate, cstate = gpu.init_state(), cpu.init_state()
    cpu.model.load_state_dict({k: v.cpu() for k, v in gpu.model.state_dict().items()})
    traj, last_values = gpu._rollout(gstate)
    ctraj = {k: v.cpu() for k, v in traj.items()}
    obs, actions = traj["obses"].reshape(-1, 84, 84, 2), traj["actions"].reshape(-1)
    with torch.no_grad():
        got = gpu.model.forward_train(obs, actions)
        want = cpu.model.forward_train(obs.cpu(), actions.cpu())
    dlogits = float((got["logits"].cpu() - want["logits"]).abs().max())
    dvalue = float((got["values"].cpu() - want["values"]).abs().max())
    cstate.dones = gstate.dones.cpu()
    gds = gpu._prepare_dataset(gstate, traj, last_values)
    cds = cpu._prepare_dataset(cstate, ctraj, last_values.cpu())
    update = check_first_update(gpu, cpu, gstate, cstate, gds, cds)
    summary = (f"forward on 128 frames max |dlogits| {dlogits:.2e}, max |dvalue| {dvalue:.2e} (|logits| up to "
               f"{float(want['logits'].abs().max()):.1f}); one minibatch of 128: {update}")
    # forward: float32 sums of up to 3136 products, 1e-4 (a TF32 convolution
    # keeps about three digits: 1e-3 of the logits)
    if not (dlogits < 1e-4 and dvalue < 1e-4):
        raise AssertionError(f"the Pong model's forward on the card disagrees with the CPU: {summary}")
    return summary


def float64_gradients(agent, ds, state):
    """The first minibatch's loss gradients of a CPU agent in float64: its
    model cast to float64 and back (float32 values survive the round trip)
    and the minibatch's float tensors cast."""
    def cast(v):
        if isinstance(v, tuple):
            return tuple(cast(x) for x in v)
        if isinstance(v, dict):
            return {k: cast(x) for k, x in v.items()}
        return v.double() if torch.is_tensor(v) and v.is_floating_point() else v

    agent.model.double()
    try:
        loss = agent._loss_and_kl(cast(agent._minibatch(ds, 0)), state.entropy_coef)[0]
        return torch.autograd.grad(loss, agent.params, allow_unused=True, materialize_grads=True)
    finally:
        agent.model.float()


def float64_distance(grads, ref) -> float:
    """The largest distance of ``grads`` from the float64 gradients ``ref``,
    relative to each tensor's largest entry (tensors without a gradient
    left out)."""
    return max(float((g.cpu().double() - r).abs().max() / r.abs().max().clamp(min=1e-30))
               for g, r in zip(grads, ref) if r.any())


def check_first_update(gpu, cpu, gstate, cstate, gds, cds, float64_reference=False, min_far_share=0.5) -> str:
    """One Adam step of the first minibatch of the same dataset, card
    against CPU: the minibatch's gradients within 1e-5 of each tensor's
    largest entry (as the CPU tests hold them to the JAX package); the
    card's step, where |g| > 1e-5, within 1e-3 · lr of the step the card's
    own gradients call for (clipped to the global norm, weight decay, then
    lr · g / (|g| + eps) in float64: the moments' bias corrections cancel
    at step 1, and where |g| is far above eps the step is lr · sign(g) to
    within 1e-3 of lr whatever rounding g carries), on more than
    ``min_far_share`` (most) of the entries of the tensors the loss reaches
    (a central value net's actor has a value head without a gradient); the
    losses, means over the minibatch, within 2e-5 relative; float32 without
    TF32 on the card. With ``float64_reference`` the gradients are held to
    the CPU's float64 gradients instead: no tensor's card gradient further
    from them, relative to its largest entry, than the larger of 1e-5 and
    three times the CPU float32 gradients' worst such distance (another
    float32 summation order; the card measured 0.99-1.75 times the CPU's,
    PERF.md §6). Where gradients sum over hundreds of thousands
    of products (a deep conv tower) or cancel (a discrete policy's logit
    biases under normalized advantages), float32 keeps no 1e-5 of them on
    either device. Returns a summary; raises on a disagreement."""
    from rl_games_tpu_torch.algos.ppo import _ADAM_EPS

    for agent in (gpu, cpu):
        agent.mini_epochs_num = agent.num_minibatches = 1
    grads = [torch.autograd.grad(agent._loss_and_kl(agent._minibatch(ds, 0), state.entropy_coef)[0],
                                 agent.params, allow_unused=True, materialize_grads=True)
             for agent, ds, state in ((gpu, gds, gstate), (cpu, cds, cstate))]
    dgrad = max(float((g.cpu() - c).abs().max() / c.abs().max().clamp(min=1e-30)) for g, c in zip(*grads))
    grad_bound, f64_note = 1e-5, ""
    if float64_reference:
        ref = [r.double() for r in float64_gradients(cpu, cds, cstate)]
        dgrad, cpu_f32 = float64_distance(grads[0], ref), float64_distance(grads[1], ref)
        grad_bound = max(1e-5, 3 * cpu_f32)
        f64_note = (f" of the CPU's float64 gradients (the CPU's float32 gradients within {cpu_f32:.2e}, bound "
                    f"{grad_bound:.2e})")
    lr = float(gstate.lr)
    before = [p.detach().cpu().double() for p in gpu.params]
    gm, cm = gpu._update(gstate, gds), cpu._update(cstate, cds)
    g64 = [g.cpu().double() for g in grads[0]]
    norm = math.sqrt(sum(float((g * g).sum()) for g in g64))
    clip = gpu.grad_norm / norm if gpu.truncate_grads and norm >= gpu.grad_norm else 1.0
    g64 = [g * clip + gpu.weight_decay * p for g, p in zip(g64, before)]
    far = [g.abs() > 1e-5 for g in g64]
    dstep = max(float(torch.where(f, (p.detach().cpu().double() - b) - (-lr * g / (g.abs() + _ADAM_EPS)), 0.0)
                      .abs().max()) for p, b, g, f in zip(gpu.params, before, g64, far))
    # the entries of the tensors the loss reaches: with a central value net
    # the actor's value head (and its separate critic trunk) take none
    n_far, n_all = sum(int(f.sum()) for f in far), sum(f.numel() for f, g in zip(far, grads[1]) if g.any())
    csd = cpu.model.state_dict()
    dp = max(float((v.cpu().double() - csd[k].double()).abs().max()) for k, v in gpu.model.state_dict().items())
    # (with a central value net c_loss is 0 on both)
    dloss = {k: abs(float(gm[k]) - float(cm[k])) / max(abs(float(cm[k])), 1e-30) for k in ("a_loss", "c_loss")}
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    summary = (f"gradients within {dgrad:.2e} of each tensor's largest entry{f64_note} (global norm {norm:.4e}, "
               f"clipped by "
               f"{clip:.4e}); the card's Adam step against its own gradients' step where |g| > 1e-5 ({n_far} of "
               f"{n_all} entries of the tensors with a gradient): max |d| {dstep:.2e} = {dstep / lr:.2e} lr (lr {lr:.1e}); max |dparam| against "
               f"the CPU's update {dp:.2e}; a_loss {float(gm['a_loss']):.7f} / {float(cm['a_loss']):.7f}, c_loss "
               f"{float(gm['c_loss']):.7f} / {float(cm['c_loss']):.7f} (relative {dloss['a_loss']:.2e}, "
               f"{dloss['c_loss']:.2e}); Adam steps {int(gstate.opt_state.count)}; TF32 (matmul, cudnn) {tf32}")
    if tf32 != (False, False) or not (dgrad < grad_bound and int(gstate.opt_state.count) == 1
                                      and n_far > min_far_share * n_all and dstep < 1e-3 * lr
                                      and max(dloss.values()) < 2e-5):
        raise AssertionError(f"the update on the card disagrees with the CPU: {summary}")
    return summary


def host_ppo_params() -> dict:
    """rl_games_tpu/configs/ref/mujoco/halfcheetah.yaml as shipped (64 envs
    x horizon 256, MLP [128, 64, 32] elu, minibatch 2048, 5 mini-epochs,
    use_smooth_clamp, adaptive LR) with the env swapped: the card's machine
    has no MuJoCo, so HalfCheetah-v5 becomes the native stepper's
    Hopper2D-v0 (vecenv_type CPUENV), a planar hopper of 5 observations and
    2 actions with bounds [-1, 1]."""
    params = load_config("ref/mujoco/halfcheetah.yaml")["params"]
    params["config"].update(env_name="Hopper2D-v0", vecenv_type="CPUENV")
    return params


def reference_host_ppo():
    """One host PPO epoch at halfcheetah.yaml's geometry on Hopper2D, card
    against CPU: the same weights, the same CPUENV seed and the same action
    noise; the trajectories held to each other, then one Adam step of the
    first minibatch of the card's trajectory (``check_first_update``)."""
    from rl_games_tpu_torch.algos.ppo import PPOAgent
    from rl_games_tpu_torch.models import distributions as D

    params = host_ppo_params()
    params["config"]["host_inference_device"] = "default"
    gpu, cpu = PPOAgent("ref", params, device="cuda"), PPOAgent("ref", params, device="cpu")
    gstate, cstate = gpu.init_state(), cpu.init_state()
    cpu.model.load_state_dict({k: v.cpu() for k, v in gpu.model.state_dict().items()})
    noise = torch.randn((gpu.horizon_length, gpu.num_actors, gpu.actions_num),
                        generator=torch.Generator().manual_seed(8))
    sample = D.normal_sample
    trajs = []
    try:
        for agent, state in ((gpu, gstate), (cpu, cstate)):
            draws = iter(noise)
            D.normal_sample = lambda mean, std, generator=None: mean + std * next(draws).to(mean.device)
            trajs.append(agent._host_rollout(state))
    finally:
        D.normal_sample = sample
    (gtraj, glast), (ctraj, clast) = trajs
    diffs = {k: float((gtraj[k].cpu() - ctraj[k]).abs().max()) for k in gtraj if k != "dones"}
    diffs["last_values"] = float((glast.cpu() - clast).abs().max())
    same_dones = torch.equal(gtraj["dones"].cpu(), ctraj["dones"])
    games = (int(gstate.game_rewards.count), int(cstate.game_rewards.count))
    print(f"[reference] host PPO rollout (halfcheetah.yaml's geometry on Hopper2D-v0, {gpu.num_actors} envs x "
          f"{gpu.horizon_length} steps) cuda vs cpu, same weights, CPUENV seed and action noise: "
          + ", ".join(f"max |d{k}| {v:.2e}" for k, v in diffs.items())
          + f"; dones equal {same_dones}; games {games}")
    # the policy's float32 outputs in two summation orders, fed back through
    # 256 steps of the hopper's smooth flight and stance phases: 1e-4
    if not (same_dones and games[0] == games[1] and max(diffs.values()) < 1e-4):
        raise AssertionError("the host PPO rollout on the card disagrees with the CPU")
    cstate.dones = gstate.dones.cpu()
    gds = gpu._prepare_dataset(gstate, gtraj, glast)
    cds = cpu._prepare_dataset(cstate, {k: v.cpu() for k, v in gtraj.items()}, glast.cpu())
    print(f"[reference] host PPO update, the first minibatch of {gpu.minibatch_size} of the card's trajectory: "
          + check_first_update(gpu, cpu, gstate, cstate, gds, cds))


def reference_sac(tag: str = "sac"):
    """One SAC update (the critic, actor and α steps and the Polyak update)
    of sac_ant2d.yaml's networks on the card against the same update on the
    CPU: the same weights from a seed, a ring of 8192 rows and the
    normalizer fed with them, one batch of 2048 at the same indices, the
    same normals. Each Adam step's parameters and gradients are recorded as
    the update takes them. ``tag`` "sac_norm": the networks and config of
    ref/mujoco/sac_ant_tuned.yaml (separate layer-norm [256, 256] trunks, a
    batch of 256, no input normalizer) on the same Ant2D rows."""
    from rl_games_tpu_torch.algos import sac as sac_module
    from rl_games_tpu_torch.algos.ppo import _ADAM_EPS

    params = load_config("sac_ant2d.yaml")["params"]
    params["config"].update(num_actors=64, replay_buffer_size=8192)
    what = "sac_ant2d.yaml's networks"
    if tag == "sac_norm":
        tuned = load_config("ref/mujoco/sac_ant_tuned.yaml")["params"]
        params["network"] = tuned["network"]
        params["config"].update({k: tuned["config"][k] for k in (
            "batch_size", "normalize_input", "init_alpha", "alpha_lr", "actor_lr", "critic_lr", "critic_tau",
            "learnable_temperature", "policy_frequency", "gamma")})
        what = "sac_ant_tuned.yaml's layer-norm networks on Ant2D rows"
    gpu, cpu = sac_module.SACAgent("ref", params, device="cuda"), sac_module.SACAgent("ref", params, device="cpu")
    gstate, cstate = gpu.init_state(), cpu.init_state()
    for name in ("actor", "critic", "critic_target", "running_mean_std"):
        if getattr(gpu, name) is not None:
            getattr(cpu, name).load_state_dict({k: v.cpu() for k, v in getattr(gpu, name).state_dict().items()})
    gen = torch.Generator().manual_seed(6)
    n, batch = 8192, gpu.batch_size
    shift, scale = torch.randn(26, generator=gen), torch.rand(26, generator=gen) * 3 + 0.1
    obs = torch.randn((n, 26), generator=gen) * scale + shift
    rows = (obs, torch.rand((n, 8), generator=gen) * 2 - 1, torch.randn(n, generator=gen),
            obs + 0.1 * torch.randn((n, 26), generator=gen), torch.rand(n, generator=gen) < 0.05,
            torch.zeros(n, dtype=torch.bool))
    for agent, state in ((gpu, gstate), (cpu, cstate)):
        sac_module.replay_add(state.replay, *(x.to(agent.device) for x in rows))
        if agent.running_mean_std is not None:
            agent.running_mean_std.update_from_batch(obs.to(agent.device))
        state.update_counter = 1  # policy_frequency 2: this update runs the actor
    idx = torch.randint(0, n, (batch,), generator=gen)
    noise = [torch.randn((batch, 8), generator=gen) for _ in range(2)]

    # per update, per Adam step: (params before, gradients), in float64
    steps = {"cuda": [], "cpu": []}
    adam = sac_module.adam_step

    def recorded(params, grads, opt, lr, max_norm=None, weight_decay=0.0):
        recording.append(([p.detach().cpu().double() for p in params], [g.detach().cpu().double() for g in grads]))
        adam(params, grads, opt, lr, max_norm, weight_decay)

    sac_module.adam_step = recorded
    log_alpha_before = cstate.log_alpha.detach().clone()
    try:
        target_before = [p.detach().cpu().double() for p in gpu.critic_target.parameters()]
        recording = steps["cuda"]
        gm = gpu._update(gstate, idx.cuda(), *(x.cuda() for x in noise))
        recording = steps["cpu"]
        cm = cpu._update(cstate, idx, *noise)
    finally:
        sac_module.adam_step = adam
    keys = ("critic_loss", "critic1_loss", "critic2_loss", "actor_loss", "entropy", "alpha_loss")
    dloss = {k: abs(float(gm[k]) - float(cm[k])) / max(abs(float(cm[k])), 1e-6) for k in keys}
    # gradients of the critic, the actor and log α: card against CPU, each
    # tensor to 1e-5 of its largest entry
    dgrad = [max(float((g - c).abs().max() / c.abs().max().clamp(min=1e-30)) for g, c in zip(gs[1], cs[1]))
             for gs, cs in zip(steps["cuda"], steps["cpu"])]
    # the actor's float32 gradient against the same step in float64 on the
    # CPU: how far float32 itself is from the exact gradient. The log-prob's
    # (pre - mu) / std recovers std · noise from pre = mu + std · noise, so
    # where log_std_bounds reach -20 (sac_ant_tuned.yaml) an ulp of mu is
    # many ulps of the result, and two devices' reduction orders differ by
    # that much; the card may differ from the CPU by at most as much as the
    # CPU's float32 differs from float64 (and by 1e-5 where that is less)
    f32_err = actor_f32_error(cpu, steps["cpu"][1], rows[0][idx], noise[1], log_alpha_before)
    actor_tol = max(1e-5, f32_err) if tag == "sac_norm" else 1e-5
    # Adam's first step from the card's own gradients, in float64: the
    # critic's clipped to the global norm first; where |g| > 1e-5 the step
    # is lr * sign(g) to within 1e-3 of lr whatever rounding g carries
    worst, n_far, n_all = [], 0, 0
    for (before, grads), module_params, lr, max_norm in zip(
            steps["cuda"], (list(gpu.critic.parameters()), list(gpu.actor.parameters()), [gstate.log_alpha]),
            (gpu.critic_lr, gpu.actor_lr, gpu.alpha_lr), (gpu.critic_grad_clip, None, None)):
        norm = math.sqrt(sum(float((g * g).sum()) for g in grads))
        clip = max_norm / norm if max_norm is not None and norm >= max_norm else 1.0
        far_d = 0.0
        for p, b, g in zip(module_params, before, grads):
            g = g * clip
            far = g.abs() > 1e-5
            d = (p.detach().cpu().double() - b) - (-lr * g / (g.abs() + _ADAM_EPS))
            far_d = max(far_d, float(torch.where(far, d, 0.0).abs().max()) / lr)
            n_far, n_all = n_far + int(far.sum()), n_all + far.numel()
        worst.append(far_d)
    # the Polyak update against the card's own critic and target, to two
    # ulps of each tensor's largest entry; and against the CPU's target
    dtarget = max(float(((t.detach().cpu().double() - (b + gpu.critic_tau * (c.detach().cpu().double() - b))).abs()
                         / (t.detach().abs().max().cpu().double() * 2 ** -22).clamp(min=1e-30)).max())
                  for t, b, c in zip(gpu.critic_target.parameters(), target_before, gpu.critic.parameters()))
    dtarget_cpu = max(float((t.detach().cpu() - c).abs().max())
                      for t, c in zip(gpu.critic_target.parameters(), cpu.critic_target.parameters()))
    dalpha = abs(float(gstate.log_alpha) - float(cstate.log_alpha))
    print(f"[reference] {tag}: SAC update of {what}, batch {batch}, cuda vs cpu: losses "
          + ", ".join(f"{k} {float(gm[k]):.7f} / {float(cm[k]):.7f}" for k in keys)
          + f" (relative at most {max(dloss.values()):.2e}); gradients within {dgrad[0]:.2e} (critic), "
          f"{dgrad[1]:.2e} (actor; the CPU's float32 actor gradient against float64 {f32_err:.2e}, the bound "
          f"{actor_tol:.2e}), {dgrad[2]:.2e} (log alpha) of each tensor's largest entry; the card's "
          f"Adam steps against its own gradients' where |g| > 1e-5 ({n_far} of {n_all} entries): "
          f"max |d| {worst[0]:.2e} (critic), {worst[1]:.2e} (actor), {worst[2]:.2e} (log alpha) of lr; "
          f"target against the card's own Polyak {dtarget:.3f} of two ulps, max |dtarget| against the CPU "
          f"{dtarget_cpu:.2e}; log alpha {float(gstate.log_alpha):.9f} / {float(cstate.log_alpha):.9f}")
    if not (gm["actor_updated"] and cm["actor_updated"] and len(steps["cuda"]) == len(steps["cpu"]) == 3
            and max(dloss.values()) < 2e-5 and max(dgrad[0], dgrad[2]) < 1e-5 and dgrad[1] < actor_tol
            and max(worst) < 1e-3
            and n_far > n_all // 2 and dtarget <= 1.0 and dalpha < 1e-3 * gpu.alpha_lr):
        raise AssertionError(f"{tag}: the SAC update on the card disagrees with the CPU")


def actor_f32_error(agent, step, obs, noise, log_alpha) -> float:
    """The largest |float32 - float64| of the actor step's gradient ``step``
    (its params before and gradients, as recorded) over each tensor's largest
    float64 entry: the step rerun on float64 copies of the actor (from
    ``step``'s params) and of the critic the step read, on the CPU."""
    import copy
    import types

    from rl_games_tpu_torch.algos import sac as sac_module

    actor64, critic64 = copy.deepcopy(agent.actor).double(), copy.deepcopy(agent.critic).double()
    with torch.no_grad():
        for p, before in zip(actor64.parameters(), step[0]):
            p.copy_(before)
    grads, saved, adam = [], (agent.actor, agent.critic, agent.actor_params), sac_module.adam_step
    sac_module.adam_step = lambda params, g, *args, **kwargs: grads.append([x.detach().double() for x in g])
    try:
        agent.actor, agent.critic, agent.actor_params = actor64, critic64, list(actor64.parameters())
        agent._update_actor_and_alpha(types.SimpleNamespace(log_alpha=log_alpha.clone(), actor_opt=None,
                                                            alpha_opt=None), obs.double(), noise.double())
    finally:
        (agent.actor, agent.critic, agent.actor_params), sac_module.adam_step = saved, adam
    return max(float((g32 - g64).abs().max() / g64.abs().max().clamp(min=1e-30))
               for g32, g64 in zip(step[1], grads[0]))


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


DISCRETE_ENV_NAMES = ("CartPole-v1", "Pendulum-v1", "MountainCarContinuous-v0", "PixelCatcher-v0",
                      "DevicePong-v0", "DeviceBreakout-v0")


def random_actions(space, n, gen, device):
    """Actions of the env's space drawn from ``gen``: indices, or uniform
    within the Box's bounds."""
    from rl_games_tpu_torch.envs.spaces import Discrete

    if isinstance(space, Discrete):
        return torch.randint(0, space.n, (n,), generator=gen, device=device)
    return torch.rand((n, *space.shape), generator=gen, device=device) * (space.high - space.low) + space.low


def phase_envs_discrete():
    """The discrete slice's envs and the classic ones: one step on the card
    against the same step on the CPU, from a state 20 random steps into its
    episode and with the same draws; then the wall time, device time and
    device kernels of a vec-env step at 512 and 4096 envs."""
    from rl_games_tpu_torch.envs import registry
    from rl_games_tpu_torch.envs.device.base import uniform

    for name in DISCRETE_ENV_NAMES:
        create = registry.ENV_CONFIGURATIONS[name]["env_creator"]
        cpu_env, gpu_env = create(device="cpu"), create(device="cuda")
        n, gen = 512, torch.Generator().manual_seed(1)
        space, shape = cpu_env.env_info().action_space, cpu_env.step_noise_shape
        state, _ = cpu_env.reset(n, gen)
        for _ in range(21):
            actions = random_actions(space, n, gen, "cpu")
            noise = None if shape is None else uniform(n, shape, gen, "cpu")
            prev, (state, obs, reward, terminated, _) = state, cpu_env.step(state, actions, noise)
        got = gpu_env.step(state_to(prev, "cuda"), actions.cuda(), None if noise is None else noise.cuda())
        exact = torch.ones(n, dtype=torch.bool)
        dpos = 0.0
        for f in dataclasses.fields(state):
            a, b = getattr(got[0], f.name).cpu(), getattr(state, f.name)
            same = (a == b).reshape(n, -1).all(dim=1)
            exact &= same
            if b.is_floating_point():
                dpos = max(dpos, float((a - b).abs().max()))
        frames_equal = bool(torch.equal(got[1].cpu()[exact], obs[exact]))
        dobs = float((got[1].cpu() - obs).abs().max())
        drew = float((got[2].cpu() - reward).abs().max())
        same_done = bool(torch.equal(got[3].cpu(), terminated))
        print(f"[envs] {name} step cuda vs cpu ({n} envs): max |dstate| {dpos:.2e}, {int(exact.sum())} of {n} "
              f"envs bit-equal in every field, their observations equal: {frames_equal}; max |dobs| {dobs:.2e}, "
              f"max |dreward| {drew:.2e}, terminations equal: {same_done}")
        # a pixel game's step is additions and comparisons on float32
        # positions, which the card and the CPU round alike: every env is
        # bit-equal, and its frame (comparisons of those positions) equal. A
        # classic env's observation takes cos and sin, whose implementations
        # differ between card and CPU
        pixel = name in ("PixelCatcher-v0", "DevicePong-v0", "DeviceBreakout-v0")
        if not (dpos < 1e-5 and (bool(exact.all()) and frames_equal if pixel else dobs < 1e-5)
                and drew < 1e-4 and same_done):
            raise AssertionError(f"{name} step on the card disagrees with the CPU step")

    rows = {}
    for name in DISCRETE_ENV_NAMES:
        for n in (512, 4096):
            vec = registry.create_vec_env(name, n)  # the default device: the card
            gen = torch.Generator(device="cuda").manual_seed(0)
            state, _ = vec.reset(gen)
            actions = random_actions(vec.get_env_info().action_space, n, gen, "cuda")
            step = lambda: vec.step(state, actions)  # noqa: E731
            step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) / 20 * 1e3
            device_ms, kernels = device_time_ms(step, 5)
            rows[(name, n)] = {"wall_ms": wall_ms, "device_ms": device_ms, "kernels": kernels}
            print(f"[envs] {name} at {n} envs: vec-env step {wall_ms:.2f} ms wall, {device_ms:.3f} ms device, "
                  f"{kernels} device kernels")
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
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    agent = PPOAgent("chip_smoke", flagship_params(num_actors))
    state = agent.init_state()
    torch.cuda.synchronize()
    print(f"[trainer] built agent + init_state in {time.perf_counter() - t0:.2f} s; "
          f"batch {agent.batch_size}, {agent.num_minibatches} minibatches x {agent.mini_epochs_num} mini-epochs")

    gae.gae_launches = fused_mlp.fused_mlp_launches = fused_mlp.fused_mlp_cluster_launches = fused_mlp.fused_mlp_wgmma_launches = 0  # the main path's run starts here
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


def epoch_marker(ends):
    """A stop_fn that stamps the end of every epoch and never stops."""
    def mark(agent):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        return False
    return mark


def steady_player_step(runner, checkpoint):
    """The player's mean step time without set-up: a second player on the
    checkpoint, the start of each env step stamped on the host's clock."""
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
    return (time.perf_counter() - stamps[warm]) / (len(stamps) - warm), warm + 1, len(stamps)


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
    with tempfile.TemporaryDirectory() as train_dir:
        params["config"].update({
            "name": "chip_smoke_fused", "train_dir": train_dir, "max_epochs": epochs,
            "save_frequency": max(1, epochs - 1), "save_best_after": 1,
            "player": {"num_actors": num_actors, "games_num": num_actors, "max_steps": play_steps,
                       "deterministic": True},
        })
        runner = Runner()  # the default device: the card
        runner.load({"params": params})

        gae.gae_launches = fused_mlp.fused_mlp_launches = fused_mlp.fused_mlp_cluster_launches = fused_mlp.fused_mlp_wgmma_launches = 0  # the training run starts here
        t0 = time.perf_counter()
        last_mean, epoch_num = runner.run({"train": True, "stop_fn": epoch_marker(epoch_ends)})
        torch.cuda.synchronize()
        train_launches = {"gae": gae.gae_launches, "fused_mlp": fused_mlp.fused_mlp_launches}  # read right after
        train_wgmma = fused_mlp.fused_mlp_wgmma_launches
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
        gae.gae_launches = fused_mlp.fused_mlp_launches = fused_mlp.fused_mlp_cluster_launches = fused_mlp.fused_mlp_wgmma_launches = 0  # the player's run starts here
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            mean_reward = runner.run({"play": True, "checkpoint": checkpoint})
        torch.cuda.synchronize()
        play_s = time.perf_counter() - t0
        play_launches = {"gae": gae.gae_launches, "fused_mlp": fused_mlp.fused_mlp_launches}  # read right after
        play_wgmma = fused_mlp.fused_mlp_wgmma_launches
        sys.stdout.write(out.getvalue())

        steady_step_s, first, last = steady_player_step(runner, checkpoint)
    games = re.search(r"games played: (\d+)", out.getvalue())
    # one policy forward per env step, nothing else
    if play_launches != {"gae": 0, "fused_mlp": steps} or steps != play_steps:
        raise AssertionError(f"player: launches {play_launches} in {steps} steps")
    check_wgmma_launches("runner", FLAGSHIP_DIMS, {"train": (train_wgmma, {8192: 17 * epochs, 32768: 16 * epochs}),
                                                   "play": (play_wgmma, {8192: steps})})
    if games is None or int(games.group(1)) <= 0 or not math.isfinite(mean_reward):
        raise AssertionError(f"player: mean reward {mean_reward}, output {out.getvalue()!r}")
    print(f"[runner] played {steps} steps x {num_actors} envs through Runner.run: launches {play_launches}, "
          f"{int(games.group(1))} games in the meter, mean reward {mean_reward:.3f}; {play_s:.2f} s with set-up, "
          f"{steps / play_s:.1f} steps/s, {steps * num_actors / play_s:,.0f} env-steps/s; steady step without set-up "
          f"{steady_step_s * 1e3:.2f} ms (mean of steps {first}-{last} of a second run), "
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
            gae.gae_launches = fused_mlp.fused_mlp_launches = fused_mlp.fused_mlp_cluster_launches = fused_mlp.fused_mlp_wgmma_launches = 0  # the training run starts here
            t0 = time.perf_counter()
            _, epoch_num = runner.run({"train": True, "stop_fn": epoch_marker(epoch_ends)})
            torch.cuda.synchronize()
            train_launches = {"gae": gae.gae_launches, "fused_mlp": fused_mlp.fused_mlp_launches}  # read right after
            train_wgmma = fused_mlp.fused_mlp_wgmma_launches
            train_batches = {b: batches.count(b) for b in sorted(set(batches))}
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            nn_dir = os.path.join(train_dir, "chip_smoke_humanoid3d", "nn")
            final = [n for n in sorted(os.listdir(nn_dir)) if f"_ep_{epochs}_rew_" in n]
            if len(final) != 1:
                raise AssertionError(f"no final checkpoint among {os.listdir(nn_dir)}")

            batches.clear()
            gae.gae_launches = fused_mlp.fused_mlp_launches = fused_mlp.fused_mlp_cluster_launches = fused_mlp.fused_mlp_wgmma_launches = 0  # the player's run starts here
            out = io.StringIO()
            t1 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                mean_reward = runner.run({"play": True, "checkpoint": os.path.join(nn_dir, final[0])})
            torch.cuda.synchronize()
            play_s = time.perf_counter() - t1
            play_launches = {"gae": gae.gae_launches, "fused_mlp": fused_mlp.fused_mlp_launches}  # read right after
            play_wgmma = fused_mlp.fused_mlp_wgmma_launches
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
    check_wgmma_launches("humanoid3d", HUMANOID3D_DIMS, {"train": (train_wgmma, expected_batches),
                                                         "play": (play_wgmma, {num_actors: play_steps})})
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
    gae.gae_launches = fused_mlp.fused_mlp_launches = fused_mlp.fused_mlp_cluster_launches = fused_mlp.fused_mlp_wgmma_launches = 0  # the main path's run starts here
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


def train_and_play(name: str, params: dict, epochs: int, batches: list | None = None):
    """``params`` through Runner.run: train ``epochs`` epochs, then play the
    last checkpoint. Returns the launch counts of both runs (each counted
    from 0 just before it), the epoch times, the peak device memory of the
    training, the player's output and mean reward, and the steady step.
    ``batches``, a list the caller's kernel wrapper appends to, is cut at
    the runs' ends into the histograms of the training, the player's run
    and the steady-step run."""
    from rl_games_tpu_torch.ops import fused_mlp, gae
    from rl_games_tpu_torch.runner import Runner

    ends = []
    with tempfile.TemporaryDirectory() as train_dir:
        params["config"].update(train_dir=train_dir, max_epochs=epochs)
        runner = Runner()  # the default device: the card
        runner.load({"params": params})
        torch.cuda.reset_peak_memory_stats()
        gae.gae_launches = fused_mlp.fused_mlp_launches = fused_mlp.fused_mlp_cluster_launches = fused_mlp.fused_mlp_wgmma_launches = 0  # the training run starts here
        t0 = time.perf_counter()
        _, epoch_num = runner.run({"train": True, "stop_fn": epoch_marker(ends)})
        torch.cuda.synchronize()
        train_launches = {"gae": gae.gae_launches, "fused_mlp": fused_mlp.fused_mlp_launches}  # read right after
        train_cluster = fused_mlp.fused_mlp_cluster_launches
        cuts = [len(batches or [])]
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        nn_dir = os.path.join(train_dir, params["config"]["name"], "nn")
        final = [n for n in sorted(os.listdir(nn_dir)) if f"_ep_{epochs}_rew_" in n]
        if epoch_num != epochs or len(final) != 1:
            raise AssertionError(f"{name}: {epoch_num} epochs, checkpoints {os.listdir(nn_dir)}")
        checkpoint = os.path.join(nn_dir, final[0])
        player = runner.create_player()
        steps = player.steps_needed(player.games_num)
        del player
        gae.gae_launches = fused_mlp.fused_mlp_launches = fused_mlp.fused_mlp_cluster_launches = fused_mlp.fused_mlp_wgmma_launches = 0  # the player's run starts here
        out = io.StringIO()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            mean_reward = runner.run({"play": True, "checkpoint": checkpoint})
        torch.cuda.synchronize()
        play_s = time.perf_counter() - t1
        play_launches = {"gae": gae.gae_launches, "fused_mlp": fused_mlp.fused_mlp_launches}  # read right after
        play_cluster = fused_mlp.fused_mlp_cluster_launches
        cuts.append(len(batches or []))
        steady_s, first, last = steady_player_step(runner, checkpoint)
    if not math.isfinite(mean_reward):
        raise AssertionError(f"{name} player: mean reward {mean_reward}")
    runs = [(batches or [])[a:b] for a, b in zip([0, *cuts], [*cuts, None])]
    train_batches, play_batches, steady_batches = ({b: run.count(b) for b in sorted(set(run))} for run in runs)
    return {"train": train_launches, "play": play_launches, "times": np.diff([t0, *ends]), "peak_gib": peak_gib,
            "play_out": out.getvalue().strip(), "play_s": play_s, "play_steps": steps, "mean_reward": mean_reward,
            "steady_step_s": steady_s, "steady_of": (first, last), "train_batches": train_batches,
            "play_batches": play_batches, "steady_batches": steady_batches, "train_cluster": train_cluster,
            "play_cluster": play_cluster}


def cluster_launches_expected(dims, batches: dict) -> int:
    """The cluster kernel's launches that calls of fused_mlp_cuda over the
    chain ``dims`` at these batches ({batch: calls}) make, as launch_plan
    plans them."""
    from rl_games_tpu_torch.ops import fused_mlp as fm

    return sum(calls * sum(p.cluster is not None for p in fm.launch_plan(dims, batch))
               for batch, calls in batches.items())


def check_cluster_launches(tag, dims, runs: dict) -> dict:
    """Each run's cluster launches ({name: (counted, {batch: calls})})
    against cluster_launches_expected; prints them and returns the counts."""
    from rl_games_tpu_torch.ops import fused_mlp as fm

    got = {name: counted for name, (counted, _) in runs.items()}
    want = {name: cluster_launches_expected(dims, batches) for name, (_, batches) in runs.items()}
    print(f"[{tag}] launches of the cluster kernel: " + ", ".join(f"{name} {n}" for name, n in got.items())
          + f" ({'x'.join(map(str, dims))}; launch_plan takes it to B = {fm.CLUSTER_SHAPES[-1][0]})")
    if got != want:
        raise AssertionError(f"{tag}: cluster kernel launches {got}, expected {want} from the batches")
    return got


def report_epochs(tag, times, batch, peak_gib):
    steady = times[1:] if len(times) > 1 else times
    epoch_s = float(np.median(steady))
    print(f"[{tag}] first epoch {times[0] * 1e3:.1f} ms; steady epoch {epoch_s * 1e3:.1f} ms (median of "
          f"{len(steady)}), {batch / epoch_s:,.0f} env-steps/s; peak device memory {peak_gib:.2f} GiB")
    return epoch_s


def phase_pong(epochs: int, play_steps: int = 200):
    """ppo_pong_device.yaml as shipped (only max_epochs, train_dir and the
    player's steps changed) through Runner.run: train, then play."""
    params = load_config("ppo_pong_device.yaml")["params"]
    params["config"]["player"] = {**params["config"]["player"], "max_steps": play_steps}
    run = train_and_play("pong", params, epochs)
    cfg = params["config"]
    batch, n = cfg["num_actors"] * cfg["horizon_length"], cfg["num_actors"]
    if run["train"] != {"gae": epochs, "fused_mlp": 0} or run["play"] != {"gae": 0, "fused_mlp": 0}:
        raise AssertionError(f"pong: launches {run['train']} in {epochs} epochs, player {run['play']}")
    print(f"[pong] trained {epochs} epochs of ppo_pong_device.yaml through Runner.run ({n} envs x "
          f"{cfg['horizon_length']} steps, {cfg['mini_epochs']} x {batch // cfg['minibatch_size']} minibatches of "
          f"{cfg['minibatch_size']}): launches {run['train']} (GAE at [{cfg['horizon_length']}, {n}, 1])")
    epoch_s = report_epochs("pong", run["times"], batch, run["peak_gib"])
    s = run["steady_step_s"]
    print(f"[pong] played {run['play_steps']} steps x {n} envs: {run['play_out']!r}, {run['play_s']:.2f} s with "
          f"set-up; steady step without set-up {s * 1e3:.2f} ms (mean of steps {run['steady_of'][0]}-"
          f"{run['steady_of'][1]} of a second run), {n / s:,.0f} env-steps/s")
    return run["train"], epoch_s


def phase_pong_fused(epochs: int, plain_epoch_s: float, play_steps: int = 200):
    """ppo_pong_device.yaml with network.mlp.fused: true (nothing else
    changed but max_epochs, train_dir and the player's steps) through
    Runner.run: train, then play. The nature-CNN's 3136 -> 512 elu torso is
    one launch that streams its input; an epoch launches it 64 + 1 times at
    B = 512 (rollout, bootstrap) and 4 x 8 times at B = 4096 (the
    minibatches, through the registered operator), the player once a step
    at B = 512; GAE once an epoch. Then the fused model's forward and first
    update on the card against the CPU (pong_reference), and the steady
    epoch beside [pong]'s plain one of this run."""
    from rl_games_tpu_torch.ops import fused_mlp

    params = load_config("ppo_pong_device.yaml")["params"]
    params["network"]["mlp"]["fused"] = True
    params["config"]["player"] = {**params["config"]["player"], "max_steps": play_steps}
    cfg = params["config"]
    n, horizon = cfg["num_actors"], cfg["horizon_length"]
    minibatches = cfg["mini_epochs"] * n * horizon // cfg["minibatch_size"]
    batches = []

    def counted(x, *args):  # the batch of every call of the kernel's wrapper
        batches.append(x.shape[0])
        return launch(x, *args)

    launch = fused_mlp.fused_mlp_cuda
    fused_mlp.fused_mlp_cuda = counted
    try:
        run = train_and_play("pong_fused", params, epochs, batches)
    finally:
        fused_mlp.fused_mlp_cuda = launch
    per_epoch = horizon + 1 + minibatches
    expected_train = {n: (horizon + 1) * epochs, cfg["minibatch_size"]: minibatches * epochs}
    if (run["train"] != {"gae": epochs, "fused_mlp": per_epoch * epochs}
            or run["play"] != {"gae": 0, "fused_mlp": play_steps} or run["play_steps"] != play_steps
            or run["train_batches"] != expected_train or run["play_batches"] != {n: play_steps}):
        raise AssertionError(f"pong_fused: launches {run['train']} in {epochs} epochs at {run['train_batches']}, "
                             f"player {run['play']} in {run['play_steps']} steps at {run['play_batches']}; expected "
                             f"{per_epoch} fused an epoch at {expected_train}, 1 a player step at B = {n}")
    run["cluster"] = check_cluster_launches("pong_fused", NATURE_DIMS, {
        "training": (run["train_cluster"], run["train_batches"]), "player": (run["play_cluster"], run["play_batches"])})
    plan = fused_mlp.launch_plan(NATURE_DIMS, n)
    print(f"[pong_fused] trained {epochs} epochs of ppo_pong_device.yaml with mlp.fused through Runner.run: launches "
          f"{run['train']} ({per_epoch} fused an epoch at batches {run['train_batches']}; the torso one launch, "
          f"streamed {plan[0].streamed}); played {play_steps} steps: launches {run['play']}, {run['play_out']!r}")
    epoch_s = report_epochs("pong_fused", run["times"], n * horizon, run["peak_gib"])
    s = run["steady_step_s"]
    print(f"[pong_fused] steady epoch {epoch_s * 1e3:.1f} ms against [pong]'s plain {plain_epoch_s * 1e3:.1f} ms in "
          f"this run ({epoch_s / plain_epoch_s:.3f}x); steady player step {s * 1e3:.2f} ms at {n} envs")
    summary = pong_reference(fused=True)
    print(f"[pong_fused] fused Pong model cuda vs cpu: {summary}")
    return run, epoch_s


def phase_deep_torso(epochs: int = 2, layers: int = 10):
    """The flagship (8192 Ant2D envs x 16, 4 x 4 minibatches of 32768) with
    a fused torso of ``layers`` layers of 256 (two launches a forward:
    MAX_LAYERS a launch) through PPOAgent.train_epoch: finite losses, 33
    forwards and so 66 fused launches an epoch, GAE once."""
    from rl_games_tpu_torch.algos.ppo import PPOAgent
    from rl_games_tpu_torch.ops import fused_mlp

    params = fused_flagship_params(8192)
    params["network"]["mlp"]["units"] = [256] * layers
    agent = PPOAgent("chip_smoke_deep", params)
    state = agent.init_state()
    forwards = agent.horizon_length + 1 + agent.mini_epochs_num * agent.num_minibatches
    per_forward = len(fused_mlp.launch_plan((26,) + (256,) * layers, agent.num_actors))
    times = []
    zero_launches()  # the main path's run starts here
    for epoch in range(epochs):
        t0 = time.perf_counter()
        state, m = agent.train_epoch(state)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        a_loss, c_loss = float(m["a_loss"]), float(m["c_loss"])
        print(f"[deep_torso] epoch {epoch + 1}: {times[-1] * 1e3:.1f} ms, a_loss {a_loss:.4f}, c_loss {c_loss:.4f}")
        if not (math.isfinite(a_loss) and math.isfinite(c_loss)):
            raise AssertionError(f"deep torso: non-finite losses in epoch {epoch + 1}")
    launches = launches_now()  # read right after
    wgmma = fused_mlp.fused_mlp_wgmma_launches
    check_wgmma_launches("deep_torso", (26,) + (256,) * layers, {"train": (wgmma, {
        agent.num_actors: (agent.horizon_length + 1) * epochs,
        agent.minibatch_size: agent.mini_epochs_num * agent.num_minibatches * epochs})})
    if per_forward != 2 or launches != {"gae": epochs, "fused_mlp": forwards * per_forward * epochs}:
        raise AssertionError(f"deep torso: launches {launches} in {epochs} epochs, {per_forward} a forward; expected "
                             f"{forwards * 2} fused an epoch")
    print(f"[deep_torso] the flagship with {layers} fused layers of 256: launches {launches} in {epochs} epochs "
          f"({forwards} forwards x {per_forward} launches an epoch); epochs {', '.join(f'{t * 1e3:.1f}' for t in times)} ms")
    return launches, times


def phase_breakout(epochs: int):
    """ppo_breakout_device.yaml as shipped through PPOAgent.train_epoch."""
    from rl_games_tpu_torch.algos.ppo import PPOAgent
    from rl_games_tpu_torch.ops import fused_mlp, gae

    agent = PPOAgent("chip_smoke_breakout", load_config("ppo_breakout_device.yaml")["params"])
    state = agent.init_state()
    torch.cuda.reset_peak_memory_stats()
    gae.gae_launches = fused_mlp.fused_mlp_launches = fused_mlp.fused_mlp_cluster_launches = fused_mlp.fused_mlp_wgmma_launches = 0  # the main path's run starts here
    times = []
    for epoch in range(epochs):
        t0 = time.perf_counter()
        state, m = agent.train_epoch(state)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if not (math.isfinite(float(m["a_loss"])) and math.isfinite(float(m["c_loss"]))):
            raise AssertionError(f"breakout: non-finite losses in epoch {epoch + 1}")
    launches = {"gae": gae.gae_launches, "fused_mlp": fused_mlp.fused_mlp_launches}  # read right after
    if launches != {"gae": epochs, "fused_mlp": 0}:
        raise AssertionError(f"breakout trainer: launches {launches} in {epochs} epochs")
    print(f"[breakout] {epochs} epochs of ppo_breakout_device.yaml through train_epoch: launches {launches}; "
          f"kl {float(m['kl']):.5f}, entropy {float(m['entropy']):.4f}, lr {float(m['lr']):.2e}, "
          f"mean_rewards {float(m['mean_rewards'][0]):.3f}, games {int(m['games_played'])}")
    epoch_s = report_epochs("breakout", np.array(times), agent.batch_size, torch.cuda.max_memory_allocated() / 2**30)
    return agent, state, launches, epoch_s


def phase_cartpole(epochs: int, play_steps: int = 200, tag: str = "cartpole", value_head: str | None = None):
    """ppo_cartpole.yaml with network.mlp.fused: true (and ``value_head``,
    where given: [twohot]) through Runner.run: train, then play; the fused
    launches held to the count the code implies, GAE once an epoch."""
    from rl_games_tpu_torch.ops import fused_mlp

    params = load_config("ppo_cartpole.yaml")["params"]
    params["network"]["mlp"]["fused"] = True
    if value_head is not None:
        params["network"]["value_head"] = value_head
    params["config"]["player"] = {**params["config"]["player"], "max_steps": play_steps}
    cfg = params["config"]
    horizon, mini_epochs = cfg["horizon_length"], cfg["mini_epochs"]
    minibatches = cfg["num_actors"] * horizon // cfg["minibatch_size"]
    batches = []

    def counted(x, *args):  # the batch of every kernel launch
        batches.append(x.shape[0])
        return launch(x, *args)

    launch = fused_mlp.fused_mlp_cuda
    fused_mlp.fused_mlp_cuda = counted
    try:
        run = train_and_play(tag, params, epochs, batches)
    finally:
        fused_mlp.fused_mlp_cuda = launch
    # per epoch: horizon rollout forwards and 1 bootstrap forward at B =
    # num_actors, mini_epochs x minibatches forwards at B = minibatch_size;
    # the player: one forward per step at B = num_actors. The steady-step
    # run of the player adds play_steps more at B = num_actors
    per_epoch = horizon + 1 + mini_epochs * minibatches
    expected_batches = {cfg["num_actors"]: (horizon + 1) * epochs + 2 * play_steps,
                        cfg["minibatch_size"]: mini_epochs * minibatches * epochs}
    got_batches = {b: batches.count(b) for b in sorted(set(batches))}
    if (run["train"] != {"gae": epochs, "fused_mlp": per_epoch * epochs}
            or run["play"] != {"gae": 0, "fused_mlp": play_steps} or run["play_steps"] != play_steps
            or got_batches != expected_batches):
        raise AssertionError(f"{tag}: launches {run['train']} in {epochs} epochs, player {run['play']} in "
                             f"{run['play_steps']} steps, batches {got_batches}; expected {per_epoch} fused per "
                             f"epoch, 1 per player step, batches {expected_batches}")
    run["train"]["cluster"] = check_cluster_launches(tag, CARTPOLE_DIMS, {
        "training": (run["train_cluster"], run["train_batches"]), "player": (run["play_cluster"], run["play_batches"])})
    head = "" if value_head is None else f", value_head: {value_head}"
    print(f"[{tag}] trained {epochs} epochs of ppo_cartpole.yaml (fused{head}) through Runner.run: launches "
          f"{run['train']} ({per_epoch} fused per epoch, GAE at [{horizon}, {cfg['num_actors']}, 1]) at batches "
          f"{got_batches} with the player's; played {play_steps} steps: launches {run['play']}, {run['play_out']!r}")
    epoch_s = report_epochs(tag, run["times"], cfg["num_actors"] * horizon, run["peak_gib"])
    print(f"[{tag}] steady player step {run['steady_step_s'] * 1e3:.2f} ms at {cfg['num_actors']} envs")
    return run["train"], run["play"], play_steps, epoch_s


def phase_sac(update_epochs: int, profile: bool, play_steps: int = 200):
    """sac_ant2d.yaml as shipped (only max_epochs, train_dir and the
    player's steps changed) through Runner.run: its warmup epochs, then
    ``update_epochs`` epochs of updates, then the last checkpoint played.
    The path launches neither kernel: SAC's MLPs are the plain chain and it
    has no GAE."""
    from rl_games_tpu_torch.algos import sac as sac_module
    from rl_games_tpu_torch.ops import fused_mlp, gae
    from rl_games_tpu_torch.runner import Runner
    from rl_games_tpu_torch.utils import checkpoint as ckpt

    params = load_config("sac_ant2d.yaml")["params"]
    cfg = params["config"]
    warmup, steps, n = cfg["num_warmup_steps"], cfg["num_steps_per_episode"], cfg["num_actors"]
    epochs = warmup + update_epochs
    cfg["player"] = {**cfg["player"], "max_steps": play_steps}
    log, ends, agents = ScalarLog(), [], []

    def mark(agent):  # stamps the end of every epoch, never stops
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        agents[:] = [agent]
        return False

    create_writer = sac_module.create_writer
    sac_module.create_writer = lambda _dir: log
    try:
        with tempfile.TemporaryDirectory() as train_dir:
            cfg.update(name="chip_smoke_sac", train_dir=train_dir, max_epochs=epochs)
            runner = Runner()  # the default device: the card
            runner.load({"params": params})
            torch.cuda.reset_peak_memory_stats()
            gae.gae_launches = fused_mlp.fused_mlp_launches = fused_mlp.fused_mlp_cluster_launches = fused_mlp.fused_mlp_wgmma_launches = 0  # the training run starts here
            t0 = time.perf_counter()
            _, epoch_num = runner.run({"train": True, "stop_fn": mark})
            torch.cuda.synchronize()
            train_launches = {"gae": gae.gae_launches, "fused_mlp": fused_mlp.fused_mlp_launches}  # read right after
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            agent = agents[0]
            state = agent.last_state
            checkpoint = os.path.join(train_dir, "chip_smoke_sac", "nn", f"last_chip_smoke_sac_ep_{epochs}.pth")
            payload, ckpt_bytes = ckpt.read_payload(checkpoint), os.path.getsize(checkpoint)

            gae.gae_launches = fused_mlp.fused_mlp_launches = fused_mlp.fused_mlp_cluster_launches = fused_mlp.fused_mlp_wgmma_launches = 0  # the player's run starts here
            out = io.StringIO()
            t1 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                mean_reward = runner.run({"play": True, "checkpoint": checkpoint})
            torch.cuda.synchronize()
            play_s = time.perf_counter() - t1
            play_launches = {"gae": gae.gae_launches, "fused_mlp": fused_mlp.fused_mlp_launches}  # read right after
            steady_step_s, first, last = steady_player_step(runner, checkpoint)
    finally:
        sac_module.create_writer = create_writer

    updates = update_epochs * steps * agent.num_updates_per_step
    losses = {k: log.tags.get(f"losses/{k}", []) for k in ("critic_loss", "actor_loss", "entropy", "alpha_loss",
                                                             "alpha")}
    if epoch_num != epochs or state.update_counter != updates or agent.num_updates_per_step != 8:
        raise AssertionError(f"sac: {epoch_num} epochs, {state.update_counter} updates; expected {epochs} "
                             f"epochs and {updates} updates (8 per env step after {warmup} warmup epochs)")
    if not all(len(v) == epochs and all(math.isfinite(x) for x in v[warmup:]) for v in losses.values()):
        raise AssertionError(f"sac: losses not finite, or not logged every epoch: {losses}")
    if losses["alpha"][-1] == 1.0 or losses["alpha"][warmup - 1] != 1.0:
        raise AssertionError(f"sac: alpha {losses['alpha'][warmup - 1]} after warmup, {losses['alpha'][-1]} at the end")
    if (payload["meta"].get("has_replay") is not False or payload["state"]["replay"]["obses"].shape[0] != 1
            or payload["state"]["update_counter"] != updates):
        raise AssertionError(f"sac: the last checkpoint's meta {payload['meta']} and its replay of "
                             f"{payload['state']['replay']['obses'].shape[0]} rows; expected a stripped ring")
    no_kernel = {"gae": 0, "fused_mlp": 0}
    if train_launches != no_kernel or play_launches != no_kernel:
        raise AssertionError(f"sac: the kernels were launched, train {train_launches}, play {play_launches}")
    if not math.isfinite(mean_reward):
        raise AssertionError(f"sac player: mean reward {mean_reward}")

    times = np.diff([t0, *ends])
    warm, upd = times[:warmup], times[warmup:]
    warm_s, upd_s = float(np.median(warm[1:])), float(np.median(upd[1:] if len(upd) > 1 else upd))
    frames = n * steps
    replay = state.replay
    replay_bytes = sum(t.numel() * t.element_size() for t in (replay.obses, replay.next_obses, replay.actions,
                                                              replay.rewards, replay.dones, replay.truncated))
    print(f"[sac] trained {epoch_num} epochs of sac_ant2d.yaml through Runner.run ({n} envs x {steps} steps, "
          f"{warmup} warmup epochs, then {agent.num_updates_per_step} updates of batch {agent.batch_size} per env "
          f"step): launches {train_launches}; {state.update_counter} updates; warmup epoch: first (with set-up) "
          f"{warm[0] * 1e3:.1f} ms, steady {warm_s * 1e3:.1f} ms (median of {len(warm) - 1}), "
          f"{frames / warm_s:,.0f} env-steps/s; update epoch: first {upd[0] * 1e3:.1f} ms, steady "
          f"{upd_s * 1e3:.1f} ms (median of {max(len(upd) - 1, 1)}), {frames / upd_s:,.0f} env-steps/s, "
          f"{steps * agent.num_updates_per_step / upd_s:,.1f} updates/s; peak device memory {peak_gib:.2f} GiB")
    print(f"[sac] last epoch: critic_loss {losses['critic_loss'][-1]:.4f}, actor_loss "
          f"{losses['actor_loss'][-1]:.4f}, entropy {losses['entropy'][-1]:.4f}, alpha_loss "
          f"{losses['alpha_loss'][-1]:.4f}, alpha {losses['alpha'][-1]:.5f}; replay {sac_module.replay_size(replay)} "
          f"of {replay.capacity} rows, {replay_bytes / 2**20:.1f} MiB; the last checkpoint {payload['meta']}, "
          f"{ckpt_bytes / 2**20:.2f} MiB, with a {payload['state']['replay']['obses'].shape[0]}-row ring")

    # device kernels and device time of the pieces of an epoch
    def update(with_actor):
        state.update_counter = 1 if with_actor else 0  # policy_frequency 2: the actor runs at 2
        agent._update(state)

    pieces = {"env step (warmup)": lambda: agent._env_step(state, True),
              "env step": lambda: agent._env_step(state, False),
              "update with the actor step": lambda: update(True),
              "update without it": lambda: update(False)}
    counts, reps = {}, 8
    for what, fn in pieces.items():
        # the fullest of three CUDA-only sessions: a session that loses one
        # event (as device_time_ms finds them to) reads 1/reps kernel low
        fn()
        torch.cuda.synchronize()
        events = max((device_events(fn, reps) for _ in range(3)), key=len)
        counts[what] = len(events) / reps
        print(f"[sac] {what}: {counts[what]:.2f} device kernels, "
              f"{sum(e.time_range.elapsed_us() for e in events) / reps / 1e3:.3f} ms device time per call "
              f"(the fullest of three sessions of {reps} calls)")
    per_update = (counts["update with the actor step"] + counts["update without it"]) / 2
    print(f"[sac] device kernels per warmup epoch {steps * counts['env step (warmup)']:.0f}, per update epoch "
          f"{steps * counts['env step'] + steps * agent.num_updates_per_step * per_update:.0f} "
          f"({per_update:.1f} per update, policy_frequency 2)")
    if profile:
        phase_profile_sac(agent, state)
    print(f"[sac] played {play_steps} steps x {n} envs through Runner.run: launches {play_launches}, "
          f"{out.getvalue().strip()!r}, {play_s:.2f} s with set-up; steady step without set-up "
          f"{steady_step_s * 1e3:.2f} ms (mean of steps {first}-{last} of a second run), "
          f"{n / steady_step_s:,.0f} env-steps/s")
    return train_launches, play_launches, upd_s


def host_ppo_run(epochs: int, placement: str, fused: bool, profile: bool):
    """host_ppo_params() through Runner.run with host_inference_device
    ``placement``: train ``epochs`` epochs, then play the last checkpoint.
    Returns the launch counts, the batch of every fused launch, per-epoch
    times and ``_last_timing``, the player's output and steps."""
    from rl_games_tpu_torch.envs.host.cpuenv import CpuVecEnv
    from rl_games_tpu_torch.ops import fused_mlp, gae
    from rl_games_tpu_torch.runner import Runner

    params = host_ppo_params()
    params["network"]["mlp"]["fused"] = fused
    cfg = params["config"]
    cfg["host_inference_device"] = placement
    cfg["player"] = {**cfg["player"], "max_steps": 1000}
    batches, ends, timings, agents, env_steps = [], [], [], [], [0]

    def counted(x, *args):  # the batch of every kernel launch
        batches.append(x.shape[0])
        return launch(x, *args)

    def mark(agent):  # stamps each epoch's end and keeps its host timing; never stops
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        timings.append(dict(agent._last_timing))
        agents[:] = [agent]
        return False

    def counted_step(self, actions):  # the player's env steps
        env_steps[0] += 1
        return step(self, actions)

    launch, step = fused_mlp.fused_mlp_cuda, CpuVecEnv.step
    fused_mlp.fused_mlp_cuda = counted
    try:
        with tempfile.TemporaryDirectory() as train_dir:
            cfg.update(name="chip_smoke_host_ppo", train_dir=train_dir, max_epochs=epochs, save_best_after=1)
            runner = Runner()  # the default device: the card
            runner.load({"params": params})
            gae.gae_launches = fused_mlp.fused_mlp_launches = fused_mlp.fused_mlp_cluster_launches = fused_mlp.fused_mlp_wgmma_launches = 0  # the training run starts here
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                _, epoch_num = runner.run({"train": True, "stop_fn": mark})
            torch.cuda.synchronize()
            train_launches = {"gae": gae.gae_launches, "fused_mlp": fused_mlp.fused_mlp_launches}  # read right after
            train_cluster = fused_mlp.fused_mlp_cluster_launches
            train_batches = {b: batches.count(b) for b in sorted(set(batches))}
            agent = agents[0]
            idle = host_ppo_profile(agent) if profile else None
            nn_dir = os.path.join(train_dir, "chip_smoke_host_ppo", "nn")
            final = [n for n in sorted(os.listdir(nn_dir)) if f"_ep_{epochs}_rew_" in n]
            if epoch_num != epochs or len(final) != 1:
                raise AssertionError(f"host_ppo: {epoch_num} epochs, checkpoints {os.listdir(nn_dir)}")
            checkpoint = os.path.join(nn_dir, final[0])

            CpuVecEnv.step = counted_step
            gae.gae_launches = fused_mlp.fused_mlp_launches = fused_mlp.fused_mlp_cluster_launches = fused_mlp.fused_mlp_wgmma_launches = 0  # the player's run starts here
            out = io.StringIO()
            t1 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                mean_reward = runner.run({"play": True, "checkpoint": checkpoint})
            torch.cuda.synchronize()
            play_s = time.perf_counter() - t1
            play_launches = {"gae": gae.gae_launches, "fused_mlp": fused_mlp.fused_mlp_launches}  # read right after
            play_cluster = fused_mlp.fused_mlp_cluster_launches
            play_batches = histogram(batches[sum(train_batches.values()):])
            CpuVecEnv.step = step
            steady_s, first, last = steady_player_step(runner, checkpoint)
    finally:
        fused_mlp.fused_mlp_cuda, CpuVecEnv.step = launch, step
    if not math.isfinite(mean_reward):
        raise AssertionError(f"host_ppo player: mean reward {mean_reward}")
    cluster = check_cluster_launches(f"host_ppo ({placement}{', fused' if fused else ''})", HOPPER_DIMS, {
        "training": (train_cluster, train_batches), "player": (play_cluster, play_batches)})
    return {"train": train_launches, "batches": train_batches, "play": play_launches, "play_steps": env_steps[0],
            "cluster": cluster,
            "times": np.diff([t0, *ends]), "timings": timings, "agent": agent, "idle": idle,
            "play_out": out.getvalue().strip(), "play_s": play_s, "steady_step_s": steady_s,
            "steady_of": (first, last)}


def host_ppo_profile(agent):
    """One host epoch of ``agent`` under torch.profiler: the device's idle
    share of its wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        agent.host_train_epoch(agent.last_state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    timing = agent._last_timing
    return profile_report("host_ppo profile", prof, wall_us, f"env steps {timing['step_time'] * 1e3:.1f} ms, "
                          f"rollout {timing['play_time'] * 1e3:.1f} ms, placement {agent.rollout_device.type}")


def phase_host_ppo(epochs: int, profile: bool):
    """ref/mujoco/halfcheetah.yaml at full width on the native Hopper2D-v0
    (host_ppo_params) through Runner.run, trained and played three times:
    host_inference_device default, cpu, and default with the fused MLP.
    GAE runs once per epoch at [256, 64, 1]; with the fused MLP on the
    card, every rollout step's forward at B = 64, the bootstrap forward,
    each minibatch's at B = 2048 and each player step's are one launch.
    The placement check times the default and cpu agents' epochs
    interleaved (host_ppo_placement_ab)."""
    from rl_games_tpu_torch.common.host_inference import auto_placement

    print(f"[host_ppo] host: {os.cpu_count()} cores online (std::thread::hardware_concurrency reads the same "
          f"count, the native stepper's thread pool), {len(os.sched_getaffinity(0))} in this process's affinity, "
          f"torch CPU threads {torch.get_num_threads()}")
    cfg = host_ppo_params()["config"]
    n, horizon, minibatch = cfg["num_actors"], cfg["horizon_length"], cfg["minibatch_size"]
    minibatches = cfg["mini_epochs"] * n * horizon // minibatch
    results = {}
    for placement, fused in (("default", False), ("cpu", False), ("default", True)):
        tag = f"{placement}{' fused' if fused else ''}"
        run = host_ppo_run(epochs, placement, fused, profile)
        results[tag] = run
        per_epoch = horizon + 1 + minibatches if fused else 0
        expected = {"gae": epochs, "fused_mlp": per_epoch * epochs}
        expected_batches = {n: (horizon + 1) * epochs, minibatch: minibatches * epochs} if fused else {}
        expected_play = run["play_steps"] if fused else 0
        if (run["train"] != expected or run["batches"] != expected_batches
                or run["play"] != {"gae": 0, "fused_mlp": expected_play}):
            raise AssertionError(f"host_ppo {tag}: launches {run['train']} at batches {run['batches']}, player "
                                 f"{run['play']} in {run['play_steps']} steps; expected {expected} at "
                                 f"{expected_batches}, player {expected_play} fused")
        times, timings = run["times"], run["timings"]
        steady = slice(1, None) if len(times) > 1 else slice(None)
        epoch_s = float(np.median(times[steady]))
        play = np.array([t["play_time"] for t in timings])
        env = np.array([t["step_time"] for t in timings])
        update = times - play
        s = run["steady_step_s"]
        print(f"[host_ppo] {tag}: {epochs} epochs of halfcheetah.yaml on Hopper2D-v0 (CPUENV, {n} envs x {horizon} "
              f"steps, {minibatches} minibatches of {minibatch}) through Runner.run: launches {run['train']}"
              + (f" at batches {run['batches']} ({per_epoch} fused per epoch = {horizon} rollout + 1 bootstrap + "
                 f"{minibatches} minibatch forwards)" if fused else "")
              + f"; first epoch {times[0] * 1e3:.1f} ms, steady epoch {epoch_s * 1e3:.1f} ms (median of "
              f"{len(times[steady])}), {n * horizon / epoch_s:,.0f} env-steps/s; steady medians: env steps "
              f"(step_time) {np.median(env[steady]) * 1e3:.1f} ms, rollout (play_time) "
              f"{np.median(play[steady]) * 1e3:.1f} ms ({np.median(play[steady]) / horizon * 1e3:.3f} ms a step, "
              f"{np.median((play - env)[steady]) / horizon * 1e3:.3f} ms of it beside the env), GAE + update "
              f"{np.median(update[steady]) * 1e3:.1f} ms")
        print(f"[host_ppo] {tag}: played {run['play_steps']} steps x {n} envs: launches {run['play']}, "
              f"{run['play_out']!r}, {run['play_s']:.2f} s with set-up; steady step without set-up {s * 1e3:.3f} ms "
              f"(mean of steps {run['steady_of'][0]}-{run['steady_of'][1]} of a second run)")
        if run["idle"] is not None:
            print(f"[host_ppo] {tag}: device idle share of one profiled epoch {run['idle']:.3f}")
    epochs_ab = host_ppo_placement_ab({p: results[p]["agent"] for p in ("default", "cpu")})
    ratio = float(np.median(epochs_ab["cpu"] / epochs_ab["default"]))  # round by round: the host's drift cancels
    faster = "cpu" if ratio < 1 else "default"
    auto = auto_placement(host_ppo_params()["network"])
    print(f"[host_ppo] placement: steady epoch default {np.median(epochs_ab['default']) * 1e3:.1f} ms, cpu "
          f"{np.median(epochs_ab['cpu']) * 1e3:.1f} ms, their epochs interleaved; cpu over default in the same "
          f"round {ratio:.3f} (median of {len(epochs_ab['cpu'])}): {faster} is faster at this geometry; "
          f"auto takes {auto} for this policy (an MLP)")
    if faster != auto:
        raise AssertionError(f"host_ppo: {faster} is the faster placement, but auto takes {auto} "
                             "(common/host_inference.auto_placement)")
    host_ppo_forward_ab({tag: results[tag]["agent"] for tag in ("default", "default fused")})
    for run in results.values():
        del run["agent"]
    return results


def host_ppo_placement_ab(agents: dict, rounds: int = 10) -> dict:
    """The trained agents' host epochs interleaved (A B, then B A), so that
    every placement sees the same host: each agent's epoch times, one a
    round. Runs trained one after the other see hosts that differ by up to
    two, and the host drifts within a run too."""
    epoch_s = collections.defaultdict(list)
    states = {tag: agent.last_state for tag, agent in agents.items()}
    for i in range(rounds):
        for tag in (list(agents) if i % 2 == 0 else list(agents)[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states[tag], _ = agents[tag].host_train_epoch(states[tag])
            torch.cuda.synchronize()
            epoch_s[tag].append(time.perf_counter() - t0)
    for tag, agent in agents.items():
        agent.last_state = states[tag]
    print(f"[host_ppo] placement A/B, {rounds} interleaved epochs each: "
          + ", ".join(f"{tag} {[round(t * 1e3, 1) for t in ts]} ms" for tag, ts in epoch_s.items()))
    return {tag: np.array(ts) for tag, ts in epoch_s.items()}


def host_ppo_forward_ab(agents: dict, rounds: int = 6, calls: int = 200):
    """The plain and the fused policy on the card side by side, each in its
    trained agent, interleaved call by call (and rollout by rollout, the
    order swapped every round) so that both see the same host: the host
    time of one forward_play at the rollout's B = 64 (until the call
    returns, and until the card has run it), of the MLP torso alone and of
    the chain alone (the kernel's wrapper, or plain_mlp), a rollout's step,
    the host time and CUDA launches of a forward under torch.profiler, and
    the device events (kernels and copies) per step of one profiled
    rollout."""
    from torch.profiler import ProfilerActivity, profile

    from rl_games_tpu_torch.models.layers import FusedMLP
    from rl_games_tpu_torch.ops import fused_mlp as fm

    tags = list(agents)
    fns = {}
    for tag, agent in agents.items():
        model, state = agent.model, agent.last_state
        torso = model.a2c_network.actor_mlp
        x = model.norm_obs(state.obs)
        ws = [m.weight for m in torso if isinstance(m, torch.nn.Linear)]
        bs = [m.bias for m in torso if isinstance(m, torch.nn.Linear)]
        chain = fm.fused_mlp_cuda if isinstance(torso, FusedMLP) else fm.plain_mlp
        activation = agent.full_params["network"]["mlp"]["activation"]
        fns[tag] = {"forward": lambda m=model, s=state: m.forward_play(s.obs, generator=s.generator),
                    "network": lambda m=model, x=x: m.a2c_network(x),
                    "torso": lambda t=torso, x=x: t(x),
                    "chain": lambda c=chain, x=x, ws=ws, bs=bs, a=activation: c(x, ws, bs, a),
                    # an untimed torso, then the timed op: the next launch's cost
                    "after": (lambda t=torso, x=x: t(x), lambda x=x: x.add(1.0))}
    out = {tag: collections.defaultdict(list) for tag in tags}
    with torch.no_grad():
        for what in ("forward", "network", "torso", "chain", "after"):
            for i in range(calls):  # A B, then B A: each pair from an idle card
                for tag in (tags if i % 2 == 0 else tags[::-1]):
                    before, fn = fns[tag][what] if what == "after" else (None, fns[tag][what])
                    torch.cuda.synchronize()
                    if before is not None:
                        before()
                    t0 = time.perf_counter()
                    fn()
                    t1 = time.perf_counter()
                    torch.cuda.synchronize()
                    out[tag][what].append((t1 - t0, time.perf_counter() - t0))
        for i in range(rounds):
            for tag in (tags if i % 2 == 0 else tags[::-1]):
                agent = agents[tag]
                agent._host_rollout(agent.last_state)
                t = agent._last_timing
                out[tag]["step"].append(t["play_time"] / agent.horizon_length)
                out[tag]["beside_env"].append((t["play_time"] - t["step_time"]) / agent.horizon_length)
    for tag, agent in agents.items():
        state, T, r = agent.last_state, agent.horizon_length, out[tag]
        torch.cuda.synchronize()
        with torch.no_grad(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                agent.model.forward_play(state.obs, generator=state.generator)
            torch.cuda.synchronize()
        rows = prof.key_averages()
        launches = sum(e.count for e in rows if e.key == "cudaLaunchKernel")
        host = sum(e.self_cpu_time_total for e in rows if e.key != "Activity Buffer Request")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            agent._host_rollout(state)
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        us = {k: np.median(np.array(r[k]), axis=0) * 1e6 for k in ("forward", "network", "torso", "chain", "after")}
        fused = isinstance(agent.model.a2c_network.actor_mlp, FusedMLP)
        print(f"[host_ppo] {tag} on the card, interleaved with the other (medians of {calls} calls each): "
              f"forward_play at B = {agent.num_actors} {us['forward'][0]:.1f} us to return, {us['forward'][1]:.1f} us "
              f"to finish; a2c_network {us['network'][0]:.1f} / {us['network'][1]:.1f} us; MLP torso "
              f"{us['torso'][0]:.1f} / {us['torso'][1]:.1f} us; the next op's launch after the torso "
              f"{us['after'][0]:.1f} us; "
              f"{'the kernel wrapper (fused_mlp_cuda)' if fused else 'the plain chain (plain_mlp)'} "
              f"{us['chain'][0]:.1f} / {us['chain'][1]:.1f} us; under the profiler a forward_play makes "
              f"{launches / 20:.1f} cudaLaunchKernel calls in {host / 20:.1f} us of host time; rollout step "
              f"{np.median(r['step']) * 1e3:.3f} ms ({np.median(r['beside_env']) * 1e3:.3f} ms beside the env; "
              f"rounds {[round(v * 1e3, 3) for v in r['step']]} ms); one profiled rollout: {len(events) / T:.1f} "
              f"device events a step ({len(events)} in {T} steps and the bootstrap), device busy "
              f"{sum(e.time_range.elapsed_us() for e in events) / T:.1f} us a step")


class PixelHostEnv:
    """A host env of ref/atari's shapes with no emulator behind it (the
    card's machine has no ale_py): 84x84x4 uint8 frames from a pool drawn
    once from ``seed``, 4 actions, episodes of staggered lengths with
    same-step autoreset and their final frames. Its step costs the host
    little beside handing back a frame batch, so a rollout over it times
    the policy's placement and the copies of its frames."""

    is_host_env = True
    autoreset_mode = "same_step"
    max_episode_steps = None  # the player's step budget takes its default

    def __init__(self, num_envs: int, seed: int = 0, pool: int = 8):
        rng = np.random.default_rng(seed)
        self.frames = rng.integers(0, 256, (pool, num_envs, 84, 84, 4), dtype=np.uint8)
        self.lengths = 60 + 7 * np.arange(num_envs)
        self.steps = np.zeros(num_envs, np.int64)
        self.t = 0

    def get_env_info(self):
        from rl_games_tpu_torch.envs.spaces import Box, Discrete, EnvInfo

        return EnvInfo(observation_space=Box(shape=(84, 84, 4), low=0, high=255, dtype=np.uint8),
                       action_space=Discrete(4))

    def reset(self):
        return self.frames[0]

    def step(self, actions):
        self.t += 1
        self.steps += 1
        dones = self.steps >= self.lengths
        self.steps[dones] = 0
        obs = self.frames[self.t % len(self.frames)]
        rewards = (np.asarray(actions) == self.t % 4).astype(np.float32)
        return obs, rewards, dones, {"time_outs": np.zeros_like(dones), "final_observation": obs}


def phase_host_pixel(epochs: int = 3):
    """A pixel-shaped host rollout, the other side of auto's choice:
    rl_games_tpu/configs/ref/atari/ppo_breakout.yaml as shipped (nature-CNN
    and [512] relu, 64 envs x horizon 128, 2 x 8 minibatches of 1024) over
    PixelHostEnv, through PPOAgent.host_train_epoch with the policy on the
    card and on its CPU copy, their epochs interleaved. GAE runs once an
    epoch at [128, 64, 1]; the fused MLP not at all (a conv torso). Fails
    when the faster placement is not the one auto takes for this policy."""
    from rl_games_tpu_torch.algos.ppo import PPOAgent
    from rl_games_tpu_torch.common.host_inference import auto_placement
    from rl_games_tpu_torch.ops import fused_mlp, gae

    agents, states = {}, {}
    epoch_s, play_s, env_s = (collections.defaultdict(list) for _ in range(3))
    for placement in ("default", "cpu"):
        params = load_config("ref/atari/ppo_breakout.yaml")["params"]
        params["config"]["host_inference_device"] = placement
        n, horizon = params["config"]["num_actors"], params["config"]["horizon_length"]
        agents[placement] = PPOAgent("chip_smoke_host_pixel", params, vec_env=PixelHostEnv(n, seed=3))
        states[placement] = agents[placement].init_state()
    gae.gae_launches = fused_mlp.fused_mlp_launches = fused_mlp.fused_mlp_cluster_launches = fused_mlp.fused_mlp_wgmma_launches = 0  # the training runs start here
    for _ in range(epochs):
        for placement, agent in agents.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states[placement], metrics = agent.host_train_epoch(states[placement])
            torch.cuda.synchronize()
            epoch_s[placement].append(time.perf_counter() - t0)
            play_s[placement].append(agent._last_timing["play_time"])
            env_s[placement].append(agent._last_timing["step_time"])
            if not all(math.isfinite(float(metrics[k])) for k in ("a_loss", "c_loss", "entropy")):
                raise AssertionError(f"host_pixel {placement}: losses {metrics}")
    launches = {"gae": gae.gae_launches, "fused_mlp": fused_mlp.fused_mlp_launches}  # read right after
    if launches != {"gae": 2 * epochs, "fused_mlp": 0}:
        raise AssertionError(f"host_pixel: launches {launches}; expected {2 * epochs} GAE and no fused")
    steady = {p: float(np.median(v[1:])) for p, v in epoch_s.items()}
    for p in agents:
        play = float(np.median(play_s[p][1:]))
        print(f"[host_pixel] {p}: ppo_breakout.yaml (nature-CNN, {n} envs x {horizon} steps of 84x84x4 uint8 "
              f"frames from PixelHostEnv) through host_train_epoch: first epoch {epoch_s[p][0] * 1e3:.1f} ms, "
              f"steady epoch {steady[p] * 1e3:.1f} ms (median of {epochs - 1}), {n * horizon / steady[p]:,.0f} "
              f"env-steps/s; rollout {play * 1e3:.1f} ms ({play / horizon * 1e3:.3f} ms a step, env "
              f"{float(np.median(env_s[p][1:])) / horizon * 1e3:.3f} ms of it)")
    faster = min(steady, key=steady.get)
    auto = auto_placement(agents["default"].full_params["network"])
    print(f"[host_pixel] placement: steady epoch default {steady['default'] * 1e3:.1f} ms, cpu "
          f"{steady['cpu'] * 1e3:.1f} ms: {faster} is faster at this geometry; auto takes {auto} for this policy "
          f"(a conv torso); launches {launches}")
    if faster != auto:
        raise AssertionError(f"host_pixel: {faster} is the faster placement, but auto takes {auto} "
                             "(common/host_inference.auto_placement)")
    return launches


def phase_host_sac(update_epochs: int, play_steps: int = 300, config: str = "sac_ant.yaml", tag: str = "host_sac"):
    """rl_games_tpu/configs/sac_ant.yaml at full width (32 envs, MLPs
    [256, 256] relu, batch 256, utd_ratio 1: 32 updates per env step,
    policy_frequency 2, a ring of 1e6 rows, 5000 warmup frames) with the env
    swapped as in host_ppo_params (Hopper2D-v0 on CPUENV: no MuJoCo on the
    card's machine) through Runner.run: its warmup epochs and
    ``update_epochs`` epochs of updates, then its last checkpoint played. It
    launches neither kernel. [sac_norm] runs ``config``
    ref/mujoco/sac_ant_tuned.yaml (separate layer-norm [256, 256] trunks,
    10000 warmup frames) the same way."""
    from rl_games_tpu_torch.algos import sac as sac_module
    from rl_games_tpu_torch.ops import fused_mlp, gae
    from rl_games_tpu_torch.runner import Runner

    params = load_config(config)["params"]
    cfg = params["config"]
    cfg.update(env_name="Hopper2D-v0", vecenv_type="CPUENV")
    n = cfg["num_actors"]
    warmup = math.ceil(cfg["num_warmup_frames"] / n)
    epochs = warmup + update_epochs
    cfg["player"] = {**cfg["player"], "max_steps": play_steps}
    log, ends, agents = ScalarLog(), [], []

    def mark(agent):  # stamps the end of every epoch, never stops
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        agents[:] = [agent]
        return False

    create_writer = sac_module.create_writer
    sac_module.create_writer = lambda _dir: log
    try:
        with tempfile.TemporaryDirectory() as train_dir:
            cfg.update(name=f"chip_smoke_{tag}", train_dir=train_dir, max_epochs=epochs, max_frames=-1)
            runner = Runner()  # the default device: the card
            runner.load({"params": params})
            gae.gae_launches = fused_mlp.fused_mlp_launches = fused_mlp.fused_mlp_cluster_launches = fused_mlp.fused_mlp_wgmma_launches = 0  # the training run starts here
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                _, epoch_num = runner.run({"train": True, "stop_fn": mark})
            torch.cuda.synchronize()
            train_launches = {"gae": gae.gae_launches, "fused_mlp": fused_mlp.fused_mlp_launches}  # read right after
            agent = agents[0]
            state = agent.last_state
            checkpoint = os.path.join(train_dir, f"chip_smoke_{tag}", "nn", f"last_chip_smoke_{tag}_ep_{epochs}.pth")

            gae.gae_launches = fused_mlp.fused_mlp_launches = fused_mlp.fused_mlp_cluster_launches = fused_mlp.fused_mlp_wgmma_launches = 0  # the player's run starts here
            out = io.StringIO()
            t1 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                mean_reward = runner.run({"play": True, "checkpoint": checkpoint})
            torch.cuda.synchronize()
            play_s = time.perf_counter() - t1
            play_launches = {"gae": gae.gae_launches, "fused_mlp": fused_mlp.fused_mlp_launches}  # read right after
            steady_step_s, first, last = steady_player_step(runner, checkpoint)
    finally:
        sac_module.create_writer = create_writer

    per_step = agent.num_updates_per_step
    updates = update_epochs * per_step
    rows = sac_module.replay_size(state.replay)
    # every env step's transition is in the ring but the last one, still pending
    expected_rows = (epochs - 1) * n
    losses = {k: log.tags.get(f"losses/{k}", []) for k in ("critic_loss", "actor_loss", "alpha")}
    if epoch_num != epochs or state.update_counter != updates or updates < 200 or per_step != n:
        raise AssertionError(f"{tag}: {epoch_num} epochs, {state.update_counter} updates; expected {epochs} "
                             f"epochs and {updates} updates ({n} per env step after {warmup} warmup epochs)")
    if rows != expected_rows or state.frame != expected_rows:
        raise AssertionError(f"{tag}: {rows} replay rows, frame {state.frame}; expected {expected_rows}")
    if not all(v and all(math.isfinite(x) for x in v) for v in losses.values()) or losses["alpha"][-1] == 1.0:
        raise AssertionError(f"{tag}: losses {losses}")
    no_kernel = {"gae": 0, "fused_mlp": 0}
    if train_launches != no_kernel or play_launches != no_kernel or not math.isfinite(mean_reward):
        raise AssertionError(f"{tag}: launches train {train_launches}, play {play_launches}, reward {mean_reward}")
    times = np.diff([t0, *ends])
    warm, upd = times[:warmup], times[warmup:]
    warm_s, upd_s = float(np.median(warm[1:])), float(np.median(upd[1:]))
    print(f"[{tag}] trained {epoch_num} epochs of {config} on Hopper2D-v0 (CPUENV, {n} envs x 1 step an "
          f"epoch, {warmup} warmup epochs, then {per_step} updates of batch {agent.batch_size} per env step) through "
          f"Runner.run: launches {train_launches}; {state.update_counter} updates; warmup step: first (with set-up) "
          f"{warm[0] * 1e3:.2f} ms, steady {warm_s * 1e3:.2f} ms (median of {len(warm) - 1}), "
          f"{n / warm_s:,.0f} env-steps/s; update step: first {upd[0] * 1e3:.1f} ms, steady {upd_s * 1e3:.1f} ms "
          f"(median of {len(upd) - 1}), {per_step / upd_s:,.1f} updates/s, {n / upd_s:,.0f} env-steps/s")
    print(f"[{tag}] replay rows written {rows} = ({epochs} env steps - 1 pending) x {n} envs, frame "
          f"{state.frame}; last logged critic_loss {losses['critic_loss'][-1]:.4f}, actor_loss "
          f"{losses['actor_loss'][-1]:.4f}, alpha {losses['alpha'][-1]:.5f}")
    print(f"[{tag}] played through Runner.run: launches {play_launches}, {out.getvalue().strip()!r}, "
          f"{play_s:.2f} s with set-up; steady step without set-up {steady_step_s * 1e3:.3f} ms (mean of steps "
          f"{first}-{last} of a second run)")
    train_fn = agent.make_train_fn()
    with contextlib.redirect_stdout(io.StringIO()):
        idle, busy, wall = idle_share(lambda: train_fn(state))
    print(f"[{tag}] one more update step {wall * 1e3:.1f} ms, the device busy {busy * 1e3:.1f} ms of the next "
          f"one (profiled), idle share {idle:.3f}")
    return train_launches, play_launches, upd_s


# ---------------------------------------------------------------------------
# [heads]: separate trunks, the remaining policy heads, masks and the test envs
# ---------------------------------------------------------------------------

PENDULUM_DIMS = (3, 32, 32)  # ref/ppo_pendulum.yaml: obs 3, mlp [32, 32] elu, one chain per trunk


def heads_params(tag: str):
    """The config of each [heads] run and the changes made to it (printed
    with the run): (a) ref/test/test_discrete.yaml as shipped; (b) the same
    on test_masked_env with use_action_masks; (c)
    ref/test/test_discrete_multidiscrete_mhv.yaml with multi_head_value on
    (value_size 2); (d) ref/ppo_pendulum.yaml with mlp.fused on the device
    Pendulum-v1 (its vecenv_type GYMNASIUM dropped: the card's machine has
    no gymnasium); (e) ref/ppo_pendulum_torch.yaml on the device Pendulum-v1
    as continuous_a2c (with sigma_activation softplus: the config's fixed
    sigma starts at 0, which that model reads as the std itself) and as
    continuous_a2c_tanh."""
    changes = []
    if tag in ("a", "b"):
        params = load_config("ref/test/test_discrete.yaml")["params"]
        if tag == "b":
            params["config"].update(env_name="test_masked_env", use_action_masks=True)
            changes.append("env_name test_masked_env, use_action_masks true")
    elif tag == "c":
        params = load_config("ref/test/test_discrete_multidiscrete_mhv.yaml")["params"]
        params["config"]["env_config"]["multi_head_value"] = True
        changes.append("env_config.multi_head_value true (value_size 2)")
    elif tag == "d":
        params = load_config("ref/ppo_pendulum.yaml")["params"]
        params["network"]["mlp"]["fused"] = True
        params["config"].pop("vecenv_type")
        changes.append("network.mlp.fused true; vecenv_type GYMNASIUM dropped (device Pendulum-v1)")
    else:
        params = load_config("ref/ppo_pendulum_torch.yaml")["params"]
        params["config"].pop("vecenv_type")
        params["model"]["name"] = {"e1": "continuous_a2c", "e2": "continuous_a2c_tanh"}[tag]
        changes.append(f"model.name {params['model']['name']}; vecenv_type GYMNASIUM dropped (device Pendulum-v1)")
        if tag == "e1":
            params["network"]["space"]["continuous"]["sigma_activation"] = "softplus"
            changes.append("sigma_activation softplus")
    return params, "; ".join(changes) or "as shipped"


@contextlib.contextmanager
def masked_action_check():
    """Every step of a vec env that serves masks counts the step, its envs,
    and, on the card, the envs whose action its masks forbid and the envs
    with a forbidden action; read once at the end."""
    from rl_games_tpu_torch.envs.device.base import DeviceVecEnv

    step = DeviceVecEnv.step
    seen = {"bad": torch.zeros((), dtype=torch.int64, device="cuda"),
            "bound": torch.zeros((), dtype=torch.int64, device="cuda"), "steps": 0, "env_steps": 0}

    def checked(self, state, actions):
        if self.has_action_masks:
            masks = self.get_action_masks(state)
            seen["bad"] += (~masks.gather(1, actions.long()[:, None])).sum()
            seen["bound"] += (~masks).any(-1).sum()
            seen["steps"] += 1
            seen["env_steps"] += actions.shape[0]
        return step(self, state, actions)

    DeviceVecEnv.step = checked
    try:
        yield seen
    finally:
        DeviceVecEnv.step = step


def masked_border_play(runner, checkpoint, draws: int = 64):
    """The trained policy on every env at the masks' corner (max_dist, -max_dist),
    where +x and -y are forbidden: sampled and deterministic actions."""
    player = runner.create_player()
    player.restore(checkpoint)
    env_state, obs = player.vec_env.reset(torch.Generator(device="cuda").manual_seed(0))
    lim = player.vec_env.env.max_dist
    env_state.estate.pos[:] = torch.tensor([lim, -lim], dtype=torch.int32, device="cuda")
    masks = player.vec_env.get_action_masks(env_state)
    gen, bad = torch.Generator(device="cuda").manual_seed(1), torch.zeros((), dtype=torch.int64, device="cuda")
    with torch.no_grad():
        for deterministic in (False, True):
            player.deterministic = deterministic
            for _ in range(draws):
                actions = player._play_actions(gen, obs, env_state)
                bad += (~masks.gather(1, actions[:, None])).sum()
    return int(bad), int((~masks).sum()), 2 * draws * player.num_actors


def phase_heads(epochs: int):
    """(a)-(e) of heads_params through Runner.run: train ``epochs`` epochs,
    then play the last checkpoint. Per run: the steady epoch, env-steps/s,
    the GAE and fused launches per epoch and per player step, held to the
    counts the code implies (1 GAE an epoch; for (d) 2 fused launches a
    forward: the actor's and the critic's trunk)."""
    from rl_games_tpu_torch.ops import fused_mlp

    out = {}
    for tag in ("a", "b", "c", "d", "e1", "e2"):
        params, changes = heads_params(tag)
        cfg = params["config"]
        horizon, n = cfg["horizon_length"], cfg["num_actors"]
        minibatches = cfg["mini_epochs"] * n * horizon // cfg["minibatch_size"]
        batches = []

        def counted(x, *args):  # the batch of every kernel launch
            batches.append(x.shape[0])
            return launch(x, *args)

        launch = fused_mlp.fused_mlp_cuda
        fused_mlp.fused_mlp_cuda = counted
        try:
            with masked_action_check() as seen:
                run = train_and_play(f"heads ({tag})", params, epochs, batches)
        finally:
            fused_mlp.fused_mlp_cuda = launch
        steps = run["play_steps"]
        fused = 2 if tag == "d" else 0
        # the training's batches; the player's run and its steady-step
        # run (steady_player_step) each play ``steps`` steps at B = n
        expected_batches = {} if not fused else {
            n: fused * (horizon + 1) * epochs, cfg["minibatch_size"]: fused * minibatches * epochs}
        expected_play = {} if not fused else {n: fused * steps}
        got_batches = run["train_batches"]
        if (run["train"] != {"gae": epochs, "fused_mlp": fused * (horizon + 1 + minibatches) * epochs}
                or run["play"] != {"gae": 0, "fused_mlp": fused * steps} or got_batches != expected_batches
                or run["play_batches"] != expected_play or run["steady_batches"] != expected_play):
            raise AssertionError(f"heads ({tag}): launches {run['train']} in {epochs} epochs, player {run['play']} "
                                 f"in {steps} steps, fused batches {got_batches} in training, "
                                 f"{run['play_batches']} / {run['steady_batches']} in the two player runs; expected "
                                 f"1 GAE an epoch, {fused} fused launches a forward ({expected_batches}, "
                                 f"{expected_play})")
        print(f"[heads] ({tag}) {params['model']['name']} on {cfg['env_name']} ({changes}): {n} envs x {horizon} "
              f"steps, {cfg['mini_epochs']} x {minibatches // cfg['mini_epochs']} minibatches of "
              f"{cfg['minibatch_size']}; trained {epochs} epochs through Runner.run: launches {run['train']} "
              f"({run['train']['gae'] / epochs:g} GAE and {run['train']['fused_mlp'] / epochs:g} fused an epoch, "
              f"fused batches {got_batches}); played {steps} steps: launches {run['play']} at batches "
              f"{run['play_batches']} "
              f"({run['play']['fused_mlp'] / steps:g} fused a player step), {run['play_out']!r}")
        cluster = check_cluster_launches(f"heads ({tag})", PENDULUM_DIMS, {
            "training": (run["train_cluster"], got_batches), "player": (run["play_cluster"], run["play_batches"])})
        epoch_s = report_epochs(f"heads ({tag})", run["times"], n * horizon, run["peak_gib"])
        print(f"[heads] ({tag}) steady player step {run['steady_step_s'] * 1e3:.2f} ms at {n} envs")
        if tag == "b":
            bad = int(seen["bad"])
            print(f"[heads] (b) masks checked at {seen['steps']} vec-env steps of training and play (the epoch "
                  f"times above include the check), {seen['env_steps']} env-steps: {bad} masked actions sampled, "
                  f"{int(seen['bound'])} of the env-steps with a forbidden action")
            if bad or not seen["steps"]:
                raise AssertionError(f"heads (b): {bad} masked actions sampled in {seen['steps']} checked steps")
        out[tag] = {**run, "epoch_s": epoch_s, "cluster": cluster}
    # (b)'s policy where the masks bind, sampled and deterministic
    params, _ = heads_params("b")
    with tempfile.TemporaryDirectory() as train_dir:
        from rl_games_tpu_torch.runner import Runner

        params["config"].update(train_dir=train_dir, max_epochs=1)
        runner = Runner()
        runner.load({"params": params})
        with contextlib.redirect_stdout(io.StringIO()):
            runner.run({"train": True})
        nn_dir = os.path.join(train_dir, params["config"]["name"], "nn")
        checkpoint = os.path.join(nn_dir, [f for f in os.listdir(nn_dir) if "_rew_" in f][0])
        bad, forbidden, actions = masked_border_play(runner, checkpoint)
    print(f"[heads] (b) the player at the masks' corner: {actions} actions, {forbidden} forbidden (env, action) "
          f"pairs, {bad} masked actions sampled")
    if bad or not forbidden:
        raise AssertionError(f"heads (b): the player at the masks' corner sampled {bad} masked actions")
    return out


def reference_heads():
    """One update of (c)'s MultiDiscrete, multi-head-value model and of (d)'s
    separate, state-dependent-sigma model (fused on the card, the plain chain
    on the CPU), card against CPU on the same trajectory, held as the Pong
    update is (check_first_update)."""
    from rl_games_tpu_torch.algos.ppo import PPOAgent

    for tag, num_actors, horizon in (("c", 16, 64), ("d", 16, 64)):
        params, _ = heads_params(tag)
        params["config"].update(num_actors=num_actors, horizon_length=horizon, minibatch_size=256)
        gpu, cpu = PPOAgent("ref", params, device="cuda"), PPOAgent("ref", params, device="cpu")
        gstate, cstate = gpu.init_state(), cpu.init_state()
        cpu.model.load_state_dict({k: v.cpu() for k, v in gpu.model.state_dict().items()})
        traj, last_values = gpu._rollout(gstate)
        cstate.dones = gstate.dones.cpu()
        gds = gpu._prepare_dataset(gstate, traj, last_values)
        cds = cpu._prepare_dataset(cstate, {k: v.cpu() for k, v in traj.items()}, last_values.cpu())
        dadv = float((gds["advantages"].cpu() - cds["advantages"]).abs().max())
        update = check_first_update(gpu, cpu, gstate, cstate, gds, cds)
        what = {"c": "MultiDiscrete (2, 3), value_size 2", "d": "separate trunks, state-dependent sigma, fused"}[tag]
        print(f"[reference] heads ({tag}) {what}, {num_actors} envs x {horizon} steps: GAE of values "
              f"{tuple(traj['values'].shape)} card vs CPU max |dadv| {dadv:.2e}; one minibatch of 256: {update}")
        if not dadv < 1e-4:
            raise AssertionError(f"heads ({tag}): the card's advantages disagree with the CPU's: {dadv}")


RND_CONFIG = {  # ref/smac/v1/3m_torch_sparse.yaml's rnd_config (the mlp.rnd / mlp.net schema)
    "scale_value": 1, "episodic": True, "episode_length": 128, "gamma": 0.99, "mini_epochs": 2,
    "minibatch_size": 1536, "learning_rate": 5e-4,
    "network": {"name": "rnd_curiosity", "mlp": {"rnd": {"units": [512, 256, 128, 64]},
                                                 "net": {"units": [128, 64, 64]}, "activation": "elu",
                                                 "initializer": {"name": "default"}}},
}


def rnn_params(tag: str):
    """The config of each [rnn] run and the changes made to it (printed
    with the run): (a) ref/test/test_rnn.yaml (separate LSTM trunks on the
    memory env); (b) ref/test/test_asymmetric_continuous.yaml (separate LSTM
    trunks with a layer norm, an LSTM central value net); (c)
    ref/test/test_asymmetric_discrete_mhv.yaml with multi_head_value on
    (its LSTM central value net at value_size 2); (d) ref/ppo_walker_rnn.yaml
    on the device Walker2D in place of BipedalWalker-v3 (the card's machine
    has no gymnasium or Box2D) with mlp.fused: the MLP [256, 128, 64] in
    one launch in front of the GRU 64; (f) ppo_cartpole.yaml with RND
    (ref/smac/v1/3m_torch_sparse.yaml's rnd_config), Gaussian soft
    augmentation, permute_batches and normalize_rms_advantage. The players
    of (b), (d) and (f) play 200 steps."""
    changes = []
    if tag == "a":
        params = load_config("ref/test/test_rnn.yaml")["params"]
    elif tag == "b":
        params = load_config("ref/test/test_asymmetric_continuous.yaml")["params"]
    elif tag == "c":
        params = load_config("ref/test/test_asymmetric_discrete_mhv.yaml")["params"]
        params["config"]["env_config"]["multi_head_value"] = True
        changes.append("env_config.multi_head_value true (value_size 2)")
    elif tag == "d":
        params = load_config("ref/ppo_walker_rnn.yaml")["params"]
        params["config"]["env_name"] = "Walker2D"
        params["config"].pop("vecenv_type")
        params["network"]["mlp"]["fused"] = True
        changes.append("env_name Walker2D (device), vecenv_type GYMNASIUM dropped; network.mlp.fused true")
    else:
        params = load_config("ppo_cartpole.yaml")["params"]
        params["config"].update(rnd_config=RND_CONFIG, permute_batches=True, normalize_rms_advantage=True,
                                features={"soft_augmentation": {"transform": {"name": "gaussian_noise", "std": 0.05},
                                                                "aug_coef": 0.001}})
        changes.append("rnd_config (ref/smac/v1/3m_torch_sparse.yaml's), soft augmentation gaussian_noise std 0.05, "
                       "permute_batches, normalize_rms_advantage")
    if tag in ("b", "d", "f"):
        params["config"]["player"] = {**params["config"].get("player", {}), "max_steps": 200}
        changes.append("player max_steps 200")
    return params, "; ".join(changes) or "as shipped"


def to_cpu(traj):
    """A trajectory's tensors on the CPU: the recurrent snapshots' tuples and
    a dict observation's keys entry by entry."""
    def cpu(v):
        if isinstance(v, tuple):
            return tuple(x.cpu() for x in v)
        if isinstance(v, dict):
            return {k: x.cpu() for k, x in v.items()}
        return v.cpu()

    return {k: cpu(v) for k, v in traj.items()}


def rnn_rollout_profile(params):
    """The rollout step of ``params`` on the card: the wall time of a step
    (one rollout of the config's horizon after a warm-up one, over its
    steps) and the device kernels a step launches (one rollout of two
    windows under torch.profiler); with an RNN, the kernels of one step of
    the actor's core alone, with dones (a forward of 9 steps less one of 1,
    over 8)."""
    from rl_games_tpu_torch.algos.ppo import PPOAgent

    agent = PPOAgent("rnn_profile", params)
    state = agent.init_state()
    agent._rollout(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    agent._rollout(state)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / agent.horizon_length
    horizon = 2 * (agent.seq_length if agent.any_rnn else 8)
    agent.horizon_length = horizon
    kernels = len(device_events(lambda: agent._rollout(state), 1)) / horizon
    core_kernels = None
    if agent.is_rnn:
        net = agent.model.a2c_network
        core = getattr(net, "a_rnn" if net.separate else "rnn")
        w = core.rnn.weight_ih_l0
        x = torch.randn((agent.num_actors, 9, w.shape[1]), device=w.device)
        dones = torch.zeros((agent.num_actors, 9), device=w.device)
        with torch.no_grad():
            nine = len(device_events(lambda: core(x, None, dones), 1))
            one = len(device_events(lambda: core(x[:, :1], None, dones[:, :1]), 1))
        core_kernels = (nine - one) / 8
    return step_s, kernels, core_kernels


def phase_rnn(epochs: int):
    """(a)-(d) and (f) of rnn_params through Runner.run: train ``epochs``
    epochs, then play the last checkpoint; (e) through train_epoch. Per
    run: the steady epoch, env-steps/s, the rollout step and its kernels,
    the player's steady step, the GAE and fused launches per epoch and per
    player step, held to the counts the code implies (1 GAE an epoch; (d)
    one fused launch a forward, (e) the flagship's 33 an epoch). The player
    of a recurrent policy starts every step from zero states, as the JAX
    package's does (ROADMAP §3, fault 4)."""
    from rl_games_tpu_torch.ops import fused_mlp

    out = {}
    for tag in ("a", "b", "c", "d", "f"):
        params, changes = rnn_params(tag)
        cfg = params["config"]
        horizon, n = cfg["horizon_length"], cfg["num_actors"]
        minibatches = cfg["mini_epochs"] * n * horizon // cfg["minibatch_size"]
        batches = []

        def counted(x, *args):  # the batch of every kernel launch
            batches.append(x.shape[0])
            return launch(x, *args)

        launch = fused_mlp.fused_mlp_cuda
        fused_mlp.fused_mlp_cuda = counted
        try:
            run = train_and_play(f"rnn ({tag})", params, epochs, batches)
        finally:
            fused_mlp.fused_mlp_cuda = launch
        steps = run["play_steps"]
        fused = 1 if tag == "d" else 0
        # use_diagnostics times the rollout once: 4 rollouts before the first epoch
        rollouts = epochs + (4 if cfg.get("use_diagnostics") else 0)
        expected_batches = {} if not fused else {
            n: fused * (horizon + 1) * rollouts, cfg["minibatch_size"]: fused * minibatches * epochs}
        expected_play = {} if not fused else {n: fused * steps}
        if (run["train"] != {"gae": epochs, "fused_mlp": fused * ((horizon + 1) * rollouts + minibatches * epochs)}
                or run["play"] != {"gae": 0, "fused_mlp": fused * steps} or run["train_batches"] != expected_batches
                or run["play_batches"] != expected_play or run["steady_batches"] != expected_play):
            raise AssertionError(f"rnn ({tag}): launches {run['train']} in {epochs} epochs, player {run['play']} in "
                                 f"{steps} steps, fused batches {run['train_batches']} in training, "
                                 f"{run['play_batches']} / {run['steady_batches']} in the two player runs; expected "
                                 f"1 GAE an epoch, {fused} fused launch a forward ({expected_batches}, {expected_play})")
        cluster = check_cluster_launches(f"rnn ({tag})", WALKER_DIMS, {
            "training": (run["train_cluster"], run["train_batches"]), "player": (run["play_cluster"], run["play_batches"])})
        rnn = params["network"].get("rnn")
        cv = (cfg.get("central_value_config") or {}).get("network", {}).get("rnn")
        what = (f"{rnn['name']} {rnn['units']}" if rnn else "no rnn") + (f", central value {cv['name']} {cv['units']}"
                                                                        if cv else "")
        print(f"[rnn] ({tag}) {params['model']['name']} on {cfg['env_name']} ({what}; {changes}): {n} envs x "
              f"{horizon} steps, seq_length {cfg.get('seq_length', 4)}, {cfg['mini_epochs']} x "
              f"{minibatches // cfg['mini_epochs']} minibatches of {cfg['minibatch_size']}; trained {epochs} epochs "
              f"through Runner.run: launches {run['train']} ({run['train']['gae'] / epochs:g} GAE and "
              f"{run['train']['fused_mlp'] / epochs:g} fused an epoch, fused batches {run['train_batches']}); played "
              f"{steps} steps: launches {run['play']} ({run['play']['fused_mlp'] / steps:g} fused a player step), "
              f"{run['play_out']!r}")
        epoch_s = report_epochs(f"rnn ({tag})", run["times"], n * horizon, run["peak_gib"])
        step_s, kernels, core_kernels = rnn_rollout_profile(params)
        print(f"[rnn] ({tag}) rollout step {step_s * 1e3:.3f} ms at {n} envs ({kernels:.1f} device kernels a step"
              + (f"; the actor's {rnn['name']} core alone {core_kernels:g} a step" if core_kernels is not None else "")
              + f"); steady player step {run['steady_step_s'] * 1e3:.2f} ms")
        out[tag] = {**run, "epoch_s": epoch_s, "rollout_step_s": step_s, "kernels_per_step": kernels,
                    "core_kernels_per_step": core_kernels, "cluster": cluster}
    out["e"] = phase_rnn_mixed_precision(3)
    return out


def phase_rnn_mixed_precision(epochs: int):
    """(e): the fused flagship (8192 Ant2D envs) with mixed_precision through
    train_epoch: each minibatch's forwards take the weights rounded to
    bfloat16 (the fused kernel gets them as float32), the rollout the
    float32 weights; 17 fused launches at B = 8192 and 16 at B = 32768 an
    epoch."""
    from rl_games_tpu_torch.algos.ppo import PPOAgent
    from rl_games_tpu_torch.ops import fused_mlp, gae

    params = flagship_params(8192)
    params["network"]["mlp"]["fused"] = True
    params["config"]["mixed_precision"] = True
    agent = PPOAgent("chip_smoke_mixed", params)
    state = agent.init_state()
    batches = []
    launch = fused_mlp.fused_mlp_cuda

    def counted(x, *args):
        batches.append(x.shape[0])
        return launch(x, *args)

    fused_mlp.fused_mlp_cuda = counted
    torch.cuda.reset_peak_memory_stats()
    gae.gae_launches = fused_mlp.fused_mlp_launches = fused_mlp.fused_mlp_cluster_launches = fused_mlp.fused_mlp_wgmma_launches = 0  # the main path's run starts here
    times = []
    try:
        for epoch in range(epochs):
            t0 = time.perf_counter()
            state, m = agent.train_epoch(state)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if not (math.isfinite(float(m["a_loss"])) and math.isfinite(float(m["c_loss"]))):
                raise AssertionError(f"rnn (e): non-finite losses in epoch {epoch + 1}")
    finally:
        fused_mlp.fused_mlp_cuda = launch
    launches = {"gae": gae.gae_launches, "fused_mlp": fused_mlp.fused_mlp_launches}  # read right after
    wgmma = fused_mlp.fused_mlp_wgmma_launches
    got_batches = {b: batches.count(b) for b in sorted(set(batches))}
    expected_batches = {8192: 17 * epochs, 32768: 16 * epochs}
    check_wgmma_launches("rnn (e)", FLAGSHIP_DIMS, {"train": (wgmma, expected_batches)})
    if launches != {"gae": epochs, "fused_mlp": 33 * epochs} or got_batches != expected_batches:
        raise AssertionError(f"rnn (e): launches {launches} at batches {got_batches} in {epochs} epochs, expected "
                             f"1 GAE and 33 fused an epoch at {expected_batches}")
    print(f"[rnn] (e) the fused flagship (8192 Ant2D envs x 16) with mixed_precision, {epochs} epochs through "
          f"train_epoch: launches {launches} at batches {got_batches}; a_loss {float(m['a_loss']):.4f}, "
          f"c_loss {float(m['c_loss']):.4f}, kl {float(m['kl']):.5f}, lr {float(m['lr']):.2e}")
    epoch_s = report_epochs("rnn (e)", np.array(times), agent.batch_size, torch.cuda.max_memory_allocated() / 2**30)
    return {"train": launches, "train_batches": got_batches, "epoch_s": epoch_s}


def reference_rnn():
    """One update of [rnn] (b) (LSTM trunks and an LSTM central value net)
    and (d) (the fused MLP into a GRU) on the card against the CPU on the
    same trajectory: the policy's first Adam step held as the Pong update
    is (check_first_update); for (b) also the central value net's first
    minibatch: its loss within 2e-5 relative and its gradients within 1e-5
    of each tensor's largest entry."""
    from rl_games_tpu_torch.algos.ppo import PPOAgent
    from rl_games_tpu_torch.ops import losses as PL

    for tag in ("b", "d"):
        params, _ = rnn_params(tag)
        params["config"].update(num_actors=16, horizon_length=64, minibatch_size=256)
        if tag == "b":
            params["config"]["central_value_config"]["minibatch_size"] = 256
        gpu, cpu = PPOAgent("ref", params, device="cuda"), PPOAgent("ref", params, device="cpu")
        gstate, cstate = gpu.init_state(), cpu.init_state()
        cpu.model.load_state_dict({k: v.cpu() for k, v in gpu.model.state_dict().items()})
        if gpu.has_central_value:
            cpu.cv_model.load_state_dict({k: v.cpu() for k, v in gpu.cv_model.state_dict().items()})
        traj, last_values = gpu._rollout(gstate)
        cstate.dones = gstate.dones.cpu()
        gds = gpu._prepare_dataset(gstate, traj, last_values)
        cds = cpu._prepare_dataset(cstate, to_cpu(traj), last_values.cpu())
        dadv = float((gds["advantages"].cpu() - cds["advantages"]).abs().max())
        detail = ""
        if gpu.has_central_value:
            losses, grads = [], []
            for agent, ds in ((gpu, gds), (cpu, cds)):
                mb = agent._minibatch(ds, 0, agent.cv_minibatch_size, "cv_rnn_states", agent.cv_games_num)
                res = agent.cv_model.forward_train(mb["states"], rnn_states=mb["rnn_states"], dones=mb["dones"],
                                                   seq_length=agent.seq_length)
                loss = PL.critic_loss(mb["old_values"], res["values"], agent.cv_e_clip, mb["returns"],
                                      agent.cv_clip_value).mean()
                losses.append(float(loss.detach()))
                grads.append(torch.autograd.grad(loss, agent.cv_params, allow_unused=True, materialize_grads=True))
            dgrad = max(float((g.cpu() - c).abs().max() / c.abs().max().clamp(min=1e-30)) for g, c in zip(*grads))
            dloss = abs(losses[0] - losses[1]) / abs(losses[1])
            detail = (f"; central value net's first minibatch: loss {losses[0]:.7f} / {losses[1]:.7f} (relative "
                      f"{dloss:.2e}), gradients within {dgrad:.2e} of each tensor's largest entry")
            if not (dloss < 2e-5 and dgrad < 1e-5):
                raise AssertionError(f"rnn ({tag}): the central value net on the card disagrees with the CPU{detail}")
        update = check_first_update(gpu, cpu, gstate, cstate, gds, cds)
        what = {"b": "LSTM trunks, LSTM central value net", "d": "fused MLP into a GRU, Walker2D"}[tag]
        print(f"[reference] rnn ({tag}) {what}, 16 envs x 64 steps: max |dadv| {dadv:.2e}{detail}; one minibatch "
              f"of 256 (8 sequences of 32 for (d), 64 of 4 for (b)): {update}")
        if not dadv < 1e-4:
            raise AssertionError(f"rnn ({tag}): the card's advantages disagree with the CPU's: {dadv}")


# ---------------------------------------------------------------------------
# [dict]: dict observations and the custom test networks (A8 (a))
# ---------------------------------------------------------------------------

DICT_CONFIGS = {"mops": "ref/test/test_asymmetric_discrete_mhv_mops.yaml",
                "aux": "ref/test/test_discrite_testnet_aux_loss.yaml"}


def phase_dict(epochs: int):
    """ref/test/test_asymmetric_discrete_mhv_mops.yaml (testnet_dict over
    test_dict_obs_env's {'pos', 'info'}) and test_discrite_testnet_aux_loss.yaml
    (testnet_aux_loss, its 'aux_target' and aux loss) as shipped: 16 envs x
    256 steps, 4 mini-epochs of 2 minibatches of 2048, each config's
    import_modules mapped to the port's test network; trained ``epochs``
    epochs through Runner.run, then played (100 games, deterministic). Per
    run: the steady epoch, env-steps/s, the rollout step and its device
    kernels, the player's steady step; 1 GAE launch an epoch at [256, 16, 1]
    and no fused one (the custom network's MLP is the plain chain); the
    device's idle share of one more epoch."""
    from rl_games_tpu_torch.algos.ppo import PPOAgent

    out = {}
    for tag, name in DICT_CONFIGS.items():
        params = load_config(name)["params"]
        cfg = params["config"]
        horizon, n = cfg["horizon_length"], cfg["num_actors"]
        minibatches = cfg["mini_epochs"] * n * horizon // cfg["minibatch_size"]
        run = train_and_play(f"dict ({tag})", params, epochs)
        steps = run["play_steps"]
        if run["train"] != {"gae": epochs, "fused_mlp": 0} or run["play"] != {"gae": 0, "fused_mlp": 0}:
            raise AssertionError(f"dict ({tag}): launches {run['train']} in {epochs} epochs, player {run['play']} in "
                                 f"{steps} steps; expected 1 GAE an epoch and no fused launch")
        print(f"[dict] ({tag}) {params['network']['name']} on {cfg['env_name']} "
              f"(env_config {cfg.get('env_config', {})}, import_modules {cfg['import_modules']}): {n} envs x {horizon} "
              f"steps, {cfg['mini_epochs']} x {minibatches // cfg['mini_epochs']} minibatches of "
              f"{cfg['minibatch_size']}; trained {epochs} epochs through Runner.run: launches {run['train']} "
              f"({run['train']['gae'] / epochs:g} GAE an epoch at [{horizon}, {n}, 1]); played {steps} steps: launches "
              f"{run['play']}, {run['play_out']!r}")
        epoch_s = report_epochs(f"dict ({tag})", run["times"], n * horizon, run["peak_gib"])
        step_s, kernels, _ = rnn_rollout_profile(params)
        agent = PPOAgent("dict_profile", params)
        state = agent.init_state()
        agent.train_epoch(state)  # a warm-up epoch
        idle, busy, wall = idle_share(lambda: agent.train_epoch(state))
        print(f"[dict] ({tag}) rollout step {step_s * 1e3:.3f} ms at {n} envs ({kernels:.1f} device kernels a step); "
              f"steady player step {run['steady_step_s'] * 1e3:.2f} ms; one more epoch {wall * 1e3:.1f} ms, the "
              f"device busy {busy * 1e3:.1f} ms of the next one (profiled), idle share {idle:.3f}")
        out[tag] = {**run, "epoch_s": epoch_s, "rollout_step_s": step_s, "kernels_per_step": kernels, "idle": idle}
    return out


def reference_dict():
    """One update of test_discrite_testnet_aux_loss.yaml's model (the aux
    loss among it) on the card against the CPU on the same trajectory of
    dict observations (16 envs x 64 steps), through check_first_update."""
    from rl_games_tpu_torch.algos.ppo import PPOAgent
    from rl_games_tpu_torch.runner import import_user_module

    params = load_config(DICT_CONFIGS["aux"])["params"]
    for module in params["config"]["import_modules"]:
        import_user_module(module)
    params["config"].update(num_actors=16, horizon_length=64, minibatch_size=256)
    gpu, cpu = PPOAgent("ref", params, device="cuda"), PPOAgent("ref", params, device="cpu")
    gstate, cstate = gpu.init_state(), cpu.init_state()
    cpu.model.load_state_dict({k: v.cpu() for k, v in gpu.model.state_dict().items()})
    traj, last_values = gpu._rollout(gstate)
    if set(traj["obses"]) != {"pos", "info", "aux_target"}:
        raise AssertionError(f"dict: the trajectory's observations are {sorted(traj['obses'])}")
    cstate.dones = gstate.dones.cpu()
    gds = gpu._prepare_dataset(gstate, traj, last_values)
    cds = cpu._prepare_dataset(cstate, to_cpu(traj), last_values.cpu())
    dadv = float((gds["advantages"].cpu() - cds["advantages"]).abs().max())
    aux = [float(agent._loss_and_kl(agent._minibatch(ds, 0), st.entropy_coef)[0].detach())
           for agent, ds, st in ((gpu, gds, gstate), (cpu, cds, cstate))]
    update = check_first_update(gpu, cpu, gstate, cstate, gds, cds)
    print(f"[reference] dict (aux) testnet_aux_loss over {{'pos', 'info', 'aux_target'}}, 16 envs x 64 steps: max "
          f"|dadv| {dadv:.2e}; first minibatch's total loss (the aux loss in it) {aux[0]:.7f} / {aux[1]:.7f}; one "
          f"minibatch of 256: {update}")
    if not (dadv < 1e-4 and abs(aux[0] - aux[1]) <= 2e-5 * abs(aux[1])):
        raise AssertionError(f"dict: the card disagrees with the CPU: advantages {dadv}, losses {aux}")


PIXEL_VECENV = "CHIP_SMOKE_PIXEL"  # PixelHostEnv under a vecenv type of its own


def impala_params(tag: str) -> dict:
    """ref/atari/ppo_breakout_torch_impala.yaml as shipped (resnet_actor_critic,
    depths 16/32/32, MLP 512, LSTM 256; 16 envs x 256 steps, seq_length 8,
    3 mini-epochs of minibatch 512), its env swapped for PixelHostEnv (the
    card's machine has no ale_py), registered as a vecenv type so that
    Runner, the trainer and the player build it; (b) with cnn.use_attention."""
    from rl_games_tpu_torch.envs import registry

    registry.register_vecenv_type(PIXEL_VECENV, lambda cfg, num_actors, device=None, **kw: PixelHostEnv(num_actors,
                                                                                                       seed=3))
    params = load_config("ref/atari/ppo_breakout_torch_impala.yaml")["params"]
    params["config"].update(vecenv_type=PIXEL_VECENV, env_config={})
    if tag == "b":
        params["network"]["cnn"]["use_attention"] = True
    return params


def host_rollout_profile(params, steps: int = 16):
    """The host rollout of ``params`` on the card: (its step's wall time, the
    device kernels a step launches, the device's idle share of an epoch and
    its busy and wall seconds). The step time comes from one epoch after a
    warm-up one (its rollout over the horizon), the idle share from the next
    two (``idle_share``), the kernels from a profiled rollout of ``steps``
    steps."""
    from rl_games_tpu_torch.algos.ppo import PPOAgent

    agent = PPOAgent("host_profile", params)
    state = agent.init_state()
    agent.host_train_epoch(state)  # a warm-up epoch
    agent.host_train_epoch(state)
    step_s = agent._last_timing["play_time"] / agent.horizon_length
    idle, busy, wall = idle_share(lambda: agent.host_train_epoch(state))
    agent.horizon_length = steps
    kernels = len(device_events(lambda: agent._host_rollout(state), 1)) / steps
    return step_s, kernels, idle, busy, wall


def phase_impala(epochs: int, play_steps: int = 100):
    """impala_params (a) and (b) through Runner.run: train ``epochs`` epochs,
    then play ``play_steps`` steps of the last checkpoint. Per run: the steady
    epoch, env-steps/s, the host rollout's step and its device kernels, the
    idle share of an epoch; 1 GAE launch an epoch, at [256, 16, 1] (each
    launch's shape recorded), and no fused one (the MLP behind the tower is
    the plain chain). PixelHostEnv's frames are those of the [host_pixel]
    phase; a conv torso's rollout runs on the card (host_inference_device
    auto)."""
    from rl_games_tpu_torch.ops import gae

    out = {}
    for tag in ("a", "b"):
        params = impala_params(tag)
        cfg = params["config"]
        cfg["player"] = {**cfg["player"], "max_steps": play_steps}
        horizon, n = cfg["horizon_length"], cfg["num_actors"]
        shapes = []
        launch = gae.gae_cuda

        def counted(rewards, *args):  # the shape of every GAE launch
            shapes.append(tuple(rewards.shape))
            return launch(rewards, *args)

        gae.gae_cuda = counted
        try:
            run = train_and_play(f"impala ({tag})", params, epochs)
        finally:
            gae.gae_cuda = launch
        if (run["train"] != {"gae": epochs, "fused_mlp": 0} or run["play"] != {"gae": 0, "fused_mlp": 0}
                or shapes != [(horizon, n, 1)] * epochs):
            raise AssertionError(f"impala ({tag}): launches {run['train']} in {epochs} epochs at {shapes}, player "
                                 f"{run['play']}; expected 1 GAE an epoch at [{horizon}, {n}, 1], no fused launch")
        net = params["network"]
        print(f"[impala] ({tag}) {net['name']} (depths {net['cnn']['conv_depths']}, attention "
              f"{net['cnn'].get('use_attention', False)}, MLP {net['mlp']['units']}, {net['rnn']['name']} "
              f"{net['rnn']['units']}) over PixelHostEnv's 84x84x4 frames: {n} envs x {horizon} steps, seq_length "
              f"{cfg['seq_length']}, {cfg['mini_epochs']} x {n * horizon // cfg['minibatch_size']} minibatches of "
              f"{cfg['minibatch_size']}; trained {epochs} epochs through Runner.run: launches {run['train']} (GAE at "
              f"{shapes[0]}); played {run['play_steps']} steps: launches {run['play']}, {run['play_out']!r}")
        epoch_s = report_epochs(f"impala ({tag})", run["times"], n * horizon, run["peak_gib"])
        step_s, kernels, idle, busy, wall = host_rollout_profile(params)
        print(f"[impala] ({tag}) rollout step {step_s * 1e3:.3f} ms at {n} envs ({kernels:.1f} device kernels a "
              f"step); steady player step {run['steady_step_s'] * 1e3:.2f} ms; one more epoch {wall * 1e3:.1f} ms, "
              f"the device busy {busy * 1e3:.1f} ms of the next one (profiled), idle share {idle:.3f}")
        out[tag] = {**run, "epoch_s": epoch_s, "rollout_step_s": step_s, "kernels_per_step": kernels, "idle": idle}
    return out


def reference_impala():
    """[impala] on the card against the CPU, through check_first_update
    (float32 convolutions: TF32 would show), the gradients of both held to
    the CPU's float64 gradients: (a)'s model, one minibatch of 128 of a host
    trajectory of 16 envs x 16 steps (two windows of 8); then
    its tower with use_bn and use_zero_init (statistics and alphas drawn off
    their init) and weight_decay 0.01: the frozen statistics take no
    gradient, so the decay alone moves them, alike on the card and the
    CPU."""
    from rl_games_tpu_torch.algos.ppo import PPOAgent

    for label, patch in (("(a)", {}), ("use_bn + use_zero_init, weight_decay 0.01",
                                       {"cnn": {"use_bn": True, "use_zero_init": True}})):
        params = impala_params("a")
        params["network"]["cnn"].update(patch.get("cnn", {}))
        params["config"].update(horizon_length=16, minibatch_size=128, weight_decay=0.01 if patch else 0.0)
        gpu, cpu = PPOAgent("ref", params, device="cuda"), PPOAgent("ref", params, device="cpu")
        gstate, cstate = gpu.init_state(), cpu.init_state()
        if patch:
            gen = torch.Generator(device="cuda").manual_seed(11)
            with torch.no_grad():
                for name, p in gpu.model.named_parameters():
                    if name.endswith(("running_mean", "alpha")):
                        p.normal_(0.0, 0.5, generator=gen)
                    elif name.endswith("running_var"):
                        p.uniform_(0.5, 2.0, generator=gen)
        cpu.model.load_state_dict({k: v.cpu() for k, v in gpu.model.state_dict().items()})
        before = {k: v.clone() for k, v in gpu.model.state_dict().items()}
        traj, last_values = gpu._host_rollout(gstate)
        cstate.dones = gstate.dones.cpu()
        gds = gpu._prepare_dataset(gstate, traj, last_values)
        cds = cpu._prepare_dataset(cstate, to_cpu(traj), last_values.cpu())
        # the tower's first conv sums its gradients over 128 x 84 x 84 positions: the CPU's float32 gradients
        # are about 1e-2 of the largest entry from float64 there (PERF.md §6), so the 1e-5 between
        # card and CPU cannot hold: both are held to float64. grad_norm 0.5 clips the gradients by about 5e-3,
        # which leaves about a fifth of the entries above |g| = 1e-5 for the step check
        update = check_first_update(gpu, cpu, gstate, cstate, gds, cds, float64_reference=True, min_far_share=0.1)
        print(f"[reference] impala {label} over PixelHostEnv's 84x84x4 frames, 16 envs x 16 steps, one minibatch of "
              f"128: {update}")
        if patch:
            stats = [k for k in before if k.startswith("a2c_network") and k.endswith(("running_mean", "running_var"))]
            gsd, csd = gpu.model.state_dict(), cpu.model.state_dict()
            moved = min(float((gsd[k] - before[k]).abs().max()) for k in stats)
            apart = max(float((gsd[k].cpu() - csd[k]).abs().max()) for k in stats)
            print(f"[reference] impala frozen statistics ({len(stats)} tensors): each moved by the decay, at least "
                  f"{moved:.3e} at its largest entry; card against CPU {apart:.2e}")
            if not (moved > 0 and apart < 1e-6):
                raise AssertionError(f"impala: the frozen statistics moved {moved} on the card, {apart} from the CPU")


def reference_twohot():
    """[twohot]: one minibatch update of ppo_cartpole.yaml's model with the
    two-hot value head (its loss the two-hot log-prob of the symlog
    returns), card against CPU, through check_first_update, the gradients
    of both held to the CPU's float64 gradients."""
    from rl_games_tpu_torch.algos.ppo import PPOAgent

    params = load_config("ppo_cartpole.yaml")["params"]
    params["network"]["value_head"] = "twohot"
    gpu, cpu = PPOAgent("ref", params, device="cuda"), PPOAgent("ref", params, device="cpu")
    gstate, cstate = gpu.init_state(), cpu.init_state()
    cpu.model.load_state_dict({k: v.cpu() for k, v in gpu.model.state_dict().items()})
    traj, last_values = gpu._rollout(gstate)
    cstate.dones = gstate.dones.cpu()
    gds = gpu._prepare_dataset(gstate, traj, last_values)
    cds = cpu._prepare_dataset(cstate, to_cpu(traj), last_values.cpu())
    # the policy's logit biases take a gradient that cancels over the minibatch's normalized advantages:
    # the CPU's float32 gradient there is 1.55e-5 of its largest entry from float64 (PERF.md §6)
    print(f"[reference] twohot ppo_cartpole.yaml, 255-bin value head, one minibatch of {gpu.minibatch_size}: "
          + check_first_update(gpu, cpu, gstate, cstate, gds, cds, float64_reference=True))


def reference_connect4():
    """connect4net as ref/ma/ppo_connect4_self_play_resnet.yaml configures it
    (5 blocks of 128 channels), card against CPU on 256 random boards: the
    train dict within 1e-5, and the gradients of a loss over it held to the
    CPU's float64 gradients as check_first_update's float64_reference holds
    them (no tensor's card gradient further from float64, relative to its
    largest entry, than the larger of 1e-5 and three times the CPU float32
    gradients' worst distance: behind GroupNorm some biases' gradients
    cancel to 1e-3 of float32's reach)."""
    import copy

    from rl_games_tpu_torch.models.model_builder import ModelBuilder
    from rl_games_tpu_torch.runner import import_user_module
    from rl_games_tpu_torch.utils.device import use_full_float32

    use_full_float32(torch.device("cuda"))  # as PPOAgent and the players set it
    params = load_config("ref/ma/ppo_connect4_self_play_resnet.yaml")["params"]
    for module in params["config"]["import_modules"]:
        import_user_module(module)
    shape, kw = (6, 7, 2), dict(actions_num=7, input_shape=(6, 7, 2))
    gpu, cpu = (ModelBuilder().load(params, **kw, device=d) for d in ("cuda", "cpu"))
    gpu.reset_parameters(torch.Generator(device="cuda").manual_seed(5))
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    gen = torch.Generator().manual_seed(6)
    obs = torch.randint(0, 2, (256, *shape), generator=gen).to(torch.float32)
    actions = torch.randint(0, 7, (256,), generator=gen)
    results = []
    for model, dev, dtype in ((gpu, "cuda", torch.float32), (cpu, "cpu", torch.float32),
                              (copy.deepcopy(cpu).double(), "cpu", torch.float64)):
        res = model.forward_train(obs.to(dev, dtype), actions.to(dev))
        loss = res["prev_neglogp"].mean() + res["values"].mean() + 0.1 * res["entropy"].mean()
        results.append((res, [g.double() for g in torch.autograd.grad(loss, list(model.parameters()))]))
    (gres, ggrads), (cres, cgrads), (_, ref) = results
    dout = max(float((gres[k].detach().cpu() - cres[k].detach()).abs().max()) for k in ("logits", "values"))
    dgrad, cpu_f32 = float64_distance(ggrads, ref), float64_distance(cgrads, ref)
    bound = max(1e-5, 3 * cpu_f32)
    blocks = params["network"]["blocks"]
    print(f"[reference] connect4net ({blocks} blocks, {gpu.a2c_network.stem.out_channels} channels) on 256 boards, "
          f"cuda vs cpu: max |d logits, values| {dout:.2e}; the card's gradients within {dgrad:.2e} of each tensor's "
          f"largest entry of the CPU's float64 gradients (the CPU's float32 gradients within {cpu_f32:.2e}, bound "
          f"{bound:.2e}); TF32 {(torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)}")
    if not (dout < 1e-5 and dgrad < bound):
        raise AssertionError(f"connect4net: the card disagrees with the CPU: outputs {dout}, gradients {dgrad}")


# ---------------------------------------------------------------------------
# [population]: multi-seed training and PBT
# ---------------------------------------------------------------------------

POPULATION_SEEDS = (7, 11, 17, 23)  # docs/PBT_SELFPLAY.md's seeds for benchruns/pbt_ant2d_ab.yaml


@contextlib.contextmanager
def launch_shapes():
    """Records the shape of each GAE launch ([T, N, V]), the batch of each
    ordinary fused-MLP launch and the (G, B) of each grouped one while the
    block runs; the counters move as always."""
    from rl_games_tpu_torch.ops import fused_mlp, gae

    shapes = {"gae": [], "fused_mlp": [], "fused_mlp_grouped": []}
    gae_launch, fused_launch, grouped_launch = gae.gae_cuda, fused_mlp.fused_mlp_cuda, fused_mlp.fused_mlp_grouped_cuda

    def gae_counted(rewards, *args):
        shapes["gae"].append(tuple(rewards.shape))
        return gae_launch(rewards, *args)

    def fused_counted(x, *args):
        shapes["fused_mlp"].append(x.shape[0])
        return fused_launch(x, *args)

    def grouped_counted(x, ws, bs, activation):
        shapes["fused_mlp_grouped"].append((fused_mlp.grouped_dims(x, ws, bs)[0], x.shape[-2]))
        return grouped_launch(x, ws, bs, activation)

    gae.gae_cuda, fused_mlp.fused_mlp_cuda, fused_mlp.fused_mlp_grouped_cuda = gae_counted, fused_counted, grouped_counted
    try:
        yield shapes
    finally:
        gae.gae_cuda, fused_mlp.fused_mlp_cuda, fused_mlp.fused_mlp_grouped_cuda = gae_launch, fused_launch, grouped_launch


def histogram(values) -> dict:
    return {v: values.count(v) for v in sorted(set(values))}


def launches_now() -> dict:
    from rl_games_tpu_torch.ops import fused_mlp, gae

    return {"gae": gae.gae_launches, "fused_mlp": fused_mlp.fused_mlp_launches}


def zero_launches():
    from rl_games_tpu_torch.ops import fused_mlp, gae

    gae.gae_launches = fused_mlp.fused_mlp_launches = fused_mlp.fused_mlp_grouped_launches = 0
    fused_mlp.fused_mlp_cluster_launches = fused_mlp.fused_mlp_sets_launches = fused_mlp.fused_mlp_wgmma_launches = 0


def fused_flagship_params(num_actors: int = 8192) -> dict:
    params = flagship_params(num_actors)
    params["network"]["mlp"]["fused"] = True
    return params


def population_run(epochs: int, play_steps: int = 100):
    """(a) benchruns/pbt_ant2d_ab.yaml as shipped (Ant2D, 2048 envs x 16, MLP
    [256, 128, 64] elu, 4 mini-epochs of minibatch 16384, its pbt block)
    through Runner.run with --seeds 7,11,17,23 for ``epochs`` epochs; only
    interval_steps shrunk to 2 epochs of one member's frames, so that a
    pbt_step runs every second epoch. Then one member's checkpoint played
    through Runner.run. 4 GAE launches at [16, 2048, 1] an epoch, no fused."""
    import yaml

    from rl_games_tpu_torch.algos.ppo import PPOAgent
    from rl_games_tpu_torch.runner import Runner
    from rl_games_tpu_torch.utils.multiseed import PopulationTrainer

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchruns", "pbt_ant2d_ab.yaml")) as f:
        params = yaml.safe_load(f)["params"]
    cfg = params["config"]
    k, n, horizon = len(POPULATION_SEEDS), cfg["num_actors"], cfg["horizon_length"]
    member_frames = n * horizon
    cfg["pbt"]["interval_steps"] = 2 * member_frames  # 65,536
    cfg["player"] = {**cfg["player"], "max_steps": play_steps}
    spans, pbt_steps = [], []
    train_epoch, pbt_step = PPOAgent.train_epoch, PopulationTrainer.pbt_step

    def timed(self, state):  # each member epoch's start and end, the device drained at both
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_epoch(self, state)
        torch.cuda.synchronize()
        spans.append((t0, time.perf_counter()))
        return out

    def counted(self, states, metrics):
        pbt_steps.append(int(metrics["epoch"][0]))
        return pbt_step(self, states, metrics)

    out = io.StringIO()
    with tempfile.TemporaryDirectory() as train_dir:
        cfg["train_dir"] = train_dir
        runner = Runner()  # the default device: the card
        runner.load({"params": params})
        PPOAgent.train_epoch, PopulationTrainer.pbt_step = timed, counted
        torch.cuda.reset_peak_memory_stats()
        try:
            with launch_shapes() as shapes, contextlib.redirect_stdout(out):
                zero_launches()  # the training run starts here
                t0 = time.perf_counter()
                paths = runner.run({"train": True, "seeds": ",".join(map(str, POPULATION_SEEDS)),
                                    "max_epochs": epochs})
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                train_launches = launches_now()  # read right after
        finally:
            PPOAgent.train_epoch, PopulationTrainer.pbt_step = train_epoch, pbt_step
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        names = sorted(os.path.basename(p) for p in paths)
        finite = all(bool(torch.isfinite(p).all()) for a in runner.trainer.agents for p in a.model.parameters())

        zero_launches()  # the player's run starts here
        play_out = io.StringIO()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(play_out):
            mean_reward = runner.run({"play": True, "checkpoint": paths[0]})
        torch.cuda.synchronize()
        play_s = time.perf_counter() - t1
        play_launches = launches_now()  # read right after
    log = out.getvalue()
    for line in log.strip().splitlines():
        print(f"[population] (a) | {line}")
    events = [line for line in log.splitlines() if line.startswith("pbt: seed")]
    expected = {"gae": k * epochs, "fused_mlp": 0}
    if (train_launches != expected or histogram(shapes["gae"]) != {(horizon, n, 1): k * epochs}
            or shapes["fused_mlp"] or len(spans) != k * epochs):
        raise AssertionError(f"population (a): launches {train_launches}, GAE shapes {histogram(shapes['gae'])}, "
                             f"{len(spans)} member epochs; expected {expected} at [{horizon}, {n}, 1]")
    if pbt_steps != list(range(2, epochs + 1, 2)) or len(paths) != k or not finite:
        raise AssertionError(f"population (a): pbt_step after epochs {pbt_steps}, checkpoints {names}")
    if play_launches != {"gae": 0, "fused_mlp": 0} or not math.isfinite(mean_reward):
        raise AssertionError(f"population (a) player: launches {play_launches}, mean reward {mean_reward}")
    ends = [end for _, end in spans]
    epoch_s = np.diff([spans[0][0]] + ends[k - 1::k])  # each epoch of the population, pbt_step and logs included
    member_s = np.array([end - start for start, end in spans[k:]] or [end - start for start, end in spans])
    steady = epoch_s[1:] if len(epoch_s) > 1 else epoch_s
    pop_s = float(np.median(steady))
    print(f"[population] (a) trained benchruns/pbt_ant2d_ab.yaml ({k} members x {n} envs x {horizon}, "
          f"interval_steps {cfg['pbt']['interval_steps']}) {epochs} epochs through Runner.run in {wall:.2f} s: "
          f"launches {train_launches}, GAE shapes {histogram(shapes['gae'])}; pbt_step after epochs {pbt_steps}, "
          f"{len(events)} adoption events; checkpoints {names}")
    print(f"[population] (a) first population epoch {epoch_s[0] * 1e3:.1f} ms; steady population epoch "
          f"{pop_s * 1e3:.1f} ms (median of {len(steady)}), {k * member_frames / pop_s:,.0f} env-steps/s "
          f"({k} x {member_frames} an epoch); a member's epoch {np.median(member_s) * 1e3:.1f} ms (median of "
          f"{len(member_s)}, {member_frames / np.median(member_s):,.0f} env-steps/s); peak device memory "
          f"{peak_gib:.2f} GiB")
    print(f"[population] (a) played {os.path.basename(paths[0])} through Runner.run "
          f"({play_steps} steps x {n} envs): launches {play_launches}, {play_out.getvalue().strip()!r}, "
          f"{play_s:.2f} s with set-up")
    return {"train": train_launches, "play": play_launches, "member_epochs": k * epochs, "epoch_s": pop_s,
            "member_s": float(np.median(member_s)), "events": len(events)}


def member_snapshot(agent, state, losses):
    """A member's or solo agent's weights and normalizers, Adam moments and
    per-epoch losses, on the CPU."""
    out = {f"model/{k}": v.detach().cpu().clone() for k, v in agent.model.state_dict().items()}
    opt = state.opt_state
    out.update({f"adam/mu/{i}": t.cpu().clone() for i, t in enumerate(opt.mu)})
    out.update({f"adam/nu/{i}": t.cpu().clone() for i, t in enumerate(opt.nu)})
    out["adam/count"] = opt.count.cpu().clone()
    out.update({f"{k}/{e}": v for e, m in enumerate(losses) for k, v in m.items()})
    return out


def snapshot_diff(a, b) -> float:
    if sorted(a) != sorted(b):
        raise AssertionError(f"snapshots differ in their entries: {sorted(set(a) ^ set(b))}")
    return max(float((a[k].to(torch.float64) - b[k].to(torch.float64)).abs().max()) for k in a)


def population_solo_equality(epochs: int = 2, seeds=(7, 11)):
    """(b) a 2-member MultiSeedTrainer of the fused flagship (8192 envs) for
    ``epochs`` epochs: each member's weights, Adam moments and a_loss /
    c_loss against a solo agent's run from the same seed, bit for bit
    unless two solo runs of one seed already differ on the card (then
    within that difference). Per member epoch 1 GAE at [16, 8192, 1] and
    33 fused launches (17 at B = 8192, 16 at B = 32768)."""
    from rl_games_tpu_torch.algos.ppo import PPOAgent
    from rl_games_tpu_torch.utils.multiseed import MultiSeedTrainer

    def losses(m, i=None):
        return {k: (m[k] if i is None else m[k][i]).detach().cpu().clone() for k in ("a_loss", "c_loss")}

    params = fused_flagship_params()
    n, mb = params["config"]["num_actors"], params["config"]["minibatch_size"]
    ms = MultiSeedTrainer(PPOAgent("chip_smoke", params), seeds)
    states = ms.init_state()
    per_epoch = []
    with launch_shapes() as shapes:
        zero_launches()  # the members' run starts here
        for _ in range(epochs):
            states, m = ms.epoch(states)
            per_epoch.append(m)
        torch.cuda.synchronize()
        launches = launches_now()  # read right after
    k = len(seeds)
    expected = {"gae": k * epochs, "fused_mlp": 33 * k * epochs}
    batches = {n: 17 * k * epochs, mb: 16 * k * epochs}
    if (launches != expected or histogram(shapes["gae"]) != {(16, n, 1): k * epochs}
            or histogram(shapes["fused_mlp"]) != batches):
        raise AssertionError(f"population (b): launches {launches}, GAE {histogram(shapes['gae'])}, fused batches "
                             f"{histogram(shapes['fused_mlp'])}; expected {expected}, fused batches {batches}")
    members = [member_snapshot(ms.agents[i], states[i], [losses(m, i) for m in per_epoch]) for i in range(k)]
    del ms, states

    def solo(seed):
        agent = PPOAgent("chip_smoke", fused_flagship_params())
        state, ls = agent.init_state(seed=seed), []
        for _ in range(epochs):
            state, m = agent.train_epoch(state)
            ls.append(losses(m))
        return member_snapshot(agent, state, ls)

    solos = [solo(s) for s in seeds]
    noise = snapshot_diff(solos[0], solo(seeds[0]))  # two solo runs of one seed
    diffs = [snapshot_diff(member, s) for member, s in zip(members, solos)]
    print(f"[population] (b) {k} members of the fused flagship ({n} envs), {epochs} epochs: launches {launches}, "
          f"GAE {histogram(shapes['gae'])}, fused batches {histogram(shapes['fused_mlp'])}; member against its "
          f"solo run (weights, normalizers, Adam moments, a_loss / c_loss): max |diff| "
          f"{', '.join(f'seed {s}: {d:.3e}' for s, d in zip(seeds, diffs))}; two solo runs of seed {seeds[0]}: "
          f"{noise:.3e}" + (" (bit for bit)" if max(diffs) == 0.0 and noise == 0.0 else ""))
    if max(diffs) > noise:
        raise AssertionError(f"population (b): members differ from their solo runs by {diffs}, two solo runs "
                             f"of one seed by {noise}")
    return {"train": launches, "member_epochs": k * epochs, "max_diff": max(diffs), "solo_noise": noise}


def population_pbt_step(seeds=(7, 11, 17)):
    """(c) a 3-member PopulationTrainer of (b)'s config, as
    tests/test_multiseed.py:132-164 builds one (threshold_std 0.1,
    threshold_abs 0.05, mutation_rate 1.0, change_range (1.2, 1.2)): one
    epoch, then pbt_step with that test's fake metrics (scores 200 / 100 /
    10, 5 games each) under random.seed(0), then one more epoch."""
    import random

    from rl_games_tpu_torch.algos.ppo import PPOAgent
    from rl_games_tpu_torch.utils.multiseed import PopulationTrainer

    tr = PopulationTrainer(PPOAgent("chip_smoke", fused_flagship_params()), seeds, threshold_std=0.1,
                           threshold_abs=0.05, mutation_rate=1.0, change_range=(1.2, 1.2))
    states, _ = tr.epoch(tr.init_state())
    before = [{k: v.clone() for k, v in a.model.state_dict().items()} for a in tr.agents]
    lrs = [float(s.lr) for s in states]
    counts = [int(s.game_rewards.count) for s in states]
    fake = {"mean_rewards": np.asarray([[200.0], [100.0], [10.0]]), "games_played": np.asarray([5, 5, 5])}
    random.seed(0)
    t0 = time.perf_counter()
    states, events = tr.pbt_step(states, fake)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    adopter, leader, state = tr.agents[2], tr.agents[0], states[2]
    opt, adopter_lr = state.opt_state, float(state.lr)
    checks = {
        "one event, seed 17 adopts seed 7": [(e["dst"], e["src"]) for e in events] == [(seeds[2], seeds[0])],
        "the adopter's state_dict is the leader's": all(torch.equal(v, leader.model.state_dict()[k])
                                                        for k, v in adopter.model.state_dict().items()),
        "its Adam moments are zero": int(opt.count) == 0 and all(float(t.abs().max()) == 0.0 for t in opt.mu + opt.nu),
        "its lr is the leader's x or / 1.2": adopter_lr in (float(np.float32(lrs[0] * 1.2)),
                                                            float(np.float32(lrs[0] / 1.2))),
        "its meters are cleared": int(state.game_rewards.count) == 0,
        "the others are untouched": all(
            float(states[i].lr) == lrs[i] and int(states[i].game_rewards.count) == counts[i]
            and all(torch.equal(v, before[i][k]) for k, v in tr.agents[i].model.state_dict().items())
            for i in (0, 1)),
    }
    states, m = tr.epoch(states)
    checks["one more epoch of every member is finite"] = bool(
        torch.isfinite(m["a_loss"]).all() and torch.isfinite(m["c_loss"]).all())
    failed = [what for what, ok in checks.items() if not ok]
    print(f"[population] (c) pbt_step over 3 fused flagship members in {step_s * 1e3:.1f} ms: events {events}; "
          f"leader lr {lrs[0]:.4e} -> adopter lr {adopter_lr:.4e}; "
          + ("every check held: " + "; ".join(checks) if not failed else f"FAILED: {failed}"))
    if failed:
        raise AssertionError(f"population (c): {failed}")
    return events


def population_manager(leader_seed: int = 11):
    """(d) the filesystem protocol on the card: one fused flagship member
    trained 2 epochs through Runner.run with pbt.enabled (policy 1 of 2,
    threshold_std and threshold_abs 0, interval one epoch's frames,
    mutation_rate 1, gamma mutated by mutate_discount); its workspace holds
    a leader's record beforehand (another seed's weights, score 1e9). At the
    first interval it adopts: the leader's weights, fresh Adam moments,
    get_param('gamma') the mutated value; the next epoch is finite."""
    from rl_games_tpu_torch.algos.ppo import PPOAgent
    from rl_games_tpu_torch.runner import Runner
    from rl_games_tpu_torch.utils import pbt

    params = fused_flagship_params()
    n = params["config"]["num_actors"]
    member_frames = n * 16
    params["config"]["pbt"] = {"enabled": True, "policy_idx": 1, "num_policies": 2, "interval_steps": member_frames,
                               "threshold_std": 0.0, "threshold_abs": 0.0, "mutation_rate": 1.0,
                               "mutation": {"gamma": "mutate_discount"}}
    seen, step = [], pbt.PbtManager.step

    def checked(self, algo, state, metrics):
        state = step(self, algo, state, metrics)
        opt = state.opt_state
        seen.append({"epoch": int(metrics["epoch"]), "a_loss": float(metrics["a_loss"]),
                     "c_loss": float(metrics["c_loss"]),
                     "weights": all(torch.equal(v.cpu(), leader_weights[k]) for k, v in algo.get_weights().items()),
                     "adam_zero": int(opt.count) == 0 and all(float(t.abs().max()) == 0.0 for t in opt.mu + opt.nu),
                     "gamma": algo.get_param("gamma"), "mutable": dict(self.mutable_params)})
        return state

    with tempfile.TemporaryDirectory() as train_dir:
        params["config"].update(name="chip_smoke_pbt", train_dir=train_dir, max_epochs=2)
        leader = PPOAgent("chip_smoke", copy.deepcopy(params))
        leader.init_state(seed=leader_seed)
        leader_weights = {k: v.cpu() for k, v in leader.get_weights().items()}
        pbt.save_member(os.path.join(train_dir, "pbt_workspace"), 0, 1e9, member_frames, leader_weights,
                        {"gamma": 0.99})
        del leader
        runner = Runner()  # the default device: the card
        runner.load({"params": params})
        pbt.PbtManager.step = checked
        try:
            with launch_shapes() as shapes, contextlib.redirect_stdout(io.StringIO()) as out:
                zero_launches()  # the training run starts here
                _, epoch_num = runner.run({"train": True})
                torch.cuda.synchronize()
                launches = launches_now()  # read right after
        finally:
            pbt.PbtManager.step = step
        records = sorted(os.listdir(os.path.join(train_dir, "pbt_workspace")))
    adopted = [line for line in out.getvalue().splitlines() if line.startswith("PBT: ")]
    first = seen[0] if seen else {}
    checks = {
        "2 epochs, a step after each": epoch_num == 2 and [s["epoch"] for s in seen] == [1, 2],
        "it adopts at the first interval": bool(first.get("weights")) and len(adopted) >= 1,
        "fresh Adam moments": bool(first.get("adam_zero")),
        "gamma mutated through set_param": first.get("gamma") == first.get("mutable", {}).get("gamma", 0.99) != 0.99,
        "the next epoch is finite": len(seen) == 2 and math.isfinite(seen[1]["a_loss"])
                                    and math.isfinite(seen[1]["c_loss"]),
        "both records in the workspace": records == ["policy_000.pbt", "policy_001.pbt"],
        "launches exact": launches == {"gae": 2, "fused_mlp": 66}
                          and histogram(shapes["gae"]) == {(16, n, 1): 2},
    }
    failed = [what for what, ok in checks.items() if not ok]
    print(f"[population] (d) PbtManager through Runner.run (pbt.enabled, policy 1 of 2): {adopted[:1]}; gamma "
          f"0.99 -> {first.get('gamma')}; launches {launches}; "
          + ("every check held: " + "; ".join(checks) if not failed else f"FAILED: {failed}"))
    if failed:
        raise AssertionError(f"population (d): {failed}; steps seen {seen}")
    return {"train": launches, "member_epochs": 2}


def population_sac(update_epochs: int = 2, seeds=(2, 4)):
    """(e) sac_ant2d.yaml as shipped with --seeds 2,4 through Runner.run: its
    warmup epochs and ``update_epochs`` epochs of updates, one agent and
    one replay ring of 1e6 rows per member; per-member checkpoints, peak
    device memory. No kernel."""
    from rl_games_tpu_torch.algos import sac as sac_module
    from rl_games_tpu_torch.runner import Runner

    params = load_config("sac_ant2d.yaml")["params"]
    cfg = params["config"]
    warmup, steps, n = cfg["num_warmup_steps"], cfg["num_steps_per_episode"], cfg["num_actors"]
    epochs = warmup + update_epochs
    with tempfile.TemporaryDirectory() as train_dir:
        cfg.update(name="chip_smoke_sac_seeds", train_dir=train_dir)
        runner = Runner()  # the default device: the card
        runner.load({"params": params})
        torch.cuda.reset_peak_memory_stats()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            zero_launches()  # the training run starts here
            t0 = time.perf_counter()
            paths = runner.run({"train": True, "seeds": ",".join(map(str, seeds)), "max_epochs": epochs})
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = launches_now()  # read right after
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        sizes = {os.path.basename(p): os.path.getsize(p) for p in paths}
    agents, states = runner.trainer.agents, runner.last_states
    rows = [sac_module.replay_size(s.replay) for s in states]
    ring_gib = sum(t.numel() * t.element_size() for t in (
        states[0].replay.obses, states[0].replay.next_obses, states[0].replay.actions, states[0].replay.rewards,
        states[0].replay.dones, states[0].replay.truncated)) / 2**30
    updates = update_epochs * steps * agents[0].num_updates_per_step
    if (launches != {"gae": 0, "fused_mlp": 0} or rows != [epochs * steps * n] * len(seeds)
            or [s.update_counter for s in states] != [updates] * len(seeds)
            or states[0].replay is states[1].replay or len(sizes) != len(seeds)
            or any(s.replay.capacity != cfg["replay_buffer_size"] for s in states)):
        raise AssertionError(f"population (e): launches {launches}, replay rows {rows}, updates "
                             f"{[s.update_counter for s in states]}, checkpoints {sizes}")
    curve = [line for line in out.getvalue().splitlines() if line.startswith("fps total")]
    print(f"[population] (e) sac_ant2d.yaml --seeds {','.join(map(str, seeds))} through Runner.run: {epochs} epochs "
          f"({warmup} warmup, {update_epochs} of {steps * agents[0].num_updates_per_step} updates) in {wall:.2f} s; "
          f"launches {launches}; replay rows {rows} of {cfg['replay_buffer_size']} each, a ring "
          f"{ring_gib:.3f} GiB; peak device memory {peak_gib:.2f} GiB; checkpoints {sizes}; {curve[-1:]}")
    return {"peak_gib": peak_gib, "ring_gib": ring_gib}


def population_host_set_param(update_epochs: int = 2):
    """(f) [host_sac]'s path (sac_ant.yaml on Hopper2D-v0, CPUENV):
    set_param('gamma', 0.95) between two update epochs keeps the pending
    transition, so the replay rows equal the env steps less that one."""
    from rl_games_tpu_torch.algos import sac as sac_module
    from rl_games_tpu_torch.algos.sac import SACAgent

    params = load_config("sac_ant.yaml")["params"]
    params["config"].update(env_name="Hopper2D-v0", vecenv_type="CPUENV")
    agent = SACAgent("chip_smoke", params)  # the default device: the card
    state = agent.init_state()
    train = agent.make_train_fn()
    warmup, n = agent.num_warmup_steps, agent.num_actors
    for _ in range(warmup + 1):
        state, _ = train(state)
    pending = agent._pending
    state = agent.set_param("gamma", 0.95, state)
    kept = pending is not None and agent._pending is pending
    for _ in range(update_epochs - 1):
        state, m = train(state)
    epochs = warmup + update_epochs
    rows = sac_module.replay_size(state.replay)
    checks = {"the pending transition kept": kept,
              "rows = (env steps - 1 pending) x envs": rows == (epochs - 1) * n == state.frame,
              "gamma": agent.get_param("gamma") == 0.95,
              "updates": state.update_counter == update_epochs * agent.num_updates_per_step,
              "finite": math.isfinite(float(m["critic_loss"]))}
    failed = [what for what, ok in checks.items() if not ok]
    print(f"[population] (f) sac_ant.yaml on Hopper2D-v0 (CPUENV, {n} envs): set_param('gamma', 0.95) after "
          f"epoch {warmup + 1} of {epochs}; replay rows {rows} = ({epochs} env steps - 1 pending) x {n}; "
          f"{state.update_counter} updates; " + ("every check held" if not failed else f"FAILED: {failed}"))
    if failed:
        raise AssertionError(f"population (f): {failed}")


def phase_population(epochs: int = 8):
    """[population]: multi-seed training and PBT, (a)-(f)."""
    t0 = time.perf_counter()
    runs = {"a": population_run(epochs), "b": population_solo_equality(), "d": population_manager()}
    population_pbt_step()
    runs["e"] = population_sac()
    population_host_set_param()
    print(f"[population] phase in {time.perf_counter() - t0:.1f} s")
    return runs


# ---------------------------------------------------------------------------
# [selfplay]: self-play and multi-agent PPO (A12, second part)
# ---------------------------------------------------------------------------

def selfplay_params() -> dict:
    """benchruns/selfplay_forage.yaml as shipped: competitive_forage, 1024 envs
    x 32, MLP [128, 64] elu, 2 mini-epochs of 4 minibatches of 8192, the
    self-play manager at update_score 0.25 over 512 games, 512 envs a push."""
    import yaml

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchruns", "selfplay_forage.yaml")) as f:
        return yaml.safe_load(f)["params"]


def multiagent_params(num_actors: int = 1024, minibatch_size: int = 12288) -> dict:
    """tests/test_multiagent.py's config (cooperative_gather, MLP [32, 32] elu,
    its central value net's [32]) at 1024 envs x 3 agents x horizon 16, 4
    minibatches of 12,288 rows for both nets."""
    cfg = {
        "name": "chip_smoke_multiagent", "env_name": "cooperative_gather", "num_actors": num_actors,
        "horizon_length": 16, "minibatch_size": minibatch_size, "mini_epochs": 2, "learning_rate": 5e-4,
        "lr_schedule": "adaptive", "kl_threshold": 0.008, "e_clip": 0.2, "clip_value": True, "gamma": 0.99,
        "tau": 0.95, "critic_coef": 1.0, "entropy_coef": 0.0, "grad_norm": 1.0, "truncate_grads": True,
        "normalize_advantage": True, "normalize_input": False, "normalize_value": False, "value_bootstrap": True,
        "seed": 5, "bounds_loss_coef": 0.0001,
        "central_value_config": {
            "learning_rate": 5e-4, "mini_epochs": 2, "minibatch_size": minibatch_size, "clip_value": True,
            "normalize_input": False,
            "network": {"name": "actor_critic", "central_value": True,
                        "mlp": {"units": [32], "activation": "elu", "initializer": {"name": "default"}}},
        },
    }
    return {
        "algo": {"name": "a2c_continuous"}, "model": {"name": "continuous_a2c_logstd"},
        "network": {
            "name": "actor_critic", "separate": False,
            "mlp": {"units": [32, 32], "activation": "elu", "initializer": {"name": "default"}},
            "space": {"continuous": {"mu_activation": "None", "sigma_activation": "None",
                                     "mu_init": {"name": "default"},
                                     "sigma_init": {"name": "const_initializer", "val": 0.0}, "fixed_sigma": True}},
        },
        "config": cfg,
    }


def selfplay_run(epochs: int, fused: bool = False):
    """(a) benchruns/selfplay_forage.yaml as shipped through Runner.run for
    ``epochs`` epochs, then its last checkpoint plays a mirror match through
    Runner.run (the restored weights in every opponent seat, checked). The
    steady epoch, env-steps/s, peak memory; a rollout step's wall time and
    device kernels with the opponent's forward apart; the player's step; 1
    GAE launch an epoch at [32, 1024, 1], none fused, none in the player.
    (f) with ``fused``: the same with network.mlp.fused: true, the
    opponents' forward one grouped launch over the 1024 slots a step. An
    epoch launches the chain 32 + 1 times at B = 1024 (rollout, bootstrap)
    and 8 times at B = 8192 (2 x 4 minibatches), and 32 times grouped at
    G = 1024, B = 1; a player step once each way."""
    from rl_games_tpu_torch.envs.device.selfplay import SelfPlayVecEnv
    from rl_games_tpu_torch.ops import fused_mlp
    from rl_games_tpu_torch.runner import Runner
    from rl_games_tpu_torch.utils import checkpoint as ckpt

    tag = "(f)" if fused else "(a)"
    params = selfplay_params()
    params["network"]["mlp"]["fused"] = fused
    cfg = params["config"]
    n, horizon = cfg["num_actors"], cfg["horizon_length"]
    minibatches = cfg["mini_epochs"] * n * horizon // cfg["minibatch_size"]
    ends, agents, seats = [], [], []
    mark = epoch_marker(ends)

    def stop_fn(agent):
        agents[:] = [agent]
        return mark(agent)

    init_opponent = SelfPlayVecEnv.init_opponent

    def recorded(self, env_state, weights):
        seats.append({k: v.detach().cpu().clone() for k, v in weights.items()})
        return init_opponent(self, env_state, weights)

    out = io.StringIO()
    with tempfile.TemporaryDirectory() as train_dir:
        cfg.update(train_dir=train_dir, max_epochs=epochs)
        runner = Runner()  # the default device: the card
        runner.load({"params": params})
        torch.cuda.reset_peak_memory_stats()
        with launch_shapes() as shapes, contextlib.redirect_stdout(out):
            zero_launches()  # the training run starts here
            t0 = time.perf_counter()
            _, epoch_num = runner.run({"train": True, "stop_fn": stop_fn})
            torch.cuda.synchronize()
            train_launches = launches_now()  # read right after
            train_grouped = fused_mlp.fused_mlp_grouped_launches
            train_cluster = fused_mlp.fused_mlp_cluster_launches
            train_sets = fused_mlp.fused_mlp_sets_launches
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        nn_dir = os.path.join(train_dir, cfg["name"], "nn")
        final = [f for f in sorted(os.listdir(nn_dir)) if f"_ep_{epochs}_rew_" in f]
        if epoch_num != epochs or len(final) != 1:
            raise AssertionError(f"selfplay {tag}: {epoch_num} epochs, checkpoints {os.listdir(nn_dir)}")
        checkpoint = os.path.join(nn_dir, final[0])
        saved, _ = ckpt.load_checkpoint_weights(checkpoint)
        player = runner.create_player()
        play_steps = player.steps_needed(player.games_num)
        SelfPlayVecEnv.init_opponent = recorded
        try:
            play_out = io.StringIO()
            with launch_shapes() as play_shapes, contextlib.redirect_stdout(play_out):
                zero_launches()  # the player's run starts here
                t1 = time.perf_counter()
                mean_reward = runner.run({"play": True, "checkpoint": checkpoint})
                torch.cuda.synchronize()
                play_s = time.perf_counter() - t1
                play_launches = launches_now()  # read right after
                play_grouped = fused_mlp.fused_mlp_grouped_launches
                play_cluster = fused_mlp.fused_mlp_cluster_launches
                play_sets = fused_mlp.fused_mlp_sets_launches
        finally:
            SelfPlayVecEnv.init_opponent = init_opponent
        steady_s, first, last = steady_player_step(runner, checkpoint)
    for line in out.getvalue().strip().splitlines():
        print(f"[selfplay] {tag} | {line}")
    rollout = epochs * (horizon + 1)
    expected = {"gae": epochs, "fused_mlp": fused * (rollout + minibatches * epochs + horizon * epochs)}
    expected_shapes = {"gae": {SELFPLAY_SHAPE: epochs},
                       "fused_mlp": {n: rollout, cfg["minibatch_size"]: minibatches * epochs} if fused else {},
                       "fused_mlp_grouped": {(n, 1): horizon * epochs} if fused else {}}
    expected_play = {"gae": 0, "fused_mlp": 2 * fused * play_steps}
    expected_play_shapes = ({"gae": {}, "fused_mlp": {n: play_steps}, "fused_mlp_grouped": {(n, 1): play_steps}}
                            if fused else {"gae": {}, "fused_mlp": {}, "fused_mlp_grouped": {}})
    got_shapes = {k: histogram(v) for k, v in shapes.items()}
    got_play_shapes = {k: histogram(v) for k, v in play_shapes.items()}
    if (train_launches != expected or train_grouped != fused * horizon * epochs or got_shapes != expected_shapes
            or play_launches != expected_play or play_grouped != fused * play_steps
            or got_play_shapes != expected_play_shapes):
        raise AssertionError(f"selfplay {tag}: launches {train_launches} ({train_grouped} grouped; shapes {got_shapes}),"
                             f" player {play_launches} ({play_grouped} grouped; shapes {got_play_shapes}); expected "
                             f"{expected} ({fused * horizon * epochs} grouped; shapes {expected_shapes}), player "
                             f"{expected_play} ({fused * play_steps} grouped; shapes {expected_play_shapes})")
    # the opponents' grouped launch (G = 1024 slots, one row each) is the sets kernel's where the plan takes it
    opp_sets = fused * int(fused_mlp.grouped_launch_plan(FORAGE_DIMS, 1, n)[0].sets is not None)
    if (train_sets, play_sets) != (opp_sets * horizon * epochs, opp_sets * play_steps):
        raise AssertionError(f"selfplay {tag}: {train_sets} sets launches in training, {play_sets} in the player; "
                             f"expected {opp_sets * horizon * epochs} and {opp_sets * play_steps}")
    # the learner's ordinary launches only: a grouped launch (the opponents) never takes the cluster kernel
    cluster = check_cluster_launches(f"selfplay {tag}", FORAGE_DIMS, {
        "training": (train_cluster, got_shapes["fused_mlp"]), "player": (play_cluster, got_play_shapes["fused_mlp"])})
    mirror = len(seats) == 1 and sorted(seats[0]) == sorted(saved) and all(
        torch.equal(seats[0][k], v) for k, v in saved.items())
    if not (mirror and math.isfinite(mean_reward)):
        raise AssertionError(f"selfplay {tag} player: mirror match {mirror} ({len(seats)} seatings), "
                             f"mean reward {mean_reward}")
    times = np.diff([t0, *ends])
    epoch_s = report_epochs(f"selfplay {tag}", times, n * horizon, peak_gib)

    # the rollout step, from the trained agent's state: its wall time (one
    # rollout after a warm-up one, over its steps), its kernels (a profiled
    # rollout of 8 steps), and the opponent's vmapped forward apart
    agent = agents[0]
    state = agent.last_state
    agent._rollout(state)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    agent._rollout(state)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t2) / horizon
    agent.horizon_length = 8
    try:
        step_kernels = len(device_events(lambda: agent._rollout(state), 1)) / 8
    finally:
        agent.horizon_length = horizon
    opponents = lambda: agent.vec_env._opp_actions(state.env_state)  # noqa: E731
    opp_ms = cuda_time_ms(opponents, 50)
    opp_kernels = len(device_events(opponents, 1))
    opp_device_ms, _ = device_time_ms(opponents, 20)
    opp_held_device_ms = None
    if fused:
        # the same forward with the held grouped launch in the sets kernel's place (the route before it): the
        # plan's launches with their sets plan taken out, for this measurement only
        plan = fused_mlp.grouped_launch_plan
        fused_mlp.grouped_launch_plan = lambda *a, **k: [launch._replace(sets=None) for launch in plan(*a, **k)]
        try:
            opp_held_device_ms, _ = device_time_ms(opponents, 20)
        finally:
            fused_mlp.grouped_launch_plan = plan
    pushes = out.getvalue().count("updating opponent weights")
    print(f"[selfplay] {tag} trained benchruns/selfplay_forage.yaml{' with network.mlp.fused: true' if fused else ' as shipped'} "
          f"({n} envs x {horizon}, MLP [128, 64] elu, 2 x 4 minibatches of 8192) {epochs} epochs through Runner.run: "
          f"launches {train_launches} ({train_grouped} grouped), shapes {got_shapes}, {pushes} opponent pushes")
    print(f"[selfplay] {tag} rollout step {step_s * 1e3:.3f} ms wall, {step_kernels:.1f} device kernels a step; of it "
          f"the opponent's forward over the {n} slots {opp_ms * 1e3:.1f} us a call between CUDA events, "
          f"{opp_kernels} device kernels, {opp_device_ms * 1e3:.1f} us of device time"
          + (f" ({opp_held_device_ms * 1e3:.1f} us with the held grouped launch in the sets kernel's place; "
             f"{train_sets} sets launches in training, {play_sets} in the player)" if fused else ""))
    print(f"[selfplay] {tag} mirror match of {os.path.basename(checkpoint)} through Runner.run (its weights in all "
          f"{n} opponent seats): {play_steps} steps, launches {play_launches} ({play_grouped} grouped), "
          f"{play_out.getvalue().strip()!r}, {play_s:.2f} s with set-up; steady player step {steady_s * 1e3:.3f} ms "
          f"(steps {first}-{last})")
    return {"train": train_launches, "train_grouped": train_grouped, "play": play_launches, "play_grouped": play_grouped,
            "cluster": cluster, "train_sets": train_sets, "play_sets": play_sets,
            "opp_held_device_ms": opp_held_device_ms,
            "play_steps": play_steps, "epochs": epochs, "epoch_s": epoch_s, "agent": agent, "state": state,
            "step_s": step_s, "step_kernels": step_kernels, "opp_ms": opp_ms, "opp_kernels": opp_kernels,
            "opp_device_ms": opp_device_ms}


def vmap_gradients_check(device="cuda"):
    """(f) one torch.autograd.grad through torch.func.vmap of the registered
    operator on the card (the grouped launch forward, the recomputed plain
    chain backward) against a loop of the operator over the sets, at
    rtol 1e-5 / atol 1e-6: every input's gradient, x shared by the sets."""
    from rl_games_tpu_torch.ops import fused_mlp as fm

    gen = torch.Generator(device=device).manual_seed(17)
    x, ws, bs = grouped_inputs(FORAGE_DIMS, 16, 3, gen, torch.device(device))
    leaves = [t.requires_grad_(True) for t in (x[0], *ws, *bs)]
    got = torch.func.vmap(lambda w0, w1, b0, b1: fm.fused_mlp(leaves[0], [w0, w1], [b0, b1], "elu"))(*leaves[1:])
    want = torch.stack([fm.fused_mlp(leaves[0], [w[g] for w in leaves[1:3]], [b[g] for b in leaves[3:]], "elu")
                        for g in range(16)])
    weights = torch.linspace(-1, 1, want.numel(), device=device).reshape(want.shape)
    g_got = torch.autograd.grad((got * weights).sum(), leaves)
    g_want = torch.autograd.grad((want * weights).sum(), leaves)
    for a, b in zip(g_got, g_want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    err = max(float((a - b).abs().max()) for a, b in zip(g_got, g_want))
    print(f"[selfplay] (f) gradients through torch.func.vmap of the operator (16 sets, x shared) against a loop "
          f"over the sets: max abs diff {err:.3e} (rtol 1e-5, atol 1e-6)")
    return err


def selfplay_push(agent, state, tag="(b)"):
    """(b) a forced push on (a)'s agent ((f) on its own): SelfPlayManager
    at update_score -100 over 1 game, half the envs (512) a push. Slots 0-511 take the
    learner's weights and 512-1023 stay bit for bit; from the same state the
    opponents' actions on the card agree with the CPU's within 1e-5."""
    from rl_games_tpu_torch.algos.ppo import meters_mean
    from rl_games_tpu_torch.envs.device.selfplay import CompetitiveForage, SelfPlayVecEnv, SelfPlayVecEnvState
    from rl_games_tpu_torch.utils.self_play import SelfPlayManager

    n = agent.num_actors
    half = n // 2  # 512 of the shipped config's 1024
    before = {k: v.clone() for k, v in state.env_state.opp_weights.items()}
    metrics = {"games_played": int(state.game_rewards.count), "frame": int(state.frame),
               "mean_rewards": meters_mean(state.game_rewards).cpu().numpy()}
    manager = SelfPlayManager({"update_score": -100.0, "games_to_check": 1, "env_update_num": half})
    with contextlib.redirect_stdout(io.StringIO()):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pushed, state = manager.update(agent, state, metrics)
        torch.cuda.synchronize()
        push_s = time.perf_counter() - t0
    weights = agent.get_weights()
    pushed_rows = all(torch.equal(state.env_state.opp_weights[k][:half], v[None].expand(half, *v.shape))
                      for k, v in weights.items())
    kept_rows = all(torch.equal(state.env_state.opp_weights[k][half:], v[half:]) for k, v in before.items())
    cpu_env = SelfPlayVecEnv(CompetitiveForage(device="cpu"), n)
    cpu_env.bind_policy(copy.deepcopy(agent.model).cpu())
    est = state.env_state.estate
    cpu_state = SelfPlayVecEnvState(
        estate=dataclasses.replace(est, **{f.name: getattr(est, f.name).cpu() for f in dataclasses.fields(est)}),
        generator=torch.Generator(), steps=state.env_state.steps.cpu(),
        opp_weights={k: v.cpu() for k, v in state.env_state.opp_weights.items()})
    got, want = agent.vec_env._opp_actions(state.env_state).cpu(), cpu_env._opp_actions(cpu_state)
    err = float((got - want).abs().max())
    print(f"[selfplay] {tag} forced push on the trained agent ({metrics['games_played']} games, {half} envs a push) in "
          f"{push_s * 1e3:.2f} ms: slots 0-{half - 1} the learner's weights {pushed_rows}, slots {half}-{n - 1} "
          f"bit for bit "
          f"{kept_rows}, next envs {manager.env_indexes[:2].tolist()}...; the opponents' actions on the card "
          f"against the CPU's from the same state: max |d| {err:.2e}")
    if not (pushed and pushed_rows and kept_rows and err < 1e-5 and int(manager.env_indexes[0]) == 1):
        raise AssertionError(f"selfplay {tag}: pushed {pushed}, rows {pushed_rows} / {kept_rows}, error {err}")
    return {"push_s": push_s, "max_abs_err": err}


def multiagent_run(epochs: int = 3):
    """(c) the device multi-agent path: cooperative_gather at 1024 envs x 3
    agents x 16 (multiagent_params, its central value net among it) through
    train_epoch's two halves, ``epochs`` epochs, each env's step counter
    staggered over the 64-step limit (env i at i mod 64) so that episodes end
    in every epoch; 1 GAE an epoch at [16, 3072, 1], none fused; the
    meters count each env's ended episode once, not once a row."""
    from rl_games_tpu_torch.algos.ppo import PPOAgent

    params = multiagent_params()
    params["config"]["games_to_track"] = 1_000_000  # the meters keep every ended episode
    agent = PPOAgent("chip_smoke_multiagent", params)
    state = agent.init_state()
    n, a = agent.num_actors, agent.num_agents
    state.env_state.steps = (torch.arange(n, device=agent.device) % 64).to(torch.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()  # (c)'s own peak, its agent's state included
    times, env_ends, row_ends = [], 0, 0
    with launch_shapes() as shapes:
        zero_launches()  # the main path's run starts here
        for _ in range(epochs):
            t0 = time.perf_counter()
            traj, last_values = agent._rollout(state)
            ended = torch.cat([traj["dones"][1:], state.dones[None]])  # the dones each step produced
            env_ends += int(ended[:, ::a].sum())
            row_ends += int(ended.sum())
            state, m = agent._finish_epoch(state, traj, last_values)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = launches_now()  # read right after
    games = int(m["games_played"])
    losses = [float(m[k]) for k in ("a_loss", "cval_loss")]
    print(f"[selfplay] (c) cooperative_gather {n} envs x {a} agents x {agent.horizon_length} (batch "
          f"{agent.batch_size}, {agent.num_minibatches} minibatches of {agent.minibatch_size}, central value net) "
          f"{epochs} epochs: launches {launches}, GAE shapes {histogram(shapes['gae'])}; games_played {games}, "
          f"ended episodes {env_ends} (at {row_ends} rows); a_loss {losses[0]:.4f}, cval_loss {losses[1]:.4f}")
    epoch_s = report_epochs("selfplay (c)", np.array(times), agent.batch_size, torch.cuda.max_memory_allocated() / 2**30)
    if (launches != {"gae": epochs, "fused_mlp": 0} or histogram(shapes["gae"]) != {MULTIAGENT_SHAPE: epochs}
            or games != env_ends or env_ends == 0 or row_ends != a * env_ends
            or not all(math.isfinite(x) for x in losses)):
        raise AssertionError(f"selfplay (c): launches {launches}, GAE shapes {histogram(shapes['gae'])}, "
                             f"games_played {games} against {env_ends} ended episodes ({row_ends} rows), "
                             f"losses {losses}")
    return {"train": launches, "epoch_s": epoch_s, "games": games}


def phase_selfplay(epochs: int):
    """[selfplay]: (a) benchruns/selfplay_forage.yaml through Runner.run,
    trained and played as a mirror match; (b) a forced push on its agent;
    (c) the device multi-agent path; (f) (a) and (b) with network.mlp.fused:
    true over 3 epochs (the opponents' forward a grouped launch) and one
    gradient through the vmapped operator. ((d): GAE at both paths' shapes
    in phase_kernel_gae; (e): reference_multiagent in phase_reference.) The
    connect-four and multiwalker host envs need pettingzoo and Box2D, which
    the card's machine lacks: they run in the CPU tests alone."""
    t0 = time.perf_counter()
    runs = {"a": selfplay_run(epochs)}
    runs["b"] = selfplay_push(runs["a"]["agent"], runs["a"]["state"])
    runs["c"] = multiagent_run(3)
    del runs["a"]["agent"], runs["a"]["state"]
    # (f): the fused seat, its forced push and the operator's vmapped gradients
    runs["f"] = selfplay_run(3, fused=True)
    runs["f"]["push"] = selfplay_push(runs["f"]["agent"], runs["f"]["state"], "(f)")
    runs["f"]["vmap_grad_err"] = vmap_gradients_check()
    del runs["f"]["agent"], runs["f"]["state"]
    a, f = runs["a"], runs["f"]
    print(f"[selfplay] the opponents' forward over {SELFPLAY_SHAPE[1]} slots: plain seat (a) {a['opp_kernels']} kernels, "
          f"{a['opp_ms'] * 1e3:.1f} us between CUDA events, {a['opp_device_ms'] * 1e3:.1f} us of device time; fused seat "
          f"(f) {f['opp_kernels']} kernels, {f['opp_ms'] * 1e3:.1f} us, {f['opp_device_ms'] * 1e3:.1f} us (the held "
          f"grouped launch in the sets kernel's place {f['opp_held_device_ms'] * 1e3:.1f} us); rollout step "
          f"{a['step_s'] * 1e3:.3f} / {f['step_s'] * 1e3:.3f} ms; steady epoch {a['epoch_s'] * 1e3:.1f} / "
          f"{f['epoch_s'] * 1e3:.1f} ms")
    print(f"[selfplay] phase in {time.perf_counter() - t0:.1f} s")
    return runs


def reference_multiagent():
    """(e) one multi-agent update with the central value net (multiagent_params
    at 64 envs x 3 agents x 16, minibatches of 768) on the card against the
    CPU on the same trajectory: the central value net's first minibatch
    (loss within 2e-5 relative, gradients within 1e-5 of each tensor's
    largest entry) and the policy's first Adam step (check_first_update)."""
    from rl_games_tpu_torch.algos.ppo import PPOAgent
    from rl_games_tpu_torch.ops import losses as PL

    params = multiagent_params(num_actors=64, minibatch_size=768)
    gpu, cpu = PPOAgent("ref", params, device="cuda"), PPOAgent("ref", params, device="cpu")
    gstate, cstate = gpu.init_state(), cpu.init_state()
    cpu.model.load_state_dict({k: v.cpu() for k, v in gpu.model.state_dict().items()})
    cpu.cv_model.load_state_dict({k: v.cpu() for k, v in gpu.cv_model.state_dict().items()})
    traj, last_values = gpu._rollout(gstate)
    cstate.dones = gstate.dones.cpu()
    gds = gpu._prepare_dataset(gstate, traj, last_values)
    cds = cpu._prepare_dataset(cstate, to_cpu(traj), last_values.cpu())
    dadv = float((gds["advantages"].cpu() - cds["advantages"]).abs().max())
    losses, grads = [], []
    for agent, ds in ((gpu, gds), (cpu, cds)):
        mb = agent._minibatch(ds, 0, agent.cv_minibatch_size)
        res = agent.cv_model.forward_train(mb["states"])
        loss = PL.critic_loss(mb["old_values"], res["values"], agent.cv_e_clip, mb["returns"],
                              agent.cv_clip_value).mean()
        losses.append(float(loss.detach()))
        grads.append(torch.autograd.grad(loss, agent.cv_params))
    dgrad = max(float((g.cpu() - c).abs().max() / c.abs().max().clamp(min=1e-30)) for g, c in zip(*grads))
    dloss = abs(losses[0] - losses[1]) / abs(losses[1])
    update = check_first_update(gpu, cpu, gstate, cstate, gds, cds)
    print(f"[reference] selfplay (e) multi-agent cooperative_gather, 64 envs x 3 agents x 16 (3072 rows): max "
          f"|dadv| {dadv:.2e}; central value net's first minibatch: loss {losses[0]:.7f} / {losses[1]:.7f} "
          f"(relative {dloss:.2e}), gradients within {dgrad:.2e} of each tensor's largest entry; one minibatch of "
          f"768: {update}")
    if not (dadv < 1e-4 and dloss < 2e-5 and dgrad < 1e-5):
        raise AssertionError(f"selfplay (e): the card disagrees with the CPU: advantages {dadv}, central value "
                             f"loss {dloss}, gradients {dgrad}")


JAX_FIXTURE = os.path.join("tests", "data", "jax_ppo_cartpole_fused.ckpt")  # tools/write_jax_ckpt_fixture.py
EXPORT_BATCHES = (1, 7, 8192)


def train_to_checkpoint(tag: str, params: dict, epochs: int, train_dir: str, checkpoint=None):
    """``params`` trained ``epochs`` epochs through Runner.run into
    ``train_dir`` (from ``checkpoint`` where given). Returns the runner, the
    last checkpoint and the training's launches, counted from 0 just before
    it and read just after."""
    from rl_games_tpu_torch.runner import Runner

    params["config"].update(train_dir=train_dir, max_epochs=epochs)
    runner = Runner()  # the default device: the card
    runner.load({"params": params})
    zero_launches()  # the training run starts here
    with contextlib.redirect_stdout(io.StringIO()):
        _, epoch_num = runner.run({"train": True, "checkpoint": checkpoint})
    torch.cuda.synchronize()
    launches = launches_now()  # read right after
    name = params["config"]["name"]
    nn_dir = os.path.join(train_dir, name, "nn")
    final = [n for n in sorted(os.listdir(nn_dir)) if re.fullmatch(f"last_{name}_ep_{epochs}(_rew_.*)?\\.pth", n)]
    if epoch_num != epochs or len(final) != 1:
        raise AssertionError(f"[{tag}] trained to epoch {epoch_num} of {epochs}; checkpoints {os.listdir(nn_dir)}")
    return runner, os.path.join(nn_dir, final[0]), launches


def host_us_per_call(fn, calls: int = 200) -> float:
    """Host time per call of fn(), in µs: the enqueue alone, the card synchronised
    before and after, with fewer calls than the launch queue holds."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host


def export_check(tag: str, runner, checkpoint: str, fused_per_call: int, batches=EXPORT_BATCHES, bounds=False,
                 device_timing=False):
    """Runner.run's --export of ``checkpoint``, the .pt2 loaded in this
    process (utils/export.load_policy): at each batch its actions against the
    player's deterministic forward on the same observations (rtol = atol =
    2e-5; discrete actions equal), the fused launches of each call (counted
    from 0 just before it), with ``bounds`` the actions inside the env's
    bounds. Times a call at the largest batch beside the player's forward
    on the host's clock and, with ``device_timing``, its device time and
    kernels a call. Returns the artifact's path and the per-call results."""
    from rl_games_tpu_torch.ops import fused_mlp
    from rl_games_tpu_torch.utils.export import load_policy

    path = runner.run({"export": True, "checkpoint": checkpoint, "export_path": checkpoint + ".pt2"})
    with open(path, "rb") as f:
        blob = f.read()
    policy = load_policy(blob)
    player = runner.create_player()
    player.restore(checkpoint)
    player.deterministic = True
    mlp = runner.params["network"].get("mlp", {})
    export_dims = (player.obs_shape[0], *mlp.get("units", ()))
    gen = torch.Generator(device="cuda").manual_seed(15)
    rows = []
    for batch in batches:
        obs = torch.randn((batch, *player.obs_shape), generator=gen, device="cuda") * 2.0
        zero_launches()  # the exported call starts here
        got = policy(obs)
        torch.cuda.synchronize()
        launches = launches_now()  # read right after
        cluster = fused_mlp.fused_mlp_cluster_launches
        with torch.no_grad():
            want = player._play_actions(None, obs)
        if got.is_floating_point():
            ok = bool(torch.allclose(got, want, rtol=2e-5, atol=2e-5))
            err = float((got - want).abs().max())
        else:
            ok, err = bool(torch.equal(got, want)), float((got != want).sum())
        if bounds:
            space = player.env_info.action_space
            low = torch.as_tensor(np.asarray(space.low, np.float32), device="cuda")
            high = torch.as_tensor(np.asarray(space.high, np.float32), device="cuda")
            ok = ok and bool(((got >= low) & (got <= high)).all())
        if not ok or launches != {"gae": 0, "fused_mlp": fused_per_call} or tuple(got.shape[:1]) != (batch,):
            raise AssertionError(f"[export] {tag} at B = {batch}: shape {tuple(got.shape)}, max |d| {err}, launches "
                                 f"{launches} (expected {fused_per_call} fused), within bounds required: {bounds}")
        # the policy's one chain, as launch_plan plans it at this batch (the cluster kernel at a few rows)
        want_cluster = cluster_launches_expected(export_dims, {batch: 1}) if fused_per_call else 0
        if cluster != want_cluster:
            raise AssertionError(f"[export] {tag} at B = {batch}: {cluster} cluster kernel launches, expected "
                                 f"{want_cluster}")
        rows.append({"batch": batch, "max_abs_err": err, "launches": launches["fused_mlp"], "cluster_launches": cluster})
    obs = torch.randn((batches[-1], *player.obs_shape), generator=gen, device="cuda")
    with torch.no_grad():
        timings = {"export_host_us": host_us_per_call(lambda: policy(obs)),
                   "player_host_us": host_us_per_call(lambda: player._play_actions(None, obs))}
        if device_timing:
            timings["export_device"] = device_time_ms(lambda: policy(obs), 20)
            timings["player_device"] = device_time_ms(lambda: player._play_actions(None, obs), 20)
    device = {key: f", {timings[key][0] * 1e3:.2f} us of device time in {timings[key][1]} kernels"
              for key in ("export_device", "player_device") if key in timings}
    print(f"[export] {tag}: {os.path.basename(path)} ({len(blob):,} bytes); the artifact against the player's "
          f"deterministic forward: " + ", ".join(f"B = {r['batch']} max |d| {r['max_abs_err']:.2e} with "
                                                 f"{r['launches']} fused launch(es) ({r['cluster_launches']} of the "
                                                 f"cluster kernel)" for r in rows)
          + f"; at B = {batches[-1]} a call {timings['export_host_us']:.1f} us on the host"
          f"{device.get('export_device', '')}; the player's forward {timings['player_host_us']:.1f} us"
          f"{device.get('player_device', '')}")
    return path, rows, timings


def operator_host_cost(rounds: int = 3):
    """The host cost of one call through the registered operator
    (torch.ops.rl_games_tpu_torch.fused_mlp) against the direct call of the
    same implementation (what the eager no-grad path takes), at B = 16 and
    8192 over the flagship chain, in turns (direct, operator, operator,
    direct), without autograd. Returns {batch: (direct µs, operator µs)}."""
    from rl_games_tpu_torch.ops import fused_mlp

    gen = torch.Generator(device="cuda").manual_seed(16)
    out = {}
    for batch in (16, 8192):
        x, ws, bs = mlp_inputs(FLAGSHIP_DIMS, batch, gen, "cuda")
        with torch.no_grad():
            calls = {"direct": lambda: fused_mlp.fused_mlp_cuda(x, ws, bs, "elu"),
                     "operator": lambda: fused_mlp.fused_mlp_op(x, list(ws), list(bs), "elu")}
            if not torch.equal(calls["direct"](), calls["operator"]()):
                raise AssertionError(f"[export] the operator and the direct call differ at B = {batch}")
            times = {"direct": [], "operator": []}
            for _ in range(rounds):
                for name in ("direct", "operator", "operator", "direct"):
                    times[name].append(host_us_per_call(calls[name]))
        out[batch] = (float(np.median(times["direct"])), float(np.median(times["operator"])))
        print(f"[export] operator dispatch at B = {batch}: direct call {out[batch][0]:.2f} us, through "
              f"torch.ops.rl_games_tpu_torch.fused_mlp {out[batch][1]:.2f} us on the host (+{out[batch][1] - out[batch][0]:.2f}"
              f" us; medians of {2 * rounds} runs of 200 calls each, in turns)")
    return out


FRESH_PROCESS = """
import sys, json
for name in ("jax", "jaxlib", "flax", "optax", "msgpack", "rl_games_tpu"):
    sys.modules[name] = None  # any import of these now raises
import torch
from rl_games_tpu_torch.utils.export import load_policy
from rl_games_tpu_torch.ops import fused_mlp
inputs = torch.load(sys.argv[2])
policy = load_policy(open(sys.argv[1], "rb").read())
out = {}
for key, obs in inputs.items():
    before = fused_mlp.fused_mlp_launches
    actions = policy(obs.cuda())
    torch.cuda.synchronize()
    out[key] = {"launches": fused_mlp.fused_mlp_launches - before, "actions": actions.cpu()}
torch.save(out, sys.argv[3])
print(json.dumps(sorted(m for m in sys.modules if m.startswith("rl_games_tpu_torch"))))
"""


def export_fresh_process(path: str, work_dir: str):
    """(d) the artifact at ``path`` in a new Python process that imports only
    rl_games_tpu_torch.utils.export (jax, flax, optax, msgpack and the JAX
    package blocked): its actions at each batch equal this process's, one
    fused launch a call."""
    from rl_games_tpu_torch.utils.export import load_policy

    gen = torch.Generator(device="cuda").manual_seed(17)
    policy = load_policy(open(path, "rb").read())
    inputs = {str(b): torch.randn((b, FLAGSHIP_DIMS[0]), generator=gen, device="cuda") for b in EXPORT_BATCHES}
    here = {k: policy(obs).cpu() for k, obs in inputs.items()}
    src, dst = os.path.join(work_dir, "obs.pt"), os.path.join(work_dir, "actions.pt")
    torch.save({k: v.cpu() for k, v in inputs.items()}, src)
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", FRESH_PROCESS, path, src, dst], cwd=root, capture_output=True,
                          text=True, timeout=300, env={**os.environ, "PYTHONPATH": root})
    if proc.returncode != 0:
        raise AssertionError(f"[export] (d) the fresh process failed: {proc.stderr[-3000:]}")
    there = torch.load(dst)
    modules = json.loads(proc.stdout.strip().splitlines()[-1])
    for k in inputs:
        if there[k]["launches"] != 1 or not torch.equal(there[k]["actions"], here[k]):
            raise AssertionError(f"[export] (d) B = {k}: {there[k]['launches']} fused launches, actions equal: "
                                 f"{torch.equal(there[k]['actions'], here[k])}")
    print(f"[export] (d) a fresh process ({time.perf_counter() - t0:.1f} s) that imported {modules} of the port: "
          f"actions equal to this process's at B = {', '.join(inputs)}, 1 fused launch a call")
    return sum(there[k]["launches"] for k in inputs)


def phase_export():
    """[export]: (a) the fused flagship (8192 Ant2D envs) trained 1 epoch
    through Runner.run, exported through Runner.run({"export": True}) and its
    .pt2 loaded: at B = 1, 7 and 8192 its actions against the player's
    deterministic forward within 2e-5 and 1 fused launch a call; a call
    timed at 8192 beside the player's forward; (b) sac_ant2d.yaml after its
    warmup and 1 update epoch: the actions inside the bounds (no kernel);
    (c) ref/ppo_walker_rnn.yaml on the device Walker2D, fused, from zero
    states ([rnn] (d)'s config), 1 epoch; (d) (a)'s artifact in a fresh
    process. Also the operator's host cost against a direct call."""
    t0 = time.perf_counter()
    runs = {}
    with tempfile.TemporaryDirectory() as train_dir:
        params = fused_flagship_params()
        params["config"].update(name="chip_smoke_export", player={"deterministic": True})
        runner, checkpoint, train = train_to_checkpoint("export (a)", params, 1, train_dir)
        if train != {"gae": 1, "fused_mlp": 33}:
            raise AssertionError(f"[export] (a) training launches {train}, expected 1 GAE and 33 fused")
        path, rows, timings = export_check("(a) fused flagship", runner, checkpoint, 1, device_timing=True)
        runs["a"] = {"train": train, "rows": rows, "timings": timings}
        runs["d"] = {"launches": export_fresh_process(path, train_dir)}

        params = load_config("sac_ant2d.yaml")["params"]
        params["config"]["name"] = "chip_smoke_export_sac"
        epochs = params["config"]["num_warmup_steps"] + 1
        runner, checkpoint, train = train_to_checkpoint("export (b)", params, epochs, train_dir)
        if train != {"gae": 0, "fused_mlp": 0}:
            raise AssertionError(f"[export] (b) SAC's training launched {train}: its MLPs are plain, it has no GAE")
        _, rows, timings = export_check("(b) sac_ant2d.yaml", runner, checkpoint, 0, bounds=True)
        runs["b"] = {"train": train, "rows": rows, "timings": timings}

        params, changes = rnn_params("d")
        params["config"]["name"] = "chip_smoke_export_walker"
        runner, checkpoint, train = train_to_checkpoint("export (c)", params, 1, train_dir)
        # 256 rollout + 1 bootstrap forwards at B = 16 and 8 minibatch forwards a epoch, 4 x 257 once to time
        # the rollout (use_diagnostics), as [rnn] (d) counts them
        if train != {"gae": 1, "fused_mlp": 265 + 4 * 257}:
            raise AssertionError(f"[export] (c) training launches {train}, expected 1 GAE and {265 + 4 * 257} fused")
        _, rows, timings = export_check("(c) ppo_walker_rnn.yaml (" + changes + ")", runner, checkpoint, 1)
        runs["c"] = {"train": train, "rows": rows, "timings": timings}
    runs["operator"] = operator_host_cost()
    print(f"[export] phase in {time.perf_counter() - t0:.1f} s")
    return runs


def phase_jax_ckpt(play_steps: int = 200, resume_epochs: int = 2):
    """[jax_ckpt]: the committed fixture (the JAX package's ppo_cartpole.yaml,
    fused, 2 epochs; tools/write_jax_ckpt_fixture.py) restored by the
    player on the card and on the CPU: ``play_steps`` deterministic steps on
    the card's env, each step's actions from both (equal) and their logits
    (within 2e-5); --play through Runner.run; training resumed through
    Runner.run for ``resume_epochs`` epochs from the JAX epoch (GAE once an
    epoch, the fused kernel 65 times); --export of the fixture."""
    from rl_games_tpu_torch.runner import Runner

    t0 = time.perf_counter()
    params = load_config("ppo_cartpole.yaml")["params"]
    params["network"]["mlp"]["fused"] = True
    params["config"]["player"] = {**params["config"]["player"], "max_steps": play_steps}
    card, cpu = Runner(), Runner(device="cpu")
    for runner in (card, cpu):
        runner.load({"params": copy.deepcopy(params)})
    players = [runner.create_player() for runner in (card, cpu)]
    for player in players:
        player.restore(JAX_FIXTURE)
    gpu_player, cpu_player = players
    env_state, obs = gpu_player.vec_env.reset(torch.Generator(device="cuda").manual_seed(5))
    worst = 0.0
    zero_launches()  # the player's steps start here
    with torch.no_grad():
        for _ in range(play_steps):
            logits = gpu_player.model.forward_play(obs, deterministic=True)["logits"]
            actions = torch.argmax(logits, dim=-1)
            cpu_logits = cpu_player.model.forward_play(obs.cpu(), deterministic=True)["logits"]
            worst = max(worst, float((logits.cpu() - cpu_logits).abs().max()))
            if not torch.equal(actions.cpu(), torch.argmax(cpu_logits, dim=-1)) or worst > 2e-5:
                raise AssertionError(f"[jax_ckpt] the card's restore and the CPU's disagree: logits within {worst}")
            env_state, obs, _, _, _ = gpu_player.vec_env.step(env_state, actions)
    torch.cuda.synchronize()
    steps_launches = launches_now()  # read right after
    if steps_launches != {"gae": 0, "fused_mlp": play_steps}:
        raise AssertionError(f"[jax_ckpt] {play_steps} player steps launched {steps_launches}")
    zero_launches()  # --play starts here
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mean_reward = card.run({"play": True, "checkpoint": JAX_FIXTURE})
    torch.cuda.synchronize()
    play_launches = launches_now()  # read right after
    if play_launches["fused_mlp"] != gpu_player.steps_needed(gpu_player.games_num) or not math.isfinite(mean_reward):
        raise AssertionError(f"[jax_ckpt] --play launches {play_launches}, mean reward {mean_reward}")
    print(f"[jax_ckpt] {JAX_FIXTURE} restored on the card and on the CPU: {play_steps} deterministic steps, actions "
          f"equal, logits within {worst:.2e}; launches {steps_launches}; --play through Runner.run: "
          f"{out.getvalue().strip()!r}, launches {play_launches}")

    ends = []
    with tempfile.TemporaryDirectory() as train_dir:
        params = copy.deepcopy(params)
        params["config"].update(train_dir=train_dir, max_epochs=2 + resume_epochs)
        runner = Runner()
        runner.load({"params": params})
        zero_launches()  # the resumed training starts here
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            _, epoch_num = runner.run({"train": True, "checkpoint": JAX_FIXTURE, "stop_fn": epoch_marker(ends)})
        torch.cuda.synchronize()
        train = launches_now()  # read right after
        times = np.diff([t1, *ends])
        per_epoch = 32 + 1 + 4 * (16 * 32 // 64)  # ppo_cartpole.yaml: horizon 32, 4 mini-epochs of 8 minibatches
        if epoch_num != 2 + resume_epochs or train != {"gae": resume_epochs, "fused_mlp": per_epoch * resume_epochs}:
            raise AssertionError(f"[jax_ckpt] resumed to epoch {epoch_num}, launches {train}; expected epoch "
                                 f"{2 + resume_epochs}, {resume_epochs} GAE and {per_epoch * resume_epochs} fused")
        nn_dir = os.path.join(train_dir, params["config"]["name"], "nn")
        print(f"[jax_ckpt] training resumed from the JAX epoch 2 through Runner.run: epochs 3-{epoch_num}, "
              f"launches {train}; epochs {', '.join(f'{t * 1e3:.1f}' for t in times)} ms; {sorted(os.listdir(nn_dir))}")
        checkpoint = os.path.join(train_dir, "fixture.ckpt")
        shutil.copyfile(JAX_FIXTURE, checkpoint)
        _, rows, timings = export_check("[jax_ckpt] the fixture", card, checkpoint, 1, batches=(1, 7, 16))
    print(f"[jax_ckpt] phase in {time.perf_counter() - t0:.1f} s")
    return {"play_steps": steps_launches, "play": play_launches, "train": train, "epoch_s": times,
            "export_rows": rows, "export_timings": timings}


def phase_replay(capacity: int = 65536, obs_dim: int = 27, batch: int = 256, adds: int = 4):
    """[replay]: common/experience.py's prioritized add, update and sample
    at capacity 65,536, observations of 27, batch 256, on the card against
    the CPU with the same rows, priorities and Gumbel noise: the indexes
    equal, the weights within 1e-6; the device time of a sample."""
    from rl_games_tpu_torch.common import experience as E

    gen = torch.Generator().manual_seed(18)
    states = [E.prioritized_init(capacity, (obs_dim,), (8,), device) for device in ("cuda", "cpu")]
    rows = capacity * 3 // 8  # the adds wrap past the end
    for _ in range(adds):
        obs = torch.randn((rows, obs_dim), generator=gen)
        act, rew = torch.randn((rows, 8), generator=gen), torch.randn((rows,), generator=gen)
        done = torch.rand((rows,), generator=gen) < 0.05
        idx = torch.randint(0, capacity, (batch,), generator=gen)
        prio = torch.rand((batch,), generator=gen) * 4.0
        for s in states:
            E.prioritized_add(s, obs, act, rew, obs + 1.0, done)
            E.prioritized_update(s, idx, prio)
    noise = E.gumbel_noise(gen, (batch, capacity))
    (gb, gw, gi), (cb, cw, ci) = (E.prioritized_sample(s, None, batch, 0.4, noise=noise) for s in states)
    dw = float((gw.cpu() - cw).abs().max())
    dp = float((states[0].p_alpha.cpu() - states[1].p_alpha).abs().max())
    if not (torch.equal(gi.cpu(), ci) and dw <= 1e-6 and torch.equal(gb["obs"].cpu(), cb["obs"])):
        raise AssertionError(f"[replay] the card's sample differs from the CPU's: indexes equal "
                             f"{torch.equal(gi.cpu(), ci)}, weights within {dw}")
    gnoise = noise.cuda()
    ms, kernels = device_time_ms(lambda: E.prioritized_sample(states[0], None, batch, 0.4, noise=gnoise), 20)
    print(f"[replay] prioritized replay at capacity {capacity:,}, obs {obs_dim}, batch {batch} ({adds} adds of "
          f"{rows:,} rows, wrapping; {adds} updates): indexes equal, weights within {dw:.2e}, p_alpha within "
          f"{dp:.2e} (card against CPU); a sample with the noise given {ms * 1e3:.1f} us of device time in "
          f"{kernels} kernels")
    return {"weights_err": dw, "sample_ms": ms}


def profile_report(tag: str, prof, wall_us: float, detail: str):
    """The device's busy time and idle share over ``wall_us`` of host time,
    and the device time by kernel, of one torch.profiler session."""
    # device activity only: key_averages() also credits each kernel's time
    # to the CPU op that launched it, so summing its rows counts it twice
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.time_range.elapsed_us() for e in kernels)  # one stream: no overlap
    print(f"[{tag}] epoch wall {wall_us / 1e3:.1f} ms ({detail}, profiler on); device busy {device_us / 1e3:.1f} ms, "
          f"idle share {1 - device_us / wall_us:.3f}; {len(kernels)} device kernels")
    for line in prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=30).splitlines():
        print(f"[{tag}] {line}")
    if device_us > wall_us:  # events counted twice or overlapping: the share would be wrong
        raise AssertionError(f"[{tag}] device busy {device_us:.0f} us exceeds the wall time {wall_us:.0f} us")
    return 1 - device_us / wall_us


def phase_mesh(epochs: int = 3):
    """[mesh]: see the module docstring, phase 28. Returns the launch counts
    of each world's runs, per rank, with the epochs each trained."""
    import torch.distributed as dist

    from rl_games_tpu_torch.parallel import dryrun
    from rl_games_tpu_torch.parallel.mesh import create_mesh, initialize_multihost

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    fused = flagship_params(8192)
    fused["network"]["mlp"]["fused"] = True
    sac = load_config("sac_ant2d.yaml")["params"]
    sac["config"].update(num_warmup_steps=1, print_stats=False)
    sac_epochs = epochs + 1  # the warmup epoch, then epochs of updates
    specs = {"flagship": ("flagship", flagship_params(8192), epochs, {}),
             "fused": ("fused", fused, epochs, {}),
             "sac": ("sac", sac, sac_epochs, {})}
    # the world of 2 also records the state at each later epoch's start, from which the plain process then
    # runs that epoch: after an update the world's weights differ from the plain run's by rounding (the
    # gradients summed in another order), which 16 steps of contact dynamics amplify from epoch to epoch
    world_specs = {name: (program, params, n, {"record_starts": True})
                   for name, (program, params, n, _) in specs.items()}
    t0 = time.perf_counter()
    plain = dryrun.run_programs(specs, device="cuda")
    print(f"[mesh] plain process: {time.perf_counter() - t0:.1f} s")

    def leaves(result):
        """Every tensor of a run; of each meter its ring, pointer and count (its last row is the spare row
        that takes the scatter's writes of the rows that did not finish, in no set order on the card)."""
        out = dict(dryrun._leaves({k: result[k] for k in ("metrics", "weights", "opt")}))
        for name, m in result["meters"].items():
            out.update({f"/meters/{name}/ring": m["buf"][:-1], f"/meters/{name}/ptr": m["ptr"],
                        f"/meters/{name}/count": m["count"]})
        return out

    # (a) an NCCL world of 1 in this process
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        initialize_multihost(f"file://{tmp}/nccl_init", 1, 0, "nccl")
        try:
            one = dryrun.run_program("flagship", flagship_params(8192), mesh=create_mesh("cuda"), device="cuda",
                                     epochs=epochs)
        finally:
            dist.destroy_process_group()
    expected, got = leaves(plain["flagship"]), leaves(one)
    differ = [k for k in expected if k not in got or not torch.equal(expected[k], got[k])]
    if differ or expected.keys() != got.keys():
        raise AssertionError(f"[mesh] (a) the NCCL world of 1 differs from the plain process in {differ[:8]} "
                             f"({len(differ)} of {len(expected)} tensors)")
    print(f"[mesh] (a) NCCL world of 1: {len(expected)} tensors bit for bit the plain process after {epochs} "
          f"epochs (weights, Adam state, lr, metrics, meters; {int(one['meters']['game_rewards']['count'])} "
          f"games in the meters); {time.perf_counter() - t0:.1f} s with the world's set-up")

    # (b) a gloo world of 2 on the one card
    t0 = time.perf_counter()
    two = dryrun.run_world(dryrun.run_programs, 2, world_specs, backend="gloo", device="cuda")
    print(f"[mesh] (b) gloo world of 2 over CUDA tensors: {time.perf_counter() - t0:.1f} s with the spawn")
    t0 = time.perf_counter()
    for name in specs:
        differ = dryrun.ranks_differ([r[name] for r in two])
        if differ:
            raise AssertionError(f"[mesh] (b) {name}: the ranks differ in {differ[:8]}")
        program, params, n, _ = specs[name]
        keys = ("critic_loss", "actor_loss") if name == "sac" else ("a_loss", "c_loss")
        first = 1 if name == "sac" else 0  # the first epoch with updates (SAC's first is its warmup)
        for e in range(first, n):
            m1, m2 = plain[name]["metrics"][e], two[0][name]["metrics"][e]
            ref, source = m1, "plain"
            if e > 0:  # the plain process's epoch from the world's state at its start
                start = functools.partial(dryrun.restore_state, full=two[0][name]["starts"][e - 1])
                ref = dryrun.run_program(program, params, device="cuda", setup=start)["metrics"][0]
                source = "plain from the world's state"
            for k in keys:
                a, b = float(ref[k]), float(m2[k])
                if not (math.isfinite(b) and abs(b - a) <= 1e-5 + 1e-3 * abs(a)):
                    raise AssertionError(f"[mesh] (b) {name} epoch {e + 1} {k}: world {b} against {source} {a}")
            print(f"[mesh] (b) {name} epoch {e + 1}: " + ", ".join(
                f"{k} {float(m2[k]):.6f} ({source} {float(ref[k]):.6f}, |d| {abs(float(m2[k]) - float(ref[k])):.3g}; "
                f"the plain run's own {float(m1[k]):.6f})" for k in keys))
        if name == "sac":
            a = float(plain[name]["weights"]["log_alpha"])
            b = float(two[0][name]["weights"]["log_alpha"])
            if not abs(b - a) <= 1e-4 * abs(a):
                raise AssertionError(f"[mesh] (b) sac log_alpha: world {b} against plain {a}")
            print(f"[mesh] (b) sac log_alpha {b:.7f} (plain {a:.7f})")

    print(f"[mesh] (b) the plain process's epochs from the world's states: {time.perf_counter() - t0:.1f} s")

    # the kernels in every rank, and the epochs
    runs = {"nccl_world1": (one, epochs)}
    for name in ("flagship", "fused"):
        for r, rank in enumerate(two):
            runs[f"gloo_world2_{name}_rank{r}"] = (rank[name], epochs)
    for tag, (res, n) in runs.items():
        want = {"gae": n, "fused_mlp": 33 * n if "fused" in tag else 0}
        if res["launches"] != want:
            raise AssertionError(f"[mesh] {tag}: launches {res['launches']}, expected {want}")
    for r, rank in enumerate(two):
        if rank["sac"]["launches"] != {"gae": 0, "fused_mlp": 0}:
            raise AssertionError(f"[mesh] sac rank {r}: launches {rank['sac']['launches']}, expected none")
    print("[mesh] launches per rank: " + ", ".join(f"{tag} {res['launches']}" for tag, (res, _) in runs.items()))

    def steady(res):
        return float(np.median(res["seconds"][1:]))

    batch = 8192 * 16
    for name in specs:
        line = f"[mesh] {name} steady epoch: plain {steady(plain[name]) * 1e3:.1f} ms"
        if name == "flagship":
            line += f", NCCL world of 1 {steady(one) * 1e3:.1f} ms"
        line += ", gloo world of 2 " + " / ".join(f"{steady(rank[name]) * 1e3:.1f}" for rank in two) + " ms"
        if name != "sac":
            line += f" ({batch / steady(two[0][name]):,.0f} env-steps/s)"
        print(line + f"; {smi}")
    return {tag: {"launches": res["launches"], "epochs": n} for tag, (res, n) in runs.items()}


def phase_profile_sac(agent, state):
    """One SAC update epoch under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        agent.train_epoch(state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    profile_report("sac profile", prof, wall_us, f"{agent.num_steps_per_episode} env steps and "
                   f"{agent.num_steps_per_episode * agent.num_updates_per_step} updates")


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
    profile_report("profile", prof, (t2 - t0) * 1e6,
                   f"rollout {(t1 - t0) * 1e3:.1f} ms, gae+update {(t2 - t1) * 1e3:.1f} ms")


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
    phase_envs_discrete()
    # before phase_profile: phase_sac's device_time_ms needs CUDA-only
    # sessions that keep every event (see phase_profiler_sessions)
    sac_train, sac_play, _ = phase_sac(args.epochs, args.profile)
    agent, state, plain_launches, plain_epoch_s = phase_trainer(args.epochs)
    if args.profile:
        phase_profile(agent, state)
    del agent, state
    train_launches, play_launches, play_steps = phase_runner(args.epochs, plain_epoch_s)
    h_train, h_play, _ = phase_humanoid3d(args.epochs)
    a3_launches, _ = phase_ant3d(args.epochs)
    pong_launches, pong_epoch_s = phase_pong(args.epochs)
    # A15-A16: the nature-CNN's 3136 -> 512 torso fused (one launch that streams its input), then a torso
    # deeper than one launch takes
    pong_fused, _ = phase_pong_fused(args.epochs, pong_epoch_s)
    deep_launches, _ = phase_deep_torso(2)
    agent, state, breakout_launches, _ = phase_breakout(3)
    if args.profile:
        phase_profile(agent, state)
    del agent, state
    cp_train, cp_play, cp_steps, _ = phase_cartpole(args.epochs)
    # the host-env paths (PR 7): PPO over the native stepper in both
    # placements and with the fused MLP, then SAC
    host = phase_host_ppo(args.epochs, args.profile)
    pixel_launches = phase_host_pixel()
    host_sac_train, host_sac_play, _ = phase_host_sac(8)
    heads = phase_heads(args.epochs)
    rnn = phase_rnn(3)
    # A8 (a): dict observations and the custom test networks, then SAC's
    # layer-norm torsos over the native stepper as [host_sac] runs
    dict_runs = phase_dict(3)
    norm_train, norm_play, _ = phase_host_sac(8, config="ref/mujoco/sac_ant_tuned.yaml", tag="sac_norm")
    # A8 (b): the Impala tower (with and without attention) and the two-hot value head
    impala = phase_impala(3)
    th_train, th_play, th_steps, _ = phase_cartpole(3, tag="twohot", value_head="twohot")
    # [reference]'s A8 (b) checks come after every profiled phase: once every profiler session after
    # reference_impala lost one device event (other runs met the same from [envs] on without it: the
    # mode is the profiler's, and device_time_ms takes it; PERF.md §6-7)
    reference_impala()
    reference_twohot()
    reference_connect4()
    # multi-seed training and PBT, after every profiled phase as well
    population = phase_population(8)
    # self-play and multi-agent PPO (A12, second part)
    selfplay = phase_selfplay(args.epochs)
    # the rest of A12: policy export, the JAX package's .ckpt, prioritized replay
    export = phase_export()
    jax_ckpt = phase_jax_ckpt()
    phase_replay()
    # data parallelism (A13): an NCCL world of 1, a gloo world of 2 on the card
    mesh = phase_mesh()

    # launches of the main paths' runs, each counted from 0: the plain
    # trainer, the fused trainer and its player, the Humanoid3D trainer and
    # its player, the Ant3D, Pong, Breakout and CartPole trainers and the
    # CartPole player
    host_runs = tuple(host[tag]["train"] for tag in ("default", "cpu", "default fused"))
    runs = (plain_launches, train_launches, h_train, a3_launches, pong_launches, breakout_launches, cp_train,
            *host_runs, pixel_launches, *(heads[tag]["train"] for tag in heads), *(rnn[tag]["train"] for tag in rnn),
            *(dict_runs[tag]["train"] for tag in dict_runs), *(impala[tag]["train"] for tag in impala), th_train,
            *(population[tag]["train"] for tag in ("a", "b", "d")), selfplay["a"]["train"], selfplay["c"]["train"],
            selfplay["f"]["train"], export["a"]["train"], export["c"]["train"], jax_ckpt["train"],
            pong_fused["train"], deep_launches)
    # Breakout trains 3 epochs, [host_pixel] 3 in each of its two placements, each [rnn], [dict], [impala] and
    # [twohot] run 3; [selfplay] (a) --epochs, (c) 3, (f) 3
    epochs_trained = ((args.epochs,) * 5 + (3,) + (args.epochs,) * 4 + (6,) + (args.epochs,) * len(heads)
                      + (3,) * len(rnn) + (3,) * len(dict_runs) + (3,) * len(impala) + (3,)
                      # [population]: its runs' member epochs, each with its own GAE launch
                      + tuple(population[tag]["member_epochs"] for tag in ("a", "b", "d"))
                      + (args.epochs, 3, selfplay["f"]["epochs"])
                      # [export] (a) and (c) 1 epoch each, [jax_ckpt] 2 resumed epochs
                      + (1, 1, 2)
                      # [pong_fused] --epochs, [deep_torso] 2
                      + (args.epochs, 2))
    # [mesh]: each world's runs, a rank each
    runs += tuple(m["launches"] for m in mesh.values())
    epochs_trained += tuple(m["epochs"] for m in mesh.values())
    gae_entry["launches"] = sum(r["gae"] for r in runs)
    gae_entry["launches_per_epoch"] = gae_entry["launches"] / sum(epochs_trained)
    gae_entry["launches_by_path"] = {"flagship_plain": plain_launches["gae"], "flagship_fused": train_launches["gae"],
                                     "humanoid3d": h_train["gae"], "ant3d": a3_launches["gae"],
                                     "pong": pong_launches["gae"], "breakout": breakout_launches["gae"],
                                     "cartpole": cp_train["gae"], "sac_ant2d": sac_train["gae"],
                                     "host_ppo": {tag: host[tag]["train"]["gae"] for tag in host},
                                     "host_pixel": pixel_launches["gae"], "host_sac": host_sac_train["gae"],
                                     "heads": {tag: heads[tag]["train"]["gae"] for tag in heads},
                                     "rnn": {tag: rnn[tag]["train"]["gae"] for tag in rnn},
                                     # [dict]: GAE at [256, 16, 1] once an epoch; [sac_norm] none
                                     "dict": {tag: dict_runs[tag]["train"]["gae"] for tag in dict_runs},
                                     "sac_norm": norm_train["gae"],
                                     # [impala]: GAE at [256, 16, 1] once an epoch; [twohot] at [32, 16, 1]
                                     "impala": {tag: impala[tag]["train"]["gae"] for tag in impala},
                                     "twohot": th_train["gae"],
                                     # [population]: (a) 4 members at [16, 2048, 1] an epoch; (b) 2 members
                                     # and (d) 1 of the fused flagship at [16, 8192, 1]
                                     "population": {tag: population[tag]["train"]["gae"] for tag in ("a", "b", "d")},
                                     # [selfplay]: (a) at [32, 1024, 1], (c) at [16, 3072, 1], once an epoch
                                     "selfplay": selfplay["a"]["train"]["gae"],
                                     "selfplay_fused": selfplay["f"]["train"]["gae"],
                                     "multiagent": selfplay["c"]["train"]["gae"],
                                     # [export] (a) at [16, 8192, 1], (c) at [256, 16, 1]; (b) SAC none
                                     "export": {tag: export[tag]["train"]["gae"] for tag in ("a", "b", "c")},
                                     # [jax_ckpt]: the resumed epochs at [32, 16, 1]
                                     "jax_ckpt": jax_ckpt["train"]["gae"],
                                     # [mesh]: at [16, 8192, 1] once an epoch in every rank
                                     "mesh": {tag: m["launches"]["gae"] for tag, m in mesh.items()},
                                     # [pong_fused] at [64, 512, 1], [deep_torso] at [16, 8192, 1]
                                     "pong_fused": pong_fused["train"]["gae"], "deep_torso": deep_launches["gae"]}
    host_fused = host["default fused"]
    fused_entry["launches"] = (train_launches["fused_mlp"] + play_launches["fused_mlp"]
                               + h_train["fused_mlp"] + h_play["fused_mlp"]
                               + cp_train["fused_mlp"] + cp_play["fused_mlp"]
                               + host_fused["train"]["fused_mlp"] + host_fused["play"]["fused_mlp"]
                               + sum(heads[tag]["train"]["fused_mlp"] + heads[tag]["play"]["fused_mlp"]
                                     for tag in heads)
                               + sum(rnn[tag]["train"]["fused_mlp"] + rnn[tag].get("play", {}).get("fused_mlp", 0)
                                     for tag in rnn)
                               + th_train["fused_mlp"] + th_play["fused_mlp"]
                               + population["b"]["train"]["fused_mlp"] + population["d"]["train"]["fused_mlp"]
                               + selfplay["a"]["train"]["fused_mlp"] + selfplay["a"]["play"]["fused_mlp"]
                               + selfplay["c"]["train"]["fused_mlp"]
                               + selfplay["f"]["train"]["fused_mlp"] + selfplay["f"]["play"]["fused_mlp"]
                               + sum(export[tag]["train"]["fused_mlp"] + sum(r["launches"] for r in export[tag]["rows"])
                                     for tag in ("a", "b", "c")) + export["d"]["launches"]
                               + sum(jax_ckpt[key]["fused_mlp"] for key in ("play_steps", "play", "train"))
                               + sum(r["launches"] for r in jax_ckpt["export_rows"])
                               + sum(m["launches"]["fused_mlp"] for m in mesh.values())
                               + pong_fused["train"]["fused_mlp"] + pong_fused["play"]["fused_mlp"]
                               + deep_launches["fused_mlp"])
    fused_entry["launches_per_epoch"] = train_launches["fused_mlp"] / args.epochs
    fused_entry["launches_per_player_step"] = play_launches["fused_mlp"] / play_steps
    fused_entry["launches_humanoid3d"] = {"train": h_train["fused_mlp"], "play": h_play["fused_mlp"]}
    fused_entry["launches_cartpole"] = {"train": cp_train["fused_mlp"], "play": cp_play["fused_mlp"],
                                        "per_epoch": cp_train["fused_mlp"] / args.epochs,
                                        "per_player_step": cp_play["fused_mlp"] / cp_steps}
    # the SAC path's networks are the plain chain (as the JAX package's): 0
    fused_entry["launches_sac_ant2d"] = {"train": sac_train["fused_mlp"], "play": sac_play["fused_mlp"]}
    # the host path: 256 rollout + 1 bootstrap forwards at B = 64 and 40
    # minibatch forwards at B = 2048 per epoch, 1 per player step; none in
    # the cpu placement's runs (the CPU copy takes the plain chain) or SAC's
    fused_entry["launches_host_ppo"] = {
        "train": host_fused["train"]["fused_mlp"], "train_batches": host_fused["batches"],
        "per_epoch": host_fused["train"]["fused_mlp"] / args.epochs, "play": host_fused["play"]["fused_mlp"],
        "per_player_step": host_fused["play"]["fused_mlp"] / host_fused["play_steps"],
        "plain_runs": {tag: host[tag]["train"]["fused_mlp"] for tag in ("default", "cpu")},
        "host_sac": {"train": host_sac_train["fused_mlp"], "play": host_sac_play["fused_mlp"]}}
    # [heads] (d): two chains a forward (the actor's and the critic's trunk)
    # at B = 16 in the rollout and the player, B = 1024 in the minibatches
    hd = heads["d"]
    fused_entry["launches_heads"] = {
        "train": hd["train"]["fused_mlp"], "play": hd["play"]["fused_mlp"], "train_batches": hd["train_batches"],
        "play_batches": hd["play_batches"], "steady_player_batches": hd["steady_batches"],
        "per_epoch": hd["train"]["fused_mlp"] / args.epochs,
        "per_player_step": hd["play"]["fused_mlp"] / hd["play_steps"],
        "other_runs": {tag: heads[tag]["train"]["fused_mlp"] + heads[tag]["play"]["fused_mlp"]
                       for tag in heads if tag != "d"}}
    # [rnn] (d): one chain a forward in front of the GRU, B = 16 in the rollout
    # and the player, 2048 in the minibatches; (e): the flagship's 33 an
    # epoch with bfloat16-rounded weights in the minibatches' forwards
    rd, re_ = rnn["d"], rnn["e"]
    fused_entry["launches_rnn"] = {
        "walker_gru": {"train": rd["train"]["fused_mlp"], "play": rd["play"]["fused_mlp"],
                       "train_batches": rd["train_batches"], "play_batches": rd["play_batches"],
                       "steady_player_batches": rd["steady_batches"], "per_epoch": rd["train"]["fused_mlp"] / 3,
                       "per_player_step": rd["play"]["fused_mlp"] / rd["play_steps"]},
        "flagship_mixed_precision": {"train": re_["train"]["fused_mlp"], "train_batches": re_["train_batches"],
                                     "per_epoch": re_["train"]["fused_mlp"] / 3},
        "other_runs": {tag: rnn[tag]["train"]["fused_mlp"] + rnn[tag]["play"]["fused_mlp"]
                       for tag in rnn if tag not in ("d", "e")}}
    # [dict] and [sac_norm] take the plain chain: no fused launch
    fused_entry["launches_dict"] = {tag: {"train": dict_runs[tag]["train"]["fused_mlp"],
                                          "play": dict_runs[tag]["play"]["fused_mlp"]} for tag in dict_runs}
    fused_entry["launches_sac_norm"] = {"train": norm_train["fused_mlp"], "play": norm_play["fused_mlp"]}
    # [impala] takes the plain chain behind the tower: no fused launch; [twohot]
    # is [cartpole]'s fused 4->32->32 relu at B = 16 and 64 with the two-hot head
    fused_entry["launches_impala"] = {tag: {"train": impala[tag]["train"]["fused_mlp"],
                                            "play": impala[tag]["play"]["fused_mlp"]} for tag in impala}
    fused_entry["launches_twohot"] = {"train": th_train["fused_mlp"], "play": th_play["fused_mlp"],
                                      "per_epoch": th_train["fused_mlp"] / 3,
                                      "per_player_step": th_play["fused_mlp"] / th_steps}
    # [population]: (a) plain (0), (b) and (d) the fused flagship's 33 a member epoch
    fused_entry["launches_population"] = {tag: population[tag]["train"]["fused_mlp"] for tag in ("a", "b", "d")}
    # [selfplay] (a) and (c): plain MLPs on both paths (the opponents' vmapped forward is a batched product): 0
    fused_entry["launches_selfplay"] = {"train": selfplay["a"]["train"]["fused_mlp"],
                                        "play": selfplay["a"]["play"]["fused_mlp"]}
    fused_entry["launches_multiagent"] = {"train": selfplay["c"]["train"]["fused_mlp"]}
    # [selfplay] (f): the fused seat; an epoch 32 + 1 ordinary launches at B = 1024 and 8 at 8192, 32 grouped at
    # G = 1024, B = 1 (the opponents, a step each); a player step one of each (grouped ones among "launches")
    sf = selfplay["f"]
    fused_entry["launches_selfplay_fused"] = {
        "train": sf["train"]["fused_mlp"], "train_grouped": sf["train_grouped"], "play": sf["play"]["fused_mlp"],
        "play_grouped": sf["play_grouped"], "per_epoch": sf["train"]["fused_mlp"] / sf["epochs"],
        "grouped_per_epoch": sf["train_grouped"] / sf["epochs"],
        "per_player_step": sf["play"]["fused_mlp"] / sf["play_steps"], "play_steps": sf["play_steps"]}
    fused_entry["launches_grouped"] = sf["train_grouped"] + sf["play_grouped"]
    fused_entry["selfplay_fused"] = {
        "opp_kernels": sf["opp_kernels"], "opp_ms": sf["opp_ms"], "opp_device_ms": sf["opp_device_ms"],
        "plain_opp_kernels": selfplay["a"]["opp_kernels"], "plain_opp_ms": selfplay["a"]["opp_ms"],
        "push_max_abs_err": sf["push"]["max_abs_err"], "vmap_grad_max_abs_err": sf["vmap_grad_err"]}
    # [export]: each exported program's call launches the chain once ((b), SAC, none), also in a fresh
    # process (d); its time at B = 8192 beside the player's forward; the operator's host cost
    fused_entry["launches_export"] = {
        tag: {"train": export[tag]["train"]["fused_mlp"], "per_call": {r["batch"]: r["launches"] for r in export[tag]["rows"]}}
        for tag in ("a", "b", "c")}
    fused_entry["launches_export"]["fresh_process"] = export["d"]["launches"]
    timing = export["a"]["timings"]
    fused_entry["export_flagship_8192"] = {
        "host_us": timing["export_host_us"], "device_ms": timing["export_device"][0], "kernels": timing["export_device"][1],
        "player_host_us": timing["player_host_us"], "player_device_ms": timing["player_device"][0],
        "player_kernels": timing["player_device"][1]}
    fused_entry["operator_host_us"] = {b: {"direct": d, "operator": o} for b, (d, o) in export["operator"].items()}
    # [jax_ckpt]: the restored fixture's 200 steps and --play (1 a step), the resumed epochs (65 each), its export
    fused_entry["launches_jax_ckpt"] = {key: jax_ckpt[key]["fused_mlp"] for key in ("play_steps", "play", "train")}
    # [mesh]: the fused flagship's 33 an epoch in each rank of the world of 2 (16 rollout forwards of its
    # 4096 envs, 1 bootstrap, 16 minibatch forwards of 16384 rows), none in the plain runs
    fused_entry["launches_mesh"] = {tag: m["launches"]["fused_mlp"] for tag, m in mesh.items()}
    # [pong_fused]: the streamed 3136 -> 512 torso, 65 at B = 512 and 32 at 4096 an epoch, 1 a player step;
    # [deep_torso]: 33 forwards of two launches an epoch
    fused_entry["launches_pong_fused"] = {
        "train": pong_fused["train"]["fused_mlp"], "train_batches": pong_fused["train_batches"],
        "play": pong_fused["play"]["fused_mlp"], "play_batches": pong_fused["play_batches"],
        "per_epoch": pong_fused["train"]["fused_mlp"] / args.epochs,
        "per_player_step": pong_fused["play"]["fused_mlp"] / pong_fused["play_steps"]}
    fused_entry["launches_deep_torso"] = {"train": deep_launches["fused_mlp"],
                                          "per_epoch": deep_launches["fused_mlp"] / 2}
    # the cluster kernel (among "launches"): each run's launches of it, counted from 0 with the others and held
    # to what launch_plan makes of the run's batches; [rnn] (d)'s 257 an epoch at B = 16 (and 4 x 257 once, the
    # rollout timing of use_diagnostics), [export]'s one a call at B = 1 and 7; CartPole, Pendulum and the
    # grouped opponents (the held kernel) none
    launches_cluster = {
        "rnn_walker_gru": rnn["d"]["cluster"], "heads_pendulum": heads["d"]["cluster"],
        "host_ppo_fused": host["default fused"]["cluster"], "cartpole": cp_train["cluster"],
        "twohot": th_train["cluster"], "selfplay_fused": selfplay["f"]["cluster"], "pong_fused": pong_fused["cluster"],
        "export": {tag: {r["batch"]: r["cluster_launches"] for r in export[tag]["rows"]} for tag in ("a", "b", "c")}}
    fused_entry["launches_cluster"] = launches_cluster
    fused_entry["cluster_launches"] = (sum(sum(v.values()) for k, v in launches_cluster.items() if k != "export")
                                       + sum(sum(v.values()) for v in launches_cluster["export"].values()))
    if fused_entry["cluster_launches"] == 0:
        raise AssertionError("no main path launched the cluster kernel")
    # the sets kernel: [selfplay] (f)'s opponents, 32 an epoch (a rollout step each) and 1 a player step, counted
    # from 0 with the others; its device time a step beside the held grouped launch's in its place
    sets_entry = fused_entry.pop("sets_kernel")
    sets_entry["launches"] = sf["train_sets"] + sf["play_sets"]
    sets_entry["launches_selfplay_fused"] = {
        "train": sf["train_sets"], "play": sf["play_sets"], "per_epoch": sf["train_sets"] / sf["epochs"],
        "per_player_step": sf["play_sets"] / sf["play_steps"]}
    sets_entry["selfplay_opp_device_ms"] = {"sets": sf["opp_device_ms"], "held": sf["opp_held_device_ms"]}
    if sets_entry["launches"] == 0:
        raise AssertionError("no main path launched the sets kernel")
    # the wgmma kernel: the fused flagship's 17 + 16 an epoch (the rollout's B = 8192, the minibatches' 32768) and
    # 1 a player step, Humanoid3D's, the deep torso's two a forward, [rnn] (e)'s; each run counted from 0 with the
    # others and held to what launch_plan makes of its batches (check_wgmma_launches)
    wgmma_entry = fused_entry.pop("wgmma_kernel")
    wgmma_entry["launches_by_path"] = WGMMA_PATH_LAUNCHES
    wgmma_entry["launches"] = sum(sum(runs.values()) for runs in WGMMA_PATH_LAUNCHES.values())
    if sorted(WGMMA_PATH_LAUNCHES) != ["deep_torso", "humanoid3d", "rnn (e)", "runner"] or not all(
            sum(runs.values()) for runs in WGMMA_PATH_LAUNCHES.values()):
        raise AssertionError(f"a main path did not launch the wgmma kernel: {WGMMA_PATH_LAUNCHES}")
    print(json.dumps({"kernels": [gae_entry, fused_entry, sets_entry, wgmma_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
