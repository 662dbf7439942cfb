"""The fused MLP's kernel, this tree against another (a parent commit
unpacked with ``git archive``), in turns on one card; or, with ``--sweep``,
this tree's cluster, streamed, sets and wgmma kernels over every shape they
take.

    python3 tools/fused_mlp_ab.py PARENT_DIR [--rounds 1]
    python3 tools/fused_mlp_ab.py --sweep [cluster|stream|sets|wgmma] [--reps 20]

Each round runs four processes, one after another: PARENT_DIR, this tree,
this tree, PARENT_DIR. Each builds its own tree's kernels (its
``build/kernels``) and prints the device time of:

- the flagship torso 26->256->128->64 elu at B = 2048, 4096, 8192 and 32768,
  with bfloat16-rounded weights at 8192 and 32768 (``[rnn]`` (e)), and the 3D
  configs' torsos 33->256->128->64 and 41->256->128->64 at 4096 and 32768
  (``chip_smoke.time_fused``: ``fused_mlp_cuda`` against the plain chain in
  turns, torch.profiler): since the wgmma kernel, the tree's plan runs them
  there from ``WGMMA_MIN_ROWS`` rows on, where a parent before it runs the
  held kernel;
- the host time of one ``fused_mlp_cuda`` call at the flagship torso, B =
  8192;
- the small batches, the same way: 16->256->128->64 elu at B = 16 (the
  walker GRU's rollout), 5->128->64->32 elu at 64 (the host path),
  the flagship torso at 1, 7 and 16 (an exported policy, the player),
  3->32->32 elu at 16 (Pendulum) and 4->32->32 relu at 16 and 64 (CartPole):
  since the cluster kernel, the tree's ``launch_plan`` may run them there,
  where a parent before it runs the held kernel;
- the chains with a streamed first layer that ``chip_smoke.kernel_fused_mlp_wide``
  times (``chip_smoke.time_wide``, the same way, with ``torch.addmm`` of a
  one-layer chain and the bound beside): the nature-CNN torso 3136->512 at
  the Pong rollout's B = 512, the minibatch's 4096 and a ragged 4099; 3134 and
  3135 inputs at B = 512; (64, 4096, 4096, 8) at B = 1024; the grouped
  3136->512->64 at G = 4, B = 256 with the 3136-wide weight shared; and
  the deep torso, 10 layers of 256 at B = 8192 (two launches);
- the host time of one ``fused_mlp_cuda`` call at 3136->512, B = 512
  (``chip_smoke.host_us_per_call``);
- the grouped forage chain 6->128->64 elu at G = 1024 and 512, B = 1 (the
  self-play opponents) and G = 64, B = 3 (``chip_smoke.time_fused_grouped``:
  ``fused_mlp_grouped_cuda`` against ``plain_mlp_grouped``): since the sets
  kernel, the tree's plan runs them there, where a parent before it runs
  the held kernel.

Both trees need ``chip_smoke.py`` with ``time_fused``, ``time_wide``,
``time_fused_grouped``, ``mlp_inputs``, ``grouped_inputs``, ``FORAGE_DIMS``
and ``host_us_per_call``. Prints a line
per process and row, then one JSON object with each tree's numbers in run
order and the change's mean over the parent's for each row.

``--sweep`` runs in this process, every kernel unless one is named. The
cluster kernel (csrc/fused_mlp.cu ``fused_mlp_cluster_kernel``): for the
walker GRU's, the host path's and the flagship's torsos, Pendulum's and
CartPole's, the self-play learner's and the fused Pong head at B = 1, 16,
64, 256, 1024 and 2048, it launches the cluster kernel at every blocks a
cluster it takes (``CLUSTER_BLOCKS``) where the shares fit, and the held
kernel, checks each against the plain chain (rtol = atol = 2e-5), two calls
and the held kernel bit for bit, and prints the device time a call
(``chip_smoke.device_time_ms``, torch.profiler) beside the held kernel's,
the plain chain's and an empty launch of the same grid, cluster and shared
memory. The shape that ``ops/fused_mlp.cluster_plan`` picks is marked; the
fastest shape a batch and whether it beats the held kernel set
``CLUSTER_SHAPES`` and ``CLUSTER_MIN_TILES``. The streamed kernel: for
3136 -> 512 elu at B = 512, 1024 and
4096 and 4096 -> 4096 at B = 1024, it launches the streamed kernel
(csrc/fused_mlp.cu ``fused_mlp_stream_kernel``) at every rows a block (16,
32, 64), split of the output tiles and cluster that the kernel takes, checks
each result against the plain chain (rtol = atol = 1e-4), and prints the time
a call between CUDA events (after a warm-up, ``--reps`` calls) beside the
cost in the model that ``ops/fused_mlp.stream_plan`` picks from (waves times
output tiles a block times rows over ``STREAM_RATE``) and ``addmm``'s time.
Then the clusters of each size that the card holds at once
(``cudaOccupancyMaxActiveClusters``), which ``STREAM_WAVE_BLOCKS`` records.
The shape that the plan picks is marked. The sets kernel (csrc/fused_mlp.cu
``fused_mlp_sets_kernel``): for the forage opponents' chain 6->128->64 elu at
1, 2, 4, 8 and 16 rows a set over G = 64, 128, 256, 512 and 1024 sets, it
launches the sets kernel at every stage count of ``SETS_SWEEP_STAGES`` that
fits a block and every multiplying warps a set of ``SETS_SWEEP_WARPS`` whose
groups divide the stages, and the held grouped launch; checks each against
``plain_mlp_grouped`` (rtol = atol = 2e-5) and two calls bit for bit; and
prints the device time a call beside the held launch's, the plain chain's,
an empty launch of its grid and shared memory, and the bound (bytes). The
fastest shape and whether it beats the held launch set ``SETS_MAX_ROWS``,
``SETS_STAGES``, ``SETS_WARPS`` and ``SETS_MIN_GROUPS``. The wgmma kernel
(csrc/fused_mlp.cu ``fused_mlp_wgmma_kernel``, 64 rows a block: one
instruction's rows): for the main paths' chains (``WGMMA_SWEEP_CHAINS``) at B
= 1024 to 32768, it launches the kernel at every blocks a cluster it takes
(``WGMMA_CLUSTERS``) and ring of ``WGMMA_SWEEP_SLOTS`` slots that fits a
block, and the held kernel; checks each against the plain chain (rtol = atol
= 2e-5) and two calls bit for bit, and prints the device time a call beside
the held kernel's, the plain chain's, an empty launch of its grid and the
bound. The shape that ``wgmma_plan`` picks is marked. The fastest cluster and
slots over all rows set ``WGMMA_CLUSTER`` and ``WGMMA_SLOTS``, and each
chain's fewest rows from which that shape beats the held kernel at every
larger batch set ``WGMMA_MIN_ROWS`` and ``WGMMA_MIN_ROW_MACS`` (the summary
line names any shape the route takes where the held kernel was faster).
Ends with one JSON object of the rows.
"""

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys

FLAGSHIP_BATCHES = (2048, 4096, 8192, 32768)
# the 3D configs' torsos (chip_smoke's ANT3D_DIMS, HUMANOID3D_DIMS) at their rollouts' and minibatches' batches
WGMMA_ROWS = (("33x256x128x64", (33, 256, 128, 64), 4096), ("33x256x128x64", (33, 256, 128, 64), 32768),
              ("41x256x128x64", (41, 256, 128, 64), 4096), ("41x256x128x64", (41, 256, 128, 64), 32768))
# the small batches' chains (chip_smoke's WALKER_DIMS, HOPPER_DIMS, FLAGSHIP_DIMS, PENDULUM_DIMS, CARTPOLE_DIMS)
SMALL_ROWS = (("16x256x128x64", (16, 256, 128, 64), 16, "elu"), ("5x128x64x32", (5, 128, 64, 32), 64, "elu"),
              ("26x256x128x64", (26, 256, 128, 64), 1, "elu"), ("26x256x128x64", (26, 256, 128, 64), 7, "elu"),
              ("26x256x128x64", (26, 256, 128, 64), 16, "elu"), ("3x32x32", (3, 32, 32), 16, "elu"),
              ("4x32x32", (4, 32, 32), 16, "relu"), ("4x32x32", (4, 32, 32), 64, "relu"))
SWEEP_CASES = (((3136, 512), 512), ((3136, 512), 1024), ((3136, 512), 4096), ((4096, 4096), 1024))
# the walker GRU's, host path's, flagship's, Pendulum's and CartPole's torsos, the self-play learner's and the
# fused Pong head behind its streamed layer (a held launch of its own)
CLUSTER_SWEEP_CHAINS = (((16, 256, 128, 64), "elu"), ((5, 128, 64, 32), "elu"), ((26, 256, 128, 64), "elu"),
                        ((3, 32, 32), "elu"), ((4, 32, 32), "relu"), ((6, 128, 64), "elu"), ((512, 64), "elu"))
CLUSTER_SWEEP_BATCHES = (1, 16, 64, 256, 1024, 2048)
# the sets kernel's sweep: the forage opponents' chain at rows a set x sets, each stage count that fits a block
SETS_SWEEP_BATCHES = (1, 2, 4, 8, 16)
SETS_SWEEP_GROUPS = (64, 128, 256, 512, 1024)
SETS_SWEEP_STAGES = (2, 3, 4, 6, 8)
SETS_SWEEP_WARPS = (8, 4, 2, 1)  # multiplying warps a set (the kernel's 8 in groups of these)
# the wgmma kernel's sweep: the flagship's, the 3D configs', the walker GRU's, the host path's and the self-play
# learner's torsos and 8 layers of 256 (a launch of the deep torso), at these batches and ring depths
WGMMA_SWEEP_CHAINS = ((26, 256, 128, 64), (33, 256, 128, 64), (41, 256, 128, 64), (16, 256, 128, 64),
                      (5, 128, 64, 32), (6, 128, 64), (256,) * 9)
WGMMA_SWEEP_BATCHES = (1024, 2048, 4096, 8192, 16384, 32768)
WGMMA_SWEEP_SLOTS = (2, 3, 4, 5, 6)
PROBE = (
    "import json, torch, chip_smoke as c\n"
    "from rl_games_tpu_torch.ops import fused_mlp as fm\n"
    "from rl_games_tpu_torch.utils import cuda_build\n"
    "cuda_build.build_all()\n"
    "dev = torch.device('cuda')\n"
    "gen = torch.Generator(device=dev).manual_seed(1)\n"
    "rows = {f'26x256x128x64 B={b}': {'ms': c.time_fused(c.FLAGSHIP_DIMS, b, gen, dev)['ms']} for b in %r}\n"
    "for b in (8192, 32768):\n"
    "    r = c.time_fused(c.FLAGSHIP_DIMS, b, gen, dev, bf16_weights=True)\n"
    "    rows[f'26x256x128x64 bf16-rounded weights B={b}'] = {k: r[k] for k in ('ms', 'plain_ms', 'bound_ms')}\n"
    "for name, dims, b in %r:\n"
    "    r = c.time_fused(dims, b, gen, dev)\n"
    "    rows[f'{name} B={b}'] = {k: r[k] for k in ('ms', 'plain_ms', 'bound_ms')}\n"
    "x, ws, bs = c.mlp_inputs(c.FLAGSHIP_DIMS, 8192, gen, dev)\n"
    "rows['host time a call, 26x256x128x64 B=8192'] = {'us': c.host_us_per_call(lambda: fm.fused_mlp_cuda(x, ws, bs, 'elu'))}\n"
    "for name, dims, b, act in %r:\n"
    "    r = c.time_fused(dims, b, gen, dev, act)\n"
    "    rows[f'{name} B={b}'] = {k: r[k] for k in ('ms', 'plain_ms', 'bound_ms')}\n"
    "def wide(name, x, ws, bs):\n"
    "    r = c.time_wide(name, x, ws, bs)\n"
    "    rows[name] = {k: r[k] for k in ('ms', 'plain_ms', 'library_ms', 'bound_ms')}\n"
    "for batch in (512, 4096, 4099):\n"
    "    wide(f'3136x512 B={batch}', *c.mlp_inputs((3136, 512), batch, gen, dev))\n"
    "for k in (3134, 3135):\n"
    "    wide(f'{k}x512 B=512', *c.mlp_inputs((k, 512), 512, gen, dev))\n"
    "wide('64x4096x4096x8 B=1024', *c.mlp_inputs((64, 4096, 4096, 8), 1024, gen, dev))\n"
    "wide('10 layers of 256 B=8192', *c.mlp_inputs((256,) * 11, 8192, gen, dev))\n"
    "x, ws, bs = c.grouped_inputs((3136, 512, 64), 4, 256, gen, dev)\n"
    "wide('grouped 3136x512x64 G=4 B=256', x, [ws[0][0], ws[1]], bs)\n"
    "x, ws, bs = c.mlp_inputs((3136, 512), 512, gen, dev)\n"
    "rows['host time a call, 3136x512 B=512'] = {'us': c.host_us_per_call(lambda: fm.fused_mlp_cuda(x, ws, bs, 'elu'))}\n"
    "for g, b in ((1024, 1), (512, 1), (64, 3)):\n"
    "    r = c.time_fused_grouped('forage', *c.grouped_inputs(c.FORAGE_DIMS, g, b, gen, dev))\n"
    "    rows[f'grouped 6x128x64 G={g} B={b}'] = {k: r[k] for k in ('ms', 'plain_ms', 'bound_ms')}\n"
    "print('AB ' + json.dumps(rows))\n" % (FLAGSHIP_BATCHES, WGMMA_ROWS, SMALL_ROWS)
)


def times_of(tree: str):
    """{row: {ms, and for the streamed rows plain_ms, library_ms, bound_ms}}
    from one process in ``tree``; the host row holds "us"."""
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=tree, capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"{tree}: exited {out.returncode}\n{out.stdout[-4000:]}\n{out.stderr[-4000:]}")
    line = next(line for line in out.stdout.splitlines() if line.startswith("AB "))
    return json.loads(line[3:])


def event_us(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps * 1e3


def modelled(dims, batch, rows, split, cluster):
    from rl_games_tpu_torch.ops import fused_mlp as fm

    tiles = -(-dims[1] // 128)
    waves = -(-(-(-batch // rows) * split) // fm.STREAM_WAVE_BLOCKS[cluster])
    return waves * (tiles // split) * rows / fm.STREAM_RATE[rows]


def sweep(reps: int, smi: str):
    """The streamed kernel at every rows, split and cluster it takes (the
    module docstring's ``--sweep``)."""
    import torch

    from rl_games_tpu_torch.ops import fused_mlp as fm
    from rl_games_tpu_torch.utils import cuda_build

    if not torch.cuda.is_available():
        raise SystemExit("fused_mlp_ab --sweep: no CUDA card")
    cuda_build.build_all(["fused_mlp"])
    forward = fm._stream_kernel()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    rows_out = []
    for dims, batch in SWEEP_CASES:
        k, n = dims
        x = torch.randn((batch, k), generator=gen, device=dev)
        w = (torch.rand((n, k), generator=gen, device=dev) * 2 - 1) / math.sqrt(k)
        b = torch.randn((n,), generator=gen, device=dev) * 0.1
        out = torch.empty((batch, n), device=dev)
        want = fm.plain_mlp(x, [w], [b], "elu")
        plan = fm.stream_plan(dims, batch)
        tiles = -(-n // 128)
        addmm = event_us(lambda: torch.addmm(b, x, w.t()), reps)
        for rows in fm.STREAM_STAGES:
            for split in (d for d in range(1, fm.MAX_CLUSTER + 1) if tiles % d == 0):
                for cluster in (c for c in fm.STREAM_WAVE_BLOCKS if split % c == 0):
                    err = ctypes.c_int(0)

                    def call():
                        code = forward(x.data_ptr(), out.data_ptr(), batch, k, n, w.data_ptr(), b.data_ptr(),
                                       fm.ACTIVATION_CODES["elu"], rows, split, cluster, 1, 0, 0, 0, 0,
                                       fm.stream_copy(x, w), torch.cuda.current_stream().cuda_stream,
                                       ctypes.byref(err))
                        if code != 0 or err.value != 0:
                            raise RuntimeError(f"launch failed: {code}, {err.value}")

                    us = event_us(call, reps)
                    ok = torch.allclose(out, want, rtol=1e-4, atol=1e-4)
                    picked = plan[:3] == (rows, split, cluster)
                    row = {"dims": list(dims), "batch": batch, "rows": rows, "split": split, "cluster": cluster,
                           "us": us, "model": modelled(dims, batch, rows, split, cluster), "addmm_us": addmm,
                           "ok": ok, "picked": picked}
                    rows_out.append(row)
                    print(f"[sweep] {k}x{n} B={batch} rows {rows} split {split} cluster {cluster}: {us:.2f} us "
                          f"(model {row['model']:.1f}){' <- plan' if picked else ''}; addmm {addmm:.2f} us"
                          f"{'' if ok else '; DIFFERS from the plain chain'}")
                    if not ok:
                        raise AssertionError(f"the kernel differs from the plain chain at {row}")
    clusters = {f"{rows} rows": {c: fm.stream_clusters(rows, c) for c in fm.STREAM_WAVE_BLOCKS} for rows in fm.STREAM_STAGES}
    print(f"[sweep] clusters held at once (cudaOccupancyMaxActiveClusters): {clusters}")
    print(json.dumps({"device": smi, "rows": rows_out, "clusters_at_once": clusters}))


def cluster_sweep(reps: int, smi: str):
    """The cluster kernel at every shape it takes, beside the held kernel
    (the module docstring's ``--sweep``)."""
    import torch

    import chip_smoke as c
    from rl_games_tpu_torch.ops import fused_mlp as fm
    from rl_games_tpu_torch.utils import cuda_build

    if not torch.cuda.is_available():
        raise SystemExit("fused_mlp_ab --sweep: no CUDA card")
    cuda_build.build_all(["fused_mlp"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)

    rows_out, best = [], []
    for dims, activation in CLUSTER_SWEEP_CHAINS:
        act, n = fm.ACTIVATION_CODES[activation], len(dims) - 1
        name = "x".join(map(str, dims))
        for batch in CLUSTER_SWEEP_BATCHES:
            x, ws, bs = c.mlp_inputs(dims, batch, gen, dev)
            out = torch.empty((batch, dims[-1]), device=dev)
            want = fm.plain_mlp(x, ws, bs, activation)
            plain_ms, _ = c.device_time_ms(lambda: fm.plain_mlp(x, ws, bs, activation), reps)
            held_launch = fm.Launch(0, n, False, fm.kernel_plan(dims, batch))

            def run(launch):
                return lambda: fm._run_chain(x, out, batch, dims, ws, bs, act, [launch])

            run(held_launch)()
            held = out.clone()
            held_us = c.device_time_ms(run(held_launch), reps)[0] * 1e3
            picked = fm.cluster_plan(dims, batch)
            print(f"[sweep] {name} B={batch} {activation}: held kernel {held_us:.2f} us, plain chain "
                  f"{plain_ms * 1e3:.2f} us; the plan picks "
                  + (f"clusters of {picked.cluster}" if picked else "the held kernel"))
            fastest = None
            for cluster in fm.CLUSTER_BLOCKS:
                shared = fm.cluster_shared_bytes(dims, cluster)
                if shared > fm.MAX_SHARED_BYTES:
                    continue
                plan = fm.ClusterPlan(cluster, shared)
                launch = held_launch._replace(cluster=plan)
                run(launch)()
                torch.cuda.synchronize()
                share = float(((out - want).abs() / (2e-5 + 2e-5 * want.abs())).max())
                first = out.clone()
                us = c.device_time_ms(run(launch), reps)[0] * 1e3
                repeat = torch.equal(out, first)  # two calls, the same bits
                as_held = torch.equal(first, held)
                floor = c.device_time_ms(lambda: fm.cluster_empty_launch(plan, batch), reps)[0] * 1e3
                row = {"dims": list(dims), "batch": batch, "cluster": cluster, "us": us, "held_us": held_us,
                       "plain_us": plain_ms * 1e3, "floor_us": floor, "shared": shared,
                       "err_over_tolerance": share, "bit_equal_calls": repeat, "bit_equal_held": as_held,
                       "picked": picked == plan}
                rows_out.append(row)
                print(f"[sweep] {name} B={batch} clusters of {cluster}: {us:.2f} us (empty launch {floor:.2f} us; "
                      f"held {held_us:.2f}), {share:.3f} of the tolerance, max |cluster - held| "
                      f"{float((first - held).abs().max()):.1e}"
                      f"{' <- plan' if row['picked'] else ''}")
                if not (share <= 1.0 and repeat and as_held):
                    raise AssertionError(f"the cluster kernel is wrong at {row}")
                if fastest is None or us < fastest["us"]:
                    fastest = row
            best.append(fastest)
            print(f"[sweep] {name} B={batch}: fastest clusters of {fastest['cluster']} {fastest['us']:.2f} us against "
                  f"the held kernel's {held_us:.2f} us ({fastest['us'] / held_us:.3f}x)")
    print(json.dumps({"device": smi, "cluster_rows": rows_out, "fastest": best}))


def sets_sweep(reps: int, smi: str):
    """The sets kernel at every rows a set, set count and stage count of the
    sweep, beside the held grouped launch (the module docstring's
    ``--sweep``)."""
    import torch

    import chip_smoke as c
    from rl_games_tpu_torch.ops import fused_mlp as fm
    from rl_games_tpu_torch.utils import cuda_build

    if not torch.cuda.is_available():
        raise SystemExit("fused_mlp_ab --sweep: no CUDA card")
    cuda_build.build_all(["fused_mlp"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    dims, act = list(c.FORAGE_DIMS), fm.ACTIVATION_CODES["elu"]
    rows_out, best = [], []
    for batch in SETS_SWEEP_BATCHES:
        for groups in SETS_SWEEP_GROUPS:
            x, ws, bs = c.grouped_inputs(c.FORAGE_DIMS, groups, batch, gen, dev)
            out = torch.empty((groups, batch, dims[-1]), device=dev)
            strides = fm.grouped_set_strides(x, ws, bs, out)
            (planned,) = fm.grouped_launch_plan(dims, batch, groups, fm.set_strides_shared(strides))
            held_launch = planned._replace(sets=None)

            def run(launch):
                return lambda: fm._run_chain(x, out, batch, dims, ws, bs, act, [launch], groups, strides)

            want = fm.plain_mlp_grouped(x, ws, bs, "elu")
            plain_us = c.device_time_ms(lambda: fm.plain_mlp_grouped(x, ws, bs, "elu"), reps)[0] * 1e3
            held_us = c.device_time_ms(run(held_launch), reps)[0] * 1e3
            nbytes = 4 * (x.numel() + sum(t.numel() for t in (*ws, *bs)) + out.numel())
            bound_us = nbytes / c.PEAK_BYTES_PER_S * 1e6
            print(f"[sweep] sets {'x'.join(map(str, dims))} G={groups} B={batch}: held grouped launch {held_us:.2f} us,"
                  f" plain {plain_us:.2f} us, bound {bound_us:.2f} us ({nbytes} B); the plan picks "
                  + (f"{planned.sets.stages} stages, {planned.sets.warps} warps a set" if planned.sets
                     else "the held kernel"))
            fastest = None
            for stages, warps in ((s, w) for s in SETS_SWEEP_STAGES for w in SETS_SWEEP_WARPS
                                  if s % (fm.SETS_MULTIPLYING_WARPS // w) == 0):
                shared = fm.sets_shared_bytes(dims, batch, stages, warps=warps)
                if shared + fm._SETS_TABLE_BYTES > fm.MAX_SHARED_BYTES:
                    continue
                plan = fm.SetsPlan(next(r for r in fm.SETS_ROWS if r >= batch), stages, warps, shared)
                launch = held_launch._replace(sets=plan)
                run(launch)()
                torch.cuda.synchronize()
                share = float(((out - want).abs() / (2e-5 + 2e-5 * want.abs())).max())
                first = out.clone()
                us = c.device_time_ms(run(launch), reps)[0] * 1e3
                repeat = torch.equal(out, first)
                floor = c.device_time_ms(lambda: fm.sets_empty_launch(plan, groups), reps)[0] * 1e3
                row = {"dims": dims, "groups": groups, "batch": batch, "rows": plan.rows, "stages": stages, "warps": warps,
                       "grid": fm.sets_grid(plan, groups), "shared": shared, "us": us, "held_us": held_us,
                       "plain_us": plain_us, "floor_us": floor, "bound_us": bound_us, "err_over_tolerance": share,
                       "bit_equal_calls": repeat, "picked": planned.sets == plan}
                rows_out.append(row)
                print(f"[sweep] sets G={groups} B={batch} {stages} stages, {warps} warps a set (grid {row['grid']}, "
                      f"{shared} B shared): "
                      f"{us:.2f} us ({bound_us / us:.3f} of the bound; held {held_us:.2f}, {us / held_us:.3f}x; "
                      f"empty launch {floor:.2f} us), {share:.3f} of the tolerance{' <- plan' if row['picked'] else ''}")
                if not (share <= 1.0 and repeat):
                    raise AssertionError(f"the sets kernel is wrong at {row}")
                if fastest is None or us < fastest["us"]:
                    fastest = row
            best.append(fastest)
            print(f"[sweep] sets G={groups} B={batch}: fastest {fastest['stages']} stages, {fastest['warps']} warps a "
                  f"set {fastest['us']:.2f} us "
                  f"against the held launch's {held_us:.2f} us ({fastest['us'] / held_us:.3f}x)")
    print(json.dumps({"device": smi, "sets_rows": rows_out, "fastest": best}))


def wgmma_sweep(reps: int, smi: str):
    """The wgmma kernel at every cluster and ring depth over the main paths'
    chains and batches, beside the held kernel (the module docstring's
    ``--sweep``)."""
    import torch

    import chip_smoke as c
    from rl_games_tpu_torch.ops import fused_mlp as fm
    from rl_games_tpu_torch.utils import cuda_build

    if not torch.cuda.is_available():
        raise SystemExit("fused_mlp_ab --sweep: no CUDA card")
    cuda_build.build_all(["fused_mlp"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    act = fm.ACTIVATION_CODES["elu"]
    rows_out, best, by_shape = [], [], {}
    for dims in WGMMA_SWEEP_CHAINS:
        n, name = len(dims) - 1, "x".join(map(str, dims[:4])) + ("..." if len(dims) > 4 else "")
        for batch in WGMMA_SWEEP_BATCHES:
            x, ws, bs = c.mlp_inputs(dims, batch, gen, dev)
            out = torch.empty((batch, dims[-1]), device=dev)
            want = fm.plain_mlp(x, ws, bs, "elu")
            held_launch = fm.Launch(0, n, False, fm.kernel_plan(dims, batch))

            def run(launch):
                return lambda: fm._run_chain(x, out, batch, list(dims), ws, bs, act, [launch])

            plain_us = c.device_time_ms(lambda: fm.plain_mlp(x, ws, bs, "elu"), reps)[0] * 1e3
            held_us = c.device_time_ms(run(held_launch), reps)[0] * 1e3
            n_weights = sum(dims[i] * dims[i + 1] for i in range(n))
            bound_ms, _ = c.bound_ms(4 * (x.numel() + out.numel() + n_weights + sum(dims[1:])),
                                     3 * 2 * batch * n_weights, c.PEAK_TF32_FLOPS)
            picked = fm.wgmma_plan(dims, batch)
            print(f"[sweep] wgmma {name} B={batch}: held kernel {held_us:.2f} us, plain chain {plain_us:.2f} us, "
                  f"bound {bound_ms * 1e3:.2f} us; the plan picks "
                  + (f"clusters of {picked.cluster}, {picked.slots} slots" if picked else "another kernel"))
            fastest = None
            for cluster in fm.WGMMA_CLUSTERS:
                for slots in WGMMA_SWEEP_SLOTS:
                    plan = fm.wgmma_plan(dims, batch, cluster=cluster, slots=slots)
                    if plan is None:
                        continue
                    launch = held_launch._replace(wgmma=plan)
                    out.fill_(float("nan"))
                    run(launch)()
                    torch.cuda.synchronize()
                    share = float(((out - want).abs() / (2e-5 + 2e-5 * want.abs())).max())
                    first = out.clone()
                    us = c.device_time_ms(run(launch), reps)[0] * 1e3
                    repeat = torch.equal(out, first)
                    floor = c.device_time_ms(lambda: fm.wgmma_empty_launch(plan, batch), reps)[0] * 1e3
                    row = {"dims": list(dims), "batch": batch, "cluster": cluster, "slots": slots,
                           "grid": fm.wgmma_grid(plan, batch), "shared": plan.shared, "us": us, "held_us": held_us,
                           "plain_us": plain_us, "floor_us": floor, "bound_us": bound_ms * 1e3,
                           "err_over_tolerance": share, "bit_equal_calls": repeat, "picked": picked == plan}
                    rows_out.append(row)
                    by_shape.setdefault((cluster, slots), []).append(row)
                    print(f"[sweep] wgmma {name} B={batch} clusters of {cluster}, {slots} slots (grid {row['grid']}, "
                          f"{plan.shared} B shared): {us:.2f} us ({us / held_us:.3f}x the held kernel; "
                          f"{bound_ms * 1e3 / us:.3f} of the bound; empty launch {floor:.2f} us), {share:.3f} of the "
                          f"tolerance{' <- plan' if row['picked'] else ''}")
                    if not (share <= 1.0 and repeat):
                        raise AssertionError(f"the wgmma kernel is wrong at {row}")
                    if fastest is None or us < fastest["us"]:
                        fastest = row
            best.append(fastest)
            print(f"[sweep] wgmma {name} B={batch}: fastest clusters of {fastest['cluster']}, {fastest['slots']} "
                  f"slots {fastest['us']:.2f} us against the held kernel's {held_us:.2f} us "
                  f"({fastest['us'] / held_us:.3f}x)")
    # the shape fastest over all rows (sum of its times over the rows where every shape ran); for each chain the
    # fewest rows from which that shape beats the held kernel at every larger batch of the sweep; whether the
    # route (WGMMA_MIN_ROWS, WGMMA_MIN_ROW_MACS) takes a shape where the held kernel was faster
    common = [key for key, rows in by_shape.items() if len(rows) == len(best)]
    shape = min(common, key=lambda key: sum(r["us"] for r in by_shape[key]))
    crossovers, lost = {}, []
    for dims in WGMMA_SWEEP_CHAINS:
        wins = {r["batch"]: r["us"] < r["held_us"] for r in by_shape[shape] if tuple(r["dims"]) == dims}
        name = "x".join(map(str, dims[:4])) + ("..." if len(dims) > 4 else "")
        crossovers[name] = {"row_macs": fm.row_macs(dims), "crossover": next(
            (b for b in WGMMA_SWEEP_BATCHES if all(wins[k] for k in WGMMA_SWEEP_BATCHES if k >= b)), None)}
        lost += [(name, b) for b, won in wins.items() if not won and fm.wgmma_plan(dims, b) is not None]
    print(f"[sweep] wgmma: over every chain and batch the fastest shape is clusters of {shape[0]}, {shape[1]} slots "
          f"(WGMMA_CLUSTER {fm.WGMMA_CLUSTER}, WGMMA_SLOTS {fm.WGMMA_SLOTS}); the fewest rows from which it beats the "
          f"held kernel at every larger batch, a chain: {crossovers}; the route (WGMMA_MIN_ROWS {fm.WGMMA_MIN_ROWS}, "
          f"WGMMA_MIN_ROW_MACS {fm.WGMMA_MIN_ROW_MACS}) takes shapes where the held kernel was faster: {lost}")
    print(json.dumps({"device": smi, "wgmma_rows": rows_out, "fastest": best,
                      "shape": {"cluster": shape[0], "slots": shape[1]}, "crossovers": crossovers,
                      "routed_where_held_won": lost}))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("parent", nargs="?")
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--sweep", nargs="?", const="all", choices=("all", "cluster", "stream", "sets", "wgmma"))
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    if (args.sweep is not None) == (args.parent is not None):
        parser.error("give PARENT_DIR or --sweep")
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[fused_mlp_ab] {smi}")
    if args.sweep:
        sys.path.insert(0, here)
        if args.sweep in ("all", "cluster"):
            cluster_sweep(args.reps, smi)
        if args.sweep in ("all", "stream"):
            sweep(args.reps, smi)
        if args.sweep in ("all", "sets"):
            sets_sweep(args.reps, smi)
        if args.sweep in ("all", "wgmma"):
            wgmma_sweep(args.reps, smi)
        return
    trees = {"parent": os.path.abspath(args.parent), "change": here}
    runs = {"parent": [], "change": []}
    for _ in range(args.rounds):
        for name in ("parent", "change", "change", "parent"):
            rows = times_of(trees[name])
            runs[name].append(rows)
            for row, r in rows.items():
                extra = "".join(f", {k} {r[k] * 1e3:.2f} us" for k in ("plain_ms", "library_ms", "bound_ms")
                                if r.get(k) is not None)
                print(f"[fused_mlp_ab] {name}: {row}: {r['us'] if 'us' in r else r['ms'] * 1e3:.2f} us{extra}")

    def value(r):
        return r.get("us", r.get("ms"))

    ratio = {row: sum(value(r[row]) for r in runs["change"]) / sum(value(r[row]) for r in runs["parent"])
             for row in runs["parent"][0]}
    print(json.dumps({"device": smi, "parent": runs["parent"], "change": runs["change"], "change_over_parent": ratio}))


if __name__ == "__main__":
    main()
