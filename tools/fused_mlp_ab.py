"""The fused MLP's kernel, this tree against another (a parent commit
unpacked with ``git archive``), in turns on one card; or, with ``--sweep``,
this tree's streamed kernel over every shape it takes.

    python3 tools/fused_mlp_ab.py PARENT_DIR [--rounds 1]
    python3 tools/fused_mlp_ab.py --sweep [--reps 20]

Each round runs four processes, one after another: PARENT_DIR, this tree,
this tree, PARENT_DIR. Each builds its own tree's kernels (its
``build/kernels``) and prints the device time of:

- the flagship torso 26->256->128->64 elu at B = 8192 and 32768
  (``chip_smoke.time_fused``: ``fused_mlp_cuda`` against the plain chain in
  turns, torch.profiler);
- the chains with a streamed first layer that ``chip_smoke.kernel_fused_mlp_wide``
  times (``chip_smoke.time_wide``, the same way, with ``torch.addmm`` of a
  one-layer chain and the bound beside): the nature-CNN torso 3136->512 at
  the Pong rollout's B = 512, the minibatch's 4096 and a ragged 4099; 3134 and
  3135 inputs at B = 512; (64, 4096, 4096, 8) at B = 1024; the grouped
  3136->512->64 at G = 4, B = 256 with the 3136-wide weight shared;
- the host time of one ``fused_mlp_cuda`` call at 3136->512, B = 512
  (``chip_smoke.host_us_per_call``).

Both trees need ``chip_smoke.py`` with ``time_fused``, ``time_wide``,
``mlp_inputs``, ``grouped_inputs`` and ``host_us_per_call``. Prints a line
per process and row, then one JSON object with each tree's numbers in run
order and the change's mean over the parent's for each row.

``--sweep`` runs in this process: for 3136 -> 512 elu at B = 512, 1024 and
4096 and 4096 -> 4096 at B = 1024, it launches the streamed kernel
(csrc/fused_mlp.cu ``fused_mlp_stream_kernel``) at every rows a block (16,
32, 64), split of the output tiles and cluster that the kernel takes, checks
each result against the plain chain (rtol = atol = 1e-4), and prints the time
a call between CUDA events (after a warm-up, ``--reps`` calls) beside the
cost in the model that ``ops/fused_mlp.stream_plan`` picks from (waves times
output tiles a block times rows over ``STREAM_RATE``) and ``addmm``'s time.
Then the clusters of each size that the card holds at once
(``cudaOccupancyMaxActiveClusters``), which ``STREAM_WAVE_BLOCKS`` records.
The shape that the plan picks is marked. Ends with one JSON object of the
rows.
"""

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys

FLAGSHIP_BATCHES = (8192, 32768)
SWEEP_CASES = (((3136, 512), 512), ((3136, 512), 1024), ((3136, 512), 4096), ((4096, 4096), 1024))
PROBE = (
    "import json, torch, chip_smoke as c\n"
    "from rl_games_tpu_torch.ops import fused_mlp as fm\n"
    "from rl_games_tpu_torch.utils import cuda_build\n"
    "cuda_build.build_all()\n"
    "dev = torch.device('cuda')\n"
    "gen = torch.Generator(device=dev).manual_seed(1)\n"
    "rows = {f'26x256x128x64 B={b}': {'ms': c.time_fused(c.FLAGSHIP_DIMS, b, gen, dev)['ms']} for b in %r}\n"
    "def wide(name, x, ws, bs):\n"
    "    r = c.time_wide(name, x, ws, bs)\n"
    "    rows[name] = {k: r[k] for k in ('ms', 'plain_ms', 'library_ms', 'bound_ms')}\n"
    "for batch in (512, 4096, 4099):\n"
    "    wide(f'3136x512 B={batch}', *c.mlp_inputs((3136, 512), batch, gen, dev))\n"
    "for k in (3134, 3135):\n"
    "    wide(f'{k}x512 B=512', *c.mlp_inputs((k, 512), 512, gen, dev))\n"
    "wide('64x4096x4096x8 B=1024', *c.mlp_inputs((64, 4096, 4096, 8), 1024, gen, dev))\n"
    "x, ws, bs = c.grouped_inputs((3136, 512, 64), 4, 256, gen, dev)\n"
    "wide('grouped 3136x512x64 G=4 B=256', x, [ws[0][0], ws[1]], bs)\n"
    "x, ws, bs = c.mlp_inputs((3136, 512), 512, gen, dev)\n"
    "rows['host time a call, 3136x512 B=512'] = {'us': c.host_us_per_call(lambda: fm.fused_mlp_cuda(x, ws, bs, 'elu'))}\n"
    "print('AB ' + json.dumps(rows))\n" % (FLAGSHIP_BATCHES,)
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


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("parent", nargs="?")
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--sweep", action="store_true")
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    if args.sweep == (args.parent is not None):
        parser.error("give PARENT_DIR or --sweep")
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[fused_mlp_ab] {smi}")
    if args.sweep:
        sys.path.insert(0, here)
        return sweep(args.reps, smi)
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
