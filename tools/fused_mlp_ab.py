"""The fused MLP's kernel at the flagship's torso, this tree against another
(a parent commit unpacked with ``git archive``), in turns on one card.

    python3 tools/fused_mlp_ab.py PARENT_DIR [--rounds 1]

Each round runs four processes, one after another: PARENT_DIR, this tree,
this tree, PARENT_DIR. Each builds its own tree's kernels (its
``build/kernels``) and prints ``chip_smoke.time_fused``'s device time of
26->256->128->64 elu (``fused_mlp_cuda`` against the plain chain in turns,
torch.profiler) at B = 8192 and 32768. Both trees need ``chip_smoke.py``
with ``time_fused`` and ``FLAGSHIP_DIMS``. Prints a line per
process, then one JSON object with each tree's times in run order and the
change's mean over the parent's.
"""

import argparse
import json
import os
import subprocess
import sys

BATCHES = (8192, 32768)
PROBE = (
    "import json, torch, chip_smoke as c\n"
    "from rl_games_tpu_torch.utils import cuda_build\n"
    "cuda_build.build_all()\n"
    "gen = torch.Generator(device='cuda').manual_seed(1)\n"
    "rows = [c.time_fused(c.FLAGSHIP_DIMS, b, gen, torch.device('cuda')) for b in %r]\n"
    "print('AB ' + json.dumps([r['ms'] for r in rows]))\n" % (BATCHES,)
)


def times_of(tree: str):
    """(kernel ms at each of BATCHES) from one process in ``tree``."""
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=tree, capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"{tree}: exited {out.returncode}\n{out.stdout[-4000:]}\n{out.stderr[-4000:]}")
    line = next(line for line in out.stdout.splitlines() if line.startswith("AB "))
    return json.loads(line[3:])


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("parent")
    parser.add_argument("--rounds", type=int, default=1)
    args = parser.parse_args()
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trees = {"parent": os.path.abspath(args.parent), "change": here}
    runs = {"parent": [], "change": []}
    for _ in range(args.rounds):
        for name in ("parent", "change", "change", "parent"):
            ms = times_of(trees[name])
            runs[name].append(ms)
            print(f"[fused_mlp_ab] {name}: " + ", ".join(f"B={b} {t * 1e3:.2f} us" for b, t in zip(BATCHES, ms)))
    ratio = {b: (sum(r[i] for r in runs["change"]) / sum(r[i] for r in runs["parent"])) for i, b in enumerate(BATCHES)}
    print(json.dumps({"batches": BATCHES, "parent_ms": runs["parent"], "change_ms": runs["change"],
                      "change_over_parent": ratio}))


if __name__ == "__main__":
    main()
