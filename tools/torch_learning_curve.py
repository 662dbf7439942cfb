"""Train one config through the port's CLI, then play its best checkpoint.

    python3 tools/torch_learning_curve.py rl_games_tpu/configs/ppo_ant3d.yaml
    python3 tools/torch_learning_curve.py rl_games_tpu/configs/ppo_humanoid3d.yaml --max-epochs 400
    python3 tools/torch_learning_curve.py rl_games_tpu/configs/ppo_ant3d.yaml --seed 11
    python3 tools/torch_learning_curve.py rl_games_tpu/configs/sac_ant2d.yaml --max-epochs 2000
    python3 tools/torch_learning_curve.py rl_games_tpu/configs/sac_pendulum.yaml --max-epochs 1000 --vecenv-type CPUENV
    python3 tools/torch_learning_curve.py rl_games_tpu/configs/ref/mujoco/halfcheetah.yaml --max-epochs 100 --device cpu

Runs ``python3 -m rl_games_tpu_torch --train --file <config>`` (on the CUDA
card: the CLI's default device), then ``--play -c <best checkpoint>``. The
config is read in place; with --max-epochs, --seed or --vecenv-type a copy
with those fields changed is written to --out first (with --seed, also its
own train_dir, runs/seed<N>, so that runs of two seeds keep their own best
checkpoint). ``--device cpu`` runs both on the CPU (the CLI's --device); its
times are the host's. Prints the card's name and power limit,
the mean reward at epochs 100, 300, 500, 1000, 2000 and 5000 (those
reached) and at the last epoch, the training's wall time, and the play score; the CLI's whole
output goes to <out>/<name>.train.log and <name>.play.log.
"""

import argparse
import os
import re
import subprocess
import sys
import time

import yaml

# PPO prints "epoch: N/M frames: F rew: R", SAC "epoch: N frames: F rew: R"
EPOCH_LINE = re.compile(r"epoch: (\d+)(?:/\d+)? frames: (\d+)(?: rew: (-?[\d.]+))?")
MARKS = (100, 300, 500, 1000, 2000, 5000)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("config")
    ap.add_argument("--max-epochs", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None, help="the config's seed unless given")
    ap.add_argument("--vecenv-type", default=None, help="the config's vecenv_type unless given (e.g. CPUENV)")
    ap.add_argument("--device", default=None, help="the CLI's --device (default: the CUDA card)")
    ap.add_argument("--out", default="runs/learning")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    with open(args.config) as f:
        config = yaml.safe_load(f)
    cfg = config["params"]["config"]
    stem = os.path.splitext(os.path.basename(args.config))[0]
    path = args.config
    if args.max_epochs is not None:
        cfg["max_epochs"] = args.max_epochs
    if args.seed is not None:
        config["params"]["seed"] = args.seed
        cfg["train_dir"] = os.path.join("runs", f"seed{args.seed}")
        stem += f".seed{args.seed}"
    if args.vecenv_type is not None:
        cfg["vecenv_type"] = args.vecenv_type
        stem += f".{args.vecenv_type}"
    if args.max_epochs is not None or args.seed is not None or args.vecenv_type is not None:
        path = os.path.join(args.out, stem + ".yaml")
        with open(path, "w") as f:
            yaml.safe_dump(config, f)
    if args.device == "cpu":
        print("[device] cpu: every time below is the host's, not a device's")
    else:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip()
        print(f"[device] {smi}")

    cli = [sys.executable, "-m", "rl_games_tpu_torch", "--file", path]
    if args.device is not None:
        cli += ["--device", args.device]
    t0 = time.perf_counter()
    with open(os.path.join(args.out, stem + ".train.log"), "w") as log:
        subprocess.run(cli + ["--train"], stdout=log, stderr=subprocess.STDOUT, check=True)
    train_s = time.perf_counter() - t0
    curve = {}
    with open(os.path.join(args.out, stem + ".train.log")) as log:
        for line in log:
            m = EPOCH_LINE.search(line)
            if m and m.group(3) is not None:
                curve[int(m.group(1))] = float(m.group(3))
    last = max(curve)
    marks = [e for e in MARKS if e in curve] + ([last] if last not in MARKS else [])
    print(f"[train] {stem}: {last} epochs in {train_s:.1f} s; mean reward "
          + ", ".join(f"{curve[e]:.2f} at epoch {e}" for e in marks)
          + f"; best {max(curve.values()):.2f} at epoch {max(curve, key=curve.get)}")

    name = cfg["name"]
    best = os.path.join(cfg.get("train_dir", "runs"), name, "nn", name + ".pth")
    t0 = time.perf_counter()
    play = subprocess.run(cli + ["--play", "-c", best], capture_output=True, text=True, check=True)
    with open(os.path.join(args.out, stem + ".play.log"), "w") as log:
        log.write(play.stdout + play.stderr)
    score = re.search(r"av reward: (-?[\d.]+) games played: (\d+)", play.stdout)
    print(f"[play] {best}: av reward {score.group(1)} over {score.group(2)} games "
          f"in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
