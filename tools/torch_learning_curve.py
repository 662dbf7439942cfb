"""Train one config through the port's CLI, then play its best checkpoint.

    python3 tools/torch_learning_curve.py rl_games_tpu/configs/ppo_ant3d.yaml
    python3 tools/torch_learning_curve.py rl_games_tpu/configs/ppo_humanoid3d.yaml --max-epochs 400
    python3 tools/torch_learning_curve.py rl_games_tpu/configs/ppo_ant3d.yaml --seed 11
    python3 tools/torch_learning_curve.py rl_games_tpu/configs/sac_ant2d.yaml --max-epochs 2000
    python3 tools/torch_learning_curve.py rl_games_tpu/configs/sac_pendulum.yaml --max-epochs 1000 --vecenv-type CPUENV
    python3 tools/torch_learning_curve.py rl_games_tpu/configs/ref/mujoco/halfcheetah.yaml --max-epochs 100 --device cpu
    python3 tools/torch_learning_curve.py rl_games_tpu/configs/ref/test/test_discrete.yaml --max-epochs 1500 --stop-at-score
    python3 tools/torch_learning_curve.py rl_games_tpu/configs/ref/ppo_pendulum.yaml --max-epochs 500 --vecenv-type DEVICE
    python3 tools/torch_learning_curve.py rl_games_tpu/configs/ref/test/test_discrete.yaml --max-epochs 300 --framework jax

Runs ``python3 -m rl_games_tpu_torch --train --file <config>`` (on the CUDA
card: the CLI's default device), then ``--play -c <best checkpoint>``. The
config is read in place; with --max-epochs, --seed or --vecenv-type a copy
with those fields changed is written to --out first (with --seed, also its
own train_dir, runs/seed<N>, so that runs of two seeds keep their own best
checkpoint; --vecenv-type DEVICE drops the config's vecenv_type, for the
device env of the same name). ``--device cpu`` runs both on the CPU (the
CLI's --device); its times are the host's. Prints the card's name and
power limit, the mean reward at epochs 100, 300, 500, 1000, 2000 and 5000
(those reached) and at the last epoch, and for an env that reports scores
(the test envs) the first epoch whose mean score reaches the config's
score_to_win (``--stop-at-score`` ends the training there: the port's train
loop compares score_to_win with the mean reward); the training's wall time,
and the play score; the CLI's whole
output goes to <out>/<name>.train.log and <name>.play.log.

``--framework jax`` trains the same config with the JAX package instead, in
this process on the CPU (JAX_PLATFORMS=cpu), through its Runner with an
observer that prints each epoch's line in the port's form (with the score);
it plays nothing and reports no time.
"""

import argparse
import os
import re
import subprocess
import sys
import time

import yaml

# PPO prints "epoch: N/M frames: F rew: R[ score: S]", SAC "epoch: N frames: F rew: R"
EPOCH_LINE = re.compile(r"epoch: (\d+)(?:/\d+)? frames: (\d+)(?: rew: (-?[\d.]+|nan))?(?: score: (-?[\d.]+))?")
MARKS = (100, 300, 500, 1000, 2000, 5000)


def train_jax(config: dict, log_path: str):
    """The JAX package's Runner on the CPU, one line an epoch in the port's
    form, into ``log_path``."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from rl_games_tpu.runner import Runner
    from rl_games_tpu.utils.observers import AlgoObserver

    class EpochLines(AlgoObserver):
        def __init__(self, log):
            self.log, self.metrics = log, None

        def after_epoch(self, metrics):
            self.metrics = metrics

        def after_print_stats(self, frame, epoch_num, total_time):
            m = self.metrics
            line = f"epoch: {epoch_num} frames: {frame}"
            if int(m["games_played"]):
                line += f" rew: {float(m['mean_rewards'][0]):.2f}"
                if "mean_scores" in m:
                    line += f" score: {float(m['mean_scores']):.3f}"
            self.log.write(line + "\n")
            self.log.flush()

    with open(log_path, "w") as log:
        runner = Runner(algo_observer=EpochLines(log))
        runner.load(config)
        runner.run({"train": True})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("config")
    ap.add_argument("--max-epochs", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None, help="the config's seed unless given")
    ap.add_argument("--vecenv-type", default=None,
                    help="the config's vecenv_type unless given (e.g. CPUENV; DEVICE drops it)")
    ap.add_argument("--device", default=None, help="the CLI's --device (default: the CUDA card)")
    ap.add_argument("--framework", choices=("torch", "jax"), default="torch")
    ap.add_argument("--stop-at-score", action="store_true",
                    help="end the port's training at the first epoch whose mean score reaches score_to_win")
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
    if args.vecenv_type == "DEVICE":
        cfg.pop("vecenv_type", None)
        stem += ".DEVICE"
    elif args.vecenv_type is not None:
        cfg["vecenv_type"] = args.vecenv_type
        stem += f".{args.vecenv_type}"
    if args.framework == "jax":
        stem += ".jax"
        cfg["train_dir"] = os.path.join(args.out, "runs")
    if args.max_epochs is not None or args.seed is not None or args.vecenv_type is not None:
        path = os.path.join(args.out, stem + ".yaml")
        with open(path, "w") as f:
            yaml.safe_dump(config, f)
    if args.device == "cpu" or args.framework == "jax":
        print("[device] cpu: every time below is the host's, not a device's")
    else:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip()
        print(f"[device] {smi}")

    cli = [sys.executable, "-m", "rl_games_tpu_torch", "--file", path]
    if args.device is not None:
        cli += ["--device", args.device]
    t0 = time.perf_counter()
    log_path = os.path.join(args.out, stem + ".train.log")
    if args.framework == "jax":
        train_jax(config, log_path)
    else:
        target = cfg.get("score_to_win") if args.stop_at_score else None
        with open(log_path, "w") as log:
            proc = subprocess.Popen(cli + ["--train"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                    env={**os.environ, "PYTHONUNBUFFERED": "1"})
            stopped = False
            for line in proc.stdout:
                log.write(line)
                m = EPOCH_LINE.search(line)
                if target is not None and m and m.group(4) is not None and float(m.group(4)) >= target:
                    proc.terminate()
                    stopped = True
                    break
            proc.stdout.close()
            if proc.wait() != 0 and not stopped:
                raise subprocess.CalledProcessError(proc.returncode, cli + ["--train"])
    train_s = time.perf_counter() - t0
    curve, scores = {}, {}
    with open(log_path) as log:
        for line in log:
            m = EPOCH_LINE.search(line)
            if m and m.group(3) is not None:
                curve[int(m.group(1))] = float(m.group(3))
            if m and m.group(4) is not None:
                scores[int(m.group(1))] = float(m.group(4))
    last = max(curve)
    marks = [e for e in MARKS if e in curve] + ([last] if last not in MARKS else [])
    print(f"[train] {stem}: {last} epochs" + (f" in {train_s:.1f} s" if args.framework == "torch" else "")
          + "; mean reward " + ", ".join(f"{curve[e]:.2f} at epoch {e}" for e in marks)
          + f"; best {max(curve.values()):.2f} at epoch {max(curve, key=curve.get)}")
    if scores:
        target = cfg.get("score_to_win")
        reached = [e for e in sorted(scores) if target is not None and scores[e] >= target]
        print(f"[train] {stem}: mean score " + ", ".join(f"{scores[e]:.3f} at epoch {e}" for e in marks if e in scores)
              + (f"; first reaches score_to_win {target} at epoch {reached[0]}" if reached
                 else f"; never reaches score_to_win {target}")
              + f"; best {max(scores.values()):.3f} at epoch {max(scores, key=scores.get)}")
    if args.framework == "jax":
        return

    name = cfg["name"]
    best = os.path.join(cfg.get("train_dir", "runs"), name, "nn", name + ".pth")
    if not os.path.exists(best):  # stopped before save_best_after
        print(f"[play] no best checkpoint: the training ended before epoch {cfg.get('save_best_after', 100)}")
        return
    t0 = time.perf_counter()
    play = subprocess.run(cli + ["--play", "-c", best], capture_output=True, text=True, check=True)
    with open(os.path.join(args.out, stem + ".play.log"), "w") as log:
        log.write(play.stdout + play.stderr)
    score = re.search(r"av reward: (-?[\d.]+) games played: (\d+)", play.stdout)
    print(f"[play] {best}: av reward {score.group(1)} over {score.group(2)} games "
          f"in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
