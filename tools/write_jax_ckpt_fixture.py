"""Write the JAX package's checkpoint that the port's tests and chip_smoke.py read.

    JAX_PLATFORMS=cpu python3 tools/write_jax_ckpt_fixture.py [--out tests/data/jax_ppo_cartpole_fused.ckpt]

Trains rl_games_tpu/configs/ppo_cartpole.yaml with network.mlp.fused: true
through the JAX package's Runner for 2 epochs (16 envs x 32 steps, the
config's own widths and seed) on the CPU and copies the run's last
checkpoint (``last_cartpole_ppo_ep_2_rew_*.ckpt``) to ``--out``. The file is
committed: the card's machine has no JAX, so chip_smoke.py's ``[jax_ckpt]``
phase restores, plays, resumes and exports this file there. This tool
imports the JAX package; the port never does.
"""

import argparse
import glob
import os
import shutil
import sys
import tempfile

import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "tests", "data", "jax_ppo_cartpole_fused.ckpt")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=DEFAULT_OUT)
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    from rl_games_tpu.runner import Runner

    with open(os.path.join(ROOT, "rl_games_tpu", "configs", "ppo_cartpole.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["params"]["network"]["mlp"]["fused"] = True
    with tempfile.TemporaryDirectory() as train_dir:
        cfg["params"]["config"].update(train_dir=train_dir, max_epochs=2, print_stats=False)
        runner = Runner()
        runner.load(cfg)
        runner.run({"train": True})
        name = cfg["params"]["config"]["name"]
        (last,) = glob.glob(os.path.join(train_dir, name, "nn", f"last_{name}_ep_2_rew_*.ckpt"))
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        shutil.copyfile(last, args.out)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes) from {os.path.basename(last)}")


if __name__ == "__main__":
    main()
