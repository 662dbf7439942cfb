"""CLI launcher: python -m rl_games_tpu_torch --train --file cfg.yaml [...]

Port of rl_games_tpu/__main__.py (the reference's runner.py:16-76 argument
surface: --train/--play/--file/--checkpoint/--seed/--num_actors/--sigma/
--track/--profile), plus ``--device``: the run goes to the CUDA card unless
another device is named.
"""

import argparse
import os


def _profiled(run, config, device):
    """``run()`` under torch.profiler; writes a chrome trace into the
    experiment directory and prints the device time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device or "cuda").type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        result = run()
    cfg = config["params"]["config"]
    trace_dir = os.path.join(cfg.get("train_dir", "runs"), cfg.get("name", "run"))
    os.makedirs(trace_dir, exist_ok=True)
    trace = os.path.join(trace_dir, "torch_profile.json")
    prof.export_chrome_trace(trace)
    sort_by = "self_cuda_time_total" if len(activities) == 2 else "self_cpu_time_total"
    print(prof.key_averages().table(sort_by=sort_by, row_limit=25))
    print(f"profiler trace written to {trace}")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m rl_games_tpu_torch")
    ap.add_argument("--seed", type=int, default=0, help="random seed override")
    ap.add_argument("-tf", "--tf", action="store_true", help="(ignored; parity)")
    ap.add_argument("-t", "--train", action="store_true")
    ap.add_argument("-p", "--play", action="store_true")
    ap.add_argument("-c", "--checkpoint", type=str, default=None)
    ap.add_argument("-f", "--file", type=str, required=True, help="yaml config")
    ap.add_argument("-na", "--num_actors", type=int, default=0)
    ap.add_argument("--sigma", type=float, default=None)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card; 'cpu' must be asked for)")
    ap.add_argument("--seeds", type=str, default=None,
                    help="multi-seed training: comma- or space-separated seeds, trained in one process")
    ap.add_argument("--track", action="store_true", help="wandb tracking")
    ap.add_argument("--wandb-project-name", type=str, default="rl_games_tpu_torch")
    ap.add_argument("--wandb-entity", type=str, default=None)
    ap.add_argument("--profile", action="store_true",
                    help="capture a torch.profiler trace of the run")
    ap.add_argument("--export", action="store_true", help="policy export (not ported yet)")
    ap.add_argument("--export-path", type=str, default=None)
    args = vars(ap.parse_args(argv))

    import yaml

    with open(args["file"]) as f:
        config = yaml.safe_load(f)

    if args["num_actors"] > 0:
        config["params"]["config"]["num_actors"] = args["num_actors"]
    if args["seed"] > 0:
        config["params"]["seed"] = args["seed"]
        # seed fans out to the env too (torch_runner.py:196-208)
        config["params"]["config"].setdefault("env_config", {})["seed"] = args["seed"]

    from rl_games_tpu_torch.runner import Runner

    runner = Runner(device=args["device"])
    runner.load(config)

    # wandb tracking mirrors runner.py:62-71 (sync_tensorboard so the TB
    # scalar families stream through); the package is optional
    wandb_run = None
    if args["track"]:
        try:
            import wandb

            wandb_run = wandb.init(
                project=args["wandb_project_name"],
                entity=args["wandb_entity"],
                sync_tensorboard=True,
                config=config,
                monitor_gym=True,
                save_code=True,
            )
        except ImportError:
            print("--track requested but wandb is not installed; continuing "
                  "with TensorBoard only")

    if args["profile"]:
        result = _profiled(lambda: runner.run(args), config, args["device"])
    else:
        result = runner.run(args)

    if wandb_run is not None:
        wandb_run.finish()
    return result


if __name__ == "__main__":
    main()
