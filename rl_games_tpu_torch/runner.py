"""Runner: config loading, algo/player factories, seeding, orchestration.

Port of rl_games_tpu/runner.py (the reference's torch_runner.py Runner,
:98-354). Same public API: ``Runner().load(yaml_dict)``,
``.run({'train': True, ...})``, ``.create_player()``; same YAML schema
(params.algo.name / model / network / config). ``Runner(algo_observer,
device=None)`` hands the observer to the agent (``config.features.observer``;
``config.algo_observer: isaac`` or any other true value picks one when none
is given) and its device to the agent and the player: CUDA by default,
which raises without a card; the CPU only when asked for. A config's
``import_modules`` that name a module of the JAX package import the port's
module of the same path (``import_user_module``).
"""

import copy
import importlib
import importlib.util
import random
from typing import Any, Dict

import numpy as np
import torch

from rl_games_tpu_torch.common.object_factory import ObjectFactory
from rl_games_tpu_torch.utils.unported import unported


def _build_ppo(**kwargs):
    from rl_games_tpu_torch.algos.ppo import PPOAgent

    return PPOAgent(**kwargs)


def _build_sac(**kwargs):
    from rl_games_tpu_torch.algos.sac import SACAgent

    return SACAgent(**kwargs)


def _build_ppo_player(**kwargs):
    from rl_games_tpu_torch.common.player import PpoPlayer

    return PpoPlayer(**kwargs)


def _build_sac_player(**kwargs):
    from rl_games_tpu_torch.common.player import SACPlayer

    return SACPlayer(**kwargs)


def _resolve_stop_fn(stop_fn):
    """Accept a callable or a 'pkg.mod:fn' / 'pkg.mod.fn' import path
    (torch_runner.py:63-80)."""
    if stop_fn is None or callable(stop_fn):
        return stop_fn
    if not isinstance(stop_fn, str):
        raise ValueError(
            "'stop_fn' must be callable or 'module:function' string, got "
            f"{type(stop_fn).__name__}"
        )
    if ":" in stop_fn:
        module_path, attr = stop_fn.split(":", 1)
    else:
        module_path, _, attr = stop_fn.rpartition(".")
        if not module_path:
            raise ValueError(
                f"'stop_fn' string must reference a module attribute: {stop_fn!r}"
            )
    fn = getattr(importlib.import_module(module_path), attr)
    if not callable(fn):
        raise ValueError(f"'stop_fn' resolved {stop_fn!r} is not callable")
    return fn


# the JAX package's modules that a config may name in import_modules and
# whose port is still to come, with the ROADMAP.md item that ports each
# (none: both that shipped configs name, test_network and connect4_network,
# have their ports)
UNPORTED_MODULES = {}


def import_user_module(module: str):
    """Import a config's ``import_modules`` entry. A module of the JAX
    package (``rl_games_tpu.x.y``) is the port's module of the same path
    (``rl_games_tpu_torch.x.y``), so the registrations land in the port's
    registries and the JAX package is never imported; one the port has no
    counterpart of yet is refused naming its ROADMAP.md item. Any other
    name is imported as given (runner.py:135-136)."""
    if module != "rl_games_tpu" and not module.startswith("rl_games_tpu."):
        return importlib.import_module(module)
    if module in UNPORTED_MODULES:
        unported(*UNPORTED_MODULES[module])
    target = "rl_games_tpu_torch" + module[len("rl_games_tpu"):]
    if importlib.util.find_spec(target) is None:
        raise ModuleNotFoundError(f"import_modules names {module}, which has no counterpart {target} in the port")
    return importlib.import_module(target)


class Runner:
    def __init__(self, algo_observer=None, device=None):
        self.algo_factory = ObjectFactory()
        # torch_runner.py:117-127
        self.algo_factory.register_builder("a2c_continuous", _build_ppo)
        self.algo_factory.register_builder("a2c_discrete", _build_ppo)
        self.algo_factory.register_builder("sac", _build_sac)

        self.player_factory = ObjectFactory()
        self.player_factory.register_builder("a2c_continuous", _build_ppo_player)
        self.player_factory.register_builder("a2c_discrete", _build_ppo_player)
        self.player_factory.register_builder("sac", _build_sac_player)

        self.algo_observer = algo_observer
        self.device = device
        self.params = None

    # -- config ------------------------------------------------------------
    def load(self, yaml_config: Dict[str, Any]):
        config = copy.deepcopy(yaml_config)
        self.default_config = config["params"]
        self.load_config(copy.deepcopy(self.default_config))

    def load_config(self, params: Dict[str, Any]):
        """torch_runner.py:143-226 (seed fan-out, user modules)."""
        self.seed = params.get("seed", None)
        if self.seed is None:
            self.seed = int(np.random.randint(0, 2**16))
        if self.seed == -1:
            self.seed = int(np.random.randint(0, 1000000))
        random.seed(self.seed)
        np.random.seed(self.seed)
        params["config"]["seed"] = self.seed

        self.algo_name = params["algo"]["name"]
        config = params["config"]
        # config-selectable observer (torch_runner.py:163-167)
        if self.algo_observer is None and config.get("algo_observer"):
            from rl_games_tpu_torch.utils.observers import DefaultAlgoObserver, IsaacAlgoObserver

            self.algo_observer = (
                IsaacAlgoObserver() if config["algo_observer"] == "isaac" else DefaultAlgoObserver()
            )
        # user modules imported for their registration side effects —
        # custom networks / env plugins (torch_runner.py:152-155)
        for module in config.get("import_modules", []) or []:
            import_user_module(module)
        config["reward_shaper"] = config.get("reward_shaper", {})
        config.setdefault("features", {})["observer"] = self.algo_observer
        self.params = params

    # -- runs ----------------------------------------------------------------
    def create_agent(self):
        return self.algo_factory.create(
            self.algo_name, base_name="run", params=self.params, device=self.device,
        )

    def run_train(self, args: Dict[str, Any]):
        """torch_runner.py:233-321."""
        if args.get("seeds"):
            return self.run_train_multiseed(args)
        print("Started to train")
        agent = self.create_agent()
        # stop_fn: programmatic args win over YAML config (torch_runner.py
        # _apply_stop_fn :83-95); strings resolve to import paths
        stop_fn = _resolve_stop_fn(
            args.get("stop_fn") or self.params["config"].get("stop_fn")
        )
        kwargs = {}
        if self.algo_name != "sac":
            if args.get("sigma") is not None:
                kwargs["sigma"] = args["sigma"]
            if args.get("load_critic_only"):
                kwargs["load_critic_only"] = True
        return agent.train(checkpoint=args.get("checkpoint"), stop_fn=stop_fn, **kwargs)

    def run_train_multiseed(self, args: Dict[str, Any]):
        """``--seeds a,b,c``: train every seed in this one process
        (utils/multiseed.py; runner.py:176-305 of the JAX package). Device
        envs only; PPO and SAC. With a ``pbt`` block a PPO population
        exploits and explores every ``interval_steps`` frames
        (``PopulationTrainer``). Prints one curve line per log_interval and
        writes a single-seed checkpoint per member at the end,
        ``<name>_seed<s>.pth`` in ``nn/``, which the player restores
        unchanged. Returns their paths; the trainer and the members' last
        states stay in ``self.trainer`` and ``self.last_states``."""
        import os
        import time

        from rl_games_tpu_torch.algos.ppo import _to_host  # metrics, nested dicts of tensors, as numpy
        from rl_games_tpu_torch.utils.multiseed import MultiSeedTrainer, PopulationTrainer
        from rl_games_tpu_torch.utils.pbt import PbtCfg

        seeds = args["seeds"]
        if isinstance(seeds, str):
            seeds = [int(s) for s in seeds.replace(",", " ").split()]
        if args.get("checkpoint"):
            raise ValueError(
                "--seeds starts every member from its own seeded init; "
                "resuming a population from a single checkpoint is "
                "ambiguous — drop -c, or warm-start one seed per process "
                "with the single-seed path"
            )
        if args.get("sigma") is not None:
            raise ValueError("--sigma is not supported with --seeds")
        print(f"Started to train {len(seeds)} seeds in one process: {seeds}")
        agent = self.create_agent()
        config = self.params["config"]
        pbt_interval_epochs = 0
        if config.get("pbt") and self.algo_name == "sac":
            print(
                "pbt block ignored: on-device PBT mutates TrainState "
                "hyperparameters of the PPO family; SAC seeds train as a "
                "plain multi-seed stack"
            )
        if config.get("pbt") and self.algo_name != "sac":
            pcfg = PbtCfg.from_dict(dict(config["pbt"]))
            trainer = PopulationTrainer(
                agent, seeds, threshold_std=pcfg.threshold_std, threshold_abs=pcfg.threshold_abs,
                mutation_rate=pcfg.mutation_rate, change_range=pcfg.change_range,
            )
            pbt_interval_epochs = max(1, pcfg.interval_steps // trainer.frames_per_epoch())
            print(f"on-device PBT: band exploit every {pbt_interval_epochs} epochs over the "
                  f"{len(seeds)}-member population")
        else:
            trainer = MultiSeedTrainer(agent, seeds)
        del agent  # the members are agents of their own
        states = trainer.init_state()
        fn = trainer.train_fn()

        name = config.get("name", "run")
        # programmatic args win over YAML
        max_epochs = int(args.get("max_epochs") or config.get("max_epochs", 0) or 0)
        if not max_epochs:
            # SAC configs bound runs by frames (sac_agent.py max_frames)
            max_frames = int(config.get("max_frames", 0))
            max_epochs = max(1, max_frames // trainer.frames_per_epoch()) if max_frames else 1000
        log_interval = int(config.get("log_interval", 10))
        frames_per_epoch = trainer.frames_per_epoch() * len(seeds)
        nn_dir = os.path.join(config.get("train_dir", "runs"), name, "nn")
        os.makedirs(nn_dir, exist_ok=True)

        start = time.perf_counter()
        for epoch in range(1, max_epochs + 1):
            states, metrics = fn(states)
            m = None
            if pbt_interval_epochs and epoch % pbt_interval_epochs == 0:
                m = _to_host(metrics)
                states, events = trainer.pbt_step(states, m)
                for ev in events:
                    print(f"pbt: seed{ev['dst']} adopts seed{ev['src']} (lr={ev['lr']:.2e} "
                          f"entropy_coef={ev['entropy_coef']:.4f})", flush=True)
            if epoch % log_interval == 0 or epoch == max_epochs:
                m = _to_host(metrics) if m is None else m
                fps = frames_per_epoch * epoch / (time.perf_counter() - start)
                played = m.get("games_played")
                rews = " ".join(
                    f"seed{s}: {float(m['mean_rewards'][i][0]):.2f}"
                    if played is None or int(played[i]) > 0 else f"seed{s}: n/a"
                    for i, s in enumerate(seeds)
                )
                print(f"fps total: {fps:.0f} epoch: {epoch}/{max_epochs} "
                      f"frames: {frames_per_epoch * epoch} {rews}", flush=True)
        paths = []
        for i, s in enumerate(seeds):
            path = os.path.join(nn_dir, f"{name}_seed{s}.pth")
            reward = float(m["mean_rewards"][i][0])
            meta = {"epoch": max_epochs, "frame": trainer.frames_per_epoch() * max_epochs,
                    "last_mean_rewards": reward}
            member = trainer.agents[i]
            if self.algo_name == "sac":
                meta["has_replay"] = member.save_replay_buffer
            member._save(path, trainer.state_for_seed(states, i), meta)
            paths.append(path)
            print(f"seed {s}: reward {reward:.2f} -> {path}")
        self.trainer, self.last_states = trainer, states
        return paths

    def create_player(self):
        return self.player_factory.create(
            self.algo_name, params=self.params, device=self.device,
        )

    def run_play(self, args: Dict[str, Any]):
        """torch_runner.py:323-334."""
        print("Started to play")
        player = self.create_player()
        checkpoint = args.get("checkpoint")
        if checkpoint:
            player.restore(checkpoint)
        if args.get("sigma") is not None:
            player.override_sigma(args["sigma"])
        return player.run(**args.get("player", {}))

    def run_export(self, args: Dict[str, Any]):
        """--export (runner.py:323-356): the checkpoint's deterministic
        policy (obs -> env-space action, the normalizers and the action
        rescale inside it, a dynamic batch) through torch.export to a
        ``.pt2`` file (utils/export.py), ``<checkpoint>.pt2`` unless
        ``export_path`` names another; the JAX package writes
        ``.stablehlo``. Returns the path."""
        from rl_games_tpu_torch.utils.export import export_policy_fn

        checkpoint = args.get("checkpoint")
        if not checkpoint:
            raise ValueError("--export requires -c <checkpoint>: refusing to export a randomly initialized policy")
        player = self.create_player()
        player.restore(checkpoint)
        if isinstance(player.obs_shape, dict):
            raise ValueError("--export supports flat observation spaces; dict-obs policies need a custom "
                             "export module (utils/export.make_deterministic_policy_fn)")
        # a batch of 2: torch.export would fix a batch of 1 (utils/export.py)
        example_obs = torch.zeros((2, *player.obs_shape), dtype=torch.float32, device=player.device)
        path = args.get("export_path") or checkpoint + ".pt2"
        blob = export_policy_fn(player.make_export_policy(), example_obs)
        with open(path, "wb") as f:
            f.write(blob)
        print(f"exported policy to {path}")
        return path

    def run(self, args: Dict[str, Any]):
        if args.get("train"):
            return self.run_train(args)
        elif args.get("play"):
            return self.run_play(args)
        elif args.get("export"):
            return self.run_export(args)
        else:
            return self.run_train(args)

    def reset(self):
        pass
