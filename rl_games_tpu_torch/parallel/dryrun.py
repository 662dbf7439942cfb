"""A dry run of data parallelism: the port's counterpart of the JAX
package's ``__graft_entry__.dryrun_multichip``.

Five programs run one epoch over a world of ranks and over a single
process: the flagship continuous PPO, SAC, multi-seed PPO (whole members a
rank), the pixel CNN (discrete PPO on PixelCatcher) and an LSTM actor with
an LSTM central value net (test_asymmetric_env), each at the JAX dry run's
tiny shapes. ``run_world`` spawns one process a rank (gloo on the CPU;
NCCL on cards of their own) and returns each rank's result, which holds
the epochs' metrics and everything a rank ends with (weights, optimizer
state, meters), as CPU tensors, so that a caller can hold the world against
the single process. Everything runs on the CUDA card unless the caller
asks for another device.

    python -m rl_games_tpu_torch.parallel.dryrun --world 2 --device cpu

asserts finite losses and the frame count of each program, and that the
ranks end bit-equal.
"""

import argparse
import copy
import hashlib
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from rl_games_tpu_torch.parallel.mesh import create_mesh, initialize_multihost
from rl_games_tpu_torch.utils import checkpoint as ckpt
from rl_games_tpu_torch.utils.device import resolve_device


def flagship_params(num_actors: int = 16) -> dict:
    """The JAX dry run's flagship continuous PPO config
    (__graft_entry__._flagship_params): the device Pendulum, horizon 16,
    minibatch num_actors * 8, 2 mini-epochs."""
    return {
        "algo": {"name": "a2c_continuous"},
        "model": {"name": "continuous_a2c_logstd"},
        "network": {
            "name": "actor_critic", "separate": False,
            "mlp": {"units": [256, 128, 64], "activation": "elu", "initializer": {"name": "default"}},
            "space": {"continuous": {
                "mu_activation": "None", "sigma_activation": "None", "mu_init": {"name": "default"},
                "sigma_init": {"name": "const_initializer", "val": 0.0}, "fixed_sigma": True,
            }},
        },
        "config": {
            "env_name": "Pendulum-v1", "num_actors": num_actors, "horizon_length": 16,
            "minibatch_size": num_actors * 8, "mini_epochs": 2, "learning_rate": 3e-4,
            "lr_schedule": "adaptive", "kl_threshold": 0.008, "e_clip": 0.2, "clip_value": True,
            "gamma": 0.99, "tau": 0.95, "critic_coef": 2.0, "entropy_coef": 0.0, "grad_norm": 1.0,
            "truncate_grads": True, "normalize_advantage": True, "normalize_input": True,
            "normalize_value": True, "bounds_loss_coef": 0.0001, "value_bootstrap": True, "seed": 7,
        },
    }


def _ppo_common(num_actors: int, minibatch: int) -> dict:
    return {
        "num_actors": num_actors, "horizon_length": 8, "minibatch_size": minibatch, "mini_epochs": 2,
        "lr_schedule": "adaptive", "kl_threshold": 0.008, "e_clip": 0.2, "clip_value": True, "gamma": 0.99,
        "tau": 0.95, "critic_coef": 1.0, "entropy_coef": 0.01, "grad_norm": 1.0, "truncate_grads": True,
        "normalize_advantage": True, "normalize_input": True, "normalize_value": True, "value_bootstrap": True,
        "seed": 7,
    }


def program_params(program: str, world: int) -> dict:
    """Each program's config at the JAX dry run's sizes for ``world`` ranks."""
    small = {"units": [32, 32], "activation": "elu", "initializer": {"name": "default"}}
    if program in ("ppo", "multiseed"):
        params = flagship_params(2 * world if program == "ppo" else 4)
        params["config"]["minibatch_size"] = 2 * world * 8 if program == "ppo" else 32
        params["network"]["mlp"] = small
        return params
    if program == "sac":
        return {
            "algo": {"name": "sac"},
            "model": {"name": "soft_actor_critic"},
            "network": {"name": "soft_actor_critic", "separate": True, "space": {"continuous": None},
                        "mlp": {"units": [32, 32], "activation": "relu", "initializer": {"name": "default"}},
                        "log_std_bounds": [-5, 2]},
            "config": {
                "name": "dryrun_sac", "env_name": "Pendulum-v1", "num_actors": 2 * world,
                "num_steps_per_episode": 2, "batch_size": 4 * world, "replay_buffer_size": 64 * world,
                "num_warmup_steps": 0, "utd_ratio": 1.0, "gamma": 0.99, "init_alpha": 1.0, "alpha_lr": 3e-4,
                "actor_lr": 3e-4, "critic_lr": 3e-4, "critic_tau": 5e-3, "learnable_temperature": True,
                "normalize_input": True, "seed": 7, "print_stats": False,
            },
        }
    if program == "pixel":
        return {
            "algo": {"name": "a2c_discrete"},
            "model": {"name": "discrete_a2c"},
            "network": {
                "name": "actor_critic", "separate": False,
                "cnn": {"type": "conv2d", "activation": "elu", "initializer": {"name": "default"},
                        "convs": [{"filters": 8, "kernel_size": 4, "strides": 2, "padding": 0},
                                  {"filters": 16, "kernel_size": 3, "strides": 2, "padding": 0}]},
                "mlp": {"units": [32], "activation": "elu", "initializer": {"name": "default"}},
                "space": {"discrete": {}},
            },
            "config": {"env_name": "PixelCatcher-v0", "learning_rate": 1e-3,
                       **_ppo_common(2 * world, 2 * world * 4)},
        }
    if program == "rnn_cv":
        lstm = {"units": [32], "activation": "elu", "initializer": {"name": "default"}}
        return {
            "algo": {"name": "a2c_discrete"},
            "model": {"name": "discrete_a2c"},
            "network": {"name": "actor_critic", "separate": False, "mlp": lstm,
                        "rnn": {"name": "lstm", "units": 16, "layers": 1}, "space": {"discrete": {}}},
            "config": {
                "env_name": "test_asymmetric_env", "learning_rate": 3e-4, **_ppo_common(2 * world, 2 * world * 8),
                "central_value_config": {
                    "learning_rate": 5e-4, "mini_epochs": 2, "minibatch_size": 2 * world * 8, "clip_value": True,
                    "normalize_input": True, "truncate_grads": True, "grad_norm": 1.0,
                    "network": {"name": "actor_critic", "central_value": True, "mlp": lstm,
                                "rnn": {"name": "lstm", "units": 16, "layers": 1}},
                },
            },
        }
    raise ValueError(f"no dry-run program {program!r}")


def _plain(x):
    return ckpt.tree_to_plain(x)


def _digest(state_dicts) -> str:
    """A hash of every tensor's bytes in ``state_dicts``, in order."""
    h = hashlib.sha256()
    for sd in state_dicts:
        for v in sd.values():
            h.update(v.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def full_state(agent, state) -> dict:
    """Everything of a PPO or SAC train state and the agent's weights as CPU
    tensors, a data-parallel rank's rows gathered from every rank (a
    collective): the single process's state at this point."""
    world = agent._world_state(state)
    if hasattr(agent, "critic"):  # SAC: its get_full_state_weights may leave the replay out
        return {"state": ckpt.tree_to_plain(world), "weights": agent.get_weights(world)}
    return agent.get_full_state_weights(world)


def restore_state(agent, state, full: dict):
    """``full_state``'s record into a fresh agent and its state (a
    ``run_program`` setup); returns the state."""
    if hasattr(agent, "critic"):
        return agent.set_weights(ckpt.tree_from_plain(state, full["state"]), full["weights"])
    return agent.set_full_state_weights(state, full)


def _host_metrics(m):
    if isinstance(m, dict):
        return {k: _host_metrics(v) for k, v in m.items()}
    return torch.as_tensor(m).detach().cpu().clone()


def run_program(program: str, params: dict, mesh=None, device=None, epochs: int = 1, seeds=(0, 1),
                setup=None, record_starts: bool = False) -> dict:
    """``epochs`` epochs of one program (``params`` from ``program_params``)
    on ``device`` (the CUDA card when None), over ``mesh`` or in a single
    process. ``setup(agent,
    state)`` may change the agent and its fresh state first (a test carries
    weights in). Returns {'metrics': [per epoch], 'weights', 'opt',
    'meters', 'launches', 'seconds', 'digests'}: CPU tensors, the kernels'
    launches during the epochs, each epoch's wall seconds and a hash of the
    weights after each epoch. With ``record_starts`` also 'starts': the
    single process's full train state (``full_state``) at the start of each
    epoch after the first, on rank 0, from which ``restore_state`` lets the
    single process run each of those epochs."""
    from rl_games_tpu_torch.ops import fused_mlp, gae

    params = copy.deepcopy(params)
    if program == "multiseed":
        from rl_games_tpu_torch.algos.ppo import PPOAgent
        from rl_games_tpu_torch.utils.multiseed import MultiSeedTrainer

        trainer = MultiSeedTrainer(PPOAgent("dryrun_ms", params, device=device), list(seeds))
        states = trainer.init_state()
        fn = trainer.make_train_fn(mesh=mesh)
        mine = [i for i in range(len(seeds)) if trainer.owner(i) == trainer.mesh.rank]
        metrics = []
        for _ in range(epochs):
            states, m = fn(states)
            metrics.append(_host_metrics(m))
        return {"metrics": metrics, "members": mine,
                "weights": {i: _plain(trainer.agents[i].get_weights()) for i in mine},
                "opt": {i: _plain(states[i].opt_state) for i in mine}}
    if program == "sac":
        from rl_games_tpu_torch.algos.sac import SACAgent

        agent = SACAgent("dryrun_sac", params, device=device)
    else:
        from rl_games_tpu_torch.algos.ppo import PPOAgent

        agent = PPOAgent(f"dryrun_{program}", params, device=device)
    state = agent.init_state()
    if setup is not None:
        state = setup(agent, state)
    fn = agent.make_train_fn(mesh=mesh)
    cuda = agent.device.type == "cuda"
    gae.gae_launches = fused_mlp.fused_mlp_launches = 0  # the counts of this run start here
    metrics, seconds, digests, starts = [], [], [], []  # digests: a hash of the weights after each epoch
    for epoch in range(epochs):
        if record_starts and epoch > 0:
            full = full_state(agent, state)  # a collective over the world
            if mesh is None or mesh.rank == 0:
                starts.append(full)
        t0 = time.perf_counter()
        state, m = fn(state)
        if cuda:
            torch.cuda.synchronize(agent.device)
        seconds.append(time.perf_counter() - t0)
        metrics.append(_host_metrics(m))
        models = [agent.actor, agent.critic] if program == "sac" else [agent.model, *filter(None, [agent.cv_model])]
        digests.append(_digest([mod.state_dict() for mod in models]))
    launches = {"gae": gae.gae_launches, "fused_mlp": fused_mlp.fused_mlp_launches}
    if program == "sac":
        weights = agent.get_weights(state)
        opt = {k: _plain(getattr(state, k)) for k in ("actor_opt", "critic_opt", "alpha_opt")}
        meters = {"replay": _plain(state.replay), "game_rewards": _plain(state.game_rewards)}
    else:
        weights = _plain(agent.get_weights())
        weights.update(_plain(agent._sections()))
        opt = {k: _plain(getattr(state, k)) for k in ("opt_state", "cv_opt", "lr", "entropy_coef")}
        meters = {k: _plain(getattr(state, k))
                  for k in ("game_rewards", "game_shaped_rewards", "game_lengths", "game_scores")}
    return {"metrics": metrics, "weights": weights, "opt": opt, "meters": meters, "launches": launches,
            "seconds": seconds, "digests": digests, "starts": starts}


def run_programs(specs: dict, mesh=None, device=None) -> dict:
    """``run_program`` of each {name: (program, params, epochs, extra
    arguments)}, in turn, over ``mesh`` or in a single process."""
    return {name: run_program(program, params, mesh=mesh, device=device, epochs=epochs, **kw)
            for name, (program, params, epochs, kw) in specs.items()}


def _rank_main(rank, size, backend, init_method, device, out_dir, fn, args, kwargs):
    if device == "cpu":  # CPU ranks share the host's cores
        torch.set_num_threads(1)
    if device == "cuda":  # ranks share the cards round-robin (several ranks a card through gloo)
        device = f"cuda:{rank % torch.cuda.device_count()}"
        torch.cuda.set_device(device)
    initialize_multihost(init_method, size, rank, backend)
    try:
        result = fn(*args, mesh=create_mesh(device), device=device, **kwargs)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_world(fn, size: int, *args, backend: str = "gloo", device=None, out_dir=None, **kwargs) -> list:
    """``fn(*args, mesh=, device=, **kwargs)`` in ``size`` spawned processes
    joined into one world (``backend`` as given: gloo, or NCCL on CUDA
    ranks) through a ``file://`` in ``out_dir`` (a temporary directory
    unless given), where the ranks leave their results; returns them in
    rank order. The ranks run on the CUDA cards, round-robin, unless
    ``device`` is 'cpu'."""
    device = resolve_device(device).type
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = out_dir or tmp
        init_method = f"file://{os.path.join(out_dir, 'world_init')}"
        mp.start_processes(_rank_main, args=(size, backend, init_method, device, out_dir, fn, args, kwargs),
                           nprocs=size, join=True, start_method="spawn")
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(size)]


PROGRAMS = ("ppo", "sac", "multiseed", "pixel", "rnn_cv")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    elif torch.is_tensor(tree):
        yield prefix, tree


def ranks_differ(results) -> list:
    """The leaves (weights, optimizer state) in which some rank's result is
    not bit-equal to rank 0's, and the epochs after which its weights
    were not."""
    first = dict(_leaves({"weights": results[0]["weights"], "opt": results[0]["opt"]}))
    out = []
    for r in results[1:]:
        out += [f"weights after epoch {e + 1}" for e, (a, b) in
                enumerate(zip(results[0].get("digests", ()), r.get("digests", ()))) if a != b]
        for name, x in _leaves({"weights": r["weights"], "opt": r["opt"]}):
            if name in first and not torch.equal(first[name], x):
                out.append(name)
    return out


def dryrun(world: int, device=None, backend: str = "gloo"):
    """Every program one epoch over ``world`` ranks (on the CUDA cards
    unless ``device`` is 'cpu'): finite losses, the frame count, the ranks
    bit-equal."""
    specs = {p: (p, program_params(p, world), 1, {"seeds": tuple(range(world))} if p == "multiseed" else {})
             for p in PROGRAMS}
    ranks = run_world(run_programs, world, specs, backend=backend, device=device)
    for program, (_, params, _, _) in specs.items():
        results = [r[program] for r in ranks]
        m = results[0]["metrics"][-1]
        loss = m["critic_loss"] if program == "sac" else m["cval_loss"] if program == "rnn_cv" else m["a_loss"]
        assert np.isfinite(loss.numpy()).all(), f"{program}: non-finite loss {loss}"
        cfg = params["config"]
        frames = (cfg["num_actors"] * cfg["num_steps_per_episode"] if program == "sac"
                  else cfg["num_actors"] * cfg["horizon_length"])
        assert (m["frame"] == frames).all(), f"{program}: frame {m['frame']}, expected {frames}"
        if program != "multiseed":
            assert not ranks_differ(results), f"{program}: the ranks differ in {ranks_differ(results)}"
        print(f"[dryrun] {program}: {world} ranks OK (loss {loss.numpy().mean():.4f}, frame {frames})")


def main():
    parser = argparse.ArgumentParser(description="data-parallel dry run of the five programs")
    parser.add_argument("--world", type=int, default=2)
    parser.add_argument("--device", default=None, help="torch device (default: the CUDA card; 'cpu' must be asked for)")
    parser.add_argument("--backend", default="gloo")
    args = parser.parse_args()
    dryrun(args.world, args.device, args.backend)


if __name__ == "__main__":
    main()
