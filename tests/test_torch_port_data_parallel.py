"""Data parallelism in the port (parallel/mesh.py) against the single
process: the counterparts of tests/test_ppo.py::test_multichip_matches_single_chip,
tests/test_sac.py::test_sac_multichip_matches_single_chip,
tests/test_multiseed.py::test_multiseed_mesh_shards_seed_axis and
tests/test_multihost.py.

Worlds are gloo ranks spawned as processes of their own, joined through a
``file://`` init method under the test's tmp dir. The dry run's five programs
(parallel/dryrun.py: flagship PPO, SAC, multi-seed, the pixel CNN, RNN with a
central value net), cooperative_gather (multi-agent rows with a central
value net), the continuous flagship with permute_batches (the mu/sigma
writeback across ranks) and CartPole with RND, soft augmentation,
permute_batches and RMS advantages run in one world of 1, one of 2 and a
single process. Tolerances are the JAX tests': PPO a_loss and c_loss at
rtol 1e-3 / atol 1e-5, SAC critic_loss and actor_loss at 1e-3 / 1e-5 and
log_alpha at rtol 1e-4, multi-seed a_loss at 2e-4 / 2e-5 and mean_rewards at
rtol 1e-5. A world of 1 is the single process bit for bit, and the ranks of
a world of 2 end bit-equal. One test holds a world of 2 against the JAX
package's 2-device mesh, on carried weights and the JAX draws."""

import copy
import functools
import os

import numpy as np
import pytest
import torch

from rl_games_tpu_torch.parallel.dryrun import (
    _leaves,
    program_params,
    ranks_differ,
    restore_state,
    run_program,
    run_programs,
    run_world,
)

torch.set_num_threads(1)
W = 2


def gather_params():
    """tests/test_multiagent.py's cooperative_gather config (8 envs x 3
    agents, horizon 16, minibatch 128) with its central value net."""
    cfg = {
        "env_name": "cooperative_gather", "num_actors": 8, "horizon_length": 16, "minibatch_size": 128,
        "mini_epochs": 2, "learning_rate": 5e-4, "lr_schedule": "adaptive", "kl_threshold": 0.008, "e_clip": 0.2,
        "clip_value": True, "gamma": 0.99, "tau": 0.95, "critic_coef": 1.0, "entropy_coef": 0.0, "grad_norm": 1.0,
        "truncate_grads": True, "normalize_advantage": True, "normalize_input": False, "normalize_value": False,
        "value_bootstrap": True, "seed": 5, "bounds_loss_coef": 0.0001,
        "central_value_config": {
            "learning_rate": 5e-4, "mini_epochs": 2, "minibatch_size": 128, "clip_value": True,
            "normalize_input": False,
            "network": {"name": "actor_critic", "central_value": True,
                        "mlp": {"units": [32], "activation": "elu", "initializer": {"name": "default"}}}},
    }
    params = program_params("ppo", W)
    params["network"]["mlp"] = {"units": [32, 32], "activation": "elu", "initializer": {"name": "default"}}
    params["config"] = cfg
    return params


def permute_params():
    params = program_params("ppo", W)
    params["config"]["permute_batches"] = True
    return params


def options_params():
    """tests/test_ppo.py's CartPole with RND (tests/test_rnd.py's network),
    gaussian soft augmentation, permute_batches and RMS advantages."""
    params = program_params("pixel", W)
    params["network"] = {"name": "actor_critic", "separate": False, "space": {"discrete": {}},
                         "mlp": {"units": [32, 32], "activation": "elu", "initializer": {"name": "default"}}}
    params["config"].update(
        env_name="CartPole-v1", num_actors=16, horizon_length=16, minibatch_size=64, mini_epochs=2,
        permute_batches=True, normalize_rms_advantage=True, adv_rms_momentum=0.5,
        features={"soft_augmentation": {"transform": {"name": "gaussian_noise", "std": 0.1}, "aug_coef": 0.5}},
        rnd_config={"scale_value": 0.02, "mini_epochs": 2, "minibatch_size": 64, "learning_rate": 5e-4,
                    "network": {"name": "rnd_curiosity",
                                "mlp": {"rnd": {"units": [64, 32, 16]}, "net": {"units": [32, 32]}}}})
    return params


# name: (program, params, epochs, extra arguments)
SPECS = {
    "ppo": ("ppo", program_params("ppo", W), 3, {"record_starts": True}),
    "sac": ("sac", program_params("sac", W), 3, {"record_starts": True}),
    "multiseed": ("multiseed", program_params("multiseed", W), 2, {"seeds": (1, 2, 3, 4)}),
    "pixel": ("pixel", program_params("pixel", W), 2, {}),
    "rnn_cv": ("rnn_cv", program_params("rnn_cv", W), 2, {}),
    "gather": ("gather", gather_params(), 5, {}),
    "ppo_permute": ("ppo_permute", permute_params(), 2, {}),
    "options": ("options", options_params(), 2, {}),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("worlds")
    plain = run_programs(SPECS, device="cpu")
    worlds = {}
    for size in (1, W):
        out = base / f"world{size}"
        out.mkdir()
        worlds[size] = run_world(run_programs, size, SPECS, device="cpu", out_dir=str(out))
    return plain, worlds[1], worlds[W]


def test_world_of_one_is_the_single_process_bit_for_bit(runs):
    """Every metric of every epoch, the weights, the optimizer states and
    the meters (the SAC replay ring too) of each program."""
    plain, (one,), _ = runs
    for name in SPECS:
        expected = dict(_leaves(plain[name]))
        got = dict(_leaves(one[name]))
        assert expected.keys() == got.keys(), name
        differ = [k for k in expected if not torch.equal(expected[k], got[k])]
        assert not differ, f"{name}: a world of 1 differs in {differ}"
        assert one[name].get("digests") == plain[name].get("digests"), name


@pytest.mark.parametrize("name", [n for n in SPECS if n != "multiseed"])
def test_ranks_stay_bit_equal(runs, name):
    """The two ranks' weights after every epoch (a hash of them), their
    weights and optimizer states at the end, and every metric they
    report."""
    _, _, two = runs
    assert not ranks_differ([r[name] for r in two])
    for k, v in _leaves(two[0][name]["metrics"]):
        assert torch.equal(v, dict(_leaves(two[1][name]["metrics"]))[k]), f"{name}: metric {k}"


@pytest.mark.parametrize("name", ["ppo", "pixel", "rnn_cv", "gather", "ppo_permute", "options"])
def test_ppo_world_of_two_matches_the_single_process(runs, name):
    """a_loss and c_loss of every epoch at the JAX test's rtol 1e-3 / atol
    1e-5; the frame counts and the games played exactly."""
    plain, _, two = runs
    for e, (m1, m2) in enumerate(zip(plain[name]["metrics"], two[0][name]["metrics"])):
        for k in ("a_loss", "c_loss"):
            np.testing.assert_allclose(m2[k].numpy(), m1[k].numpy(), rtol=1e-3, atol=1e-5,
                                       err_msg=f"{name} epoch {e + 1} {k}")
        assert int(m2["frame"]) == int(m1["frame"]) and int(m2["games_played"]) == int(m1["games_played"])
    if name in ("rnn_cv", "gather"):
        for e, (m1, m2) in enumerate(zip(plain[name]["metrics"], two[0][name]["metrics"])):
            np.testing.assert_allclose(m2["cval_loss"].numpy(), m1["cval_loss"].numpy(), rtol=1e-3, atol=1e-5)
    if name == "options":
        m1, m2 = plain[name]["metrics"][-1], two[0][name]["metrics"][-1]
        np.testing.assert_allclose(m2["rnd_loss"].numpy(), m1["rnd_loss"].numpy(), rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("name", ["ppo", "sac"])
def test_each_world_epoch_is_the_single_process_epoch_from_its_state(runs, name):
    """Every later epoch of the world of 2 against the single process's
    epoch run from the world's state at its start (``full_state``, gathered
    on rank 0; ``restore_state``): the losses within rtol 1e-5 / atol 1e-6,
    the frame and epoch counters exactly."""
    _, _, two = runs
    program, params, epochs, _ = SPECS[name]
    keys = ("critic_loss", "actor_loss", "alpha") if name == "sac" else ("a_loss", "c_loss", "kl", "lr")
    assert len(two[0][name]["starts"]) == epochs - 1 and two[1][name]["starts"] == []
    for e, start in enumerate(two[0][name]["starts"], 1):
        ref = run_program(program, params, device="cpu",
                          setup=functools.partial(restore_state, full=start))["metrics"][0]
        for k in keys:
            np.testing.assert_allclose(two[0][name]["metrics"][e][k].numpy(), ref[k].numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=f"epoch {e + 1} {k}")
        assert int(ref["frame"]) == int(two[0][name]["metrics"][e]["frame"])


def test_gather_meters_fill_as_the_single_process(runs):
    """cooperative_gather's 64-step episodes end within the 5 epochs: the
    meters count the same episodes, an env once, with the same returns."""
    plain, _, two = runs
    m1, m2 = plain["gather"]["meters"], two[0]["gather"]["meters"]
    for k in ("game_rewards", "game_lengths"):
        assert int(m2[k]["count"]) == int(m1[k]["count"]) == 8
        np.testing.assert_allclose(m2[k]["buf"].numpy(), m1[k]["buf"].numpy(), rtol=1e-5, atol=1e-5)


def test_sac_world_of_two_matches_the_single_process(runs):
    """critic_loss and actor_loss at 1e-3 / 1e-5 and log_alpha at rtol 1e-4
    after 3 epochs; each rank holds the whole replay ring, whose rows agree
    with the single process's and whose cursor is the same."""
    plain, _, two = runs
    m1, m2 = plain["sac"]["metrics"][-1], two[0]["sac"]["metrics"][-1]
    for k in ("critic_loss", "actor_loss"):
        np.testing.assert_allclose(m2[k].numpy(), m1[k].numpy(), rtol=1e-3, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(two[0]["sac"]["weights"]["log_alpha"].numpy(),
                               plain["sac"]["weights"]["log_alpha"].numpy(), rtol=1e-4)
    r1, r2 = plain["sac"]["meters"]["replay"], two[0]["sac"]["meters"]["replay"]
    assert (r2["idx"], r2["full"]) == (r1["idx"], r1["full"])
    np.testing.assert_allclose(r2["obses"].numpy(), r1["obses"].numpy(), rtol=1e-5, atol=1e-5)
    for k in ("obses", "actions", "rewards", "dones"):
        assert torch.equal(two[0]["sac"]["meters"]["replay"][k], two[1]["sac"]["meters"]["replay"][k])


def test_multiseed_world_of_two_matches_the_single_process(runs):
    """Whole members a rank: the gathered [4] metrics at the JAX test's
    tolerances, equal on both ranks; each rank trained its block of
    members, whose weights are the single process's bit for bit."""
    plain, _, two = runs
    m1 = plain["multiseed"]["metrics"][-1]
    for rank in two:
        m2 = rank["multiseed"]["metrics"][-1]
        assert m2["a_loss"].shape == (4,)
        np.testing.assert_allclose(m2["a_loss"].numpy(), m1["a_loss"].numpy(), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(m2["mean_rewards"].numpy(), m1["mean_rewards"].numpy(), rtol=1e-5)
    assert [r["multiseed"]["members"] for r in two] == [[0, 1], [2, 3]]
    for rank in two:
        for i, w in rank["multiseed"]["weights"].items():
            for k, v in w.items():
                assert torch.equal(v, plain["multiseed"]["weights"][i][k]), (i, k)


# ---------------------------------------------------------------------------
# the Runner over a world: rank-0 I/O, the seed rule
# ---------------------------------------------------------------------------


def runner_train(runs, base, mesh=None, device="cpu"):
    """``Runner.run({'train': True})`` of each (name, params) on one rank,
    its train_dir its own; returns the files each wrote, the seed its
    agent trained on and, of a PPO agent, its weights. The device vec env
    is registered under a type name of its own too, as a user registers
    one."""
    from rl_games_tpu_torch.envs import registry
    from rl_games_tpu_torch.runner import Runner
    from rl_games_tpu_torch.utils import checkpoint as ckpt

    registry.register_vecenv_type("DEVICE_UNDER_ITS_OWN_NAME", registry.VECENV_TYPES["DEVICE"])

    out = {}
    for name, params in runs:
        params = copy.deepcopy(params)
        train_dir = os.path.join(base, name, f"rank{mesh.rank}")
        params["config"].update(train_dir=train_dir, name="world", max_epochs=2, save_frequency=1,
                                print_stats=False)
        runner = Runner(device=device)
        runner.load({"params": params})
        runner.mesh = mesh
        runner.run({"train": True})
        written = sorted(os.path.relpath(os.path.join(d, f), train_dir) for d, _, fs in os.walk(train_dir)
                         for f in fs)
        rows = [ckpt.read_payload(os.path.join(train_dir, f))["state"]["obs"].shape[0]
                for f in written if f.endswith(".pth")]
        out[name] = {"files": written, "seed": runner.params["config"]["seed"], "checkpoint_rows": rows,
                     "weights": None if name == "sac" else dict(runner.agent.model.state_dict())}
    # the world resumes from rank 0's last checkpoint of the device run: epoch 3
    torch.distributed.barrier()
    nn_dir = os.path.join(base, "device", "rank0", "world", "nn")
    last = next(f for f in sorted(os.listdir(nn_dir)) if f.startswith("last_world_ep_2_rew"))
    params = copy.deepcopy(runs[0][1])
    params["config"].update(train_dir=os.path.join(base, "resumed", f"rank{mesh.rank}"), name="world",
                            max_epochs=3, print_stats=False)
    runner = Runner(device=device)
    runner.load({"params": params})
    runner.mesh = mesh
    out["resumed_epochs"] = runner.run({"train": True, "checkpoint": os.path.join(nn_dir, last)})[1]
    return out


def test_runner_world_writes_checkpoints_on_rank_zero_alone(tmp_path):
    """Two ranks train through Runner.run with the world as Runner.mesh.
    The flagship dry-run config without a seed: rank 0 draws one and both
    ranks train on it; rank 0 writes every epoch's checkpoint, rank 1
    nothing. Pendulum-v1 over gymnasium (a host env, which ignores the
    world): each rank trains alone on the config's seed plus its rank, and
    again only rank 0 writes. The SAC dry-run config (no seed either) as
    the flagship's. Each checkpoint holds every env's rows, and the world
    resumes from one."""
    device = program_params("ppo", W)
    host = copy.deepcopy(device)
    host["seed"] = 11
    host["config"].update(vecenv_type="GYMNASIUM", num_actors=2, horizon_length=8, minibatch_size=16)
    out = tmp_path / "out"
    out.mkdir()
    sac = program_params("sac", W)
    custom = copy.deepcopy(device)
    custom["config"]["vecenv_type"] = "DEVICE_UNDER_ITS_OWN_NAME"
    runs = [("device", device), ("host", host), ("sac", sac), ("custom", custom)]
    ranks = run_world(runner_train, W, runs, str(tmp_path / "runs"), device="cpu", out_dir=str(out))
    for name, params in runs:
        assert any(f.endswith(".pth") and "last_world_ep_1" in f for f in ranks[0][name]["files"]), ranks[0]
        assert ranks[1][name]["files"] == []
        # a checkpoint holds the world's rows, gathered from both ranks
        assert set(ranks[0][name]["checkpoint_rows"]) == {params["config"]["num_actors"]}
    assert [r["resumed_epochs"] for r in ranks] == [3, 3]
    assert ranks[0]["device"]["seed"] == ranks[1]["device"]["seed"]
    assert ranks[0]["sac"]["seed"] == ranks[1]["sac"]["seed"]
    assert [r["host"]["seed"] for r in ranks] == [11, 12]
    # a device env registered under a type name of its own is told apart by
    # the vec env built, not by its name: one seed, and the ranks' weights
    # after the 2 epochs bit for bit
    assert ranks[0]["custom"]["seed"] == ranks[1]["custom"]["seed"]
    for k, v in ranks[0]["custom"]["weights"].items():
        assert torch.equal(v, ranks[1]["custom"]["weights"][k]), k


# ---------------------------------------------------------------------------
# against the JAX package's 2-device mesh
# ---------------------------------------------------------------------------


def jax_flagship_params():
    """tests/test_torch_port_ppo.py's flagship cut (16 Ant2D envs, units
    [32, 16], 2 mini-epochs) at horizon 8, minibatch 32: seed 7 has no env
    terminate in the 16 steps of 2 epochs, so no reset draw differs."""
    return {
        "algo": {"name": "a2c_continuous"},
        "model": {"name": "continuous_a2c_logstd"},
        "network": {
            "name": "actor_critic", "separate": False,
            "mlp": {"units": [32, 16], "activation": "elu", "initializer": {"name": "default"}},
            "space": {"continuous": {
                "mu_activation": "None", "sigma_activation": "None", "mu_init": {"name": "default"},
                "sigma_init": {"name": "const_initializer", "val": 0.0}, "fixed_sigma": True}},
        },
        "config": {
            "env_name": "Ant2D", "num_actors": 16, "horizon_length": 8, "minibatch_size": 32, "mini_epochs": 2,
            "learning_rate": 3e-4, "lr_schedule": "adaptive", "kl_threshold": 0.008, "e_clip": 0.2,
            "clip_value": True, "gamma": 0.99, "tau": 0.95, "critic_coef": 2.0, "entropy_coef": 0.0,
            "grad_norm": 1.0, "truncate_grads": True, "normalize_advantage": True, "normalize_input": True,
            "normalize_value": True, "bounds_loss_coef": 0.0001, "value_bootstrap": True, "seed": 7,
        },
    }


def carry_jax(path, agent, state):
    """The JAX agent's initial weights, normalizer stats, env state,
    observations, dones and lr from the .npz at ``path``, and its rollouts'
    action noise in place of the port's draws: each step's global [N, A]
    normals, of which a rank takes its rows."""
    from rl_games_tpu_torch.envs.device.ant2d import Ant2DState
    from rl_games_tpu_torch.models import distributions as D
    from rl_games_tpu_torch.parallel.mesh import RowGenerator

    data = dict(np.load(path))
    weights = {k[len("w/"):]: torch.from_numpy(v) for k, v in data.items() if k.startswith("w/")}
    agent.model.load_state_dict(weights)
    state.env_state.estate = Ant2DState(**{k: torch.from_numpy(data[k]) for k in ("q", "qd", "last_x")})
    state.env_state.steps = torch.from_numpy(data["steps"])
    state.obs, state.dones, state.lr = (torch.from_numpy(data[k]) for k in ("obs", "dones", "lr"))
    noise = iter(torch.from_numpy(data["noise"]))

    def normal_sample(mean, std, generator=None):
        n = next(noise)
        if isinstance(generator, RowGenerator):
            n = n[generator.lo:generator.hi]
        return mean + std * n

    D.normal_sample = normal_sample
    return state


def test_world_of_two_matches_the_jax_mesh(tmp_path):
    """The JAX package's make_train_fn(mesh=create_mesh(jax.devices()[:2]))
    over 2 epochs against a port world of 2 started from the JAX state's
    weights and env state, its action noise handed in (recovered as
    (actions - mus) / sigmas from the JAX single-device rollouts of the same
    epochs, which the mesh program draws alike): a_loss and c_loss of each
    epoch at rtol 1e-3 / atol 1e-5 (tests/test_ppo.py:230's)."""
    import jax

    from rl_games_tpu.algos.ppo import PPOAgent as JPPOAgent
    from rl_games_tpu.parallel.mesh import create_mesh
    from rl_games_tpu_torch.utils.jax_params import jax_to_state_dict

    if jax.device_count() < 2:
        pytest.skip("needs 2 virtual devices")
    params = jax_flagship_params()
    jagent = JPPOAgent("jax", params)
    jstate = jagent.init_state()
    roll, finish = jax.jit(jagent._rollout), jax.jit(jagent._finish_epoch)
    noise, state = [], jstate
    for _ in range(2):
        after, traj, last_values, _ = roll(state)
        assert not np.asarray(traj["dones"])[1:].any() and not np.asarray(after.dones).any()
        noise.append((np.asarray(traj["actions"]) - np.asarray(traj["mus"])) / np.asarray(traj["sigmas"]))
        state, _ = finish(after, traj, last_values, None)
    mesh_agent = JPPOAgent("jax", params)
    fn = mesh_agent.make_train_fn(mesh=create_mesh(jax.devices()[:2]), donate=False)
    mstate, jmetrics = mesh_agent.init_state(), []
    for _ in range(2):
        mstate, m = fn(mstate)
        jmetrics.append({k: float(m[k]) for k in ("a_loss", "c_loss")})

    weights = jax_to_state_dict(jax.tree.map(np.asarray, jstate.params), jax.tree.map(np.asarray, jstate.norm))
    est = jstate.env_state.estate
    path = str(tmp_path / "jax.npz")
    np.savez(path, **{f"w/{k}": v.numpy() for k, v in weights.items()}, q=np.asarray(est.q),
             qd=np.asarray(est.qd), last_x=np.asarray(est.last_x), steps=np.asarray(jstate.env_state.steps),
             obs=np.asarray(jstate.obs), dones=np.asarray(jstate.dones), lr=np.asarray(jstate.lr),
             noise=np.concatenate(noise).astype(np.float32))
    out = tmp_path / "out"
    out.mkdir()
    ranks = run_world(run_program, W, "jax_flagship", params, epochs=2, setup=functools.partial(carry_jax, path),
                      device="cpu", out_dir=str(out))
    assert not ranks_differ(ranks)
    for e, jm in enumerate(jmetrics):
        for k, v in jm.items():
            np.testing.assert_allclose(float(ranks[0]["metrics"][e][k]), v, rtol=1e-3, atol=1e-5,
                                       err_msg=f"epoch {e + 1} {k}")


# ---------------------------------------------------------------------------
# PBT over a world: the leader's weights move between ranks
# ---------------------------------------------------------------------------


def pbt_adoption(params, mesh=None, device="cpu"):
    """One epoch of a 4-member population, then a pbt_step on metrics where
    member 3 leads and member 0 lags (Python's random seeded alike): each
    member's weights, lr and entropy_coef where this rank trains it, and the
    events."""
    import random

    from rl_games_tpu_torch.algos.ppo import PPOAgent
    from rl_games_tpu_torch.utils.multiseed import PopulationTrainer

    trainer = PopulationTrainer(PPOAgent("t", params, device=device), [1, 2, 3, 4], mutation_rate=1.0)
    states = trainer.init_state()
    states, _ = trainer.make_train_fn(mesh=mesh)(states)
    random.seed(0)
    metrics = {"mean_rewards": np.array([[1.0], [5.0], [5.0], [9.0]]), "games_played": np.ones(4)}
    states, events = trainer.pbt_step(states, metrics)
    mine = [i for i in range(4) if trainer.owner(i) == trainer.mesh.rank]
    return {"events": events, "members": {i: {"weights": trainer.agents[i].get_weights(), "lr": states[i].lr.clone(),
                                              "entropy_coef": states[i].entropy_coef.clone()} for i in mine}}


def test_pbt_adoption_moves_the_leader_between_ranks(tmp_path):
    """Member 0 (rank 0) adopts member 3 (rank 1): its weights are the
    leader's, bit for bit, and its mutated lr and entropy_coef and the
    events are the single process's; member 3 keeps its own."""
    params = program_params("multiseed", W)
    plain = pbt_adoption(params)
    ranks = run_world(pbt_adoption, W, params, device="cpu", out_dir=str(tmp_path))
    assert [e["dst"] for e in plain["events"]] == [1] and [e["src"] for e in plain["events"]] == [4]
    for r in ranks:
        assert r["events"] == plain["events"]
    adopted, leader = ranks[0]["members"][0], ranks[1]["members"][3]
    for k, v in leader["weights"].items():
        assert torch.equal(adopted["weights"][k], v) and torch.equal(v, plain["members"][3]["weights"][k]), k
    for k in ("lr", "entropy_coef"):
        assert torch.equal(adopted[k], plain["members"][0][k])
