"""The data-parallel helpers of the port (parallel/mesh.py), the counterpart
of rl_games_tpu/parallel/mesh.py: the blocks of rows, the global draws that
a rank slices (rule (a)), a vec env cut to a rank's envs, the gather, the
flat-buffer all-reduce and the broadcast over gloo ranks, and what a mesh
refuses or ignores. The worlds of full programs are in
tests/test_torch_port_data_parallel.py."""

import os
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import yaml

from rl_games_tpu_torch.algos.ppo import PPOAgent, meters_init, meters_update
from rl_games_tpu_torch.algos.sac import SACAgent
from rl_games_tpu_torch.envs import registry
from rl_games_tpu_torch.envs.device import base
from rl_games_tpu_torch.models import distributions as D
from rl_games_tpu_torch.parallel import mesh as M
from rl_games_tpu_torch.parallel.dryrun import program_params, run_world
from rl_games_tpu_torch.utils.multiseed import MultiSeedTrainer

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


def fake_mesh(rank: int, size: int) -> M.Mesh:
    """A handle with no process group: enough for what is checked before a
    collective runs."""
    return M.Mesh(rank=rank, size=size, device=torch.device("cpu"), backend="gloo")


def test_block_splits_rows_evenly_or_raises():
    assert [fake_mesh(r, 4).block(8) for r in range(4)] == [(0, 2), (2, 4), (4, 6), (6, 8)]
    with pytest.raises(ValueError, match="minibatch_size \\(6\\) must be divisible by the world size \\(4\\)"):
        fake_mesh(0, 4).block(6, "minibatch_size")


@pytest.mark.parametrize("sampler", [torch.rand, torch.randn])
@pytest.mark.parametrize("rank", [0, 1, 2])
def test_row_generator_draws_the_world_rows(sampler, rank):
    """Each draw is the single process's draw at [6, 3], cut to the rank's
    rows, and the stream advances alike: the second draw matches too."""
    world = torch.Generator().manual_seed(11)
    lo, hi = fake_mesh(rank, 3).block(6)
    mine = M.row_generator(torch.Generator().manual_seed(11), lo, hi, 6)
    for _ in range(2):
        expected = sampler((6, 3), generator=world)
        assert torch.equal(M.draw_rows(sampler, (2, 3), mine), expected[lo:hi])
    with pytest.raises(ValueError):
        M.draw_rows(sampler, (3, 3), mine)


@pytest.mark.parametrize("draw", ["uniform", "normal_sample", "categorical_sample"])
def test_samplers_take_their_rows_of_the_world_draw(draw):
    """The env's uniforms, the Gaussian policy's normals and the Gumbel-max
    categorical: a rank's rows equal the single process's rows."""
    n, lo, hi = 8, 4, 8
    x = torch.randn(n, 5, generator=torch.Generator().manual_seed(2))

    def run(gen, rows):
        if draw == "uniform":
            return base.uniform(rows.stop - rows.start, (2, 3), gen, "cpu")
        if draw == "normal_sample":
            return D.normal_sample(x[rows], torch.ones_like(x[rows]), gen)
        return D.categorical_sample(x[rows], gen)

    whole = run(torch.Generator().manual_seed(5), slice(0, n))
    part = run(M.row_generator(torch.Generator().manual_seed(5), lo, hi, n), slice(lo, hi))
    assert torch.equal(part, whole[lo:hi])


@pytest.mark.parametrize("name", ["Ant2D", "CartPole-v1", "PixelCatcher-v0", "cooperative_gather"])
def test_take_rows_steps_the_block_as_the_world(name):
    """A vec env cut to envs [2, 4) of 4 steps its block as the whole vec
    env steps those envs, bit for bit, through 40 steps of autoresets: the
    reset and step draws are the world's, sliced."""
    whole = registry.create_vec_env(name, 4, device="cpu")
    part = registry.create_vec_env(name, 4, device="cpu")
    ws, wobs = whole.reset(torch.Generator().manual_seed(3))
    ps, _ = part.reset(torch.Generator().manual_seed(3))
    ps = part.take_rows(ps, 2, 4)
    agents = getattr(whole, "num_agents", 1)
    space = whole.get_env_info().action_space
    rng = np.random.default_rng(0)
    done_seen = False
    for _ in range(40):
        if hasattr(space, "n"):
            actions = torch.from_numpy(rng.integers(0, space.n, 4 * agents))
        else:
            actions = torch.from_numpy(rng.uniform(-1, 1, (4 * agents, *space.shape)).astype(np.float32))
        ws, wobs, wr, wd, _ = whole.step(ws, actions)
        ps, pobs, pr, pd, _ = part.step(ps, actions[2 * agents:])
        for w, p in ((wobs, pobs), (wr, pr), (wd, pd)):
            for key in (w if isinstance(w, dict) else [None]):
                a, b = (w, p) if key is None else (w[key], p[key])
                assert torch.equal(b, a[2 * agents:]), key
        done_seen = done_seen or bool(wd.any())
    assert part.num_envs == 2 and part.env_offset == 2
    assert done_seen or name == "cooperative_gather"


def test_selfplay_push_fills_the_rank_slots():
    """The self-play manager's env indices are global: a rank cut to envs
    [4, 8) fills the slots of the ones in its block."""
    params = yaml.safe_load((ROOT / "benchruns" / "selfplay_forage.yaml").read_text())["params"]
    params["config"].update(num_actors=8, minibatch_size=64)
    agent = PPOAgent("t", params, device="cpu")
    state = agent.init_state()
    es = agent.vec_env.take_rows(state.env_state, 4, 8)
    w = {k: v + 1.0 for k, v in agent.get_weights().items()}
    new = agent.vec_env.set_weights([1, 5, 6], w, env_state=es)
    for k, cur in new.opp_weights.items():
        changed = [i for i in range(4) if not torch.equal(cur[i], es.opp_weights[k][i])]
        assert changed in ([1, 2], []), (k, changed)
    key = next(k for k, v in w.items() if v.dtype.is_floating_point)
    assert torch.equal(new.opp_weights[key][1], w[key])


def collectives(mesh=None, device="cpu"):
    """gather_rows, all_reduce_mean_ and broadcast_ on one rank."""
    r = mesh.rank
    out = {
        "rows": M.gather_rows(torch.arange(4, dtype=torch.float32).reshape(2, 2) + 10 * r, mesh),
        "axis1": M.gather_rows(torch.full((3, 2), r, dtype=torch.int64), mesh, axis=1),
        "bool": M.gather_rows(torch.tensor([True, r == 1]), mesh),
        "dict": M.gather_rows({"a": torch.tensor([float(r)]), "b": (torch.tensor([r]),)}, mesh),
    }
    grads = [torch.full((2, 3), float(r + 1)), torch.tensor(2.0 * r)]
    out["mean"] = M.all_reduce_mean_(grads, mesh)
    out["bcast"] = M.broadcast_([torch.full((2,), float(r)), torch.tensor([r + 2**40])], mesh.size - 1, mesh)
    return out


def test_collectives_over_a_world_of_two(tmp_path):
    """Two gloo ranks: the gather concatenates in rank order (axis 0 or 1,
    bool and int64 as they were), the all-reduce averages each tensor in
    place, the broadcast takes the last rank's float32 and int64 values
    exactly (2^40 + 1 survives)."""
    ranks = run_world(collectives, 2, device="cpu", out_dir=str(tmp_path))
    for out in ranks:
        assert torch.equal(out["rows"], torch.tensor([[0.0, 1], [2, 3], [10, 11], [12, 13]]))
        assert torch.equal(out["axis1"], torch.tensor([[0, 0, 1, 1]] * 3))
        assert torch.equal(out["bool"], torch.tensor([True, False, True, True]))
        assert torch.equal(out["dict"]["a"], torch.tensor([0.0, 1.0]))
        assert torch.equal(out["dict"]["b"][0], torch.tensor([0, 1]))
        assert torch.equal(out["mean"][0], torch.full((2, 3), 1.5)) and float(out["mean"][1]) == 1.0
        assert torch.equal(out["bcast"][0], torch.ones(2)) and int(out["bcast"][1]) == 1 + 2**40


def test_collectives_at_a_world_of_one_are_identities(tmp_path):
    """One gloo rank in this process: every helper returns its input's
    values bit for bit."""
    M.initialize_multihost(f"file://{tmp_path / 'init'}", 1, 0, "gloo")
    try:
        mesh = M.create_mesh()
        assert (mesh.rank, mesh.size, mesh.backend, mesh.device.type) == (0, 1, "gloo", "cpu")
        x = torch.randn(5, 3, generator=torch.Generator().manual_seed(1))
        assert torch.equal(M.gather_rows(x, mesh), x)
        y = [x.clone(), x[0].clone()]
        M.all_reduce_mean_(y, mesh)
        assert torch.equal(y[0], x) and torch.equal(y[1], x[0])
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError):
        M.initialize_multihost("file:///nonexistent", 1, 0, "mpi")


def test_local_world_helpers_return_their_input():
    """LOCAL, the trainers' default world of one process with no process
    group: the gather, the reduce and the broadcast hand back their input
    without a collective; every size divides."""
    assert not dist.is_initialized()
    x = torch.randn(5, 3, generator=torch.Generator().manual_seed(2))
    tree = {"a": x, "b": (x[0],)}
    assert M.gather_rows(x, M.LOCAL) is x and M.gather_rows(tree, M.LOCAL) is tree
    assert M.unshard_rows(tree, M.LOCAL) is tree
    grads = [x]
    assert M.all_reduce_mean_(grads, M.LOCAL) is grads and M.broadcast_(grads, 0, M.LOCAL) is grads
    assert M.LOCAL.block(7) == (0, 7)


def test_entry_points_run_on_the_card_unless_asked(monkeypatch):
    """The dry run and its helpers run on the CUDA card by default: without
    one they raise rather than fall back to the CPU."""
    from rl_games_tpu_torch.parallel import dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        dryrun.run_world(collectives, 2)
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        dryrun.run_program("ppo", program_params("ppo", 1))
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        dryrun.dryrun(2)


def test_meters_keep_the_last_rows_when_more_finish_than_they_hold():
    """5 rows finish at once in a ring of 3: the last 3 stay, in order, as
    5 one-row writes would leave them; the spare row takes the rest."""
    m = meters_init(3, 1, "cpu")
    values = torch.arange(1.0, 7.0)[:, None]
    meters_update(m, values, torch.tensor([True, True, False, True, True, True]))
    assert m.buf[:3, 0].tolist() == [5.0, 6.0, 4.0]  # slots 2, 0, 1 of the ring
    assert int(m.count) == 3 and int(m.ptr) == 2


def test_make_train_fn_checks_the_world_sizes():
    """Sizes the world must divide: num_actors, the minibatch, a
    minibatch's sequences, SAC's batch; each a ValueError naming it."""
    ppo = PPOAgent("t", program_params("ppo", 2), device="cpu")
    with pytest.raises(ValueError, match="num_actors"):
        ppo.make_train_fn(mesh=fake_mesh(0, 3))
    params = program_params("rnn_cv", 2)
    params["config"].update(seq_length=8, minibatch_size=16)  # 2 sequences a minibatch, 4 rows a rank
    rnn = PPOAgent("t", params, device="cpu")
    with pytest.raises(ValueError, match="sequences"):
        rnn.make_train_fn(mesh=fake_mesh(0, 4))
    sac = SACAgent("t", program_params("sac", 2), device="cpu")
    with pytest.raises(ValueError, match="num_actors"):
        sac.make_train_fn(mesh=fake_mesh(0, 3))
    assert ppo.mesh is M.LOCAL and sac.mesh is M.LOCAL


def test_multiseed_seed_count_must_divide_the_world():
    """tests/test_multiseed.py:208's ValueError: 3 seeds over 2 ranks."""
    agent = PPOAgent("t", program_params("multiseed", 2), device="cpu")
    with pytest.raises(ValueError, match="the number of seeds"):
        MultiSeedTrainer(agent, [1, 2, 3]).make_train_fn(mesh=fake_mesh(0, 2))
    trainer = MultiSeedTrainer(agent, [1, 2, 3, 4])
    trainer.make_train_fn(mesh=fake_mesh(1, 2))
    assert [trainer.owner(i) for i in range(4)] == [0, 0, 1, 1]


def host_params(algo: str):
    params = program_params("ppo" if algo == "ppo" else "sac", 2)
    params["config"].update(vecenv_type="GYMNASIUM", num_actors=2)
    if algo == "ppo":
        params["config"].update(horizon_length=8, minibatch_size=16)
    return params


@pytest.mark.parametrize("algo", ["ppo", "sac"])
def test_host_envs_ignore_the_mesh_with_a_warning(algo):
    """algos/ppo.py:1499-1504 and algos/sac.py:613-621 of the JAX package:
    a host env's epoch is the single-process one, with a UserWarning."""
    agent = (PPOAgent if algo == "ppo" else SACAgent)("t", host_params(algo), device="cpu")
    with pytest.warns(UserWarning, match="mesh is ignored"):
        fn = agent.make_train_fn(mesh=fake_mesh(1, 2))
    assert fn == agent.host_train_epoch and agent.mesh is M.LOCAL


@pytest.mark.parametrize("rank", [0, 1])
def test_only_rank_zero_writes_checkpoints_and_summaries(tmp_path, rank):
    """PPO over a host env trains alone on each rank (the world ignored);
    rank 0 writes its run directory, rank 1 nothing."""
    params = host_params("ppo")
    params["config"].update(train_dir=str(tmp_path / "runs"), name="t", max_epochs=2, save_frequency=1,
                            print_stats=False)
    agent = PPOAgent("t", params, device="cpu")
    with pytest.warns(UserWarning):
        agent.train(mesh=fake_mesh(rank, 2))
    written = [f for _, _, fs in os.walk(tmp_path) for f in fs]
    assert (any(f.endswith(".pth") for f in written) if rank == 0 else written == []), written


def test_dryrun_runs_its_five_programs(capsys):
    """parallel/dryrun.py, the counterpart of __graft_entry__.dryrun_multichip:
    flagship PPO, SAC, multi-seed, the pixel CNN and RNN with a central value
    net, one epoch each over 2 gloo ranks: finite losses, the frame counts,
    the ranks bit-equal."""
    from rl_games_tpu_torch.parallel.dryrun import PROGRAMS, dryrun

    dryrun(2, device="cpu")
    out = capsys.readouterr().out
    assert [line.split(":")[0] for line in out.splitlines() if line.startswith("[dryrun]")] == \
        [f"[dryrun] {p}" for p in PROGRAMS]
