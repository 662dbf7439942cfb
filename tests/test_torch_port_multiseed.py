"""Multi-seed training in the port (utils/multiseed.py, Runner --seeds):
tests/test_multiseed.py's cases for the port. Each member trains exactly as
a solo agent seeded alike (no module, generator, env or normalizer is
shared), the population learns, checkpoints play, SAC and the pbt block
run, and the RNN and central value configs compose."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from rl_games_tpu_torch.algos.ppo import PPOAgent
from rl_games_tpu_torch.runner import Runner
from rl_games_tpu_torch.utils import checkpoint as ckpt
from rl_games_tpu_torch.utils.multiseed import MultiSeedTrainer, PopulationTrainer

from test_ppo import cartpole_params

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
CONFIGS = ROOT / "rl_games_tpu" / "configs"


def load(name):
    return yaml.safe_load((CONFIGS / name).read_text())


def leaves(state):
    """(path, tensor) of every tensor of a train state, generators as their state."""
    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from walk(v, f"{prefix}/{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from walk(v, f"{prefix}/{i}")
        elif tree is not None:
            yield prefix, tree
    return dict(walk(ckpt.tree_to_plain(state), ""))


def test_members_equal_their_solo_runs():
    """Each member's 3 epochs equal the same seed trained alone, exactly:
    weights, normalizers, Adam moments, every tensor of the state, losses."""
    seeds = [3, 9]
    ms = MultiSeedTrainer(PPOAgent("t", cartpole_params(), device="cpu"), seeds)
    states = ms.init_state()
    for _ in range(3):
        states, metrics = ms.epoch(states)
    assert metrics["a_loss"].shape == (2,) and metrics["mean_rewards"].shape == (2, 1)
    for i, seed in enumerate(seeds):
        solo = PPOAgent("t", cartpole_params(), device="cpu")
        state = solo.init_state(seed=seed)
        for _ in range(3):
            state, m = solo.train_epoch(state)
        for k in ("a_loss", "c_loss", "entropy", "kl", "lr", "mean_rewards", "games_played"):
            assert torch.equal(metrics[k][i], m[k]), (seed, k)
        for k, v in solo.model.state_dict().items():
            assert torch.equal(ms.agents[i].model.state_dict()[k], v), (seed, k)
        got, want = leaves(ms.state_for_seed(states, i)), leaves(state)
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (seed, k)
    # the members share no module or generator
    a, b = ms.agents
    assert a.model is not b.model and a.vec_env is not b.vec_env and states[0].generator is not states[1].generator


def test_population_learns_and_slices_a_solo_state():
    seeds = [5, 11, 17]
    agent = PPOAgent("t", cartpole_params(), device="cpu")
    ms = MultiSeedTrainer(agent, seeds)
    states = ms.init_state()
    for _ in range(60):
        states, m = ms.epoch(states)
    rewards = m["mean_rewards"].numpy()[:, 0]
    assert rewards.shape == (3,)
    assert (rewards > 60.0).all(), rewards
    # one member's state has a solo state's shapes (checkpoint / player compatible)
    solo = {k: tuple(v.shape) for k, v in leaves(agent.init_state(seed=5)).items()}
    assert {k: tuple(v.shape) for k, v in leaves(ms.state_for_seed(states, 1)).items()} == solo
    assert ms.frames_per_epoch() == 16 * 32


def test_multiseed_rejects_host_envs():
    params = cartpole_params(vecenv_type="GYMNASIUM", env_config={"seed": 1})
    agent = PPOAgent("t", params, device="cpu")
    assert agent.is_host_env
    with pytest.raises(ValueError, match="needs a device env"):
        MultiSeedTrainer(agent, [1, 2])


def cartpole_config(train_dir, max_epochs=3, **config):
    cfg = load("ppo_cartpole.yaml")
    cfg["params"]["config"].update({"num_actors": 4, "horizon_length": 8, "minibatch_size": 16, "mini_epochs": 2,
                                    "max_epochs": max_epochs, "train_dir": str(train_dir), "log_interval": 1,
                                    "print_stats": False, **config})
    cfg["params"]["config"]["player"] = {"games_num": 4, "num_actors": 4, "deterministic": True}
    return cfg


def test_runner_seeds_write_checkpoints_the_player_plays(tmp_path, capsys):
    runner = Runner(device="cpu")
    runner.load(cartpole_config(tmp_path))
    paths = runner.run({"train": True, "seeds": "3,9"})
    nn_dir = tmp_path / "cartpole_ppo" / "nn"
    assert paths == [str(nn_dir / "cartpole_ppo_seed3.pth"), str(nn_dir / "cartpole_ppo_seed9.pth")]
    out = capsys.readouterr().out
    assert "Started to train 2 seeds in one process: [3, 9]" in out
    assert "epoch: 3/3 frames: 192 seed3: " in out and " seed9: " in out  # 2 members x 4 envs x 8 steps x 3
    for i, p in enumerate(paths):
        assert ckpt.peek_meta(p)["epoch"] == 3
        # a single-seed checkpoint: the member's weights
        weights, _ = ckpt.load_checkpoint_weights(p)
        for k, v in runner.trainer.agents[i].model.state_dict().items():
            assert torch.equal(weights[k], v), k
    assert float(runner.run({"play": True, "checkpoint": paths[0]})) > 0


def test_runner_seeds_space_separated_with_pbt_block(tmp_path, capsys, monkeypatch):
    """The pbt block on PPO selects the population: every interval_steps
    (64 frames: 2 epochs of 4 envs x 8) a pbt_step on the epoch's metrics."""
    cfg = cartpole_config(tmp_path, max_epochs=6, log_interval=2)
    cfg["params"]["config"]["pbt"] = {"interval_steps": 64, "threshold_std": 0.1, "threshold_abs": 0.05,
                                      "mutation_rate": 0.5}
    runner = Runner(device="cpu")
    runner.load(cfg)
    steps, pbt_step = [], PopulationTrainer.pbt_step

    def counted(self, states, metrics):
        steps.append(int(metrics["epoch"][0]))
        return pbt_step(self, states, metrics)

    monkeypatch.setattr(PopulationTrainer, "pbt_step", counted)
    paths = runner.run({"train": True, "seeds": "1 2 3"})
    out = capsys.readouterr().out
    assert len(paths) == 3 and all(os.path.exists(p) for p in paths)
    assert "on-device PBT: band exploit every 2 epochs over the 3-member population" in out
    assert steps == [2, 4, 6] and isinstance(runner.trainer, PopulationTrainer)


def test_runner_seeds_sac(tmp_path, capsys):
    """SAC --seeds 2,4 on sac_pendulum.yaml shrunk (tests/test_multiseed.py:
    108-129): one agent and replay ring per member; the pbt block is ignored."""
    cfg = load("sac_pendulum.yaml")
    cfg["params"]["config"].update(num_actors=4, num_steps_per_episode=4, batch_size=32, replay_buffer_size=1000,
                                   num_warmup_steps=2, utd_ratio=0.5, max_epochs=4, train_dir=str(tmp_path),
                                   log_interval=2, print_stats=False, pbt={"interval_steps": 16})
    cfg["params"]["network"]["mlp"]["units"] = [32, 32]
    runner = Runner(device="cpu")
    runner.load(cfg)
    paths = runner.run({"train": True, "seeds": "2,4"})
    assert len(paths) == 2 and all(os.path.exists(p) for p in paths)
    assert "pbt block ignored" in capsys.readouterr().out
    a, b = runner.trainer.agents
    sa, sb = runner.last_states
    assert sa.replay is not sb.replay and sa.update_counter == sb.update_counter == (4 - 2) * 4 * 2
    assert not torch.equal(next(a.actor.parameters()), next(b.actor.parameters()))  # seeded apart
    assert ckpt.peek_meta(paths[1])["has_replay"] is False
    assert float(runner.run({"play": True, "checkpoint": paths[1], "player": {"games_num": 1}})) < 0.0


@pytest.mark.parametrize("args", [{"checkpoint": "x.pth"}, {"sigma": 0.5}], ids=["checkpoint", "sigma"])
def test_runner_seeds_refuse_checkpoint_and_sigma(tmp_path, args):
    runner = Runner(device="cpu")
    runner.load(cartpole_config(tmp_path))
    with pytest.raises(ValueError):
        runner.run({"train": True, "seeds": "1,2", **args})


def test_rnn_and_central_value_configs_compose():
    """Every member's own recurrent states and central value net: each
    metric gains the [2] axis."""
    from test_central_value import asym_params
    from test_ppo_rnn import rnn_params

    for params in (rnn_params(), asym_params()):
        ms = MultiSeedTrainer(PPOAgent("t", params, device="cpu"), [1, 2])
        states, m = ms.epoch(ms.init_state())
        for k in ("a_loss", "c_loss", "kl", "lr", "games_played"):
            assert m[k].shape == (2,), k
            assert np.isfinite(m[k].numpy()).all(), k
        assert m["mean_rewards"].shape == (2, 1)
    assert "cval_loss" in m and ms.agents[0].cv_model is not ms.agents[1].cv_model


def test_cli_seeds_train_and_play(tmp_path):
    """python -m rl_games_tpu_torch --train --seeds 3,9 writes both
    members' checkpoints in one process; --play -c restores one."""
    cfg_path = tmp_path / "cartpole.yaml"
    cfg_path.write_text(yaml.safe_dump(cartpole_config(tmp_path / "runs", max_epochs=2)))
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    base = [sys.executable, "-m", "rl_games_tpu_torch", "--device", "cpu", "-f", str(cfg_path)]
    train = subprocess.run(base + ["--train", "--seeds", "3,9"], cwd=tmp_path, env=env, capture_output=True,
                           text=True, timeout=300)
    assert train.returncode == 0, train.stderr[-3000:]
    nn_dir = tmp_path / "runs" / "cartpole_ppo" / "nn"
    assert sorted(os.listdir(nn_dir)) == ["cartpole_ppo_seed3.pth", "cartpole_ppo_seed9.pth"]
    play = subprocess.run(base + ["--play", "-c", str(nn_dir / "cartpole_ppo_seed9.pth")], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert play.returncode == 0, play.stderr[-3000:]
    assert "av reward: " in play.stdout
