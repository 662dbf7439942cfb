"""Discrete PPO in the port against the JAX PPOAgent, and its entry points.

A conv-torso config on PixelCatcher (ppo_pixelcatcher.yaml narrowed to
filters 4/8 and MLP [16], 16 envs, horizon 8, minibatch 32, 2
mini-epochs): the JAX agent's weights, normalizer stats and env states are
carried to the port, and the Gumbel noise of the JAX rollout's
``jax.random.categorical`` (the uniforms its per-step keys give) is fed to
the port's sampler. Then ``ppo_cartpole.yaml`` plain and fused through
``Runner`` and a shrunk ``ppo_pong_device.yaml`` through the CLI, all on
the CPU, and the float32 precision an entry point sets for a card.

Tolerances (stated per comparison): actions and observations exactly;
what the network computes at 1e-5, float32 in another summation order.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from rl_games_tpu.algos.ppo import PPOAgent as JPPOAgent
from rl_games_tpu_torch.algos.ppo import PPOAgent
from rl_games_tpu_torch.common.player import PpoPlayer
from rl_games_tpu_torch.envs.device.pixel import CatchState
from rl_games_tpu_torch.models import distributions as D
from rl_games_tpu_torch.ops import fused_mlp, gae
from rl_games_tpu_torch.runner import Runner
from rl_games_tpu_torch.utils.jax_params import jax_to_state_dict

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
CONFIGS = ROOT / "rl_games_tpu" / "configs"
NUM_ACTORS, HORIZON = 16, 8


def load(name):
    return yaml.safe_load((CONFIGS / name).read_text())


def catcher_params(schedule_type="legacy"):
    params = load("ppo_pixelcatcher.yaml")["params"]
    params["network"]["cnn"]["convs"] = [{"filters": 4, "kernel_size": 4, "strides": 2, "padding": 0},
                                         {"filters": 8, "kernel_size": 3, "strides": 2, "padding": 0}]
    params["network"]["mlp"]["units"] = [16]
    params["config"].update(num_actors=NUM_ACTORS, horizon_length=HORIZON, minibatch_size=32,
                            mini_epochs=2, schedule_type=schedule_type)
    return params


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def jax_run():
    """A JAX agent, its initial state, one rollout from it (numpy), and the
    uniforms behind each rollout step's categorical sample."""
    jagent = JPPOAgent("jax", catcher_params())
    jstate = jagent.init_state()
    after, traj, last_values, _ = jax.jit(jagent._rollout)(jstate)
    rng, uniforms = jstate.rng, []
    tiny = jnp.finfo(jnp.float32).tiny
    for _ in range(HORIZON):  # the rollout's key schedule: rng, akey = split(rng)
        rng, akey = jax.random.split(rng)
        uniforms.append(np.asarray(jax.random.uniform(akey, (NUM_ACTORS, 3), minval=tiny, maxval=1.0)))
    return jagent, jstate, after, to_np(traj), np.asarray(last_values), uniforms


def port_agent(jstate, params=None):
    """A port agent (CPU) holding the JAX state's weights, normalizer stats,
    env state and LR."""
    agent = PPOAgent("port", params or catcher_params(), device="cpu")
    state = agent.init_state()
    agent.model.load_state_dict(jax_to_state_dict(to_np(jstate.params), to_np(jstate.norm)))
    est = jstate.env_state.estate
    state.env_state.estate = CatchState(ball_row=t(est.ball_row), ball_col=t(est.ball_col),
                                        paddle_col=t(est.paddle_col))
    state.env_state.steps = t(jstate.env_state.steps)
    state.obs, state.dones, state.lr = t(jstate.obs), t(jstate.dones), t(jstate.lr)
    return agent, state


def test_rollout_matches_jax(jax_run, monkeypatch):
    _, jstate, after, traj, last_values, uniforms = jax_run
    # 8 steps from fresh episodes: no ball reaches the bottom row (15 steps),
    # so no env resets (resets draw from the frameworks' own generators)
    assert not traj["dones"][1:].any() and not np.asarray(after.dones).any()
    noise = iter(t(u) for u in uniforms)
    monkeypatch.setattr(D, "categorical_sample",
                        lambda logits, generator=None, mask=None: D.gumbel_max(logits, next(noise), mask))
    agent, state = port_agent(jstate)
    ptraj, plast = agent._rollout(state)
    assert set(ptraj) == {"obses", "dones", "actions", "values", "neglogpacs", "rewards"}
    assert ptraj["actions"].dtype == torch.int64
    np.testing.assert_array_equal(ptraj["actions"].numpy(), traj["actions"])
    np.testing.assert_array_equal(ptraj["obses"].numpy(), traj["obses"])
    np.testing.assert_array_equal(ptraj["dones"].numpy(), traj["dones"])
    tol = dict(rtol=1e-5, atol=1e-5)
    for k in ("values", "neglogpacs", "rewards"):
        np.testing.assert_allclose(ptraj[k].numpy(), traj[k], err_msg=k, **tol)
    np.testing.assert_allclose(plast.numpy(), last_values, **tol)
    # the observations lie env-major, so the dataset's flatten is a view
    assert ptraj["obses"].transpose(0, 1).is_contiguous()


@pytest.mark.parametrize("schedule_type", ["legacy", "standard"])
def test_full_update_matches_jax(jax_run, schedule_type):
    """One epoch's update (2 mini-epochs x 4 minibatches, adaptive LR) from
    the same trajectory. After 8 Adam steps, each dividing a gradient by
    its running RMS, the weights agree within 2e-6 absolute (the LR is
    1e-3: a quarter of a percent of one step), the normalizer stats at
    rtol 1e-5, the loss terms at rtol 1e-4."""
    _, _, after, traj, last_values, _ = jax_run
    jagent = JPPOAgent("jax", catcher_params(schedule_type))
    agent, state = port_agent(after, catcher_params(schedule_type))
    jnew, jm = jax.jit(jagent._finish_epoch)(after, traj, last_values, None)
    state, pm = agent._finish_epoch(state, {k: t(v) for k, v in traj.items()}, t(last_values))
    expected = jax_to_state_dict(to_np(jnew.params), to_np(jnew.norm))
    for name, got in agent.model.state_dict().items():
        tol = dict(rtol=0, atol=2e-6) if name.startswith("a2c_network") else dict(rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), expected[name].numpy(), err_msg=name, **tol)
    np.testing.assert_allclose(float(state.lr), float(jnew.lr), rtol=1e-5)
    jm = to_np(jm)
    for k in ("a_loss", "c_loss", "kl", "entropy", "explained_variance"):
        np.testing.assert_allclose(float(pm[k]), jm[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert float(pm["b_loss"]) == 0.0
    assert int(state.epoch) == 1 and int(state.frame) == NUM_ACTORS * HORIZON


def cartpole_params(train_dir, fused):
    params = load("ppo_cartpole.yaml")["params"]
    params["network"]["mlp"]["fused"] = fused
    params["config"].update(train_dir=str(train_dir), max_epochs=4,
                            player={"games_num": 8, "max_steps": 520, "deterministic": True})
    return params


@pytest.fixture(scope="module")
def cartpole_runs(tmp_path_factory):
    """ppo_cartpole.yaml, 4 epochs, plain and with mlp.fused: true, each
    trained and its last checkpoint played through Runner on the CPU."""
    runs = {}
    for fused in (False, True):
        train_dir = tmp_path_factory.mktemp(f"fused{fused}")
        runner = Runner(device="cpu")
        runner.load({"params": cartpole_params(train_dir, fused)})
        gae.gae_launches = fused_mlp.fused_mlp_launches = 0
        _, epochs = runner.run({"train": True})
        nn_dir = train_dir / "cartpole_ppo" / "nn"
        last = [n for n in os.listdir(nn_dir) if "_rew_" in n]
        reward = runner.run({"play": True, "checkpoint": str(nn_dir / last[0])})
        runs[fused] = (runner, epochs, last, reward, (gae.gae_launches, fused_mlp.fused_mlp_launches),
                       torch.load(nn_dir / last[0], weights_only=False)["model"])
    return runs


@pytest.mark.parametrize("fused", [False, True])
def test_cartpole_trains_and_plays_through_runner(cartpole_runs, fused):
    runner, epochs, last, reward, launches, weights = cartpole_runs[fused]
    assert epochs == 4 and len(last) == 1
    # 520 steps: every env ends an episode (500 steps at most), each step paying 1
    assert np.isfinite(reward) and reward > 0
    # CPU tensors take the plain versions: no kernel launched
    assert launches == (0, 0)
    player = runner.create_player()
    assert type(player.model.a2c_network.actor_mlp).__name__ == ("FusedMLP" if fused else "Sequential")


def test_fused_and_plain_cartpole_train_alike(cartpole_runs):
    """On the CPU the fused torso runs the plain chain: the two runs end
    with the same weights (float32, one thread)."""
    plain, fused = cartpole_runs[False][-1], cartpole_runs[True][-1]
    assert plain.keys() == fused.keys()
    for k in plain:
        torch.testing.assert_close(fused[k], plain[k], rtol=1e-5, atol=1e-6)


def test_discrete_player_is_argmax_when_deterministic(tmp_path):
    player = PpoPlayer(cartpole_params(tmp_path, False), device="cpu")
    obs = torch.randn((32, 4), generator=torch.Generator().manual_seed(0))
    actions = player._play_actions(None, obs)
    with torch.no_grad():
        logits = player.model.a2c_network(obs)["logits"]
    torch.testing.assert_close(actions, torch.argmax(logits, -1), rtol=0, atol=0)
    player.deterministic = False
    sampled = player._play_actions(torch.Generator().manual_seed(1), obs)
    assert sampled.dtype == torch.int64 and set(sampled.tolist()) <= {0, 1}


def test_pong_config_trains_and_plays_through_the_cli(tmp_path):
    """ppo_pong_device.yaml shrunk to 4 envs, horizon 4 and minibatch 8:
    one epoch through ``python -m rl_games_tpu_torch --train``, then
    ``--play`` of its checkpoint, on the CPU."""
    config = load("ppo_pong_device.yaml")
    config["params"]["config"].update(num_actors=4, horizon_length=4, minibatch_size=8, max_epochs=1,
                                      train_dir=str(tmp_path / "runs"),
                                      player={"games_num": 1, "max_steps": 6, "deterministic": True})
    cfg = tmp_path / "pong.yaml"
    cfg.write_text(yaml.safe_dump(config))
    env = {**os.environ, "PYTHONPATH": str(ROOT), "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    base = [sys.executable, "-m", "rl_games_tpu_torch", "--device", "cpu", "-f", str(cfg)]
    train = subprocess.run(base + ["--train"], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert train.returncode == 0, train.stderr[-3000:]
    assert " epoch: 1/1 frames: 16" in train.stdout
    nn_dir = tmp_path / "runs" / "DevicePong_ppo" / "nn"
    final = [n for n in os.listdir(nn_dir) if "_rew_" in n]
    assert len(final) == 1
    play = subprocess.run(base + ["--play", "-c", str(nn_dir / final[0])], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert play.returncode == 0, play.stderr[-3000:]
    assert "av reward: " in play.stdout


def test_entry_points_set_full_float32_for_a_card(monkeypatch):
    """A player built for a CUDA device turns TF32 off for matrix products
    and for cuDNN's convolutions before it touches the device (here, with
    no card, the build then fails at the first CUDA tensor)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    params = load("ppo_pong_device.yaml")["params"]
    try:
        PpoPlayer(params, device=torch.device("cuda"))
    except (RuntimeError, AssertionError):
        assert not torch.cuda.is_available()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_trainer_sets_full_float32_for_a_card(monkeypatch):
    """So does a trainer built for a CUDA device."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    params = load("ppo_pong_device.yaml")["params"]
    try:
        PPOAgent("tf32", params, device=torch.device("cuda"))
    except (RuntimeError, AssertionError):
        assert not torch.cuda.is_available()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_resolving_a_device_leaves_the_precision(monkeypatch):
    """Resolving a device sets nothing: the precision is the entry points'
    own call (``use_full_float32``)."""
    from rl_games_tpu_torch.utils.device import resolve_device, use_full_float32

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert resolve_device("cuda") == torch.device("cuda")
    assert torch.backends.cudnn.allow_tf32 is True
    use_full_float32(torch.device("cpu"))
    assert torch.backends.cudnn.allow_tf32 is True
    use_full_float32(torch.device("cuda"))
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (False, False)
