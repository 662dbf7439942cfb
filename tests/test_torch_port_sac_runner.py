"""The port's SAC through its entry points on the CPU: ``Runner`` train,
resume and play of a shrunk sac_pendulum.yaml, ``python -m
rl_games_tpu_torch``, the JAX package's importer on the port's SAC
checkpoint (and its refusal of layer-norm trunks, ROADMAP.md §3 fault 5),
a weights-only warm start, and the refusals (no card, host envs) beside
the normalized torsos that build."""

import copy
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from rl_games_tpu.common.player import SACPlayer as JSACPlayer
from rl_games_tpu_torch.algos.sac import SACAgent, replay_size
from rl_games_tpu_torch.common.player import SACPlayer
from rl_games_tpu_torch.runner import Runner
from rl_games_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


def pendulum(train_dir, **config):
    """sac_pendulum.yaml cut to 4 envs, 2 steps an epoch, [16, 16] nets,
    batch 16, 2 warmup epochs; its player to 4 envs and 210 steps (one
    200-step episode each)."""
    params = yaml.safe_load((ROOT / "rl_games_tpu" / "configs" / "sac_pendulum.yaml").read_text())["params"]
    params["network"]["mlp"]["units"] = [16, 16]
    params["config"].update({
        "num_actors": 4, "num_steps_per_episode": 2, "batch_size": 16, "replay_buffer_size": 400,
        "num_warmup_steps": 2, "max_epochs": 4, "save_best_after": 1, "train_dir": str(train_dir),
        "player": {"games_num": 4, "num_actors": 4, "max_steps": 210, "deterministic": True}, **config,
    })
    return params


def test_runner_trains_resumes_and_plays(tmp_path, capsys):
    """Four epochs through Runner.run write the last checkpoint (replay
    stripped) with the reference SAC sections; play restores its actor; a
    resume continues the counters with the update gate raised."""
    params = pendulum(tmp_path)
    runner = Runner(device="cpu")
    runner.load({"params": params})
    _, epochs = runner.run({"train": True, "sigma": 0.5})  # --sigma is a PPO knob: ignored
    out = capsys.readouterr().out
    assert epochs == 4 and "fps: " in out and " epoch: 4 frames: 32" in out and "MAX EPOCHS NUM!" in out
    assert runner.create_agent().num_updates_per_step == 1  # utd 0.25 x 4 envs
    nn_dir = tmp_path / "pendulum_sac" / "nn"
    last = nn_dir / "last_pendulum_sac_ep_4.pth"
    payload = ckpt.read_payload(str(last))
    assert {"state", "meta", "actor", "critic", "critic_target", "log_alpha", "running_mean_std"} <= set(payload)
    assert payload["meta"] == {"last_mean_rewards": -100500.0, "epoch": 4, "frame": 32, "has_replay": False}
    assert payload["state"]["replay"]["obses"].shape == (1, 3)  # the stripped stub
    assert payload["state"]["update_counter"] == 4  # epochs 3 and 4, 2 steps x 1 update
    assert sorted(payload["actor"]) == [f"trunk.{i}.{p}" for i in (0, 2, 4) for p in ("bias", "weight")]

    mean = runner.run({"play": True, "checkpoint": str(last), "sigma": 0.5})
    out = capsys.readouterr().out
    assert "Cannot set new sigma: SAC policy has no fixed sigma parameter" in out
    assert "av reward: " in out and "games played: 4" in out and np.isfinite(mean)
    player = runner.create_player()
    player.restore(str(last))
    for k, v in player.actor.state_dict().items():
        assert torch.equal(v, payload["actor"][k]), k
    assert torch.equal(player.running_mean_std.count, payload["running_mean_std"]["count"])

    resumed = copy.deepcopy(params)
    resumed["config"]["max_epochs"] = 6
    agent = SACAgent("resume", resumed, device="cpu")
    agent.train(checkpoint=str(last))
    assert agent.last_state.epoch == 6 and agent.last_state.frame == 48
    assert agent._update_min_fill == 20  # replay_resume_min_fill: 400 // 20
    assert replay_size(agent.last_state.replay) == 16 and agent.last_state.update_counter == 4


def test_cli_trains_and_plays(tmp_path):
    """python -m rl_games_tpu_torch --train, then --play with the file it
    wrote, on a temporary YAML with --device cpu."""
    params = pendulum(tmp_path / "runs", max_epochs=3)
    cfg = tmp_path / "sac.yaml"
    cfg.write_text(yaml.safe_dump({"params": params}))
    env = {**os.environ, "PYTHONPATH": str(ROOT), "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    base = [sys.executable, "-m", "rl_games_tpu_torch", "--device", "cpu", "-f", str(cfg)]
    train = subprocess.run(base + ["--train", "--seed", "11"], cwd=tmp_path, env=env,
                           capture_output=True, text=True, timeout=300)
    assert train.returncode == 0, train.stderr[-3000:]
    assert " epoch: 3 frames: 24" in train.stdout
    last = tmp_path / "runs" / "pendulum_sac" / "nn" / "last_pendulum_sac_ep_3.pth"
    play = subprocess.run(base + ["--play", "-c", str(last)], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert play.returncode == 0, play.stderr[-3000:]
    assert "av reward: " in play.stdout and "games played: 4" in play.stdout


def test_jax_importer_reads_port_checkpoint(tmp_path):
    """The JAX SACPlayer restores the port's SAC checkpoint through
    convert_sac_weights, and its deterministic actions are the port
    player's (rtol 1e-5, atol 1e-6)."""
    params = pendulum(tmp_path, max_epochs=3)
    agent = SACAgent("a", params, device="cpu")
    agent.train()
    last = str(tmp_path / "pendulum_sac" / "nn" / "last_pendulum_sac_ep_3.pth")
    port, jplayer = SACPlayer(params, device="cpu"), JSACPlayer(params)
    port.restore(last)
    jplayer.restore(last)
    obs = np.random.default_rng(5).standard_normal((32, 3)).astype(np.float32) * 2
    with torch.no_grad():
        got = port._play_actions(None, torch.from_numpy(obs))
    want = jplayer._sac_actions(jax.random.PRNGKey(0), obs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(jplayer.obs_rms.count), agent.running_mean_std.count.numpy())


@pytest.mark.parametrize("nested", [False, True], ids=["top_level", "under_model"])
def test_reference_pth_warm_starts(tmp_path, nested):
    """A file with no train state (a reference SAC .pth: the sections at the
    top, or under 'model') warm-starts training: the actor, critic and log
    α are the file's; without a critic_target the target stays the fresh
    one, as in the JAX package."""
    params = pendulum(tmp_path, max_epochs=1, num_warmup_steps=10)  # warmup only: no update
    donor = SACAgent("donor", params, device="cpu")
    state = donor.init_state(seed=123)
    sections = {k: v for k, v in donor.get_weights(state).items() if k != "critic_target"}
    sections["log_alpha"] = torch.tensor(-0.7)
    path = str(tmp_path / "ref.pth")
    torch.save({"model": sections} if nested else sections, path)
    agent = SACAgent("warm", params, device="cpu")
    agent.train(checkpoint=path)
    for module, name in ((agent.actor, "actor"), (agent.critic, "critic")):
        for k, v in module.state_dict().items():
            assert torch.equal(v, sections[name][k]), (name, k)
    fresh = SACAgent("fresh", params, device="cpu")
    fresh.init_state()
    for a, b in zip(agent.critic_target.parameters(), fresh.critic_target.parameters()):
        assert torch.equal(a, b)
    assert float(agent.last_state.log_alpha) == pytest.approx(-0.7)
    assert agent.last_state.epoch == 1  # a warm start keeps the fresh counters

    no_norm = pendulum(tmp_path, normalize_input=False)
    with pytest.raises(ValueError, match="normalize_input"):
        SACAgent("raw", no_norm, device="cpu").train(checkpoint=path)


def test_entry_points_default_to_the_card(monkeypatch):
    """With no device, SACAgent and SACPlayer take CUDA and raise without
    it; built for a card, both turn TF32 off first."""
    params = pendulum("unused")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: SACAgent("t", params), lambda: SACPlayer(params)):
        with pytest.raises(RuntimeError, match="CUDA device by default"):
            make()
    for make in (lambda: SACAgent("t", params, device="cuda"), lambda: SACPlayer(params, device="cuda")):
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
        try:
            make()
        except (RuntimeError, AssertionError):
            pass  # no card: the first CUDA tensor fails
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (False, False)


@pytest.mark.parametrize("make, item", [
    (lambda p: SACAgent("t", {**p, "config": {**p["config"], "vecenv_type": "MULTIWALKER"}}, device="cpu"),
     "SAC takes one agent an env"),
    (lambda p: SACPlayer({**p, "config": {**p["config"], "vecenv_type": "CONNECT4"}}, device="cpu"),
     "SAC requires a continuous action space"),
    (lambda p: SACAgent("t", {**p, "network": {**p["network"], "normalization": "layer_norm"}}, device="cpu"), None),
    (lambda p: SACAgent("t", {**p, "network": {**p["network"], "normalization": "layer_norm",
                                               "mlp": {**p["network"]["mlp"], "d2rl": True}}}, device="cpu"), None),
], ids=["host_env_agent", "host_env_player", "normalization", "d2rl"])
def test_unported_sac_options_raise(make, item):
    """The multi-agent and self-play host envs (A12's second part) build,
    and SAC stops at them with its own ValueError, as the JAX package's SAC
    fails there: multiwalker's 3 walkers an env (the JAX SAC reshapes the
    N · A rewards to [num_actors]), connect four's discrete actions. The
    normalized torsos A8 (a) ported (item None: plain and D2RL) build their
    LayerNorms and run an update epoch (their updates against the JAX
    package: test_torch_port_sac.py::test_layer_norm_update_matches_jax)."""
    if item is not None:
        with pytest.raises(ValueError, match=item):
            make(pendulum("unused"))
        return
    agent = make(pendulum("unused", num_warmup_steps=1))
    norms = [m for m in agent.actor.modules() if isinstance(m, torch.nn.LayerNorm)]
    assert len(norms) == 2
    state = agent.init_state()
    for _ in range(2):
        state, metrics = agent.train_epoch(state)
    assert state.update_counter > 0 and np.isfinite(float(metrics["critic_loss"]))


def test_jax_importer_refuses_layer_norm_trunks(tmp_path):
    """ROADMAP.md §3, fault 5 (latent, in the JAX package): convert_sac_weights
    collects every key of a trunk that ends in '.weight' as a Linear
    (torch_import.py:626-635), a LayerNorm's too, and _fill_seq_module pairs
    those four with the JAX trunk's four scopes (Dense_0, LayerNorm_0,
    Dense_1, LayerNorm_1), so it refuses the reference layout of a
    layer-norm SAC checkpoint that the port writes with a KeyError on the
    'Dense_0' inside LayerNorm_0. The port's own reader restores it."""
    from rl_games_tpu.models.sac import build_sac_networks as jbuild_sac_networks
    from rl_games_tpu.utils.torch_import import convert_sac_weights

    params = pendulum(tmp_path, max_epochs=3, normalize_input=False)
    params["network"]["normalization"] = "layer_norm"
    agent = SACAgent("a", params, device="cpu")
    agent.train()
    last = str(tmp_path / "pendulum_sac" / "nn" / "last_pendulum_sac_ep_3.pth")
    raw = ckpt.read_payload(last)
    jactor, jcritic = jbuild_sac_networks(params["network"], 1)
    obs, act = np.zeros((1, 3), np.float32), np.zeros((1, 1), np.float32)
    ja, jc = jactor.init(jax.random.PRNGKey(0), obs), jcritic.init(jax.random.PRNGKey(1), obs, act)
    with pytest.raises(KeyError, match="Dense_0"):
        convert_sac_weights(raw, ja, jc)
    player = SACPlayer(params, device="cpu")
    player.restore(last)
    for k, v in player.actor.state_dict().items():
        assert torch.equal(v, agent.actor.state_dict()[k]), k
