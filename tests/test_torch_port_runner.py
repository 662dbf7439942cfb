"""The port's normal entry points on the CPU: checkpoints
(utils/checkpoint.py), ``PPOAgent.train``, ``Runner`` and
``python -m rl_games_tpu_torch``, on a tiny fused Ant2D config."""

import copy
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from rl_games_tpu.models.model_builder import ModelBuilder as JModelBuilder
from rl_games_tpu.utils.torch_import import convert_a2c_state_dict, load_torch_state_dict
from rl_games_tpu_torch.algos.ppo import PPOAgent
from rl_games_tpu_torch.runner import Runner, _resolve_stop_fn
from rl_games_tpu_torch.utils import checkpoint as ckpt
from rl_games_tpu_torch.utils import writer as port_writer
from rl_games_tpu_torch.utils.observers import AlgoObserver

from test_torch_port_ppo import flagship_params

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


def tiny_params(train_dir, **config):
    params = flagship_params(8)
    params["seed"] = 5
    params["network"]["mlp"]["fused"] = True
    params["config"].update({
        "name": "tiny", "train_dir": str(train_dir), "max_epochs": 2, "minibatch_size": 64,
        "player": {"games_num": 4, "max_steps": 25, "num_actors": 4}, **config,
    })
    return params


def plain_leaves(tree, prefix=""):
    """(path, tensor) leaves of a tree_to_plain result (the train state's
    unused options, None, have none)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from plain_leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from plain_leaves(v, f"{prefix}/{i}")
    elif tree is not None:
        yield prefix, tree


def test_checkpoint_round_trip_and_resume(tmp_path):
    """Save after one epoch; a fresh agent that loads the file holds every
    tensor of the state bit for bit, and its next epoch equals the next
    epoch of the agent that trained on (CPU, one thread, fixed seeds)."""
    params = tiny_params(tmp_path)
    agent = PPOAgent("a", params, device="cpu")
    state, _ = agent.train_epoch(agent.init_state())
    path = str(tmp_path / "nn" / "one.pth")
    ckpt.save_checkpoint(path, state, {"epoch": 1, "frame": 128, "last_mean_rewards": -3.0},
                         weights=agent.get_weights())
    assert not os.path.exists(path + ".tmp")
    saved = dict(plain_leaves(ckpt.tree_to_plain(state)))
    saved_weights = agent.get_weights()
    state, metrics = agent.train_epoch(state)

    assert ckpt.peek_meta(path) == {"epoch": 1, "frame": 128, "last_mean_rewards": -3.0}
    other = PPOAgent("b", params, device="cpu")
    example = other.init_state(seed=99)  # other weights, env state and noise
    payload = ckpt.read_payload(path)
    restored, meta = ckpt.load_checkpoint(path, example, payload=payload)
    weights, _ = ckpt.load_checkpoint_weights(path, payload=payload)
    other.set_weights(weights)
    assert meta["epoch"] == 1
    got = dict(plain_leaves(ckpt.tree_to_plain(restored)))
    assert sorted(got) == sorted(saved) and len(saved) > 30
    for k in saved:
        assert torch.equal(got[k], saved[k]), k
    for k, v in other.model.state_dict().items():
        assert torch.equal(v, saved_weights[k]), k
    restored, metrics2 = other.train_epoch(restored)
    for k, v in agent.model.state_dict().items():
        assert torch.equal(other.model.state_dict()[k], v), k
    for k in ("a_loss", "c_loss", "kl", "lr", "mean_rewards", "frame"):
        assert torch.equal(metrics2[k], metrics[k]), k
    assert torch.equal(restored.obs, state.obs)

    # the full-state pair (a2c_common.py:650-688)
    full = agent.get_full_state_weights(state, last_mean_rewards=1.5)
    assert full["epoch"] == 2 and full["frame"] == 256 and full["last_mean_rewards"] == 1.5
    third = PPOAgent("c", params, device="cpu")
    st = third.set_full_state_weights(third.init_state(seed=3), full, set_epoch=False)
    assert int(st.epoch) == 0 and torch.equal(st.obs, state.obs)
    assert torch.equal(third.model.state_dict()["a2c_network.mu.weight"],
                       agent.model.state_dict()["a2c_network.mu.weight"])
    cleared = third.clear_stats(st)
    assert int(cleared.game_rewards.count) == 0 and float(cleared.current_lengths.sum()) == 0.0

    with pytest.raises(ValueError, match="shape"):
        ckpt.load_checkpoint(path, PPOAgent("d", flagship_params(4), device="cpu").init_state())


def test_jax_importer_reads_port_checkpoint(tmp_path):
    """The JAX package's own torch importer reads the port's file ('model' is
    a reference-layout state_dict) and its params give the same forward
    (rtol 1e-5, atol 1e-5)."""
    params = tiny_params(tmp_path)
    agent = PPOAgent("a", params, device="cpu")
    state, _ = agent.train_epoch(agent.init_state())
    path = str(tmp_path / "p.pth")
    ckpt.save_checkpoint(path, state, {}, weights=agent.get_weights())
    sd = load_torch_state_dict(path)
    assert sorted(sd) == sorted(agent.model.state_dict())
    kw = dict(actions_num=8, input_shape=(26,), normalize_input=True, normalize_value=True)
    jmodel = JModelBuilder().load(params, **kw)
    jparams, norm = jmodel.init(jax.random.PRNGKey(0), np.zeros((4, 26), np.float32))
    jparams, norm = convert_a2c_state_dict(sd, jparams, norm, params["network"], (26,))
    obs = np.random.default_rng(1).normal(size=(16, 26)).astype(np.float32)
    jp = jmodel.forward_play(jparams, norm, jax.random.PRNGKey(0), obs, deterministic=True)
    with torch.no_grad():
        pp = agent.model.forward_play(torch.from_numpy(obs), deterministic=True)
    for k in ("actions", "values", "sigmas"):
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-5, err_msg=k)


def test_weights_only_file_is_refused_as_state(tmp_path):
    path = str(tmp_path / "w.pth")
    torch.save({"model": {"w": torch.zeros(2)}}, path)
    assert ckpt.load_checkpoint_weights(path)[0]["w"].shape == (2,)
    with pytest.raises(ValueError, match="no train state"):
        ckpt.load_checkpoint(path, {})
    torch.save({"state": {}}, path)
    with pytest.raises(ValueError, match="no weights section"):
        ckpt.load_checkpoint_weights(path)


def test_safe_filesystem_op_retries():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("busy")
        return "done"

    assert ckpt.safe_filesystem_op(flaky) == "done" and len(calls) == 3
    with pytest.raises(OSError):
        ckpt.safe_filesystem_op(lambda: (_ for _ in ()).throw(OSError("gone")), num_attempts=1)


def test_runner_trains_checkpoints_and_plays(tmp_path, capsys):
    """Two epochs through Runner.run: the three kinds of checkpoint are
    written, the log line has the reference's form, run_play restores the
    last one and returns a finite mean, and training resumes from it."""
    params = tiny_params(tmp_path, save_frequency=1, save_best_after=1)
    runner = Runner(device="cpu")
    runner.load({"params": params})
    last_mean, epochs = runner.run({"train": True})
    out = capsys.readouterr().out
    assert epochs == 2 and "Started to train" in out and "MAX EPOCHS NUM!" in out
    assert "fps total: " in out and " epoch: 2/2 frames: 256 rew: " in out
    nn_dir = tmp_path / "tiny" / "nn"
    names = sorted(os.listdir(nn_dir))
    assert "last_tiny_ep_1.pth" in names and "last_tiny_ep_2.pth" in names  # save_frequency
    assert "tiny.pth" in names  # best so far
    final = [n for n in names if n.startswith("last_tiny_ep_2_rew_")]
    assert len(final) == 1  # written at exit
    assert np.isfinite(last_mean) and last_mean > -100500.0
    assert ckpt.peek_meta(str(nn_dir / "tiny.pth"))["last_mean_rewards"] == last_mean

    mean = runner.run({"play": True, "checkpoint": str(nn_dir / final[0])})
    out = capsys.readouterr().out
    assert "Started to play" in out and "av reward: " in out and np.isfinite(mean)
    player = runner.create_player()
    player.restore(str(nn_dir / final[0]))
    trained = torch.load(str(nn_dir / final[0]), weights_only=True)["model"]
    for k, v in player.model.state_dict().items():
        assert torch.equal(v, trained[k]), k

    resumed = copy.deepcopy(params)
    resumed["config"]["max_epochs"] = 3
    runner2 = Runner(device="cpu")
    runner2.load({"params": resumed})
    _, epochs = runner2.run({"train": True, "checkpoint": str(nn_dir / "last_tiny_ep_2.pth"), "sigma": -0.5})
    assert epochs == 3 and " epoch: 3/3 frames: 384" in capsys.readouterr().out


def stop_after_one(agent):
    return int(agent.last_state.epoch) >= 1


@pytest.mark.parametrize("stop_fn", [stop_after_one, "test_torch_port_runner:stop_after_one",
                                     "test_torch_port_runner.stop_after_one"])
def test_stop_fn(tmp_path, capsys, stop_fn):
    params = tiny_params(tmp_path, max_epochs=5)
    runner = Runner(device="cpu")
    runner.load({"params": params})
    _, epochs = runner.run({"train": True, "stop_fn": stop_fn})
    assert epochs == 1 and "Custom stop condition met!" in capsys.readouterr().out


def test_resolve_stop_fn_errors():
    assert _resolve_stop_fn(None) is None
    with pytest.raises(ValueError, match="callable or"):
        _resolve_stop_fn(3)
    with pytest.raises(ValueError, match="module attribute"):
        _resolve_stop_fn("nomodule")
    with pytest.raises(ValueError, match="not callable"):
        _resolve_stop_fn("os:sep")


def test_load_config_seed_rules(tmp_path):
    runner = Runner(device="cpu")
    params = tiny_params(tmp_path)
    runner.load({"params": params})
    assert runner.seed == 5 and runner.params["config"]["seed"] == 5
    assert runner.params["config"]["reward_shaper"] == {}
    del params["seed"]
    runner.load({"params": params})
    assert 0 <= runner.seed < 2**16
    params["seed"] = -1
    params["config"]["import_modules"] = ["json"]
    runner.load({"params": params})
    assert 0 <= runner.seed < 1000000


def test_log_interval_and_max_frames(tmp_path, capsys):
    """Only log epochs print; max_frames ends the run."""
    params = tiny_params(tmp_path, max_epochs=-1, max_frames=384, log_interval=2)
    agent = PPOAgent("run", params, device="cpu")
    records = []

    class Recorder(port_writer.NoopWriter):
        def add_scalar(self, tag, value, step):
            records.append((tag, step))

    _, epochs = agent.train(writer=Recorder())
    out = capsys.readouterr().out
    assert epochs == 3 and "MAX FRAMES NUM!" in out
    assert " epoch: 2 frames: 256" in out and " epoch: 3 frames: 384" in out and " epoch: 1 " not in out
    tags = {tag for tag, _ in records}
    assert {"performance/step_fps", "losses/a_loss", "losses/bounds_loss", "info/last_lr", "info/kl",
            "info/explained_variance", "rewards/step", "episode_lengths/iter"} <= tags
    assert {step for tag, step in records if tag == "losses/a_loss"} == {256, 384}


def test_interval_writer_throttles():
    records = []

    class Recorder(port_writer.NoopWriter):
        def add_scalar(self, tag, value, step):
            records.append(step)

    w = port_writer.IntervalSummaryWriter(Recorder(), {"defer_summaries_sec": 0, "summaries_interval_sec_min": 1000})
    w.add_scalar("a", 1.0, 0)  # step 0 is dropped
    w.add_scalar("a", 1.0, 10)
    w.tick()
    w.add_scalar("a", 1.0, 20)  # inside the interval
    assert records == [10]
    assert isinstance(port_writer.create_writer(None), port_writer.NoopWriter)


def test_cli_end_to_end(tmp_path):
    """python -m rl_games_tpu_torch --train, then --play with the file it
    wrote, on a temporary YAML with --device cpu."""
    import yaml

    params = tiny_params(tmp_path / "runs")
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(yaml.safe_dump({"params": params}))
    env = {**os.environ, "PYTHONPATH": str(ROOT), "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    base = [sys.executable, "-m", "rl_games_tpu_torch", "--device", "cpu", "-f", str(cfg)]
    train = subprocess.run(base + ["--train", "-na", "4", "--seed", "11"], cwd=tmp_path, env=env,
                           capture_output=True, text=True, timeout=300)
    assert train.returncode == 0, train.stderr[-3000:]
    assert " epoch: 2/2 frames: 128" in train.stdout  # -na 4: 4 envs x horizon 16
    nn_dir = tmp_path / "runs" / "tiny" / "nn"
    final = [n for n in os.listdir(nn_dir) if "_rew_" in n]
    assert len(final) == 1
    play = subprocess.run(base + ["--play", "-c", str(nn_dir / final[0])], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert play.returncode == 0, play.stderr[-3000:]
    assert "av reward: " in play.stdout and "games played: " in play.stdout


@pytest.mark.parametrize("args, params_patch, item", [
    ({"train": True, "seeds": "1,2"}, {}, "seeds"),
    ({"export": True}, {}, "A12"),
    ({"train": True, "load_critic_only": True}, {}, None),
    ({"train": True}, {"algo": {"name": "sac"},
                       "config": {"env_name": "multiwalker_env", "num_actors": 2}}, "SAC takes one agent an env"),
    ({"play": True}, {"algo": {"name": "sac"},
                      "config": {"env_name": "connect4_env", "num_actors": 2}}, "SAC requires a continuous action"),
], ids=["args0-params_patch0-A12", "args1-params_patch1-A12", "args2-params_patch2-A9", "args3-params_patch3-A12",
        "args4-params_patch4-A12"])
def test_unported_verbs_raise(tmp_path, args, params_patch, item):
    """The verbs the port lacks name their item (export, A12);
    load_critic_only (item None, A9) without a checkpoint trains, as the
    JAX runner does, and --seeds (A12) trains both members and returns
    their checkpoints. The multiwalker and connect-four envs came with
    A12's second part: SAC stops at them with its own ValueError, as the
    JAX package's SAC fails there (N · A rows; discrete actions)."""
    params = {**tiny_params(tmp_path), **params_patch}
    runner = Runner(device="cpu")
    runner.load({"params": params})
    if item is None:
        assert runner.run(args)[1] == 2
        return
    if item == "seeds":
        paths = runner.run(args)
        assert paths == [str(tmp_path / "tiny" / "nn" / f"tiny_seed{s}.pth") for s in (1, 2)]
        assert all(ckpt.peek_meta(p)["epoch"] == 2 for p in paths)
        return
    if item.startswith("SAC"):
        with pytest.raises(ValueError, match=item):
            runner.run(args)
        return
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        runner.run(args)


@pytest.mark.parametrize("key, value, item", [
    ("pbt", {"enabled": True, "interval_steps": 128}, "pbt"),
    ("self_play_config", {"update_score": -100, "games_to_check": 0, "env_update_num": 2}, "A12"),
    ("normalize_rms_advantage", True, None),
    ("features", {"soft_augmentation": {"transform": {"name": "gaussian_noise"}}}, None),
], ids=["pbt-value0-A12", "self_play_config-value1-A12", "normalize_rms_advantage-True-A2", "features-value3-A9"])
def test_unported_train_options_raise(tmp_path, capsys, key, value, item):
    """None of these train options is refused now: the ones A2 and A9
    ported (item None) train; pbt.enabled (A12) trains its 2 epochs with its
    record in the workspace under train_dir and no adoption (it is the
    population's only member); self_play_config (A12's second part) trains
    2 epochs on competitive_forage with a plain MLP and pushes into the
    opponents' slots after each; the fused MLP is refused on the opponent
    seat (A14)."""
    params = tiny_params(tmp_path, **{key: value})
    runner = Runner(device="cpu")
    runner.load({"params": params})
    if item is None:
        assert runner.run({"train": True})[1] == 2
        return
    if item == "pbt":
        assert runner.run({"train": True})[1] == 2
        record = torch.load(tmp_path / "pbt_workspace" / "policy_000.pbt", weights_only=True)
        assert record["frame"] == 2 * 128 and set(record["params"]) == {"learning_rate", "entropy_coef"}
        assert os.listdir(tmp_path / "pbt_workspace") == ["policy_000.pbt"]
        return
    params["config"]["env_name"] = "competitive_forage"
    runner = Runner(device="cpu")
    runner.load({"params": params})
    with pytest.raises(NotImplementedError, match=r"mlp\.fused .*item A14"):
        runner.run({"train": True})
    params["network"]["mlp"]["fused"] = False
    runner = Runner(device="cpu")
    runner.load({"params": params})
    capsys.readouterr()
    assert runner.run({"train": True})[1] == 2
    assert capsys.readouterr().out.count("— updating opponent weights") == 2


class HookLog(AlgoObserver):
    """An observer that records the hooks the trainer calls."""

    def __init__(self):
        self.calls = []

    def before_init(self, *args):
        self.calls.append("before_init")

    def after_init(self, algo):
        self.calls.append("after_init")

    def after_epoch(self, metrics):
        self.calls.append("after_epoch")

    def after_print_stats(self, *args):
        self.calls.append("after_print_stats")


@pytest.mark.parametrize("option", ["algo_observer_isaac", "use_diagnostics", "runner_observer"])
def test_observer_options_reach_the_trainer(tmp_path, monkeypatch, option):
    """The options that A6 ported, through Runner.run: a config-selected
    observer, the diagnostics scalars, an observer handed to Runner."""
    from rl_games_tpu_torch.algos import ppo as ppo_module
    from rl_games_tpu_torch.utils.observers import IsaacAlgoObserver

    scalars = []

    class Log(port_writer.NoopWriter):
        def add_scalar(self, tag, value, step):
            scalars.append(tag)

    monkeypatch.setattr(ppo_module, "create_writer", lambda _dir: Log())
    config = {"algo_observer_isaac": {"algo_observer": "isaac"},
              "use_diagnostics": {"use_diagnostics": True}, "runner_observer": {}}[option]
    observer = HookLog() if option == "runner_observer" else None
    runner = Runner(algo_observer=observer, device="cpu")
    runner.load({"params": tiny_params(tmp_path, **config)})
    runner.run({"train": True})
    if option == "algo_observer_isaac":
        assert isinstance(runner.algo_observer, IsaacAlgoObserver)
        assert runner.algo_observer.writer is not None  # after_init ran
    elif option == "use_diagnostics":
        assert {"diagnostics/kl/0", "diagnostics/kl/1", "diagnostics/clip_frac/1",
                "diagnostics/value_rms_var"} <= set(scalars)
    else:
        assert runner.params["config"]["features"]["observer"] is observer
        assert observer.calls == ["before_init", "after_init"] + ["after_epoch", "after_print_stats"] * 2


HEAD_CASES = {
    # ref/ppo_pendulum.yaml's torso: separate trunks, a state-dependent sigma
    "separate_state_sigma": ("ref/ppo_pendulum.yaml", {}, {}),
    "d2rl": ("ref/ppo_pendulum_torch.yaml", {"mlp": {"units": [16, 8], "activation": "elu", "d2rl": True}}, {}),
    "separate_discrete": ("ref/test/test_discrete.yaml", {}, {}),
    "multi_discrete_value2": ("ref/test/test_discrete_multidiscrete_mhv.yaml", {},
                              {"normalize_value": True, "normalize_input": True,
                               "env_config": {"multi_discrete_space": True, "multi_head_value": True}}),
    "separate_cnn": ("ppo_pixelcatcher.yaml", {"separate": True, "mlp": {"units": [16], "activation": "relu"}}, {}),
}


@pytest.mark.parametrize("case", sorted(HEAD_CASES))
def test_jax_importer_reads_port_checkpoint_of_each_head(tmp_path, case):
    """test_jax_importer_reads_port_checkpoint for each torso and head of
    the port: the JAX package's importer reads the port's file and its
    params give the same forward (rtol 1e-5, atol 1e-5). The JAX importer
    looks for a state-dependent sigma head one level deeper
    (sigma/Dense_0, torch_import.py:493-502) than the JAX torso declares it
    (a bare nn.Dense, network_builder.py:300-318); the test nests the JAX
    params alike around the call."""
    import yaml

    from rl_games_tpu_torch.algos.ppo import actor_obs

    name, net_patch, config_patch = HEAD_CASES[case]
    params = yaml.safe_load((ROOT / "rl_games_tpu" / "configs" / name).read_text())["params"]
    params["network"].update(net_patch)
    if "cnn" in params["network"]:
        params["network"]["cnn"]["convs"] = [{"filters": 4, "kernel_size": 4, "strides": 2, "padding": 0}]
    cfg = params["config"]
    cfg.pop("vecenv_type", None)  # the device Pendulum
    env_config = {**cfg.get("env_config", {}), **config_patch.pop("env_config", {})}
    cfg.update(num_actors=4, horizon_length=8, minibatch_size=16, mini_epochs=1, env_config=env_config,
               **config_patch)
    agent = PPOAgent("a", params, device="cpu")
    state, _ = agent.train_epoch(agent.init_state())
    path = str(tmp_path / "p.pth")
    ckpt.save_checkpoint(path, state, {}, weights=agent.get_weights())
    sd = load_torch_state_dict(path)
    assert sorted(sd) == sorted(agent.model.state_dict())
    obs_shape = agent.obs_shape
    kw = dict(actions_num=agent.actions_num, input_shape=obs_shape, value_size=agent.value_size,
              normalize_input=agent.normalize_input, normalize_value=agent.normalize_value)
    jmodel = JModelBuilder().load(params, **kw)
    jparams, norm = jmodel.init(jax.random.PRNGKey(0), np.zeros((4, *obs_shape), np.float32))
    body = jparams["params"]
    nested = isinstance(body.get("sigma"), dict)
    if nested:
        body["sigma"] = {"Dense_0": body["sigma"]}
    jparams, norm = convert_a2c_state_dict(sd, jparams, norm, params["network"], obs_shape)
    if nested:
        jparams["params"]["sigma"] = jparams["params"]["sigma"]["Dense_0"]
    obs = actor_obs(state.obs).numpy()
    jp = jmodel.forward_play(jparams, norm, jax.random.PRNGKey(0), obs, deterministic=True)
    with torch.no_grad():
        pp = agent.model.forward_play(torch.from_numpy(obs), deterministic=True)
    for k in ("actions", "values", "neglogpacs") + (("sigmas",) if agent.is_continuous else ()):
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-5, err_msg=k)
