"""Reading the JAX package's ``.ckpt`` files in the port
(rl_games_tpu_torch/utils/jax_checkpoint.py, utils/jax_params.ppo_jax_state
and sac_jax_state, the agents' and players' restore).

- The decoder gives what ``msgpack.unpackb`` plus flax's
  ``msgpack_restore`` give, leaf for leaf and dtype for dtype, on real JAX
  checkpoint bytes, a bfloat16 leaf (widened to float32), flax's chunked
  arrays and the other msgpack types; the restricted unpickler refuses any
  global but builtins' and numpy's, naming it.
- ppo_cartpole.yaml with the fused MLP and sac_pendulum.yaml (its replay
  shrunk to 64 rows and checkpointed), each trained 2 epochs by the JAX
  package here: every tensor the port restores equals the JAX leaf it maps
  from exactly (the mapping applied to flax's own decode, and direct leaves
  beside it), and the port's player gives the JAX player's deterministic
  actions (discrete: equal; continuous: rtol 1e-5, atol 1e-6).
- ``--train -c x.ckpt`` resumes at the JAX epoch + 1; a replay ring of
  another capacity raises, naming both; without the replay the ring starts
  empty and the update gate rises.
- The committed fixture (tools/write_jax_ckpt_fixture.py) reads.

The recurrent and central-value checkpoints are in
test_torch_port_jax_ckpt_rnn.py.
"""

import glob
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from rl_games_tpu_torch.runner import Runner
from rl_games_tpu_torch.utils import jax_checkpoint as jc
from rl_games_tpu_torch.utils import jax_params as jp

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "jax_ppo_cartpole_fused.ckpt")
TOL = dict(rtol=1e-5, atol=1e-6)


def load_cfg(name):
    with open(os.path.join(ROOT, "rl_games_tpu", "configs", name)) as f:
        return yaml.safe_load(f)


def jax_train(cfg, tmp_path, epochs=2):
    """Train ``cfg`` through the JAX package's Runner; the last checkpoint."""
    from rl_games_tpu.runner import Runner as JRunner

    cfg["params"]["config"].update(train_dir=str(tmp_path / "jax"), max_epochs=epochs, print_stats=False)
    runner = JRunner()
    runner.load(cfg)
    runner.run({"train": True})
    name = cfg["params"]["config"]["name"]
    (path,) = glob.glob(str(tmp_path / "jax" / name / "nn" / f"last_{name}_ep_{epochs}*.ckpt"))
    return path, runner


def flax_decode(path):
    """The reference decode: pickle, then flax's msgpack_restore."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    return {"state": serialization.msgpack_restore(payload["state_bytes"]),
            "weights": serialization.msgpack_restore(payload["weights_bytes"]), "meta": payload["meta"]}


def assert_same_tree(a, b, path="root"):
    """Equal structure, equal leaves, equal dtypes."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), (path, sorted(a), sorted(b))
        for k in b:
            assert_same_tree(a[k], b[k], f"{path}/{k}")
    elif b is None or isinstance(b, (bool, int, float, str, bytes)):
        assert a == b and type(a) is type(b), (path, a, b)
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype, (path, np.asarray(a).dtype, np.asarray(b).dtype)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


def assert_tensors_equal(got: dict, want: dict):
    assert set(got) == set(want), (sorted(set(got) ^ set(want)))
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k


def assert_adam(opt, carried, module):
    """An AdamState against jax_params' moments by parameter name, exactly."""
    names = [n for n, _ in module.named_parameters()]
    assert int(opt.count) == int(carried["count"]) and len(opt.mu) == len(names)
    for name, mu, nu in zip(names, opt.mu, opt.nu):
        assert torch.equal(mu.cpu(), carried["mu"][name]) and torch.equal(nu.cpu(), carried["nu"][name]), name


def test_decoder_equals_msgpack_and_flax(tmp_path, monkeypatch):
    """Every msgpack type flax writes, a bfloat16 leaf, numpy scalars and
    chunked arrays (MAX_CHUNK_SIZE patched down) decode as msgpack and
    flax's msgpack_restore decode them; the fixture's bytes too. A global
    outside builtins and numpy is refused by name."""
    import msgpack

    tree = {"f32": np.arange(12, dtype=np.float32).reshape(3, 4) / 7, "i64": np.array([-(2 ** 40), 3]),
            "u8": np.arange(300, dtype=np.uint8).reshape(-1), "b": np.array([True, False]), "none": None,
            "scalar": np.float32(2.5), "i32": np.int32(-7), "nested": {"0": np.zeros((0, 3)), "1": "text" * 20},
            "ints": {str(i): v for i, v in enumerate([0, 1, 127, 128, 255, 256, 65536, -1, -33, -129, -40000,
                                                      2 ** 40, -(2 ** 40)])},
            "floats": 1.25, "flags": True, "long": "x" * 70000, "blob": b"\x00\x01" * 200}
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 16)
    for data in (serialization.to_bytes(tree),
                 serialization.to_bytes({"w": jnp.linspace(-3, 3, 41).astype(jnp.bfloat16)}),
                 pickle.load(open(FIXTURE, "rb"))["state_bytes"]):
        want = serialization.msgpack_restore(data)
        got = jc.msgpack_restore(data)
        if "w" in want:  # bfloat16 widens to float32
            want = {"w": np.asarray(want["w"]).astype(np.float32)}
        assert_same_tree(got, want)
    raw = serialization.to_bytes({"a": [1, 2.5, None]})
    assert jc.unpackb(raw) == msgpack.unpackb(raw, ext_hook=lambda c, d: None, raw=False)

    numpy_meta = tmp_path / "numpy_meta.ckpt"
    with open(numpy_meta, "wb") as f:  # the JAX trainer's meta may hold numpy scalars and arrays
        pickle.dump({"state_bytes": serialization.to_bytes({"x": np.ones(2)}),
                     "meta": {"last_mean_rewards": np.float32(3.5), "a": np.arange(3)}}, f, protocol=5)
    meta = jc.read_jax_checkpoint(str(numpy_meta))["meta"]
    assert meta["last_mean_rewards"] == np.float32(3.5) and meta["a"].tolist() == [0, 1, 2]
    bad = tmp_path / "bad.ckpt"
    with open(bad, "wb") as f:
        pickle.dump({"state_bytes": b"", "meta": {"x": os.path.join}}, f)
    with pytest.raises(pickle.UnpicklingError, match="posixpath.join"):
        jc.read_jax_checkpoint(str(bad))


def test_fixture_reads():
    """tests/data/jax_ppo_cartpole_fused.ckpt: the JAX package's
    ppo_cartpole.yaml (fused) after 2 epochs; the port's decode equals
    flax's, and its player restores it as the JAX player does."""
    from rl_games_tpu.runner import Runner as JRunner

    got, want = jc.read_jax_checkpoint(FIXTURE), flax_decode(FIXTURE)
    assert got["meta"] == want["meta"] and got["meta"]["epoch"] == 2 and got["meta"]["frame"] == 1024
    assert_same_tree(got["state"], want["state"])
    assert_same_tree(got["weights"], want["weights"])
    cfg = load_cfg("ppo_cartpole.yaml")
    cfg["params"]["network"]["mlp"]["fused"] = True
    assert_players_agree(cfg, FIXTURE, JRunner(), discrete=True)


def assert_players_agree(cfg, path, jrunner, discrete, batch=9):
    """The port's player and the JAX player, each restoring ``path``: their
    deterministic actions on the same observations (a recurrent policy's
    from zero states in both)."""
    jrunner.load(cfg)
    jplayer = jrunner.create_player()
    jplayer.restore(path)
    runner = Runner(device="cpu")
    runner.load(cfg)
    player = runner.create_player()
    player.restore(path)
    obs = (np.random.default_rng(5).normal(size=(batch, *player.obs_shape)) * 2).astype(np.float32)
    with torch.no_grad():
        if hasattr(jplayer, "net_params"):
            want = np.asarray(jplayer.model.forward_play(jplayer.net_params, jplayer.norm, jax.random.PRNGKey(0),
                                                         jnp.asarray(obs), deterministic=True)["actions"])
            got = player.model.forward_play(torch.from_numpy(obs), deterministic=True)["actions"].numpy()
        else:  # SAC: normalize, mu, tanh, rescale, clip
            want = np.asarray(jplayer.make_export_policy()(jnp.asarray(obs)))
            got = player.make_export_policy()(torch.from_numpy(obs)).numpy()
    if discrete:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)
    return player


def test_ppo_cartpole_fused_restores_and_resumes(tmp_path):
    """ppo_cartpole.yaml (fused) trained 2 epochs by the JAX package: the
    agent's restore gives every tensor of the mapping of flax's decode
    (weights, Adam count and moments by name, lr, entropy_coef, epoch,
    frame), a Dense kernel and its moment equal to the JAX leaves
    transposed; the players agree; --train -c resumes at epoch 3, one epoch
    to max_epochs 3, with the JAX meta's reward watermark."""
    from rl_games_tpu.runner import Runner as JRunner

    cfg = load_cfg("ppo_cartpole.yaml")
    cfg["params"]["network"]["mlp"]["fused"] = True
    cfg["params"]["config"].update(num_actors=4, horizon_length=8, minibatch_size=16, mini_epochs=2)
    path, _ = jax_train(cfg, tmp_path)
    ref = flax_decode(path)
    runner = Runner(device="cpu")
    runner.load(cfg)
    agent = runner.create_agent()
    state, meta = agent.restore_jax_checkpoint(path, agent.init_state())
    assert meta == ref["meta"]
    net = cfg["params"]["network"]
    carried = jp.ppo_jax_state(ref["state"], net, (4,))
    assert_tensors_equal(agent.model.state_dict(), carried["model"])
    assert_adam(state.opt_state, carried["opt"], agent.model)
    body, adam = ref["state"]["params"]["params"], jp.find_adam_state(ref["state"]["opt_state"])
    kernel = body["actor_mlp"]["Dense_0"]["Dense_0"]["kernel"]
    np.testing.assert_array_equal(agent.model.state_dict()["a2c_network.actor_mlp.0.weight"].numpy(), kernel.T)
    mu_kernel = adam["mu"]["params"]["actor_mlp"]["Dense_0"]["Dense_0"]["kernel"]
    np.testing.assert_array_equal(state.opt_state.mu[[n for n, _ in agent.model.named_parameters()].index(
        "a2c_network.actor_mlp.0.weight")].numpy(), mu_kernel.T)
    assert float(state.lr) == float(ref["state"]["lr"]) and float(state.entropy_coef) == float(
        ref["state"]["entropy_coef"])
    assert int(state.epoch) == 2 and int(state.frame) == int(ref["state"]["frame"]) == 64
    assert_players_agree(cfg, path, JRunner(), discrete=True)

    epochs = []
    cfg["params"]["config"].update(train_dir=str(tmp_path / "port"), max_epochs=3)
    runner = Runner(device="cpu")
    runner.load(cfg)
    _, epoch = runner.run({"train": True, "checkpoint": path, "stop_fn": lambda a: epochs.append(1) and False})
    assert epoch == 3 and len(epochs) == 1
    assert os.listdir(tmp_path / "port" / "cartpole_ppo" / "nn")[0].startswith("last_cartpole_ppo_ep_3_")


def sac_cfg(replay=64):
    cfg = load_cfg("sac_pendulum.yaml")
    cfg["params"]["config"].update(num_actors=4, num_warmup_steps=1, replay_buffer_size=replay,
                                   replay_buffer_checkpoint=True, batch_size=16)
    return cfg


def test_sac_restores_with_replay(tmp_path):
    """sac_pendulum.yaml (a replay ring of 64 rows, checkpointed) trained 2
    epochs by the JAX package: the sections, the three Adam states, the ring
    and the counters equal the JAX leaves; the players agree; a ring of
    another capacity raises naming both; a checkpoint without the replay
    leaves the ring empty and raises the update gate."""
    from rl_games_tpu.runner import Runner as JRunner

    cfg = sac_cfg()
    path, _ = jax_train(cfg, tmp_path)
    ref = flax_decode(path)
    runner = Runner(device="cpu")
    runner.load(cfg)
    agent = runner.create_agent()
    state, meta = agent.restore_jax_checkpoint(path, agent.init_state())
    assert meta["has_replay"] is True
    carried = jp.sac_jax_state(ref["state"], cfg["params"]["network"])
    sections = agent.get_weights(state)
    for name in ("actor", "critic", "critic_target", "running_mean_std"):
        assert_tensors_equal(sections[name], carried["sections"][name])
    assert float(state.log_alpha) == float(ref["state"]["log_alpha"])
    assert_adam(state.actor_opt, carried["actor_opt"], agent.actor)
    assert_adam(state.critic_opt, carried["critic_opt"], agent.critic)
    alpha = jp.find_adam_state(ref["state"]["alpha_opt"])
    assert float(state.alpha_opt.mu[0]) == float(alpha["mu"]) and float(state.alpha_opt.nu[0]) == float(alpha["nu"])
    replay = ref["state"]["replay"]
    for k in ("obses", "next_obses", "actions", "rewards", "dones", "truncated"):
        np.testing.assert_array_equal(getattr(state.replay, k).numpy(), replay[k], err_msg=k)
    assert (state.replay.idx, state.replay.full) == (int(replay["idx"]), bool(replay["full"]))
    assert (state.epoch, state.frame, state.update_counter) == tuple(
        int(ref["state"][k]) for k in ("epoch", "frame", "update_counter"))
    assert_players_agree(cfg, path, JRunner(), discrete=False)

    other = Runner(device="cpu")
    other.load(sac_cfg(replay=128))
    agent = other.create_agent()
    with pytest.raises(ValueError, match=r"holds 64 rows.*replay_buffer_size is 128"):
        agent.restore_jax_checkpoint(path, agent.init_state())

    payload = pickle.load(open(path, "rb"))
    payload["meta"]["has_replay"] = False
    stripped = str(tmp_path / "stripped.ckpt")
    pickle.dump(payload, open(stripped, "wb"))
    state, _ = agent.restore_jax_checkpoint(stripped, agent.init_state())
    assert (state.replay.capacity, state.replay.idx, state.replay.full) == (128, 0, False)
    assert agent._update_min_fill == agent.replay_resume_min_fill
