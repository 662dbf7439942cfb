"""The port's recurrent torsos against the JAX package.

- ``RNNCore`` (LSTM, GRU, identity; 1 and 2 layers) against the JAX
  ``RNNCore`` from the same weights, with dones at random positions: the
  outputs and the states out within 1e-5 relative, the gradients of a
  loss over both (input, every cell tensor) within 1e-5 relative.
- ``A2CNetwork`` in every wiring (after the MLP, ``before_mlp``,
  ``concat_input`` / ``concat_output``, ``layer_norm``, separate trunks,
  a central value net, the identity core, a continuous head) against the
  JAX ``A2CNetwork`` with the weights carried across: within 1e-5
  relative.
- The port of tests/test_ppo_rnn.py::test_rnn_rollout_update_consistency:
  a sequence minibatch rerun from its snapshot gives back the rollout's
  neglogp.
- One epoch of shrunk ref/test/test_rnn.yaml (separate LSTM trunks, the
  memory task) against the JAX agent, the rollout's categorical draws
  handed over: actions exactly, the policy's outputs, the windows' states
  and the bootstrap at 1e-5; then the update from the JAX trajectory:
  weights at 2e-6 absolute, losses at rtol 1e-4 (test_torch_port_test_envs.py's
  tolerances).
- Fault 4 (ROADMAP §3), pinned: the player's recurrent forward starts
  from zero states at every step, as the JAX player's does.
- A port checkpoint of an RNN actor read by the JAX importer
  (``convert_a2c_state_dict``): the same forward over a sequence.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_games_tpu.algos.ppo import PPOAgent as JPPOAgent
from rl_games_tpu.models import layers as JL
from rl_games_tpu.models.network_builder import A2CNetwork as JA2CNetwork
from rl_games_tpu_torch.algos.ppo import PPOAgent
from rl_games_tpu_torch.models import layers as L
from rl_games_tpu_torch.models.network_builder import A2CNetwork
from rl_games_tpu_torch.utils.jax_params import _rnn_core, jax_to_state_dict
from test_torch_port_test_envs import jax_uniforms, load, port_agent, sample_from, t, to_np

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6


def close(got, want, err_msg="", rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol, err_msg=err_msg)


# ---------------------------------------------------------------------------
# RNNCore
# ---------------------------------------------------------------------------

CORE_CASES = [(kind, layers) for kind in ("lstm", "gru") for layers in (1, 2)] + [("identity", 1)]


def core_inputs(kind, layers, seqs=5, length=6, features=7, units=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(seqs, length, features)).astype(np.float32)
    width = 1 if kind == "identity" else units
    n_states = 2 if kind == "lstm" else 1
    states = tuple(rng.normal(size=(layers, seqs, width)).astype(np.float32) for _ in range(n_states))
    dones = (rng.random((seqs, length)) < 0.3).astype(np.float32)
    dones[0, 3] = 1.0  # a done in mid-sequence
    return x, states, dones


def port_core(kind, layers, features, units, jparams):
    core = L.RNNCore(kind, features, units, layers, device="cpu")
    if kind != "identity":
        sd = {}
        _rnn_core(sd, to_np(jparams)["params"]["stack"], "core")
        core.load_state_dict({k[len("core."):]: v for k, v in sd.items()})
    return core


@pytest.mark.parametrize("kind, layers", CORE_CASES, ids=[f"{k}_{n}" for k, n in CORE_CASES])
def test_rnn_core_matches_jax(kind, layers):
    x, states, dones = core_inputs(kind, layers)
    jcore = JL.RNNCore(kind, 8, layers)
    jparams = jcore.init(jax.random.PRNGKey(1), x, states, dones)
    jout, jstates = jcore.apply(jparams, x, states, dones)
    core = port_core(kind, layers, 7, 8, jparams)
    out, new_states = core(t(x), tuple(t(s) for s in states), t(dones))
    close(out, jout, "out")
    assert len(new_states) == len(jstates)
    for got, want in zip(new_states, jstates):
        close(got, want, "states")
    # no dones and no states: zeros, as the JAX core starts
    jout0, _ = jcore.apply(jparams, x, None, None)
    close(core(t(x))[0], jout0, "zero states")


@pytest.mark.parametrize("kind, layers", CORE_CASES[:4], ids=[f"{k}_{n}" for k, n in CORE_CASES[:4]])
def test_rnn_core_gradients_match_jax(kind, layers):
    """d/d(input, cell tensors) of Σ w·out + Σ v·h_final. The JAX cells
    hold the LSTM's bias once (hidden side) and the GRU's r, z biases once
    (input side): the port's other copy takes no gradient."""
    x, states, dones = core_inputs(kind, layers, seed=3)
    rng = np.random.default_rng(4)
    w = rng.normal(size=(5, 6, 8)).astype(np.float32)
    v = rng.normal(size=(layers, 5, 8)).astype(np.float32)
    jcore = JL.RNNCore(kind, 8, layers)
    jparams = jcore.init(jax.random.PRNGKey(2), x, states, dones)

    def jloss(p, xx):
        out, st = jcore.apply(p, xx, states, dones)
        return jnp.sum(out * w) + jnp.sum(st[0] * v)

    gp, gx = jax.grad(jloss, argnums=(0, 1))(jparams, x)
    core = port_core(kind, layers, 7, 8, jparams)
    xt = t(x).requires_grad_(True)
    out, st = core(xt, tuple(t(s) for s in states), t(dones))
    loss = (out * t(w)).sum() + (st[0] * t(v)).sum()
    gx_port, *gs = torch.autograd.grad(loss, [xt, *core.parameters()])
    grads = dict(zip([n for n, _ in core.named_parameters()], gs))
    close(gx_port, gx, "d/dx", atol=1e-5)
    want = {}
    _rnn_core(want, to_np(gp)["params"]["stack"], "core")
    units = 8
    for name, g in grads.items():
        key = "core." + name
        if "bias_ih" in name and kind == "lstm":
            # flax's one LSTM bias is the hidden side's: bias_ih takes none
            assert not g.any(), name
        elif "bias_hh" in name and kind == "gru":
            # flax's r and z biases are the input side's: only 'hn' here
            assert not g[:2 * units].any(), name
            close(g[2 * units:], want[key].numpy()[2 * units:], name, atol=1e-5)
        else:
            close(g, want[key].numpy(), name, atol=1e-5)


def test_rnn_core_init_draws_like_flax():
    """lecun-normal input kernels (truncated at 2σ), orthogonal recurrent
    blocks per gate, zero biases; from the generator."""
    core = L.RNNCore("lstm", 50, 40, 2, device="cpu")
    core.reset_parameters(torch.Generator().manual_seed(0))
    for k in range(2):
        w_ih, w_hh, b_ih, b_hh = core.rnn.layer(k)
        fan_in = w_ih.shape[1]
        assert float(w_ih.abs().max()) <= 2 * np.sqrt(1 / fan_in) / 0.87962566103423978 + 1e-6
        assert abs(float(w_ih.std()) - np.sqrt(1 / fan_in)) < 0.1 * np.sqrt(1 / fan_in)
        for block in w_hh.split(40):
            torch.testing.assert_close(block @ block.t(), torch.eye(40), atol=1e-5, rtol=0)
        assert not b_ih.any() and not b_hh.any()
    again = L.RNNCore("lstm", 50, 40, 2, device="cpu")
    again.reset_parameters(torch.Generator().manual_seed(0))
    for a, b in zip(core.parameters(), again.parameters()):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# A2CNetwork wirings
# ---------------------------------------------------------------------------

def net_cfg(space="discrete", separate=False, central_value=False, **rnn):
    cfg = {"name": "actor_critic", "separate": separate,
           "mlp": {"units": [16, 12], "activation": "elu", "initializer": {"name": "default"}},
           "rnn": {"name": "lstm", "units": 8, "layers": 1, **rnn}}
    if central_value:
        cfg["central_value"] = True
    elif space == "discrete":
        cfg["space"] = {"discrete": {}}
    else:
        cfg["space"] = {"continuous": {"mu_activation": "None", "sigma_activation": "None",
                                       "sigma_init": {"name": "const_initializer", "val": -0.5},
                                       "fixed_sigma": True}}
    return cfg


WIRINGS = {
    "lstm_after_mlp": net_cfg(),
    "gru_2_layers_before_mlp": net_cfg(name="gru", layers=2, before_mlp=True),
    "concat_input_output_layer_norm": net_cfg(concat_input=True, concat_output=True, layer_norm=True),
    "before_mlp_concat_output": net_cfg(name="gru", before_mlp=True, concat_output=True),
    "separate_layer_norm": net_cfg(separate=True, layer_norm=True),
    "central_value": net_cfg(central_value=True, layers=2),
    "identity": net_cfg(name="identity", layer_norm=True),
    "continuous_separate_gru": net_cfg("continuous", name="gru", separate=True),
}


@pytest.mark.parametrize("wiring", sorted(WIRINGS))
def test_network_wiring_matches_jax(wiring):
    cfg = WIRINGS[wiring]
    seqs, length, obs_dim = 6, 4, 5
    rng = np.random.default_rng(5)
    obs = rng.normal(size=(seqs * length, obs_dim)).astype(np.float32)
    dones = (rng.random(seqs * length) < 0.25).astype(np.float32)
    jnet = JA2CNetwork.create(cfg, 3, (obs_dim,), value_size=2)
    states = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32), jnet.get_default_rnn_state(seqs))
    jparams = jnet.init(jax.random.PRNGKey(3), obs, rnn_states=states, dones=dones, seq_length=length)
    want = jnet.apply(jparams, obs, rnn_states=states, dones=dones, seq_length=length)
    net = A2CNetwork(cfg, 3, (obs_dim,), value_size=2, device="cpu")
    net.load_state_dict({k[len("a2c_network."):]: v for k, v in jax_to_state_dict(to_np(jparams)).items()})
    assert len(net.get_default_rnn_state(seqs)) == len(states)
    with torch.no_grad():
        got = net(t(obs), rnn_states=tuple(t(s) for s in states), dones=t(dones), seq_length=length)
    assert set(got) == set(want)
    for k in want:
        if k == "rnn_states":
            assert len(got[k]) == len(want[k])
            for a, b in zip(got[k], want[k]):
                close(a, b, k)
        else:
            close(got[k], want[k], k)


# ---------------------------------------------------------------------------
# PPO with an RNN
# ---------------------------------------------------------------------------

def rnn_yaml_params(**config):
    """ref/test/test_rnn.yaml (separate LSTM trunks on the memory env) cut
    to 16 envs x 32 steps in windows of 4, minibatches of 128."""
    params = load("ref/test/test_rnn.yaml")
    params["config"].update({"num_actors": 16, "horizon_length": 32, "seq_length": 4, "minibatch_size": 128,
                             "mini_epochs": 2, **config})
    return params


def test_rnn_rollout_update_consistency():
    """Before any gradient step, rerunning a sequence minibatch from its
    snapshot gives back the rollout's neglogp (tests/test_ppo_rnn.py)."""
    agent = PPOAgent("t", rnn_yaml_params(), device="cpu")
    state = agent.init_state()
    traj, last_values = agent._rollout(state)
    assert traj["dones"][1:].any()  # episodes end inside the windows
    dataset = agent._prepare_dataset(state, traj, last_values)
    assert [tuple(x.shape) for x in dataset["rnn_states"]] == [(1, 16 * 8, 64)] * 4
    for start in (0, 2 * agent.minibatch_size):
        mb = agent._minibatch(dataset, start)
        with torch.no_grad():
            res = agent.model.forward_train(mb["obses"], mb["actions"], rnn_states=mb["rnn_states"],
                                            dones=mb["dones"], seq_length=agent.seq_length)
        close(res["prev_neglogp"], mb["old_logp_actions"].numpy(), atol=1e-5)


def test_rnn_epoch_matches_jax(monkeypatch):
    """The rollout over 16 steps (inside the env's 21-step episodes: an
    autoreset would draw from each framework's own generator), then the
    update from a JAX rollout of 32 steps whose envs start at random
    points of their episodes, so that dones fall inside the windows."""
    params = rnn_yaml_params(horizon_length=16, minibatch_size=64)
    jagent = JPPOAgent("jax", params)
    jstate = jagent.init_state()
    after, traj, last_values, snapshots = jax.jit(jagent._rollout)(jstate)
    traj, last_values, snapshots = to_np(traj), np.asarray(last_values), to_np(snapshots)
    sample_from(monkeypatch, jax_uniforms(jstate, 16, (4,)))
    agent, state = port_agent(params, jstate)
    state.rnn_states = tuple(t(s) for s in jstate.rnn_states)
    ptraj, plast = agent._rollout(state)
    np.testing.assert_array_equal(ptraj["actions"].numpy(), traj["actions"])
    np.testing.assert_array_equal(ptraj["dones"].numpy(), traj["dones"])
    for k in ("values", "neglogpacs", "rewards"):
        close(ptraj[k], traj[k], k, rtol=1e-5, atol=1e-5)
    close(plast, last_values, "last values", rtol=1e-5, atol=1e-5)
    assert len(ptraj["rnn_snapshots"]) == 4 and snapshots[1] is None
    for got, want in zip(ptraj["rnn_snapshots"], snapshots[0]):
        close(got, want, "snapshots", rtol=1e-5, atol=1e-5)
    for got, want in zip(state.rnn_states, after.rnn_states):
        close(got, want, "states after", rtol=1e-5, atol=1e-5)

    # the update from a JAX trajectory with dones inside the windows
    params = rnn_yaml_params()
    jagent = JPPOAgent("jax", params)
    jstate = jagent.init_state()
    steps = np.random.default_rng(8).integers(0, 21, 16).astype(np.int32)
    jstate = jstate.replace(env_state=jstate.env_state.replace(steps=jnp.asarray(steps)))
    after, traj, last_values, snapshots = jax.jit(jagent._rollout)(jstate)
    traj, last_values, snapshots = to_np(traj), np.asarray(last_values), to_np(snapshots)
    assert traj["dones"].reshape(8, 4, 16)[:, 1:].any()  # dones inside the windows, not only at their start
    jnew, jm = jax.jit(jagent._finish_epoch)(after, traj, last_values, snapshots)
    agent2, state2 = port_agent(params, after)
    state2.rnn_states = tuple(t(s) for s in after.rnn_states)
    ptraj = {k: t(v) for k, v in traj.items()}
    ptraj["rnn_snapshots"] = tuple(t(s) for s in snapshots[0])
    state2, pm = agent2._finish_epoch(state2, ptraj, t(last_values))
    expected = jax_to_state_dict(to_np(jnew.params), to_np(jnew.norm))
    assert sorted(expected) == sorted(agent2.model.state_dict())
    for name, got in agent2.model.state_dict().items():
        np.testing.assert_allclose(got.numpy(), expected[name].numpy(), rtol=0, atol=2e-6, err_msg=name)
    jm = to_np(jm)
    for k in ("a_loss", "c_loss", "kl", "entropy", "explained_variance"):
        np.testing.assert_allclose(float(pm[k]), jm[k], rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(state2.lr), float(jnew.lr), rtol=1e-5)


def test_player_plays_rnn_with_zero_states_as_jax(monkeypatch):
    """Fault 4 (ROADMAP §3): the JAX player passes no rnn_states
    (player.py:230-255), so its RNNCore starts every step from zeros; the
    port's player does the same. Each step's actions equal a forward from
    explicit zero states (and differ from a forward that carries them), and
    the JAX model's zero-state forward gives the same actions."""
    from rl_games_tpu_torch.common.player import PpoPlayer

    params = rnn_yaml_params(player={"games_num": 4, "deterministic": True})
    player = PpoPlayer(params, device="cpu")
    calls = []
    forward = player.model.forward_play

    def recording(obs, **kw):
        calls.append((obs.clone(), dict(kw)))
        return forward(obs, **kw)

    monkeypatch.setattr(player.model, "forward_play", recording)
    player.max_steps = 30
    player.run()
    assert len(calls) == 30 and all("rnn_states" not in kw for _, kw in calls)
    obs = torch.cat([o for o, _ in calls])
    zeros = player.model.get_default_rnn_state(obs.shape[0])
    with torch.no_grad():
        played = torch.cat([forward(o, deterministic=True)["actions"] for o, _ in calls])
        zero = forward(obs, deterministic=True, rnn_states=zeros)["actions"]
    assert torch.equal(played, zero)
    # the JAX model from the same weights, with no states: the same actions
    jagent = JPPOAgent("jax", params)
    jstate = jagent.init_state()
    player.model.load_state_dict(jax_to_state_dict(to_np(jstate.params), to_np(jstate.norm)))
    res = jagent.model.forward_play(jstate.params, jstate.norm, jax.random.PRNGKey(0), obs.numpy(),
                                    deterministic=True)
    with torch.no_grad():
        np.testing.assert_array_equal(forward(obs, deterministic=True)["actions"].numpy(), np.asarray(res["actions"]))
    # carrying the states gives other actions somewhere (the memory matters)
    with torch.no_grad():
        state, carried = None, []
        for o, _ in calls:
            r = forward(o, deterministic=True, rnn_states=state)
            state = r["rnn_states"]
            carried.append(r["actions"])
    assert not torch.equal(torch.cat(carried), played)


@pytest.mark.parametrize("name", ["ref/test/test_rnn.yaml", "ref/test/test_asymmetric_continuous.yaml",
                                  "ref/ppo_walker_rnn.yaml"])
def test_jax_importer_reads_port_rnn_checkpoint(tmp_path, name):
    """A port checkpoint of an RNN actor (separate LSTM trunks; a layer norm
    behind the LSTM; a shared GRU) through the JAX package's importer: the
    same forward over sequences with dones, from the same states."""
    from rl_games_tpu.models.model_builder import ModelBuilder as JModelBuilder
    from rl_games_tpu.utils.torch_import import convert_a2c_state_dict, load_torch_state_dict
    from rl_games_tpu_torch.algos.ppo import actor_obs
    from rl_games_tpu_torch.utils import checkpoint as ckpt

    params = load(name)
    cfg = params["config"]
    if cfg.pop("vecenv_type", None):
        cfg["env_name"] = "Walker2D"  # the device Walker2D in place of BipedalWalker-v3
    cfg.update(num_actors=4, horizon_length=8, seq_length=4, minibatch_size=16, mini_epochs=1)
    cfg.pop("central_value_config", None)
    agent = PPOAgent("a", params, device="cpu")
    state, _ = agent.train_epoch(agent.init_state())
    path = str(tmp_path / "p.pth")
    agent._save(path, state, {})
    sd = load_torch_state_dict(path)
    kw = dict(actions_num=agent.actions_num, input_shape=agent.obs_shape, value_size=agent.value_size,
              normalize_input=agent.normalize_input, normalize_value=agent.normalize_value)
    jmodel = JModelBuilder().load(params, **kw)
    states = jmodel.get_default_rnn_state(4)
    jparams, norm = jmodel.init(jax.random.PRNGKey(0), np.zeros((4, *agent.obs_shape), np.float32),
                                rnn_states=states)
    jparams, norm = convert_a2c_state_dict(sd, jparams, norm, params["network"], agent.obs_shape)
    rng = np.random.default_rng(7)
    obs = np.repeat(actor_obs(state.obs).numpy(), 4, axis=0) + rng.normal(size=(16, *agent.obs_shape)).astype(
        np.float32)
    dones = (rng.random(16) < 0.3).astype(np.float32)
    states = tuple(rng.normal(size=s.shape).astype(np.float32) for s in states)
    out = jmodel.apply_network(jparams, norm, obs, rnn_states=states, dones=dones, seq_length=4)
    with torch.no_grad():
        got = agent.model._net(t(obs), rnn_states=tuple(t(s) for s in states), dones=t(dones), seq_length=4)
    for k in ("value", "logits", "mu"):
        if k in out:
            close(got[k], out[k], k, rtol=1e-5, atol=1e-5)
    for a, b in zip(got["rnn_states"], out["rnn_states"]):
        close(a, b, "states", rtol=1e-5, atol=1e-5)
