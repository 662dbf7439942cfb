"""Dict observations in the port against the JAX package.

On the same numpy-seeded inputs, with the weights carried across by
``jax_to_state_dict``:

- the per-key normalizer (``RunningMeanStdObs``) against ``rms_*_obs``:
  means, variances and normalized values at rtol 1e-5, counts exactly, an
  integer key and a mask included;
- ``TestDictObsNet`` (``testnet_dict``, ``testnet_aux_loss``) behind the
  dict normalizer: the train dict at rtol 1e-5 / atol 1e-6, the aux loss
  among it, and the gradients of a loss over all of it at rtol 1e-4 with
  an atol of 1e-5 of each tensor's largest entry;
- the resnet builder's extras (a reward and a last action joining an LSTM's
  input): an integer last action (one-hot) and a float one, at the same
  tolerances, over sequences with dones; an integer one behind the
  normalizer (a float there) is refused by both packages;
- one PPO epoch of tests/test_custom_network.py's two configurations (the
  dict normalizer; the aux loss of test_discrite_testnet_aux_loss.yaml's
  network): the rollout with the JAX rollout's categorical draws handed
  over (actions and every observation key exactly, the policy's outputs at
  1e-5), then the update from the JAX trajectory (weights at 2e-6 absolute,
  the per-key stats at rtol 1e-5, the losses at rtol 1e-4); the aux head
  moves only through the aux loss;
- the player on test_dict_obs_env (tests/test_envs.py:200): its
  deterministic actions, step by step from the JAX env's observations;
- one host epoch over a host env of dict observations with an integer key
  (the policy's draws handed over as above);
- checkpoints: a dict-observation run through ``Runner`` read back by the
  port's trainer and player, and an LSTM with the extras read by the JAX
  package's importer;
- the Runner's ``import_modules``: the JAX package's module names map to the
  port's.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import rl_games_tpu.models.test_network  # noqa: F401  (registers the JAX testnet_dict, testnet_aux_loss)
import rl_games_tpu_torch.models.test_network  # noqa: F401  (the port's)
from rl_games_tpu.algos.ppo import PPOAgent as JPPOAgent
from rl_games_tpu.common.player import PpoPlayer as JPpoPlayer
from rl_games_tpu.envs import spaces as jspaces
from rl_games_tpu.models import models as JM
from rl_games_tpu.models.model_builder import ModelBuilder as JModelBuilder
from rl_games_tpu.ops import running_stats as JRS
from rl_games_tpu_torch.algos.ppo import PPOAgent
from rl_games_tpu_torch.common.player import PpoPlayer
from rl_games_tpu_torch.envs import spaces as tspaces
from rl_games_tpu_torch.envs.device import test_envs
from rl_games_tpu_torch.models import distributions as D
from rl_games_tpu_torch.models.model_builder import ModelBuilder
from rl_games_tpu_torch.ops import running_stats as RS
from rl_games_tpu_torch.runner import Runner
from rl_games_tpu_torch.utils import checkpoint as ckpt
from rl_games_tpu_torch.utils.jax_params import jax_to_state_dict

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
N = 16
TINY = jnp.finfo(jnp.float32).tiny


def t(x):
    return torch.from_numpy(np.array(x))


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def tree_t(x):
    return {k: t(v) for k, v in x.items()} if isinstance(x, dict) else t(x)


def close(got, want, err_msg="", rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol, err_msg=err_msg)


def load(name):
    return yaml.safe_load((ROOT / "rl_games_tpu" / "configs" / name).read_text())["params"]


def assert_grads(port_model, jgrads, jnorm):
    """The port's .grad of every parameter against the JAX gradient tree,
    rtol 1e-4 with an atol of 1e-5 of each tensor's largest entry."""
    want = jax_to_state_dict(to_np(jgrads), to_np(jnorm))
    for name, p in port_model.named_parameters():
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4, atol=1e-5 * np.abs(w).max() + 1e-12, err_msg=name)


# ---------------------------------------------------------------------------
# the per-key normalizer
# ---------------------------------------------------------------------------


def test_per_key_normalizer_matches_jax():
    """Three updates (one masked, one over [4, 4] leading dims) of
    {'pos', 'info', 'last_action' (int32)} stats, then normalize; the model's
    checkpoint names them running_mean_std.running_mean_std.<key>.*."""
    rng = np.random.default_rng(0)
    shapes = {"pos": (2,), "info": (4,), "last_action": ()}
    jstate, port = JRS.rms_init_obs(shapes), RS.RunningMeanStdObs(shapes)
    for lead, masked in (((16,), False), ((16,), True), ((4, 4), False)):
        batch = {"pos": rng.normal(3.0, 2.0, (*lead, 2)).astype(np.float32),
                 "info": rng.normal(-1.0, 0.5, (*lead, 4)).astype(np.float32),
                 "last_action": rng.integers(0, 4, lead).astype(np.int32)}
        mask = (rng.random(lead) < 0.5) if masked else None
        jstate = JRS.rms_update_obs(jstate, batch, None if mask is None else jnp.asarray(mask))
        port.update_from_batch(tree_t(batch), None if mask is None else t(mask))
    for k in shapes:
        rms = port.running_mean_std[k]
        close(rms.running_mean, jstate[k].mean, k)
        close(rms.running_var, jstate[k].var, k)
        assert int(rms.count) == int(jstate[k].count)
    obs = {"pos": rng.normal(3.0, 2.0, (8, 2)).astype(np.float32),
           "info": rng.normal(size=(8, 4)).astype(np.float32),
           "last_action": rng.integers(0, 4, 8).astype(np.int32)}
    want = JRS.rms_normalize_obs(jstate, obs)
    got = port.normalize(tree_t(obs))
    for k in shapes:
        close(got[k], want[k], k)
    model = ModelBuilder().load(dict_net_params(False), actions_num=4, input_shape=shapes, normalize_input=True,
                                obs_shape=shapes, device="cpu")
    assert {f"running_mean_std.running_mean_std.{k}.{s}" for k in shapes
            for s in ("running_mean", "running_var", "count")} <= set(model.state_dict())


# ---------------------------------------------------------------------------
# TestDictObsNet and the resnet builder's extras
# ---------------------------------------------------------------------------


def dict_net_params(aux: bool, units=(16, 16)):
    return {"model": {"name": "discrete_a2c"},
            "network": {"name": "testnet_aux_loss" if aux else "testnet_dict", "mlp": {"units": list(units)}}}


def both_models(params, shapes, example, actions_num, normalize_input=True, rnn_states=None):
    """The JAX model initialized on ``example`` and the port's with its
    weights; the JAX normalizer first takes one batch of ``example``."""
    kw = dict(actions_num=actions_num, input_shape=shapes, normalize_input=normalize_input, obs_shape=shapes)
    jmodel = JModelBuilder().load(params, **kw)
    jparams, jnorm = jmodel.init(jax.random.PRNGKey(0), example, rnn_states=rnn_states)
    jnorm = JM.update_obs_stats(jnorm, example)
    model = ModelBuilder().load(params, **kw, device="cpu")
    model.load_state_dict(jax_to_state_dict(to_np(jparams), to_np(jnorm)))
    return jmodel, jparams, jnorm, model


@pytest.mark.parametrize("aux", [False, True], ids=["testnet_dict", "testnet_aux_loss"])
def test_testnet_forward_and_gradients_match_jax(aux):
    """The train dict (neglogp, values, entropy, log-probs, the aux loss) and
    the gradients of their sum's mean, behind the per-key normalizer."""
    rng = np.random.default_rng(1)
    shapes = {"pos": (2,), "info": (4,), **({"aux_target": (1,)} if aux else {})}
    obs = {k: rng.normal(1.0, 2.0, (32, *s)).astype(np.float32) for k, s in shapes.items()}
    actions = rng.integers(0, 4, 32)
    jmodel, jparams, jnorm, model = both_models(dict_net_params(aux), shapes, obs, 4)

    def total(res):
        aux_sum = sum(v.mean() for v in (res.get("aux_losses") or {}).values())
        return res["prev_neglogp"].mean() + res["values"].mean() + 0.1 * res["entropy"].mean() + aux_sum

    def jtotal(p):
        jres = jmodel.forward_train(p, jnorm, obs, jnp.asarray(actions))
        return total(jres), jres

    (_, jres), jgrads = jax.jit(jax.value_and_grad(jtotal, has_aux=True))(jparams)
    res = model.forward_train(tree_t(obs), t(actions))
    for k in ("prev_neglogp", "values", "entropy", "logits"):
        close(res[k], jres[k], k)
    assert ("aux_losses" in res) == ("aux_losses" in jres) == aux
    if aux:
        close(res["aux_losses"]["aux_dist_loss"], jres["aux_losses"]["aux_dist_loss"], "aux")
    total(res).backward()
    assert_grads(model, jgrads, jnorm)


EXTRAS = {
    # (model, space, last action's shape and dtype, normalize_input)
    "integer_last_action": ("discrete_a2c", {"discrete": {}}, (), np.int32, False),
    "float_last_action": ("continuous_a2c_logstd", {"continuous": {"fixed_sigma": True}}, (2,), np.float32, False),
    # both packages size the core for the one-hot and then get a float
    "normalized_integer": ("discrete_a2c", {"discrete": {}}, (), np.int32, True),
}


@pytest.mark.parametrize("case", sorted(EXTRAS))
def test_resnet_builder_extras_match_jax(case):
    """{'observation', 'reward', 'last_action'} with require_rewards and
    require_last_actions: the reward and the last action (one-hot when an
    integer reaches the network, as it is when a float does) join an LSTM's
    input after the MLP. Three sequences of four steps with dones, from
    random states: the train dict, the new states and the gradients. Behind
    the normalizer an integer last action reaches the network as a float,
    where both packages sized the core for the one-hot: the JAX package's
    apply fails on the kernel's shape, the port's forward says why."""
    model_name, space, la_shape, la_dtype, normalize = EXTRAS[case]
    actions_num = 4 if "discrete" in space else 2
    params = {"model": {"name": model_name},
              "network": {"name": "actor_critic", "mlp": {"units": [16], "activation": "elu"},
                          "rnn": {"name": "lstm", "units": 8, "layers": 1}, "require_rewards": True,
                          "require_last_actions": True, "space": space}}
    shapes = {"observation": (5,), "reward": (), "last_action": la_shape}
    rng = np.random.default_rng(2)

    def draw(n):
        la = (rng.integers(0, actions_num, (n, *la_shape)) if la_dtype == np.int32
              else rng.normal(size=(n, *la_shape))).astype(la_dtype)
        return {"observation": rng.normal(size=(n, 5)).astype(np.float32),
                "reward": rng.normal(size=n).astype(np.float32), "last_action": la}

    jmodel0 = JModelBuilder().load(params, actions_num=actions_num, input_shape=shapes,
                                   normalize_input=normalize, obs_shape=shapes)
    states0 = jmodel0.get_default_rnn_state(3)
    jmodel, jparams, jnorm, model = both_models(params, shapes, draw(3), actions_num, normalize, states0)
    core = model.a2c_network.rnn.rnn.weight_ih_l0
    assert core.shape[1] == 16 + 1 + (actions_num if la_dtype == np.int32 else int(np.prod(la_shape)))
    obs = draw(12)
    dones = (rng.random(12) < 0.3).astype(np.float32)
    states = tuple(rng.normal(size=s.shape).astype(np.float32) for s in states0)
    actions = (rng.integers(0, actions_num, 12) if "discrete" in space
               else rng.normal(size=(12, actions_num)).astype(np.float32))
    kw = dict(dones=dones, seq_length=4)

    def total(res):
        return res["prev_neglogp"].mean() + res["values"].mean() + sum(s.mean() for s in res["rnn_states"])

    def port():
        return model.forward_train(tree_t(obs), t(actions), rnn_states=tuple(t(s) for s in states),
                                   dones=t(dones), seq_length=4)

    if normalize:
        from flax.errors import ScopeParamShapeError

        with pytest.raises(ScopeParamShapeError):
            jmodel.forward_train(jparams, jnorm, obs, jnp.asarray(actions), rnn_states=states, **kw)
        with pytest.raises(ValueError, match="built for an integer last action and got a torch.float32"):
            port()
        return
    def jtotal(p):
        jres = jmodel.forward_train(p, jnorm, obs, jnp.asarray(actions), rnn_states=states, **kw)
        return total(jres), jres

    (_, jres), jgrads = jax.jit(jax.value_and_grad(jtotal, has_aux=True))(jparams)
    res = port()
    for k in ("prev_neglogp", "values", "entropy"):
        close(res[k], jres[k], k)
    for a, b in zip(res["rnn_states"], jres["rnn_states"]):
        close(a, b, "rnn_states")
    total(res).backward()
    assert_grads(model, jgrads, jnorm)


# ---------------------------------------------------------------------------
# PPO: tests/test_custom_network.py's two configurations against the JAX agent
# ---------------------------------------------------------------------------


def custom_params(aux: bool):
    """tests/test_custom_network.py's dict_params at N envs x 8 steps, 2
    mini-epochs of 4 minibatches of 32; with ``aux``
    test_discrite_testnet_aux_loss.yaml's network (testnet_aux_loss, the
    env's aux_target, normalize_input as the config has it: off)."""
    params = load("ref/test/test_discrite_testnet_aux_loss.yaml")
    cfg = params["config"]
    cfg.pop("import_modules")
    cfg.update(num_actors=N, horizon_length=8, minibatch_size=32, mini_epochs=2, learning_rate=5e-4, seed=5,
               normalize_input=not aux)
    if not aux:
        params["network"] = {"name": "testnet_dict", "mlp": {"units": [32, 32]}}
        cfg.pop("env_config")
    return params


def jax_uniforms(jstate, horizon):
    """Per rollout step, the uniforms of the categorical's Gumbel noise,
    from the rollout's key schedule (rng, akey = split(rng))."""
    rng, out = jstate.rng, []
    for _ in range(horizon):
        rng, akey = jax.random.split(rng)
        out.append(np.asarray(jax.random.uniform(akey, (N, 4), minval=TINY, maxval=1.0)))
    return out


def sample_from(monkeypatch, uniforms):
    noise = iter(t(u) for u in uniforms)
    monkeypatch.setattr(D, "categorical_sample",
                        lambda logits, generator=None, mask=None: D.gumbel_max(logits, next(noise), mask))


def port_agent(params, jstate):
    """A CPU port agent with the JAX state's weights, per-key stats, env
    state, observations, dones and LR."""
    agent = PPOAgent("port", params, device="cpu")
    state = agent.init_state()
    agent.model.load_state_dict(jax_to_state_dict(to_np(jstate.params), to_np(jstate.norm)))
    est = jstate.env_state.estate
    state.env_state.estate = test_envs.MemoryState(
        **{f.name: t(getattr(est, f.name)) for f in dataclasses.fields(test_envs.MemoryState)})
    state.env_state.steps = t(jstate.env_state.steps)
    state.obs, state.dones, state.lr = tree_t(jstate.obs), t(jstate.dones), t(jstate.lr)
    return agent, state


def check_update(jagent, jafter, traj, last_values, agent, state, ptraj, plast):
    """_finish_epoch of both from the same trajectory: weights at 2e-6
    absolute, normalizer stats at rtol 1e-5, LR at rtol 1e-5, losses at
    rtol 1e-4."""
    jnew, jm = jax.jit(jagent._finish_epoch)(jafter, traj, last_values, None)
    state, pm = agent._finish_epoch(state, ptraj, plast)
    expected = jax_to_state_dict(to_np(jnew.params), to_np(jnew.norm))
    assert set(agent.model.state_dict()) == set(expected)
    for name, got in agent.model.state_dict().items():
        tol = dict(rtol=0, atol=2e-6) if name.startswith("a2c_network") else dict(rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), expected[name].numpy(), err_msg=name, **tol)
    np.testing.assert_allclose(float(state.lr), float(jnew.lr), rtol=1e-5)
    jm = to_np(jm)
    for k in ("a_loss", "c_loss", "kl", "entropy", "explained_variance"):
        np.testing.assert_allclose(float(pm[k]), jm[k], rtol=1e-4, atol=1e-6, err_msg=k)
    return state, jnew


@pytest.mark.parametrize("aux", [False, True], ids=["dict_obs_trains", "aux_loss_flows_into_training"])
def test_custom_network_epoch_matches_jax(monkeypatch, aux):
    """tests/test_custom_network.py's test_dict_obs_custom_network_trains
    (the per-key normalizer: stats for 'pos' and 'info') and
    test_aux_loss_flows_into_training (the aux head moves, and only through
    the aux loss) as parity tests: one rollout on test_dict_obs_env from the
    JAX state with its draws, then one update from the JAX trajectory."""
    params = custom_params(aux)
    jagent = JPPOAgent("jax", params)
    jstate = jagent.init_state()
    after, traj, last_values, _ = jax.jit(jagent._rollout)(jstate)
    traj, last_values = to_np(traj), np.asarray(last_values)
    keys = {"pos", "info"} | ({"aux_target"} if aux else set())
    assert set(traj["obses"]) == keys
    sample_from(monkeypatch, jax_uniforms(jstate, 8))
    agent, state = port_agent(params, jstate)
    if not aux:
        assert set(agent.model.running_mean_std.running_mean_std) == {"pos", "info"}
    ptraj, plast = agent._rollout(state)
    np.testing.assert_array_equal(ptraj["actions"].numpy(), traj["actions"])
    for k in keys:
        np.testing.assert_array_equal(ptraj["obses"][k].numpy(), traj["obses"][k], err_msg=k)
    for k in ("values", "neglogpacs", "rewards"):
        np.testing.assert_allclose(ptraj[k].numpy(), traj[k], rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(plast.numpy(), last_values, rtol=1e-5, atol=1e-5)
    for k in keys:
        np.testing.assert_array_equal(state.obs[k].numpy(), np.asarray(after.obs[k]), err_msg=k)

    agent2, state2 = port_agent(params, after)
    before = {k: v.clone() for k, v in agent2.model.state_dict().items()}
    ptraj = {k: tree_t(v) for k, v in traj.items()}
    check_update(JPPOAgent("jax", params), after, traj, last_values, agent2, state2, ptraj, t(last_values))
    if aux:
        moved = agent2.model.state_dict()["a2c_network.aux_head.weight"] - before["a2c_network.aux_head.weight"]
        assert float(moved.abs().max()) > 0
        # the aux head's gradient comes from the aux loss alone
        dataset = agent2._prepare_dataset(state2, ptraj, t(last_values))
        mb = agent2._minibatch(dataset, 0)
        head = [agent2.model.a2c_network.aux_head.weight, agent2.model.a2c_network.aux_head.bias]
        grads = torch.autograd.grad(agent2._loss_and_kl(mb, state2.entropy_coef)[0], head)
        assert all(float(g.abs().max()) > 0 for g in grads)
        forward_train = agent2.model.forward_train
        monkeypatch.setattr(agent2.model, "forward_train", lambda *a, **k: {
            key: v for key, v in forward_train(*a, **k).items() if key != "aux_losses"})
        grads = torch.autograd.grad(agent2._loss_and_kl(mb, state2.entropy_coef)[0], head, allow_unused=True,
                                    materialize_grads=True)
        assert all(float(g.abs().max()) == 0 for g in grads)


def test_player_plays_dict_obs_env_as_jax():
    """tests/test_envs.py::test_player_runs_dict_obs_env against the JAX
    player: the same weights give the same deterministic actions for 30
    steps of the JAX env's dict observations; the port's run ends finite."""
    params = {"algo": {"name": "a2c_discrete"}, "model": {"name": "discrete_a2c"},
              "network": {"name": "testnet_dict", "with_aux_loss": False, "mlp": {"units": [16, 16]}},
              "config": {"env_name": "test_dict_obs_env", "num_actors": 4, "normalize_input": True,
                         "normalize_value": False, "player": {"games_num": 4, "num_actors": 4}, "seed": 3}}
    jplayer, player = JPpoPlayer(params), PpoPlayer(params, device="cpu")
    jplayer.norm = JM.update_obs_stats(jplayer.norm, jplayer.vec_env.reset(jax.random.PRNGKey(9))[1])
    player.model.load_state_dict(jax_to_state_dict(to_np(jplayer.net_params), to_np(jplayer.norm)))
    env_state, obs = jplayer.vec_env.reset(jax.random.PRNGKey(4))
    step = jax.jit(jplayer.vec_env.step)
    for _ in range(30):
        actions = jplayer._play_actions(None, obs, env_state)
        np.testing.assert_array_equal(player._play_actions(None, tree_t(to_np(obs))).numpy(), np.asarray(actions))
        env_state, obs, _, _, _ = step(env_state, actions)
    assert np.isfinite(player.run(games_num=4))


# ---------------------------------------------------------------------------
# a host env of dict observations
# ---------------------------------------------------------------------------


class DictHostEnv:
    """A host env of dict observations {'pos': float32 [2], 'info': float32
    [4], 'steps': int32 []}: Discrete(4) moves of a point on the plane
    toward a goal, reward -0.1 |pos - goal|₁, episodes of staggered lengths
    with same-step autoreset."""

    is_host_env = True
    autoreset_mode = "same_step"
    max_episode_steps = 100

    def __init__(self, spaces, n=N):
        self.spaces, self.n = spaces, n
        self.lengths = 3 + np.arange(n) % 5
        self.pos = np.zeros((n, 2), np.float32)
        self.goal = np.stack([np.arange(n) % 3 - 1, np.arange(n) % 4 - 2], -1).astype(np.float32)
        self.count = np.zeros(n, np.int32)

    def get_env_info(self):
        s = self.spaces
        return s.EnvInfo(observation_space=s.DictSpace.create({"pos": s.Box(shape=(2,)), "info": s.Box(shape=(4,)),
                                                               "steps": s.Box(shape=())}),
                         action_space=s.Discrete(n=4))

    def _obs(self):
        info = np.concatenate([self.goal, self.count[:, None] / 10.0, np.ones((self.n, 1))], -1)
        return {"pos": self.pos.copy(), "info": info.astype(np.float32), "steps": self.count.copy()}

    def reset(self):
        return self._obs()

    def step(self, actions):
        actions = np.asarray(actions).reshape(self.n)
        move = np.stack([(actions == 0).astype(np.float32) - (actions == 1), (actions == 2).astype(np.float32)
                         - (actions == 3)], -1)
        self.pos += move
        self.count += 1
        rewards = (-0.1 * np.abs(self.pos - self.goal).sum(-1)).astype(np.float32)
        done = self.count >= self.lengths
        self.pos[done] = 0.0
        self.count[done] = 0
        return self._obs(), rewards, done, {}


def test_host_dict_rollout_matches_jax(monkeypatch):
    """One host epoch (rollout, GAE, update) of a testnet_dict policy over
    DictHostEnv with the JAX host rollout's draws: every key goes up in the
    step's one copy, the integer 'steps' as an integer; the weights, the
    per-key stats (the integer key's too), the losses and the meters as the
    JAX agent's."""
    params = custom_params(False)
    params["config"].update(env_name="unused", host_inference_device="cpu", horizon_length=8)
    jagent = JPPOAgent("jax", params, vec_env=DictHostEnv(jspaces))
    jstate = jagent.init_state()
    agent = PPOAgent("port", params, device="cpu", vec_env=DictHostEnv(tspaces))
    state = agent.init_state()
    assert state.obs["steps"].dtype == torch.int64 and state.obs["pos"].dtype == torch.float32
    agent.model.load_state_dict(jax_to_state_dict(to_np(jstate.params), to_np(jstate.norm)))
    state.lr = t(jstate.lr)
    sample_from(monkeypatch, jax_uniforms(jstate, 8))
    uploads = []
    upload = agent._upload
    agent._upload = lambda *a: uploads.append(len(a)) or upload(*a)
    state, pm = agent.host_train_epoch(state)
    assert uploads == [5] * 8  # three keys, rewards and dones
    jnew, jm = jagent.host_train_epoch(jstate)
    expected = jax_to_state_dict(to_np(jnew.params), to_np(jnew.norm))
    for name, got in agent.model.state_dict().items():
        tol = dict(rtol=0, atol=2e-6) if name.startswith("a2c_network") else dict(rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), expected[name].numpy(), err_msg=name, **tol)
    assert int(agent.model.running_mean_std.running_mean_std["steps"].count) == N * 8 + 1
    jm = to_np(jm)
    for k in ("a_loss", "c_loss", "kl", "entropy"):
        np.testing.assert_allclose(float(pm[k]), jm[k], rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(pm["mean_rewards"].numpy(), jm["mean_rewards"], rtol=1e-5)
    assert int(pm["games_played"]) == int(jm["games_played"]) > 0


# ---------------------------------------------------------------------------
# checkpoints and the Runner's import_modules
# ---------------------------------------------------------------------------


def test_dict_obs_checkpoint_round_trips(tmp_path):
    """test_discrite_testnet_aux_loss.yaml (its import_modules mapped to the
    port) 2 epochs through Runner.run with normalize_input: the last
    checkpoint holds the per-key stats and the dict observations of the
    train state; the trainer restores both and trains on, the player
    restores the weights."""
    doc = {"params": load("ref/test/test_discrite_testnet_aux_loss.yaml")}
    cfg = doc["params"]["config"]
    cfg.update(num_actors=4, horizon_length=8, minibatch_size=16, mini_epochs=1, max_epochs=2, normalize_input=True,
               train_dir=str(tmp_path), print_stats=False, player={"games_num": 2, "deterministic": True})
    runner = Runner(device="cpu")
    runner.load(doc)
    runner.run({"train": True})
    path = str(next((tmp_path / cfg["name"] / "nn").glob("last_*_ep_2_rew_*.pth")))
    payload = ckpt.read_payload(path)
    assert "running_mean_std.running_mean_std.aux_target.running_mean" in payload["model"]
    assert set(payload["state"]["obs"]) == {"pos", "info", "aux_target"}
    agent = runner.create_agent()
    state, meta = ckpt.load_checkpoint(path, agent.init_state(), payload=payload)  # init_state draws weights
    agent.set_weights(ckpt.load_checkpoint_weights(path, payload=payload)[0])
    for k, v in agent.model.state_dict().items():
        assert torch.equal(v, payload["model"][k]), k
    for k, v in state.obs.items():
        assert torch.equal(v, payload["state"]["obs"][k]), k
    assert int(state.epoch) == meta["epoch"] == 2
    state, metrics = agent.train_epoch(state)  # and trains on from there
    assert int(state.epoch) == 3 and np.isfinite(float(metrics["a_loss"]))
    player = runner.create_player()
    player.restore(path)
    for k, v in player.model.state_dict().items():
        assert torch.equal(v, payload["model"][k]), k
    assert np.isfinite(player.run(games_num=2))


def test_jax_importer_reads_dict_obs_checkpoint(tmp_path):
    """A port checkpoint of an LSTM policy with the extras and the per-key
    normalizer, through the JAX package's convert_a2c_state_dict: the same
    parameters and per-key stats back."""
    from rl_games_tpu.utils.torch_import import convert_a2c_state_dict, load_torch_state_dict

    model_name, space, la_shape, _, _ = EXTRAS["integer_last_action"]
    params = {"model": {"name": model_name},
              "network": {"name": "actor_critic", "mlp": {"units": [16], "activation": "elu"},
                          "rnn": {"name": "lstm", "units": 8, "layers": 1}, "require_rewards": True,
                          "require_last_actions": True, "space": space}}
    shapes = {"observation": (5,), "reward": (), "last_action": la_shape}
    kw = dict(actions_num=4, input_shape=shapes, normalize_input=True, obs_shape=shapes)
    model = ModelBuilder().load(params, **kw, device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(3))
    rng = np.random.default_rng(4)
    model.update_obs_stats({"observation": t(rng.normal(size=(8, 5)).astype(np.float32)),
                            "reward": t(rng.normal(size=8).astype(np.float32)),
                            "last_action": t(rng.integers(0, 4, 8))})
    path = str(tmp_path / "p.pth")
    ckpt.save_checkpoint(path, None, {}, weights=model.state_dict())
    jmodel = JModelBuilder().load(params, **kw)
    example = {"observation": np.zeros((2, 5), np.float32), "reward": np.zeros(2, np.float32),
               "last_action": np.zeros(2, np.int32)}
    jparams, jnorm = jmodel.init(jax.random.PRNGKey(0), example, rnn_states=jmodel.get_default_rnn_state(2))
    jparams, jnorm = convert_a2c_state_dict(load_torch_state_dict(path), jparams, jnorm, params["network"], shapes)
    back = jax_to_state_dict(to_np(jparams), to_np(jnorm))
    assert set(back) == set(model.state_dict())
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)


def test_import_modules_map_to_the_port(monkeypatch):
    """A JAX package module named in import_modules is the port's module of
    the same path (connect4_network, whose port came in A8 (b), among them);
    one listed in UNPORTED_MODULES names its ROADMAP.md item; any other name
    is imported as given."""
    import importlib

    from rl_games_tpu_torch import runner as runner_module
    from rl_games_tpu_torch.models import model_builder

    imported = []
    real = importlib.import_module
    monkeypatch.setattr(runner_module.importlib, "import_module", lambda name: imported.append(name) or real(name))
    runner_module.import_user_module("rl_games_tpu.models.test_network")
    assert imported == ["rl_games_tpu_torch.models.test_network"]
    assert model_builder.NETWORK_REGISTRY["testnet_aux_loss"].__module__ == "rl_games_tpu_torch.models.test_network"
    runner_module.import_user_module("rl_games_tpu.models.connect4_network")
    assert imported[-1] == "rl_games_tpu_torch.models.connect4_network"
    assert model_builder.NETWORK_REGISTRY["connect4net"].__module__ == "rl_games_tpu_torch.models.connect4_network"
    assert runner_module.UNPORTED_MODULES == {}
    monkeypatch.setitem(runner_module.UNPORTED_MODULES, "rl_games_tpu.models.connect4_network",
                        ("the connect4 network (connect4net)", "A8 (b)"))
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md, item A8 \(b\)"):
        runner_module.import_user_module("rl_games_tpu.models.connect4_network")
    with pytest.raises(ModuleNotFoundError, match="no counterpart"):
        runner_module.import_user_module("rl_games_tpu.models.no_such_module")
    runner_module.import_user_module("json")
    assert imported[-1] == "json"
