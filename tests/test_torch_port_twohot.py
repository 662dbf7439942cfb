"""The two-hot value head, its functions and losses, and the straight-through
one-hot categorical, in the port against the JAX package.

On the same numpy-seeded inputs:

- ``symlog`` / ``symexp``, ``twohot_encode`` / ``twohot_decode``,
  ``twohot_log_prob`` (its width (hi - lo) / 255, its truncation toward
  zero and its clip of the lower bin only, targets beyond the grid
  included) at rtol 1e-5 / atol 1e-6; the bins within 2e-6 of
  ``jnp.linspace``'s, their ends exact (tests/test_ops.py:287, 296, 353);
- the value head (``value_head: twohot``: 255 logits, the value symexp of
  their expected bin) with the weights carried across: the train dict, its
  'value_logits' among it (tests/test_ops.py:387), and the gradients;
- one PPO update with the two-hot value loss, -twohot_log_prob of the
  symlog returns, from the JAX rollout's trajectory: ppo_cartpole.yaml's
  actor-critic, and test_asymmetric_discrete.yaml's central value net
  (without its LSTMs); weights at 2e-6 absolute, the losses at rtol 1e-4;
- tests/test_ppo.py:261, the two-hot head training CartPole past 100 in 100
  epochs;
- ``OneHotDist`` (tests/test_ppo.py:273): the mode's gradient is the
  identity on the raw logits, a sample's flows through the softmax; with
  the uniforms of the JAX key, the same draw and the same gradients.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from rl_games_tpu.algos.ppo import PPOAgent as JPPOAgent
from rl_games_tpu.models import distributions as JD
from rl_games_tpu.models.model_builder import ModelBuilder as JModelBuilder
from rl_games_tpu_torch.models import distributions as D
from rl_games_tpu_torch.models.model_builder import ModelBuilder
from rl_games_tpu_torch.utils.jax_params import jax_to_state_dict
from test_torch_port_impala import models
from test_torch_port_test_envs import port_agent, t, to_np

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
TINY = jnp.finfo(jnp.float32).tiny


def close(got, want, err_msg="", rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol, err_msg=err_msg)


def load(name):
    return yaml.safe_load((ROOT / "rl_games_tpu" / "configs" / name).read_text())["params"]


# ---------------------------------------------------------------------------
# the functions
# ---------------------------------------------------------------------------


def test_twohot_bins_match_jax():
    want = np.asarray(JD.TWOHOT_BINS)
    assert D.TWOHOT_BINS.shape == want.shape == (255,)
    assert float(D.TWOHOT_BINS[0]) == -20.0 and float(D.TWOHOT_BINS[-1]) == 20.0
    np.testing.assert_allclose(D.TWOHOT_BINS.numpy(), want, rtol=0, atol=2e-6)


def test_twohot_roundtrip():
    """tests/test_ops.py::test_twohot_roundtrip: the encoding sums to 1 and
    decodes to the value; as JAX's encoding, with a value on a bin, one
    below the grid and one above it."""
    bins = np.linspace(-5.0, 5.0, 33).astype(np.float32)
    x = np.asarray([-4.2, 0.0, 1.7, 4.9, bins[7], -6.0, 7.5], np.float32)
    enc = D.twohot_encode(t(x), t(bins))
    close(enc, JD.twohot_encode(jnp.asarray(x), jnp.asarray(bins)), "encode")
    close(enc.sum(-1), np.ones(len(x)), "sums")
    close((enc * t(bins)).sum(-1), np.clip(x, -5.0, 5.0), "decoded", atol=1e-5)


def test_symlog_symexp_roundtrip():
    """tests/test_ops.py::test_symlog_symexp_roundtrip, and each as JAX's."""
    x = np.asarray([-100.0, -1.0, 0.0, 2.5, 1000.0], np.float32)
    close(D.symlog(t(x)), JD.symlog(jnp.asarray(x)), "symlog")
    close(D.symexp(t(x / 100)), JD.symexp(jnp.asarray(x / 100)), "symexp")
    close(D.symexp(D.symlog(t(x))), x, "roundtrip", rtol=1e-4)


def test_twohot_decode_matches_jax():
    logits = np.random.default_rng(0).normal(size=(16, 255)).astype(np.float32)
    close(D.twohot_decode(t(logits), D.TWOHOT_BINS), JD.twohot_decode(jnp.asarray(logits), JD.TWOHOT_BINS), atol=1e-5)


def test_twohot_log_prob_matches_torch_reference_formula():
    """tests/test_ops.py::test_twohot_log_prob_matches_torch_reference_formula:
    the port's log-prob against the JAX package's and the reference formula
    (through torch.distributions.OneHotCategorical), at targets inside the
    grid and beyond it (the lower bin clipped, the weights not)."""
    rng = np.random.RandomState(1)
    logits = rng.normal(size=(40, 255)).astype("float32")
    targets = np.concatenate([rng.uniform(-19.5, 19.5, size=(32,)),
                              [-20.0, -20.1, -25.0, 20.0, 21.0, 0.0, -0.05, 19.9]]).astype("float32")
    got = D.twohot_log_prob(t(logits), t(targets))
    close(got, JD.twohot_log_prob(jnp.asarray(logits), jnp.asarray(targets)), "jax", atol=1e-5)
    dist = torch.distributions.OneHotCategorical(logits=t(logits))
    buckets = torch.linspace(-20.0, 20.0, steps=255)
    width = (buckets[-1] - buckets[0]) / 255
    x = (t(targets) - buckets[0]) / width
    lo = torch.clip(x.to(torch.int64), min=0, max=253)
    hi = lo + 1
    w_lo, w_hi = torch.abs(x - hi), torch.abs(x - lo)
    expected = (w_lo * dist.log_prob(torch.nn.functional.one_hot(lo, 255).float())
                + w_hi * dist.log_prob(torch.nn.functional.one_hot(hi, 255).float()))
    close(got, expected.numpy(), "reference", rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the value head and its losses
# ---------------------------------------------------------------------------

CONTINUOUS = {"continuous": {"mu_activation": "None", "sigma_activation": "None", "mu_init": {"name": "default"},
                             "sigma_init": {"name": "const_initializer", "val": 0.0}, "fixed_sigma": True}}


def test_twohot_value_logits_reach_the_loss():
    """tests/test_ops.py::test_twohot_value_logits_reach_the_loss: the train
    dict carries the head's [B, 255] logits; the head's values, logits and
    gradients as the JAX head's (a loss over the values, the logits'
    two-hot log-prob and the policy)."""
    net = {"name": "actor_critic", "separate": False, "value_head": "twohot", "space": CONTINUOUS,
           "mlp": {"units": [16], "activation": "relu", "initializer": {"name": "default"}}}
    jmodel, jparams, jnorm, port = models(net, (3,), actions_num=2, model="continuous_a2c_logstd")
    assert tuple(port.a2c_network.value.weight.shape) == (255, 16)
    rng = np.random.default_rng(2)
    obs = rng.normal(size=(8, 3)).astype(np.float32)
    actions = rng.normal(size=(8, 2)).astype(np.float32)
    targets = rng.normal(0.0, 3.0, 8).astype(np.float32)

    def total(res, lib):
        return (res["prev_neglogp"].mean() + res["values"].mean()
                - lib.twohot_log_prob(res["value_logits"], lib.symlog(targets_of(lib))).mean())

    def targets_of(lib):
        return jnp.asarray(targets) if lib is JD else t(targets)

    def jtotal(p):
        jres = jmodel.forward_train(p, jnorm, obs, jnp.asarray(actions))
        return total(jres, JD), jres

    (_, jres), jgrads = jax.jit(jax.value_and_grad(jtotal, has_aux=True))(jparams)
    res = port.forward_train(t(obs), t(actions))
    assert tuple(res["value_logits"].shape) == (8, 255)
    for k in ("prev_neglogp", "values", "value_logits", "mus"):
        close(res[k], jres[k], k, atol=1e-5)
    total(res, D).backward()
    want = jax_to_state_dict(to_np(jgrads))
    for name, p in port.named_parameters():
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4, atol=1e-5 * np.abs(w).max() + 1e-12, err_msg=name)


def test_twohot_head_takes_one_value():
    params = {"model": {"name": "discrete_a2c"},
              "network": {"name": "actor_critic", "value_head": "twohot", "space": {"discrete": {}},
                          "mlp": {"units": [8], "activation": "relu"}}}
    with pytest.raises(ValueError, match="value_size 1"):
        ModelBuilder().load(params, actions_num=2, input_shape=(3,), value_size=2, device="cpu")


def jax_bins(model):
    """The JAX package's bins in the port model's head: torch's linspace
    rounds some bins an ulp away from jnp.linspace's (test_twohot_bins_match_jax),
    and an update amplifies an ulp of a decoded value in Adam's first steps."""
    with torch.no_grad():
        model.a2c_network.twohot_bins.copy_(t(JD.TWOHOT_BINS))


def check_update(jagent, after, traj, last_values, agent, state, ptraj, cv_atol=2e-6):
    """_finish_epoch of both from the JAX trajectory, the JAX bins in the
    port's heads: the actor's weights at 2e-6 absolute (a central value
    net's at ``cv_atol``), normalizer stats at rtol 1e-5, the losses at rtol
    1e-4."""
    for model in (agent.model, agent.cv_model) if agent.has_central_value else (agent.model,):
        if getattr(model.a2c_network, "twohot", False):
            jax_bins(model)
    jnew, jm = jax.jit(jagent._finish_epoch)(after, traj, last_values, None)
    state, pm = agent._finish_epoch(state, ptraj, t(last_values))
    pairs = [(agent.model, jnew.params, jnew.norm, 2e-6)]
    if agent.has_central_value:
        pairs.append((agent.cv_model, jnew.cv_params, jnew.cv_norm, cv_atol))
    for model, params, norm, atol in pairs:
        expected = jax_to_state_dict(to_np(params), to_np(norm))
        assert sorted(expected) == sorted(model.state_dict())
        for name, got in model.state_dict().items():
            tol = dict(rtol=0, atol=atol) if name.startswith("a2c_network") else dict(rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(got.numpy(), expected[name].numpy(), err_msg=name, **tol)
    jm = to_np(jm)
    for k in ("a_loss", "c_loss", "kl", "entropy") + (("cval_loss",) if agent.has_central_value else ()):
        np.testing.assert_allclose(float(pm[k]), jm[k], rtol=1e-4, atol=1e-6, err_msg=k)
    return pm


def test_twohot_actor_critic_update_matches_jax():
    """ppo_cartpole.yaml with value_head: twohot (16 envs x 32 steps, 4 x 8
    minibatches of 64): c_loss is the mean negative two-hot log-prob."""
    params = load("ppo_cartpole.yaml")
    params["network"]["value_head"] = "twohot"
    jagent = JPPOAgent("jax", params)
    after, traj, last_values, _ = jax.jit(jagent._rollout)(jagent.init_state())
    traj, last_values = to_np(traj), np.asarray(last_values)
    agent, state = port_agent(params, after)
    pm = check_update(jagent, after, traj, last_values, agent, state, {k: t(v) for k, v in traj.items()})
    assert float(pm["c_loss"]) > 0


def test_twohot_central_value_update_matches_jax():
    """test_asymmetric_discrete.yaml without its LSTMs (16 envs x 16 steps,
    2 x 4 minibatches of 64), its central value net with value_head:
    twohot: the central net's loss is the two-hot one. Its first
    minibatch's gradients as JAX's (rtol 1e-4, atol 1e-5 of each tensor's
    largest entry); after the epoch its weights within 2e-5: one entry's
    first gradient is -2.5e-8, within Adam's eps (1e-8) of zero, where the
    step lr · g / (|g| + eps) moves by 2 % of lr (1e-5) with the float32
    summation order of g; the other steps hold 2e-6."""
    params = load("ref/test/test_asymmetric_discrete.yaml")
    cfg = params["config"]
    params["network"].pop("rnn")
    cv = cfg["central_value_config"]
    cv["network"].pop("rnn")
    cv["network"]["value_head"] = "twohot"
    cfg.update(num_actors=16, horizon_length=16, minibatch_size=64, mini_epochs=2)
    cv.update(minibatch_size=64, mini_epochs=2)
    jagent = JPPOAgent("jax", params)
    after, traj, last_values, _ = jax.jit(jagent._rollout)(jagent.init_state())
    traj, last_values = to_np(traj), np.asarray(last_values)
    agent, state = port_agent(params, after)
    agent.cv_model.load_state_dict(jax_to_state_dict(to_np(after.cv_params), to_np(after.cv_norm)))
    assert tuple(agent.cv_model.a2c_network.value.weight.shape)[0] == 255
    ptraj = {k: t(v) for k, v in traj.items() if k != "obses"}
    ptraj["obses"] = t(traj["obses"]["obs"])
    jax_bins(agent.cv_model)
    jprep, jds, _ = jagent._prepare_dataset(after, traj, last_values)
    rows = slice(0, agent.cv_minibatch_size)

    def jloss(p):
        res = jagent.cv_model.forward_train(p, jprep.cv_norm, jds["states"][rows])
        return -JD.twohot_log_prob(res["value_logits"], JD.symlog(jds["returns"][rows, 0])).mean()

    jgrads = to_np(jax.grad(jloss)(after.cv_params))
    pds = agent._prepare_dataset(state, ptraj, t(last_values))  # the normalizers' update as JAX's
    close(pds["returns"], jds["returns"], "returns")
    res = agent.cv_model.forward_train(pds["states"][rows])
    loss = -D.twohot_log_prob(res["value_logits"], D.symlog(pds["returns"][rows, 0])).mean()
    grads = torch.autograd.grad(loss, list(agent.cv_model.parameters()))
    want = jax_to_state_dict(jgrads)
    for (name, _), g in zip(agent.cv_model.named_parameters(), grads):
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5 * np.abs(w).max(), err_msg=name)
    agent, state = port_agent(params, after)
    agent.cv_model.load_state_dict(jax_to_state_dict(to_np(after.cv_params), to_np(after.cv_norm)))
    pm = check_update(jagent, after, traj, last_values, agent, state, ptraj, cv_atol=2e-5)
    assert float(pm["cval_loss"]) > 0


# ---------------------------------------------------------------------------
# OneHotDist
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("unimix", [0.0, 0.1])
def test_onehot_dist_straight_through(unimix):
    """tests/test_ppo.py::test_onehot_dist_straight_through: mode() is bin 0
    with the identity gradient on the raw logits, [1, 2, 3]; a sample is one
    one-hot whose gradient flows through the softmax. With the uniforms of
    the JAX key, the port draws the JAX sample and gets its gradient; the
    log-prob of a one-hot as JAX's."""
    logits = np.asarray([[2.0, 0.5, -1.0], [0.1, 0.3, 0.2]], np.float32)
    w = np.asarray([1.0, 2.0, 3.0], np.float32)
    key = jax.random.PRNGKey(0)

    def jmode(lg):
        return (JD.OneHotDist(lg, unimix).mode() * w).sum()

    def jsample(lg):
        return (JD.OneHotDist(lg, unimix).sample(key) * w).sum()

    lg = t(logits).requires_grad_(True)
    mode = D.OneHotDist(lg, unimix).mode()
    assert float((mode[0].detach() * t(w)).sum()) == 1.0  # argmax bin 0
    g = torch.autograd.grad((mode * t(w)).sum(), lg)[0]
    close(g, jax.grad(jmode)(jnp.asarray(logits)), "mode gradient")
    if unimix == 0.0:
        close(g, [[1.0, 2.0, 3.0]] * 2, "identity")
    # jax.random.categorical's Gumbel noise comes from these uniforms
    u = np.asarray(jax.random.uniform(key, logits.shape, minval=TINY, maxval=1.0))
    sample = D.OneHotDist(lg, unimix).sample(t(u))
    jdraw = JD.OneHotDist(jnp.asarray(logits), unimix).sample(key)
    close(sample, jdraw, "sample")
    close(sample.sum(-1), [1.0, 1.0], "one-hot")
    gs = torch.autograd.grad((sample * t(w)).sum(), lg)[0]
    close(gs, jax.grad(jsample)(jnp.asarray(logits)), "sample gradient")
    assert float(gs.abs().sum()) > 0.0
    one_hot = np.eye(3, dtype=np.float32)[[2, 0]]
    close(D.OneHotDist(t(logits), unimix).log_prob(t(one_hot)),
          JD.OneHotDist(jnp.asarray(logits), unimix).log_prob(jnp.asarray(one_hot)), "log_prob")


def test_jax_model_builds_the_same_head():
    """The JAX package's twohot head is a bare Dense named 'value' of 255
    outputs (no Dense_0 level): jax_to_state_dict reads it as such."""
    params = {"model": {"name": "discrete_a2c"},
              "network": {"name": "actor_critic", "value_head": "twohot", "space": {"discrete": {}},
                          "mlp": {"units": [8], "activation": "relu"}}}
    jmodel = JModelBuilder().load(params, actions_num=2, input_shape=(3,))
    jparams, _ = jmodel.init(jax.random.PRNGKey(0), np.zeros((2, 3), np.float32))
    assert set(jparams["params"]["value"]) == {"kernel", "bias"}
    sd = jax_to_state_dict(to_np(jparams))
    assert tuple(sd["a2c_network.value.weight"].shape) == (255, 8)


def test_twohot_value_head_trains_cartpole():
    """tests/test_ppo.py::test_twohot_value_head_trains_cartpole in the port:
    tests/test_ppo.py's CartPole config (16 envs x 32 steps, MLP [32, 32]
    elu, seed 7) with value_head: twohot passes 100 mean reward after 100
    epochs, with a finite value loss (seeds 1-5 and 7 reached 290-385 on a
    CPU)."""
    from test_ppo import cartpole_params

    from rl_games_tpu_torch.algos.ppo import PPOAgent

    params = cartpole_params()
    params["network"]["value_head"] = "twohot"
    agent = PPOAgent("t", params, device="cpu")
    state = agent.init_state()
    for _ in range(100):
        state, m = agent.train_epoch(state)
    assert float(m["mean_rewards"][0]) > 100.0
    assert np.isfinite(float(m["c_loss"]))


def test_jax_importer_looks_for_the_twohot_head_one_level_too_deep(tmp_path):
    """Fault 6 (ROADMAP §3, latent in the JAX package): the torch importer
    reads the value head at value/Dense_0 (torch_import.py:482-491), where
    the two-hot head is a bare nn.Dense (network_builder.py:247-254), so a
    checkpoint of a two-hot model raises KeyError 'Dense_0'. With the JAX
    params nested alike around the call (as for fault 3), the port's
    checkpoint of a trained epoch imports, and the JAX forward gives the
    port's values and logits (rtol 1e-5, atol 1e-5)."""
    from rl_games_tpu.utils.torch_import import convert_a2c_state_dict, load_torch_state_dict

    from rl_games_tpu_torch.algos.ppo import PPOAgent
    from rl_games_tpu_torch.utils import checkpoint as ckpt

    params = load("ppo_cartpole.yaml")
    params["network"]["value_head"] = "twohot"
    agent = PPOAgent("a", params, device="cpu")
    state, _ = agent.train_epoch(agent.init_state())
    path = str(tmp_path / "p.pth")
    ckpt.save_checkpoint(path, state, {}, weights=agent.get_weights())
    sd = load_torch_state_dict(path)
    kw = dict(actions_num=2, input_shape=(4,), normalize_input=agent.normalize_input,
              normalize_value=agent.normalize_value)
    jmodel = JModelBuilder().load(params, **kw)
    jparams, norm = jmodel.init(jax.random.PRNGKey(0), np.zeros((2, 4), np.float32))
    with pytest.raises(KeyError, match="Dense_0"):
        convert_a2c_state_dict(sd, jparams, norm, params["network"], (4,))
    body = jparams["params"]
    body["value"] = {"Dense_0": body["value"]}
    jparams, norm = convert_a2c_state_dict(sd, jparams, norm, params["network"], (4,))
    jparams["params"]["value"] = jparams["params"]["value"]["Dense_0"]
    obs = np.random.default_rng(4).normal(size=(8, 4)).astype(np.float32)
    jres = jmodel.forward_play(jparams, norm, jax.random.PRNGKey(0), obs, deterministic=True)
    with torch.no_grad():
        res = agent.model.forward_play(t(obs), deterministic=True)
    for k in ("values", "logits"):
        np.testing.assert_allclose(res[k].numpy(), np.asarray(jres[k]), rtol=1e-5, atol=1e-5, err_msg=k)
