"""The port's torsos and policy heads against the JAX package's: separate
actor and critic trunks, the multi-discrete heads, the state-dependent
sigma head, the D2RL MLP (also as SAC's torso), a multi-head value, the
action masks of the discrete models, and the continuous_a2c and
continuous_a2c_tanh models. Weights come from a JAX ``model.init`` and
cross through ``utils/jax_params``; inputs are drawn with numpy from a seed.

Tolerances: forwards at rtol 1e-5 / atol 1e-6 (the same float32 products
in another summation order; 1e-5 absolute where a log-probability sums
over heads or a tanh's log-det is taken); gradients at rtol 1e-4 plus 1e-5
of each tensor's largest entry (a backward pass sums over the batch once
more). Sampled actions are compared exactly where the JAX draws are handed
to the port's sampler.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_games_tpu.models import layers as JL
from rl_games_tpu.models.model_builder import ModelBuilder as JModelBuilder
from rl_games_tpu.models.sac import build_sac_networks as j_build_sac_networks
from rl_games_tpu.ops.running_stats import rms_update_from_batch
from rl_games_tpu_torch.models import distributions as D
from rl_games_tpu_torch.models import layers as L
from rl_games_tpu_torch.models.model_builder import ModelBuilder
from rl_games_tpu_torch.models.sac import build_sac_networks
from rl_games_tpu_torch.utils.jax_params import jax_to_state_dict, sac_jax_to_state_dict

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-6)
OBS, B = 7, 24


def network(space="continuous", separate=True, units=(16, 8), d2rl=False, fixed_sigma=True,
            sigma_init=None, sigma_activation="None", normalization=None):
    cfg = {
        "name": "actor_critic",
        "separate": separate,
        "mlp": {"units": list(units), "activation": "elu", "initializer": {"name": "default"}, "d2rl": d2rl},
    }
    if normalization:
        cfg["normalization"] = normalization
    if space == "continuous":
        cfg["space"] = {"continuous": {
            "mu_activation": "None", "sigma_activation": sigma_activation,
            "mu_init": {"name": "default"},
            "sigma_init": sigma_init or {"name": "const_initializer", "val": 0.0},
            "fixed_sigma": fixed_sigma,
        }}
    else:
        cfg["space"] = {space: None}
    return cfg


def actions_num(space):
    return {"continuous": 3, "discrete": 5, "multi_discrete": (2, 3)}[space]


def build_pair(model_name, net, space, value_size=1, seed=0, normalize=True):
    """(JAX model, params, norm, port model) with the same weights and
    non-trivial normalizer stats."""
    params = {"model": {"name": model_name}, "network": net}
    kw = dict(actions_num=actions_num(space), input_shape=(OBS,), value_size=value_size,
              normalize_input=normalize, normalize_value=normalize)
    jmodel = JModelBuilder().load(params, **kw)
    rng = np.random.default_rng(seed)
    jparams, norm = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((4, OBS), jnp.float32))
    jparams = jax.tree.map(np.asarray, jparams)
    body = jparams["params"]
    if "sigma" in body and not isinstance(body["sigma"], dict):
        body["sigma"] = (rng.normal(size=body["sigma"].shape) * 0.3).astype(np.float32)
    if normalize:
        norm = norm.replace(
            obs=rms_update_from_batch(norm.obs, rng.normal(size=(64, OBS)).astype(np.float32) * 2 + 1),
            value=rms_update_from_batch(norm.value, rng.normal(size=(64, value_size)).astype(np.float32) * 5),
        )
    norm = jax.tree.map(np.asarray, norm)
    pmodel = ModelBuilder().load(params, device="cpu", **kw)
    pmodel.load_state_dict(jax_to_state_dict(jparams, norm, network=net))
    return jmodel, jparams, norm, pmodel


def obs_batch(seed=1):
    return (np.random.default_rng(seed).normal(size=(B, OBS)) * 2 + 1).astype(np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


def assert_close(got, want, err_msg="", tol=FWD):
    if isinstance(want, (tuple, list)):
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, f"{err_msg}[{i}]", tol)
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), err_msg=err_msg, **tol)


# ---------------------------------------------------------------------------
# tests/test_networks.py's counterparts
# ---------------------------------------------------------------------------


def test_separate_trunks_have_distinct_params():
    """Two trunks with their own weights; the value reads the critic's, the
    policy the actor's (network_builder.py:216-229)."""
    jmodel, jparams, norm, pmodel = build_pair("continuous_a2c_logstd", network(), "continuous")
    names = set(pmodel.state_dict())
    assert {"a2c_network.actor_mlp.0.weight", "a2c_network.critic_mlp.0.weight"} <= names
    net = pmodel.a2c_network
    assert not torch.equal(net.actor_mlp[0].weight, net.critic_mlp[0].weight)
    obs = t(obs_batch())
    with torch.no_grad():
        before = net(obs)
        net.actor_mlp[0].weight.add_(1.0)
        after = net(obs)
    torch.testing.assert_close(after["value"], before["value"], rtol=0, atol=0)
    assert not torch.allclose(after["mu"], before["mu"])


def test_discrete_and_multidiscrete():
    obs = obs_batch()
    for space, model_name in (("discrete", "discrete_a2c"), ("multi_discrete", "multi_discrete_a2c")):
        jmodel, jparams, norm, pmodel = build_pair(model_name, network(space), space)
        want = jmodel.apply_network(jparams, norm, obs)
        with torch.no_grad():
            got = pmodel.a2c_network(pmodel.norm_obs(t(obs)))
        if space == "discrete":
            assert got["logits"].shape == (B, 5)
        else:
            assert [x.shape for x in got["logits"]] == [(B, 2), (B, 3)]
            assert "a2c_network.logits.1.weight" in pmodel.state_dict()
        assert_close(got["logits"], want["logits"], space)
        assert_close(got["value"], want["value"], space)


@pytest.mark.parametrize("normalization", [None, "layer_norm"])
def test_d2rl_mlp(normalization):
    """The dense-skip MLP: the input joins the features before every layer
    but the first; the norm after the activation on layer 0, before it on
    the others (layers.py:161-195)."""
    jmlp = JL.build_mlp((16, 8, 8), "elu", norm_func_name=normalization, d2rl=True)
    x = obs_batch(2)
    jparams = jax.tree.map(np.asarray, jmlp.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    if normalization:  # scales and biases away from their init
        rng = np.random.default_rng(3)
        for name in ("LayerNorm_0", "LayerNorm_1"):
            for k in ("scale", "bias"):
                jparams["params"][name][k] = rng.normal(size=jparams["params"][name][k].shape).astype(np.float32)
    mlp = L.build_mlp(OBS, (16, 8, 8), "elu", norm_func_name=normalization, d2rl=True, device="cpu")
    assert type(mlp).__name__ == "D2RLMLP"
    assert mlp.linears[1].weight.shape == (8, 16 + OBS)
    sd = {k.split(".", 2)[2]: v for k, v in jax_to_state_dict({"actor_mlp": jparams["params"]},
                                                                         network={"mlp": {"d2rl": True}}).items()}
    mlp.load_state_dict(sd)
    with torch.no_grad():
        got = mlp(t(x))
    assert_close(got, jmlp.apply(jparams, jnp.asarray(x)))
    model = ModelBuilder().load({"model": {"name": "continuous_a2c_logstd"}, "network": network(d2rl=True)},
                                actions_num=2, input_shape=(OBS,), device="cpu")
    with torch.no_grad():
        assert model.forward_play(t(x))["mus"].shape == (B, 2)
    with pytest.raises(ValueError, match="plain sequential MLP only"):
        L.build_mlp(OBS, (8,), "elu", d2rl=True, fused=True)


def test_state_dependent_sigma_const_init_writes_bias():
    """network_builder.py:300-310: a const sigma_init zeroes the sigma head's
    weights and writes its bias."""
    net = network(fixed_sigma=False, sigma_init={"name": "const_initializer", "val": -1.5})
    model = ModelBuilder().load({"model": {"name": "continuous_a2c_logstd"}, "network": net},
                                actions_num=3, input_shape=(OBS,), device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    sigma = model.a2c_network.sigma
    assert torch.all(sigma.weight == 0) and torch.all(sigma.bias == -1.5)
    with torch.no_grad():
        out = model.a2c_network(t(obs_batch()))
    torch.testing.assert_close(out["sigma_raw"], torch.full((B, 3), -1.5), rtol=1e-6, atol=0)
    # the other initializers draw the weights, with a zero bias
    net = network(fixed_sigma=False, sigma_init={"name": "default"})
    model = ModelBuilder().load({"model": {"name": "continuous_a2c_logstd"}, "network": net},
                                actions_num=3, input_shape=(OBS,), device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    assert torch.all(model.a2c_network.sigma.bias == 0) and model.a2c_network.sigma.weight.abs().max() > 0


def test_mu_init_reads_like_the_jax_package():
    """ref/ppo_pendulum.yaml's mu_init {name: default, scale: 0.01}: the JAX
    package's 'default' (and the reference's init_factory, where 'default'
    is nn.Identity) keeps torch's U(±1/sqrt(fan_in)) and reads no scale, so
    the port draws the same."""
    net = network(units=(64,))
    net["space"]["continuous"]["mu_init"] = {"name": "default", "scale": 0.01}
    model = ModelBuilder().load({"model": {"name": "continuous_a2c_logstd"}, "network": net},
                                actions_num=32, input_shape=(OBS,), device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    w = model.a2c_network.mu.weight
    assert w.abs().max() <= 1 / 8 and w.abs().max() > 0.9 / 8
    jparams = JModelBuilder().load({"model": {"name": "continuous_a2c_logstd"}, "network": net}, actions_num=32,
                                   input_shape=(OBS,)).init(jax.random.PRNGKey(0), jnp.zeros((1, OBS)))[0]
    jw = np.asarray(jparams["params"]["mu"]["Dense_0"]["kernel"])
    assert np.abs(jw).max() <= 1 / 8 and np.abs(jw).max() > 0.9 / 8


def test_discrete_model_action_masking():
    """Sampled and deterministic actions stay inside the mask; the masked
    neglogp, entropy and log-probabilities are the JAX package's."""
    jmodel, jparams, norm, pmodel = build_pair("discrete_a2c", network("discrete"), "discrete")
    obs = obs_batch(4)
    rng = np.random.default_rng(5)
    mask = rng.random((B, 5)) < 0.5
    mask[np.arange(B), rng.integers(0, 5, B)] = True
    with torch.no_grad():
        play = pmodel.forward_play(t(obs), generator=torch.Generator().manual_seed(0), action_masks=t(mask))
        det = pmodel.forward_play(t(obs), deterministic=True, action_masks=t(mask))
    for res in (play, det):
        assert mask[np.arange(B), res["actions"].numpy()].all()
    jdet = jmodel.forward_play(jparams, norm, jax.random.PRNGKey(0), obs, action_masks=mask, deterministic=True)
    np.testing.assert_array_equal(det["actions"].numpy(), np.asarray(jdet["actions"]))
    actions = play["actions"].numpy()
    jt = jmodel.forward_train(jparams, norm, obs, actions, action_masks=mask)
    with torch.no_grad():
        pt = pmodel.forward_train(t(obs), t(actions), action_masks=t(mask))
    for k in ("prev_neglogp", "values", "entropy", "logits"):
        assert_close(pt[k], jt[k], k)
    # the logits of masked actions are the fill, so their probabilities are 0
    assert torch.all(torch.exp(pt["logits"])[~t(mask)] == 0)


def test_tanh_model_train_play_consistency():
    """continuous_a2c_tanh: squashed actions; the train neglogp of a played
    action is its play neglogp; the deterministic action is tanh(mu); the
    sampled entropy from the same normals is the JAX package's."""
    jmodel, jparams, norm, pmodel = build_pair("continuous_a2c_tanh", network(fixed_sigma=False), "continuous")
    obs = obs_batch(6)
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(9), (B, 3)))
    with torch.no_grad():
        play = pmodel.forward_play(t(obs), generator=torch.Generator().manual_seed(1))
        assert play["actions"].abs().max() <= 1.0
        train = pmodel.forward_train(t(obs), play["actions"], entropy_noise=t(noise))
        det = pmodel.forward_play(t(obs), deterministic=True)
    np.testing.assert_allclose(train["prev_neglogp"].numpy(), play["neglogpacs"].numpy(), rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(det["actions"], torch.tanh(det["mus"]), rtol=1e-6, atol=0)
    jdet = jmodel.forward_play(jparams, norm, jax.random.PRNGKey(2), obs, deterministic=True)
    for k in ("actions", "neglogpacs", "values", "mus", "sigmas"):
        assert_close(det[k], jdet[k], k, dict(rtol=1e-5, atol=1e-5))
    jt = jmodel.forward_train(jparams, norm, obs, play["actions"].numpy(), entropy_key=jax.random.PRNGKey(9))
    for k in ("prev_neglogp", "values", "entropy", "mus", "sigmas"):
        assert_close(train[k], jt[k], k, dict(rtol=1e-5, atol=1e-5))
    with pytest.raises(ValueError, match="entropy_noise"):
        pmodel.forward_train(t(obs), play["actions"])


# ---------------------------------------------------------------------------
# each new model's forward_play and forward_train against the JAX package
# ---------------------------------------------------------------------------

CASES = {
    # ref/ppo_pendulum.yaml's network: separate trunks, a state-dependent sigma
    "logstd_state_sigma": ("continuous_a2c_logstd", dict(fixed_sigma=False), "continuous", 1),
    "logstd_value2": ("continuous_a2c_logstd", dict(separate=False), "continuous", 2),
    "continuous_a2c_softplus": ("continuous_a2c", dict(sigma_activation="softplus"), "continuous", 1),
    "continuous_a2c_state_sigma": ("continuous_a2c", dict(fixed_sigma=False, sigma_activation="softplus",
                                                          sigma_init={"name": "default"}), "continuous", 1),
    "tanh_d2rl": ("continuous_a2c_tanh", dict(d2rl=True), "continuous", 1),
    "discrete_masked_value2": ("discrete_a2c", {}, "discrete", 2),
    "multi_discrete_masked_value2": ("multi_discrete_a2c", {}, "multi_discrete", 2),
    "multi_discrete_layer_norm": ("multi_discrete_a2c", dict(normalization="layer_norm"), "multi_discrete", 1),
}


def case_masks(space, rng):
    if space == "discrete":
        m = rng.random((B, 5)) < 0.6
        m[:, 0] = True
        return m
    if space == "multi_discrete":
        ms = tuple(rng.random((B, n)) < 0.6 for n in (2, 3))
        for m in ms:
            m[:, 1] = True
        return ms
    return None


def to_t(masks):
    return tuple(t(m) for m in masks) if isinstance(masks, tuple) else t(masks)


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_forwards_match_jax(case):
    model_name, net_kw, space, value_size = CASES[case]
    jmodel, jparams, norm, pmodel = build_pair(model_name, network(space, **net_kw), space, value_size, seed=7)
    obs = obs_batch(8)
    rng = np.random.default_rng(9)
    masks = case_masks(space, rng)
    if "masked" not in case:
        masks = None
    mkw = {} if masks is None else {"action_masks": masks}
    pkw = {} if masks is None else {"action_masks": to_t(masks)}
    valid = case_masks(space, rng) if masks is None else masks  # where to draw train actions from
    jp = jmodel.forward_play(jparams, norm, jax.random.PRNGKey(0), obs, deterministic=True, **mkw)
    with torch.no_grad():
        pp = pmodel.forward_play(t(obs), deterministic=True, **pkw)
    assert pp["values"].shape == (B, value_size)
    if space == "continuous":
        assert_close(pp["actions"], jp["actions"], "actions", dict(rtol=1e-5, atol=1e-5))
    else:
        np.testing.assert_array_equal(pp["actions"].numpy(), np.asarray(jp["actions"]))
    for k in ("neglogpacs", "values"):
        assert_close(pp[k], jp[k], k, dict(rtol=1e-5, atol=1e-5))
    # forward_train at actions away from the mode
    if space == "continuous":
        actions = np.clip(rng.normal(size=(B, 3)) * 0.5, -0.9, 0.9).astype(np.float32)
    elif space == "discrete":
        actions = np.argmax(np.where(valid, rng.random((B, 5)), -1), -1)
    else:
        actions = np.stack([np.argmax(np.where(m, rng.random(m.shape), -1), -1) for m in valid], -1)
    extra = {}
    if model_name == "continuous_a2c_tanh":  # the entropy's normals: the JAX key's
        key = jax.random.PRNGKey(11)
        extra, mkw = dict(entropy_noise=t(jax.random.normal(key, (B, 3)))), dict(entropy_key=key)
    jt = jmodel.forward_train(jparams, norm, obs, actions, **mkw)
    with torch.no_grad():
        pt = pmodel.forward_train(t(obs), t(actions), **pkw, **extra)
    keys = ("prev_neglogp", "values", "entropy") + (("mus", "sigmas") if space == "continuous" else ("logits",))
    for k in keys:
        assert_close(pt[k], jt[k], k, dict(rtol=1e-5, atol=1e-5))
    if space == "multi_discrete":
        kl = pmodel.kl(pt["logits"], tuple(x + 0.1 * torch.arange(x.shape[-1]) for x in pt["logits"]))
        assert_close(kl, jmodel.kl(jt["logits"], tuple(x + 0.1 * jnp.arange(x.shape[-1]) for x in jt["logits"])),
                     "kl", dict(rtol=1e-5, atol=1e-6))


def test_separate_state_sigma_gradients_match():
    """ref/ppo_pendulum.yaml's network: one loss's gradients through both
    trunks, the sigma head and the value head."""
    jmodel, jparams, norm, pmodel = build_pair("continuous_a2c_logstd", network(fixed_sigma=False), "continuous",
                                               seed=3)
    obs = obs_batch(4)
    rng = np.random.default_rng(5)
    actions = rng.normal(size=(B, 3)).astype(np.float32)
    target = rng.normal(size=(B, 1)).astype(np.float32)

    def jloss(p):
        out = jmodel.forward_train(p, norm, obs, actions)
        return (out["prev_neglogp"].mean() + jnp.square(out["values"] - target).mean()
                - 0.01 * out["entropy"].mean())

    jgrads = jax_to_state_dict(jax.tree.map(np.asarray, jax.grad(jloss)(jparams)))
    out = pmodel.forward_train(t(obs), t(actions))
    ploss = (out["prev_neglogp"].mean() + torch.square(out["values"] - t(target)).mean()
             - 0.01 * out["entropy"].mean())
    np.testing.assert_allclose(ploss.item(), float(jloss(jparams)), **FWD)
    ploss.backward()
    for name, p in pmodel.named_parameters():
        want = jgrads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-4, atol=1e-5 * np.abs(want).max() + 1e-12,
                                   err_msg=name)


def test_sac_d2rl_torso_matches_jax():
    """SAC's actor and twin critic over D2RL trunks, from the JAX package's
    weights (trunk.0.linears.{i}, the head trunk.1)."""
    net = {"mlp": {"units": [16, 16], "activation": "relu", "initializer": {"name": "default"}, "d2rl": True},
           "log_std_bounds": [-5, 2]}
    jactor, jcritic = j_build_sac_networks(net, 2)
    obs, act = obs_batch(7), np.random.default_rng(8).uniform(-1, 1, (B, 2)).astype(np.float32)
    ja = jax.tree.map(np.asarray, jactor.init(jax.random.PRNGKey(0), obs))
    jc = jax.tree.map(np.asarray, jcritic.init(jax.random.PRNGKey(1), obs, act))
    actor, critic = build_sac_networks(net, OBS, 2, device="cpu")
    sd = sac_jax_to_state_dict(ja, jc, d2rl=True)
    actor.load_state_dict(sd["actor"])
    critic.load_state_dict(sd["critic"])
    assert "trunk.0.linears.1.weight" in sd["actor"] and "Q2.1.weight" in sd["critic"]
    with torch.no_grad():
        mu, std = actor(t(obs))
        q1, q2 = critic(t(obs), t(act))
    jmu, jstd = jactor.apply(ja, obs)
    jq1, jq2 = jcritic.apply(jc, obs, act)
    for got, want in ((mu, jmu), (std, jstd), (q1, jq1), (q2, jq2)):
        assert_close(got, want)


@pytest.mark.parametrize("patch, item", [
    ({"rnn": {"name": "lstm", "units": 8, "layers": 1}}, None),
    ({"central_value": True}, None),
    ({"space": {}}, None),
    ({"value_head": "twohot"}, None),
    ({"name": "resnet_actor_critic", "cnn": {"conv_depths": [4, 8]}}, None),
], ids=["rnn", "central_value", "no_action_space", "twohot", "resnet"])
def test_unported_torso_options_name_their_item(patch, item):
    """The torso options that once named their ROADMAP item build and compute
    what the JAX torso computes: those A9 ported (an RNN, a central value
    net, a network without an action space) and those of A8 (b) (the
    two-hot value head, the resnet builder's Impala tower, here on separate
    trunks over 8x8x2 frames): the deterministic play forward from zero
    states, the weights carried across, at rtol 1e-5 / atol 1e-6."""
    assert item is None  # nothing of the torso is left to port
    net = {**network("discrete"), **patch}
    shape = (8, 8, 2) if "cnn" in patch else (OBS,)
    value_only = patch.get("central_value") or patch.get("space") == {}
    params = {"model": {"name": "central_value" if value_only else "discrete_a2c"}, "network": net}
    kw = dict(actions_num=None if value_only else 5, input_shape=shape)
    jmodel = JModelBuilder().load(params, **kw)
    obs = np.random.default_rng(3).normal(size=(B, *shape)).astype(np.float32)
    jparams, norm = jmodel.init(jax.random.PRNGKey(0), obs[:2], rnn_states=jmodel.get_default_rnn_state(2))
    model = ModelBuilder().load(params, **kw, device="cpu")
    model.load_state_dict(jax_to_state_dict(jax.tree.map(np.asarray, jparams), network=net, input_shape=shape))
    with torch.no_grad():
        out = (model.forward_play(torch.from_numpy(obs)) if value_only
               else model.forward_play(torch.from_numpy(obs), deterministic=True))
    jout = (jmodel.forward_play(jparams, norm, None, obs) if value_only
            else jmodel.forward_play(jparams, norm, jax.random.PRNGKey(0), obs, deterministic=True))
    assert out["values"].shape == (B, 1) and ("actions" in out) != bool(value_only)
    for k in ("values",) if value_only else ("values", "logits", "actions"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]), err_msg=k, **FWD)


def test_normal_tanh_distribution_matches_jax():
    from rl_games_tpu.models import distributions as JD

    rng = np.random.default_rng(12)
    loc, raw = rng.normal(size=(B, 3)).astype(np.float32), rng.normal(size=(B, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    noise = np.asarray(jax.random.normal(key, (B, 3)))
    jd, pd = JD.NormalTanhDistribution(loc, raw), D.NormalTanhDistribution(t(loc), t(raw))
    jact, jpre = jd.sample(key)
    pact, ppre = pd.sample(t(noise))
    for got, want in ((pact, jact), (ppre, jpre), (pd.entropy(t(noise)), jd.entropy(key)), (pd.mode(), jd.mode()),
                      (pd.log_prob(pact, ppre), jd.log_prob(jact, jpre))):
        assert_close(got, want, tol=dict(rtol=1e-5, atol=1e-5))


def test_sac_agent_trains_over_d2rl_trunks():
    """sac_pendulum.yaml with mlp.d2rl: the SAC agent builds its D2RL
    actor and critics and runs update epochs on the CPU."""
    from pathlib import Path

    import yaml

    from rl_games_tpu_torch.algos.sac import SACAgent

    root = Path(__file__).resolve().parent.parent
    params = yaml.safe_load((root / "rl_games_tpu" / "configs" / "sac_pendulum.yaml").read_text())["params"]
    params["network"]["mlp"]["d2rl"] = True
    params["config"].update(num_actors=4, batch_size=32, replay_buffer_size=256, num_warmup_steps=1,
                            num_steps_per_episode=2)
    agent = SACAgent("t", params, device="cpu")
    assert type(agent.actor.trunk[0]).__name__ == "D2RLMLP"
    state = agent.init_state()
    for _ in range(3):
        state, metrics = agent.train_epoch(state)
    assert all(np.isfinite(float(metrics[k])) for k in ("actor_loss", "critic_loss"))
