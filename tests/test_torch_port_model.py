"""The port's continuous A2C model against the JAX package's, with weights
carried across from a JAX ``model.init`` through ``utils/jax_params``.

Tolerances: forwards at rtol 1e-5 / atol 1e-6, since both run the same
float32 products and differ only in summation order; gradients at rtol
1e-4 / atol 1e-6, since a backward pass sums over the batch once more.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_games_tpu.models.model_builder import ModelBuilder as JModelBuilder
from rl_games_tpu.ops.running_stats import rms_update_from_batch
from rl_games_tpu.utils.torch_import import convert_a2c_state_dict
from rl_games_tpu_torch.models.model_builder import ModelBuilder
from rl_games_tpu_torch.utils.jax_params import jax_to_state_dict

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
OBS, ACT, B = 26, 8, 48


def network_cfg(units=(32, 16), normalization=None):
    cfg = {
        "name": "actor_critic",
        "separate": False,
        "mlp": {"units": list(units), "activation": "elu", "initializer": {"name": "default"}},
        "space": {"continuous": {
            "mu_activation": "None", "sigma_activation": "None",
            "mu_init": {"name": "default"},
            "sigma_init": {"name": "const_initializer", "val": 0.0},
            "fixed_sigma": True,
        }},
    }
    if normalization:
        cfg["normalization"] = normalization
    return cfg


def build_pair(seed=0, normalization=None):
    """(JAX model, params, norm, port model) with identical weights and
    non-trivial normalizer stats."""
    params = {"model": {"name": "continuous_a2c_logstd"}, "network": network_cfg(normalization=normalization)}
    kw = dict(actions_num=ACT, input_shape=(OBS,), normalize_input=True, normalize_value=True)
    jmodel = JModelBuilder().load(params, **kw)
    rng = np.random.default_rng(seed)
    jparams, norm = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((4, OBS), jnp.float32))
    jparams = jax.tree.map(np.asarray, jparams)
    jparams["params"]["sigma"] = rng.normal(size=ACT).astype(np.float32) * 0.3
    norm = norm.replace(
        obs=rms_update_from_batch(norm.obs, rng.normal(size=(64, OBS)).astype(np.float32) * 2 + 1),
        value=rms_update_from_batch(norm.value, rng.normal(size=(64, 1)).astype(np.float32) * 5),
    )
    norm = jax.tree.map(np.asarray, norm)
    pmodel = ModelBuilder().load(params, device="cpu", **kw)
    pmodel.load_state_dict(jax_to_state_dict(jparams, norm))
    return jmodel, jparams, norm, pmodel


def inputs(seed=1):
    rng = np.random.default_rng(seed)
    obs = (rng.normal(size=(B, OBS)) * 2 + 1).astype(np.float32)
    actions = rng.normal(size=(B, ACT)).astype(np.float32)
    return obs, actions


@pytest.mark.parametrize("normalization", [None, "layer_norm"])
def test_forward_train_and_play(normalization):
    jmodel, jparams, norm, pmodel = build_pair(normalization=normalization)
    obs, actions = inputs()
    jt = jmodel.forward_train(jparams, norm, obs, actions)
    with torch.no_grad():
        pt = pmodel.forward_train(torch.from_numpy(obs), torch.from_numpy(actions))
    for k in ("prev_neglogp", "values", "entropy", "mus", "sigmas"):
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(jt[k]), err_msg=k, **FWD)
    jp = jmodel.forward_play(jparams, norm, jax.random.PRNGKey(0), obs, deterministic=True)
    with torch.no_grad():
        pp = pmodel.forward_play(torch.from_numpy(obs), deterministic=True)
    for k in ("neglogpacs", "values", "actions", "mus", "sigmas"):
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]), err_msg=k, **FWD)


def test_gradients_match():
    jmodel, jparams, norm, pmodel = build_pair(seed=3)
    obs, actions = inputs(seed=4)
    target = np.random.default_rng(5).normal(size=(B, 1)).astype(np.float32)

    def jloss(p):
        out = jmodel.forward_train(p, norm, obs, actions)
        return (out["prev_neglogp"].mean() + jnp.square(out["values"] - target).mean()
                - 0.01 * out["entropy"].mean() + jnp.square(out["mus"]).mean())

    jgrads = jax.tree.map(np.asarray, jax.grad(jloss)(jparams))
    out = pmodel.forward_train(torch.from_numpy(obs), torch.from_numpy(actions))
    ploss = (out["prev_neglogp"].mean() + torch.square(out["values"] - torch.from_numpy(target)).mean()
             - 0.01 * out["entropy"].mean() + torch.square(out["mus"]).mean())
    np.testing.assert_allclose(ploss.item(), float(jloss(jparams)), **FWD)
    ploss.backward()
    expected = jax_to_state_dict(jgrads)  # a grad tree has the params' layout
    for name, p in pmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), expected[name].numpy(), err_msg=name, **GRAD)


def test_neglogp_and_entropy_of_sampled_actions():
    jmodel, jparams, norm, pmodel = build_pair(seed=6)
    obs, _ = inputs(seed=7)
    noise = np.random.default_rng(8).normal(size=(B, ACT)).astype(np.float32)
    jt = jmodel.forward_train(jparams, norm, obs, np.zeros((B, ACT), np.float32))
    acts = np.asarray(jt["mus"]) + np.asarray(jt["sigmas"]) * noise
    jt = jmodel.forward_train(jparams, norm, obs, acts)
    with torch.no_grad():
        pt = pmodel.forward_train(torch.from_numpy(obs), torch.from_numpy(acts))
    np.testing.assert_allclose(pt["prev_neglogp"].numpy(), np.asarray(jt["prev_neglogp"]), **FWD)
    np.testing.assert_allclose(pt["entropy"].numpy(), np.asarray(jt["entropy"]), **FWD)


def test_state_dict_round_trips_through_jax_converter():
    """A port state_dict() is a reference-layout checkpoint: the JAX
    package's own importer maps it back onto the JAX params unchanged."""
    jmodel, jparams, norm, pmodel = build_pair(seed=9)
    sd = {k: v.numpy() for k, v in pmodel.state_dict().items()}
    back, back_norm = convert_a2c_state_dict(sd, jparams, norm, network_cfg(), (OBS,))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jparams), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), a, err_msg=jax.tree_util.keystr(path))
    for a, b in zip(jax.tree.leaves(norm), jax.tree.leaves(back_norm)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_fused_mlp_refused():
    """mlp.fused: true builds the fused torso; with a normalization it is
    refused, as in the JAX package (the fused kernel has no norm layer)."""
    params = {"model": {"name": "continuous_a2c_logstd"}, "network": network_cfg()}
    params["network"]["mlp"]["fused"] = True
    model = ModelBuilder().load(params, actions_num=ACT, input_shape=(OBS,), device="cpu")
    assert type(model.a2c_network.actor_mlp).__name__ == "FusedMLP"
    params["network"]["normalization"] = "layer_norm"
    with pytest.raises(ValueError, match="plain sequential MLP only"):
        ModelBuilder().load(params, actions_num=ACT, input_shape=(OBS,), device="cpu")
