"""The Noisy layers, the C51 projection, connect4net and the rnd_curiosity
name, in the port against the JAX package.

On the same numpy-seeded inputs:

- ``NoisyLinear`` / ``NoisyFactorizedLinear`` (tests/test_networks.py:327):
  their init (sigma 0.017 and 0.4 / sqrt(fan_in); mu in U(±sqrt(3 / fan_in))
  and U(±1 / sqrt(fan_in))), the mean-weight forward and the noisy forward
  from the JAX key's normal draws, with the params carried across, at rtol
  1e-5 / atol 1e-6; the independent noise is of full rank, the factorized
  noise of rank 1;
- ``CategoricalQ.distr_projection`` (tests/test_ops.py:420) against the
  numpy oracle of the reference's per-atom loop (done rows and the u == l
  split included) and the JAX projection, at 1e-5;
- ``connect4net`` (models/connect4_network.py): the forward and the
  gradients with the JAX params (GroupNorm's epsilon 1e-6, the policy
  conv's flatten permuted), at rtol 1e-5 / 1e-4; ref/ma/
  ppo_connect4_self_play_resnet.yaml loads its network through
  ``import_modules`` and builds its agent over the CONNECT4 env;
- ``network.name: rnd_curiosity`` raises the JAX package's ValueError.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import rl_games_tpu.models.connect4_network  # noqa: F401  (registers the JAX connect4net)
import rl_games_tpu_torch.models.connect4_network  # noqa: F401  (the port's)
from rl_games_tpu.models import layers as JL
from rl_games_tpu.models.model_builder import ModelBuilder as JModelBuilder
from rl_games_tpu.ops.categorical import CategoricalQ as JCategoricalQ
from rl_games_tpu_torch.models import layers as L
from rl_games_tpu_torch.models.model_builder import ModelBuilder
from rl_games_tpu_torch.ops.categorical import CategoricalQ
from rl_games_tpu_torch.runner import Runner
from rl_games_tpu_torch.utils.jax_params import jax_to_state_dict

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


def t(x):
    return torch.from_numpy(np.array(x))


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def close(got, want, err_msg="", rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol, err_msg=err_msg)


# ---------------------------------------------------------------------------
# the Noisy layers
# ---------------------------------------------------------------------------

NOISY = {"independent": (JL.NoisyLinear, L.NoisyLinear, 0.017, np.sqrt(3.0 / 4)),
         "factorized": (JL.NoisyFactorizedLinear, L.NoisyFactorizedLinear, 0.4 / 2.0, np.sqrt(1.0 / 4))}


@pytest.mark.parametrize("kind", sorted(NOISY))
def test_noisy_linear(kind):
    """tests/test_networks.py::test_noisy_linear: sigma at its init, mu
    within its bound; the mean-weight forward and two noisy forwards (JAX
    keys 1 and 2, their normal draws handed to the port) as the JAX
    layer's; the noise differs between the draws and from the mean."""
    jcls, cls, sigma, bound = NOISY[kind]
    x = np.random.default_rng(0).normal(size=(3, 4)).astype(np.float32)
    jlayer = jcls(8)
    jparams = jlayer.init(jax.random.PRNGKey(0), x)
    layer = cls(4, 8, device="cpu")
    layer.reset_parameters(torch.Generator().manual_seed(0))
    close(layer.sigma_weight, np.full((8, 4), sigma), "sigma_weight")
    close(layer.sigma_bias, np.full(8, sigma), "sigma_bias")
    assert float(layer.weight.abs().max()) <= bound and float(layer.bias.abs().max()) <= bound
    np.testing.assert_allclose(np.asarray(jparams["params"]["sigma_w"]), sigma, rtol=1e-6)
    layer.load_state_dict(jax_to_state_dict(to_np(jparams)))
    close(layer(t(x)), jlayer.apply(jparams, x), "mean forward")
    outs = []
    for seed in (1, 2):
        key = jax.random.PRNGKey(seed)
        k1, k2 = jax.random.split(key)
        if kind == "independent":
            noise = (t(np.asarray(jax.random.normal(k1, (4, 8))).T), t(jax.random.normal(k2, (8,))))
        else:
            noise = (t(jax.random.normal(k1, (4,))), t(jax.random.normal(k2, (8,))))
        out = layer(t(x), noise=noise)
        close(out, jlayer.apply(jparams, x, noise_key=key), f"noisy forward, key {seed}")
        outs.append(out.detach())
    assert not torch.allclose(outs[0], outs[1]) and not torch.allclose(outs[0], layer(t(x)).detach())
    # the weight noise: of full rank for independent draws, of rank 1 factorized
    eye, zero = torch.eye(4), torch.zeros(1, 4)
    gen = torch.Generator().manual_seed(3)
    noise = (torch.randn((8, 4), generator=gen), torch.randn(8, generator=gen)) if kind == "independent" else (
        torch.randn(4, generator=gen), torch.randn(8, generator=gen))
    with torch.no_grad():
        w_noise = (layer(eye, noise=noise) - layer(zero, noise=noise)) - (layer(eye) - layer(zero))
    rank = np.linalg.matrix_rank(w_noise.numpy(), tol=1e-5)
    assert (rank > 1) if kind == "independent" else (rank == 1)


# ---------------------------------------------------------------------------
# CategoricalQ
# ---------------------------------------------------------------------------


def test_categorical_q_projection_matches_reference_loop():
    """tests/test_ops.py::test_categorical_q_projection_matches_reference_loop:
    the numpy oracle of the reference's per-atom scatter loop
    (rl_games/common/categorical.py:11-51), with terminal rows,
    boundary-clipped atoms and exact-bin rewards (the u == l branch); and
    the JAX projection."""
    rng = np.random.RandomState(3)
    B, A = 64, 51
    v_min, v_max, gamma = -10.0, 10.0, 0.9
    logits = rng.randn(B, A)
    next_distr = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    rewards = rng.uniform(-15, 15, B).astype(np.float32)
    rewards[:8] = np.linspace(v_min, v_max, 8)
    dones = rng.rand(B) < 0.3

    delta_z = (v_max - v_min) / (A - 1)
    expected = np.zeros_like(next_distr, dtype=np.float32)
    for atom in range(A):
        tz = np.clip(rewards + (v_min + atom * delta_z) * gamma, v_min, v_max)
        b = (tz - v_min) / delta_z
        lo, up = np.floor(b).astype(int), np.ceil(b).astype(int)
        eq = up == lo
        expected[eq, lo[eq]] += next_distr[eq, atom]
        ne = ~eq
        expected[ne, lo[ne]] += next_distr[ne, atom] * (up - b)[ne]
        expected[ne, up[ne]] += next_distr[ne, atom] * (b - lo)[ne]
    expected[dones] = 0.0
    tz = np.clip(rewards[dones], v_min, v_max)
    b = (tz - v_min) / delta_z
    lo, up = np.floor(b).astype(int), np.ceil(b).astype(int)
    rows = np.where(dones)[0]
    eq = up == lo
    expected[rows[eq], lo[eq]] = 1.0
    expected[rows[~eq], lo[~eq]] = (up - b)[~eq]
    expected[rows[~eq], up[~eq]] = (b - lo)[~eq]

    got = CategoricalQ(A, v_min, v_max).distr_projection(t(next_distr), t(rewards), t(dones), gamma)
    close(got, expected, "oracle", atol=1e-5)
    close(got.sum(-1), np.ones(B), "mass", atol=1e-5)
    jgot = JCategoricalQ(A, v_min, v_max).distr_projection(jnp.asarray(next_distr), jnp.asarray(rewards),
                                                           jnp.asarray(dones), gamma)
    close(got, jgot, "jax", atol=1e-6)


# ---------------------------------------------------------------------------
# connect4net
# ---------------------------------------------------------------------------


def connect4_params(blocks=2, channels=16):
    return {"model": {"name": "discrete_a2c"},
            "network": {"name": "connect4net", "blocks": blocks, "channels": channels}}


def test_connect4net_matches_jax():
    """Two blocks of 16 channels over [B, 6, 7, 2] boards: the train dict
    and the gradients of a loss over it, the JAX params carried across
    (norm scales and biases off their init)."""
    params, shape = connect4_params(), (6, 7, 2)
    rng = np.random.default_rng(1)
    jmodel = JModelBuilder().load(params, actions_num=7, input_shape=shape, obs_shape=shape)
    jparams, jnorm = jmodel.init(jax.random.PRNGKey(0), np.zeros((2, *shape), np.float32))
    jparams = jax.tree.map(lambda x: np.asarray(x) + (0.1 * rng.normal(size=x.shape).astype(np.float32)
                                                      if np.ndim(x) == 1 else 0), jparams)
    model = ModelBuilder().load(params, actions_num=7, input_shape=shape, device="cpu")
    sd = jax_to_state_dict(to_np(jparams))
    assert sorted(sd) == sorted(model.state_dict())
    model.load_state_dict(sd)
    assert model.a2c_network.n0a.eps == 1e-6 and model.a2c_network.n0a.num_groups == 8
    obs = rng.integers(0, 2, (8, *shape)).astype(np.float32)
    actions = rng.integers(0, 7, 8)

    def total(res):
        return res["prev_neglogp"].mean() + res["values"].mean() + 0.1 * res["entropy"].mean()

    def jtotal(p):
        jres = jmodel.forward_train(p, jnorm, obs, jnp.asarray(actions))
        return total(jres), jres

    (_, jres), jgrads = jax.jit(jax.value_and_grad(jtotal, has_aux=True))(jparams)
    res = model.forward_train(t(obs), t(actions))
    for k in ("prev_neglogp", "values", "entropy", "logits"):
        close(res[k], jres[k], k, atol=1e-5)
    total(res).backward()
    want = jax_to_state_dict(to_np(jgrads))
    for name, p in model.named_parameters():
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4, atol=1e-5 * np.abs(w).max() + 1e-12, err_msg=name)


def test_connect4_resnet_config_loads_its_network():
    """ref/ma/ppo_connect4_self_play_resnet.yaml: its import_modules entry
    (rl_games_tpu.models.connect4_network) imports the port's module, which
    registers connect4net; since A12's second part the config builds its
    agent, a connect4net over the CONNECT4 env with its masks."""
    doc = yaml.safe_load((ROOT / "rl_games_tpu/configs/ref/ma/ppo_connect4_self_play_resnet.yaml").read_text())
    runner = Runner(device="cpu")
    runner.load(doc)
    net = ModelBuilder().load(runner.params, actions_num=7, input_shape=(6, 7, 2), device="cpu").a2c_network
    assert type(net).__name__ == "Connect4Net" and net.blocks == doc["params"]["network"]["blocks"]
    agent = runner.create_agent()
    assert type(agent.model.a2c_network).__name__ == "Connect4Net" and agent.use_action_masks
    assert type(agent.vec_env).__name__ == "Connect4SelfPlayVecEnv" and agent.vec_env.num_envs == 4


def test_rnd_curiosity_is_no_policy_network():
    """network.name: rnd_curiosity raises the JAX package's ValueError, word
    for word."""
    params = {"model": {"name": "discrete_a2c"}, "network": {"name": "rnd_curiosity"}}
    with pytest.raises(ValueError) as jerr:
        JModelBuilder().load(params, actions_num=2, input_shape=(3,))
    with pytest.raises(ValueError) as err:
        ModelBuilder().load(params, actions_num=2, input_shape=(3,), device="cpu")
    assert str(err.value) == str(jerr.value)
