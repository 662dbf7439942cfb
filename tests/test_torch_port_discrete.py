"""The port's discrete parts against the JAX package: the categorical
functions and their Gumbel-max sampler, the discrete KL, the conv stacks
(``layers.CNN``), the discrete A2C model on a narrowed nature-CNN, and the
checkpoint layout of a CNN model. Weights go from the JAX package's init
to the port through ``utils/jax_params``.

Tolerances: the categorical functions and the conv stacks at rtol 1e-5 /
atol 1e-6 (the same float32 operations in another summation order), a
stack with a LayerNorm over its 4 and 6 channels at atol 2e-5 (a
per-pixel std over so few channels can be small, and dividing by it
multiplies the convs' rounding differences); the
model's forwards at rtol 1e-5 / atol 2e-6, since a conv over 84x84 sums
up to 512 products per output before the 3136-wide flatten; gradients at
rtol 1e-4 plus an absolute 1e-5 of each tensor's largest entry (the first
conv's weight gradient sums 4800 products per entry over the batch and the
positions, and entries that cancel keep only the sum's absolute accuracy).
Sampled actions and checkpoint leaves are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_games_tpu.models import distributions as JD
from rl_games_tpu.models import layers as JL
from rl_games_tpu.models.model_builder import ModelBuilder as JModelBuilder
from rl_games_tpu.ops import divergence as jdiv
from rl_games_tpu.ops.running_stats import rms_update_from_batch
from rl_games_tpu.utils.torch_import import convert_a2c_state_dict
from rl_games_tpu_torch.models import distributions as D
from rl_games_tpu_torch.models import layers as L
from rl_games_tpu_torch.models.model_builder import ModelBuilder
from rl_games_tpu_torch.ops import divergence
from rl_games_tpu_torch.utils.jax_params import jax_to_state_dict
from test_torch_port_impala import models

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
FWD = dict(rtol=1e-5, atol=2e-6)


def t(x):
    return torch.from_numpy(np.array(x))


def logits_and_mask(seed, b=32, a=5):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(b, a)) * 3).astype(np.float32)
    mask = rng.random((b, a)) < 0.6
    mask[np.arange(b), rng.integers(0, a, b)] = True  # one valid action per row at least
    return logits, mask


@pytest.mark.parametrize("masked", [False, True])
def test_categorical_functions_match_jax(masked):
    logits, mask = logits_and_mask(0)
    m = mask if masked else None
    actions = np.random.default_rng(1).integers(0, 5, 32)
    if masked:  # the actions an env would take: valid ones
        actions = np.argmax(mask * np.random.default_rng(2).random(mask.shape), axis=-1)
    tm = None if m is None else t(m)
    np.testing.assert_allclose(D.categorical_log_probs(t(logits), tm).numpy(),
                               np.asarray(JD.categorical_log_probs(logits, m)), **TOL)
    np.testing.assert_allclose(D.categorical_neglogp(t(logits), t(actions), tm).numpy(),
                               np.asarray(JD.categorical_neglogp(logits, actions, m)), **TOL)
    np.testing.assert_allclose(D.categorical_entropy(t(logits), tm).numpy(),
                               np.asarray(JD.categorical_entropy(logits, m)), **TOL)


def test_d_kl_discrete_matches_jax():
    p, _ = logits_and_mask(3)
    q, _ = logits_and_mask(4)
    p_logp, q_logp = (np.asarray(jax.nn.log_softmax(x, axis=-1)) for x in (p, q))
    np.testing.assert_allclose(divergence.d_kl_discrete(t(p_logp), t(q_logp)).numpy(),
                               np.asarray(jdiv.d_kl_discrete(p_logp, q_logp)), **TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_gumbel_max_is_jax_categorical(masked):
    """Given the uniforms jax.random.gumbel draws from a key, the port's
    sampler picks the action jax.random.categorical picks."""
    logits, mask = logits_and_mask(5, b=256)
    m = mask if masked else None
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        u = jax.random.uniform(key, logits.shape, minval=jnp.finfo(jnp.float32).tiny, maxval=1.0)
        want = np.asarray(JD.categorical_sample(key, logits, m))
        got = D.gumbel_max(t(logits), t(u), None if m is None else t(m)).numpy()
        np.testing.assert_array_equal(got, want)
        if masked:
            assert mask[np.arange(len(got)), got].all()


def test_categorical_sample_draws_from_the_distribution():
    """The port's own draws: 20000 samples of one row follow its softmax
    within 4 standard errors."""
    logits = torch.tensor([[1.0, -0.5, 0.3, 2.0]]).repeat(20000, 1)
    samples = D.categorical_sample(logits, torch.Generator().manual_seed(0))
    freq = torch.bincount(samples, minlength=4).double() / 20000
    p = torch.softmax(logits[0].double(), -1)
    assert torch.all((freq - p).abs() < 4 * torch.sqrt(p * (1 - p) / 20000))


CONVS = [{"filters": 4, "kernel_size": 4, "strides": 2, "padding": 0},
         {"filters": 6, "kernel_size": 3, "strides": 1, "padding": 1}]


@pytest.mark.parametrize("ctype, padding, norm", [
    ("conv2d", 0, None),
    ("conv2d", 1, "layer_norm"),
    ("coord_conv2d", 0, None),
    ("conv2d_spatial_softargmax", 1, None),
    ("conv1d", 1, None),
])
def test_cnn_matches_jax(ctype, padding, norm):
    convs = [dict(c, padding=padding) for c in CONVS]
    shape = (6, 13, 3) if ctype == "conv1d" else (6, 15, 13, 3)  # channels last
    x = np.random.default_rng(6).normal(size=shape).astype(np.float32)
    jcnn = JL.CNN(convs=tuple(tuple(sorted(c.items())) for c in convs), activation="elu",
                  initializer={"name": "default"}, norm_func_name=norm, ctype=ctype)
    jparams = jax.tree.map(np.asarray, jcnn.init(jax.random.PRNGKey(0), x))
    want = np.asarray(jcnn.apply(jparams, x))
    pcnn = L.CNN(shape[-1], convs, "elu", initializer={"name": "default"}, norm_func_name=norm,
                 ctype=ctype, device="cpu")
    sd = jax_to_state_dict({"actor_cnn": jparams["params"]}, network={"cnn": {"type": ctype}})
    pcnn.load_state_dict({k[len("a2c_network.actor_cnn."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got = pcnn(t(x).movedim(-1, 1))
    if ctype != "conv2d_spatial_softargmax":
        got = got.movedim(1, -1)  # back to channels last
        assert pcnn.output_size(shape[1:-1]) == np.prod(want.shape[1:])
    np.testing.assert_allclose(got.numpy(), want, **(TOL if norm is None else dict(rtol=1e-5, atol=2e-5)))


def test_cnn_init_draws_the_jax_bounds():
    """'default' draws U(±1/sqrt(kernel height)) for a conv, as the JAX
    package's torch_default_kernel_init does for a flax conv kernel, and
    U(±1/sqrt(fan_in)) for a Linear; biases are zero."""
    cnn = L.CNN(2, [{"filters": 32, "kernel_size": 8, "strides": 4, "padding": 0}], "elu",
                initializer={"name": "default"}, device="cpu")
    L.reset_parameters(cnn, torch.Generator().manual_seed(0))
    w = cnn[0].weight
    assert w.abs().max() <= 1 / np.sqrt(8) and w.abs().max() > 0.9 / np.sqrt(8)
    assert torch.all(cnn[0].bias == 0)
    jw = JL.torch_default_kernel_init(jax.random.PRNGKey(0), (8, 8, 2, 32))
    assert float(jnp.abs(jw).max()) <= 1 / np.sqrt(8)


def nature_params(convs=((4, 8, 4), (8, 4, 2), (8, 3, 1)), units=(16,)):
    """ppo_pong_device.yaml's network, narrowed: filters 4/8/8, MLP [16]."""
    return {
        "model": {"name": "discrete_a2c"},
        "network": {
            "name": "actor_critic", "separate": False, "space": {"discrete": None},
            "cnn": {"type": "conv2d", "activation": "elu", "initializer": {"name": "default"},
                    "convs": [{"filters": f, "kernel_size": k, "strides": s, "padding": 0} for f, k, s in convs]},
            "mlp": {"units": list(units), "activation": "elu",
                    "initializer": {"name": "orthogonal_initializer", "gain": 1.41421356237}},
        },
    }


SHAPE, ACT, B = (84, 84, 2), 3, 12


def build_pair(seed=0):
    """(JAX model, params, norm, port model) with the same weights and
    non-trivial normalizer stats."""
    params = nature_params()
    kw = dict(actions_num=ACT, input_shape=SHAPE, normalize_input=True, normalize_value=True)
    jmodel = JModelBuilder().load(params, **kw)
    rng = np.random.default_rng(seed)
    jparams, norm = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, *SHAPE), jnp.float32))
    jparams = jax.tree.map(np.asarray, jparams)
    norm = norm.replace(
        obs=rms_update_from_batch(norm.obs, rng.random((32, *SHAPE)).astype(np.float32)),
        value=rms_update_from_batch(norm.value, rng.normal(size=(32, 1)).astype(np.float32) * 5),
    )
    norm = jax.tree.map(np.asarray, norm)
    pmodel = ModelBuilder().load(params, device="cpu", **kw)
    pmodel.load_state_dict(jax_to_state_dict(jparams, norm))
    return jmodel, jparams, norm, pmodel


def frames(seed):
    rng = np.random.default_rng(seed)
    return (rng.random((B, *SHAPE)) * (rng.random((B, *SHAPE)) < 0.1)).astype(np.float32)


def test_model_forward_train_and_play():
    jmodel, jparams, norm, pmodel = build_pair()
    obs = frames(1)
    actions = np.random.default_rng(2).integers(0, ACT, B)
    jt = jmodel.forward_train(jparams, norm, obs, actions)
    with torch.no_grad():
        pt = pmodel.forward_train(t(obs), t(actions))
    for k in ("prev_neglogp", "values", "entropy", "logits"):
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(jt[k]), err_msg=k, **FWD)
    jp = jmodel.forward_play(jparams, norm, jax.random.PRNGKey(0), obs, deterministic=True)
    with torch.no_grad():
        pp = pmodel.forward_play(t(obs), deterministic=True)
    np.testing.assert_array_equal(pp["actions"].numpy(), np.asarray(jp["actions"]))
    for k in ("neglogpacs", "values", "logits"):
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]), err_msg=k, **FWD)


def test_model_gradients_match():
    jmodel, jparams, norm, pmodel = build_pair(seed=3)
    obs = frames(4)
    actions = np.random.default_rng(5).integers(0, ACT, B)
    target = np.random.default_rng(6).normal(size=(B, 1)).astype(np.float32)

    def jloss(p):
        out = jmodel.forward_train(p, norm, obs, actions)
        return (out["prev_neglogp"].mean() + jnp.square(out["values"] - target).mean()
                - 0.01 * out["entropy"].mean())

    jgrads = jax.tree.map(np.asarray, jax.grad(jloss)(jparams))
    out = pmodel.forward_train(t(obs), t(actions))
    ploss = (out["prev_neglogp"].mean() + torch.square(out["values"] - t(target)).mean()
             - 0.01 * out["entropy"].mean())
    np.testing.assert_allclose(ploss.item(), float(jloss(jparams)), **FWD)
    ploss.backward()
    expected = jax_to_state_dict(jgrads)  # a grad tree has the params' layout
    for name, p in pmodel.named_parameters():
        want = expected[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-4, atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


def test_cnn_state_dict_round_trips_through_jax_converter():
    """A port CNN model's state_dict() is a reference-layout checkpoint
    (NCHW flatten): the JAX package's importer maps it back onto the JAX
    params exactly."""
    jmodel, jparams, norm, pmodel = build_pair(seed=9)
    sd = {k: v.numpy() for k, v in pmodel.state_dict().items()}
    back, back_norm = convert_a2c_state_dict(sd, jparams, norm, nature_params()["network"], SHAPE)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jparams), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), a, err_msg=jax.tree_util.keystr(path))
    for a, b in zip(jax.tree.leaves(norm), jax.tree.leaves(back_norm)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_cnn_model_names_and_unported_options():
    params = nature_params()
    model = ModelBuilder().load(params, actions_num=ACT, input_shape=SHAPE, device="cpu")
    names = set(model.state_dict())
    assert {"a2c_network.actor_cnn.0.weight", "a2c_network.actor_cnn.4.weight",
            "a2c_network.actor_mlp.0.weight", "a2c_network.logits.weight", "a2c_network.value.weight"} <= names
    assert model.a2c_network.actor_mlp[0].weight.shape == (16, 8 * 7 * 7)
    rnn = {"name": "lstm", "units": 8, "layers": 1}
    # the options A8 (b) ported build, their checkpoint names as the
    # reference's, and compute what the JAX torso computes (the weights
    # carried across; 2 frames, from zero states; rtol 1e-5, atol 1e-5)
    for patch, name in (({"cnn": {"type": "impala", "conv_depths": [16]}}, "a2c_network.cnn.0.conv.conv.weight"),
                        ({"rnn": {**rnn, "before_mlp": True}}, "a2c_network.rnn.rnn.weight_ih_l0"),
                        ({"value_head": "twohot"}, "a2c_network.value.weight")):
        net = {**params["network"], **patch}
        jmodel, jparams, _, model = models(net, SHAPE, actions_num=ACT)
        assert name in model.state_dict()
        obs = np.random.default_rng(1).normal(size=(2, *SHAPE)).astype(np.float32)
        jout = jax.jit(jmodel.network.apply)(jparams, obs)
        with torch.no_grad():
            out = model.a2c_network(torch.from_numpy(obs))
        for k in ("logits", "value"):
            np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]), rtol=1e-5, atol=1e-5, err_msg=str(patch))
    # a conv stack in front of an RNN after the MLP, and a conv central value net, build (A9)
    names = set(ModelBuilder().load({**params, "network": {**params["network"], "rnn": rnn}}, actions_num=ACT,
                                    input_shape=SHAPE, device="cpu").state_dict())
    assert {"a2c_network.actor_cnn.0.weight", "a2c_network.rnn.rnn.weight_hh_l0"} <= names
    cv = {"model": {"name": "central_value"}, "network": {**params["network"], "central_value": True}}
    names = set(ModelBuilder().load(cv, actions_num=None, input_shape=SHAPE, device="cpu").state_dict())
    assert "a2c_network.value.weight" in names and "a2c_network.logits.weight" not in names
    # separate conv trunks build: the critic's stack beside the actor's
    separate = {**params, "network": {**params["network"], "separate": True}}
    names = set(ModelBuilder().load(separate, actions_num=ACT, input_shape=SHAPE, device="cpu").state_dict())
    assert {"a2c_network.critic_cnn.0.weight", "a2c_network.critic_mlp.0.weight"} <= names
