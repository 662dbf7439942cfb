"""The port's fused MLP (ops/fused_mlp.py, models/layers.FusedMLP) against
the JAX package's, on the CPU: the plain chain and the CPU route of
``fused_mlp`` against the JAX ``plain_mlp`` and against the Pallas kernel
in interpret mode; gradients; parameter-layout interchange; the kernel's
launch plan and the wrapper's refusals. The CUDA kernel itself runs only on
a card: ``chip_smoke.py`` holds it against ``plain_mlp`` there.

Weights are carried across transposed: the JAX package keeps [in, out]
kernels, ``torch.nn.Linear`` [out, in].
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_games_tpu.models.model_builder import ModelBuilder as JModelBuilder
from rl_games_tpu.ops import fused_mlp as jfm
from rl_games_tpu_torch.models import layers as L
from rl_games_tpu_torch.models.model_builder import ModelBuilder
from rl_games_tpu_torch.ops import fused_mlp as fm
from rl_games_tpu_torch.utils.jax_params import jax_to_state_dict

torch.set_num_threads(1)

ACTIVATIONS = ["relu", "elu", "selu", "softplus", "gelu", "sigmoid", "swish", "tanh", "None"]
# tests/test_fused_mlp.py's shape sets
SHAPES = [
    ((37, 50, 33, 7), 19),      # everything unaligned
    ((26, 256, 128, 64), 512),  # the bench workload's torso
    ((4, 8), 1),                # single row, single layer
    ((130, 257), 1030),         # just past lane/sublane boundaries
]


def random_net(seed, dims, batch):
    """x and [in, out] weights (the JAX layout), as tests/test_fused_mlp.py
    scales them."""
    rng = np.random.default_rng(seed)
    ws = [(rng.normal(size=(dims[i], dims[i + 1])) * 0.3).astype(np.float32) for i in range(len(dims) - 1)]
    bs = [(rng.normal(size=(dims[i + 1],)) * 0.1).astype(np.float32) for i in range(len(dims) - 1)]
    x = rng.normal(size=(batch, dims[0])).astype(np.float32)
    return x, ws, bs


def to_torch(x, ws, bs):
    return (torch.from_numpy(x), [torch.from_numpy(np.ascontiguousarray(w.T)) for w in ws],
            [torch.from_numpy(b) for b in bs])


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("dims,batch", SHAPES)
def test_matches_jax_plain_and_pallas(activation, dims, batch):
    """rtol = atol = 2e-5, the tolerance of tests/test_fused_mlp.py: the
    same float32 products summed in another order."""
    x, ws, bs = random_net(0, dims, batch)
    tx, tws, tbs = to_torch(x, ws, bs)
    with torch.no_grad():
        plain = fm.plain_mlp(tx, tws, tbs, activation).numpy()
        fused = fm.fused_mlp(tx, tws, tbs, activation).numpy()  # the CPU route
    np.testing.assert_array_equal(fused, plain)
    jplain = np.asarray(jfm.plain_mlp(x, ws, bs, activation))
    jpallas = np.asarray(jfm.fused_mlp_pallas(
        jnp.asarray(x), tuple(jnp.asarray(w) for w in ws), tuple(jnp.asarray(b) for b in bs),
        activation, interpret=True, block_b=256))
    np.testing.assert_allclose(plain, jplain, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(plain, jpallas, rtol=2e-5, atol=2e-5)


def test_grads_match_jax():
    """Gradients of the port's fused_mlp (backward through the plain chain)
    against jax.grad through the JAX fused_mlp: rtol 1e-5, atol 1e-6, as
    tests/test_fused_mlp.py::test_fused_mlp_grads_exact."""
    x, ws, bs = random_net(2, (9, 24, 5), 17)

    def jloss(x, ws, bs):
        return jnp.sum(jfm.fused_mlp(x, ws, bs, "elu") ** 2)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)))
    tx, tws, tbs = to_torch(x, ws, bs)
    leaves = [t.requires_grad_(True) for t in (tx, *tws, *tbs)]
    loss = (fm.fused_mlp(leaves[0], leaves[1:3], leaves[3:], "elu") ** 2).sum()
    loss.backward()
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(leaves[0].grad.numpy(), np.asarray(jg[0]), **tol)
    for t, j in zip(leaves[1:3], jg[1]):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j).T, **tol)
    for t, j in zip(leaves[3:], jg[2]):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), **tol)


def test_grads_only_where_needed():
    """An input that needs no gradient (the observations) gets none."""
    x, ws, bs = to_torch(*random_net(3, (6, 5, 4), 7))
    for t in (*ws, *bs):
        t.requires_grad_(True)
    fm.fused_mlp(x, ws, bs, "tanh").sum().backward()
    assert x.grad is None and all(t.grad is not None for t in (*ws, *bs))


def test_fused_module_interchanges_with_plain():
    """Same generator -> identical state_dict keys and values; each loads
    the other's state; same output."""
    plain = L.build_mlp(11, [32, 16], "elu", {"name": "default"}, device="cpu")
    fused = L.build_mlp(11, [32, 16], "elu", {"name": "default"}, fused=True, device="cpu")
    assert isinstance(fused, L.FusedMLP)
    L.reset_parameters(plain, torch.Generator().manual_seed(5))
    L.reset_parameters(fused, torch.Generator().manual_seed(5))
    sp, sf = plain.state_dict(), fused.state_dict()
    assert list(sp) == list(sf) == ["0.weight", "0.bias", "2.weight", "2.bias"]
    for k in sp:
        assert torch.equal(sp[k], sf[k]), k
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(3, 6, 11)).astype(np.float32))
    np.testing.assert_array_equal(fused(x).detach().numpy(), plain(x).detach().numpy())
    L.reset_parameters(plain, torch.Generator().manual_seed(6))
    fused.load_state_dict(plain.state_dict())
    np.testing.assert_array_equal(fused(x[:, ::2]).detach().numpy(), plain(x[:, ::2]).detach().numpy())
    plain.load_state_dict(fused.state_dict())


def test_jax_fused_model_carries_over():
    """A JAX model built with mlp.fused: true goes through jax_to_state_dict
    into the port's fused model: same forward at rtol 1e-5 / atol 1e-5."""
    network = {
        "name": "actor_critic", "separate": False,
        "mlp": {"units": [32, 16], "activation": "elu", "initializer": {"name": "default"}, "fused": True},
        "space": {"continuous": {"mu_activation": "None", "sigma_activation": "None",
                                 "mu_init": {"name": "default"},
                                 "sigma_init": {"name": "const_initializer", "val": 0.0},
                                 "fixed_sigma": True}},
    }
    params = {"model": {"name": "continuous_a2c_logstd"}, "network": network}
    kw = dict(actions_num=8, input_shape=(26,), normalize_input=True, normalize_value=True)
    jmodel = JModelBuilder().load(params, **kw)
    jparams, norm = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((4, 26), jnp.float32))
    pmodel = ModelBuilder().load(params, device="cpu", **kw)
    assert isinstance(pmodel.a2c_network.actor_mlp, L.FusedMLP)
    pmodel.load_state_dict(jax_to_state_dict(jax.tree.map(np.asarray, jparams), jax.tree.map(np.asarray, norm)))
    obs = np.random.default_rng(1).normal(size=(48, 26)).astype(np.float32)
    jp = jmodel.forward_play(jparams, norm, jax.random.PRNGKey(0), obs, deterministic=True)
    with torch.no_grad():
        pp = pmodel.forward_play(torch.from_numpy(obs), deterministic=True)
    for k in ("neglogpacs", "values", "actions", "mus", "sigmas"):
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("kwargs", [{"d2rl": True}, {"norm_func_name": "layer_norm"}])
def test_fused_rejects_d2rl_and_norm(kwargs):
    with pytest.raises(ValueError, match="plain sequential MLP only"):
        L.build_mlp(8, [8], "relu", fused=True, device="cpu", **kwargs)


def test_cuda_wrapper_refuses_cpu_tensor():
    x, ws, bs = to_torch(*random_net(1, (4, 8), 2))
    before = fm.fused_mlp_launches
    with pytest.raises(ValueError, match="CUDA device"):
        fm.fused_mlp_cuda(x, ws, bs, "elu")
    assert fm.fused_mlp_launches == before


def test_unknown_activation_raises():
    x, ws, bs = to_torch(*random_net(1, (4, 8), 2))
    with pytest.raises(ValueError, match="no activation"):
        fm.plain_mlp(x, ws, bs, "mish")


@pytest.mark.parametrize("dims, batch, expected", [
    # flagship torso: buffers hold widths {26, 128} and {256}; 132 = 128 + 4
    # and 260 = 256 + 4 are 4 * odd
    ((26, 256, 128, 64), 32768, (64, 132, 260)),
    ((26, 256, 128, 64), 8192, (32, 132, 260)),  # 8192 rows < 132 SMs * 64
    ((26, 256, 128, 64), 4096, (32, 132, 260)),
    ((26, 256, 128, 64), 2048, (16, 132, 260)),  # 2048 rows < 132 SMs * 16
    ((4, 8), 1, (16, 4, 0)),  # one layer: nothing in the odd buffer
    ((37, 50, 33, 7), 19, (16, 44, 52)),
])
def test_kernel_plan(dims, batch, expected):
    rows, s0, s1, shared = fm.kernel_plan(dims, batch)
    assert (rows, s0, s1) == expected
    assert shared == 4 * (rows * (s0 + s1) + 64 * 36) <= fm.MAX_SHARED_BYTES
    for stride, widths in ((s0, dims[:-1][0::2]), (s1, dims[:-1][1::2])):
        assert stride % 4 == 0 and (stride == 0 or stride >= max(widths))


def test_kernel_plan_limits():
    with pytest.raises(ValueError, match="block limit"):
        fm.kernel_plan((64, 4096, 4096, 8), 100)
    with pytest.raises(ValueError, match="1 to 8 layers"):
        fm.kernel_plan((4,) * 10, 100)
    # a wide net takes a smaller tile rather than fail
    assert fm.kernel_plan((64, 1024, 1024, 8), 100000)[0] == 16
