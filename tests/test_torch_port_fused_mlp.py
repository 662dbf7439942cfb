"""The port's fused MLP (ops/fused_mlp.py, models/layers.FusedMLP) against
the JAX package's, on the CPU: the plain chain and the CPU route of
``fused_mlp`` against the JAX ``plain_mlp`` and against the Pallas kernel
in interpret mode; gradients; parameter-layout interchange; the kernel's
launch plan and the wrapper's refusals; and a plain PyTorch rehearsal of the
kernel's numeric scheme (3xTF32 with a model of the tensor core's truncating
adder) against the chain in float64. The CUDA kernel
itself runs only on a card: ``chip_smoke.py`` holds it against ``plain_mlp``
there.

Weights are carried across transposed: the JAX package keeps [in, out]
kernels, ``torch.nn.Linear`` [out, in].
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

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


def init_scale_net(seed, dims, batch, x_scale=1.0, w_scale=1.0):
    """x ~ x_scale N(0, 1) and [out, in] weights ~ w_scale U(+-1/sqrt(in)),
    the model's default init (chip_smoke.py's ``mlp_inputs``), as tensors:
    activations stay of order 1, so atol = 2e-5 is a float32 statement."""
    rng = np.random.default_rng(seed)
    ws = [((rng.random((dims[i + 1], dims[i])) * 2 - 1) * (w_scale / np.sqrt(dims[i]))).astype(np.float32)
          for i in range(len(dims) - 1)]
    bs = [(rng.normal(size=(dims[i + 1],)) * 0.1).astype(np.float32) for i in range(len(dims) - 1)]
    x = (rng.normal(size=(batch, dims[0])) * x_scale).astype(np.float32)
    return torch.from_numpy(x), [torch.from_numpy(w) for w in ws], [torch.from_numpy(b) for b in bs]


def tf32_round(x):
    """float32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero, as ``cvt.rna.tf32.f32``), by bit operations on the int32 view."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_leading_bits(x):
    """float32 cut to its leading 10 mantissa bits, as the tensor core reads
    an operand that was not rounded first."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def truncate_to_float32(v):
    """float64 -> float32 rounded towards zero, as the tensor core's adder
    rounds its sum (csrc/fused_mlp.cu's notes)."""
    y = v.float()
    return torch.where(y.double().abs() > v.abs(), torch.nextafter(y, torch.zeros_like(y)), y)


def tensor_core_step(acc, a, w):
    """acc + a @ w.T for one 8-input ``mma.sync`` of TF32 operands: the
    products summed exactly (float64 holds them: each is two 11-bit
    significands), the sum added to the float32 accumulator and the result
    truncated towards zero to float32, once per instruction."""
    return truncate_to_float32(acc.double() + a.double() @ w.double().T)


def emulated_kernel_mlp(x, ws, bs, activation, products: int = 3, fold=None):
    """The arithmetic of ``csrc/fused_mlp.cu`` in plain PyTorch, with a
    model of the tensor core's adder: each operand split as hi = tf32(v)
    and lo = the leading bits of v - hi; per 8 inputs one instruction each
    for a_lo.w_hi and a_hi.w_lo into a small accumulator and a_hi.w_hi into
    the main one, each truncated towards zero (``tensor_core_step``); per
    layer main + small + bias in float32. The layers of a launch that
    streams its input (``fm.launch_plan``) sum the main products per
    32-input weight tile and add each tile's sum into a float32 total with a
    rounding add, as the kernel does there; ``fold`` forces that choice for
    every layer (True, False) or leaves it to the plan (None).
    ``products=1`` keeps a_hi.w_hi alone (plain TF32), which does not hold
    the kernel's tolerance."""
    f = fm._PLAIN_ACTS[fm._activation_code(activation)]
    dims = [x.shape[1]] + [w.shape[0] for w in ws]
    folds = [launch.streamed for launch in fm.launch_plan(dims, x.shape[0])
             for _ in range(launch.first, launch.last)]
    for w, b, folded in zip(ws, bs, folds if fold is None else [fold] * len(ws)):
        k = w.shape[1]
        pad = (0, (-k) % 8)  # the kernel zero-fills the inputs up to a multiple of 8
        a_hi, w_hi = tf32_round(x), tf32_round(w)
        a_lo, w_lo = tf32_leading_bits(x - a_hi), tf32_leading_bits(w - w_hi)
        a_hi, w_hi, a_lo, w_lo = (F.pad(t, pad) for t in (a_hi, w_hi, a_lo, w_lo))
        big = small = total = torch.zeros((x.shape[0], w.shape[0]), dtype=torch.float32)
        last_tile = (k - 1) // 32
        for k0 in range(0, a_hi.shape[1], 8):
            s = slice(k0, k0 + 8)
            if products == 3:
                small = tensor_core_step(small, a_lo[:, s], w_hi[:, s])
            big = tensor_core_step(big, a_hi[:, s], w_hi[:, s])
            if products == 3:
                small = tensor_core_step(small, a_hi[:, s], w_lo[:, s])
            if folded and (k0 + 8) % 32 == 0 and k0 // 32 < last_tile:
                total, big = total + big, torch.zeros_like(big)
        x = f(big + total + small + b)
    return x


def test_tf32_round_is_round_to_nearest():
    """10 mantissa bits kept, the nearest such value, ties away from zero."""
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 - 2.0 ** -23, -1.0 - 2.0 ** -11,
                      1.0 + 3 * 2.0 ** -11, 3.14159274, -0.0, 1e-30], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0, -1.0 - 2.0 ** -10,
                         1.0 + 2.0 ** -9, 3.140625, -0.0, 1e-30], dtype=torch.float32)
    got = tf32_round(x)
    assert torch.equal(got[:-1], want[:-1])
    assert torch.all(got.view(torch.int32) & 0x1FFF == 0)
    assert abs(float(got[-1]) - 1e-30) <= 1e-30 * 2.0 ** -11


# the kernel's accuracy cases: the shape sets at the init scale, then inputs
# 30 times and weights 8 times as large (chip_smoke.py runs the same on the
# card); then the nature-CNN torso's 3136 -> 512, one launch that streams its
# input, at the init scale and with inputs 30 times as large
SCHEME_CASES = [(dims, batch, 1.0, 1.0) for dims, batch in SHAPES] + [
    ((26, 256, 128, 64), 512, 30.0, 1.0),
    ((130, 257), 1030, 1.0, 8.0),
    ((3136, 512), 64, 1.0, 1.0),
    ((3136, 512), 64, 30.0, 1.0),
]


def exact_mlp(x, ws, bs, activation):
    """``plain_mlp`` in float64: the chain's exact result, to float32's
    grade (at 3136 inputs of 30 the float32 chain is itself 0.83-0.95 of
    rtol = atol = 2e-5 away from it)."""
    return fm.plain_mlp(x.double(), [w.double() for w in ws], [b.double() for b in bs], activation).numpy()


@pytest.mark.parametrize("activation", ["elu", "tanh"])
@pytest.mark.parametrize("dims,batch,x_scale,w_scale", SCHEME_CASES)
def test_3xtf32_scheme_holds_the_tolerance(activation, dims, batch, x_scale, w_scale):
    """The kernel's arithmetic rehearsed in plain PyTorch: TF32 halves by bit
    operations (hi rounded to nearest, lo cut to its leading bits), three
    products per layer, the tensor core's truncating adder once per 8
    inputs, float32 sums, and the streamed launch's sum per weight tile. It
    agrees with the exact chain (``plain_mlp`` in float64) within the
    kernel's rtol = atol = 2e-5; one TF32 product per layer does not, so the
    comparison can fail."""
    x, ws, bs = init_scale_net(3, dims, batch, x_scale, w_scale)
    with torch.no_grad():
        want = exact_mlp(x, ws, bs, activation)
        three = emulated_kernel_mlp(x, ws, bs, activation).numpy()
        one = emulated_kernel_mlp(x, ws, bs, activation, products=1).numpy()
    np.testing.assert_allclose(three, want, rtol=2e-5, atol=2e-5)
    assert not np.allclose(one, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("activation", ["elu", "tanh"])
def test_streamed_layer_needs_the_sum_per_tile(activation):
    """The accuracy trap of a 3136-input layer: with one running a_hi.w_hi
    sum over its 392 instructions (the held launch's accumulation) the
    truncations, all towards zero, put the result 12 times the tolerance
    away from the exact chain at inputs of 30; the streamed launch's sum per
    32-input tile holds it (the case above)."""
    x, ws, bs = init_scale_net(3, (3136, 512), 64, 30.0)
    with torch.no_grad():
        running = emulated_kernel_mlp(x, ws, bs, activation, fold=False).numpy()
    assert not np.allclose(running, exact_mlp(x, ws, bs, activation), rtol=2e-5, atol=2e-5)


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
    # flagship torso: the buffers hold widths {26, 128} and {256};
    # 136 = 8 * 17 and 264 = 8 * 33 are 8 * odd
    ((26, 256, 128, 64), 32768, (32, 136, 264)),
    ((26, 256, 128, 64), 8192, (32, 136, 264)),
    ((26, 256, 128, 64), 4224, (32, 136, 264)),  # 132 SMs * 2 blocks * 16 rows
    ((26, 256, 128, 64), 4096, (16, 136, 264)),  # 16-row tiles are all resident at once
    ((26, 256, 128, 64), 2048, (16, 136, 264)),
    ((4, 8), 1, (16, 8, 0)),  # one layer: nothing in the odd buffer
    ((37, 50, 33, 7), 19, (16, 40, 56)),  # 37 -> 40 = 8 * 5; 50 -> 56 = 8 * 7
    ((130, 257), 1030, (16, 136, 0)),  # 130 -> 136
])
def test_kernel_plan(dims, batch, expected):
    rows, s0, s1, shared = fm.kernel_plan(dims, batch)
    assert (rows, s0, s1) == expected
    # both activation buffers and the ring of three 128 x 32 weight tiles
    # (row stride 40)
    assert shared == 4 * (rows * (s0 + s1) + 3 * 128 * 40) <= fm.MAX_SHARED_BYTES
    for stride, widths in ((s0, dims[:-1][0::2]), (s1, dims[:-1][1::2])):
        assert stride == 0 if not widths else stride % 16 == 8 and stride >= (max(widths) + 7) // 8 * 8


def test_kernel_plan_limits():
    with pytest.raises(ValueError, match="block limit"):
        fm.kernel_plan((64, 4096, 4096, 8), 100)
    with pytest.raises(ValueError, match="1 to 8 layers"):
        fm.kernel_plan((4,) * 10, 100)
    # a wide net takes a smaller tile rather than fail
    assert fm.kernel_plan((64, 1024, 1024, 8), 100000)[0] == 16
    # two 32-row blocks of the flagship torso fit one SM's 228 KB together
    # (1 KB of each block is the system's)
    assert 2 * (fm.kernel_plan((26, 256, 128, 64), 8192)[3] + 1024) <= 228 * 1024
