"""The fused MLP over chains that one launch with x held does not take
(ops/fused_mlp.py ``launch_plan``, ``_in_float32``) and the slice that
needs them (ppo_pong_device.yaml with ``network.mlp.fused: true``), on the
CPU.

- ``launch_plan``: every layer in exactly one launch, in order, each launch
  within the block's shared memory and ``MAX_LAYERS``; the nature-CNN torso
  3136 -> 512 one streamed launch (a layer of its own, ``stream_plan``'s
  clusters and rows a block); the deep and wide chains cut where the plan
  says; every chain that one launch took before is that launch with
  ``kernel_plan``'s plan.
- The wrappers' walk through a plan (``fused_mlp_cuda``,
  ``fused_mlp_grouped_cuda``: scratch between launches, slices of the
  weights, set strides, launch counters) with the launch itself replaced by
  the plain chain on the CPU: the kernel runs only on a card
  (``chip_smoke.py`` holds it there). Against ``plain_mlp`` and
  ``plain_mlp_grouped`` at rtol = atol = 1e-6 (the same float32 layers,
  products taken per set).
- Inputs that are not float32: the CUDA route hands float32 copies to the
  kernel and returns x's dtype, as ``fused_mlp_pallas`` does; on the CPU the
  chain keeps x's dtype.
- The port's ``fused_mlp`` at 3136 -> 512 and a 12-layer chain against the
  JAX package's ``fused_mlp_pallas(..., interpret=True)`` and ``plain_mlp``
  from the same numpy inputs, at rtol = atol = 1e-5 (float32 sums of up to
  3136 products in another order); gradients against ``jax.grad`` of the
  JAX ``fused_mlp`` at rtol 1e-5 plus 1e-5 of each tensor's largest entry;
  the grouped chain against
  ``jax.vmap`` of the JAX plain chain at rtol = atol = 1e-5.
- The fused Pong model against the JAX package's (params carried by
  ``utils/jax_params``) at rtol 1e-5 / atol 2e-6 (the conv stack's sums, as
  tests/test_torch_port_discrete.py holds them), and its ``state_dict`` in
  the plain config's model, bit for bit.

Weights are carried across transposed: the JAX package keeps [in, out]
kernels, ``torch.nn.Linear`` [out, in].
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from rl_games_tpu.models.model_builder import ModelBuilder as JModelBuilder
from rl_games_tpu.ops import fused_mlp as jfm
from rl_games_tpu_torch.models import layers as L
from rl_games_tpu_torch.models.model_builder import ModelBuilder
from rl_games_tpu_torch.ops import fused_mlp as fm
from rl_games_tpu_torch.utils.jax_params import jax_to_state_dict

torch.set_num_threads(1)

NATURE = (3136, 512)
FLAGSHIP = (26, 256, 128, 64)
# tests/test_torch_port_fused_mlp.py::test_kernel_plan's chains and the shipped fused torsos
# (chip_smoke.py's): one launch each, as before launch_plan
ONE_LAUNCH = [(FLAGSHIP, 32768), (FLAGSHIP, 8192), (FLAGSHIP, 4224), (FLAGSHIP, 4096), (FLAGSHIP, 2048),
              ((4, 8), 1), ((37, 50, 33, 7), 19), ((130, 257), 1030), ((33, 256, 128, 64), 4096),
              ((41, 256, 128, 64), 32768), ((4, 32, 32), 16), ((5, 128, 64, 32), 64), ((3, 32, 32), 1024),
              ((16, 256, 128, 64), 16), ((6, 128, 64), 8192), ((6, 128, 64), 0), ((64, 1024, 1024, 8), 100000)]


def check_covers(dims, batch, launches):
    """Every layer in one launch, in order; each launch within the limits,
    with kernel_plan's plan of its widths."""
    assert launches[0].first == 0 and launches[-1].last == len(dims) - 1
    for a, b in zip(launches, launches[1:]):
        assert a.last == b.first
    for launch in launches:
        assert 1 <= launch.last - launch.first <= fm.MAX_LAYERS
        rows, _, _, shared = launch.plan
        if launch.streamed:  # one layer, a stream_plan
            assert launch.last - launch.first == 1 and rows in fm.STREAM_STAGES
        else:
            assert rows in fm.TILE_ROWS
        assert shared <= fm.MAX_SHARED_BYTES
        assert launch.plan == fm.kernel_plan(dims[launch.first:launch.last + 1], batch, launch.streamed)


@pytest.mark.parametrize("dims,batch", ONE_LAUNCH)
def test_one_launch_where_one_launch_fits(dims, batch):
    (launch,) = fm.launch_plan(dims, batch)
    assert (launch.first, launch.last, launch.streamed) == (0, len(dims) - 1, False)
    assert launch.plan == fm.kernel_plan(dims, batch)


# the streamed kernel's ring: 1 KB to align, then per stage W's 128 x 32 and x's rows x 32 floats and two barriers
STREAM_SHARED = {16: 1024 + 12 * (4 * 32 * 144 + 16), 32: 1024 + 11 * (4 * 32 * 160 + 16),
                 64: 1024 + 9 * (4 * 32 * 192 + 16)}


@pytest.mark.parametrize("batch,rows,split,cluster,blocks", [
    (512, 16, 4, 2, 128),      # the rollout: 32 row tiles, their outputs split over 4 blocks, one wave
    (4096, 64, 2, 2, 128),     # the minibatch: 64-row blocks read W from L2 once per 64 rows
    (4099, 64, 2, 2, 130),     # ragged: a 65th row tile, still one wave of 132
    (4224, 64, 2, 2, 132), (32768, 64, 1, 1, 512),
    (1024, 32, 4, 2, 128),     # 64-row blocks would leave the card half empty
    (16, 16, 4, 4, 4),         # one row tile: x multicast to the 4 blocks of its outputs
])
def test_nature_torso_is_one_streamed_launch(batch, rows, split, cluster, blocks):
    """3136 -> 512: no buffer holds x (3136 inputs need 200,960 B at 16
    rows beside the ring), so the layer is one streamed launch: the shape
    that stream_plan's model of the card says ends first (rows a block, the
    blocks its 4 output tiles are split over, clusters that share x), a ring
    that fills the block's shared memory; nothing is held."""
    (launch,) = fm.launch_plan(NATURE, batch)
    assert launch == fm.Launch(0, 1, True, fm.StreamPlan(rows, split, cluster, STREAM_SHARED[rows]))
    assert fm.stream_grid(launch.plan, batch) == (blocks, 1)
    with pytest.raises(ValueError, match="block limit"):
        fm.kernel_plan(NATURE, batch)
    # the fused Pong head behind it: a held launch of its own, 512 in the even buffer
    stream, head = fm.launch_plan(NATURE + (64,), batch)
    assert stream == launch and not head.streamed and head.plan[1:3] == (520, 0)


@pytest.mark.parametrize("dims,cuts", [
    ((64, 4096, 4096, 8), [(0, 1, False), (1, 2, True), (2, 3, True)]),  # 4096 held by no buffer
    ((256,) * 10, [(0, 8, False), (8, 9, False)]),  # 9 layers
    ((256,) * 11, [(0, 8, False), (8, 10, False)]),  # 10
    ((256,) * 17, [(0, 8, False), (8, 16, False)]),  # 16
    ((256,) * 18, [(0, 8, False), (8, 16, False), (16, 17, False)]),  # 17
    ((8,) * 13, [(0, 8, False), (8, 12, False)]),  # 12 narrow layers
    ((2000, 2000, 8), [(0, 1, False), (1, 2, False)]),  # 2000 held at 16 rows, but not twice
    ((3136, 512) + (256,) * 9, [(0, 1, True), (1, 9, False), (9, 10, False)]),  # a streamed layer is a launch
    ((3136, 512, 64), [(0, 1, True), (1, 2, False)]),
    ((16, 4000, 8), [(0, 1, False), (1, 2, True)]),
])
def test_launch_plan_cuts(dims, cuts):
    for batch in (3, 8192):
        launches = fm.launch_plan(dims, batch)
        check_covers(dims, batch, launches)
        assert [(launch.first, launch.last, launch.streamed) for launch in launches] == cuts


def test_launch_plan_refuses_no_layers():
    with pytest.raises(ValueError, match="1 layer at least"):
        fm.launch_plan((8,), 4)


def test_kernel_plan_streamed_holds_no_input():
    """A streamed launch is one layer and holds no width: its shared memory
    is the ring of stages alone (W's 128 x 32 tile and the rows by 32
    inputs of x each), whatever its widths; it takes one layer only."""
    assert fm.kernel_plan((3000, 8), 16, streamed=True) == fm.StreamPlan(16, 1, 1, STREAM_SHARED[16])
    assert fm.kernel_plan((20000, 384), 8192, streamed=True) == fm.StreamPlan(64, 1, 1, STREAM_SHARED[64])
    for dims in ((3000, 8, 200), FLAGSHIP):
        with pytest.raises(ValueError, match="one layer"):
            fm.kernel_plan(dims, 16, streamed=True)
    with pytest.raises(ValueError, match="block limit"):
        fm.kernel_plan((3000, 8, 200), 16)  # held, 3000 inputs do not fit beside the ring


def plain_launch(x, out, batch, dims, ws, bs, act, launch, groups, set_strides):
    """fm._launch's stand-in on the CPU: the launch's chain for each set,
    read and written at the set strides as the kernel does, and counted."""
    x_set, out_set, w_sets, b_sets = set_strides
    assert launch.last - launch.first == len(ws) <= fm.MAX_LAYERS and len(dims) == len(ws) + 1

    def at(t, shape, stride, offset):
        return torch.as_strided(t, shape, stride, t.storage_offset() + offset)

    name = next(k for k, v in fm.ACTIVATION_CODES.items() if v == act)
    for g in range(groups):
        xg = at(x, (batch, dims[0]), (dims[0], 1), g * x_set)
        wg = [at(w, (dims[i + 1], dims[i]), (dims[i], 1), g * s) for i, (w, s) in enumerate(zip(ws, w_sets))]
        bg = [at(b, (dims[i + 1],), (1,), g * s) for i, (b, s) in enumerate(zip(bs, b_sets))]
        at(out, (batch, dims[-1]), (dims[-1], 1), g * out_set).copy_(fm.plain_mlp(xg, wg, bg, name))
    fm.fused_mlp_launches += 1


@pytest.fixture
def cpu_launches(monkeypatch):
    """The wrappers' CUDA path on CPU tensors, each launch the plain chain."""
    monkeypatch.setattr(fm, "_launch", plain_launch)
    monkeypatch.setattr(fm, "_check_tensors", lambda x, ws, bs: None)
    monkeypatch.setattr(fm, "fused_mlp_launches", 0)
    monkeypatch.setattr(fm, "fused_mlp_grouped_launches", 0)


def init_scale(seed, dims, batch, groups=None):
    """x ~ N(0, 1), weights [out, in] ~ U(+-1/sqrt(in)), biases ~ 0.1 N(0, 1)
    (the model's default init), as numpy float32; with ``groups`` a set axis
    first."""
    rng = np.random.default_rng(seed)
    lead = () if groups is None else (groups,)
    ws = [((rng.random(lead + (dims[i + 1], dims[i])) * 2 - 1) / np.sqrt(dims[i])).astype(np.float32)
          for i in range(len(dims) - 1)]
    bs = [(rng.normal(size=lead + (dims[i + 1],)) * 0.1).astype(np.float32) for i in range(len(dims) - 1)]
    return rng.normal(size=lead + (batch, dims[0])).astype(np.float32), ws, bs


def tensors(x, ws, bs):
    return torch.from_numpy(x), [torch.from_numpy(w) for w in ws], [torch.from_numpy(b) for b in bs]


TOL = dict(rtol=1e-6, atol=1e-6)
WALKS = [((16, 4000, 8), 3, "elu"), ((8,) * 13, 5, "tanh"), (NATURE + (6,), 4, "relu"), ((6, 2000, 2000, 5), 2, "selu")]


@pytest.mark.parametrize("dims,batch,activation", WALKS)
def test_wrapper_walks_the_plan(cpu_launches, dims, batch, activation):
    """fused_mlp_cuda through several launches (scratch between them, the
    weights sliced) against plain_mlp, one count a launch."""
    x, ws, bs = tensors(*init_scale(0, dims, batch))
    got = fm.fused_mlp_cuda(x, ws, bs, activation)
    torch.testing.assert_close(got, fm.plain_mlp(x, ws, bs, activation), **TOL)
    assert fm.fused_mlp_launches == len(fm.launch_plan(dims, batch))


@pytest.mark.parametrize("dims,batch,activation", WALKS)
def test_grouped_wrapper_walks_the_plan(cpu_launches, dims, batch, activation):
    """fused_mlp_grouped_cuda over G = 3 sets, the first weight shared (set
    stride 0), through several launches (a scratch [G, B, D] at set stride
    B * D between them) against plain_mlp_grouped."""
    x, ws, bs = tensors(*init_scale(1, dims, batch, groups=3))
    ws[0] = ws[0][1]
    got = fm.fused_mlp_grouped_cuda(x, ws, bs, activation)
    torch.testing.assert_close(got, fm.plain_mlp_grouped(x, ws, bs, activation), **TOL)
    launches = len(fm.launch_plan(dims, 0))
    assert fm.fused_mlp_launches == fm.fused_mlp_grouped_launches == launches


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float64])
@pytest.mark.parametrize("weights", ["float32", "x's"])
def test_cuda_route_takes_other_dtypes_as_float32(dtype, weights):
    """The CUDA route (``_in_float32``) hands the kernel float32 copies of
    every floating input that is not float32 and returns x's dtype: the
    float32 chain's result cast back."""
    x, ws, bs = tensors(*init_scale(2, (9, 24, 5), 7))
    x = x.to(dtype)
    if weights == "x's":
        ws, bs = [w.to(dtype) for w in ws], [b.to(dtype) for b in bs]
    seen = []

    def kernel(xx, wws, bbs, activation):
        seen.extend(t.dtype for t in (xx, *wws, *bbs))
        return fm.plain_mlp(xx, wws, bbs, activation)

    got = fm._in_float32(kernel, x, ws, bs, "elu")
    assert seen == [torch.float32] * 5 and got.dtype == dtype
    want = fm.plain_mlp(x.float(), [w.float() for w in ws], [b.float() for b in bs], "elu").to(dtype)
    assert torch.equal(got, want)


def test_float32_inputs_go_to_the_kernel_as_they_are():
    x, ws, bs = tensors(*init_scale(3, (9, 24, 5), 7))
    handed = []
    fm._in_float32(lambda *args: handed.append(args) or args[0], x, ws, bs, "elu")
    assert handed[0][0] is x and all(a is b for a, b in zip(handed[0][1], ws))


def test_kernel_wrappers_still_refuse_other_dtypes():
    x, ws, bs = tensors(*init_scale(4, (9, 24, 5), 7))
    for call, args in ((fm.fused_mlp_cuda, (x.bfloat16(), ws, bs)),
                       (fm.fused_mlp_grouped_cuda, (x.half()[None], [w[None] for w in ws], bs))):
        with pytest.raises(TypeError, match="float32"):
            call(*args, "elu")


def test_cpu_chain_keeps_x_dtype():
    """On the CPU the chain is plain_mlp in x's dtype, eager and through the
    registered operator (with autograd)."""
    x, ws, bs = tensors(*init_scale(5, (9, 24, 5), 7))
    x, ws, bs = x.bfloat16(), [w.bfloat16().requires_grad_() for w in ws], [b.bfloat16() for b in bs]
    with torch.no_grad():
        eager = fm.fused_mlp(x, ws, bs, "elu")
    graded = fm.fused_mlp(x, ws, bs, "elu")
    graded.float().sum().backward()
    assert eager.dtype == graded.dtype == torch.bfloat16 and ws[0].grad.dtype == torch.bfloat16
    assert torch.equal(eager, fm.plain_mlp(x, ws, bs, "elu")) and torch.equal(graded.detach(), eager)


def jax_chain(x, ws, bs):
    """numpy [out, in] weights -> the JAX package's [in, out]."""
    return jnp.asarray(x), tuple(jnp.asarray(np.ascontiguousarray(np.swapaxes(w, -1, -2))) for w in ws), \
        tuple(jnp.asarray(b) for b in bs)


JAX_TOL = dict(rtol=1e-5, atol=1e-5)
CHAINS = [(NATURE, 8, "elu"), ((10,) + (32,) * 11 + (6,), 9, "tanh")]


@pytest.mark.parametrize("dims,batch,activation", CHAINS, ids=["nature_3136x512", "12_layers"])
def test_matches_jax_pallas_and_plain(dims, batch, activation):
    x, ws, bs = init_scale(6, dims, batch)
    jx, jws, jbs = jax_chain(x, ws, bs)
    jpallas = np.asarray(jfm.fused_mlp_pallas(jx, jws, jbs, activation, interpret=True))
    jplain = np.asarray(jfm.plain_mlp(jx, jws, jbs, activation))
    with torch.no_grad():
        got = fm.fused_mlp(*tensors(x, ws, bs), activation).numpy()
    np.testing.assert_allclose(got, jpallas, **JAX_TOL)
    np.testing.assert_allclose(got, jplain, **JAX_TOL)


@pytest.mark.parametrize("dims,batch,activation", CHAINS, ids=["nature_3136x512", "12_layers"])
def test_grads_match_jax(dims, batch, activation):
    """Gradients of the squared output's sum against jax.grad of the JAX
    ``fused_mlp`` (its custom VJP: the plain chain's): rtol 1e-5 plus an
    absolute 1e-5 of each tensor's largest entry. Each gradient carries the
    forward's float32 error (sums of 3136 products in another order) at the
    gradient's own scale, and entries that cancel keep only that absolute
    accuracy."""
    x, ws, bs = init_scale(7, dims, batch)

    def jloss(x, ws, bs):
        return jnp.sum(jfm.fused_mlp(x, ws, bs, activation) ** 2)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*jax_chain(x, ws, bs))
    tx, tws, tbs = tensors(x, ws, bs)
    leaves = [t.requires_grad_(True) for t in (tx, *tws, *tbs)]
    n = len(ws)
    (fm.fused_mlp(leaves[0], leaves[1:1 + n], leaves[1 + n:], activation) ** 2).sum().backward()
    want = [np.asarray(jg[0])] + [np.asarray(j).T for j in jg[1]] + [np.asarray(j) for j in jg[2]]
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("dims,batch,activation", CHAINS, ids=["nature_3136x512", "12_layers"])
def test_grouped_matches_jax_vmap(dims, batch, activation):
    """``fused_mlp_grouped`` (the CPU route: plain_mlp_grouped) over G = 3
    weight sets against ``jax.vmap`` of the JAX plain chain."""
    x, ws, bs = init_scale(8, dims, batch, groups=3)
    jx, jws, jbs = jax_chain(x, ws, bs)
    want = np.asarray(jax.vmap(lambda xx, w, b: jfm.plain_mlp(xx, w, b, activation))(jx, jws, jbs))
    with torch.no_grad():
        got = fm.fused_mlp_grouped(*tensors(x, ws, bs), activation).numpy()
    np.testing.assert_allclose(got, want, **JAX_TOL)


PONG_SHAPE, PONG_ACTIONS = (84, 84, 2), 3  # DevicePong's frames and Discrete(3)
FWD = dict(rtol=1e-5, atol=2e-6)


def pong_network(fused):
    with open("rl_games_tpu/configs/ppo_pong_device.yaml") as f:
        params = yaml.safe_load(f)["params"]
    params["network"]["mlp"]["fused"] = fused
    return {"model": params["model"], "network": params["network"]}


def test_fused_pong_model_matches_jax_and_the_plain_model():
    """ppo_pong_device.yaml with mlp.fused: true at its full widths (the
    nature-CNN's 32/64/64 filters, its 3136 -> 512 elu torso): the JAX
    model's params through jax_to_state_dict into the port's fused model,
    forward_train (logits, values) on two frames against the JAX model's;
    the same state_dict in the plain config's model gives the same outputs
    bit for bit."""
    params = pong_network(True)
    kw = dict(actions_num=PONG_ACTIONS, input_shape=PONG_SHAPE, normalize_input=True, normalize_value=True)
    jmodel = JModelBuilder().load(params, **kw)
    jparams, norm = jmodel.init(jax.random.PRNGKey(3), jnp.zeros((1, *PONG_SHAPE), jnp.float32))
    jparams, norm = jax.tree.map(np.asarray, jparams), jax.tree.map(np.asarray, norm)
    fused = ModelBuilder().load(params, device="cpu", **kw)
    assert isinstance(fused.a2c_network.actor_mlp, L.FusedMLP)
    state = jax_to_state_dict(jparams, norm, network=params["network"], input_shape=PONG_SHAPE)
    fused.load_state_dict(state)
    rng = np.random.default_rng(9)
    obs = (rng.random((2, *PONG_SHAPE)) * (rng.random((2, *PONG_SHAPE)) < 0.2)).astype(np.float32)
    actions = np.array([0, 2])
    jt = jmodel.forward_train(jparams, norm, obs, actions)
    with torch.no_grad():
        pt = fused.forward_train(torch.from_numpy(obs), torch.from_numpy(actions))
    for k in ("logits", "values"):
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(jt[k]), err_msg=k, **FWD)
    plain = ModelBuilder().load(pong_network(False), device="cpu", **kw)
    assert not isinstance(plain.a2c_network.actor_mlp, L.FusedMLP)
    plain.load_state_dict(fused.state_dict())
    with torch.no_grad():
        pp = plain.forward_train(torch.from_numpy(obs), torch.from_numpy(actions))
    for k in ("logits", "values"):
        assert torch.equal(pp[k], pt[k]), k
