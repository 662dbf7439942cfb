"""The wgmma launch of the fused MLP (csrc/fused_mlp.cu
``fused_mlp_wgmma_kernel``, ops/fused_mlp.py ``wgmma_plan``) on the CPU,
where the kernel itself cannot run (``chip_smoke.py`` holds it against
``plain_mlp`` and the held kernel on the card):

- which launches the plan sends to the wgmma kernel: held, ungrouped
  launches of widths of at most 256 over at least ``WGMMA_MIN_ROWS`` rows
  (the flagship torso's rollout and minibatches, the 3D configs', both
  launches of the 10-layer deep torso); the cluster kernel keeps its small
  batches, and grouped, streamed and wider launches keep their kernels;
- the shared bytes of ``wgmma_shared_bytes`` recounted by hand and against
  the source's layout, the halves and slots a layer takes, and the copy
  mode of each tensor (a tensor map, or ``cp.async`` of 16, 8 or 4 bytes)
  from its address and width;
- a float32 rehearsal of the kernel's arithmetic (hi the truncation, lo the
  rest, the tensor core's truncating adder once per 8 inputs, a_lo.w_hi and
  a_hi.w_lo into a sum that starts from the bias, a_hi.w_hi into another,
  elu's expm1 as exp - 1) held to the float64 chain within rtol = atol =
  2e-5 at the flagship, Humanoid3D and 10 x 256 widths;
- ``plain_mlp`` on the weights that ``utils/jax_params`` carries over from
  the JAX package's fused flagship model, against the JAX package's Pallas
  kernel in interpret mode;
- the wrapper: the C entry and its arguments, the counter beside
  ``fused_mlp_launches``, and no fallback (an error raises), with the CUDA
  calls replaced on the CPU.
"""

import contextlib
import ctypes
import re
from pathlib import Path
from types import SimpleNamespace

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

FLAGSHIP = (26, 256, 128, 64)
ANT3D, HUMANOID3D = (33, 256, 128, 64), (41, 256, 128, 64)
DEEP10 = (256,) * 11  # [deep_torso]: 10 layers of 256, two launches
WALKER, HOST, FORAGE = (16, 256, 128, 64), (5, 128, 64, 32), (6, 128, 64)
CARTPOLE = (4, 32, 32)
SOURCE = Path(fm.__file__).resolve().parent.parent / "csrc" / "fused_mlp.cu"


def source_constant(name):
    return int(re.search(r"constexpr int " + name + r" = ([0-9]+);", SOURCE.read_text()).group(1))


# --- the route ---------------------------------------------------------------


@pytest.mark.parametrize("dims,batch", [
    (FLAGSHIP, 8192), (FLAGSHIP, 32768),        # the fused flagship's rollout and minibatches, [rnn] (e)
    (HUMANOID3D, 32768), (ANT3D, 32768),        # ppo_humanoid3d.yaml's and ppo_ant3d.yaml's minibatches
    (WALKER, 8192),
])
def test_main_path_batches_take_the_wgmma_kernel(dims, batch):
    """One held launch (``kernel_plan``'s plan as before) run as the wgmma
    kernel: the measured cluster, as many slots as fit."""
    (launch,) = fm.launch_plan(dims, batch)
    assert (launch.first, launch.last, launch.streamed) == (0, len(dims) - 1, False)
    assert launch.plan == fm.kernel_plan(dims, batch)
    assert launch.cluster is None and launch.sets is None
    assert launch.wgmma == fm.wgmma_plan(dims, batch)
    assert launch.wgmma.cluster == fm.WGMMA_CLUSTER and launch.wgmma.shared <= fm.MAX_SHARED_BYTES


def test_deep_torso_takes_it_in_both_launches():
    launches = fm.launch_plan(DEEP10, 8192)
    assert [(p.first, p.last, p.streamed) for p in launches] == [(0, 8, False), (8, 10, False)]
    assert all(p.wgmma == fm.wgmma_plan(DEEP10[p.first:p.last + 1], 8192) is not None for p in launches)


@pytest.mark.parametrize("dims,batch", [
    (FLAGSHIP, 1), (FLAGSHIP, 7), (FLAGSHIP, 16), (FLAGSHIP, 1024), (WALKER, 16), (HOST, 64), (FORAGE, 1024),
])
def test_small_batches_keep_the_cluster_kernel(dims, batch):
    (launch,) = fm.launch_plan(dims, batch)
    assert launch.cluster == fm.cluster_plan(dims, batch) is not None and launch.wgmma is None


@pytest.mark.parametrize("dims,batch", [
    (HUMANOID3D, 4096), (ANT3D, 4096), (FLAGSHIP, 4096),  # below WGMMA_MIN_ROWS: the held kernel was faster
    (CARTPOLE, 16), (CARTPOLE, 64), ((3, 32, 32), 16),  # two weight tiles at their rollouts' batches
    ((130, 257), 8192), ((300, 64), 8192),              # a width past 256
    (HOST, 2048), (FORAGE, 8192),                       # few multiply-adds a row: the minibatches' batches
])
def test_the_held_kernel_keeps_the_rest(dims, batch):
    (launch,) = fm.launch_plan(dims, batch)
    assert launch.cluster is None and launch.wgmma is None and not launch.streamed


def test_crossover():
    """The wgmma kernel starts where the sweep measured it faster than the
    held kernel: from WGMMA_MIN_ROWS rows on, past every cluster shape, for
    chains of at least WGMMA_MIN_ROW_MACS multiply-adds a row."""
    most = fm.WGMMA_MIN_ROWS
    assert most > fm.CLUSTER_SHAPES[-1][0]
    assert fm.wgmma_plan(FLAGSHIP, most) is not None and fm.wgmma_plan(FLAGSHIP, most - 1) is None
    (below,) = fm.launch_plan(FLAGSHIP, most - 1)
    assert below.wgmma is None and below.cluster is None
    assert fm.row_macs(FLAGSHIP) == 26 * 256 + 256 * 128 + 128 * 64
    for dims in (FLAGSHIP, HUMANOID3D, ANT3D, WALKER, DEEP10[:9], DEEP10[8:]):
        assert fm.row_macs(dims) >= fm.WGMMA_MIN_ROW_MACS
    for dims in (HOST, FORAGE):  # the host path's and the self-play learner's: the held kernel is quicker there
        assert fm.row_macs(dims) < fm.WGMMA_MIN_ROW_MACS
        assert fm.wgmma_plan(dims, 32768) is None and fm.launch_plan(dims, 32768)[0].wgmma is None
    # the sweep's forced shapes take any batch
    assert fm.wgmma_plan(FLAGSHIP, 64, cluster=1, slots=2) == fm.WgmmaPlan(1, 2, fm.wgmma_shared_bytes(FLAGSHIP, 2))


def test_streamed_and_grouped_launches_never_take_it():
    (stream,) = fm.launch_plan((3136, 512), 4096)
    assert stream.streamed and stream.wgmma is None
    stream, head = fm.launch_plan((3136, 512, 64), 4096)
    assert stream.wgmma is None and head.wgmma is None  # 512 inputs: past the kernel's widths
    assert all(p.wgmma is None for p in fm.launch_plan(FLAGSHIP, 8192, cluster=False))
    assert all(p.wgmma is None for p in fm.grouped_launch_plan(FLAGSHIP, 8192, 4))
    assert all(p.wgmma is None for p in fm.grouped_launch_plan(FORAGE, 1, 1024))


# --- the layout --------------------------------------------------------------


def test_flagship_layout_counted_by_hand():
    """26 -> 256 -> 128 -> 64: the buffer holds 64 rows of 256 floats (the
    first layer's outputs), a slot 128 rows of 32 floats and their lo
    tile, the staging buffer the first weight whole (256 x 26 floats: its
    rows are not 16-byte multiples); four slots fit beside them, five do
    not."""
    buffer, slot, stage, barriers = 64 * 256 * 4, 2 * 128 * 32 * 4, 256 * 26 * 4, 3 * 8
    assert fm.wgmma_width(FLAGSHIP) == 256
    for slots in range(2, 7):
        assert fm.wgmma_shared_bytes(FLAGSHIP, slots) == 1024 + buffer + slots * (slot + barriers) + stage + 16
    assert fm.wgmma_shared_bytes(FLAGSHIP, 4) <= fm.MAX_SHARED_BYTES < fm.wgmma_shared_bytes(FLAGSHIP, 5)
    assert fm.wgmma_plan(FLAGSHIP, 8192).slots == min(4, fm.WGMMA_SLOTS)


@pytest.mark.parametrize("dims,slots", [
    (HOST, 5),          # a buffer of 128 floats a row and a staged 128 x 5 weight
    (DEEP10[:9], 5),    # nothing staged: every weight's rows are 1 KB
    (HUMANOID3D, 3),    # 256 x 41 floats staged: 42 KB
    (ANT3D, 4),         # 256 x 33 floats: 33.8 KB
    ((37, 50, 33, 7), 6),  # 50 x 37 floats are 7400 bytes, no multiple of 16: cp.async, nothing staged
])
def test_slots_that_fit(dims, slots):
    """As many slots as fit beside the buffer and the staging buffer, at
    most the kernel's six."""
    assert fm.wgmma_plan(dims, 8192, cluster=fm.WGMMA_CLUSTER).slots == min(slots, fm.WGMMA_SLOTS)
    assert fm.wgmma_shared_bytes(dims, slots) <= fm.MAX_SHARED_BYTES
    assert slots == 6 or fm.wgmma_shared_bytes(dims, slots + 1) > fm.MAX_SHARED_BYTES


def test_layout_mirrors_the_source():
    text = SOURCE.read_text()
    assert source_constant("kWgRows") == fm.WGMMA_ROWS
    assert source_constant("kWgSlotRows") == fm.WGMMA_SLOT_ROWS
    assert source_constant("kWgMaxWidth") == fm.WGMMA_MAX_WIDTH
    assert (2, source_constant("kWgMaxSlots")) == fm.WGMMA_SLOTS_RANGE
    assert source_constant("kMaxSharedBytes") == fm.MAX_SHARED_BYTES
    assert "constexpr int kWgSlotFloats = 2 * kWgSlotRows * 32;" in text
    assert ("return kSwizzleAlign + 4 * (kWgRows * width + net.slots * kWgSlotFloats) + stage + 3 * 8 * net.slots + "
            "2 * 8;" in text)
    assert source_constant("kWgMaxStageBytes") == fm.WGMMA_MAX_STAGE_BYTES
    assert ("return (k & 3) != 0 && (bytes & 15) == 0 && bytes <= kWgMaxStageBytes ? static_cast<int>(bytes) : 0;"
            in text)
    assert "slots < 2 || slots > kWgMaxSlots" in text
    assert "return half <= 16 ? 16 : half <= 32 ? 32 : half <= 64 ? 64 : 128;" in text
    assert "return 2 * half > kWgSlotRows ? 2 : 1;" in text


@pytest.mark.parametrize("n", [1, 7, 8, 16, 17, 26, 32, 33, 64, 65, 100, 128, 129, 200, 256])
def test_halves_and_slots_of_a_layer(n):
    """A warpgroup takes half the outputs rounded up to 8, then to an
    instruction width; a step of 32 inputs takes one slot where both
    halves' rows fit 128, else one a warpgroup; the outputs written, up to
    twice the half, cover the next layer's inputs rounded up to 32."""
    half = fm.wgmma_half(n)
    assert half in fm.WGMMA_HALVES and 2 * half >= n and (half == 16 or half < 2 * (-(-n // 16) * 8))
    parts = 2 if 2 * half > fm.WGMMA_SLOT_ROWS else 1  # csrc/fused_mlp.cu wg_parts
    assert parts == (2 if half == 128 else 1) and 2 * half <= parts * fm.WGMMA_SLOT_ROWS
    assert 2 * half >= -(-n // 32) * 32
    assert fm.wgmma_width((n, n, 5)) == max(-(-n // 32) * 32, 2 * half)


def test_refusals_of_the_plan():
    assert not fm.wgmma_takes((257, 64)) and not fm.wgmma_takes((64,) * (fm.MAX_LAYERS + 2))
    assert fm.wgmma_plan(FLAGSHIP, 8192, slots=6) is None   # past a block's shared memory
    assert fm.wgmma_plan(FLAGSHIP, 8192, slots=1) is None   # a 256-wide step takes two slots at once
    assert fm.wgmma_plan(FLAGSHIP, 8192, cluster=3) is None and fm.wgmma_plan(FLAGSHIP, 8192, cluster=4) is None
    assert "if ((cluster != 1 && cluster != 2) || slots < 2 || slots > kWgMaxSlots) return -1;" in SOURCE.read_text()


# --- the copy modes ----------------------------------------------------------


@pytest.mark.parametrize("address,n,k,mode", [
    (0, 256, 256, "tensor map"), (16, 64, 128, "tensor map"), (1024, 7, 64, "tensor map"),
    (0, 256, 26, "staged"), (0, 256, 41, "staged"), (0, 256, 33, "staged"), (0, 128, 5, "staged"),
    (8, 256, 26, 8), (4, 256, 26, 4), (8, 256, 41, 4), (8, 256, 256, 8), (12, 64, 64, 4),
    (0, 50, 37, 4),     # 7400 bytes: no multiple of 16
    (0, 250, 25, 4),    # 25,000 bytes
    (0, 1024, 26, 8),   # 106,496 bytes: more than a staged weight
])
def test_copy_mode_by_address_and_width(address, n, k, mode):
    """Bulk tensor copies want a 16-byte aligned address and rows of a
    multiple of 16 bytes; a weight whose rows are not, but whose whole bytes
    are and fit the staging buffer, goes by one bulk copy; else the kernel's
    own cp.async, as wide as the address and the rows allow."""
    assert fm.wgmma_copy(address, n, k) == mode


def test_copy_modes_of_the_main_path():
    """The flagship's and the 3D configs' first weights (26, 33 and 41
    floats a row) are staged, every later W goes by tensor maps; x's rows
    go by cp.async, 8 bytes at a time at 26 floats, 4 at 33 and 41."""
    for dims, first in ((FLAGSHIP, 8), (HUMANOID3D, 4), (ANT3D, 4)):
        x = torch.zeros((64, dims[0]))
        ws = [torch.zeros((dims[i + 1], dims[i])) for i in range(len(dims) - 1)]
        assert fm.wgmma_copy_modes(x, ws) == [first, "staged", "tensor map", "tensor map"]
        assert fm.wgmma_copy_modes(x[1:], ws)[0] == (8 if dims[0] == 26 else 4)
    x = torch.zeros((64, 256))
    assert fm.wgmma_copy_modes(x, [torch.zeros((256, 256))]) == [16, "tensor map"]
    w = torch.zeros(256 * 26 + 1)[1:].view(256, 26)  # a weight 4 bytes past an aligned address
    assert fm.wgmma_copy_modes(torch.zeros((64, 26)), [w]) == [8, 4]


def test_copy_rule_matches_the_source():
    text = SOURCE.read_text()
    assert "if ((K & 3) == 0 && (address & 15) == 0)" in text
    assert "else if ((K & 1) == 0 && (address & 7) == 0)" in text
    assert "return (reinterpret_cast<uintptr_t>(base) & 15) == 0 && (K & 3) == 0 && (set_stride & 3) == 0;" in text
    assert ("if (wg_stage_bytes(dims[l + 1], dims[l]) > 0 && (reinterpret_cast<uintptr_t>(net.w[l]) & 15) == 0)"
            in text)


# --- the arithmetic ----------------------------------------------------------


def init_scale_net(seed, dims, batch, x_scale=1.0, w_scale=1.0):
    """x ~ x_scale N(0, 1) and [out, in] weights ~ w_scale U(+-1/sqrt(in)),
    the model's default init (chip_smoke.py's ``mlp_inputs``)."""
    rng = np.random.default_rng(seed)
    ws = [((rng.random((dims[i + 1], dims[i])) * 2 - 1) * (w_scale / np.sqrt(dims[i]))).astype(np.float32)
          for i in range(len(dims) - 1)]
    bs = [(rng.normal(size=(dims[i + 1],)) * 0.1).astype(np.float32) for i in range(len(dims) - 1)]
    x = (rng.normal(size=(batch, dims[0])) * x_scale).astype(np.float32)
    return torch.from_numpy(x), [torch.from_numpy(w) for w in ws], [torch.from_numpy(b) for b in bs]


def leading_bits(v):
    """float32 cut to its leading 10 mantissa bits: what the tensor core
    reads of an operand."""
    return (v.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def truncate_to_float32(v):
    """float64 -> float32 rounded towards zero, as the tensor core's adder
    rounds its sum."""
    y = v.float()
    return torch.where(y.double().abs() > v.abs(), torch.nextafter(y, torch.zeros_like(y)), y)


def tensor_core_step(acc, a, w):
    """acc + a @ w.T for one 8-input instruction of TF32 operands: the
    products summed exactly, the sum added to the float32 accumulator and
    truncated towards zero, once per instruction."""
    return truncate_to_float32(acc.double() + leading_bits(a).double() @ leading_bits(w).double().T)


def wg_activate(activation):
    """The kernel's activation at a layer's end: elu's and selu's expm1 as
    exp - 1 (float32), the others plain_mlp's."""
    if activation == "elu":
        return lambda z: torch.where(z > 0, z, torch.exp(torch.clamp(z, max=0.0)) - 1.0)
    if activation == "selu":
        return lambda z: 1.0507009873554805 * torch.where(
            z > 0, z, 1.6732632423543772 * (torch.exp(torch.clamp(z, max=0.0)) - 1.0))
    return fm._PLAIN_ACTS[fm._activation_code(activation)]


def rehearse_wgmma(x, ws, bs, activation, products=3):
    """The wgmma kernel's arithmetic in plain PyTorch: inputs zero-filled to
    a multiple of 32; each operand's hi the value itself (the tensor core
    reads its leading bits), lo = v - (v with its last 13 bits cleared),
    exact in float32; per 8 inputs a_lo.w_hi, then a_hi.w_hi into the main
    sum, then a_hi.w_lo, each instruction truncated towards zero, the small
    sum starting from the bias; per layer act(main + small) in float32.
    ``products=1`` keeps a_hi.w_hi alone (plain TF32)."""
    f = wg_activate(activation)
    for w, b in zip(ws, bs):
        pad = (0, (-w.shape[1]) % 32)
        a_hi, w_hi = F.pad(x, pad), F.pad(w, pad)
        a_lo, w_lo = a_hi - leading_bits(a_hi), w_hi - leading_bits(w_hi)
        big = torch.zeros((x.shape[0], w.shape[0]))
        small = b.expand(x.shape[0], -1).clone() if products == 3 else torch.zeros_like(big)
        for k0 in range(0, a_hi.shape[1], 8):
            s = slice(k0, k0 + 8)
            if products == 3:
                small = tensor_core_step(small, a_lo[:, s], w_hi[:, s])
            big = tensor_core_step(big, a_hi[:, s], w_hi[:, s])
            if products == 3:
                small = tensor_core_step(small, a_hi[:, s], w_lo[:, s])
        x = f(big + small) if products == 3 else f(big + b)
    return x


def exact_chain(x, ws, bs, activation):
    return fm.plain_mlp(x.double(), [w.double() for w in ws], [b.double() for b in bs], activation).numpy()


# chains at the model's scale and with inputs 30 times as large; weights 8
# times as large layer by layer (test_weights_8_times_hold_layer_by_layer)
SCHEME_CHAINS = [(FLAGSHIP, 96, 1.0), (HUMANOID3D, 96, 1.0), (DEEP10, 32, 1.0),
                 (FLAGSHIP, 96, 30.0), (HUMANOID3D, 96, 30.0), (DEEP10, 32, 30.0)]
SCHEME_LAYERS = [(26, 256), (256, 128), (128, 64), (41, 256), (256, 256)]


@pytest.mark.parametrize("activation", ["elu", "tanh"])
@pytest.mark.parametrize("dims,batch,x_scale", SCHEME_CHAINS)
def test_scheme_holds_the_tolerance(activation, dims, batch, x_scale):
    """The rehearsal within rtol = atol = 2e-5 of the chain in float64; one
    TF32 product a layer is not, so the comparison can fail."""
    x, ws, bs = init_scale_net(3, dims, batch, x_scale)
    want = exact_chain(x, ws, bs, activation)
    with torch.no_grad():
        np.testing.assert_allclose(rehearse_wgmma(x, ws, bs, activation).numpy(), want, rtol=2e-5, atol=2e-5)
        assert not np.allclose(rehearse_wgmma(x, ws, bs, activation, products=1).numpy(), want,
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("activation", ["elu", "tanh"])
@pytest.mark.parametrize("dims", SCHEME_LAYERS)
def test_weights_8_times_hold_layer_by_layer(activation, dims):
    x, ws, bs = init_scale_net(4, dims, 256, w_scale=8.0)
    with torch.no_grad():
        np.testing.assert_allclose(rehearse_wgmma(x, ws, bs, activation).numpy(), exact_chain(x, ws, bs, activation),
                                   rtol=2e-5, atol=2e-5)


def test_weights_8_times_over_a_chain_miss_in_float32_itself():
    """Why weights 8 times as large are held layer by layer: over the
    flagship's three layers the float32 chain (plain_mlp) itself misses the
    float64 one by more than the tolerance."""
    x, ws, bs = init_scale_net(3, FLAGSHIP, 256, w_scale=8.0)
    assert not np.allclose(fm.plain_mlp(x, ws, bs, "elu").numpy(), exact_chain(x, ws, bs, "elu"),
                           rtol=2e-5, atol=2e-5)


def test_every_activation_rehearsed():
    x, ws, bs = init_scale_net(5, (37, 50, 33, 7), 19)
    for activation in ("relu", "elu", "selu", "softplus", "gelu", "sigmoid", "swish", "tanh", "None"):
        with torch.no_grad():
            np.testing.assert_allclose(rehearse_wgmma(x, ws, bs, activation).numpy(),
                                       exact_chain(x, ws, bs, activation), rtol=2e-5, atol=2e-5)


def test_reference_through_jax_params_matches_pallas():
    """The JAX package's fused flagship model, its weights carried into the
    port's FusedMLP by jax_to_state_dict: plain_mlp on them (the plain
    version the kernel is held to on the card) and the rehearsal against
    the JAX package's Pallas kernel in interpret mode, rtol = atol = 2e-5."""
    network = {
        "name": "actor_critic", "separate": False,
        "mlp": {"units": list(FLAGSHIP[1:]), "activation": "elu", "initializer": {"name": "default"},
                "fused": True},
        "space": {"continuous": {"mu_activation": "None", "sigma_activation": "None",
                                 "mu_init": {"name": "default"},
                                 "sigma_init": {"name": "const_initializer", "val": 0.0},
                                 "fixed_sigma": True}},
    }
    params = {"model": {"name": "continuous_a2c_logstd"}, "network": network}
    kw = dict(actions_num=8, input_shape=(FLAGSHIP[0],), normalize_input=False, normalize_value=False)
    jmodel = JModelBuilder().load(params, **kw)
    jparams, norm = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((4, FLAGSHIP[0]), jnp.float32))
    pmodel = ModelBuilder().load(params, device="cpu", **kw)
    pmodel.load_state_dict(jax_to_state_dict(jax.tree.map(np.asarray, jparams), jax.tree.map(np.asarray, norm)))
    mlp = pmodel.a2c_network.actor_mlp
    assert isinstance(mlp, L.FusedMLP)
    linears = [m for m in mlp.modules() if isinstance(m, torch.nn.Linear)]
    ws = [m.weight.detach() for m in linears]
    bs = [m.bias.detach() for m in linears]
    assert [tuple(w.shape) for w in ws] == [(FLAGSHIP[i + 1], FLAGSHIP[i]) for i in range(3)]
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(300, FLAGSHIP[0])).astype(np.float32))
    pallas = np.asarray(jfm.fused_mlp_pallas(
        jnp.asarray(x.numpy()), tuple(jnp.asarray(w.numpy().T) for w in ws), tuple(jnp.asarray(b.numpy()) for b in bs),
        "elu", interpret=True, block_b=256))
    with torch.no_grad():
        np.testing.assert_allclose(fm.plain_mlp(x, ws, bs, "elu").numpy(), pallas, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(rehearse_wgmma(x, ws, bs, "elu").numpy(), pallas, rtol=2e-5, atol=2e-5)


# --- the wrapper -------------------------------------------------------------


def c_parameters(name):
    match = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", SOURCE.read_text())
    return [p.strip() for p in match.group(1).split(",")]


def test_wgmma_entry_arguments_match_the_source():
    params = c_parameters("fused_mlp_wgmma_forward")
    assert len(params) == len(fm.WGMMA_ARGTYPES)
    for param, argtype in zip(params, fm.WGMMA_ARGTYPES):
        assert ("*" in param) == (argtype is ctypes.c_void_p or argtype.__name__.startswith("LP_")), param
    assert [p.split()[-1].lstrip("*") for p in params] == [
        "x", "out", "B", "n_layers", "dims", "ws", "bs", "act", "cluster", "slots", "stream", "attr_err"]
    assert [p.split()[-1] for p in c_parameters("fused_mlp_wgmma_grid")] == ["B", "cluster", "smem_bytes"]
    assert [p.split()[-1] for p in c_parameters("fused_mlp_wgmma_empty")] == ["B", "cluster", "smem_bytes",
                                                                               "stream"]


@pytest.fixture
def cpu_cuda_calls(monkeypatch):
    """_launch on CPU tensors: the device guard and the current stream
    replaced, the C entries recorded; an entry may also set attr_err."""
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: SimpleNamespace(cuda_stream=7))
    for counter in ("fused_mlp_launches", "fused_mlp_cluster_launches", "fused_mlp_wgmma_launches"):
        monkeypatch.setattr(fm, counter, 0)
    calls = {"wgmma": [], "held": []}

    def entry(kind, code, attr_err):
        def fn(*args):
            calls[kind].append(args)
            args[-1]._obj.value = attr_err
            return code
        return fn

    def use(wgmma_code=0, attr_err=0):
        monkeypatch.setattr(fm, "_wgmma_kernel", lambda: entry("wgmma", wgmma_code, attr_err))
        monkeypatch.setattr(fm, "_kernel", lambda: entry("held", 0, 0))
        return calls

    return use


def launch_flagship(batch, launch=None, groups=1):
    x, ws, bs = init_scale_net(6, FLAGSHIP, batch)
    out = torch.empty((batch, FLAGSHIP[-1]))
    (planned,) = fm.launch_plan(FLAGSHIP, batch)
    fm._launch(x, out, batch, list(FLAGSHIP), ws, bs, fm.ACTIVATION_CODES["elu"], launch or planned, groups,
               (0, 0, [0] * 3, [0] * 3))
    return x, out


def test_wgmma_launch_calls_its_entry_and_counts(cpu_cuda_calls):
    calls = cpu_cuda_calls()
    x, out = launch_flagship(8192)
    ((args,),) = [calls["wgmma"]]
    assert not calls["held"]
    plan = fm.wgmma_plan(FLAGSHIP, 8192)
    assert args[:4] == (x.data_ptr(), out.data_ptr(), 8192, 3)
    assert args[7:11] == (fm.ACTIVATION_CODES["elu"], plan.cluster, plan.slots, 7)
    assert fm.fused_mlp_launches == fm.fused_mlp_wgmma_launches == 1 and fm.fused_mlp_cluster_launches == 0
    # a held Launch (as chip_smoke.py hands _run_chain to compare) takes the held entry and no wgmma count
    launch_flagship(8192, fm.Launch(0, 3, False, fm.kernel_plan(FLAGSHIP, 8192)))
    assert len(calls["held"]) == 1 and fm.fused_mlp_launches == 2 and fm.fused_mlp_wgmma_launches == 1


@pytest.mark.parametrize("code,attr_err,match", [
    (-1, 0, "launch failed"), (1, 0, "launch failed"), (719, 0, "launch failed"),
    (-2, 0, "tensor maps"), (0, -1, "holds no block"), (0, -3, "168 registers"), (0, 1, "cudaFuncSetAttribute"),
])
def test_wgmma_launch_errors_raise(cpu_cuda_calls, code, attr_err, match):
    """No fallback: an error of the entry or its preparation raises, counts
    nothing and never reaches the held kernel or the plain chain."""
    calls = cpu_cuda_calls(wgmma_code=code, attr_err=attr_err)
    with pytest.raises(RuntimeError, match=match):
        launch_flagship(8192)
    assert not calls["held"] and fm.fused_mlp_launches == fm.fused_mlp_wgmma_launches == 0


def test_wgmma_launch_refuses_weight_sets(cpu_cuda_calls):
    cpu_cuda_calls()
    with pytest.raises(ValueError, match="one weight set"):
        launch_flagship(8192, groups=2)


def test_ordinary_call_walks_a_wgmma_launch(monkeypatch):
    """fused_mlp_cuda at the flagship's rollout batch hands _launch the
    planned wgmma launch (the launch itself recorded and run as the plain
    chain on the CPU)."""
    seen = []

    def launch(x, out, batch, dims, ws, bs, act, launch, groups, set_strides):
        seen.append((tuple(dims), launch, groups))
        out.copy_(fm.plain_mlp(x, ws, bs, "elu"))

    monkeypatch.setattr(fm, "_launch", launch)
    monkeypatch.setattr(fm, "_check_tensors", lambda x, ws, bs: None)
    x, ws, bs = init_scale_net(7, FLAGSHIP, 8192)
    got = fm.fused_mlp_cuda(x, ws, bs, "elu")
    ((dims, launch, groups),) = seen
    assert dims == FLAGSHIP and groups == 1 and launch.wgmma == fm.wgmma_plan(FLAGSHIP, 8192)
    torch.testing.assert_close(got, fm.plain_mlp(x, ws, bs, "elu"), rtol=0, atol=0)
