"""The sets launch of the fused MLP (csrc/fused_mlp.cu
``fused_mlp_sets_kernel``, ops/fused_mlp.py ``sets_plan``) on the CPU, where
the kernel itself cannot run (``chip_smoke.py`` holds it against
``plain_mlp_grouped`` on the card):

- which grouped launches the plan sends to the sets kernel: held ones over
  at least SETS_MIN_GROUPS sets of at most SETS_MAX_ROWS rows whose set
  fits two stages; never G = 1, a set of more rows, a set too large or a
  streamed launch; tensors at set stride 0 kept once, outside the ring;
- the copy mode of each set of each tensor, from its address and size:
  one bulk copy, or the kernel's cp.async of 16, 8 or 4 bytes (the forage
  opponents' 24-byte rows of x, the 6 -> 7 layer's sets of 42 floats, the
  skewed 4x4x8 strides that chip_smoke.py checks on the card);
- the kernel's summation order rehearsed in float32 (each lane's inputs in
  order by fused multiply-adds, then the shuffle tree), held to the chain
  in float64 at rtol = atol = 2e-5;
- a rehearsal of the kernel's dataflow in numpy (persistent blocks, the
  ring of stages and the shared region at ``sets_layout``'s offsets, the
  activation buffers), and ``plain_mlp_grouped``, the kernel's plain
  version, against the JAX package's Pallas kernel under ``jax.vmap`` in
  interpret mode;
- the wrapper: the sets launch's C entry and arguments, its counter beside
  ``fused_mlp_launches`` and ``fused_mlp_grouped_launches``, and no fallback
  (an error raises), with the CUDA calls replaced on the CPU.
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

from rl_games_tpu.ops import fused_mlp as jfm
from rl_games_tpu_torch.ops import fused_mlp as fm

torch.set_num_threads(1)

FORAGE = (6, 128, 64)  # benchruns/selfplay_forage.yaml's MLP [128, 64] elu on competitive_forage's 6 observations
SOURCE = Path(fm.__file__).resolve().parent.parent / "csrc" / "fused_mlp.cu"
MANY = max(fm.SETS_MIN_GROUPS.values())  # sets enough for the route at every rows a set it takes
ROWS = min(3, fm.SETS_MAX_ROWS)  # chip_smoke.py's shared-tensor cases' rows a set, where the route takes them
# the JAX package's kernel test shapes (tests/test_fused_mlp.py)
JAX_SHAPES = [((37, 50, 33, 7), 19), ((26, 256, 128, 64), 512), ((4, 8), 1), ((130, 257), 1030)]


def one_launch(dims, batch, groups, shared=None):
    (launch,) = fm.grouped_launch_plan(dims, batch, groups, shared)
    return launch


@pytest.mark.parametrize("groups", [1024, 512])
def test_forage_opponents_take_the_sets_kernel(groups):
    """The self-play opponents' chain at one row a set: one launch of the
    sets kernel, its 1-row instance, SETS_STAGES stages, the held plan
    beside it as before."""
    launch = one_launch(FORAGE, 1, groups)
    assert (launch.first, launch.last, launch.streamed, launch.cluster) == (0, 2, False, None)
    warps = fm.sets_warps(fm.SETS_STAGES)
    assert launch.sets == fm.SetsPlan(1, fm.SETS_STAGES, warps, fm.sets_shared_bytes(FORAGE, 1, fm.SETS_STAGES,
                                                                                      warps=warps))
    assert launch.plan == fm.kernel_plan(FORAGE, 0)


@pytest.mark.parametrize("batch", range(1, fm.SETS_MAX_ROWS + 1))
def test_rows_a_set_pick_the_smallest_instance(batch):
    plan = fm.sets_plan(FORAGE, batch, MANY)
    assert plan.rows == min(r for r in fm.SETS_ROWS if r >= batch)
    assert plan.shared == fm.sets_shared_bytes(FORAGE, batch, plan.stages, warps=plan.warps)


@pytest.mark.parametrize("dims,batch,groups", [
    (FORAGE, 1, 1),                                     # G = 1: the ordinary launch
    ((37, 50, 33, 7), 19, 3),                           # 19 rows a set
    (FORAGE, fm.SETS_MAX_ROWS + 1, MANY),               # one row past the route
    (FORAGE, 1, fm.SETS_MIN_GROUPS[1] - 1),             # one set short of it
    ((26, 256, 128, 64), 1, MANY),                      # a set of 190 KB: not two stages
    ((130, 257), 1, MANY),                              # 134 KB a set
])
def test_the_held_kernel_keeps_the_rest(dims, batch, groups):
    launch = one_launch(dims, batch, groups)
    assert launch.sets is None and launch.cluster is None and not launch.streamed


@pytest.mark.parametrize("batch", range(1, fm.SETS_MAX_ROWS + 1))
def test_min_groups_by_rows(batch):
    """Each instance's rows take the sets kernel from its SETS_MIN_GROUPS
    on (3 rows a set: the 4-row instance's count); one set fewer stays held."""
    rows = min(r for r in fm.SETS_ROWS if r >= batch)
    fewest = fm.SETS_MIN_GROUPS[rows]
    assert fewest >= 2 and fm.sets_plan(FORAGE, batch, fewest).rows == rows
    assert fm.sets_plan(FORAGE, batch, fewest - 1) is None


def test_min_groups_and_stage_limit():
    assert sorted(fm.SETS_MIN_GROUPS) == [r for r in fm.SETS_ROWS if r <= fm.SETS_MAX_ROWS]
    assert list(fm.SETS_MIN_GROUPS.values()) == sorted(fm.SETS_MIN_GROUPS.values())
    assert 2 <= fm.SETS_STAGES <= fm.MAX_SETS_STAGES
    # a set of 99.7 KB fits two stages and no third: the plan takes as many as fit
    dims = (32, 256, 64)
    plan = fm.sets_plan(dims, 1, MANY)
    assert plan is not None and plan.stages == 2
    assert plan.shared + fm._SETS_TABLE_BYTES <= fm.MAX_SHARED_BYTES
    assert fm.sets_shared_bytes(dims, 1, 3, warps=fm.sets_warps(3)) + fm._SETS_TABLE_BYTES > fm.MAX_SHARED_BYTES


def test_every_use_of_a_stage_falls_to_one_group():
    """The groups of multiplying warps divide the stages (``sets_warps``
    adds warps a set until they do), at every stage count and warps a set:
    the block's i-th set is in stage i % stages and group i % groups, so a
    stage's sets are one group's, and that group's parity wait on the
    stage's full barrier never meets it two phases behind. csrc/fused_mlp.cu
    refuses any other launch."""
    for stages in range(1, fm.MAX_SETS_STAGES + 1):
        for warps in (1, 2, 4, 8):
            got = fm.sets_warps(stages, warps)
            groups = fm.SETS_MULTIPLYING_WARPS // got
            assert got >= warps and stages % groups == 0 and groups <= stages
            for s in range(stages):
                assert len({i % groups for i in range(8 * stages) if i % stages == s}) == 1
    assert "stages % (kSetsWarps / warps) != 0) return -1;" in SOURCE.read_text()


def test_streamed_launches_stay_streamed():
    """3136 -> 512 -> 64 over many sets of one row: the streamed first layer
    keeps its kernel; the held 512 -> 64 behind it (32 K floats a set) fits
    no two stages and stays held."""
    stream, head = fm.grouped_launch_plan((3136, 512, 64), 1, MANY)
    assert stream.streamed and stream.sets is None
    assert not head.streamed and head.sets is None
    # a small head behind a streamed layer: its input is each set's own scratch
    stream, head = fm.grouped_launch_plan((3136, 512, 8), 1, MANY, (True,) * 5)
    assert stream.sets is None and head.sets is not None
    assert head.sets.shared == fm.sets_shared_bytes((512, 8), 1, head.sets.stages, (False, True, True),
                                                    head.sets.warps)


def test_shared_tensors_stay_out_of_the_ring():
    """A tensor at set stride 0 is copied once, into the region kept for a
    block's life: the stage holds only the others."""
    alone = fm.sets_layout(FORAGE, 3, 4)
    shared_w0 = fm.sets_layout(FORAGE, 3, 4, (False, True, False, False, False))
    assert alone.stage_floats - shared_w0.stage_floats == 128 * 6
    assert shared_w0.floats - shared_w0.ring_off == 4 * shared_w0.stage_floats
    assert shared_w0.offsets[1] < shared_w0.act_off  # in the shared region
    shared_x = fm.sets_layout(FORAGE, 3, 4, (True, False, False, False, False))
    assert alone.stage_floats - shared_x.stage_floats == 20  # 3 rows of 6, rounded up to 4 floats


def test_forage_layout_counted_by_hand():
    """The forage opponents' stage: x's 6 floats (8 with the rounding), W_0
    768, b_0 128, W_1 8192, b_1 64; 9 barriers (18 floats, 20 rounded);
    two activation buffers of one row of 128."""
    layout = fm.sets_layout(FORAGE, 1, 4)
    assert layout.stage_floats == 8 + 768 + 128 + 8192 + 64
    assert layout.offsets == (0, 8, 776, 904, 9096)
    assert (layout.act_off, layout.act_floats, layout.ring_off) == (20, 128, 276)
    assert fm.sets_shared_bytes(FORAGE, 1, 4) == 4 * (276 + 4 * 9160) == 147_664
    # two warps a set: four groups, two activation buffers each
    assert fm.sets_layout(FORAGE, 1, 4, warps=2).ring_off == 20 + 4 * 2 * 128
    # 36,608 bytes of weights and biases a set: 37,486,592 at G = 1024, the bound's bytes less x and out
    assert 4 * (layout.stage_floats - 8) == 36_608


@pytest.mark.parametrize("dims,batch", [(FORAGE, 1), (FORAGE, 3), ((6, 7, 5), 3), ((4, 4, 8), 5), ((37, 50, 33, 7), 16)])
@pytest.mark.parametrize("stages,warps", [(2, 8), (4, 2), (16, 1)])
def test_layout_regions_are_aligned_and_apart(dims, batch, stages, warps):
    """Every region starts on 16 bytes and none overlaps another, for any
    mix of shared tensors; the barriers come first."""
    n = 2 * len(dims) - 1
    floats = fm.sets_tensor_floats(dims, batch)
    for mask in range(1 << n):
        shared = tuple(bool(mask >> k & 1) for k in range(n))
        layout = fm.sets_layout(dims, batch, stages, shared, warps)
        spans = [(0, 2 * (2 * stages + 1))]
        spans += [(layout.offsets[k], layout.offsets[k] + floats[k]) for k in range(n) if shared[k]]
        spans += [(layout.act_off + i * layout.act_floats, layout.act_off + (i + 1) * layout.act_floats)
                  for i in range(2 * fm.SETS_MULTIPLYING_WARPS // warps)]
        for s in range(stages):
            base = layout.ring_off + s * layout.stage_floats
            spans += [(base + layout.offsets[k], base + layout.offsets[k] + floats[k]) for k in range(n) if not shared[k]]
        assert all(start % 4 == 0 for start, _ in spans[1:])
        spans = sorted(span for span in spans if span[1] > span[0])
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
        assert spans[-1][1] <= layout.floats


def test_copy_modes_of_the_forage_opponents():
    """x's 24-byte rows: a set start on 16 bytes takes 16-byte copies and a
    tail, the others 8-byte copies; the weights and biases (multiples of 16
    bytes at aligned addresses) one bulk copy each."""
    base = 1 << 20
    assert fm.sets_copy_modes(base, 6, 6, 4) == [16, 8, 16, 8]
    for floats in (768, 128, 8192, 64):
        assert fm.sets_copy_modes(base, floats, floats, 5) == ["bulk"] * 5


def test_copy_modes_of_sets_of_42_floats():
    """The 6 -> 7 -> 5 chain of chip_smoke.py: W_0's sets of 42 floats (168
    bytes) start on 16 bytes in every second set, W_1's of 35 floats (140
    bytes) in every fourth, else on 8 or 4 bytes."""
    base = 1 << 20
    assert fm.sets_copy_modes(base, 42, 42, 4) == [16, 8, 16, 8]
    assert fm.sets_copy_modes(base, 35, 35, 4) == [16, 4, 8, 4]
    assert fm.sets_copy_modes(base, 7, 7, 2) == [16, 4]  # b_0
    assert fm.sets_copy_modes(base, 5, 5, 2) == [16, 4]  # b_1


def test_copy_modes_of_the_skewed_strides():
    """chip_smoke.py's 4x4x8 sets: x (5 rows of 4) at 21 floats a set, W_0
    (16 floats) at 17, W_1 (32 floats) one float past an aligned base."""
    base = 1 << 20
    assert fm.sets_copy_modes(base, 21, 20, 4) == ["bulk", 4, 8, 4]
    assert fm.sets_copy_modes(base, 17, 16, 4) == ["bulk", 4, 8, 4]
    assert fm.sets_copy_modes(base + 4, 32, 32, 3) == [4, 4, 4]


def test_a_shared_tensor_is_copied_once():
    assert fm.sets_copy_modes(1 << 20, 0, 768, 1024) == ["bulk"]
    assert fm.sets_copy_modes((1 << 20) + 8, 0, 6, 1024) == [8]


def test_copy_rules_match_the_source():
    """csrc/fused_mlp.cu's sets_bulk and sets_copy decide as sets_copy
    does: a bulk copy for a 16-byte aligned address and a multiple of 4
    floats, else 16, 8 or 4 bytes from the address; the instances and the
    stage limit are those the plan knows."""
    text = SOURCE.read_text()
    assert "return (reinterpret_cast<uintptr_t>(src) & 15) == 0 && (floats & 3) == 0;" in text
    assert re.search(r"if \(\(address & 15\) == 0\) \{\s+body = floats & ~3;", text)
    assert re.search(r"\} else if \(\(address & 7\) == 0\) \{\s+body = floats & ~1;", text)
    assert re.search(r"constexpr int kMaxSetsStages = (\d+);", text).group(1) == str(fm.MAX_SETS_STAGES)
    instances = re.findall(r"return fused_mlp_sets_kernel<(\d+)>;", text)
    assert tuple(map(int, instances)) == fm.SETS_ROWS


def fma32(acc, w, h):
    """fmaf in float32: the product exact in float64 (two 24-bit
    significands), the sum rounded to float64 and then to float32 (the
    double rounding aside, the kernel's single rounding)."""
    return (acc.astype(np.float64) + w.astype(np.float64) * h.astype(np.float64)).astype(np.float32)


PLAIN_ACTS = {"elu": lambda v: np.where(v > 0, v, np.expm1(np.minimum(v, 0))).astype(np.float32),
              "tanh": lambda v: np.tanh(v).astype(np.float32), "relu": lambda v: np.maximum(v, 0),
              "None": lambda v: v}


def sets_layer(h, w, b, activation):
    """One layer as the kernel sums it, in float32: the inputs in vectors of
    4, 2 or 1 floats (as K allows); output n's sum walks the vectors from
    n mod (K / vector) on, round to the one before, each vector's floats in
    order, one fused multiply-add each; then bias and activation. h
    [rows, K], w [N, K]."""
    k, n = w.shape[1], w.shape[0]
    vec = 4 if k % 4 == 0 else 2 if k % 2 == 0 else 1
    vectors = k // vec
    outputs = np.arange(n)
    acc = np.zeros((h.shape[0], n), np.float32)
    for j in range(vectors):
        v = (outputs + j) % vectors
        for e in range(vec):
            i = v * vec + e
            acc = fma32(acc, w[outputs, i][None, :], h[:, i])
    return PLAIN_ACTS[activation](acc + b)


def sets_chain(x, ws, bs, activation):
    for w, b in zip(ws, bs):
        x = sets_layer(x, w, b, activation)
    return x


def init_scale(seed, dims, batch, groups=None, x_scale=1.0, w_scale=1.0):
    rng = np.random.default_rng(seed)
    lead = () if groups is None else (groups,)
    ws = [(w_scale * (rng.random(lead + (dims[i + 1], dims[i])) * 2 - 1) / np.sqrt(dims[i])).astype(np.float32)
          for i in range(len(dims) - 1)]
    bs = [(rng.normal(size=lead + (dims[i + 1],)) * 0.1).astype(np.float32) for i in range(len(dims) - 1)]
    return (x_scale * rng.normal(size=lead + (batch, dims[0]))).astype(np.float32), ws, bs


def exact_chain(x, ws, bs, activation):
    return fm.plain_mlp(torch.from_numpy(x).double(), [torch.from_numpy(w).double() for w in ws],
                        [torch.from_numpy(b).double() for b in bs], activation).numpy()


@pytest.mark.parametrize("activation", ["elu", "tanh"])
@pytest.mark.parametrize("dims,batch,x_scale,w_scale", [(FORAGE, 1, 1.0, 1.0), (FORAGE, 16, 1.0, 1.0)]
                         + [(dims, batch, 1.0, 1.0) for dims, batch in JAX_SHAPES]
                         + [((26, 256, 128, 64), 64, 30.0, 1.0), ((130, 257), 64, 1.0, 8.0)])
def test_summation_order_holds_the_tolerance(activation, dims, batch, x_scale, w_scale):
    """The kernel's float32 sums in its order, against the chain in float64,
    at the kernel's rtol = atol = 2e-5: at the forage widths, the JAX
    package's kernel test shapes and inputs 30 times or weights 8 times as
    large."""
    x, ws, bs = init_scale(11, dims, batch, x_scale=x_scale, w_scale=w_scale)
    np.testing.assert_allclose(sets_chain(x, ws, bs, activation), exact_chain(x, ws, bs, activation),
                               rtol=2e-5, atol=2e-5)


def rehearse_sets(x, ws, bs, activation, grid, stages, shared, warps):
    """The sets kernel's dataflow in numpy: ``grid`` persistent blocks, each
    with its own shared memory (NaN where nothing was written) laid out by
    ``sets_layout``; the shared tensors copied once; block b's sets b,
    b + grid, ... through the ring, the i-th in stage i % stages and to
    group i % groups of ``warps`` multiplying warps, each set's tensors
    copied whole to their offsets; each layer read from the stage (or the
    shared region) and the group's activation buffers, summed as
    ``sets_layer``. x, ws, bs carry their set axis where ``shared`` says
    not."""
    tensors = [x] + [t for pair in zip(ws, bs) for t in pair]
    groups = next(t.shape[0] for t, s in zip(tensors, shared) if not s)
    batch, dims = x.shape[-2], [x.shape[-1]] + [w.shape[-2] for w in ws]
    layout = fm.sets_layout(dims, batch, stages, shared, warps)
    warp_groups = fm.SETS_MULTIPLYING_WARPS // warps
    assert stages % warp_groups == 0
    out = np.full((groups, batch, dims[-1]), np.nan, np.float32)
    for block in range(grid):
        smem = np.full(layout.floats, np.nan, np.float32)

        def put(base, k, t):
            flat = np.ascontiguousarray(t).reshape(-1)
            smem[base + layout.offsets[k]:base + layout.offsets[k] + flat.size] = flat

        for k, t in enumerate(tensors):
            if shared[k]:
                put(0, k, t)
        for i, s in enumerate(range(block, groups, grid)):
            stage = layout.ring_off + (i % stages) * layout.stage_floats
            for k, t in enumerate(tensors):
                if not shared[k]:
                    put(stage, k, t[s])

            def read(k, shape):
                start = (0 if shared[k] else stage) + layout.offsets[k]
                return smem[start:start + int(np.prod(shape))].reshape(shape)

            h = read(0, (batch, dims[0]))
            act_buf = layout.act_off + 2 * (i % warp_groups) * layout.act_floats
            for l in range(len(ws)):
                y = sets_layer(h, read(1 + 2 * l, (dims[l + 1], dims[l])), read(2 + 2 * l, (dims[l + 1],)), activation)
                if l == len(ws) - 1:
                    out[s] = y
                else:
                    buf = act_buf + (l % 2) * layout.act_floats
                    smem[buf:buf + y.size] = y.reshape(-1)
                    h = smem[buf:buf + y.size].reshape(y.shape)
    assert not np.isnan(out).any()
    return out


def pallas_vmapped(x, ws, bs, activation):
    """The JAX package's Pallas kernel in interpret mode under jax.vmap over
    the sets (weights carried across transposed), as the JAX self-play env
    runs its opponents' forward."""
    return np.asarray(jax.vmap(lambda xx, w, b: jfm.fused_mlp_pallas(xx, w, b, activation, interpret=True,
                                                                     block_b=8))(
        jnp.asarray(x), tuple(jnp.asarray(np.swapaxes(w, -1, -2)) for w in ws), tuple(jnp.asarray(b) for b in bs)))


@pytest.mark.parametrize("batch", [1, 3])
def test_plain_version_and_rehearsal_match_pallas_under_vmap(batch):
    """plain_mlp_grouped (the sets kernel's plain version) and the dataflow
    rehearsal (16 blocks, 4 stages) against the JAX package's Pallas kernel
    under jax.vmap at G = 64, in interpret mode, rtol = atol = 2e-5; the
    rehearsal at two warps a set."""
    x, ws, bs = init_scale(5, FORAGE, batch, groups=64)
    want = pallas_vmapped(x, ws, bs, "elu")
    plain = fm.plain_mlp_grouped(torch.from_numpy(x), [torch.from_numpy(w) for w in ws],
                                 [torch.from_numpy(b) for b in bs], "elu").numpy()
    np.testing.assert_allclose(plain, want, rtol=2e-5, atol=2e-5)
    got = rehearse_sets(x, ws, bs, "elu", 16, 4, (False,) * 5, 2)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shared", [(True, False, False, False, False), (False, True, False, False, False),
                                    (False, False, True, False, True)])
def test_rehearsal_with_shared_tensors(shared):
    """x shared, W_0 shared, the biases shared (chip_smoke.py's cases at
    G = 64, B = 3), 2 stages and 4 warps a set over 7 blocks: each set against
    plain_mlp_grouped."""
    x, ws, bs = init_scale(6, FORAGE, 3, groups=64)
    tensors = [x] + [t for pair in zip(ws, bs) for t in pair]
    tensors = [t[0] if s else t for t, s in zip(tensors, shared)]
    x, ws, bs = tensors[0], tensors[1::2], tensors[2::2]
    got = rehearse_sets(x, ws, bs, "elu", 7, 2, shared, 4)
    want = fm.plain_mlp_grouped(torch.from_numpy(x), [torch.from_numpy(w) for w in ws],
                                [torch.from_numpy(b) for b in bs], "elu").numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.fixture
def cpu_cuda_calls(monkeypatch):
    """fused_mlp_grouped_cuda on CPU tensors: the tensor checks, the device
    guard and the current stream replaced, the C entries recorded (each
    writes ``attr`` to *attr_err and returns ``code``)."""
    monkeypatch.setattr(fm, "_check_tensors", lambda x, ws, bs: None)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: SimpleNamespace(cuda_stream=7))
    for name in ("fused_mlp_launches", "fused_mlp_grouped_launches", "fused_mlp_sets_launches",
                 "fused_mlp_cluster_launches"):
        monkeypatch.setattr(fm, name, 0)
    calls = {"sets": [], "held": []}

    def entry(kind, code, attr):
        def fn(*args):
            calls[kind].append(args)
            args[-1]._obj.value = attr
            return code
        return fn

    def use(sets_code=0, sets_attr=0):
        monkeypatch.setattr(fm, "_sets_kernel", lambda: entry("sets", sets_code, sets_attr))
        monkeypatch.setattr(fm, "_kernel", lambda: entry("held", 0, 0))
        return calls

    return use


def torch_inputs(seed, dims, batch, groups):
    x, ws, bs = init_scale(seed, dims, batch, groups)
    return torch.from_numpy(x), [torch.from_numpy(w) for w in ws], [torch.from_numpy(b) for b in bs]


def test_sets_launch_calls_its_entry_and_counts(cpu_cuda_calls):
    calls = cpu_cuda_calls()
    x, ws, bs = torch_inputs(8, FORAGE, 1, MANY)
    out = fm.fused_mlp_grouped_cuda(x, ws, bs, "elu")
    ((args,),) = [calls["sets"]]
    assert not calls["held"]
    plan = fm.sets_plan(FORAGE, 1, MANY)
    assert args[:4] == (x.data_ptr(), out.data_ptr(), 1, 2)
    assert args[7:14] == (fm.ACTIVATION_CODES["elu"], plan.rows, plan.stages, plan.warps, MANY, 6, 64)
    assert args[16] == 7
    w_sets = ctypes.cast(args[14], ctypes.POINTER(ctypes.c_longlong))
    b_sets = ctypes.cast(args[15], ctypes.POINTER(ctypes.c_longlong))
    assert [w_sets[0], w_sets[1], b_sets[0], b_sets[1]] == [768, 8192, 128, 64]
    assert fm.fused_mlp_launches == fm.fused_mlp_grouped_launches == fm.fused_mlp_sets_launches == 1
    # G = 1: the ordinary launch through the held entry, no sets count
    fm.fused_mlp_grouped_cuda(x[:1], [w[:1] for w in ws], [b[:1] for b in bs], "elu")
    assert len(calls["held"]) == 1 and len(calls["sets"]) == 1
    assert fm.fused_mlp_launches == fm.fused_mlp_grouped_launches == 2 and fm.fused_mlp_sets_launches == 1


def test_shared_and_expanded_tensors_go_at_set_stride_zero(cpu_cuda_calls):
    """W_0 without a set axis and b_1 expanded over the sets: both at set
    stride 0, the plan's shared bytes counted without them in the ring."""
    calls = cpu_cuda_calls()
    x, ws, bs = torch_inputs(9, FORAGE, ROWS, MANY)
    bs[1] = bs[1][0].expand(MANY, 64)
    fm.fused_mlp_grouped_cuda(x, [ws[0][0], ws[1]], bs, "elu")
    ((args,),) = [calls["sets"]]
    w_sets = ctypes.cast(args[14], ctypes.POINTER(ctypes.c_longlong))
    b_sets = ctypes.cast(args[15], ctypes.POINTER(ctypes.c_longlong))
    assert [w_sets[0], w_sets[1], b_sets[0], b_sets[1]] == [0, 8192, 128, 0]
    shared = (False, True, False, False, True)
    launch = fm.grouped_launch_plan(FORAGE, ROWS, MANY, shared)[0]
    assert launch.sets.shared == fm.sets_shared_bytes(FORAGE, ROWS, launch.sets.stages, shared, launch.sets.warps)


@pytest.mark.parametrize("code,attr", [(-1, 0), (1, 0), (719, 0), (0, -1), (0, 1)])
def test_sets_launch_errors_raise(cpu_cuda_calls, code, attr):
    """No fallback: an error of the sets entry or of its preparation raises,
    counts nothing and never reaches the held kernel or the plain chain."""
    calls = cpu_cuda_calls(sets_code=code, sets_attr=attr)
    x, ws, bs = torch_inputs(10, FORAGE, 1, MANY)
    with pytest.raises(RuntimeError, match="fused_mlp_sets_forward"):
        fm.fused_mlp_grouped_cuda(x, ws, bs, "elu")
    assert not calls["held"] and len(calls["sets"]) == 1
    assert fm.fused_mlp_launches == fm.fused_mlp_grouped_launches == fm.fused_mlp_sets_launches == 0


def c_parameters(name):
    """The parameter list of the extern "C" function ``name`` in
    csrc/fused_mlp.cu."""
    match = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", SOURCE.read_text())
    return [p.strip() for p in match.group(1).split(",")]


def test_sets_entry_arguments_match_the_source():
    params = c_parameters("fused_mlp_sets_forward")
    assert len(params) == len(fm.SETS_ARGTYPES)
    for param, argtype in zip(params, fm.SETS_ARGTYPES):
        pointer = "*" in param
        assert pointer == (argtype in (ctypes.c_void_p,) or argtype.__name__.startswith("LP_")), param
        if not pointer:
            assert (argtype is ctypes.c_longlong) == param.startswith("long long"), param
    assert [p.split()[-1].lstrip("*") for p in params] == [
        "x", "out", "B", "n_layers", "dims", "ws", "bs", "act", "rows", "stages", "warps", "groups", "x_set", "out_set",
        "w_set", "b_set", "stream", "attr_err"]
    assert [p.split()[-1] for p in c_parameters("fused_mlp_sets_grid")] == ["rows", "groups", "smem_bytes"]
