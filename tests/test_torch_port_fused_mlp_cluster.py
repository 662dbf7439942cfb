"""The cluster launch of the fused MLP (csrc/fused_mlp.cu
``fused_mlp_cluster_kernel``, ops/fused_mlp.py ``cluster_plan``) on the
CPU, where the kernel itself cannot run (``chip_smoke.py`` holds it against
``plain_mlp`` and the held kernel on the card):

- which launches the plan sends to the cluster kernel: held chains of three
  weight tiles at least, up to the crossover of rows (``CLUSTER_SHAPES``),
  whose shares fit a block; never a grouped launch, a streamed one, a
  two-tile chain or a batch past the crossover; and that ``kernel_plan``
  and the other fields of ``Launch`` keep their meaning;
- the shares: each layer's outputs covered once, in whole 8-wide tiles, and
  the shared bytes of ``cluster_shared_bytes`` recounted;
- a rehearsal of the kernel's dataflow in numpy: C blocks, each with its own
  two activation buffers, each computing its column share of a layer from
  its own buffer and writing it into every block's other buffer, layer by
  layer, row tile by row tile; against ``plain_mlp`` and the JAX package's
  ``fused_mlp_pallas(interpret=True)`` at rtol = atol = 2e-5;
- the shared-memory banks of the B fragments' 8-byte loads in both layouts
  of a share (rows of 8 * odd floats, and rows of K floats where one bulk
  copy brings the share);
- the wrapper: a cluster launch's C entry and arguments, its counter
  beside ``fused_mlp_launches``, and no fallback (an error raises), with
  the CUDA calls replaced on the CPU.

The kernel keeps each output's sum over all of K in the held kernel's
order, so test_torch_port_fused_mlp.py's 3xTF32 rehearsal is its numeric
scheme as well.
"""

import contextlib
import ctypes
import functools
import re
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_games_tpu.ops import fused_mlp as jfm
from rl_games_tpu_torch.ops import fused_mlp as fm

torch.set_num_threads(1)

WALKER = (16, 256, 128, 64)   # ref/ppo_walker_rnn.yaml's MLP in front of its GRU
HOST = (5, 128, 64, 32)       # ref/mujoco/halfcheetah.yaml's MLP on Hopper2D's 5 observations
FLAGSHIP = (26, 256, 128, 64)
PENDULUM, CARTPOLE = (3, 32, 32), (4, 32, 32)
FORAGE = (6, 128, 64)          # benchruns/selfplay_forage.yaml's learner
SOURCE = Path(fm.__file__).resolve().parent.parent / "csrc" / "fused_mlp.cu"


def cluster_of(batch):
    """The blocks a cluster that CLUSTER_SHAPES gives ``batch`` rows."""
    return next(cluster for most, cluster in fm.CLUSTER_SHAPES if batch <= most)


@pytest.mark.parametrize("dims,batch", [
    (WALKER, 16), (WALKER, 1), (HOST, 64), (HOST, 1), (FLAGSHIP, 1), (FLAGSHIP, 7), (FLAGSHIP, 16),
    (WALKER, 256), (FLAGSHIP, 1024), (FORAGE, 1024), ((512, 64), 512),
])
def test_small_batches_take_the_cluster_kernel(dims, batch):
    """One launch, held (``kernel_plan``'s plan as before), run as the
    cluster kernel at the measured cluster size."""
    (launch,) = fm.launch_plan(dims, batch)
    assert (launch.first, launch.last, launch.streamed) == (0, len(dims) - 1, False)
    assert launch.plan == fm.kernel_plan(dims, batch)
    assert launch.cluster == fm.ClusterPlan(cluster_of(batch), fm.cluster_shared_bytes(dims, cluster_of(batch)))
    assert launch.cluster.shared <= fm.MAX_SHARED_BYTES


@pytest.mark.parametrize("dims,batch", [
    (FLAGSHIP, 8192), (FLAGSHIP, 32768),     # the flagship's rollout and minibatch: the held kernel, 32 rows
    (WALKER, 2048), (HOST, 2048),            # the minibatches, past the crossover
    ((33, 256, 128, 64), 4096), ((41, 256, 128, 64), 32768),
    (PENDULUM, 16), (CARTPOLE, 16), (CARTPOLE, 64), ((4, 8), 1),  # two weight tiles or fewer
])
def test_the_held_kernel_keeps_the_rest(dims, batch):
    (launch,) = fm.launch_plan(dims, batch)
    assert launch.cluster is None and not launch.streamed and launch.plan == fm.kernel_plan(dims, batch)


def test_crossover_and_tile_limits():
    """The cluster kernel ends where the sweep measured the held kernel
    faster: past the last row count of CLUSTER_SHAPES, and for chains of
    fewer weight tiles than CLUSTER_MIN_TILES (Pendulum's and CartPole's
    two)."""
    most = fm.CLUSTER_SHAPES[-1][0]
    assert fm.cluster_plan(WALKER, most) is not None and fm.cluster_plan(WALKER, most + 1) is None
    assert [m for m, _ in fm.CLUSTER_SHAPES] == sorted(m for m, _ in fm.CLUSTER_SHAPES)
    assert all(c in fm.CLUSTER_BLOCKS for _, c in fm.CLUSTER_SHAPES)
    assert fm.held_weight_tiles(PENDULUM) == fm.held_weight_tiles(CARTPOLE) == 2 < fm.CLUSTER_MIN_TILES
    assert fm.held_weight_tiles(WALKER) == fm.held_weight_tiles(FLAGSHIP) == 14
    assert fm.held_weight_tiles(HOST) == 7


def test_shares_that_do_not_fit_stay_held():
    """2000 -> 2000 fits one held block at 16 rows but its share of W does
    not fit beside the buffers; the chain is cut there as before."""
    launches = fm.launch_plan((2000, 2000, 8), 3)
    assert [(p.first, p.last, p.streamed) for p in launches] == [(0, 1, False), (1, 2, False)]
    assert launches[0].cluster is None
    assert fm.cluster_shared_bytes((2000, 2000), cluster_of(3)) > fm.MAX_SHARED_BYTES
    assert launches[1].cluster is not None  # 2000 -> 8: a small share


def test_streamed_and_grouped_launches_never_take_it():
    (stream,) = fm.launch_plan((3136, 512), 16)
    assert stream.streamed and stream.cluster is None
    stream, head = fm.launch_plan((3136, 512, 64), 16)
    assert stream.cluster is None and head.cluster is not None
    assert all(p.cluster is None for p in fm.launch_plan(WALKER, 0, cluster=False))


def init_scale(seed, dims, batch, groups=None):
    rng = np.random.default_rng(seed)
    lead = () if groups is None else (groups,)
    ws = [((rng.random(lead + (dims[i + 1], dims[i])) * 2 - 1) / np.sqrt(dims[i])).astype(np.float32)
          for i in range(len(dims) - 1)]
    bs = [(rng.normal(size=lead + (dims[i + 1],)) * 0.1).astype(np.float32) for i in range(len(dims) - 1)]
    return rng.normal(size=lead + (batch, dims[0])).astype(np.float32), ws, bs


@pytest.fixture
def recorded(monkeypatch):
    """The wrappers' CUDA path on CPU tensors: each launch recorded and run
    as the plain chain."""
    seen = []

    def launch(x, out, batch, dims, ws, bs, act, launch, groups, set_strides):
        seen.append((tuple(dims), launch, groups))
        name = next(k for k, v in fm.ACTIVATION_CODES.items() if v == act)
        for g in range(groups):
            x_set, out_set, w_sets, b_sets = set_strides
            xg = torch.as_strided(x, (batch, dims[0]), (dims[0], 1), x.storage_offset() + g * x_set)
            wg = [torch.as_strided(w, (dims[i + 1], dims[i]), (dims[i], 1), w.storage_offset() + g * s)
                  for i, (w, s) in enumerate(zip(ws, w_sets))]
            bg = [torch.as_strided(b, (dims[i + 1],), (1,), b.storage_offset() + g * s)
                  for i, (b, s) in enumerate(zip(bs, b_sets))]
            torch.as_strided(out, (batch, dims[-1]), (dims[-1], 1), out.storage_offset() + g * out_set).copy_(
                fm.plain_mlp(xg, wg, bg, name))

    monkeypatch.setattr(fm, "_launch", launch)
    monkeypatch.setattr(fm, "_check_tensors", lambda x, ws, bs: None)
    return seen


@pytest.mark.parametrize("dims,groups,batch", [(FORAGE, 1024, 1), (WALKER, 4, 16), (HOST, 3, 64)])
def test_grouped_launches_stay_held(recorded, dims, groups, batch):
    """fused_mlp_grouped_cuda plans every set of at most 16 rows at batch
    0, which a rule keyed on the batch would send to the cluster kernel; it
    takes one weight set, so every grouped launch stays on the held
    kernel."""
    x, ws, bs = (torch.from_numpy(t) if isinstance(t, np.ndarray) else [torch.from_numpy(u) for u in t]
                 for t in init_scale(3, dims, batch, groups))
    got = fm.fused_mlp_grouped_cuda(x, ws, bs, "elu")
    torch.testing.assert_close(got, fm.plain_mlp_grouped(x, ws, bs, "elu"), rtol=1e-6, atol=1e-6)
    assert recorded and all(launch.cluster is None and g == groups for _, launch, g in recorded)


def test_ordinary_small_batch_walks_a_cluster_launch(recorded):
    x, ws, bs = (torch.from_numpy(t) if isinstance(t, np.ndarray) else [torch.from_numpy(u) for u in t]
                 for t in init_scale(4, WALKER, 16))
    fm.fused_mlp_cuda(x, ws, bs, "elu")
    ((dims, launch, groups),) = recorded
    assert dims == WALKER and groups == 1 and launch.cluster == fm.cluster_plan(WALKER, 16)


@pytest.mark.parametrize("dims", [WALKER, HOST, FLAGSHIP, FORAGE, (37, 50, 33, 7), (512, 64), (130, 257)])
@pytest.mark.parametrize("cluster", fm.CLUSTER_BLOCKS)
def test_shares_cover_each_output_once(dims, cluster):
    """Block r owns tiles r S .. r S + S - 1 of each layer (S = ceil(tiles /
    C)): every 8-wide tile of every layer once, the last blocks fewer or
    none; the shared bytes recounted from csrc/fused_mlp.cu's layout."""
    shares = fm.cluster_tiles(dims, cluster)
    for n, per_block in zip(dims[1:], shares):
        tiles = -(-n // 8)
        owned = [range(r * per_block, min((r + 1) * per_block, tiles)) for r in range(cluster)]
        assert sorted(t for block in owned for t in block) == list(range(tiles))
        assert per_block == -(-tiles // cluster)
    s0, s1 = fm._strides(dims)
    floats = 16 * (s0 + s1) + 2 * 2 * fm.MAX_LAYERS
    for k, per_block in zip(dims[:-1], shares):
        eights = -(-k // 8)
        floats += 8 * per_block * (8 * (eights if eights % 2 else eights + 1) + 1)
    # and the kernel's static table of 8 layer records of 48 bytes
    assert fm.cluster_shared_bytes(dims, cluster) == 4 * floats + 8 * 48


def rehearse_cluster(x, ws, bs, activation, cluster):
    """The cluster kernel's dataflow in numpy float32 (ws [out, in]): a
    cluster a 16-row tile; each block copies x's tile into its even buffer;
    for layer l each block multiplies its own buffer by its column share of
    W_l (zero-filled to whole tiles and to K rounded up to 8) and writes the
    share into the other buffer of every block of the cluster, its own
    included; the last layer's shares go to out. Checks that every block's
    buffer is whole and the same after each exchange, and that a layer
    never writes the buffer that it reads."""
    act = {"elu": lambda v: np.where(v > 0, v, np.expm1(np.minimum(v, 0))), "relu": lambda v: np.maximum(v, 0),
           "tanh": np.tanh}[activation]
    dims = [x.shape[1]] + [w.shape[0] for w in ws]
    shares = fm.cluster_tiles(dims, cluster)
    strides = fm._strides(dims)
    batch, out = x.shape[0], np.full((x.shape[0], dims[-1]), np.nan, np.float32)
    for row0 in range(0, batch, 16):
        rows = min(16, batch - row0)
        bufs = [[np.full((16, s), np.nan, np.float32) for s in strides] for _ in range(cluster)]
        for block in bufs:
            block[0][:, :-(-dims[0] // 8) * 8] = 0.0
            block[0][:rows, :dims[0]] = x[row0:row0 + rows]
        for l, (w, b) in enumerate(zip(ws, bs)):
            k, n = dims[l], dims[l + 1]
            kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
            src, dst = l % 2, (l + 1) % 2
            assert src != dst
            for r in range(cluster):
                n0, n1 = r * shares[l] * 8, min((r + 1) * shares[l] * 8, np_)
                if n0 >= n1:
                    continue
                w_share = np.zeros((n1 - n0, kp), np.float32)
                w_share[:max(0, min(n1, n) - n0), :k] = w[n0:min(n1, n)]
                b_share = np.zeros(n1 - n0, np.float32)
                b_share[:max(0, min(n1, n) - n0)] = b[n0:min(n1, n)]
                y = act(bufs[r][src][:, :kp] @ w_share.T + b_share).astype(np.float32)
                y[:, max(0, n - n0):] = 0.0  # columns N .. Np-1: the next layer's zero-filled inputs
                if l == len(ws) - 1:
                    out[row0:row0 + rows, n0:min(n1, n)] = y[:rows, :min(n1, n) - n0]
                else:
                    for peer in bufs:
                        peer[dst][:, n0:n1] = y
            if l < len(ws) - 1:
                first = bufs[0][dst][:, :np_]
                assert not np.isnan(first).any()
                assert all(np.array_equal(block[dst][:, :np_], first) for block in bufs)
    return out


@pytest.mark.parametrize("dims,batch,activation", [
    (WALKER, 16, "elu"), (FLAGSHIP, 1, "elu"), (FLAGSHIP, 7, "tanh"), (HOST, 37, "elu"),
    ((37, 50, 33, 7), 19, "relu"), (FORAGE, 33, "elu"),
])
@pytest.mark.parametrize("cluster", [2, 8, 16])
def test_dataflow_matches_plain_and_pallas(dims, batch, activation, cluster):
    """The rehearsal against plain_mlp and the JAX package's Pallas kernel
    in interpret mode (weights carried across transposed), rtol = atol =
    2e-5 as test_matches_jax_plain_and_pallas holds them."""
    x, ws, bs = init_scale(5, dims, batch)
    got = rehearse_cluster(x, ws, bs, activation, cluster)
    plain = fm.plain_mlp(torch.from_numpy(x), [torch.from_numpy(w) for w in ws], [torch.from_numpy(b) for b in bs],
                         activation).numpy()
    np.testing.assert_allclose(got, plain, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, pallas_chain(dims, batch, activation), rtol=2e-5, atol=2e-5)


@functools.lru_cache(maxsize=None)
def pallas_chain(dims, batch, activation):
    """The JAX package's Pallas kernel in interpret mode on init_scale(5)'s
    inputs (once a chain: every cluster size is held to the same result)."""
    x, ws, bs = init_scale(5, dims, batch)
    return np.asarray(jfm.fused_mlp_pallas(
        jnp.asarray(x), tuple(jnp.asarray(w.T) for w in ws), tuple(jnp.asarray(b) for b in bs), activation,
        interpret=True, block_b=256))


def fragment_conflicts(ld):
    """The most lanes of half a warp whose 8-byte B-fragment loads (lane g,
    t at row g, inputs 2t and 2t + 1 of a step, rows ``ld`` floats apart)
    fall on one bank at different addresses."""
    worst = 1
    for half in (range(16), range(16, 32)):
        banks = {}
        for lane in half:
            g, t = lane // 4, lane % 4
            for word in (g * ld + 2 * t, g * ld + 2 * t + 1):
                banks.setdefault(word % 32, set()).add(word)
        worst = max(worst, max(len(words) for words in banks.values()))
    return worst


@pytest.mark.parametrize("k", [5, 16, 26, 64, 128, 256, 512, 2000])
def test_share_layouts_bank_conflicts(k):
    """A share copied by the kernel's cp.async takes rows of 8 * odd floats
    (``_buffer_stride``): no conflict. A share that one bulk copy brings
    keeps W's rows of K floats (K a multiple of 8): at most 4-way, as the
    kernel's notes say (4 where K is a multiple of 32)."""
    assert fragment_conflicts(fm._buffer_stride([k])) == 1
    if k % 8 == 0:
        assert fragment_conflicts(k) == (4 if k % 32 == 0 else 2 if k % 16 == 0 else 1)


def c_parameters(name):
    """The parameter list of the extern "C" function ``name`` in
    csrc/fused_mlp.cu."""
    text = SOURCE.read_text()
    match = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
    return [p.strip() for p in match.group(1).split(",")]


def test_cluster_entry_arguments_match_the_source():
    params = c_parameters("fused_mlp_cluster_forward")
    assert len(params) == len(fm.CLUSTER_ARGTYPES)
    for param, argtype in zip(params, fm.CLUSTER_ARGTYPES):
        pointer = "*" in param
        assert pointer == (argtype in (ctypes.c_void_p,) or argtype.__name__.startswith("LP_")), param
    assert [p.split()[-1].lstrip("*") for p in params] == [
        "x", "out", "B", "n_layers", "dims", "ws", "bs", "act", "cluster", "stride0", "stride1", "stream",
        "attr_err"]


@pytest.fixture
def cpu_cuda_calls(monkeypatch):
    """_launch on CPU tensors: the device guard and the current stream
    replaced, the C entries recorded."""
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(fm, "fused_mlp_launches", 0)
    monkeypatch.setattr(fm, "fused_mlp_cluster_launches", 0)
    calls = {"cluster": [], "held": []}

    def entry(kind, code):
        def fn(*args):
            calls[kind].append(args)
            return code
        return fn

    def use(cluster_code=0, held_code=0):
        monkeypatch.setattr(fm, "_cluster_kernel", lambda: entry("cluster", cluster_code))
        monkeypatch.setattr(fm, "_kernel", lambda: entry("held", held_code))
        return calls

    return use


def launch_walker(batch, launch=None):
    x, ws, bs = (torch.from_numpy(t) if isinstance(t, np.ndarray) else [torch.from_numpy(u) for u in t]
                 for t in init_scale(6, WALKER, batch))
    out = torch.empty((batch, WALKER[-1]))
    (planned,) = fm.launch_plan(WALKER, batch)
    fm._launch(x, out, batch, list(WALKER), ws, bs, fm.ACTIVATION_CODES["elu"], launch or planned, 1,
               (0, 0, [0] * 3, [0] * 3))
    return x, ws, out


def test_cluster_launch_calls_its_entry_and_counts(cpu_cuda_calls):
    calls = cpu_cuda_calls()
    x, ws, out = launch_walker(16)
    ((args,),) = [calls["cluster"]]
    assert not calls["held"]
    plan = fm.cluster_plan(WALKER, 16)
    assert args[:4] == (x.data_ptr(), out.data_ptr(), 16, 3)
    assert args[7:11] == (fm.ACTIVATION_CODES["elu"], plan.cluster, *fm._strides(WALKER)) and args[11] == 7
    assert fm.fused_mlp_launches == fm.fused_mlp_cluster_launches == 1
    # a held Launch (as chip_smoke.py hands _run_chain to compare) takes the held entry and no cluster count
    launch_walker(16, fm.Launch(0, 3, False, fm.kernel_plan(WALKER, 16)))
    assert len(calls["held"]) == 1 and fm.fused_mlp_launches == 2 and fm.fused_mlp_cluster_launches == 1


@pytest.mark.parametrize("code", [-1, 1, 719])
def test_cluster_launch_errors_raise(cpu_cuda_calls, code):
    """No fallback: an error of the cluster entry raises, counts nothing
    and never reaches the held kernel or the plain chain."""
    calls = cpu_cuda_calls(cluster_code=code)
    with pytest.raises(RuntimeError, match="fused_mlp_cluster_forward"):
        launch_walker(16)
    assert not calls["held"] and fm.fused_mlp_launches == fm.fused_mlp_cluster_launches == 0


def test_cluster_launch_refuses_weight_sets(cpu_cuda_calls):
    cpu_cuda_calls()
    x, ws, bs = (torch.from_numpy(t) if isinstance(t, np.ndarray) else [torch.from_numpy(u) for u in t]
                 for t in init_scale(7, WALKER, 16))
    with pytest.raises(ValueError, match="one weight set"):
        fm._launch(x, torch.empty((16, 64)), 16, list(WALKER), ws, bs, 2, fm.launch_plan(WALKER, 16)[0], 2,
                   (0, 0, [0] * 3, [0] * 3))
