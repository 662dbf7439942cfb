"""The streamed launch of the fused MLP (csrc/fused_mlp.cu
``fused_mlp_stream_kernel``, ops/fused_mlp.py ``stream_plan``,
``stream_copy``) on the CPU, where the kernel itself cannot run
(``chip_smoke.py`` holds it against the chain in float64 on the card):

- how the plan picks rows a block and the cluster by batch and width, and
  that the grid it implies fills the card;
- which rows go by bulk tensor copies and which by the kernel's own
  ``cp.async`` (misaligned widths, addresses and set strides);
- a rehearsal of the kernel's index arithmetic in plain Python: tiles laid
  out with the 128-byte swizzle, each lane's fragments read at the kernel's
  offsets (fragment row g from tile row p(g), weight row p(g) as column g),
  ``mma.sync``'s fragment layout, and the epilogue's rows and columns. The
  products it assembles are x . W^T of the block's tile, and half a warp's
  8-byte fragment loads fall on 32 different banks.
"""

import numpy as np
import pytest
import torch

from rl_games_tpu_torch.ops import fused_mlp as fm

TN, TK = 128, 32  # csrc/fused_mlp.cu: a W tile's outputs and a stage's inputs


def modelled_time(plan, dims, batch):
    """stream_plan's model: waves of blocks times output tiles a block
    times rows over the products' rate at those rows."""
    tiles = -(-dims[1] // TN)
    blocks = max(1, -(-batch // plan.rows)) * plan.split
    waves = -(-blocks // fm.STREAM_WAVE_BLOCKS[plan.cluster])
    return waves * tiles // plan.split * plan.rows / fm.STREAM_RATE[plan.rows]


@pytest.mark.parametrize("dims,batch,rows,split,cluster", [
    ((3136, 512), 512, 16, 4, 2),    # the Pong rollout: 128 blocks of 16 rows, one wave
    ((3136, 512), 4096, 64, 2, 2),   # the minibatch: 128 blocks of 64 rows, two output tiles each
    ((3136, 512), 4099, 64, 2, 2),   # 130 blocks: still one wave
    ((3135, 512), 512, 16, 4, 2),    # the plan does not look at K: a misaligned K has the same shape
    ((3134, 512), 4096, 64, 2, 2),
    ((4096, 4096), 1024, 64, 8, 2),  # 32 output tiles, 4 a block
    ((4096, 8), 1024, 16, 1, 1),     # one output tile: 64 blocks at most
    ((3136, 384), 4096, 64, 3, 1),   # 3 output tiles: two waves of 64-row blocks beat one of 32-row blocks
    ((3136, 640), 4096, 64, 5, 1),   # 5 output tiles: clusters must divide the split
    ((3136, 512), 3, 16, 4, 4),      # one row tile: its x multicast to 4 blocks
    ((3136, 512), 0, 16, 4, 4),      # a grouped launch of at most 16 rows a set
])
def test_stream_plan_picks_rows_split_and_cluster(dims, batch, rows, split, cluster):
    plan = fm.stream_plan(dims, batch)
    assert plan[:3] == (rows, split, cluster)
    tiles = -(-dims[1] // TN)
    assert tiles % split == 0 and split % cluster == 0  # every block of a cluster walks as many output tiles
    assert cluster <= fm.MAX_CLUSTER and plan.shared <= fm.MAX_SHARED_BYTES
    blocks, groups = fm.stream_grid(plan, batch)
    assert groups == 1 and blocks % cluster == 0 and blocks * plan.rows >= batch * split
    # no other shape the kernel takes ends earlier in the model
    best = modelled_time(plan, dims, batch)
    for r in fm.STREAM_STAGES:
        for s in range(1, fm.MAX_CLUSTER + 1):
            if tiles % s == 0:
                assert best <= modelled_time(fm.StreamPlan(r, s, 1, 0), dims, batch)


def test_stream_plan_grouped_rows_and_grid():
    """A grouped launch plans over all sets' rows and puts the sets on the
    grid's second axis: the 3136-wide torso at G = 4, B = 256 takes 32-row
    blocks split in 4, 32 a set, 128 in all."""
    (launch, head) = fm.launch_plan((3136, 512, 64), 4 * 256)
    assert launch.streamed and launch.plan[:3] == (32, 4, 2) and not head.streamed
    assert fm.stream_grid(launch.plan, 256, 4) == (32, 4)


def floats(n, offset=0):
    """n floats of a fresh buffer from ``offset`` floats on (torch's
    allocations are 16-byte aligned: offset 1 is not)."""
    buf = torch.zeros(n + offset)
    assert buf.data_ptr() % 16 == 0
    return buf[offset:]


@pytest.mark.parametrize("case,copy", [
    ("aligned", 3),              # 3136 inputs: both by bulk tensor copies
    ("3135 inputs", 0),          # rows 12,540 B apart: the kernel's 4-byte cp.async
    ("3134 inputs", 0),          # 12,536 B: 8-byte cp.async
    ("x one float off", 2),      # x's address 4 bytes past a 16-byte boundary
    ("W one float off", 1),
    ("x sets 42 floats apart", 2),
    ("W shared, x per set", 3),
])
def test_stream_copy_mode(case, copy):
    """Bulk tensor copies need a 16-byte aligned address, row stride and set
    stride; the rest go by the kernel's own copies, x and W apart."""
    k = {"3135 inputs": 3135, "3134 inputs": 3134, "x sets 42 floats apart": 40}.get(case, 3136)
    x = floats(6 * k, 1 if case == "x one float off" else 0).view(6, k)
    w = floats(16 * k, 1 if case == "W one float off" else 0).view(16, k)
    x_set = 0
    if case == "x sets 42 floats apart":
        x = floats(3 * 42).as_strided((3, 1, k), (42, k, 1))
        x_set = 42
    if case == "W shared, x per set":
        x = floats(3 * 6 * k).view(3, 6, k)
        x_set = 6 * k
    assert fm.stream_copy(x, w, x_set, 0) == copy
    assert ("x bulk" in fm.stream_copy_name(copy)) == bool(copy & 1)


# -- the kernel's index arithmetic, as csrc/fused_mlp.cu writes it ----------

def swizzled(r, c):
    """Where element (r, c) of a rows x 32 float tile lands: the bulk
    copies' 128-byte swizzle (16-byte chunk c / 4 of row r at chunk
    (c / 4) ^ (r % 8)), which the kernel's cp.async path (copy_tile_by)
    writes the same way."""
    return r * TK + ((((c >> 2) ^ (r & 7)) << 2) | (c & 3))


def lay_out(tile):
    flat = np.full(tile.size, np.nan)
    for r in range(tile.shape[0]):
        for c in range(TK):
            flat[swizzled(r, c)] = tile[r, c]
    return flat


def shape_of(tm):
    """StreamShape<TM>: warps along rows x outputs, instruction tiles a warp."""
    wm = 1 if tm == 16 else 2
    wn = 8 // wm
    return wm, wn, tm // 16 // wm, TN // 8 // wn


def lane_offsets(tm, warp, lane):
    """The multiplying lane's constants: a_off, w_off, lane_x, col_lane and
    its row in the block's tile."""
    wm_n, wn_n, mt, snt = shape_of(tm)
    wm, wn = warp // wn_n, warp % wn_n
    g, t = lane >> 2, lane & 3
    pg = ((g & 3) << 1) | (g >> 2)
    lane_x = pg ^ (t >> 1)
    a_off = (wm * 16 * mt + pg) * TK + 2 * (t & 1)
    w_off = (wn * 8 * snt + pg) * TK + 2 * (t & 1)
    col_lane = wn * 8 * snt + (((t & 1) << 2) | (t >> 1))
    row_lane = wm * 16 * mt + pg
    return a_off, w_off, lane_x, col_lane, row_lane


def k_offset(ks, lane_x):
    return ((2 * ks) ^ lane_x) << 2


@pytest.mark.parametrize("tm", [16, 32, 64])
def test_stream_fragments_reassemble_the_product(tm):
    """Every lane of every warp reads its A and B fragments at the kernel's
    offsets; ``mma.sync`` m16n8k8's layout (A (g, t) (g+8, t) (g, t+4)
    (g+8, t+4), B (k = t, n = g) (k = t+4, n = g), C (g, 2t) (g, 2t+1)
    (g+8, 2t) (g+8, 2t+1)) makes the warp's products; the epilogue's rows and
    columns put each sum where it belongs: the block's tile of x . W^T."""
    rng = np.random.default_rng(tm)
    x_tile = rng.normal(size=(tm, TK))
    w_tile = rng.normal(size=(TN, TK))
    xs, ws = lay_out(x_tile), lay_out(w_tile)
    _, _, mt, snt = shape_of(tm)
    out = np.full((tm, TN), np.nan)
    for warp in range(8):
        lanes = [lane_offsets(tm, warp, lane) for lane in range(32)]
        acc = np.zeros((32, mt, snt, 4))
        for ks in range(TK // 8):
            a = np.zeros((32, mt, 4))
            b = np.zeros((32, snt, 2))
            for lane, (a_off, w_off, lane_x, _, _) in enumerate(lanes):
                k = k_offset(ks, lane_x)
                for i in range(mt):
                    top = xs[a_off + 16 * i * TK + k:][:2]
                    bottom = xs[a_off + (16 * i + 8) * TK + k:][:2]
                    a[lane, i] = top[0], bottom[0], top[1], bottom[1]
                for j in range(snt):
                    b[lane, j] = ws[w_off + 8 * j * TK + k:][:2]
            # the instruction: assemble the warp's 16 x 8 A and 8 x 8 B, multiply, hand out C
            for i in range(mt):
                for j in range(snt):
                    am, bm = np.zeros((16, 8)), np.zeros((8, 8))
                    for lane in range(32):
                        g, t = lane >> 2, lane & 3
                        am[g, t], am[g + 8, t], am[g, t + 4], am[g + 8, t + 4] = a[lane, i]
                        bm[t, g], bm[t + 4, g] = b[lane, j]
                    cm = am @ bm
                    for lane in range(32):
                        g, t = lane >> 2, lane & 3
                        acc[lane, i, j] += cm[g, 2 * t], cm[g, 2 * t + 1], cm[g + 8, 2 * t], cm[g + 8, 2 * t + 1]
        # stream_finish: rows row_lane + 16 i + 8 h, columns col_lane + 8 j and + 2
        for lane, (_, _, _, col, row) in enumerate(lanes):
            for i in range(mt):
                for j in range(snt):
                    for h in range(2):
                        for e, dn in enumerate((0, 2)):
                            r, n = row + 16 * i + 8 * h, col + 8 * j + dn
                            assert np.isnan(out[r, n]), (warp, lane, r, n)
                            out[r, n] = acc[lane, i, j, 2 * h + e]
    np.testing.assert_allclose(out, x_tile @ w_tile.T, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("tm", [16, 32, 64])
def test_stream_fragment_loads_are_conflict_free(tm):
    """Half a warp's 8-byte loads of one fragment (16 lanes, two 4-byte
    words each) touch 32 different banks: every A and B load of every
    k-step, every warp."""
    _, _, mt, snt = shape_of(tm)
    for warp in range(8):
        lanes = [lane_offsets(tm, warp, lane) for lane in range(32)]
        for ks in range(TK // 8):
            loads = [lambda a_off, w_off, i=i: a_off + 16 * i * TK for i in range(mt)]
            loads += [lambda a_off, w_off, i=i: a_off + (16 * i + 8) * TK for i in range(mt)]
            loads += [lambda a_off, w_off, j=j: w_off + 8 * j * TK for j in range(snt)]
            for load in loads:
                for half in (range(16), range(16, 32)):
                    banks = set()
                    for lane in half:
                        a_off, w_off, lane_x, _, _ = lanes[lane]
                        word = load(a_off, w_off) + k_offset(ks, lane_x)
                        assert word % 2 == 0  # an 8-byte aligned pair
                        banks.update({word % 32, (word + 1) % 32})
                    assert len(banks) == 32, (tm, warp, ks)


def test_swizzle_is_a_permutation_within_each_row():
    """The swizzle moves 16-byte chunks within their own 128-byte row, so a
    tile's rows stay where a bulk copy of rows x 32 floats puts them."""
    for r in range(64):
        assert sorted(swizzled(r, c) for c in range(TK)) == list(range(r * TK, (r + 1) * TK))
