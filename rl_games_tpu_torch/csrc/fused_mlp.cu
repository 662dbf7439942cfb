// Fully-fused sequential MLP forward for Hopper (sm_90a), on the tensor cores.
//
// Replaces the TPU kernel `_fused_kernel` in rl_games_tpu/ops/fused_mlp.py
// (launched by `fused_mlp_pallas`). One launch computes, for every row of x,
//
//   h_0 = x;   h_{l+1} = act(h_l . W_l^T + b_l)   for l = 0 .. L-1;   out = h_L
//
// with the activation applied after every layer, the last one too. x is
// [B, D_0], W_l is [D_{l+1}, D_l] (torch.nn.Linear's layout, the input index
// contiguous), b_l is [D_{l+1}], out is [B, D_L], all contiguous float32.
//
// The same launch also walks G weight sets at once (a grouped launch: the
// per-env opponent seats of a self-play env, which the JAX package runs as
// the Pallas call under jax.vmap over stacked weights). Set s reads x, W_l and
// b_l and writes out at s times each tensor's set stride (in floats) past its
// base; a stride of 0 shares the tensor among all sets, so shared weights are
// never copied G times. The ordinary launch is G = 1 with every stride 0.
//
// What bounds it on this card: operations. At the flagship torso
// 26 -> 256 -> 128 -> 64 a row costs 2 * 47,616 flop against 360 bytes
// moved, and the only unit that does such a chain quickly is the tensor core,
// which takes TF32 operands (10 mantissa bits). One TF32 product misses the
// float32 tolerance by orders of magnitude, so every product is made three
// times (3xTF32): each operand is split as v = hi + lo with hi = tf32(v), and
// a_lo.w_hi + a_hi.w_lo + a_hi.w_hi is accumulated in float32; the dropped
// lo.lo term is about 2^-22 of the product. The bound of such a kernel is
// 3 * flop over the card's TF32 rate. What keeps the kernel from it: the
// warp-level `mma.sync` does not reach the rate of the warpgroup
// instruction, and a row tile's walk through the chain is a sequence of
// phases (first copies, products, bias and activation) of which only the
// products use the tensor cores; two blocks that share an SM start together
// and stay in step, so one's activations (expm1f for elu: about a sixth of
// the kernel's time) seldom run under the other's products.
//
// Design.
// - Products: `mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32`. A (rows
//   x inputs, row-major) is the activation tile, B ("col": the input index
//   contiguous per output column) is exactly W's [out, in] layout, so no
//   transposed copy is made anywhere. With g = lane / 4 and t = lane % 4 a
//   lane holds A (g, t) (g+8, t) (g, t+4) (g+8, t+4), B (k = t, n = g)
//   (k = t+4, n = g) and C (g, 2t) (g, 2t+1) (g+8, 2t) (g+8, 2t+1). A sum
//   over inputs does not care for their order, so a lane feeds inputs 2t and
//   2t+1 where the layout says t and t+4: each fragment half is one 8-byte
//   shared-memory load.
// - The split is an integer add and a mask (round to nearest) and one
//   subtraction; the tensor core reads the leading bits of lo itself. The
//   compiler's own cvt.rna.tf32.f32 costs four instructions on this target.
// - The tensor core's adder truncates where a float32 add rounds, once per
//   instruction, always towards zero. The two small products therefore go
//   to an accumulator of their own and only a_hi.w_hi to the main one: the
//   main sum sees one truncation per 8 inputs, not three, and the small sum's
//   truncations are 2^-11 of that. Both are added, in float32, before the
//   bias.
// - A block owns a tile of 32 or 16 rows and walks the whole chain for it, so
//   intermediate activations never leave the SM: they alternate between two
//   shared-memory buffers (even-numbered and odd-numbered widths). Two
//   blocks share an SM (at the flagship torso a 32-row block takes 110 KB).
//   Row strides are 8 * odd floats, which spreads the 4 rows x 4 pairs of
//   inputs that half a warp loads over the 32 banks. Eight warps multiply:
//   each owns all the tile's rows by 16 of a weight tile's 128 outputs, 2 x 2
//   or 1 x 2 instruction tiles. Per 8 inputs it splits its A fragments once and
//   reuses them across its output columns, and splits each B fragment once
//   and reuses it across its rows, so a split is paid per element per use,
//   not per product.
// - Weights stay in device memory (L2) and are staged in tiles of 128
//   outputs x 32 inputs, row stride 40 floats (conflict-free for the B
//   fragment), with `cp.async` straight into a ring of three tiles: 16-byte
//   copies where every row of W starts on a 16-byte boundary, else 8-byte or
//   4-byte copies (the flagship's first layer has 26 inputs: 8 bytes);
//   out-of-range elements are zero-filled by the copy itself (source size 0).
//   x takes the same way in. The ring runs ahead across layer boundaries, and
//   there is one `__syncthreads()` per tile: it publishes the tile that has
//   landed and frees the slot of the tile before it for the next copy.
// - A launch may stream its first layer's input instead of holding it (a
//   width that no buffer of a block's shared memory holds: the 3136 inputs
//   behind the nature-CNN need 200 KB at 16 rows). Each ring stage then
//   carries, beside a weight tile of layer 0, the block's rows of x by the
//   same 32 inputs (row stride 40), copied the same way, and layer 0 reads
//   its A fragments there. The weight tiles run inputs-fastest, so x's rows
//   are read once per 128 outputs (from L2 after the first). The mode is a
//   template parameter: a launch that holds x runs exactly the code it ran
//   without the mode. A chain too deep for the argument block or with an
//   inner width that no buffer holds is cut into several launches by the
//   wrapper (ops/fused_mlp.py launch_plan), each next launch streaming the
//   width that the one before wrote to device memory.
// - A streamed launch sums a_hi.w_hi per weight tile: the tensor core's
//   adder truncates towards zero, always the same way, so over the 392
//   instructions of 3136 inputs the bias of one running sum reaches the
//   tolerance (the CPU rehearsal in tests/test_torch_port_fused_mlp.py puts
//   it at 12 times the tolerance at inputs of 30). Each tile's 32 inputs
//   start from zero and are added into a float32 total with a rounding add,
//   so the truncations are relative to a tile's partial sum.
// - A ninth warp issues the copies. A `cp.async` completes on its own, but
//   its issue holds the warp until the SM's path from L2 has taken it; issued
//   by the multiplying warps, the copies cost them a sixth of their time.
//   Only the first copies (x and the ring's first two tiles), which nothing
//   can hide, are shared out among all nine warps.
// - A layer's bias is asked for when its first tile begins and added after
//   its last, so the trip to device memory passes under the products. Bias
//   and activation are applied to the sums in the registers, the activation
//   chosen once per layer end outside the loops over the sums, so that only
//   the chosen activation's code is ever fetched. elu and selu call expm1f
//   without a branch around it: a branch per element keeps a thread's
//   elements from overlapping. The results go to the other buffer or, after
//   the last layer, to `out`.
// - Nothing is padded in device memory. In shared memory widths are
//   zero-filled up to a multiple of 8 (the instruction's depth and width);
//   ragged rows and columns are masked at the store.
// - A grouped launch puts the set on the grid's second axis: a block finds
//   its set in blockIdx.y and offsets its pointers before its first copy.
//   The width of each copy is chosen from the address that the copy is
//   handed, so a set stride that breaks 16-byte alignment (a 6 -> 7 layer's
//   42 floats a set) takes the narrower copies in the sets it misaligns.
//   Each block streams its set's weights once; at one row a set (the
//   opponents' case) a 16-row tile runs with 15 rows idle.
// - Inputs must be finite: the split of an infinity is not a number.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxLayers = 8;
constexpr int TN = 128;      // output columns per weight tile
constexpr int TK = 32;       // inputs per weight tile
constexpr int WS = TK + 8;   // weight tile row stride: 40 = 8 * odd
constexpr int kStages = 3;   // weight tiles in the ring
constexpr int kTileFloats = TN * WS;
// floats of a ring stage: a weight tile and, when layer 0's input is
// streamed, the block's `rows` rows of x by the tile's 32 inputs
__host__ __device__ constexpr int stage_floats(int rows, bool stream) {
  return kTileFloats + (stream ? rows * WS : 0);
}
constexpr int kWarps = 8;  // warps that multiply, side by side along a weight tile's 128 outputs
constexpr int kThreads = 32 * (kWarps + 1);  // and one warp that issues the copies
constexpr int NT = TN / 8 / kWarps;          // 8-wide instruction tiles of outputs per warp
constexpr int kMaxGroups = 65535;            // weight sets a launch: the grid's second axis

struct Net {
  const float* w[kMaxLayers];
  const float* b[kMaxLayers];
  // set strides in floats (0: every set shares the tensor)
  long long w_set[kMaxLayers];
  long long b_set[kMaxLayers];
  long long x_set, out_set;
  int dims[kMaxLayers + 1];
  int n_layers;
  int act;
  int stride0;  // row stride (floats, 8 * odd) of the even-width buffer (widths 2, 4, ... if x streams)
  int stride1;  // same for the odd-width buffer
};

enum Act { kIdentity = 0, kRelu, kElu, kSelu, kSoftplus, kGelu, kSigmoid, kSilu, kTanh };

template <int kAct>
__device__ __forceinline__ float activate(float x) {
  switch (kAct) {
    case kRelu:
      return fmaxf(x, 0.0f);
    // elu and selu take expm1f without a branch around it: a branch per
    // element would keep the elements of one thread from overlapping
    case kElu: {
      const float e = expm1f(fminf(x, 0.0f));
      return x > 0.0f ? x : e;
    }
    case kSelu: {
      const float e = 1.6732632423543772f * expm1f(fminf(x, 0.0f));
      return 1.0507009873554805f * (x > 0.0f ? x : e);
    }
    case kSoftplus:
      return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
    case kGelu: {
      const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
      return 0.5f * x * (1.0f + tanhf(u));
    }
    case kSigmoid:
      return 1.0f / (1.0f + expf(-x));
    case kSilu:
      return x / (1.0f + expf(-x));
    case kTanh:
      return tanhf(x);
    default:
      return x;
  }
}

// v = hi + lo exactly: hi is v rounded to the nearest TF32 value (10 mantissa
// bits; ties away from zero, as cvt.rna.tf32.f32 rounds, here as an integer
// add and a mask, which is cheaper than what the compiler makes of the cvt),
// lo the rest, of which the tensor core reads the leading 10 mantissa bits.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// c += a . b for one 16 x 8 x 8 tile, float32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Asynchronous copy of kFloats (4, 2 or 1) floats device memory -> shared
// memory; with `inside` false it reads nothing and writes zeros.
template <int kFloats>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool inside) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int src_bytes = inside ? 4 * kFloats : 0;
  if (kFloats == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(src_bytes)
                 : "memory");
  else if (kFloats == 2)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(d), "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

template <int kFloats, int kCopiers>
__device__ __forceinline__ void stage_tile_by(float* dst, int ld_dst, const float* __restrict__ src,
                                              int rows_inside, int n_cols, int c0, int rows_fill,
                                              int cols_fill, int tid) {
  // a thread keeps its column and walks down the rows: first those inside
  // the matrix, then those that are filled with zeros
  constexpr int kPerRow = TK / kFloats;
  constexpr int kStep = kCopiers / kPerRow;
  const int c = (tid % kPerRow) * kFloats;
  if (c >= cols_fill) return;
  if (c0 + c >= n_cols) rows_inside = 0;
  int r = tid / kPerRow;
  const float* from = src + r * n_cols + c0 + c;
  float* to = dst + r * ld_dst + c;
  const int from_step = kStep * n_cols;
  const int to_step = kStep * ld_dst;
  for (; r < rows_inside; r += kStep) {
    cp_async<kFloats>(to, from, true);
    from += from_step;
    to += to_step;
  }
  for (; r < rows_fill; r += kStep) {
    cp_async<kFloats>(to, src, false);
    to += to_step;
  }
}

// Starts the copies, shared out among threads 0 .. kCopiers-1 (this one is
// `tid`), of a tile of a row-major matrix with rows of n_cols floats into
// `dst` (row stride `ld_dst`). `src` points at the tile's first row, of which
// `rows_inside` lie inside the matrix; the tile takes rows 0 .. rows_fill-1 by
// columns c0 .. c0+31, the columns as far as n_cols rounded up to 8 reaches,
// and is zero outside the matrix. Copies are as wide (16, 8 or 4 bytes) as the
// alignment of the rows allows. Offsets within a tile are 32-bit: a tile spans
// at most 128 rows.
template <int kCopiers>
__device__ __forceinline__ void stage_tile(float* dst, int ld_dst, const float* __restrict__ src,
                                           int rows_inside, int n_cols, int c0, int rows_fill,
                                           int tid) {
  const int cols_fill = min(TK, ((n_cols + 7) & ~7) - c0);
  const uintptr_t address = reinterpret_cast<uintptr_t>(src);
  if ((n_cols & 3) == 0 && (address & 15) == 0)
    stage_tile_by<4, kCopiers>(dst, ld_dst, src, rows_inside, n_cols, c0, rows_fill, cols_fill,
                               tid);
  else if ((n_cols & 1) == 0 && (address & 7) == 0)
    stage_tile_by<2, kCopiers>(dst, ld_dst, src, rows_inside, n_cols, c0, rows_fill, cols_fill,
                               tid);
  else
    stage_tile_by<1, kCopiers>(dst, ld_dst, src, rows_inside, n_cols, c0, rows_fill, cols_fill,
                               tid);
}

// Position in the chain's sequence of weight tiles (layer, tile of outputs,
// tile of inputs; the inputs run fastest), with the layer's shape beside it
// so that a step within a layer reads nothing from the argument block.
struct TilePos {
  int l, nc, kc;
  int K, N, nK, nN;
  const float* W;
};

__device__ __forceinline__ void enter_layer(TilePos& p, const Net& net, int l) {
  p.l = l;
  p.nc = p.kc = 0;
  if (l >= net.n_layers) return;
  p.K = net.dims[l];
  p.N = net.dims[l + 1];
  p.nK = (p.K + TK - 1) / TK;
  p.nN = (p.N + TN - 1) / TN;
  p.W = net.w[l] + blockIdx.y * net.w_set[l];  // this block's weight set
}

__device__ __forceinline__ void advance(TilePos& p, const Net& net) {
  if (p.l >= net.n_layers) return;
  if (++p.kc == p.nK) {
    p.kc = 0;
    if (++p.nc == p.nN) enter_layer(p, net, p.l + 1);
  }
}

// Starts the copies of the weight tile at `p`: outputs n0 .. n0+127 (as far
// as the layer's width rounded up to 8 reaches) by inputs k0 .. k0+31 of
// W [N, K]. Past the last layer it copies nothing.
template <int kCopiers>
__device__ __forceinline__ void stage_w_tile(float* ws, const Net& net, const TilePos& p, int tid) {
  if (p.l >= net.n_layers) return;
  const int n0 = p.nc * TN;
  stage_tile<kCopiers>(ws, WS, p.W + static_cast<size_t>(n0) * p.K, min(TN, p.N - n0), p.K,
                       p.kc * TK, min(TN, ((p.N + 7) & ~7) - n0), tid);
}

// Starts the copies of the ring stage at `p`: its weight tile and, with
// kStream on a tile of layer 0, the block's TM rows of x (`x_tile`, of which
// `rows_inside` lie inside the batch) by the tile's 32 inputs.
template <int kCopiers, int TM, bool kStream>
__device__ __forceinline__ void stage_ring(float* stage, const Net& net, const TilePos& p,
                                           const float* __restrict__ x_tile, int rows_inside,
                                           int tid) {
  stage_w_tile<kCopiers>(stage, net, p, tid);
  if constexpr (kStream) {
    if (p.l == 0)
      stage_tile<kCopiers>(stage + kTileFloats, WS, x_tile, rows_inside, p.K, p.kc * TK, TM, tid);
  }
}

// The three products of 8 inputs for a warp's MT x NT instruction tiles.
// `a` points at this lane's (row g, input 2t) of the activation tile, `w` at
// its (output g, input 2t) of the weight tile. A sum over inputs does not
// care for their order, so the lane hands the instruction inputs 2t and 2t+1
// where its fragment layout says t and t+4, in A and B alike: each fragment
// half is then one 8-byte load. With kAll every tile of outputs holds columns
// of the layer and the step is free of branches; else only the first
// `active` tiles do.
template <int MT, bool kAll>
__device__ __forceinline__ void product_step(float (&big)[MT][NT][4], float (&small)[MT][NT][4],
                                             const float* a, int s_in, const float* w,
                                             int active) {
  uint32_t a_hi[MT][4], a_lo[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const float2 top = *reinterpret_cast<const float2*>(a + 16 * i * s_in);
    const float2 bottom = *reinterpret_cast<const float2*>(a + (16 * i + 8) * s_in);
    split_tf32(top.x, a_hi[i][0], a_lo[i][0]);
    split_tf32(bottom.x, a_hi[i][1], a_lo[i][1]);
    split_tf32(top.y, a_hi[i][2], a_lo[i][2]);
    split_tf32(bottom.y, a_hi[i][3], a_lo[i][3]);
  }
  uint32_t b_hi[NT][2], b_lo[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (kAll || j < active) {
      const float2 wv = *reinterpret_cast<const float2*>(w + 8 * j * WS);
      split_tf32(wv.x, b_hi[j][0], b_lo[j][0]);
      split_tf32(wv.y, b_hi[j][1], b_lo[j][1]);
    }
  }
  // the two products that share an accumulator stand a whole round apart, so
  // that neither waits for the other
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < MT; ++i)
      if (kAll || j < active) mma_tf32(small[i][j], a_lo[i], b_hi[j]);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < MT; ++i)
      if (kAll || j < active) mma_tf32(big[i][j], a_hi[i], b_hi[j]);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < MT; ++i)
      if (kAll || j < active) mma_tf32(small[i][j], a_hi[i], b_lo[j]);
}

// The end of a layer for one thread: bias and activation on the sums that it
// holds (`active` tiles of outputs by 2 * MT rows 8 apart, a pair of columns
// each), then to the other buffer at `mine` (its row g, column 2t of the
// warp's tile) or, after the last layer, to `out`.
template <int kAct, int MT>
__device__ __forceinline__ void finish_layer(const float (&big)[MT][NT][4],
                                             const float (&small)[MT][NT][4],
                                             const float (&bias_lane)[NT][2], float* mine,
                                             int s_out, int active, int n_lane, int N, bool last,
                                             float* __restrict__ out, long long row_lane,
                                             long long B) {
  float* out_lane = out + row_lane * N + n_lane;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < active) {
      const int n = n_lane + 8 * j;
      const bool in0 = n < N, in1 = n + 1 < N;
#pragma unroll
      for (int q = 0; q < 2 * MT; ++q) {
        const int i = q / 2, h = q % 2;
        const float y0 = activate<kAct>(big[i][j][2 * h] + small[i][j][2 * h] + bias_lane[j][0]);
        const float y1 =
            activate<kAct>(big[i][j][2 * h + 1] + small[i][j][2 * h + 1] + bias_lane[j][1]);
        if (last) {
          if (row_lane + 8 * q < B) {
            if (in0) out_lane[8 * q * N + 8 * j] = y0;
            if (in1) out_lane[8 * q * N + 8 * j + 1] = y1;
          }
        } else {
          // columns N .. Np-1 are the next layer's zero-filled inputs
          *reinterpret_cast<float2*>(mine + 8 * q * s_out + 8 * j) =
              make_float2(in0 ? y0 : 0.0f, in1 ? y1 : 0.0f);
        }
      }
    }
  }
}

// MT: 16-row instruction tiles per warp. Every warp covers all 16 * MT rows
// of the block's tile and 16 of the weight tile's 128 columns. kStream:
// layer 0's input comes through the ring stages, not buf0.
template <int MT, bool kStream>
__global__ void __launch_bounds__(kThreads, 2)
fused_mlp_kernel(const float* __restrict__ x, float* __restrict__ out, int B, Net net) {
  constexpr int TM = 16 * MT;
  constexpr int kStageFloats = stage_floats(TM, kStream);
  extern __shared__ __align__(16) float smem[];
  float* buf0 = smem;
  float* buf1 = buf0 + TM * net.stride0;
  float* ring = buf1 + TM * net.stride1;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int col_base = warp * (8 * NT);
  const long long row0 = static_cast<long long>(blockIdx.x) * TM;
  // this block's set: its rows of x and of out
  x += blockIdx.y * net.x_set;
  out += blockIdx.y * net.out_set;

  // Everyone shares the first copies: the tile's rows of x (unless they
  // stream) and the ring's first kStages - 1 stages (x and the first stage
  // make one group).
  TilePos ahead, pos;
  enter_layer(ahead, net, 0);
  enter_layer(pos, net, 0);
  const float* x_tile = x + row0 * net.dims[0];
  const int rows_inside = static_cast<int>(min(static_cast<long long>(TM), B - row0));
  if constexpr (!kStream) {
    for (int c0 = 0; c0 < net.dims[0]; c0 += TK)
      stage_tile<kThreads>(buf0 + c0, net.stride0, x_tile, rows_inside, net.dims[0], c0, TM, tid);
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    stage_ring<kThreads, TM, kStream>(ring + s * kStageFloats, net, ahead, x_tile, rows_inside, tid);
    cp_async_commit();
    advance(ahead, net);
  }

  if (warp == kWarps) {
    // The copying warp issues every later copy. Copies are asynchronous, but
    // issuing one holds a warp until the SM's path from L2 has taken it, and
    // this warp has nothing else to do. It stays kStages - 1 tiles ahead of
    // the others and meets them at every tile's barrier: before it, its own
    // copies of that tile have landed; after it, everyone is done with the
    // tile before, whose slot the next copies take.
    for (int it = 0; pos.l < net.n_layers; ++it) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      stage_ring<32, TM, kStream>(ring + ((it + kStages - 1) % kStages) * kStageFloats, net, ahead,
                                  x_tile, rows_inside, lane);
      cp_async_commit();
      advance(ahead, net);
      advance(pos, net);
    }
    return;
  }

  cp_async_wait<0>();  // this thread's share of the first copies
  float big[MT][NT][4], small[MT][NT][4];
  float total[MT][NT][4];  // kStream: the sum of a layer's tiles of big so far
  float bias_lane[NT][2];  // the bias of this lane's columns 2t, 2t+1 of each tile of outputs
  for (int it = 0; pos.l < net.n_layers; ++it) {
    // tile `it` has landed, and x or the previous layer's output is complete
    __syncthreads();

    const int l = pos.l;
    const int N = pos.N;
    const int Kp = (pos.K + 7) & ~7;
    const int Np = (N + 7) & ~7;
    const int n0 = pos.nc * TN;
    const int k0 = pos.kc * TK;
    const float* ws = ring + (it % kStages) * kStageFloats;
    // layer 0's streamed input: this stage's rows of x by the tile's inputs
    const bool streamed = kStream && l == 0;
    const float* in = streamed ? ws + kTileFloats : (l & 1) ? buf1 : buf0;
    const int s_in = streamed ? WS : (l & 1) ? net.stride1 : net.stride0;
    // this warp's 8-wide tiles of outputs that hold columns of the layer
    const int active = min(NT, max(0, Np - n0 - col_base) / 8);

    if (pos.kc == 0) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) big[i][j][e] = small[i][j][e] = total[i][j][e] = 0.0f;
      // asked for now, needed after the layer's last product: the trip to
      // device memory passes under the products
      const float* __restrict__ bias = net.b[l] + blockIdx.y * net.b_set[l];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + col_base + 2 * t + 8 * j + e;
          bias_lane[j][e] = n < N ? bias[n] : 0.0f;
        }
    }

    if (active > 0) {
      // inputs beyond Kp were never written in `in`: stop there (the weight
      // tile is zero from K on, and `in` is zero from K to Kp)
      const int ksteps = min(TK, Kp - k0) / 8;
      const float* a = in + g * s_in + (streamed ? 0 : k0) + 2 * t;
      const float* w = ws + (col_base + g) * WS + 2 * t;
      if (ksteps == TK / 8 && active == NT) {
#pragma unroll
        for (int ks = 0; ks < TK / 8; ++ks)
          product_step<MT, true>(big, small, a + 8 * ks, s_in, w + 8 * ks, NT);
      } else {
        for (int ks = 0; ks < ksteps; ++ks)
          product_step<MT, false>(big, small, a + 8 * ks, s_in, w + 8 * ks, active);
      }
      if constexpr (kStream) {
        // the tile's sums go into the total with a rounding add, and the next
        // tile's start from zero; after the layer's last tile big holds the
        // total (the same sum: a float add does not care for its order)
        const bool layer_end = pos.kc == pos.nK - 1;
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (layer_end) {
                big[i][j][e] += total[i][j][e];
              } else {
                total[i][j][e] += big[i][j][e];
                big[i][j][e] = 0.0f;
              }
            }
      }

      if (pos.kc == pos.nK - 1) {
        // one copy of the layer's end per activation, chosen here, outside
        // its loops: only the chosen one is ever fetched
        const int s_out = (l & 1) ? net.stride0 : net.stride1;
        const int n_lane = n0 + col_base + 2 * t;
        float* mine = ((l & 1) ? buf0 : buf1) + g * s_out + n_lane;
        const bool last = (l == net.n_layers - 1);
        const long long row_lane = row0 + g;
        switch (net.act) {
#define FUSED_MLP_FINISH(kAct)                                                               \
  case kAct:                                                                                 \
    finish_layer<kAct, MT>(big, small, bias_lane, mine, s_out, active, n_lane, N, last, out, \
                           row_lane, B);                                                     \
    break;
          FUSED_MLP_FINISH(kIdentity)
          FUSED_MLP_FINISH(kRelu)
          FUSED_MLP_FINISH(kElu)
          FUSED_MLP_FINISH(kSelu)
          FUSED_MLP_FINISH(kSoftplus)
          FUSED_MLP_FINISH(kGelu)
          FUSED_MLP_FINISH(kSigmoid)
          FUSED_MLP_FINISH(kSilu)
          FUSED_MLP_FINISH(kTanh)
#undef FUSED_MLP_FINISH
        }
      }
    }
    advance(pos, net);
  }
}

// Shared memory for a tile of `rows` rows: both activation buffers and the
// ring's stages, in bytes (ops/fused_mlp.py kernel_plan computes the same).
int smem_bytes_for(int rows, int stride0, int stride1, bool stream) {
  return 4 * (rows * (stride0 + stride1) + kStages * stage_floats(rows, stream));
}

template <int MT, bool kStream>
int launch(const float* x, float* out, int B, int groups, const Net& net, cudaStream_t stream,
           int* attr_err) {
  constexpr int TM = 16 * MT;
  const int smem_bytes = smem_bytes_for(TM, net.stride0, net.stride1, kStream);
  *attr_err = static_cast<int>(cudaFuncSetAttribute(
      fused_mlp_kernel<MT, kStream>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes));
  if (*attr_err != 0) return 0;
  const unsigned int blocks = static_cast<unsigned int>((static_cast<long long>(B) + TM - 1) / TM);
  const dim3 grid(blocks, static_cast<unsigned int>(groups));
  fused_mlp_kernel<MT, kStream><<<grid, kThreads, smem_bytes, stream>>>(x, out, B, net);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) over `groups` weight sets
// (1 for the ordinary launch), with layer 0's input streamed through the ring
// if `stream_input` is 1 and held in buf0 if 0. `dims` holds n_layers + 1
// widths, `ws` and `bs` n_layers device pointers each, `w_set` and `b_set`
// n_layers set strides each (host arrays); `x_set` and `out_set` are the set strides of x and out.
// All strides count floats. Returns cudaGetLastError() of the launch and
// writes the code of the shared-memory attribute call to *attr_err; -1 for
// arguments the kernel does not take.
extern "C" int fused_mlp_forward(const float* x, float* out, int B, int n_layers,
                                 const int* dims, const void* const* ws,
                                 const void* const* bs, int act, int rows_per_block,
                                 int stride0, int stride1, int groups, long long x_set,
                                 long long out_set, const long long* w_set,
                                 const long long* b_set, int stream_input, void* stream,
                                 int* attr_err) {
  *attr_err = 0;
  if (n_layers < 1 || n_layers > kMaxLayers || act < kIdentity || act > kTanh) return -1;
  if (stream_input != 0 && stream_input != 1) return -1;
  if (groups < 1 || groups > kMaxGroups) return -1;
  if (B <= 0) return 0;
  Net net = {};
  for (int l = 0; l < n_layers; ++l) {
    net.w[l] = static_cast<const float*>(ws[l]);
    net.b[l] = static_cast<const float*>(bs[l]);
    net.w_set[l] = w_set[l];
    net.b_set[l] = b_set[l];
  }
  net.x_set = x_set;
  net.out_set = out_set;
  for (int l = 0; l <= n_layers; ++l) net.dims[l] = dims[l];
  net.n_layers = n_layers;
  net.act = act;
  net.stride0 = stride0;
  net.stride1 = stride1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows_per_block * 2 + stream_input) {
    case 64:
      return launch<2, false>(x, out, B, groups, net, s, attr_err);
    case 65:
      return launch<2, true>(x, out, B, groups, net, s, attr_err);
    case 32:
      return launch<1, false>(x, out, B, groups, net, s, attr_err);
    case 33:
      return launch<1, true>(x, out, B, groups, net, s, attr_err);
    default:
      return -1;
  }
}
