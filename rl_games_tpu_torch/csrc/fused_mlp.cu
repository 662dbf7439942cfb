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
// the kernel's time) seldom run under the other's products. A held launch
// over many rows whose widths are at most 256 (the flagship torso's rollout
// and minibatches, the 3D configs', the deep torso's) is therefore a launch
// of the wgmma kernel further down (`fused_mlp_wgmma_kernel`, with its own
// notes: warpgroup products, weights by bulk copies shared over a cluster);
// this kernel keeps the held launches between the cluster kernel's rows and
// the wgmma kernel's (ops/fused_mlp.py wgmma_plan), the grouped ones and
// wider chains.
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
//   This is the route of many rows; a held chain over few rows (one block
//   would walk every weight through one SM) runs as the cluster kernel
//   further down (`fused_mlp_cluster_kernel`, with its own notes), whose
//   blocks split each layer's outputs and exchange the activations.
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
//   Each block streams its set's weights once. That is the route of sets
//   of many rows; a grouped launch at few rows a set (the self-play
//   opponents: one row a set), where a 16-row tile would run with 15 rows
//   idle, is a launch of the sets kernel further down
//   (`fused_mlp_sets_kernel`, with its own notes; ops/fused_mlp.py
//   sets_plan).
// - A chain too deep for the argument block, or with an inner width that no
//   buffer holds, is cut into several launches by the wrapper
//   (ops/fused_mlp.py launch_plan); the widths between them go through
//   device memory. A layer whose input no buffer holds (the 3136 inputs
//   behind the nature-CNN need 200 KB at 16 rows) is a launch of its own, of
//   the streamed kernel further down (`fused_mlp_stream_kernel`, with its own
//   notes), which holds nothing and streams x beside W. A launch that one
//   held block takes, over fewer rows than ops/fused_mlp.py's crossover
//   (cluster_plan), is a launch of the cluster kernel instead; one over
//   at least WGMMA_MIN_ROWS rows of widths of at most 256 (wgmma_plan) a
//   launch of the wgmma kernel.
// - Inputs must be finite: the split of an infinity is not a number.

#include <cuda.h>  // CUtensorMap and its enums: the streamed kernel's bulk tensor copies
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kMaxLayers = 8;
constexpr int TN = 128;      // output columns per weight tile
constexpr int TK = 32;       // inputs per weight tile
constexpr int WS = TK + 8;   // weight tile row stride: 40 = 8 * odd
constexpr int kStages = 3;   // weight tiles in the ring
constexpr int kTileFloats = TN * WS;
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
  int stride0;  // row stride (floats, 8 * odd) of the even-width buffer
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
// of the block's tile and 16 of the weight tile's 128 columns.
template <int MT>
__global__ void __launch_bounds__(kThreads, 2)
fused_mlp_kernel(const float* __restrict__ x, float* __restrict__ out, int B, Net net) {
  constexpr int TM = 16 * MT;
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

  // Everyone shares the first copies: the tile's rows of x and the ring's
  // first kStages - 1 tiles (x and the first tile make one group).
  TilePos ahead, pos;
  enter_layer(ahead, net, 0);
  enter_layer(pos, net, 0);
  {
    const float* x_tile = x + row0 * net.dims[0];
    const int rows_inside = static_cast<int>(min(static_cast<long long>(TM), B - row0));
    for (int c0 = 0; c0 < net.dims[0]; c0 += TK)
      stage_tile<kThreads>(buf0 + c0, net.stride0, x_tile, rows_inside, net.dims[0], c0, TM, tid);
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    stage_w_tile<kThreads>(ring + s * kTileFloats, net, ahead, tid);
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
      stage_w_tile<32>(ring + ((it + kStages - 1) % kStages) * kTileFloats, net, ahead, lane);
      cp_async_commit();
      advance(ahead, net);
      advance(pos, net);
    }
    return;
  }

  cp_async_wait<0>();  // this thread's share of the first copies
  float big[MT][NT][4], small[MT][NT][4];
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
    const float* in = (l & 1) ? buf1 : buf0;
    const int s_in = (l & 1) ? net.stride1 : net.stride0;
    const float* ws = ring + (it % kStages) * kTileFloats;
    // this warp's 8-wide tiles of outputs that hold columns of the layer
    const int active = min(NT, max(0, Np - n0 - col_base) / 8);

    if (pos.kc == 0) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) big[i][j][e] = small[i][j][e] = 0.0f;
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
      const float* a = in + g * s_in + k0 + 2 * t;
      const float* w = ws + (col_base + g) * WS + 2 * t;
      if (ksteps == TK / 8 && active == NT) {
#pragma unroll
        for (int ks = 0; ks < TK / 8; ++ks)
          product_step<MT, true>(big, small, a + 8 * ks, s_in, w + 8 * ks, NT);
      } else {
        for (int ks = 0; ks < ksteps; ++ks)
          product_step<MT, false>(big, small, a + 8 * ks, s_in, w + 8 * ks, active);
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
// ring of weight tiles, in bytes (ops/fused_mlp.py kernel_plan computes the
// same).
int smem_bytes_for(int rows, int stride0, int stride1) {
  return 4 * (rows * (stride0 + stride1) + kStages * kTileFloats);
}

template <int MT>
int launch(const float* x, float* out, int B, int groups, const Net& net, cudaStream_t stream,
           int* attr_err) {
  constexpr int TM = 16 * MT;
  const int smem_bytes = smem_bytes_for(TM, net.stride0, net.stride1);
  *attr_err = static_cast<int>(cudaFuncSetAttribute(
      fused_mlp_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes));
  if (*attr_err != 0) return 0;
  const unsigned int blocks = static_cast<unsigned int>((static_cast<long long>(B) + TM - 1) / TM);
  const dim3 grid(blocks, static_cast<unsigned int>(groups));
  fused_mlp_kernel<MT><<<grid, kThreads, smem_bytes, stream>>>(x, out, B, net);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// The streamed launch: one layer, out = act(x . W^T + b), whose input x
// [B, K] no buffer of a block holds, so it streams through shared memory
// beside W [N, K] (the nature-CNN torso's 3136 -> 512 at the Pong rollout's
// B = 512 and the minibatch's 4096).
//
// What bounds it on this card: the 3xTF32 products. `mma.sync` does not
// reach the TF32 rate of the warpgroup instruction (the 64-row block makes
// three products a multiply-add at a third of that rate), and measured over
// every shape the kernel takes (tools/fused_mlp_ab.py --sweep), its time
// follows the products a block makes and not the bytes a stage brings: the
// launch ends when its last wave of blocks is done with its products.
// What the design does about it:
// - Enough blocks, in one wave. The `split` blocks that share a row tile
//   split its 128-wide output tiles (block n takes tiles n, n + split, ...),
//   so a small batch still fills the card: at B = 512, 32 row tiles of 16
//   rows by a split of 4 make 128 blocks, one an SM. A block holds the whole
//   227 KB, so one runs an SM: 132 at once in clusters of one or two, 120 in
//   clusters of four or eight. The wrapper (ops/fused_mlp.py stream_plan)
//   picks rows a block (16, 32 or 64), the split and the cluster from a model
//   of these measured rates: waves times output tiles a block times rows
//   over the products' rate at those rows (a 64-row block splits each operand
//   for more products than a 16-row one). At B = 4096 it takes 64-row blocks
//   split in two: W is read from L2 once per 64 rows.
// - Clusters that multicast x. The blocks of a cluster share a row tile;
//   the first issues a stage's x tile to all of them in one multicast copy.
// - Bulk tensor copies (the TMA). One thread of a copying warpgroup issues a
//   stage as two `cp.async.bulk.tensor` copies (W's 128 x 32 tile, x's
//   rows x 32 tile), which signal a transaction barrier (`mbarrier`) of the
//   stage when they land; out-of-range rows and columns land as zeros. A
//   ring of 9 to 12 stages (as many as 227 KB hold) runs ahead, and no
//   `__syncthreads()` is left in the loop: a multiplying warp waits for its
//   stage's full barrier and, done with the stage, arrives on the stage's
//   empty barrier in every block of the cluster (remote arrives through
//   distributed shared memory), so a copy that lands in several blocks waits
//   until all of them are done with the slot.
// - The copies swizzle (128-byte mode: the 16-byte chunk c of row r lands at
//   chunk c ^ (r % 8)). A lane reads fragment row g from tile row
//   p(g) = 2 (g % 4) + g / 4, and takes weight row p(g) as its column g, so
//   the 16 lanes of half a warp read 8-byte pairs from 8 different chunks
//   of rows whose r % 8 differ in the chunk's upper bits: no bank conflict.
//   The sums' rows and columns come out in the same order, which the
//   epilogue undoes (a lane's two columns are 2 apart).
// - Rows that a bulk copy cannot take (a row stride, set stride or address
//   that is not a multiple of 16 bytes: 3134 and 3135 inputs) take the
//   kernel's own `cp.async` copies (16, 8 or 4 bytes wide, as the rows'
//   alignment allows) into the same swizzled tiles, shared out among the
//   copying warpgroup's 128 threads, each of which then arrives on the
//   stage's full barrier when its copies land (`cp.async.mbarrier.arrive`).
//   The wrapper picks the mode of x and of W apart, from their strides and
//   addresses; such a tensor is not multicast: each block copies its own.
// - Registers. The block is 12 warps (8 multiplying, a copying warpgroup of
//   4), which start at 168 registers a thread; the 64-row block's three sets
//   of sums need more, so there the copying warpgroup hands registers to the
//   multiplying ones (`setmaxnreg`: 56 and 224), one branch a role to the
//   end, as the instruction wants it.
// - The numeric scheme is the held kernel's, with the per-tile sum that a
//   long input needs: the tensor core's adder truncates towards zero, always
//   the same way, so over the 392 instructions of 3136 inputs the bias of
//   one running sum reaches the tolerance (the CPU rehearsal in
//   tests/test_torch_port_fused_mlp.py puts it at 12 times the tolerance at
//   inputs of 30). Each tile's 32 inputs start from zero and are added into
//   a float32 total with a rounding add. No sum is split across blocks, so
//   two calls on the same inputs give the same bits.
// - A block's copying warp exits only after every block of its cluster has
//   released the ring's last stages: then nothing can still copy into its
//   shared memory or arrive on its barriers. A wait that never ends (a fault
//   of the schedule) traps after 2^24 tries instead of hanging the card.
// ---------------------------------------------------------------------------

constexpr int kMaxCluster = 8;       // blocks a cluster (the portable limit)
constexpr int kSwizzleAlign = 1024;  // the 128-byte swizzle repeats every 8 rows of 128 bytes
constexpr int kWaitTries = 1 << 24;  // try_waits before a wait traps
constexpr int kCopyWarps = 4;        // the copying warpgroup
constexpr int kCopiers = 32 * kCopyWarps;
constexpr int kStreamThreads = 32 * kWarps + kCopiers;
// Registers a thread of the copying and of a multiplying warpgroup where
// the 64-row block moves them between the two (setmaxnreg): 384 threads
// start at 168; 128 x (168 - 56) = 256 x (224 - 168).
constexpr int kEntryRegisters = 168;
constexpr int kCopyRegisters = 56;
constexpr int kMultiplyRegisters = 224;

// Rows a block: its warps' layout (wm x wn warps over rows x outputs), the
// ring's depth (as many stages as fit 227 KB with the alignment slack), and
// whether the copying warpgroup hands registers to the multiplying ones (the
// 64-row block's three sets of sums need more than 168 a thread).
template <int TM>
struct StreamShape {
  static constexpr int WM = TM == 16 ? 1 : 2;      // warps along the rows
  static constexpr int WN = kWarps / WM;           // warps along a tile's 128 outputs
  static constexpr int MT = TM / 16 / WM;          // 16-row instruction tiles a warp
  static constexpr int SNT = TN / 8 / WN;          // 8-wide instruction tiles a warp
  static constexpr int kStageFloats = (TN + TM) * TK;  // W's tile, then x's
  static constexpr int kRingStages = TM == 16 ? 12 : TM == 32 ? 11 : 9;
  static constexpr int kSmemBytes = kSwizzleAlign + kRingStages * (4 * kStageFloats + 16);
  static constexpr bool kRebalance = TM == 64;
};

struct StreamLayer {
  const float* x;
  const float* w;
  const float* b;
  float* out;
  long long x_set, w_set, b_set, out_set;  // set strides in floats (0: shared)
  int B, K, N;
  int act;
  int split;  // blocks a row tile's output tiles are split over: block n takes tiles n, n + split, ...
  int tiles;  // output tiles of 128 a block walks: N / 128 (rounded up) / split
  int copy;   // bit 0: x through bulk tensor copies, bit 1: W (else the kernel's cp.async)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\tbarrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// Waits until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (int tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\tmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == kWaitTries) __trap();
  }
}

// Arrives on `bar`, telling it that `bytes` more are to land in this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// Arrives on the barrier at `bar`'s place in the shared memory of the
// cluster's block `rank` (this block's own for its own rank).
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar, uint32_t rank) {
  asm volatile(
      "{\n\t.reg .b32 remote;\n\tmapa.shared::cluster.u32 remote, %0, %1;\n\t"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n\t}" ::"r"(smem_u32(bar)),
      "r"(rank)
      : "memory");
}

// This thread's arrival on `bar` once all its earlier cp.async have landed
// (counted among the barrier's expected arrivals).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// A bulk tensor copy of the box at (c0, c1, c2) of `map` into `dst`, to the
// blocks of `mask` (at `dst`'s and `bar`'s places in each) or, with mask 0,
// to this block alone; it signals the bytes to `bar`.
__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                         int c2, uint16_t mask) {
  const uint64_t m = reinterpret_cast<uint64_t>(map);
  if (mask == 0)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
        "[%2];" ::"r"(smem_u32(dst)),
        "l"(m), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
        "[%0], [%1, {%3, %4, %5}], [%2], %6;" ::"r"(smem_u32(dst)),
        "l"(m), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "h"(mask)
        : "memory");
}

// The kernel's own copies of a rows x 32 tile of a row-major [*, K] matrix
// (`src`: its first row at input k0) into a swizzled tile, by the copying
// warpgroup's 128 threads, kFloats (4, 2 or 1) floats a copy; rows from
// rows_inside on and inputs from K on land as zeros. kLean: one copy an
// iteration, not unrolled (the 64-row block's copying warpgroup has 56
// registers a thread; unrolled, its loops spill).
template <int kFloats, bool kLean>
__device__ __forceinline__ void copy_tile_by(float* dst, const float* __restrict__ src, int rows,
                                             int rows_inside, int K, int k0, int tid) {
  constexpr int kPerRow = TK / kFloats;
  auto copy = [&](int idx) {
    const int r = idx / kPerRow;
    const int c = (idx % kPerRow) * kFloats;
    const bool inside = r < rows_inside && k0 + c < K;
    float* to = dst + r * TK + ((((c >> 2) ^ (r & 7)) << 2) | (c & 3));
    cp_async<kFloats>(to, inside ? src + static_cast<size_t>(r) * K + k0 + c : src, inside);
  };
  if constexpr (kLean) {
#pragma unroll 1
    for (int idx = tid; idx < rows * kPerRow; idx += kCopiers) copy(idx);
  } else {
    for (int idx = tid; idx < rows * kPerRow; idx += kCopiers) copy(idx);
  }
}

template <bool kLean>
__device__ __forceinline__ void copy_tile(float* dst, const float* __restrict__ src, int rows,
                                          int rows_inside, int K, int k0, int tid) {
  const uintptr_t address = reinterpret_cast<uintptr_t>(src);
  if ((K & 3) == 0 && (address & 15) == 0)
    copy_tile_by<4, kLean>(dst, src, rows, rows_inside, K, k0, tid);
  else if ((K & 1) == 0 && (address & 7) == 0)
    copy_tile_by<2, kLean>(dst, src, rows, rows_inside, K, k0, tid);
  else
    copy_tile_by<1, kLean>(dst, src, rows, rows_inside, K, k0, tid);
}

// The three products of 8 inputs (k-step `ks` of a stage) for a warp's
// MT x SNT instruction tiles, as product_step makes them, on swizzled tiles.
// `a` points at this lane's tile row p(g) of its first instruction tile of
// x, at the pair 2 (t % 2) of a chunk; `w` the same in W's tile; `lane_x` is
// p(g) ^ (t / 2), so the lane's inputs 8 ks + 2t, 8 ks + 2t + 1 lie in chunk
// (2 ks) ^ lane_x of each of its rows (all 8 rows apart). The B fragments
// are split once and kept across the rows; the A fragments of one 16-row
// instruction tile at a time (fewer live registers: the 64-row block's three
// sets of sums take 96), each tile's two products into `small` still SNT
// instructions apart.
template <int MT, int SNT>
__device__ __forceinline__ void stream_product_step(float (&big)[MT][SNT][4], float (&small)[MT][SNT][4],
                                                    const float* a, const float* w, int ks, int lane_x) {
  const int k = ((2 * ks) ^ lane_x) << 2;
  uint32_t b_hi[SNT][2], b_lo[SNT][2];
#pragma unroll
  for (int j = 0; j < SNT; ++j) {
    const float2 wv = *reinterpret_cast<const float2*>(w + 8 * j * TK + k);
    split_tf32(wv.x, b_hi[j][0], b_lo[j][0]);
    split_tf32(wv.y, b_hi[j][1], b_lo[j][1]);
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    uint32_t a_hi[4], a_lo[4];
    const float2 top = *reinterpret_cast<const float2*>(a + 16 * i * TK + k);
    const float2 bottom = *reinterpret_cast<const float2*>(a + (16 * i + 8) * TK + k);
    split_tf32(top.x, a_hi[0], a_lo[0]);
    split_tf32(bottom.x, a_hi[1], a_lo[1]);
    split_tf32(top.y, a_hi[2], a_lo[2]);
    split_tf32(bottom.y, a_hi[3], a_lo[3]);
#pragma unroll
    for (int j = 0; j < SNT; ++j) mma_tf32(small[i][j], a_lo, b_hi[j]);
#pragma unroll
    for (int j = 0; j < SNT; ++j) mma_tf32(big[i][j], a_hi, b_hi[j]);
#pragma unroll
    for (int j = 0; j < SNT; ++j) mma_tf32(small[i][j], a_hi, b_lo[j]);
  }
}

// Bias, activation and the store of a warp's sums of one output tile: row
// `row` (the lane's p(g) of its first instruction tile; + 8 and + 16 i
// beside) by columns `col` and `col` + 2 of each 8-wide tile j.
template <int kAct, int MT, int SNT>
__device__ __forceinline__ void stream_finish(const float (&big)[MT][SNT][4], const float (&small)[MT][SNT][4],
                                              const float* __restrict__ bias, float* __restrict__ out,
                                              long long row, int col, int B, int N) {
#pragma unroll
  for (int j = 0; j < SNT; ++j) {
    const int n = col + 8 * j;
    const float bias0 = n < N ? bias[n] : 0.0f, bias1 = n + 2 < N ? bias[n + 2] : 0.0f;
#pragma unroll
    for (int q = 0; q < 2 * MT; ++q) {
      const int i = q / 2, h = q % 2;
      const long long r = row + 8 * q;
      const float y0 = activate<kAct>(big[i][j][2 * h] + small[i][j][2 * h] + bias0);
      const float y1 = activate<kAct>(big[i][j][2 * h + 1] + small[i][j][2 * h + 1] + bias1);
      if (r < B) {
        if (n < N) out[r * N + n] = y0;
        if (n + 2 < N) out[r * N + n + 2] = y1;
      }
    }
  }
}

template <int TM>
__global__ void __launch_bounds__(kStreamThreads, 1)
fused_mlp_stream_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
                        const StreamLayer p, const int cluster) {
  using S = StreamShape<TM>;
  constexpr int MT = S::MT, SNT = S::SNT, kRing = S::kRingStages;
  extern __shared__ unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kSwizzleAlign - 1) & ~static_cast<uintptr_t>(kSwizzleAlign - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kRing * S::kStageFloats);
  uint64_t* empty = full + kRing;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // `split` consecutive blocks share a row tile, block `slice` of them taking
  // output tiles slice, slice + split, ...; a cluster is `cluster` of them
  const int slice = blockIdx.x % p.split;
  const int rank = static_cast<int>(cluster_rank());
  const int set = blockIdx.y;
  const long long row0 = static_cast<long long>(blockIdx.x / p.split) * TM;
  const int rows_inside = static_cast<int>(min(static_cast<long long>(TM), p.B - row0));
  const bool x_tma = p.copy & 1, w_tma = p.copy & 2;
  const int nK = (p.K + TK - 1) / TK;
  const int steps = p.tiles * nK;

  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) {
      // the expect_tx arrival, and each copying thread's when it copies itself
      mbar_init(&full[s], 1 + (x_tma && w_tma ? 0 : kCopiers));
      mbar_init(&empty[s], kWarps * cluster);  // every multiplying warp of the cluster
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();

  // One branch a role to the end, as setmaxnreg wants it.
  if (warp >= kWarps) {
    // The copying warpgroup. Thread 0 of it arms each stage's full barrier
    // with the bytes that bulk copies bring and issues them: W's tile for
    // this block, and x's tile for every block of the cluster if this is the
    // cluster's first. A tensor that bulk copies cannot take the 128 threads
    // copy themselves; else the other three warps have nothing to do.
    if constexpr (S::kRebalance) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kCopyRegisters));
    const int ctid = tid - 32 * kWarps;
    if (x_tma && w_tma && warp != kWarps) return;
    const float* x_rows = p.x + set * p.x_set + row0 * p.K;
    const uint16_t x_mask = cluster == 1 ? 0 : static_cast<uint16_t>((1u << cluster) - 1);
    const uint32_t tx_bytes = (w_tma ? 4 * TN * TK : 0) + (x_tma ? 4 * TM * TK : 0);
    int s = 0;
    uint32_t round = 0;
    for (int tile = 0; tile < p.tiles; ++tile) {
      const int n0 = (slice + tile * p.split) * TN;
      const float* w_rows = p.w + set * p.w_set + static_cast<long long>(n0) * p.K;
      for (int kc = 0; kc < nK; ++kc) {
        const int k0 = kc * TK;
        if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);  // every block is done with the slot
        float* ws = ring + s * S::kStageFloats;
        float* xs = ws + TN * TK;
        if (ctid == 0) {
          mbar_arrive_expect_tx(&full[s], tx_bytes);
          if (w_tma) tma_load(ws, &w_map, &full[s], k0, n0, p.w_set ? set : 0, 0);
          if (x_tma && rank == 0)
            tma_load(xs, &x_map, &full[s], k0, static_cast<int>(row0), p.x_set ? set : 0, x_mask);
        }
        if (!w_tma) copy_tile<S::kRebalance>(ws, w_rows, TN, min(TN, p.N - n0), p.K, k0, ctid);
        if (!x_tma) copy_tile<S::kRebalance>(xs, x_rows, TM, rows_inside, p.K, k0, ctid);
        if (!(x_tma && w_tma)) cp_async_arrive(&full[s]);
        if (++s == kRing) {
          s = 0;
          ++round;
        }
      }
    }
    if (warp == kWarps) {
      // The tail: the last stage of every slot released by every warp of the
      // cluster. Then no block of the cluster can still copy into this
      // block's shared memory or arrive on its barriers, and it may exit.
      for (int i = max(0, steps - kRing); i < steps; ++i) mbar_wait(&empty[i % kRing], (i / kRing) & 1);
    }
  } else {
    if constexpr (S::kRebalance) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kMultiplyRegisters));
    // A multiplying warp: rows wm * 16 MT .. of the block's tile by outputs
    // wn * 8 SNT .. of each output tile.
    const int wm = warp / S::WN, wn = warp % S::WN;
    const int g = lane >> 2, t = lane & 3;
    const int pg = ((g & 3) << 1) | (g >> 2);  // the tile row of fragment row g, the W row of column g
    const int lane_x = pg ^ (t >> 1);
    const int a_off = (wm * 16 * MT + pg) * TK + 2 * (t & 1);
    const int w_off = (wn * 8 * SNT + pg) * TK + 2 * (t & 1);
    // the lane's sums: rows p(g) (+ 8), columns p(2t) and p(2t + 1) = p(2t) + 2 of each 8-wide tile
    const int col_lane = wn * 8 * SNT + (((t & 1) << 2) | (t >> 1));
    const long long row_lane = row0 + wm * 16 * MT + pg;
    const float* __restrict__ bias = p.b + set * p.b_set;
    float* __restrict__ out = p.out + set * p.out_set;
    float big[MT][SNT][4], small[MT][SNT][4], total[MT][SNT][4];
    int s = 0;
    uint32_t round = 0;
    for (int tile = 0; tile < p.tiles; ++tile) {
      const int n0 = (slice + tile * p.split) * TN;
      // a warp whose columns all lie past N multiplies nothing
      const bool active = n0 + wn * 8 * SNT < p.N;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < SNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) big[i][j][e] = small[i][j][e] = total[i][j][e] = 0.0f;
      for (int kc = 0; kc < nK; ++kc) {
        mbar_wait(&full[s], round & 1);
        const float* ws = ring + s * S::kStageFloats;
        if (active) {
#pragma unroll
          for (int ks = 0; ks < TK / 8; ++ks)
            stream_product_step<MT, SNT>(big, small, ws + TN * TK + a_off, ws + w_off, ks, lane_x);
        }
        __syncwarp();
        if (lane < cluster) mbar_arrive_remote(&empty[s], lane);
        if (++s == kRing) {
          s = 0;
          ++round;
        }
        // the tile's sums go into the total with a rounding add, and the next
        // tile's start from zero; after the last tile big holds the total
        const bool last = kc == nK - 1;
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < SNT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (last) {
                big[i][j][e] += total[i][j][e];
              } else {
                total[i][j][e] += big[i][j][e];
                big[i][j][e] = 0.0f;
              }
            }
      }
      if (active) {
        switch (p.act) {
#define FUSED_MLP_STREAM_FINISH(kAct)                                                         \
  case kAct:                                                                                  \
    stream_finish<kAct, MT, SNT>(big, small, bias, out, row_lane, n0 + col_lane, p.B, p.N); \
    break;
          FUSED_MLP_STREAM_FINISH(kIdentity)
          FUSED_MLP_STREAM_FINISH(kRelu)
          FUSED_MLP_STREAM_FINISH(kElu)
          FUSED_MLP_STREAM_FINISH(kSelu)
          FUSED_MLP_STREAM_FINISH(kSoftplus)
          FUSED_MLP_STREAM_FINISH(kGelu)
          FUSED_MLP_STREAM_FINISH(kSigmoid)
          FUSED_MLP_STREAM_FINISH(kSilu)
          FUSED_MLP_STREAM_FINISH(kTanh)
#undef FUSED_MLP_STREAM_FINISH
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link to
// the driver library); null where the driver has none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Whether bulk tensor copies take the rows of a [G, rows, K] float32 tensor
// at `base` with set stride `set_stride` floats: 16-byte aligned address,
// row stride and set stride.
bool bulk_copies_take(const void* base, int K, long long set_stride) {
  return (reinterpret_cast<uintptr_t>(base) & 15) == 0 && (K & 3) == 0 && (set_stride & 3) == 0;
}

// The tensor map of [sets, rows, K] float32 at `base` (set stride
// `set_stride` floats; 0: one set), boxes of box_rows x 32, swizzled
// 128 bytes, out-of-range elements read as zeros.
bool encode_rows(CUtensorMap* map, const float* base, int K, int rows, int sets, long long set_stride,
                 int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const long long set_bytes = 4 * (set_stride != 0 ? set_stride : static_cast<long long>(rows) * K);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(set_stride != 0 ? sets : 1)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(4LL * K), static_cast<cuuint64_t>(set_bytes)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(TK), static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The kernel's launch configuration over `blocks` x `groups` blocks in
// clusters of `cluster` along the grid's first axis.
template <int TM>
cudaLaunchConfig_t stream_config(long long blocks, int groups, int cluster, cudaStream_t stream,
                                 cudaLaunchAttribute* attribute) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned int>(blocks), static_cast<unsigned int>(groups));
  config.blockDim = dim3(kStreamThreads);
  config.dynamicSmemBytes = StreamShape<TM>::kSmemBytes;
  config.stream = stream;
  attribute->id = cudaLaunchAttributeClusterDimension;
  attribute->val.clusterDim.x = static_cast<unsigned int>(cluster);
  attribute->val.clusterDim.y = 1;
  attribute->val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  return config;
}

// Sets the kernel's shared memory; 0, a CUDA error, or -3 where the 64-row
// block's registers at entry are not the 168 that setmaxnreg's exchange
// counts on (an exchange that finds fewer would wait for ever).
template <int TM>
int prepare_stream() {
  const int err = static_cast<int>(cudaFuncSetAttribute(
      fused_mlp_stream_kernel<TM>, cudaFuncAttributeMaxDynamicSharedMemorySize, StreamShape<TM>::kSmemBytes));
  if (err != 0 || !StreamShape<TM>::kRebalance) return err;
  cudaFuncAttributes attributes;
  const int got = static_cast<int>(cudaFuncGetAttributes(&attributes, fused_mlp_stream_kernel<TM>));
  if (got != 0) return got;
  return attributes.numRegs == kEntryRegisters ? 0 : -3;
}

template <int TM>
int launch_stream(const CUtensorMap& x_map, const CUtensorMap& w_map, const StreamLayer& p, int groups,
                  int cluster, cudaStream_t stream, int* attr_err) {
  *attr_err = prepare_stream<TM>();
  if (*attr_err != 0) return 0;
  const long long blocks = (static_cast<long long>(p.B) + TM - 1) / TM * p.split;
  cudaLaunchAttribute attribute;
  const cudaLaunchConfig_t config = stream_config<TM>(blocks, groups, cluster, stream, &attribute);
  const cudaError_t err = cudaLaunchKernelEx(&config, fused_mlp_stream_kernel<TM>, x_map, w_map, p, cluster);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <int TM>
int stream_clusters(int cluster) {
  if (prepare_stream<TM>() != 0) return -1;
  cudaLaunchAttribute attribute;
  const cudaLaunchConfig_t config = stream_config<TM>(cluster * 1024, 1, cluster, nullptr, &attribute);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, fused_mlp_stream_kernel<TM>, &config) != cudaSuccess) return -1;
  return clusters;
}


// ---------------------------------------------------------------------------
// The cluster launch: a held chain at small batch (the rollout's 16 rows of
// a recurrent or test-env config, the host path's 64, an exported policy's
// one action), `fused_mlp_cluster_kernel`.
//
// It replaces no further TPU kernel: it is the route of `_fused_kernel`
// (rl_games_tpu/ops/fused_mlp.py:112) on this card where a held launch has
// few rows (ops/fused_mlp.py cluster_plan), and computes what the held
// kernel computes, bit for bit.
//
// What bounds it: latency. At 16 rows the held kernel is one block that
// walks every weight through its ring of three tiles: 16 -> 256 -> 128 -> 64
// is 14 tiles, each an L2 round trip behind a __syncthreads(), two in
// flight, so one SM pulls 180 KB at about 14 GB/s (13.26 us against 0.06 us
// of bytes). The least such a launch can take is the launch itself, one
// trip to L2 for the weights and, between layers, one exchange of the
// activations. Clock stamps inside the kernel (PERF.md §6, PR 20) put the
// rest in steady latencies, the same in a second pass through the layers
// in one launch: a copy's trip (about 1300 cycles for cp.async, 2900 for a
// small bulk copy), an exchange between blocks (about 1500-1900 cycles from
// the first push to the last peer's bytes), and a few hundred cycles each
// for a layer's products, its activation and a block barrier.
//
// What the design does about it:
// - A cluster of C blocks (1 to 16; 16 as a non-portable cluster size)
//   shares one tile of 16 rows; over more rows there is one cluster a row
//   tile. Block r owns a 1/C share of every layer's outputs in whole 8-wide
//   tiles: tiles r S .. r S + S - 1 with S = ceil(ceil(N / 8) / C), so C
//   SMs pull the chain's weights side by side, each its share once.
// - Every copy is issued at entry. x's tile and layer 0's share (and bias)
//   go first, by every thread with the kernel's own cp.async (16 bytes a
//   copy where rows are 16-byte aligned, else 4; zero-filled past the
//   matrix): layer 0 waits for them alone. Warp l then sets up layer l (its
//   record in a table in shared memory, its barriers) and, for l >= 1,
//   starts its share of W as one bulk copy (cp.async.bulk, completing on
//   the layer's mbarrier): a share's rows are contiguous in W ([N, K],
//   row-major), and where K is a multiple of 8 and W 16-byte aligned they
//   land as rows of K floats (the B fragments' 8-byte loads then meet 4-way
//   bank conflicts where K is a multiple of 32: a few cycles a step). The
//   bias share is one more bulk copy where its length allows, else cp.async.
//   Other shares take the kernel's cp.async into rows of 8 * odd floats,
//   the held kernel's conflict-free stride. The bulk copies' latency passes
//   under layer 0 and the first exchange.
// - Layer l: warp w multiplies the 16 rows by output tiles w, w + 8, ... of
//   the block's share with the held kernel's numeric scheme (split_tf32,
//   three mma.sync a step in product_step's order, the big and the small
//   accumulator, bias and activation as finish_layer adds them), each sum
//   over all of K in order: the result is the held kernel's bit for bit,
//   and two calls give the same bits. (Splitting K over the warps that a
//   narrow share leaves idle, through shared memory and a barrier; dealing
//   a warp's steps round four accumulator pairs; computing a narrow first
//   layer whole in every block to save an exchange: each was measured and
//   not faster, tools/fused_mlp_ab.py --sweep, PERF.md §6.) The activation
//   is a template argument: one layer end in the kernel's code.
// - The exchange: a warp writes its columns of h_{l+1} into this block's
//   next activation buffer; after a __syncthreads() all 256 threads push
//   the block's share to every other block of the cluster in 16-byte
//   st.async stores through distributed shared memory (mapa), each counted
//   on the receiver's mbarrier for that layer's input, which the receiver
//   armed at entry with the bytes its peers send. No cluster barrier
//   between layers: a block starts layer l + 1 when its own share is
//   written (the __syncthreads()) and its peers' bytes have landed. Two
//   buffers alternate, as in the held kernel, so a push never meets a read:
//   layer l + 1 writes the buffer that layer l - 1 wrote and layer l read,
//   and no block computes layer l + 1 (and pushes its output) before every
//   block has pushed its share of h_{l+1}, which each does only after it is
//   done with layer l. The last layer stores its columns of `out` straight
//   to device memory.
// - A block arrives on the cluster's barrier once its barriers are set up
//   and waits on it only before its first push, so that no store reaches a
//   peer whose barriers are not yet initialised; the wait passes under
//   layer 0. A block exits after the last layer's stores: every push into
//   it has landed before it computes its last layer, and no peer arrives on
//   its barriers after that. A wait for a copy that never ends traps
//   (kWaitTries).
// ---------------------------------------------------------------------------

constexpr int kClusterWarps = 8;  // warps a block: every one copies at entry, then multiplies
constexpr int kClusterThreads = 32 * kClusterWarps;
constexpr int kClusterRows = 16;  // rows a cluster: one 16-row instruction tile
constexpr int kMaxClusterBlocks = 16;
constexpr int kMaxSharedBytes = 232448;  // shared memory a block may use on sm_90

// A layer of a cluster launch, as the host lays it out.
struct ClusterLayerArgs {
  const float* w;  // W_l [N, K]
  const float* b;  // b_l [N]
  int K, N;
  int tiles;  // 8-wide output tiles a block owns (the last blocks may own fewer or none)
  int bulk;   // 1: a share of W is one bulk copy (K a multiple of 8, W 16-byte aligned), else the kernel's cp.async
  int ld;     // the row stride of a share in shared memory: K with bulk, else 8 * odd
  int w_off;  // offsets (floats) in shared memory of the block's share of W_l and of b_l
  int b_off;
};
static_assert(sizeof(ClusterLayerArgs) == 48, "ops/fused_mlp.py counts 48 bytes a record of the kernel's table");

struct ClusterNet {
  ClusterLayerArgs layer[kMaxLayers];
  int n_layers;
  int stride0;  // row stride (floats, 8 * odd) of the even-width buffer, as the held kernel's
  int stride1;  // same for the odd-width buffer
  int bar_off;  // the layers' barriers
};

__device__ __forceinline__ uint32_t cluster_blocks() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return n;
}

__device__ __forceinline__ uint32_t cluster_index() {
  uint32_t c;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(c));
  return c;
}

// The first output column of block `rank`'s share of a layer, and its
// 8-wide tiles.
__device__ __forceinline__ int share_n0(const ClusterLayerArgs& L, int rank) { return rank * L.tiles * 8; }

__device__ __forceinline__ int share_tiles(const ClusterLayerArgs& L, int rank) {
  return min(L.tiles, max(0, (L.N + 7) / 8 - rank * L.tiles));
}

// A bulk copy of `bytes` (a multiple of 16; both addresses 16-byte aligned)
// from device memory into this block's shared memory; the bytes count on
// `bar`'s transactions when they land.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// Stores v at `addr` (an address in this block's shared memory) in the
// shared memory of the cluster's block `rank`, asynchronously: its 16
// bytes count on the transactions of the barrier at `bar`'s place in that
// block when they land.
__device__ __forceinline__ void st_async_v4(uint32_t addr, uint32_t rank, uint32_t bar, float4 v) {
  asm volatile(
      "{\n\t.reg .b32 remote, remote_bar;\n\tmapa.shared::cluster.u32 remote, %0, %1;\n\t"
      "mapa.shared::cluster.u32 remote_bar, %2, %1;\n\t"
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [remote], {%3, %4, %5, %6}, [remote_bar];\n\t}" ::"r"(addr),
      "r"(rank), "r"(bar), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
      : "memory");
}

// The kernel's own copies of rows 0 .. rows-1 of a row-major [*, K] matrix
// (`src`: its first row) into rows of `ld` floats at `dst`, inputs 0 .. Kp-1
// (K rounded up to 8), by the block's threads in one flat loop: 16 bytes a
// copy where every row starts on a 16-byte boundary, else 4; rows from
// rows_inside on and inputs from K on land as zeros. (stage_tile's loop a
// 32 inputs at a time took a 512-wide layer's launch from 6.5 to 11.2 us:
// PERF.md §6, PR 20.)
__device__ __forceinline__ void copy_rows(float* dst, int ld, const float* __restrict__ src, int rows,
                                          int rows_inside, int K, int tid) {
  const int Kp = (K + 7) & ~7;
  if ((K & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int quads = Kp / 4;
    for (int i = tid; i < rows * quads; i += kClusterThreads) {
      const int r = i / quads, k = 4 * (i % quads);
      const bool inside = r < rows_inside && k < K;
      cp_async<4>(dst + r * ld + k, inside ? src + static_cast<size_t>(r) * K + k : src, inside);
    }
  } else {
    for (int i = tid; i < rows * Kp; i += kClusterThreads) {
      const int r = i / Kp, k = i % Kp;
      const bool inside = r < rows_inside && k < K;
      cp_async<1>(dst + r * ld + k, inside ? src + static_cast<size_t>(r) * K + k : src, inside);
    }
  }
}

// product_step for one 16-row instruction tile and one tile of 8 outputs:
// `a` at this lane's (row g, input 2t) of the activation tile, `w` at its
// (output g, input 2t) of the block's share of W. The same instructions on
// the same operands, in the same order for each sum.
__device__ __forceinline__ void cluster_product_step(float (&big)[4], float (&small)[4], const float* a, int s_in,
                                                     const float* w) {
  uint32_t a_hi[4], a_lo[4], b_hi[2], b_lo[2];
  const float2 top = *reinterpret_cast<const float2*>(a);
  const float2 bottom = *reinterpret_cast<const float2*>(a + 8 * s_in);
  split_tf32(top.x, a_hi[0], a_lo[0]);
  split_tf32(bottom.x, a_hi[1], a_lo[1]);
  split_tf32(top.y, a_hi[2], a_lo[2]);
  split_tf32(bottom.y, a_hi[3], a_lo[3]);
  const float2 wv = *reinterpret_cast<const float2*>(w);
  split_tf32(wv.x, b_hi[0], b_lo[0]);
  split_tf32(wv.y, b_hi[1], b_lo[1]);
  mma_tf32(small, a_lo, b_hi);
  mma_tf32(big, a_hi, b_hi);
  mma_tf32(small, a_hi, b_lo);
}

// kAct: the activation, one kernel each (a switch over them would put nine
// copies of the layer's end in one kernel's code).
template <int kAct>
__global__ void __launch_bounds__(kClusterThreads, 1)
fused_mlp_cluster_kernel(const float* __restrict__ x, float* __restrict__ out, int B,
                         const __grid_constant__ ClusterNet net) {
  extern __shared__ __align__(16) float smem[];
  // the layers' records, copied here once: a read of the argument block at a
  // layer index goes through the constant cache, a few hundred cycles a miss
  __shared__ ClusterLayerArgs table[kMaxLayers];
  float* buf0 = smem;
  float* buf1 = buf0 + kClusterRows * net.stride0;
  // wbar[l]: layer l's bulk copies; xbar[l]: the other blocks' shares of layer l's input (l >= 1)
  uint64_t* wbar = reinterpret_cast<uint64_t*>(smem + net.bar_off);
  uint64_t* xbar = wbar + kMaxLayers;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int rank = static_cast<int>(cluster_rank()), blocks = static_cast<int>(cluster_blocks());
  const long long row0 = static_cast<long long>(cluster_index()) * kClusterRows;
  const int rows_inside = static_cast<int>(min(static_cast<long long>(kClusterRows), B - row0));
  const int n_layers = net.n_layers;

  // First x's tile and layer 0's share of W and b, by every thread with the
  // kernel's own cp.async: layer 0 waits for nothing else, and a small copy
  // lands sooner this way than through the bulk-copy unit.
  {
    const ClusterLayerArgs& L = net.layer[0];
    const int n0 = share_n0(L, rank), fill = 8 * share_tiles(L, rank);
    const int w_rows = min(max(L.N - n0, 0), fill);
    copy_rows(buf0, net.stride0, x + row0 * L.K, kClusterRows, rows_inside, L.K, tid);
    if (fill > 0) {
      copy_rows(smem + L.w_off, L.ld, L.w + static_cast<size_t>(n0) * L.K, fill, w_rows, L.K, tid);
      for (int i = tid; i < fill; i += kClusterThreads)
        cp_async<1>(smem + L.b_off + i, L.b + n0 + min(i, w_rows - 1), i < w_rows);
    }
  }
  if (warp < n_layers) {
    // Warp l sets up layer l: its record in the table and its barriers, one
    // arrival each. wbar[l] is armed with the bytes of layer l's bulk copies
    // (none for layer 0 and where the kernel copies a share itself), xbar[l]
    // with the bytes that the other blocks push (16 rows of the input's
    // 8-wide tiles that this block does not compute in layer l - 1).
    const int l = warp;
    const ClusterLayerArgs L = net.layer[l];
    const int n0 = share_n0(L, rank), fill = 8 * share_tiles(L, rank);
    const int w_rows = min(max(L.N - n0, 0), fill);  // rows of W in the share; rows w_rows .. fill-1 are zero
    float* ws = smem + L.w_off;
    float* bias = smem + L.b_off;
    const bool bulk_w = l > 0 && L.bulk && w_rows > 0;
    const bool bulk_b = bulk_w && (w_rows & 3) == 0 && (reinterpret_cast<uintptr_t>(L.b) & 15) == 0;
    if (lane == 0) {
      table[l] = L;
      mbar_init(&wbar[l], 1);
      mbar_init(&xbar[l], 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      if (l > 0) {
        const ClusterLayerArgs& before = net.layer[l - 1];
        mbar_arrive_expect_tx(&xbar[l], 4u * kClusterRows * 8 * ((before.N + 7) / 8 - share_tiles(before, rank)));
      }
      const uint32_t w_bytes = bulk_w ? 4u * L.K * w_rows : 0u, b_bytes = bulk_b ? 4u * w_rows : 0u;
      mbar_arrive_expect_tx(&wbar[l], w_bytes + b_bytes);
      if (w_bytes) bulk_copy(ws, L.w + static_cast<size_t>(n0) * L.K, w_bytes, &wbar[l]);
      if (b_bytes) bulk_copy(bias, L.b + n0, b_bytes, &wbar[l]);
    }
    if (l > 0) {
      if (bulk_w)  // the rows no copy brings: w_rows .. fill-1, K floats each (K is a multiple of 8: float4 stores)
        for (int i = lane; i < (fill - w_rows) * L.K / 4; i += 32)
          *reinterpret_cast<float4*>(ws + w_rows * L.K + 4 * i) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (bulk_b)
        for (int i = w_rows + lane; i < fill; i += 32) bias[i] = 0.0f;
      else
        for (int i = lane; i < fill; i += 32) cp_async<1>(bias + i, L.b + n0 + min(i, w_rows - 1), i < w_rows);
    }
  }
  __syncthreads();  // the table
  // The shares of W after layer 0 that a bulk copy does not take, by every thread.
  for (int l = 1; l < n_layers; ++l) {
    const ClusterLayerArgs& L = table[l];
    if (L.bulk) continue;
    const int n0 = share_n0(L, rank), fill = 8 * share_tiles(L, rank);
    if (fill > 0) copy_rows(smem + L.w_off, L.ld, L.w + static_cast<size_t>(n0) * L.K, fill, min(L.N - n0, fill), L.K, tid);
  }
  cp_async_wait<0>();
  __syncthreads();  // every thread's copies and zero fills, and the barriers, are seen by the block
  // this block's barriers are set up: peers may push into it once they have waited
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  bool joined = false;  // whether this block has waited for every block's arrival

  for (int l = 0; l < n_layers; ++l) {
    const ClusterLayerArgs& L = table[l];
    const bool last = l == n_layers - 1;
    const float* in = (l & 1) ? buf1 : buf0;
    const int s_in = (l & 1) ? net.stride1 : net.stride0;
    float* next = (l & 1) ? buf0 : buf1;
    const int s_out = (l & 1) ? net.stride0 : net.stride1;
    const float* ws = smem + L.w_off;
    const float* bias = smem + L.b_off;
    const int n0 = share_n0(L, rank), mine = share_tiles(L, rank);
    const int steps = (L.K + 7) / 8;
    mbar_wait(&wbar[l], 0);
    if (l > 0) mbar_wait(&xbar[l], 0);  // the other blocks' shares of h_l
    // warp w takes the share's output tiles w, w + 8, ..., each over all of K
    for (int tile = warp; tile < mine; tile += kClusterWarps) {
      const int col = tile * 8 + 2 * t;  // the lane's first column in the share
      const float bias0 = bias[col], bias1 = bias[col + 1];
      float big[4] = {0.0f, 0.0f, 0.0f, 0.0f}, small[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const float* a = in + g * s_in + 2 * t;
      const float* w = ws + (tile * 8 + g) * L.ld + 2 * t;
#pragma unroll 4
      for (int ks = 0; ks < steps; ++ks) cluster_product_step(big, small, a + 8 * ks, s_in, w + 8 * ks);
      // bias and activation as finish_layer adds them; to this block's next
      // buffer (columns N .. Np-1 are the next layer's zero-filled inputs)
      // or, after the last layer, to out
      const int n = n0 + col;
      const bool in0 = n < L.N, in1 = n + 1 < L.N;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float y0 = activate<kAct>(big[2 * h] + small[2 * h] + bias0);
        const float y1 = activate<kAct>(big[2 * h + 1] + small[2 * h + 1] + bias1);
        const long long row = row0 + g + 8 * h;
        if (last) {
          if (row < B) {
            if (in0) out[row * L.N + n] = y0;
            if (in1) out[row * L.N + n + 1] = y1;
          }
        } else {
          *reinterpret_cast<float2*>(next + (g + 8 * h) * s_out + n) = make_float2(in0 ? y0 : 0.0f, in1 ? y1 : 0.0f);
        }
      }
    }
    if (last) break;
    // This block's share of h_{l+1} is complete and seen by the block; every
    // thread then pushes a part of it (16-byte units of its 16 rows by 8 mine
    // columns) into the other blocks' next buffer, each store counted on the
    // receiver's xbar[l + 1].
    __syncthreads();
    if (!joined) {
      asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");  // every block's barriers are set up
      joined = true;
    }
    const int quads = 2 * mine, units = kClusterRows * quads;
    const uint32_t bar = smem_u32(&xbar[l + 1]);
    for (int i = tid; i < units * (blocks - 1); i += kClusterThreads) {
      const int peer = i / units, u = i % units;
      float* at = next + (u / quads) * s_out + n0 + 4 * (u % quads);
      st_async_v4(smem_u32(at), peer < rank ? peer : peer + 1, bar, *reinterpret_cast<const float4*>(at));
    }
  }
  if (!joined) asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");  // the entry's arrival's wait
}

// An empty kernel of the cluster kernel's block, launched at its grid,
// cluster and shared memory: the floor under a cluster launch's time.
__global__ void __launch_bounds__(kClusterThreads, 1) fused_mlp_cluster_empty_kernel() {}

// The cluster kernel's dynamic shared memory, in bytes, for the chain in
// `net` (its layers' K, N, w, b and n_layers, stride0, stride1 set) over
// clusters of `cluster` blocks; fills each layer's share, stride and offsets
// (ops/fused_mlp.py cluster_shared_bytes computes the same). Every offset
// is a multiple of 8 floats: rows of 16-byte copies and bulk copies, and
// 8-byte barriers.
int cluster_layout(ClusterNet& net, int cluster) {
  int off = kClusterRows * (net.stride0 + net.stride1);
  for (int l = 0; l < net.n_layers; ++l) {
    ClusterLayerArgs& L = net.layer[l];
    const int eights = (L.K + 7) / 8;
    const int padded = 8 * (eights % 2 ? eights : eights + 1);
    L.tiles = ((L.N + 7) / 8 + cluster - 1) / cluster;
    // W's rows go by bulk copies where each share is one contiguous, 16-byte aligned run of rows of 8 k floats
    L.bulk = (L.K & 7) == 0 && (reinterpret_cast<uintptr_t>(L.w) & 15) == 0;
    L.ld = L.bulk ? L.K : padded;
    L.w_off = off;
    off += 8 * L.tiles * padded;
    L.b_off = off;
    off += 8 * L.tiles;
  }
  net.bar_off = off;
  off += 2 * 2 * kMaxLayers;  // wbar and xbar, 8 bytes each
  return 4 * off;
}

cudaLaunchConfig_t cluster_config(int B, int cluster, int smem_bytes, cudaStream_t stream,
                                  cudaLaunchAttribute* attribute) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned int>((static_cast<long long>(B) + kClusterRows - 1) / kClusterRows * cluster));
  config.blockDim = dim3(kClusterThreads);
  config.dynamicSmemBytes = smem_bytes;
  config.stream = stream;
  attribute->id = cudaLaunchAttributeClusterDimension;
  attribute->val.clusterDim.x = static_cast<unsigned int>(cluster);
  attribute->val.clusterDim.y = 1;
  attribute->val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  return config;
}

// Sets a kernel's shared memory and, past the portable 8, its non-portable
// cluster size; 0 or the CUDA error.
template <typename Kernel>
int prepare_cluster(Kernel kernel, int cluster, int smem_bytes) {
  int err = static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes));
  if (err == 0 && cluster > kMaxCluster)
    err = static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  return err;
}

template <int kAct>
int launch_cluster(const float* x, float* out, int B, const ClusterNet& net, int cluster, int smem_bytes,
                   cudaStream_t stream, int* attr_err) {
  *attr_err = prepare_cluster(fused_mlp_cluster_kernel<kAct>, cluster, smem_bytes);
  if (*attr_err != 0) return 0;
  cudaLaunchAttribute attribute;
  const cudaLaunchConfig_t config = cluster_config(B, cluster, smem_bytes, stream, &attribute);
  const cudaError_t err = cudaLaunchKernelEx(&config, fused_mlp_cluster_kernel<kAct>, x, out, B, net);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}


// ---------------------------------------------------------------------------
// The sets launch: a grouped launch over G weight sets at few rows a set
// (the self-play opponents: the policy's chain 6 -> 128 -> 64 elu over each
// env's own slot of weights, one row a set), `fused_mlp_sets_kernel`.
//
// It replaces no further TPU kernel: it is the route of `_fused_kernel`
// (rl_games_tpu/ops/fused_mlp.py:112) under jax.vmap over stacked weights
// (rl_games_tpu/envs/jax/selfplay.py:148-162) on this card where a set has
// few rows (ops/fused_mlp.py sets_plan).
//
// What bounds it: bytes. Each set's weights are read once and used for a
// handful of rows: the forage opponents move 36.6 KB a set, 37.8 MB at
// G = 1024, for 18.4 MFLOP, so the least time is the bytes over the card's
// memory rate (11.28 us) and the products are small beside it. The held
// kernel's grouped launch (a block a set, a 16-row tile with 15 rows idle,
// a ring of three 16 KB weight tiles behind a __syncthreads() each) keeps
// too few bytes in flight: 0.38 of the bound.
//
// What the design does about it:
// - Persistent blocks: as many as the card holds at once (grid = min(G,
//   SMs x blocks an SM): three an SM for the forage chain at 2 stages);
//   block b takes sets b, b + grid, b + 2 grid, ...
// - A ring of whole sets in shared memory, `stages` deep: a stage holds one
//   set's rows of x and every layer's W and b. One copying warp fills it.
//   Lane 0 arms the stage's full barrier with the bytes of its bulk copies
//   and issues them (cp.async.bulk, 1-D: a set's W_l [N, K] and b_l are
//   contiguous, so each is one copy and needs no tensor map). A tensor that
//   a bulk copy does not take (a set start that is not 16-byte aligned, or
//   a size that is not a multiple of 16 bytes: x's 24-byte rows) goes by
//   the warp's own cp.async, 16, 8 or 4 bytes wide as the set's address
//   allows and the tail by 4-byte copies, after which every lane arrives on
//   the full barrier when its copies land. The warp waits on the stage's
//   empty barrier before it reuses the stage. So several sets' bytes are in
//   flight on every SM at once. A tensor at set stride 0 (shared by every
//   set) is copied once, into a region kept for the block's life.
// - Products on the CUDA cores, in float32 FMA: a set of a few rows is a
//   chain of matrix-vector products, where a tensor-core tile would idle
//   most of its rows. The 8 multiplying warps form groups of `group_warps`
//   (ops/fused_mlp.py SETS_WARPS: 4), and group g takes the block's sets g,
//   g + groups, ..., so several sets are multiplied at once. In a layer each
//   thread of the group owns outputs t, t + threads, ... and sums each over
//   all of K itself, in vectors of 4 floats (2 or 1 where K is not a
//   multiple of 4), one fmaf a float, starting at vector n mod (K / vector)
//   and going round: neighbouring outputs start at neighbouring vectors, so
//   the 8 lanes of a 16-byte load's phase read 8 different columns of W and
//   of the input, without a bank conflict where K is a multiple of 8. Then
//   bias and activation (elu through expm1f, as the held kernel) in every
//   lane, and the row goes to the group's next activation buffer or, after
//   the last layer, to out (neighbouring lanes, neighbouring addresses). No
//   shuffles, and a fixed order: two calls give the same bits, and plain
//   float32 is closer to the chain than 3xTF32. The group meets at a named
//   barrier of its own after each layer, and each of its warps arrives on
//   the stage's empty barrier after the set's last layer. (The first design,
//   one set at a time over all 8 warps, a warp an output and a shuffle tree
//   over its lanes, was latency-bound: 27.2 us at G = 1024, slower than the
//   held launch from 2 rows a set: tools/fused_mlp_ab.py --sweep sets,
//   PERF.md §6.)
// - The stages are a multiple of the groups, so every use of a stage falls
//   to one group, whose parity wait on the stage's full barrier then never
//   finds it two phases behind.
// - The tensors' records are copied into shared memory at entry: a read of
//   the argument block at a layer index costs a constant-cache trip.
// - A wait that never ends traps (kWaitTries).
// ---------------------------------------------------------------------------

constexpr int kSetsWarps = 8;                        // warps that multiply
constexpr int kSetsThreads = 32 * (kSetsWarps + 1);  // and one copying warp
constexpr int kSetsTensors = 1 + 2 * kMaxLayers;     // x, then W_0, b_0, W_1, b_1, ...
constexpr int kMaxSetsStages = 16;
constexpr int kSetsArrivals = 33;  // a full barrier's: lane 0's expect_tx, then each lane's copies landed

// A tensor of a sets launch, as the host lays it out.
struct SetsTensor {
  const float* base;
  long long set;  // set stride in floats (0: every set shares it, copied once a block)
  int floats;     // floats a set
  int off;        // offset (floats) in a stage, or in shared memory for a shared tensor
};
static_assert(sizeof(SetsTensor) == 24, "ops/fused_mlp.py counts 24 bytes a record of the sets kernel's table");

struct SetsNet {
  SetsTensor t[kSetsTensors];
  float* out;
  long long out_set;
  int dims[kMaxLayers + 1];
  int n_layers, act, B, groups, stages;
  int group_warps;        // multiplying warps a set (1, 2, 4 or 8)
  int stage_floats;       // a stage's floats
  int ring_off, act_off;  // offsets (floats) of the ring and of the two activation buffers
  int act_floats;         // floats of one activation buffer (two a group of warps)
};

// The static shared memory of the sets kernel: its table of tensors and widths.
constexpr int kSetsStaticBytes = kSetsTensors * static_cast<int>(sizeof(SetsTensor)) + 4 * (kMaxLayers + 1);

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// activate<kAct> for an activation known at run time (one branch, the same
// in every thread).
__device__ __forceinline__ float activate_any(int act, float x) {
  switch (act) {
    case kRelu:
      return activate<kRelu>(x);
    case kElu:
      return activate<kElu>(x);
    case kSelu:
      return activate<kSelu>(x);
    case kSoftplus:
      return activate<kSoftplus>(x);
    case kGelu:
      return activate<kGelu>(x);
    case kSigmoid:
      return activate<kSigmoid>(x);
    case kSilu:
      return activate<kSilu>(x);
    case kTanh:
      return activate<kTanh>(x);
    default:
      return x;
  }
}

// Whether one bulk copy takes `floats` floats at `src`: a 16-byte aligned
// address and a multiple of 16 bytes (ops/fused_mlp.py sets_copy).
__device__ __forceinline__ bool sets_bulk(const float* src, int floats) {
  return (reinterpret_cast<uintptr_t>(src) & 15) == 0 && (floats & 3) == 0;
}

// The copying warp's copies of `floats` floats from `src` into `dst` (16-byte
// aligned): one bulk copy by lane 0, counted on `bar`, where sets_bulk takes
// them; else every lane's cp.async, 16, 8 or 4 bytes wide as `src`'s
// alignment allows, and the floats past the last whole copy 4 bytes a copy.
__device__ __forceinline__ void sets_copy(float* dst, const float* src, int floats, uint64_t* bar, int lane) {
  if (sets_bulk(src, floats)) {
    if (lane == 0) bulk_copy(dst, src, 4u * floats, bar);
    return;
  }
  const uintptr_t address = reinterpret_cast<uintptr_t>(src);
  int body = 0;
  if ((address & 15) == 0) {
    body = floats & ~3;
    for (int i = 4 * lane; i < body; i += 128) cp_async<4>(dst + i, src + i, true);
  } else if ((address & 7) == 0) {
    body = floats & ~1;
    for (int i = 2 * lane; i < body; i += 64) cp_async<2>(dst + i, src + i, true);
  }
  for (int i = body + lane; i < floats; i += 32) cp_async<1>(dst + i, src + i, true);
}

// The copying warp's copies of set `set`'s tensors into `dst`: with `shared`
// those that every set shares (set stride 0), else the others. Lane 0 arms
// `bar` with the bytes of the bulk copies before it issues them; every lane
// then arrives on `bar` once its own cp.async have landed (33 arrivals).
__device__ __forceinline__ void sets_stage(float* dst, const SetsTensor* table, int n_tensors, long long set,
                                           bool shared, uint64_t* bar, int lane) {
  uint32_t tx = 0;
  for (int k = 0; k < n_tensors; ++k) {
    const SetsTensor& t = table[k];
    if ((t.set == 0) == shared && sets_bulk(t.base + set * t.set, t.floats)) tx += 4u * t.floats;
  }
  if (lane == 0) mbar_arrive_expect_tx(bar, tx);
  for (int k = 0; k < n_tensors; ++k) {
    const SetsTensor& t = table[k];
    if ((t.set == 0) == shared) sets_copy(dst + t.off, t.base + set * t.set, t.floats, bar, lane);
  }
  cp_async_arrive(bar);
}

template <int kVec>
struct SetsVector;
template <>
struct SetsVector<4> {
  using T = float4;
  static __device__ __forceinline__ float fma(float4 w, float4 h, float acc) {
    acc = fmaf(w.x, h.x, acc);
    acc = fmaf(w.y, h.y, acc);
    acc = fmaf(w.z, h.z, acc);
    return fmaf(w.w, h.w, acc);
  }
};
template <>
struct SetsVector<2> {
  using T = float2;
  static __device__ __forceinline__ float fma(float2 w, float2 h, float acc) {
    acc = fmaf(w.x, h.x, acc);
    return fmaf(w.y, h.y, acc);
  }
};
template <>
struct SetsVector<1> {
  using T = float;
  static __device__ __forceinline__ float fma(float w, float h, float acc) { return fmaf(w, h, acc); }
};

// One layer of one set for thread `t` of the `threads` that multiply it:
// dst[r, n] = act(in[r, :] . W[n, :] + b[n]) for rows r < rows, the rows of
// `in` and of W K floats apart, those of dst N floats apart. Thread t owns
// outputs t, t + threads, ...; for output n it walks the K / kVec vectors of
// the inputs from vector n mod (K / kVec) on, round to the one before, each
// vector's floats in order, one fmaf each into the row's sum. Neighbouring
// outputs start at neighbouring vectors, so the 8 lanes of a 16-byte load's
// phase read 8 different 16-byte columns of W and of `in`: no bank conflict
// where K is a multiple of 8.
template <int kRows, int kVec>
__device__ __forceinline__ void sets_layer(const float* in, const float* W, const float* bias, int K, int N,
                                           int rows, int act, float* dst, int t, int threads) {
  using V = SetsVector<kVec>;
  using T = typename V::T;
  const int vectors = K / kVec;
  const T* in_v = reinterpret_cast<const T*>(in);
  for (int n = t; n < N; n += threads) {
    const T* w_v = reinterpret_cast<const T*>(W + static_cast<size_t>(n) * K);
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
    int v = n % vectors;
#pragma unroll 4
    for (int j = 0; j < vectors; ++j) {
      const T w = w_v[v];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < rows) acc[r] = V::fma(w, in_v[r * vectors + v], acc[r]);
      if (++v == vectors) v = 0;
    }
    const float b = bias[n];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < rows) dst[static_cast<size_t>(r) * N + n] = activate_any(act, acc[r] + b);
  }
}

// kRows: the most rows a set the kernel takes (B <= kRows). Three blocks of
// the instances of at most 2 rows may share an SM where their rings fit (at
// most 72 registers a thread), two of the others (112).
template <int kRows>
__global__ void __launch_bounds__(kSetsThreads, kRows <= 2 ? 3 : 2) fused_mlp_sets_kernel(const __grid_constant__ SetsNet net) {
  extern __shared__ __align__(16) float smem[];
  __shared__ SetsTensor table[kSetsTensors];
  __shared__ int dims[kMaxLayers + 1];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + net.stages;
  uint64_t* resident = empty + net.stages;  // the shared tensors' one fill
  float* ring = smem + net.ring_off;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_layers = net.n_layers, n_tensors = 1 + 2 * n_layers, stages = net.stages;
  if (tid < n_tensors) table[tid] = net.t[tid];
  if (tid <= n_layers) dims[tid] = net.dims[tid];
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], kSetsArrivals);
      mbar_init(&empty[s], net.group_warps);
    }
    mbar_init(resident, kSetsArrivals);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kSetsWarps) {
    // The copying warp: the shared tensors once, then this block's sets
    // through the ring, `stages` ahead of the multiplying warps.
    sets_stage(smem, table, n_tensors, 0, true, resident, lane);
    int i = 0;
    for (long long set = blockIdx.x; set < net.groups; set += gridDim.x, ++i) {
      const int s = i % stages, round = i / stages;
      if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);  // the group that took the slot's set is done with it
      sets_stage(ring + s * net.stage_floats, table, n_tensors, set, false, &full[s], lane);
    }
    cp_async_wait<0>();
    return;
  }

  // The multiplying warps, in groups of group_warps: group g takes the
  // block's sets g, g + groups, ... (the i-th set of the block is in stage
  // i % stages; the stages are a multiple of the groups, so every use of a
  // stage is one group's), with two activation buffers of its own, and
  // meets at a barrier of its own after each layer.
  const int group_threads = 32 * net.group_warps, groups = kSetsWarps / net.group_warps;
  const int group = warp / net.group_warps, t = tid - group * group_threads;
  float* act_buf = smem + net.act_off + 2 * group * net.act_floats;
  mbar_wait(resident, 0);
  for (long long i = group, set = blockIdx.x + group * static_cast<long long>(gridDim.x); set < net.groups;
       i += groups, set += groups * static_cast<long long>(gridDim.x)) {
    const int s = static_cast<int>(i % stages);
    mbar_wait(&full[s], static_cast<uint32_t>(i / stages) & 1);
    const float* stage = ring + s * net.stage_floats;
    for (int l = 0; l < n_layers; ++l) {
      const SetsTensor &wt = table[1 + 2 * l], &bt = table[2 + 2 * l];
      const float* W = (wt.set == 0 ? smem : stage) + wt.off;
      const float* bias = (bt.set == 0 ? smem : stage) + bt.off;
      const float* in = l == 0 ? (table[0].set == 0 ? smem : stage) + table[0].off
                               : act_buf + ((l - 1) & 1) * net.act_floats;
      const bool last = l == n_layers - 1;
      float* dst = last ? net.out + set * net.out_set : act_buf + (l & 1) * net.act_floats;
      const int K = dims[l], N = dims[l + 1];
      if ((K & 3) == 0)
        sets_layer<kRows, 4>(in, W, bias, K, N, net.B, net.act, dst, t, group_threads);
      else if ((K & 1) == 0)
        sets_layer<kRows, 2>(in, W, bias, K, N, net.B, net.act, dst, t, group_threads);
      else
        sets_layer<kRows, 1>(in, W, bias, K, N, net.B, net.act, dst, t, group_threads);
      if (last) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage
      }
      // the group's warps meet: layer l's output is whole before layer l + 1
      // reads it, and no warp writes a buffer that another still reads
      asm volatile("bar.sync %0, %1;" ::"r"(1 + group), "r"(group_threads) : "memory");
    }
  }
}

// An empty kernel of the sets kernel's block, launched at its grid and
// shared memory: the floor under a sets launch's time.
__global__ void __launch_bounds__(kSetsThreads, 1) fused_mlp_sets_empty_kernel() {}

// The sets kernel's dynamic shared memory, in bytes, for the launch in `net`
// (each tensor's floats and set stride, dims, n_layers, B, stages and
// group_warps set);
// fills each tensor's offset, the stage's floats and the regions' offsets
// (ops/fused_mlp.py sets_layout computes the same): the barriers (a full and
// an empty one a stage, one for the shared tensors), the shared tensors, two
// activation buffers of B rows of the widest inner width for each group of
// warps, then the ring. Every offset is a multiple of 4 floats: 16-byte copies, bulk
// copies and 16-byte loads.
long long sets_layout(SetsNet& net) {
  auto up4 = [](long long f) { return (f + 3) & ~3LL; };
  long long off = up4(2 * (2 * net.stages + 1));
  const int n_tensors = 1 + 2 * net.n_layers;
  for (int k = 0; k < n_tensors; ++k) {
    if (net.t[k].set != 0) continue;
    net.t[k].off = static_cast<int>(off);
    off += up4(net.t[k].floats);
  }
  int widest = 0;
  for (int l = 1; l < net.n_layers; ++l) widest = std::max(widest, net.dims[l]);
  net.act_off = static_cast<int>(off);
  net.act_floats = static_cast<int>(up4(static_cast<long long>(net.B) * widest));
  off += 2LL * (kSetsWarps / net.group_warps) * net.act_floats;
  net.ring_off = static_cast<int>(off);
  long long stage = 0;
  for (int k = 0; k < n_tensors; ++k) {
    if (net.t[k].set == 0) continue;
    net.t[k].off = static_cast<int>(stage);
    stage += up4(net.t[k].floats);
  }
  net.stage_floats = static_cast<int>(stage);
  return 4 * (off + net.stages * stage);
}

// Sets a kernel's dynamic shared memory and returns the grid of a sets
// launch over `groups` sets: as many blocks as the card holds at once, at
// most one a set; -1 on an error.
template <typename Kernel>
int sets_grid(Kernel kernel, int groups, int smem_bytes) {
  static int sms = 0;
  if (sms == 0) {
    int device = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
      return -1;
  }
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes) != cudaSuccess) return -1;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSetsThreads, smem_bytes) != cudaSuccess ||
      per_sm < 1)
    return -1;
  return std::min(groups, sms * per_sm);
}

// The sets kernel's instance for `rows` rows a set (1, 2, 4, 8 or 16), or null.
using SetsKernel = void (*)(SetsNet);
SetsKernel sets_kernel(int rows) {
  switch (rows) {
    case 1:
      return fused_mlp_sets_kernel<1>;
    case 2:
      return fused_mlp_sets_kernel<2>;
    case 4:
      return fused_mlp_sets_kernel<4>;
    case 8:
      return fused_mlp_sets_kernel<8>;
    case 16:
      return fused_mlp_sets_kernel<16>;
    default:
      return nullptr;
  }
}


// ---------------------------------------------------------------------------
// The wgmma launch: a held chain over many rows (the flagship torso's rollout
// and minibatches, the 3D configs', the deep torso's), `fused_mlp_wgmma_kernel`.
//
// It replaces no further TPU kernel: it is the route of `_fused_kernel`
// (rl_games_tpu/ops/fused_mlp.py:112) on this card where a held, ungrouped
// launch has many rows (ops/fused_mlp.py wgmma_plan), and computes what the
// held kernel computes, within the same rtol = atol = 2e-5 of the chain.
//
// What bounds it on this card: the 3xTF32 products, as for the held kernel
// (26 -> 256 -> 128 -> 64 at B = 8192: 1.17 GFLOP of TF32 products against
// 2.95 MB of x and out). What kept the held kernel at 0.16-0.19 of that
// bound: warp-level mma.sync, which does not reach the tensor cores' rate;
// every 32-row block reading the chain's 190 KB of weights again from L2
// through a ring of three tiles behind a __syncthreads() each; and a row
// tile's phases (copies, products, bias and activation) in step across the
// blocks of an SM.
//
// What the design does about it:
// - Products by the warpgroup instruction with A from registers:
//   `wgmma.mma_async.sync.aligned.m64nNk8.f32.tf32.tf32`, D [64 rows, N
//   outputs] += A [64 rows, 8 inputs] . W [N outputs, 8 inputs]^T. W's
//   [out, in] layout is the K-major B operand that TF32 wants, read from
//   shared memory through a descriptor (128-byte swizzle, 8-row groups 1024
//   bytes apart); nothing is transposed.
// - 3xTF32 with hi the truncation: the tensor core reads a float32's leading
//   10 mantissa bits and ignores the rest, so hi is the value itself and
//   lo = v - (v with its last 13 bits cleared) is exact, of which the tensor
//   core reads the leading bits again (tests/test_torch_port_fused_mlp_wgmma.py
//   rehearses the scheme against the chain in float64). Per 8 inputs
//   a_lo.w_hi and a_hi.w_lo go to a small accumulator and a_hi.w_hi to the
//   main one, in the held kernel's order, since the tensor core's adder
//   truncates; both are added, with the bias, in float32 at the layer's end.
// - A block owns a tile of 64 rows and walks the whole chain for it; two
//   consumer warpgroups split each layer's outputs (warpgroup c takes
//   outputs c H .. c H + H - 1, H = 16, 32, 64 or 128: half the width
//   rounded up, so two accumulators of H / 2 registers a thread each fit).
//   The activations stay in shared memory, one buffer of 64 rows in the
//   swizzled K-major layout (blocks of 32 inputs), overwritten in place: a
//   layer's outputs are written once both warpgroups have read its inputs
//   (a named barrier), and zero from N up to 2 H, the next layer's
//   zero-filled inputs. A thread loads its A fragments (rows g and g + 8 of
//   its warp's 16, inputs t and t + 4 of each step; conflict-free through the
//   swizzle) and makes lo in registers, so no lo copy of the activations is
//   kept: the buffer and the ring share 227 KB.
// - Weights stream through a ring of slots, each 128 output rows of W by 32
//   inputs and beside it their lo tile: a layer's 32 inputs take one slot
//   where 2 H <= 128 (both warpgroups read it) and two where 2 H = 256 (one
//   a warpgroup). Ring, buffer and a staging buffer (below) share 227 KB:
//   beside the flagship's 256-wide buffer (64 KB) and its staged first
//   weight (26 KB) four slots fit. A producer warpgroup fills the ring. Its
//   two copying warps wait on a slot's empty barrier and bring W's tile by
//   one bulk tensor copy (`cp.async.bulk.tensor`, rows past N zero-filled),
//   multicast from the cluster's first block to every block of the
//   cluster, so that the cluster's blocks read each weight from L2 once. A
//   W whose rows are not 16-byte multiples (the 26, 33 and 41 inputs of the
//   main paths' first layers), which no tensor map takes, comes whole by
//   one bulk copy (`cp.async.bulk`: its bytes are a multiple of 16) into
//   the staging buffer as it lies in device memory, once a row tile, each
//   block its own; the splitting warps swizzle its rows into the slots. A
//   W that neither takes comes by the kernel's own 16-, 8- or 4-byte
//   cp.async into the slots, a step's rows shared by the copying and the
//   splitting warps (the kernel picks the mode a layer from W's address and
//   widths; 4- and 8-byte cp.async issue slowly, and a first layer's copies
//   lie on every row tile's path).
//   The two splitting warps wait on the slot's full barrier, write the lo
//   tile (and, after cp.async or from the staging buffer, the hi tile with
//   their own stores, so that their proxy fence covers every byte that the
//   tensor cores read) and arrive on the slot's ready barrier, so the split
//   runs beside the products, once a slot and block, and not on the
//   consumers' path. A consuming warp waits on the slot's ready and full
//   barriers and, once its products are done, arrives on the slot's empty
//   barrier in every block of the cluster (on both slots of a 256-wide
//   layer's step, so every empty barrier counts the same arrivals).
// - The bias and activation of a layer's end write each pair of outputs
//   with one 8-byte store at an address that is a register (one of four a
//   thread: the swizzle's XOR takes four values along a row) plus a
//   constant; elu's and selu's expm1 is exp - 1 through ex2.approx
//   (wg_activate): expm1f took most of the layer ends' time.
// - Persistent blocks, as many as the card holds at once (one an SM), walk
//   row tiles block, block + grid, ... (whole clusters: a cluster's blocks
//   walk as many tiles, the last ones empty where the rows end); x's next
//   tile is asked for (cp.async, zero-filled past the rows and inputs) as
//   soon as the last layer has read the buffer, under the last layer's
//   epilogue, and the ring runs on across row tiles.
// - Registers: 384 threads start at 168 a thread; the producer warpgroup
//   gives registers to the consumers (`setmaxnreg`: 56 and 224), one branch
//   a role to the end. The activation is a template argument.
// - A wait that never ends traps (kWaitTries). A block's first copying warp
//   exits only after every slot's last use has been released by every
//   block of its cluster.
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;                            // rows a block: one wgmma tile
constexpr int kWgConsumers = 2;                        // consumer warpgroups, each half of a layer's outputs
constexpr int kWgThreads = 128 * (kWgConsumers + 1);   // and a producer warpgroup
constexpr int kWgConsumerThreads = 128 * kWgConsumers;
constexpr int kWgMaxWidth = 256;                       // widths the kernel takes
constexpr int kWgSlotRows = 128;                       // rows of W a slot of the ring holds
constexpr int kWgSlotFloats = 2 * kWgSlotRows * 32;    // W's 32 inputs of them, then their lo tile
constexpr int kWgMaxSlots = 6;
constexpr int kWgMaxStageBytes = 65536;               // a staged W: one bulk copy of a whole weight
constexpr int kWgCopiers = 64;                         // the producer warpgroup's first two warps copy
constexpr int kWgSplitters = 64;                       // its last two split
constexpr int kWgFullArrivals = 1 + kWgCopiers + kWgSplitters;  // the expect_tx arrival, then each producer thread's copies landed
constexpr int kWgProducerRegisters = 56;               // 128 x (168 - 56) = 256 x (224 - 168)
constexpr int kWgConsumerRegisters = 224;

struct WgmmaNet {
  CUtensorMap map[kMaxLayers];  // W_l's bulk tensor copies, where bit l of `tma` is set
  const float* x;
  float* out;
  const float* w[kMaxLayers];
  const float* b[kMaxLayers];
  int dims[kMaxLayers + 1];
  int half[kMaxLayers];  // outputs a consumer warpgroup takes in layer l: 16, 32, 64 or 128
  int n_layers, B, tma, slots;
  int staged;       // bit l: W_l comes by one bulk copy of the whole weight into the staging buffer
  int stage_bytes;  // the staging buffer
  int width;        // floats of a row of the activation buffer: a multiple of 32
  int iters;        // row tiles a block walks
};

// The bytes of layer l's W [n, k] in the staging buffer where bulk tensor
// copies can never take its rows (k not a multiple of 4: the 26, 33 and 41
// inputs of the main paths) and one bulk copy can take it whole (its bytes
// a multiple of 16, at most kWgMaxStageBytes), else 0 (ops/fused_mlp.py
// wgmma_stage_bytes).
__host__ __device__ __forceinline__ int wg_stage_bytes(int n, int k) {
  const long long bytes = 4LL * n * k;
  return (k & 3) != 0 && (bytes & 15) == 0 && bytes <= kWgMaxStageBytes ? static_cast<int>(bytes) : 0;
}

// Outputs a consumer warpgroup takes of a layer of `n` outputs: half of them
// rounded up to 8, then to the instruction width 16, 32, 64 or 128
// (ops/fused_mlp.py wgmma_half).
int wgmma_half(int n) {
  const int half = (n + 15) / 16 * 8;
  return half <= 16 ? 16 : half <= 32 ? 32 : half <= 64 ? 64 : 128;
}

// A shared-memory descriptor of a K-major tile with the 128-byte swizzle:
// its address (16-byte units), the stride between 8-row groups (1024 bytes)
// and the layout; the leading offset is not used by this layout.
__device__ __forceinline__ uint64_t wg_desc(const float* p) {
  const uint64_t address = smem_u32(p);
  return ((address & 0x3FFFF) >> 4) | (1ull << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d += a . b for one 64 x H x 8 step of the warpgroup: a this thread's A
// fragment (rows g, g + 8 of its warp's 16 by inputs t, t + 4), b the
// descriptor of the H x 8 weight tile.
template <int H>
__device__ __forceinline__ void wgmma_tf32(float (&d)[H / 2], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %13, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %21, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %69, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory"); }

// Keeps the compiler from moving accesses to the accumulators across the
// asynchronous products.
template <int M>
__device__ __forceinline__ void fence_accumulators(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kWgConsumerThreads) : "memory");
}

// The copies, by threads 0 .. kThreads-1 (this one `tid`), of rows 0 ..
// rows-1 of a row-major [*, K] matrix (`src`: its first row) by inputs
// k0 .. k0 + 32 blocks - 1 into `blocks` swizzled tiles of rows x 32 floats
// at `dst` (the 16-byte chunk c of row r at chunk c ^ (r % 8)), kFloats (4,
// 2 or 1) floats a copy; rows from rows_inside on and inputs from K on land
// as zeros (`base`: an address inside the matrix for the copies that read
// nothing).
template <int kFloats, int kThreads>
__device__ __forceinline__ void wg_copy_by(float* dst, const float* __restrict__ src, const float* base, int rows,
                                           int rows_inside, int K, int k0, int blocks, int tid) {
  constexpr int kPerRow = 32 / kFloats;
  const int per_block = rows * kPerRow;
#pragma unroll 1
  for (int idx = tid; idx < blocks * per_block; idx += kThreads) {
    const int kb = idx / per_block, rem = idx - kb * per_block;
    const int r = rem / kPerRow, c = (rem % kPerRow) * kFloats, k = k0 + 32 * kb + c;
    const bool inside = r < rows_inside && k < K;
    float* to = dst + kb * rows * 32 + r * 32 + ((((c >> 2) ^ (r & 7)) << 2) | (c & 3));
    cp_async<kFloats>(to, inside ? src + static_cast<size_t>(r) * K + k : base, inside);
  }
}

template <int kThreads>
__device__ __forceinline__ void wg_copy(float* dst, const float* __restrict__ src, const float* base, int rows,
                                        int rows_inside, int K, int k0, int blocks, int tid) {
  const uintptr_t address = reinterpret_cast<uintptr_t>(src);
  if ((K & 3) == 0 && (address & 15) == 0)
    wg_copy_by<4, kThreads>(dst, src, base, rows, rows_inside, K, k0, blocks, tid);
  else if ((K & 1) == 0 && (address & 7) == 0)
    wg_copy_by<2, kThreads>(dst, src, base, rows, rows_inside, K, k0, blocks, tid);
  else
    wg_copy_by<1, kThreads>(dst, src, base, rows, rows_inside, K, k0, blocks, tid);
}

// The shared memory of the wgmma kernel, its parts in floats from the
// 1024-aligned start: the activation buffer, then the ring (each slot W's
// tile, then its lo tile), then the full, empty and ready barriers.
struct WgLayout {
  float* act;
  float* ring;
  float* stage;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* ready;
  uint64_t* stage_full;
  uint64_t* stage_empty;
};

__device__ __forceinline__ WgLayout wg_layout(unsigned char* raw, const WgmmaNet& net) {
  WgLayout s;
  s.act = reinterpret_cast<float*>((reinterpret_cast<uintptr_t>(raw) + kSwizzleAlign - 1) &
                                   ~static_cast<uintptr_t>(kSwizzleAlign - 1));
  s.ring = s.act + kWgRows * net.width;
  s.stage = s.ring + net.slots * kWgSlotFloats;
  s.full = reinterpret_cast<uint64_t*>(s.stage + net.stage_bytes / 4);
  s.empty = s.full + net.slots;
  s.ready = s.empty + net.slots;
  s.stage_full = s.ready + net.slots;
  s.stage_empty = s.stage_full + 1;
  return s;
}

// Row tile `it` of this block: the cluster's blocks take neighbouring tiles,
// the clusters every nclusters-th group of them.
__device__ __forceinline__ long long wg_tile(int it, int cluster) {
  const long long nclusters = gridDim.x / cluster;
  return (static_cast<long long>(cluster_index()) + it * nclusters) * cluster + cluster_rank();
}

// A place in the ring: the slot and how often the ring has come round to it
// (its barriers' phase parity is round & 1). Producers and consumers walk
// the same sequence of slots.
struct WgSlot {
  int s;
  uint32_t round;
  __device__ __forceinline__ void next(int slots) {
    if (++s == slots) {
      s = 0;
      ++round;
    }
  }
};

// The slots of a layer's step of 32 inputs (one where 2 H <= 128, two where
// 2 H = 256: warpgroup c reads the c-th) and the rows of W each holds.
__host__ __device__ __forceinline__ int wg_parts(int half) { return 2 * half > kWgSlotRows ? 2 : 1; }
__host__ __device__ __forceinline__ int wg_box(int half) { return 2 * half < kWgSlotRows ? 2 * half : kWgSlotRows; }

// activate<kAct>, with elu's and selu's expm1 as exp - 1 through the
// card's exp2 (ex2.approx): its error, about 2^-22 of exp(x) <= 1, is 1 %
// of the tolerance's atol, and expm1f took most of the layer ends' time.
template <int kAct>
__device__ __forceinline__ float wg_activate(float x) {
  if (kAct == kElu || kAct == kSelu) {
    const float e = __expf(fminf(x, 0.0f)) - 1.0f;
    return kAct == kElu ? (x > 0.0f ? x : e) : 1.0507009873554805f * (x > 0.0f ? x : 1.6732632423543772f * e);
  }
  return activate<kAct>(x);
}

// v - (v with its last 13 bits cleared), elementwise: the lo halves of a
// weight's four values.
__device__ __forceinline__ float4 wg_lo4(float4 v) {
  return make_float4(v.x - __uint_as_float(__float_as_uint(v.x) & 0xffffe000u),
                     v.y - __uint_as_float(__float_as_uint(v.y) & 0xffffe000u),
                     v.z - __uint_as_float(__float_as_uint(v.z) & 0xffffe000u),
                     v.w - __uint_as_float(__float_as_uint(v.w) & 0xffffe000u));
}

// The kernel's own copies of a step of 32 inputs (from k0 on) of layer l's
// W, for a W that bulk copies do not take, shared by the producer's two
// pairs of warps (`half`: 0 the copying warps, 1 the splitting warps; `tid`
// 0-63 within them): of a step of two slots each takes one, of a step of
// one slot each half of its rows.
__device__ __forceinline__ void wg_copy_half(float* slot, const WgmmaNet& net, int l, int k0, int part, int half,
                                             int tid) {
  const int K = net.dims[l], N = net.dims[l + 1], parts = wg_parts(net.half[l]), box = wg_box(net.half[l]);
  if (parts == 2 && part != half) return;
  const int r0 = parts == 2 ? 0 : half * (box / 2), rows = parts == 2 ? box : box / 2;
  const int row = part * kWgSlotRows + r0;  // the first row of W copied
  wg_copy<kWgCopiers>(slot + r0 * 32, net.w[l] + static_cast<size_t>(row) * K, net.w[l], rows,
                      max(0, min(N - row, rows)), K, k0, 1, tid);
}

// One layer of a consumer warpgroup (`c`: its half of the outputs) over the
// block's row tile at row0: the products slot by slot, then activation and
// the store, into the activation buffer in place or, after the last layer,
// to out. With `next_x`, the next tile's x is asked for once the buffer is
// free.
template <int H, int kAct>
__device__ __forceinline__ void wg_layer(const WgmmaNet& net, const WgLayout& sm, int l, WgSlot& pos, int c,
                                         int warp_in_group, int lane, int cluster, long long row0,
                                         const float* next_x, int next_rows) {
  constexpr int kParts = 2 * H > kWgSlotRows ? 2 : 1;
  const int K = net.dims[l], N = net.dims[l + 1];
  const bool last = l == net.n_layers - 1;
  const int nK = (K + 31) / 32;
  // Offsets and addresses from here on depend on this opaque 0, so the
  // compiler cannot compute them once for every row tile and layer ahead of
  // the loops (hundreds of them, which spill and come back from L2).
  int opaque;
  asm volatile("mov.u32 %0, 0;" : "=r"(opaque));
  float* const act = sm.act + opaque;
  float* const ring = sm.ring + opaque;
  const int g = (lane + opaque) >> 2, t = (lane + opaque) & 3;
  const int r0 = 16 * warp_in_group + g;  // this thread's rows r0 and r0 + 8 of the tile
  const int sw = r0 & 7;
  // The small sum starts from the bias: its truncations are 2^-23 of the
  // bias's size, and the layer's end adds nothing more.
  float big[H / 2], small[H / 2];
  const float* __restrict__ bias = net.b[l] + opaque;
#pragma unroll
  for (int j = 0; j < H / 8; ++j) {
    const int n = c * H + 8 * j + 2 * t;
    const float b0 = n < N ? __ldg(bias + n) : 0.0f, b1 = n + 1 < N ? __ldg(bias + n + 1) : 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      big[4 * j + 2 * h] = big[4 * j + 2 * h + 1] = 0.0f;
      small[4 * j + 2 * h] = b0;
      small[4 * j + 2 * h + 1] = b1;
    }
  }
#pragma unroll 1
  for (int kb = 0; kb < nK; ++kb) {
    WgSlot mine = pos;
    if (kParts == 2 && c == 1) mine.next(net.slots);
    // the A fragments of the step's four instructions (rows g and g + 8 of
    // the warp's 16 by inputs t and t + 4 of each): a_hi is the value
    // itself (the tensor core reads its leading bits), a_lo the rest
    const float* blk = act + kb * kWgRows * 32;
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int c0 = ((2 * ks) ^ sw) << 2, c1 = ((2 * ks + 1) ^ sw) << 2;
      const float v[4] = {blk[r0 * 32 + c0 + t], blk[(r0 + 8) * 32 + c0 + t], blk[r0 * 32 + c1 + t],
                          blk[(r0 + 8) * 32 + c1 + t]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hi[ks][e] = __float_as_uint(v[e]);
        lo[ks][e] = __float_as_uint(v[e] - __uint_as_float(__float_as_uint(v[e]) & 0xffffe000u));
      }
    }
    mbar_wait(&sm.ready[mine.s], mine.round & 1);
    mbar_wait(&sm.full[mine.s], mine.round & 1);
    const float* w_hi = ring + mine.s * kWgSlotFloats + (kParts == 1 ? c * H * 32 : 0);
    const float* w_lo = w_hi + kWgSlotRows * 32;
    fence_accumulators(big);
    fence_accumulators(small);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t d_hi = wg_desc(w_hi + 8 * ks), d_lo = wg_desc(w_lo + 8 * ks);
      wgmma_tf32<H>(small, lo[ks], d_hi);
      wgmma_tf32<H>(big, hi[ks], d_hi);
      wgmma_tf32<H>(small, hi[ks], d_lo);
    }
    wgmma_commit();
    wgmma_wait();
    fence_accumulators(big);
    fence_accumulators(small);
    __syncwarp();
    if (lane < cluster) {
      // every consuming warp releases every slot of the step
      WgSlot release = pos;
#pragma unroll
      for (int p = 0; p < kParts; ++p) {
        mbar_arrive_remote(&sm.empty[release.s], lane);
        release.next(net.slots);
      }
    }
#pragma unroll
    for (int p = 0; p < kParts; ++p) pos.next(net.slots);
  }
  consumers_sync();  // both warpgroups have read the buffer
  if (next_x != nullptr)
    wg_copy<kWgConsumerThreads>(act, next_x, net.x, kWgRows, next_rows, net.dims[0], 0, (net.dims[0] + 31) / 32,
                                threadIdx.x);
  // the same for the layer's end, apart from the offsets of the bias's loads
  int opaque_end;
  asm volatile("mov.u32 %0, 0;" : "=r"(opaque_end));
  const int t_end = t + opaque_end, g_end = g + opaque_end, r_end = 16 * warp_in_group + g_end;
  if (last) {
    float* const out = net.out + opaque_end;
#pragma unroll
    for (int j = 0; j < H / 8; ++j) {
      const int n = c * H + 8 * j + 2 * t_end;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = row0 + r_end + 8 * h;
        const float y0 = wg_activate<kAct>(big[4 * j + 2 * h] + small[4 * j + 2 * h]);
        const float y1 = wg_activate<kAct>(big[4 * j + 2 * h + 1] + small[4 * j + 2 * h + 1]);
        if (row < net.B) {
          if (n < N) out[row * N + n] = y0;
          if (n + 1 < N) out[row * N + n + 1] = y1;
        }
      }
    }
  } else {
    // Outputs n = c H + 8 j + 2 t and n + 1 of rows r_end and r_end + 8 land
    // at (n / 32) (64 x 32) + r 32 + (((n % 32) / 4) ^ (r % 8)) 4 + n % 4 of
    // the buffer; r % 8 is g, and with J = c H / 8 + j the 16-byte chunk
    // (n % 32) / 4 is 2 (J % 4) + t / 2, so the XOR takes four values a
    // thread, one for each J % 4: four base addresses, each plus constants.
    const int rot = ((c * H) >> 3) & 3, q = g_end ^ (t_end >> 1);
    const uint32_t base =
        smem_u32(act) + 4 * (((c * H) >> 5) * (kWgRows * 32) + r_end * 32 + 2 * (t_end & 1)) + opaque_end;
    uint32_t at[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) at[m] = base + 16 * ((2 * ((m + rot) & 3)) ^ q);
#pragma unroll
    for (int j = 0; j < H / 8; ++j) {
      const int n = c * H + 8 * j + 2 * t_end;
      const bool in0 = n < N, in1 = n + 1 < N;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float y0 = wg_activate<kAct>(big[4 * j + 2 * h] + small[4 * j + 2 * h]);
        const float y1 = wg_activate<kAct>(big[4 * j + 2 * h + 1] + small[4 * j + 2 * h + 1]);
        const uint32_t p = at[j & 3] + 4 * ((j >> 2) * (kWgRows * 32) + 8 * h * 32);
        asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(p), "f"(in0 ? y0 : 0.0f), "f"(in1 ? y1 : 0.0f)
                     : "memory");
      }
    }
  }
  if (next_x != nullptr) {
    cp_async_commit();
    cp_async_wait<0>();
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // for the tensor cores' reads of the buffer
  consumers_sync();  // the layer's outputs (or the next tile's x) are whole
}

template <int kAct>
__global__ void __launch_bounds__(kWgThreads, 1) fused_mlp_wgmma_kernel(const __grid_constant__ WgmmaNet net) {
  extern __shared__ unsigned char smem_raw[];
  const WgLayout sm = wg_layout(smem_raw, net);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cluster = static_cast<int>(cluster_blocks()), rank = static_cast<int>(cluster_rank());
  const int slots = net.slots;
  if (tid == 0) {
    for (int s = 0; s < slots; ++s) {
      mbar_init(&sm.full[s], kWgFullArrivals);
      mbar_init(&sm.empty[s], 4 * kWgConsumers * cluster);  // every consuming warp of the cluster
      mbar_init(&sm.ready[s], kWgSplitters);
    }
    mbar_init(sm.stage_full, 1);
    mbar_init(sm.stage_empty, kWgSplitters);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();

  // One branch a role to the end, as setmaxnreg wants it.
  if (warp >= 4 * kWgConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kWgProducerRegisters));
    const int ptid = tid - kWgConsumerThreads;
    WgSlot pos = {0, 0};
    if (ptid < kWgCopiers) {
      // The copying warps: each slot once every block of the cluster is
      // done with it. Thread 0 arms the slot's full barrier with the bytes
      // of the bulk copy and, in the cluster's first block, issues it to
      // every block of the cluster. A W that bulk copies do not take both
      // pairs of the producer's warps copy (wg_copy_half), each block its
      // own, and every producer thread arrives when its copies have landed.
      const uint16_t mask = cluster == 1 ? 0 : static_cast<uint16_t>((1u << cluster) - 1);
      int uses = 0, staged_uses = 0;
#pragma unroll 1
      for (int it = 0; it < net.iters; ++it) {
#pragma unroll 1
        for (int l = 0; l < net.n_layers; ++l) {
          const int K = net.dims[l], parts = wg_parts(net.half[l]), box = wg_box(net.half[l]);
          const bool tma = (net.tma >> l) & 1, staged = (net.staged >> l) & 1;
          if (staged) {
            // the whole W into the staging buffer once the splitting warps are done with its last use
            if (ptid == 0) {
              if (staged_uses > 0) mbar_wait(sm.stage_empty, (staged_uses - 1) & 1);
              const uint32_t bytes = static_cast<uint32_t>(wg_stage_bytes(net.dims[l + 1], K));
              mbar_arrive_expect_tx(sm.stage_full, bytes);
              bulk_copy(sm.stage, net.w[l], bytes, sm.stage_full);
            }
            ++staged_uses;
          }
#pragma unroll 1
          for (int k0 = 0; k0 < K; k0 += 32) {
#pragma unroll 1
            for (int p = 0; p < parts; ++p, ++uses) {
              float* w_hi = sm.ring + pos.s * kWgSlotFloats;
              if (pos.round > 0) mbar_wait(&sm.empty[pos.s], (pos.round - 1) & 1);
              if (tma) {
                if (ptid == 0) {
                  mbar_arrive_expect_tx(&sm.full[pos.s], 4u * box * 32);
                  if (rank == 0) tma_load(w_hi, &net.map[l], &sm.full[pos.s], k0, p * kWgSlotRows, 0, mask);
                }
              } else {
                if (ptid == 0) mbar_arrive_expect_tx(&sm.full[pos.s], 0);
                if (!staged) wg_copy_half(w_hi, net, l, k0, p, 0, ptid);
              }
              cp_async_arrive(&sm.full[pos.s]);
              pos.next(slots);
            }
          }
        }
      }
      if (ptid < 32) {
        // The tail: the last use of every slot released by every consuming
        // warp of the cluster. Then no block of the cluster can still copy
        // into this block's shared memory or arrive on its barriers.
        for (int i = max(0, uses - slots); i < uses; ++i) mbar_wait(&sm.empty[i % slots], (i / slots) & 1);
      }
    } else {
      // The splitting warps, a step of 32 inputs at a time: first their
      // share of the step's copies (after the kernel's own cp.async; each
      // after the slot's empty barrier) and their arrival on each of its
      // slots' full barriers; then each slot once it has landed: lo = v -
      // (v with its last 13 bits cleared), elementwise (the lo tile has W's
      // layout), and after cp.async the hi tile again.
      const int stid = ptid - kWgCopiers;
      int staged_uses = 0;
#pragma unroll 1
      for (int it = 0; it < net.iters; ++it) {
#pragma unroll 1
        for (int l = 0; l < net.n_layers; ++l) {
          const int K = net.dims[l], N = net.dims[l + 1], parts = wg_parts(net.half[l]), box = wg_box(net.half[l]);
          const bool tma = (net.tma >> l) & 1, staged = (net.staged >> l) & 1;
          if (staged) mbar_wait(sm.stage_full, staged_uses & 1);
#pragma unroll 1
          for (int k0 = 0; k0 < K; k0 += 32) {
            WgSlot at = pos;
#pragma unroll 1
            for (int p = 0; p < parts; ++p) {
              if (!tma && !staged) {
                if (at.round > 0) mbar_wait(&sm.empty[at.s], (at.round - 1) & 1);
                wg_copy_half(sm.ring + at.s * kWgSlotFloats, net, l, k0, p, 1, stid);
              }
              cp_async_arrive(&sm.full[at.s]);
              at.next(slots);
            }
#pragma unroll 1
            for (int p = 0; p < parts; ++p) {
              mbar_wait(&sm.full[pos.s], pos.round & 1);
              float4* hi4 = reinterpret_cast<float4*>(sm.ring + pos.s * kWgSlotFloats);
              float4* lo4 = hi4 + kWgSlotRows * 8;
              if (staged) {
#pragma unroll 1
                for (int i = stid; i < box * 8; i += kWgSplitters) {
                  // 16 bytes of a row of the slot from the staged W [N, K] (row-major, unswizzled): row
                  // p 128 + i / 8, inputs k0 + 4 (chunk i % 8 undone from the swizzle) on, zeros past N and K
                  const int r = i >> 3, row = p * kWgSlotRows + r, k = k0 + 4 * ((i & 7) ^ (r & 7));
                  const float* src = sm.stage + row * K + k;
                  const bool in = row < N;
                  const float4 v = make_float4(in && k < K ? src[0] : 0.0f, in && k + 1 < K ? src[1] : 0.0f,
                                               in && k + 2 < K ? src[2] : 0.0f, in && k + 3 < K ? src[3] : 0.0f);
                  hi4[i] = v;
                  lo4[i] = wg_lo4(v);
                }
              } else {
#pragma unroll 4
                for (int i = stid; i < box * 8; i += kWgSplitters) {
                  const float4 v = hi4[i];
                  lo4[i] = wg_lo4(v);
                  if (!tma) hi4[i] = v;
                }
              }
              asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
              mbar_arrive(&sm.ready[pos.s]);
              pos.next(slots);
            }
          }
          if (staged) {
            mbar_arrive(sm.stage_empty);  // the staged W's last slot is made
            ++staged_uses;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kWgConsumerRegisters));
    const int c = warp / 4, warp_in_group = warp % 4;
    const int K0 = net.dims[0], blocks0 = (K0 + 31) / 32;
    WgSlot pos = {0, 0};
    {
      const long long row0 = wg_tile(0, cluster) * kWgRows;
      const int rows = static_cast<int>(max(0LL, min(static_cast<long long>(kWgRows), net.B - row0)));
      wg_copy<kWgConsumerThreads>(sm.act, rows > 0 ? net.x + row0 * K0 : net.x, net.x, kWgRows, rows, K0, 0,
                                  blocks0, tid);
      cp_async_commit();
      cp_async_wait<0>();
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      consumers_sync();
    }
#pragma unroll 1
    for (int it = 0; it < net.iters; ++it) {
      const long long row0 = wg_tile(it, cluster) * kWgRows;
      const long long next0 = wg_tile(it + 1, cluster) * kWgRows;
      const int next_rows = static_cast<int>(max(0LL, min(static_cast<long long>(kWgRows), net.B - next0)));
      const float* next_x = it + 1 < net.iters ? (next_rows > 0 ? net.x + next0 * K0 : net.x) : nullptr;
#pragma unroll 1
      for (int l = 0; l < net.n_layers; ++l) {
        const float* prefetch = l == net.n_layers - 1 ? next_x : nullptr;
        switch (net.half[l]) {
          case 16:
            wg_layer<16, kAct>(net, sm, l, pos, c, warp_in_group, lane, cluster, row0, prefetch, next_rows);
            break;
          case 32:
            wg_layer<32, kAct>(net, sm, l, pos, c, warp_in_group, lane, cluster, row0, prefetch, next_rows);
            break;
          case 64:
            wg_layer<64, kAct>(net, sm, l, pos, c, warp_in_group, lane, cluster, row0, prefetch, next_rows);
            break;
          default:
            wg_layer<128, kAct>(net, sm, l, pos, c, warp_in_group, lane, cluster, row0, prefetch, next_rows);
            break;
        }
      }
    }
  }
}

// An empty kernel of the wgmma kernel's block, launched at its grid, cluster
// and shared memory: the floor under a wgmma launch's time.
__global__ void __launch_bounds__(kWgThreads, 1) fused_mlp_wgmma_empty_kernel() {}

// The wgmma kernel's dynamic shared memory for `net` (dims, n_layers and
// slots set), in bytes; fills the halves and the buffer's width
// (ops/fused_mlp.py wgmma_shared_bytes computes the same): 1 KB to align the
// buffer to the swizzle's 1024 bytes, the buffer (64 rows of the widest of
// x's inputs and the inner widths, each rounded up to 32, where the outputs
// of a layer are written to 2 H), the slots (128 rows of 32 floats, twice),
// the staging buffer (the largest wg_stage_bytes of a layer), three
// barriers a slot and the staging buffer's two.
int wgmma_layout(WgmmaNet& net) {
  int width = (net.dims[0] + 31) / 32 * 32, stage = 0;
  for (int l = 0; l < net.n_layers; ++l) {
    net.half[l] = wgmma_half(net.dims[l + 1]);
    if (l < net.n_layers - 1) width = std::max(width, 2 * net.half[l]);
    stage = std::max(stage, wg_stage_bytes(net.dims[l + 1], net.dims[l]));
  }
  net.width = width;
  net.stage_bytes = stage;
  return kSwizzleAlign + 4 * (kWgRows * width + net.slots * kWgSlotFloats) + stage + 3 * 8 * net.slots + 2 * 8;
}

cudaLaunchConfig_t wgmma_config(int grid, int cluster, int smem_bytes, cudaStream_t stream,
                                cudaLaunchAttribute* attribute) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned int>(grid));
  config.blockDim = dim3(kWgThreads);
  config.dynamicSmemBytes = smem_bytes;
  config.stream = stream;
  attribute->id = cudaLaunchAttributeClusterDimension;
  attribute->val.clusterDim.x = static_cast<unsigned int>(cluster);
  attribute->val.clusterDim.y = 1;
  attribute->val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  return config;
}

// Sets a wgmma kernel's shared memory to the block's limit once; 0, a CUDA
// error, or -3 where its registers at entry are not the 168 that
// setmaxnreg's exchange counts on.
template <typename Kernel>
int prepare_wgmma(Kernel kernel, bool check_registers) {
  int err = static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSharedBytes));
  if (err != 0 || !check_registers) return err;
  cudaFuncAttributes attributes;
  err = static_cast<int>(cudaFuncGetAttributes(&attributes, kernel));
  if (err != 0) return err;
  return attributes.numRegs == kEntryRegisters ? 0 : -3;
}

// How many clusters of `cluster` blocks with `smem_bytes` of shared memory
// the card holds at once (cudaOccupancyMaxActiveClusters), remembered by
// (cluster, shared bytes); -1 on an error.
int wgmma_clusters(int cluster, int smem_bytes) {
  struct Known {
    int cluster, smem_bytes, clusters;
  };
  static Known known[16];
  static int n_known = 0;
  for (int i = 0; i < n_known; ++i)
    if (known[i].cluster == cluster && known[i].smem_bytes == smem_bytes) return known[i].clusters;
  // every instance takes the same registers (168 a thread at entry) and threads: ask the first
  if (prepare_wgmma(fused_mlp_wgmma_kernel<kIdentity>, false) != 0) return -1;
  cudaLaunchAttribute attribute;
  const cudaLaunchConfig_t config = wgmma_config(cluster * 256, cluster, smem_bytes, nullptr, &attribute);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, fused_mlp_wgmma_kernel<kIdentity>, &config) != cudaSuccess ||
      clusters < 1)
    return -1;
  known[n_known % 16] = {cluster, smem_bytes, clusters};
  ++n_known;
  return clusters;
}

// The tensor map of W [N, K] at `w`, boxes of `box_rows` x 32 (encode_rows),
// remembered by (address, K, N, box): a map depends on nothing else.
bool wgmma_weight_map(CUtensorMap* map, const float* w, int K, int N, int box_rows) {
  struct Known {
    const float* w;
    int K, N, box_rows;
    CUtensorMap map;
  };
  static Known known[32];
  static int n_known = 0;
  for (int i = 0; i < std::min(n_known, 32); ++i) {
    const Known& k = known[i];
    if (k.w == w && k.K == K && k.N == N && k.box_rows == box_rows) {
      *map = k.map;
      return true;
    }
  }
  if (!encode_rows(map, w, K, N, 1, 0, box_rows)) return false;
  known[n_known % 32] = {w, K, N, box_rows, *map};
  ++n_known;
  return true;
}

// The grid of a wgmma launch over B rows: a block a row tile of 64, at most
// as many whole clusters as the card holds at once; -1 on an error.
int wgmma_grid(long long B, int cluster, int smem_bytes) {
  const int at_once = wgmma_clusters(cluster, smem_bytes);
  if (at_once < 1) return -1;
  const long long tiles = (B + kWgRows - 1) / kWgRows;
  return static_cast<int>(std::min<long long>((tiles + cluster - 1) / cluster, at_once) * cluster);
}

template <int kAct>
int launch_wgmma(WgmmaNet& net, int cluster, int smem_bytes, cudaStream_t stream, int* attr_err) {
  static int prepared = 1;  // 1: not yet; else prepare_wgmma's result
  if (prepared == 1) prepared = prepare_wgmma(fused_mlp_wgmma_kernel<kAct>, true);
  *attr_err = prepared;
  if (prepared != 0) return 0;
  const int grid = wgmma_grid(net.B, cluster, smem_bytes);
  if (grid < 1) {
    *attr_err = -1;
    return 0;
  }
  net.iters = static_cast<int>(((static_cast<long long>(net.B) + kWgRows - 1) / kWgRows + grid - 1) / grid);
  cudaLaunchAttribute attribute;
  const cudaLaunchConfig_t config = wgmma_config(grid, cluster, smem_bytes, stream, &attribute);
  const cudaError_t err = cudaLaunchKernelEx(&config, fused_mlp_wgmma_kernel<kAct>, net);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) over `groups` weight sets
// (1 for the ordinary launch). `dims` holds n_layers + 1 widths, `ws` and `bs`
// n_layers device pointers each, `w_set` and `b_set` n_layers set strides
// each (host arrays); `x_set` and `out_set` are the set strides of x and out.
// All strides count floats. Returns cudaGetLastError() of the launch and
// writes the code of the shared-memory attribute call to *attr_err; -1 for
// arguments the kernel does not take.
extern "C" int fused_mlp_forward(const float* x, float* out, int B, int n_layers,
                                 const int* dims, const void* const* ws,
                                 const void* const* bs, int act, int rows_per_block,
                                 int stride0, int stride1, int groups, long long x_set,
                                 long long out_set, const long long* w_set,
                                 const long long* b_set, void* stream, int* attr_err) {
  *attr_err = 0;
  if (n_layers < 1 || n_layers > kMaxLayers || act < kIdentity || act > kTanh) return -1;
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
  switch (rows_per_block) {
    case 32:
      return launch<2>(x, out, B, groups, net, s, attr_err);
    case 16:
      return launch<1>(x, out, B, groups, net, s, attr_err);
    default:
      return -1;
  }
}

// The streamed launch of one layer (fused_mlp_stream_kernel) on `stream`
// over `groups` weight sets: out [B, N] = act(x [B, K] . w [N, K]^T + b [N])
// per set, each tensor at its set stride in floats (0: shared by every set).
// `rows` rows a block (16, 32 or 64); a row tile's 128-wide output tiles
// split over `split` blocks (which must divide their count), in clusters of
// `cluster` of them (dividing split, at most 8); `copy` bit 0 sends x
// through bulk tensor copies and bit 1 W (the wrapper sets a bit only where
// the tensor's address, K and set stride are 16-byte multiples), each other
// tensor through the kernel's cp.async. Returns the launch's CUDA error code
// and writes the preparation's to *attr_err (-3: the 64-row block's
// registers at entry are not 168); -1 for arguments the kernel does not
// take, -2 where a tensor map could not be encoded.
extern "C" int fused_mlp_stream_forward(const float* x, float* out, int B, int K, int N, const float* w,
                                        const float* b, int act, int rows, int split, int cluster, int groups,
                                        long long x_set, long long out_set, long long w_set, long long b_set,
                                        int copy, void* stream, int* attr_err) {
  *attr_err = 0;
  if (act < kIdentity || act > kTanh || K < 1 || N < 1 || groups < 1 || groups > kMaxGroups) return -1;
  const int n_tiles = (N + TN - 1) / TN;
  if (split < 1 || n_tiles % split != 0 || cluster < 1 || cluster > kMaxCluster || split % cluster != 0) return -1;
  if (copy < 0 || copy > 3 || ((copy & 1) && !bulk_copies_take(x, K, x_set)) ||
      ((copy & 2) && !bulk_copies_take(w, K, w_set)))
    return -1;
  if (B <= 0) return 0;
  StreamLayer p = {x, w, b, out, x_set, w_set, b_set, out_set, B, K, N, act, split, n_tiles / split, copy};
  CUtensorMap x_map = {}, w_map = {};
  if ((copy & 1) && !encode_rows(&x_map, x, K, B, groups, x_set, rows)) return -2;
  if ((copy & 2) && !encode_rows(&w_map, w, K, N, groups, w_set, TN)) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 16:
      return launch_stream<16>(x_map, w_map, p, groups, cluster, s, attr_err);
    case 32:
      return launch_stream<32>(x_map, w_map, p, groups, cluster, s, attr_err);
    case 64:
      return launch_stream<64>(x_map, w_map, p, groups, cluster, s, attr_err);
    default:
      return -1;
  }
}

// The cluster launch of a held chain (fused_mlp_cluster_kernel) on
// `stream`: arguments as fused_mlp_forward's for one weight set, and the
// blocks a cluster (1 to 16). Returns the launch's CUDA error code and
// writes the attribute calls' to *attr_err; -1 for arguments the kernel
// does not take (shares of the weights that do not fit a block's shared
// memory among them).
extern "C" int fused_mlp_cluster_forward(const float* x, float* out, int B, int n_layers, const int* dims,
                                         const void* const* ws, const void* const* bs, int act, int cluster,
                                         int stride0, int stride1, void* stream, int* attr_err) {
  *attr_err = 0;
  if (n_layers < 1 || n_layers > kMaxLayers || act < kIdentity || act > kTanh) return -1;
  if (cluster < 1 || cluster > kMaxClusterBlocks) return -1;
  if (B <= 0) return 0;
  ClusterNet net = {};
  for (int l = 0; l < n_layers; ++l) {
    net.layer[l].w = static_cast<const float*>(ws[l]);
    net.layer[l].b = static_cast<const float*>(bs[l]);
    net.layer[l].K = dims[l];
    net.layer[l].N = dims[l + 1];
  }
  net.n_layers = n_layers;
  net.stride0 = stride0;
  net.stride1 = stride1;
  const int smem_bytes = cluster_layout(net, cluster);
  // beside the kernel's static table of layers
  if (smem_bytes + static_cast<int>(sizeof(ClusterLayerArgs)) * kMaxLayers > kMaxSharedBytes) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (act) {
#define FUSED_MLP_CLUSTER_LAUNCH(kAct) \
  case kAct:                           \
    return launch_cluster<kAct>(x, out, B, net, cluster, smem_bytes, s, attr_err);
    FUSED_MLP_CLUSTER_LAUNCH(kIdentity)
    FUSED_MLP_CLUSTER_LAUNCH(kRelu)
    FUSED_MLP_CLUSTER_LAUNCH(kElu)
    FUSED_MLP_CLUSTER_LAUNCH(kSelu)
    FUSED_MLP_CLUSTER_LAUNCH(kSoftplus)
    FUSED_MLP_CLUSTER_LAUNCH(kGelu)
    FUSED_MLP_CLUSTER_LAUNCH(kSigmoid)
    FUSED_MLP_CLUSTER_LAUNCH(kSilu)
    FUSED_MLP_CLUSTER_LAUNCH(kTanh)
#undef FUSED_MLP_CLUSTER_LAUNCH
    default:
      return -1;
  }
}

// An empty kernel at the grid, cluster and shared memory of a cluster launch
// over B rows (the floor under its time); the CUDA error code.
extern "C" int fused_mlp_cluster_empty(int B, int cluster, int smem_bytes, void* stream) {
  if (B <= 0 || cluster < 1 || cluster > kMaxClusterBlocks || smem_bytes < 0 || smem_bytes > kMaxSharedBytes)
    return -1;
  const int err = prepare_cluster(fused_mlp_cluster_empty_kernel, cluster, smem_bytes);
  if (err != 0) return err;
  cudaLaunchAttribute attribute;
  const cudaLaunchConfig_t config =
      cluster_config(B, cluster, smem_bytes, static_cast<cudaStream_t>(stream), &attribute);
  const cudaError_t launched = cudaLaunchKernelEx(&config, fused_mlp_cluster_empty_kernel);
  return static_cast<int>(launched != cudaSuccess ? launched : cudaGetLastError());
}

// How many clusters of `cluster` blocks of `rows` rows the card holds at
// once (cudaOccupancyMaxActiveClusters); -1 on an error.
extern "C" int fused_mlp_stream_clusters(int rows, int cluster) {
  if (cluster < 1 || cluster > kMaxCluster) return -1;
  switch (rows) {
    case 16:
      return stream_clusters<16>(cluster);
    case 32:
      return stream_clusters<32>(cluster);
    case 64:
      return stream_clusters<64>(cluster);
    default:
      return -1;
  }
}

// The sets launch of a grouped chain (fused_mlp_sets_kernel) on `stream`:
// arguments as fused_mlp_forward's, with `rows` the kernel's rows a set (1,
// 2, 4, 8 or 16; B at most that), `stages` the ring's depth (1 to 16) and
// `warps` the multiplying warps a set (1, 2, 4 or 8).
// Returns the launch's CUDA error code and writes the preparation's to
// *attr_err (-1 where the card holds no block of it); -1 for arguments the
// kernel does not take (a stage that does not fit a block's shared memory
// among them).
extern "C" int fused_mlp_sets_forward(const float* x, float* out, int B, int n_layers, const int* dims,
                                      const void* const* ws, const void* const* bs, int act, int rows, int stages,
                                      int warps, int groups, long long x_set, long long out_set,
                                      const long long* w_set, const long long* b_set, void* stream, int* attr_err) {
  *attr_err = 0;
  const SetsKernel kernel = sets_kernel(rows);
  if (kernel == nullptr || n_layers < 1 || n_layers > kMaxLayers || act < kIdentity || act > kTanh) return -1;
  if (groups < 1 || groups > kMaxGroups || stages < 1 || stages > kMaxSetsStages || B > rows) return -1;
  // every use of a stage falls to one group (stages a multiple of the groups): a group's wait on a stage's full
  // barrier by parity then never meets it two phases behind
  if (warps < 1 || warps > kSetsWarps || kSetsWarps % warps != 0 || stages % (kSetsWarps / warps) != 0) return -1;
  if (B <= 0) return 0;
  const long long most = kMaxSharedBytes / 4;  // floats a tensor's set may hold
  SetsNet net = {};
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1 || dims[l] > most) return -1;
    net.dims[l] = dims[l];
  }
  net.t[0] = {x, x_set, B * dims[0], 0};
  for (int l = 0; l < n_layers; ++l) {
    const long long w_floats = static_cast<long long>(dims[l + 1]) * dims[l];
    if (w_floats > most) return -1;
    net.t[1 + 2 * l] = {static_cast<const float*>(ws[l]), w_set[l], static_cast<int>(w_floats), 0};
    net.t[2 + 2 * l] = {static_cast<const float*>(bs[l]), b_set[l], dims[l + 1], 0};
  }
  net.out = out;
  net.out_set = out_set;
  net.n_layers = n_layers;
  net.act = act;
  net.B = B;
  net.groups = groups;
  net.stages = stages;
  net.group_warps = warps;
  const long long smem_bytes = sets_layout(net);
  if (smem_bytes + kSetsStaticBytes > kMaxSharedBytes) return -1;
  const int grid = sets_grid(kernel, groups, static_cast<int>(smem_bytes));
  if (grid < 1) {
    *attr_err = static_cast<int>(cudaGetLastError());
    if (*attr_err == 0) *attr_err = -1;
    return 0;
  }
  void* args[] = {&net};
  const cudaError_t err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(grid), dim3(kSetsThreads), args,
                                           static_cast<size_t>(smem_bytes), static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The grid of a sets launch of `rows` rows a set over `groups` sets with
// `smem_bytes` of dynamic shared memory (as fused_mlp_sets_forward launches
// it); -1 on an error.
extern "C" int fused_mlp_sets_grid(int rows, int groups, int smem_bytes) {
  const SetsKernel kernel = sets_kernel(rows);
  if (kernel == nullptr || groups < 1 || smem_bytes < 0 || smem_bytes + kSetsStaticBytes > kMaxSharedBytes) return -1;
  return sets_grid(kernel, groups, smem_bytes);
}

// An empty kernel of the sets kernel's block at `grid` blocks and
// `smem_bytes` of dynamic shared memory (the floor under a sets launch's
// time); the CUDA error code.
extern "C" int fused_mlp_sets_empty(int grid, int smem_bytes, void* stream) {
  if (grid < 1 || smem_bytes < 0 || smem_bytes + kSetsStaticBytes > kMaxSharedBytes) return -1;
  const int err = static_cast<int>(
      cudaFuncSetAttribute(fused_mlp_sets_empty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes));
  if (err != 0) return err;
  fused_mlp_sets_empty_kernel<<<grid, kSetsThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// The wgmma launch of a held chain (fused_mlp_wgmma_kernel) on `stream`:
// arguments as fused_mlp_forward's for one weight set, the blocks a cluster
// (1 or 2: a weight tile is multicast to them; clusters of 4 ran slower, in
// two waves, and once gave two calls that differed in their last bits) and
// the ring's slots (2 to 6). Each W_l whose address and rows are 16-byte multiples goes by bulk
// tensor copies, the others by the kernel's cp.async (ops/fused_mlp.py
// wgmma_copy). Returns the launch's CUDA error code and writes the
// preparation's to *attr_err (-3: the kernel's registers at entry are not
// 168; -1: the card holds no cluster of it); -1 for arguments the kernel
// does not take (a width past 256, a layout past a block's shared memory),
// -2 where a tensor map could not be encoded.
extern "C" int fused_mlp_wgmma_forward(const float* x, float* out, int B, int n_layers, const int* dims,
                                       const void* const* ws, const void* const* bs, int act, int cluster,
                                       int slots, void* stream, int* attr_err) {
  *attr_err = 0;
  if (n_layers < 1 || n_layers > kMaxLayers || act < kIdentity || act > kTanh) return -1;
  if ((cluster != 1 && cluster != 2) || slots < 2 || slots > kWgMaxSlots) return -1;
  if (B <= 0) return 0;
  WgmmaNet net = {};
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1 || dims[l] > kWgMaxWidth) return -1;
    net.dims[l] = dims[l];
  }
  net.x = x;
  net.out = out;
  net.n_layers = n_layers;
  net.B = B;
  net.slots = slots;
  const int smem_bytes = wgmma_layout(net);
  if (smem_bytes > kMaxSharedBytes) return -1;
  for (int l = 0; l < n_layers; ++l) {
    net.w[l] = static_cast<const float*>(ws[l]);
    net.b[l] = static_cast<const float*>(bs[l]);
    if (!bulk_copies_take(net.w[l], dims[l], 0)) {
      if (wg_stage_bytes(dims[l + 1], dims[l]) > 0 && (reinterpret_cast<uintptr_t>(net.w[l]) & 15) == 0)
        net.staged |= 1 << l;
      continue;
    }
    if (!wgmma_weight_map(&net.map[l], net.w[l], dims[l], dims[l + 1], wg_box(net.half[l]))) return -2;
    net.tma |= 1 << l;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (act) {
#define FUSED_MLP_WGMMA_LAUNCH(kAct) \
  case kAct:                         \
    return launch_wgmma<kAct>(net, cluster, smem_bytes, s, attr_err);
    FUSED_MLP_WGMMA_LAUNCH(kIdentity)
    FUSED_MLP_WGMMA_LAUNCH(kRelu)
    FUSED_MLP_WGMMA_LAUNCH(kElu)
    FUSED_MLP_WGMMA_LAUNCH(kSelu)
    FUSED_MLP_WGMMA_LAUNCH(kSoftplus)
    FUSED_MLP_WGMMA_LAUNCH(kGelu)
    FUSED_MLP_WGMMA_LAUNCH(kSigmoid)
    FUSED_MLP_WGMMA_LAUNCH(kSilu)
    FUSED_MLP_WGMMA_LAUNCH(kTanh)
#undef FUSED_MLP_WGMMA_LAUNCH
    default:
      return -1;
  }
}

// The grid of a wgmma launch over B rows in clusters of `cluster` with
// `smem_bytes` of dynamic shared memory (wgmma_grid); -1 on an error.
extern "C" int fused_mlp_wgmma_grid(int B, int cluster, int smem_bytes) {
  if (B <= 0 || (cluster != 1 && cluster != 2) || smem_bytes < 0 || smem_bytes > kMaxSharedBytes)
    return -1;
  return wgmma_grid(B, cluster, smem_bytes);
}

// An empty kernel at the grid, cluster and shared memory of a wgmma launch
// over B rows (the floor under its time); the CUDA error code.
extern "C" int fused_mlp_wgmma_empty(int B, int cluster, int smem_bytes, void* stream) {
  const int grid = fused_mlp_wgmma_grid(B, cluster, smem_bytes);
  if (grid < 1) return -1;
  const int err = prepare_wgmma(fused_mlp_wgmma_empty_kernel, false);
  if (err != 0) return err;
  cudaLaunchAttribute attribute;
  const cudaLaunchConfig_t config =
      wgmma_config(grid, cluster, smem_bytes, static_cast<cudaStream_t>(stream), &attribute);
  const cudaError_t launched = cudaLaunchKernelEx(&config, fused_mlp_wgmma_empty_kernel);
  return static_cast<int>(launched != cudaSuccess ? launched : cudaGetLastError());
}
