// Fully-fused sequential MLP forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fused_kernel` in rl_games_tpu/ops/fused_mlp.py
// (launched by `fused_mlp_pallas`). One launch computes, for every row of x,
//
//   h_0 = x;   h_{l+1} = act(h_l . W_l^T + b_l)   for l = 0 .. L-1;   out = h_L
//
// with the activation applied after every layer, the last one too. x is
// [B, D_0], W_l is [D_{l+1}, D_l] (torch.nn.Linear's layout, the input index
// contiguous), b_l is [D_{l+1}], out is [B, D_L], all contiguous float32.
// Products accumulate in float32 FMAs; no tensor cores.
//
// Design. A block of 256 threads owns a tile of TM = 16*RM rows (RM = 4, 2
// or 1) and walks the whole chain for it, so the intermediate activations
// never leave the SM: they alternate between two shared-memory buffers, one
// for the even-numbered widths D_0, D_2, .. and one for the odd-numbered
// ones, each as wide as the widest layer it holds; the last layer's result
// goes straight from registers to `out`. Nothing is padded in device memory
// (the TPU wrapper pads every width to 128 lanes and the batch to the tile):
// ragged rows, columns and depths are masked by index, and what the masks
// leave in shared memory is written as zero so that it multiplies to zero.
//
// Weights stay in device memory (the flagship torso's 190 KB live in L2) and
// are staged through shared memory in tiles of TN = 64 outputs by TK = 32
// inputs. A warp reads 32 consecutive inputs of one output row, so the
// [out, in] layout loads coalesced without a transposed copy; the tile keeps
// that orientation with a row stride of 36 floats, which makes the 16-byte
// reads of the product loop conflict-free. The next tile's global loads are
// started into registers before the current tile's products, so they overlap;
// a full tile's product loop is unrolled.
// Each thread owns RM rows x 4 columns (columns tx, tx+16, tx+32, tx+48) and
// reads both operands as float4 along the input index: per 4 inputs it
// makes RM + 4 shared loads for 16*RM FMAs.
//
// Bound. At the flagship torso 26 -> 256 -> 128 -> 64 the chain costs
// 2 * 47,616 flop per row: 780,140,544 flop at B = 8192 (11.6 us at the
// card's 67 TFLOP/s of float32 outside the tensor cores) against 3,141,376
// bytes moved (0.94 us at 3.35 TB/s); at B = 32768, 46.6 us against 3.6 us.
// Operations bound it, and the design spends its shared-memory traffic
// accordingly (register tiles, vector loads) rather than saving bytes. What
// holds it below the bound is shared-memory bandwidth: RM + 4 shared loads
// of 16 bytes for every 16*RM FMAs of a thread. Weight tiles of 64 inputs, a second tile buffer
// and blocks of 128 threads were tried and changed its time by under a
// tenth; a larger register tile over input-major buffers is the next step.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kThreads = 256;
constexpr int kRowGroups = kThreads / 16;
constexpr int TN = 64;       // output columns per weight tile
constexpr int TK = 32;       // inputs per weight tile
constexpr int WS = TK + 4;   // weight tile row stride: 36 = 4 * odd
constexpr int kWLoads = TN * TK / kThreads;  // weight elements a thread stages

struct Net {
  const float* w[kMaxLayers];
  const float* b[kMaxLayers];
  int dims[kMaxLayers + 1];
  int n_layers;
  int act;
  int stride0;  // row stride (floats, multiple of 4) of the even-width buffer
  int stride1;  // same for the odd-width buffer
};

enum Act { kIdentity = 0, kRelu, kElu, kSelu, kSoftplus, kGelu, kSigmoid, kSilu, kTanh };

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case kRelu:
      return fmaxf(x, 0.0f);
    case kElu:
      return x > 0.0f ? x : expm1f(x);
    case kSelu:
      return 1.0507009873554805f * (x > 0.0f ? x : 1.6732632423543772f * expm1f(x));
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

// Element i of the thread's share of the weight tile at (n0, k0): outputs
// n0 .. n0+63 by inputs k0 .. k0+31 of W [N, K]; zero outside the matrix.
__device__ __forceinline__ void load_w_tile(float (&reg)[kWLoads], const float* __restrict__ W,
                                            int N, int K, int n0, int k0, int tid) {
#pragma unroll
  for (int i = 0; i < kWLoads; ++i) {
    const int idx = tid + i * kThreads;
    const int n = n0 + idx / TK;
    const int k = k0 + idx % TK;
    reg[i] = (n < N && k < K) ? W[static_cast<size_t>(n) * K + k] : 0.0f;
  }
}

__device__ __forceinline__ void store_w_tile(float* ws, const float (&reg)[kWLoads], int tid) {
#pragma unroll
  for (int i = 0; i < kWLoads; ++i) {
    const int idx = tid + i * kThreads;
    ws[(idx / TK) * WS + idx % TK] = reg[i];
  }
}

// acc[i][j] += sum over 4 inputs of a[row i][k] * w[column tx + 16 j][k]
template <int RM>
__device__ __forceinline__ void product_step(float (&acc)[RM][4], const float* a_row, int s_in,
                                             const float* w_row) {
  float4 a[RM];
  float4 w[4];
#pragma unroll
  for (int i = 0; i < RM; ++i) a[i] = *reinterpret_cast<const float4*>(a_row + i * s_in);
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] = *reinterpret_cast<const float4*>(w_row + 16 * j * WS);
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[i][j] = fmaf(a[i].x, w[j].x, acc[i][j]);
      acc[i][j] = fmaf(a[i].y, w[j].y, acc[i][j]);
      acc[i][j] = fmaf(a[i].z, w[j].z, acc[i][j]);
      acc[i][j] = fmaf(a[i].w, w[j].w, acc[i][j]);
    }
}

template <int RM>
__global__ void __launch_bounds__(kThreads)
fused_mlp_kernel(const float* __restrict__ x, float* __restrict__ out, int B, Net net) {
  constexpr int TM = kRowGroups * RM;
  extern __shared__ __align__(16) float smem[];
  float* buf0 = smem;
  float* buf1 = buf0 + TM * net.stride0;
  float* ws = buf1 + TM * net.stride1;

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // column group
  const int ty = tid >> 4;   // row group: rows ty*RM .. ty*RM + RM-1
  const long long row0 = static_cast<long long>(blockIdx.x) * TM;

  // the tile's rows of x are one contiguous run in device memory
  {
    const int D0 = net.dims[0];
    const int D0p = (D0 + 3) & ~3;
    for (int idx = tid; idx < TM * D0p; idx += kThreads) {
      const int r = idx / D0p;
      const int c = idx - r * D0p;
      const long long row = row0 + r;
      float v = 0.0f;
      if (c < D0 && row < B) v = x[row * D0 + c];
      buf0[r * net.stride0 + c] = v;
    }
  }
  __syncthreads();

  float* in = buf0;
  float* nxt = buf1;
  int s_in = net.stride0;
  int s_out = net.stride1;

  for (int l = 0; l < net.n_layers; ++l) {
    const int K = net.dims[l];
    const int N = net.dims[l + 1];
    const int Kp = (K + 3) & ~3;
    const int Np = (N + 3) & ~3;
    const float* __restrict__ W = net.w[l];
    const float* __restrict__ bias = net.b[l];
    const bool last = (l == net.n_layers - 1);
    const int nK = (K + TK - 1) / TK;
    const int nN = (N + TN - 1) / TN;
    const int tiles = nK * nN;

    float wreg[kWLoads];
    load_w_tile(wreg, W, N, K, 0, 0, tid);
    float acc[RM][4];

    for (int t = 0; t < tiles; ++t) {
      const int nc = t / nK;
      const int kc = t - nc * nK;
      const int n0 = nc * TN;
      const int k0 = kc * TK;
      store_w_tile(ws, wreg, tid);
      __syncthreads();
      if (t + 1 < tiles) {
        const int nc1 = (t + 1) / nK;
        const int kc1 = (t + 1) - nc1 * nK;
        load_w_tile(wreg, W, N, K, nc1 * TN, kc1 * TK, tid);
      }

      if (kc == 0) {
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
      }

      // inputs beyond Kp were never written in `in`: stop there (the weight
      // tile is zero from K on, and `in` is zero from K to Kp)
      const int kmax = min(TK, Kp - k0);
      const float* a_row = in + (ty * RM) * s_in + k0;
      const float* w_row = ws + tx * WS;
      if (kmax == TK) {
#pragma unroll
        for (int kk = 0; kk < TK; kk += 4) product_step<RM>(acc, a_row + kk, s_in, w_row + kk);
      } else {
        for (int kk = 0; kk < kmax; kk += 4) product_step<RM>(acc, a_row + kk, s_in, w_row + kk);
      }

      if (kc == nK - 1) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + tx + 16 * j;
          const float bj = (n < N) ? bias[n] : 0.0f;
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const int r = ty * RM + i;
            const float y = activate(acc[i][j] + bj, net.act);
            if (last) {
              const long long row = row0 + r;
              if (row < B && n < N) out[row * N + n] = y;
            } else if (n < Np) {
              nxt[r * s_out + n] = (n < N) ? y : 0.0f;
            }
          }
        }
      }
      __syncthreads();  // the tile is consumed; `nxt` is complete after the last one
    }

    float* done = nxt;
    nxt = in;
    in = done;
    const int s = s_in;
    s_in = s_out;
    s_out = s;
  }
}

template <int RM>
int launch(const float* x, float* out, int B, const Net& net, int smem_bytes,
           cudaStream_t stream, int* attr_err) {
  constexpr int TM = kRowGroups * RM;
  *attr_err = static_cast<int>(cudaFuncSetAttribute(
      fused_mlp_kernel<RM>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes));
  if (*attr_err != 0) return 0;
  const unsigned int blocks = static_cast<unsigned int>((static_cast<long long>(B) + TM - 1) / TM);
  fused_mlp_kernel<RM><<<blocks, kThreads, smem_bytes, stream>>>(x, out, B, net);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory for a tile of `rows` rows: both activation buffers and one
// weight tile, in bytes (ops/fused_mlp.py kernel_plan computes the same).
int smem_bytes_for(int rows, int stride0, int stride1) {
  return 4 * (rows * (stride0 + stride1) + TN * WS);
}

}  // namespace

// Launches on `stream` (PyTorch's current stream). `dims` holds n_layers + 1
// widths, `ws` and `bs` n_layers device pointers each (host arrays). Returns
// cudaGetLastError() of the launch and writes the code of the shared-memory
// attribute call to *attr_err; -1 for arguments the kernel does not take.
extern "C" int fused_mlp_forward(const float* x, float* out, int B, int n_layers,
                                 const int* dims, const void* const* ws,
                                 const void* const* bs, int act, int rows_per_block,
                                 int stride0, int stride1, void* stream, int* attr_err) {
  *attr_err = 0;
  if (n_layers < 1 || n_layers > kMaxLayers) return -1;
  if (B <= 0) return 0;
  Net net = {};
  for (int l = 0; l < n_layers; ++l) {
    net.w[l] = static_cast<const float*>(ws[l]);
    net.b[l] = static_cast<const float*>(bs[l]);
  }
  for (int l = 0; l <= n_layers; ++l) net.dims[l] = dims[l];
  net.n_layers = n_layers;
  net.act = act;
  net.stride0 = stride0;
  net.stride1 = stride1;
  const int smem_bytes = smem_bytes_for(rows_per_block, stride0, stride1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows_per_block / kRowGroups) {
    case 4:
      return launch<4>(x, out, B, net, smem_bytes, s, attr_err);
    case 2:
      return launch<2>(x, out, B, net, smem_bytes, s, attr_err);
    case 1:
      return launch<1>(x, out, B, net, smem_bytes, s, attr_err);
    default:
      return -1;
  }
}
