// Generalized Advantage Estimation for Hopper (sm_90a).
//
// Replaces the TPU kernel `_gae_pallas_kernel` in rl_games_tpu/ops/gae.py
// (launched by `gae_pallas`). For each (env, value) column c in [0, N*V) it
// sweeps t = T-1 .. 0, carrying (lastgaelam, next_v) in registers:
//
//   nnt_t   = 1 - dones[t+1, env]        (last row: 1 - last_dones[env])
//   delta   = r[t,c] + gamma * next_v * nnt_t - v[t,c]
//   adv[t,c] = lastgaelam = delta + gamma*lam * nnt_t * lastgaelam
//   next_v  = v[t,c]                     (first carry: last_values[c])
//
// Layout: r, v, adv are [T, N, V] and dones [T, N], all contiguous f32, so
// element (t, c) of a [T, N*V] view sits at t*N*V + c; last_values [N, V],
// last_dones [N]. One thread owns one column. In each row t neighbouring
// threads read neighbouring addresses, so every load and store is
// coalesced. Dones are read directly as dones[t, c / V]: unlike the TPU
// wrapper there is no nnt array, no fold and no padding to 128 lanes; the
// ragged last block is masked.
//
// What bounds it on this card: by bytes it is nothing (each input read once
// and adv written once: 2,162,688 B at T=16, N=8192, V=1), so its time is
// latency: the launch itself, which no kernel can go below (the empty kernel
// at the bottom of this file measures it over the same grid), and the trips
// to memory inside one thread's sweep. The recurrence is serial in t, but
// only the carry is: no load depends on it. So the sweep takes its rows 16
// (then 8) at a time, issues all of a chunk's loads into registers before the
// chunk's carried arithmetic, and pays one trip to memory per chunk, not one
// per row; rows beyond the last full chunk go one by one. Blocks are 64
// threads wide so that the main path's 8192 columns make 128 blocks for the
// card's 132 SMs, and V = 1 (the main path) skips the c / V division.
//
// It is built with -fmad=false and keeps the order of every product and sum,
// so each rounds as in the plain PyTorch version (ops/gae.py gae_plain) and
// the two agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;

// Rows t_top-1 .. t_top-kRows of column c: every load first, then the carry.
template <int kRows>
__device__ __forceinline__ void sweep_rows(const float* __restrict__ r,
                                           const float* __restrict__ v,
                                           const float* __restrict__ d,
                                           float* __restrict__ adv, long long M, int N,
                                           long long c, int env, int t_top, float gamma,
                                           float gl, float& next_v, float& nnt,
                                           float& lastgaelam) {
  float r_t[kRows], v_t[kRows], d_t[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const long long t = t_top - 1 - i;
    v_t[i] = v[t * M + c];
    r_t[i] = r[t * M + c];
    d_t[i] = d[t * N + env];
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const long long t = t_top - 1 - i;
    const float delta = r_t[i] + gamma * next_v * nnt - v_t[i];
    lastgaelam = delta + gl * nnt * lastgaelam;
    adv[t * M + c] = lastgaelam;
    next_v = v_t[i];
    // dones[t] enter step t, so they gate the step t-1 -> t
    nnt = 1.0f - d_t[i];
  }
}

__global__ void __launch_bounds__(kThreads)
gae_kernel(const float* __restrict__ r, const float* __restrict__ v,
           const float* __restrict__ d, const float* __restrict__ lv,
           const float* __restrict__ ld, float* __restrict__ adv, int T, int N, int V,
           float gamma, float lam) {
  const long long M = static_cast<long long>(N) * V;
  const long long c = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= M) return;
  // the 64-bit division is a routine of some hundred instructions; V = 1
  // (the main path) goes round it
  const int env = static_cast<int>(V == 1 ? c : c / V);
  const float gl = gamma * lam;
  float next_v = lv[c];
  float nnt = 1.0f - ld[env];
  float lastgaelam = 0.0f;
  int t = T;
  for (; t >= 16; t -= 16)
    sweep_rows<16>(r, v, d, adv, M, N, c, env, t, gamma, gl, next_v, nnt, lastgaelam);
  if (t >= 8) {
    sweep_rows<8>(r, v, d, adv, M, N, c, env, t, gamma, gl, next_v, nnt, lastgaelam);
    t -= 8;
  }
  for (; t > 0; --t)
    sweep_rows<1>(r, v, d, adv, M, N, c, env, t, gamma, gl, next_v, nnt, lastgaelam);
}

// Does nothing: its time over GAE's grid is what a launch alone costs.
__global__ void __launch_bounds__(kThreads) empty_kernel() {}

unsigned int blocks_for(long long columns) {
  return static_cast<unsigned int>((columns + kThreads - 1) / kThreads);
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError(): a refused launch never runs, and only this code says so.
extern "C" int gae_forward(const float* r, const float* v, const float* d,
                           const float* lv, const float* ld, float* adv,
                           int T, int N, int V, float gamma, float lam,
                           void* stream) {
  const long long M = static_cast<long long>(N) * V;
  if (T <= 0 || M <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gae_kernel<<<blocks_for(M), kThreads, 0, s>>>(r, v, d, lv, ld, adv, T, N, V, gamma, lam);
  return static_cast<int>(cudaGetLastError());
}

// The empty kernel over the grid that gae_forward takes for N * V columns:
// the floor that launch latency sets under any single launch of that grid.
extern "C" int gae_empty_launch(int N, int V, void* stream) {
  const long long M = static_cast<long long>(N) * V;
  if (M <= 0) return 0;
  empty_kernel<<<blocks_for(M), kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
