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
// Bound: the kernel moves each input once and writes adv once. At the main
// path's shape (T=16, N=8192, V=1) that is r, v, adv and dones at 524,288 B
// each plus last_values and last_dones at 32,768 B each: 2,162,688 B, about
// 0.65 us at 3.35 TB/s. Its arithmetic (8 flops per element) is negligible.
// It is built with -fmad=false, so each product and sum rounds as in the
// plain PyTorch version (ops/gae.py gae_plain).
// A launch costs several microseconds, so launch latency, not memory, sets
// its time; the design accepts that, since GAE runs once per epoch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void gae_kernel(const float* __restrict__ r,
                           const float* __restrict__ v,
                           const float* __restrict__ d,
                           const float* __restrict__ lv,
                           const float* __restrict__ ld,
                           float* __restrict__ adv,
                           int T, int N, int V, float gamma, float lam) {
  const long long M = static_cast<long long>(N) * V;
  const long long c = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= M) return;
  const int env = static_cast<int>(c / V);
  const float gl = gamma * lam;
  float next_v = lv[c];
  float nnt = 1.0f - ld[env];
  float lastgaelam = 0.0f;
  for (int t = T - 1; t >= 0; --t) {
    const long long idx = static_cast<long long>(t) * M + c;
    const float v_t = v[idx];
    const float delta = r[idx] + gamma * next_v * nnt - v_t;
    lastgaelam = delta + gl * nnt * lastgaelam;
    adv[idx] = lastgaelam;
    next_v = v_t;
    // dones[t] enter step t, so they gate the step t-1 -> t
    nnt = 1.0f - d[static_cast<long long>(t) * N + env];
  }
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
  const long long blocks = (M + kThreads - 1) / kThreads;
  gae_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(r, v, d, lv, ld, adv, T, N,
                                                     V, gamma, lam);
  return static_cast<int>(cudaGetLastError());
}
