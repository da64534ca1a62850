// DSGD stratum sweep for NVIDIA Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the two TPU kernels of the JAX package's ops/pallas_sgd.py:
//   _sweep_kernel   (ops/pallas_sgd.py:172, one (stratum, block) visit)
//   _stratum_kernel (ops/pallas_sgd.py:440, all k visits of one stratum)
// Both apply one λ/ω minibatch rule. For each minibatch g of the stratum, in
// order, and for every entry of it:
//   gather u = U[su], v = V[si]                   (all reads before any write)
//   e  = (r − u·v)·w
//   du = η·(e·v − (λ/max(ω_u,1))·u·w)·icu,   dv symmetrically
//   scatter-add du into U[su], dv into V[si]     (duplicates accumulate;
//                                                 minibatch g+1 sees g's writes)
//
// Design. The k block visits of a stratum are row-disjoint in U and in V, so
// minibatch g of every visit runs at once: each minibatch step is two
// launches over a grid of (mb / 8) x k blocks of 8 warps, one warp per entry
// with the lanes over the rank.
//   sgd_delta_kernel   gathers the f32 rows straight from global memory,
//                      reduces the dot with warp shuffles and writes du/dv
//                      into a [k, mb, r] f32 scratch.
//   sgd_scatter_kernel adds the scratch into U and V with f32 atomicAdd.
// The launch boundary between the two gives "all gathers before any write";
// the next step's delta launch sees this step's writes. Entries of weight 0
// (padding) gather nothing, write zero deltas and are skipped by the scatter,
// so a padding entry's row 0 is never touched from another visit. Row indices
// are global table rows.
//
// Atomics: duplicate rows inside a minibatch are summed with atomicAdd in an
// order that changes from run to run, so results agree with a sequential
// scatter only to f32 rounding (the tolerance is stated in the tests and in
// PERF.md).
//
// Bound. The function of one minibatch step (all k visits) must read each
// distinct U and V row it touches once, with its ω, write each of them back
// once, and read 24 B of streams per entry (su, si, r, w, icu, icv). At the
// bench geometry (k 8, mb 32,768, rank 128 f32, ~173k distinct rows per
// step) that is ~185 MB, ~0.055 ms at the H100's 3.35 TB/s; the f32
// operations (~12·rank per entry) are far below the card's rate.
// What this design moves instead, per real entry: 2 row gathers, 2 row
// read-modify-writes by atomics, and the du/dv scratch written and read back
// (10 rows of 512 B at rank 128 f32), ~5.1 KB, ~1.5 ms per million ratings.
// The scratch round trip and the per-entry (not per-row) traffic are costs
// of the two-launch design, not of the function. The design is latency-bound
// on the random row gathers and atomics; it makes no attempt at TMA or
// shared-memory staging.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;     // entries (warps) per thread block
constexpr int kMaxCols = 8;   // columns per lane: rank <= 32 * kMaxCols

__global__ void sgd_delta_kernel(
    const float* __restrict__ U, const float* __restrict__ V,
    const int32_t* __restrict__ su, const int32_t* __restrict__ si,
    const float* __restrict__ sv, const float* __restrict__ sw,
    const float* __restrict__ icu, const float* __restrict__ icv,
    const float* __restrict__ omega_u, const float* __restrict__ omega_v,
    float* __restrict__ du, float* __restrict__ dv,
    int64_t block_stride, int64_t g_off, int mb, int rank,
    float lr, float lam) {
  const int p = blockIdx.y;
  const int j = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (j >= mb) return;
  const int64_t e = (int64_t)p * block_stride + g_off + j;
  float* du_row = du + ((int64_t)p * mb + j) * rank;
  float* dv_row = dv + ((int64_t)p * mb + j) * rank;
  const float w = sw[e];
  if (w == 0.0f) {  // padding: no gather, zero deltas
    for (int c = lane; c < rank; c += 32) {
      du_row[c] = 0.0f;
      dv_row[c] = 0.0f;
    }
    return;
  }
  const int64_t ru = su[e];
  const int64_t ri = si[e];
  const float* u_row = U + ru * rank;
  const float* v_row = V + ri * rank;

  float u[kMaxCols], v[kMaxCols];
  float dot = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxCols; ++i) {
    const int c = lane + 32 * i;
    u[i] = c < rank ? u_row[c] : 0.0f;
    v[i] = c < rank ? v_row[c] : 0.0f;
    dot += u[i] * v[i];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    dot += __shfl_xor_sync(0xffffffffu, dot, off);

  const float err = (sv[e] - dot) * w;
  const float reg_u = lam / fmaxf(omega_u[ru], 1.0f);
  const float reg_v = lam / fmaxf(omega_v[ri], 1.0f);
  const float cu = icu[e];
  const float cv = icv[e];
#pragma unroll
  for (int i = 0; i < kMaxCols; ++i) {
    const int c = lane + 32 * i;
    if (c < rank) {
      du_row[c] = (lr * (err * v[i] - reg_u * u[i] * w)) * cu;
      dv_row[c] = (lr * (err * u[i] - reg_v * v[i] * w)) * cv;
    }
  }
}

__global__ void sgd_scatter_kernel(
    float* __restrict__ U, float* __restrict__ V,
    const int32_t* __restrict__ su, const int32_t* __restrict__ si,
    const float* __restrict__ sw,
    const float* __restrict__ du, const float* __restrict__ dv,
    int64_t block_stride, int64_t g_off, int mb, int rank) {
  const int p = blockIdx.y;
  const int j = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (j >= mb) return;
  const int64_t e = (int64_t)p * block_stride + g_off + j;
  if (sw[e] == 0.0f) return;  // padding never touches a table row
  float* u_row = U + (int64_t)su[e] * rank;
  float* v_row = V + (int64_t)si[e] * rank;
  const float* du_row = du + ((int64_t)p * mb + j) * rank;
  const float* dv_row = dv + ((int64_t)p * mb + j) * rank;
  for (int c = lane; c < rank; c += 32) {
    atomicAdd(u_row + c, du_row[c]);
    atomicAdd(v_row + c, dv_row[c]);
  }
}

dim3 step_grid(int mb, int k) {
  return dim3((unsigned)((mb + kWarps - 1) / kWarps), (unsigned)k);
}

}  // namespace

// Plain C entry points. The stratum's streams are passed at their stratum-s
// base (su[s] of the [k, k, b] layout): visit p's entries start at
// p * block_stride, minibatch g at g_off = g * mb. Each returns
// cudaGetLastError() of its launch.
extern "C" int dsgd_sweep_max_rank() { return 32 * kMaxCols; }

extern "C" int sgd_delta_launch(
    const void* U, const void* V, const void* su, const void* si,
    const void* sv, const void* sw, const void* icu, const void* icv,
    const void* omega_u, const void* omega_v, void* du, void* dv,
    int64_t block_stride, int64_t g_off, int mb, int rank, int k,
    float lr, float lam, void* stream) {
  sgd_delta_kernel<<<step_grid(mb, k), kWarps * 32, 0,
                     (cudaStream_t)stream>>>(
      (const float*)U, (const float*)V, (const int32_t*)su,
      (const int32_t*)si, (const float*)sv, (const float*)sw,
      (const float*)icu, (const float*)icv, (const float*)omega_u,
      (const float*)omega_v, (float*)du, (float*)dv, block_stride, g_off,
      mb, rank, lr, lam);
  return (int)cudaGetLastError();
}

extern "C" int sgd_scatter_launch(
    void* U, void* V, const void* su, const void* si, const void* sw,
    const void* du, const void* dv, int64_t block_stride, int64_t g_off,
    int mb, int rank, int k, void* stream) {
  sgd_scatter_kernel<<<step_grid(mb, k), kWarps * 32, 0,
                       (cudaStream_t)stream>>>(
      (float*)U, (float*)V, (const int32_t*)su, (const int32_t*)si,
      (const float*)sw, (const float*)du, (const float*)dv, block_stride,
      g_off, mb, rank);
  return (int)cudaGetLastError();
}
