// One ALS half-step for NVIDIA Hopper (sm_90a), bound to Python with ctypes
// (ops/als.py::als_solve).
//
// Replaces no TPU kernel: the JAX package solves ALS's normal equations with
// XLA ops (large_scale_recommendation_tpu/ops/als.py::solve_side: padded
// gathers, batched einsum grams, jnp.linalg.cholesky and two triangular
// solves). The port did the same with torch ops, which wrote every padded
// gather [rc, pad, k], a weighted copy of it and a [rc, k, k] gram to device
// memory (14.5 GB of grams a round at ML-25M, rank 128) and passed over the
// grams three more times (the ridge, cholesky_ex's zeroed upper half,
// cuSOLVER's batched potrf and trsm). This kernel solves each row in one
// block, and nothing but the solution leaves the SM.
//
// What it computes, for each solved row (one block a row, rows longest
// first, as the CSR plan orders them): with the row's partners j, their rows
// v_j of the fixed table F [n_other, k], b-weights a_j and gram weights w_j
// (1 where the plan has none),
//   A = G + Σ_j w_j v_j v_jᵀ + λ·max(s, 1)·I,   b = Σ_j a_j v_j,   A x = b
// (G the implicit route's whole-table gram, 0 otherwise; s the row's ω
// under ALS-WR, else 1), in f32 throughout (CUDA-core FMAs, no TF32), and
// writes x to the row of `out`. Rows with no entries are not in the plan and
// stay 0 (the wrapper zeroes `out`). A pivot that is ≤ 0 or not finite
// makes the row NaN, as the bucketed route's cholesky_ex does. Every sum
// runs in one fixed order and nothing uses atomics, so two launches are
// bit-equal.
//
// What bounds it on this card. A round at ML-25M (23.75M ratings, 221,588
// solved rows, rank 128) needs about 4.0e11 FMAs for the lower grams and
// right-hand sides and 0.8e11 for the factorisations and solves: ~14 ms at
// 67 TFLOP/s. Its bytes are the partner rows, 12 GB a half-step gathered
// through the 50 MB L2 (the fixed table is 30 or 83 MB), under 4 ms even
// from HBM. So the CUDA cores' FMA issue bounds it, and with it the shared
// memory that feeds them and the factorisation's chain of 16 dependent
// panel steps. On an H100 a round takes ~42 ms: the gram issues FMAs at
// about half the peak rate (a row's 8 operands per 64 FMAs come from shared
// memory), and each panel step waits on shared-memory latency. The design:
//
//   * 5 warps a block. Warps 0–3 own the 120 strictly-lower 8×8 tiles of
//     the 128×128 gram, one tile a lane, 64 accumulators in registers: warp
//     0 rows 64–95 × columns 0–63, warp 1 rows 96–127 × columns 0–63 (4 × 8
//     tiles each), warps 2 and 3 the two triangles of 28 tiles below the
//     diagonal blocks (lanes 28–31 idle). Warp 4 owns the 16 diagonal
//     tiles' lower triangles, two lanes a tile and 18 entries a lane, and
//     the right-hand side b, 4 rows a lane. Only the lower triangle is
//     formed (8,256 of 16,384 entries).
//   * A lane's diagonal half: the even lane of a tile takes 18 pairs
//     {r, s} of the tile's 8 columns, the odd lane the same pairs shifted by
//     one column ({r+1, s+1} mod 8). Both run one instruction stream on
//     operands the odd lane loads rotated by one, and the two halves cover
//     the 36 lower entries once.
//   * The partner rows come through a 2-stage ring of 32 rows in shared
//     memory (cp.async, 16 bytes a copy where k is a multiple of 4; a
//     stage's column indices are loaded first, then its copies issued).
//     A ring row's 16-byte chunks are stored at chunk ^ ((chunk >> 3) & 1),
//     so the 8 distinct column tiles a warp reads at once fall in 8
//     distinct bank groups: a tile load is one shared-memory wavefront.
//   * The factorisation is right-looking in 8-column panels, in shared
//     memory: the gram's tiles are stored (transposed, 68 floats a tile)
//     over the ring's memory. For panel p, one lane of warp 4 factors the
//     8×8 diagonal tile (its pivots checked; reciprocals kept), warps 0–3
//     solve the rows below it, a row a thread, and then give every
//     trailing tile its rank-8 update in 4×4 quarters spread evenly over
//     their 128 threads (32 FMAs per 2 shared-memory loads), while warp 4
//     updates tile (p + 1, p + 1) first and factors it. Two barriers a
//     panel. The factor stays in the store for the solves.
//   * The forward and back solves run in warp 4, b in its registers (4
//     rows a lane), by 8-row panels: each lane takes the panel's values by
//     shuffles and solves its 8×8 triangle itself, then the lanes of the
//     other tiles take the panel's rank-8 update.
//   * Load balance: rows longest first (the plan's order), one block a
//     row, so the last blocks to start are the shortest. 38 KB of shared
//     memory and 96 registers a thread put 4 blocks (20 warps) on an SM,
//     so one block's factorisation and solves overlap others' grams: the
//     phases outside the gram wait on shared-memory latency, and a fourth
//     block (a few registers spilled) beat three without spills by ~11%.
//
// k < 128 runs the same tiles with the columns past k zero and a ridge on
// their diagonal (they solve to 0 and do not touch the real columns); tiles
// wholly past k do nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 128;
constexpr int kTiles = kMaxK / 8;             // 8×8 tiles a side
constexpr int kThreads = 160;                 // 5 warps
constexpr int kChunk = 32;                    // partner rows a stage
constexpr int kStages = 2;
constexpr int kTileStride = 68;               // floats a stored factor tile
constexpr int kLTiles = kTiles * (kTiles + 1) / 2;
constexpr int kRing = kStages * kChunk * kMaxK;
constexpr int kStore = kLTiles * kTileStride;
constexpr int kBig = kRing > kStore ? kRing : kStore;
// 16-byte copies a stage, at most, per thread
constexpr int kCopies = (kChunk * 32 + kThreads - 1) / kThreads;

// A ring row's 16-byte chunk ch lives at chunk swz(ch).
__device__ __forceinline__ int swz(int ch) { return ch ^ ((ch >> 3) & 1); }
__device__ __forceinline__ int swz_f(int f) {
  return (swz(f >> 2) << 2) | (f & 3);
}

// Packed lower tiles, row-major by tile row.
__device__ __forceinline__ int tile_of(int I, int J) {
  return I * (I + 1) / 2 + J;
}

// The diagonal half of a lane: pair m is {a, b} of the tile's columns
// (groups of column distance 0, 1, 2, 3 and 4), shifted by one on odd lanes.
__host__ __device__ constexpr int pair_group(int m) {
  return m < 16 ? m / 4 : 4;
}
__host__ __device__ constexpr int pair_a(int m) {
  return 2 * (m - 4 * pair_group(m));
}
__host__ __device__ constexpr int pair_b(int m) {
  return (pair_a(m) + pair_group(m)) & 7;
}
// Position (row · 8 + column, row ≥ column) of pair m in the tile.
__host__ __device__ constexpr int pair_pos(int m, int par) {
  const int a = (pair_a(m) + par) & 7, b = (pair_b(m) + par) & 7;
  return a >= b ? a * 8 + b : b * 8 + a;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The 8 values of column tile T of a ring row.
__device__ __forceinline__ void load_tile(const float* row, int T, float* x) {
  const float4 lo = *reinterpret_cast<const float4*>(row + (swz(2 * T) << 2));
  const float4 hi =
      *reinterpret_cast<const float4*>(row + (swz(2 * T + 1) << 2));
  x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
  x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
}

// 8 contiguous floats of shared memory (16-byte aligned).
__device__ __forceinline__ void load8(const float* p, float* x) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
  x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
}

__device__ __forceinline__ float g_at(const float* G, int k, int i, int j) {
  return (G != nullptr && i < k && j < k) ? G[i * k + j] : 0.f;
}

// Factor the 8×8 diagonal tile p of the store in place (its lower
// triangle, transposed: T[s][r] = A[8p + r][8p + s]): L goes back with zeros
// above the diagonal, the reciprocals of its pivots to invd[8p..8p+7]; a
// pivot ≤ 0 or not finite sets *bad.
__device__ __forceinline__ void factor_diag(float* store, float* invd, int p,
                                            int* bad) {
  float* T = store + tile_of(p, p) * kTileStride;
  float a[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int s = 0; s <= r; ++s) a[r][s] = T[s * 8 + r];
  bool ok = true;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float piv = a[c][c];
    ok = ok && piv > 0.f && piv < INFINITY;
    float inv = rsqrtf(piv);  // one Newton step: within an ulp or two
    inv = inv * fmaf(-0.5f * piv * inv, inv, 1.5f);
    const float l = piv * inv;
    a[c][c] = l;
    invd[8 * p + c] = inv;
#pragma unroll
    for (int r = c + 1; r < 8; ++r) a[r][c] *= inv;
#pragma unroll
    for (int r = c + 1; r < 8; ++r)
#pragma unroll
      for (int s = c + 1; s <= r; ++s)
        a[r][s] = fmaf(-a[r][c], a[s][c], a[r][s]);
  }
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    float col[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) col[r] = r >= s ? a[r][s] : 0.f;
    *reinterpret_cast<float4*>(T + s * 8) =
        make_float4(col[0], col[1], col[2], col[3]);
    *reinterpret_cast<float4*>(T + s * 8 + 4) =
        make_float4(col[4], col[5], col[6], col[7]);
  }
  if (!ok) *bad = 1;
}

template <bool kWeighted>
__global__ void __launch_bounds__(kThreads, 4)
    als_solve_kernel(const float* __restrict__ F, int k, int vec16,
                     const int* __restrict__ rows,
                     const long long* __restrict__ ptr,
                     const int* __restrict__ cnt,
                     const int* __restrict__ cols,
                     const float* __restrict__ va,
                     const float* __restrict__ wg,
                     const float* __restrict__ scale,
                     const float* __restrict__ G, float lam,
                     float* __restrict__ out) {
  __shared__ __align__(16) float s_big[kBig];  // the ring, then the factor
  __shared__ __align__(16) float s_va[kStages * kChunk];
  __shared__ __align__(16) float s_w[kStages * kChunk];
  __shared__ __align__(16) float s_invd[kMaxK];
  __shared__ int s_bad;

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int nt = (k + 7) >> 3;

  // this lane's off-diagonal tile (warps 0–3) or diagonal half (warp 4)
  int I = -1, J = -1;
  if (warp == 0 || warp == 1) {
    I = 8 + 4 * warp + (lane >> 3);
    J = lane & 7;
  } else if (warp < 4 && lane < 28) {
    int i = 1;
    while (i * (i + 1) / 2 <= lane) ++i;
    I = i + (warp == 3 ? 8 : 0);
    J = lane - i * (i - 1) / 2 + (warp == 3 ? 8 : 0);
  }
  const int d = lane >> 1, par = lane & 1;
  const bool off_on = I >= 0 && I < nt;
  const bool diag_on = warp == 4 && d < nt;

  const int r = blockIdx.x;
  const int row = rows[r];
  const long long e_begin = ptr[r];
  const int n = cnt[r];
  const float ridge = lam * fmaxf(scale != nullptr ? scale[r] : 1.f, 1.f);

  // acc: warps 0–3 the tile (row-major); warp 4 [0, 18) its diagonal half,
  // [18, 22) its rows 4·lane .. 4·lane + 3 of b
  float acc[64];
  if (warp < 4) {
#pragma unroll
    for (int rr = 0; rr < 8; ++rr)
#pragma unroll
      for (int cc = 0; cc < 8; ++cc)
        acc[rr * 8 + cc] =
            off_on ? g_at(G, k, 8 * I + rr, 8 * J + cc) : 0.f;
  } else {
#pragma unroll
    for (int m = 0; m < 64; ++m) acc[m] = 0.f;
    if (diag_on) {
#pragma unroll
      for (int m = 0; m < 18; ++m) {
        const int pos = par ? pair_pos(m, 1) : pair_pos(m, 0);
        acc[m] = g_at(G, k, 8 * d + (pos >> 3), 8 * d + (pos & 7));
      }
    }
  }

  if (t == 0) s_bad = 0;
  if (k < kMaxK) {  // the ring's columns past k read as 0
    const int pad = kMaxK - k;
    for (int q = t; q < kStages * kChunk * pad; q += kThreads) {
      const int slot = q / pad;
      s_big[slot * kMaxK + swz_f(k + q - slot * pad)] = 0.f;
    }
  }

  // -- the gram: partner rows through the ring ------------------------------
  const int nchunks = (n + kChunk - 1) / kChunk;
  float* const big = s_big;
  float* const sva = s_va;
  float* const sw = s_w;
  auto issue = [&](int c) {
    if (c < nchunks) {
      const int st = c % kStages;
      const long long e0 = e_begin + (long long)c * kChunk;
      const int nc = min(kChunk, n - c * kChunk);
      float* ring = big + st * kChunk * kMaxK;
      if (vec16) {  // the chunk's indices first, then its copies
        const int segs = k >> 2;
        const int total = nc * segs;
        int colv[kCopies];
#pragma unroll
        for (int j = 0; j < kCopies; ++j) {
          const int q = t + j * kThreads;
          const int e = segs == 32 ? q >> 5 : q / segs;
          colv[j] = q < total ? __ldg(cols + e0 + e) : 0;
        }
#pragma unroll
        for (int j = 0; j < kCopies; ++j) {
          const int q = t + j * kThreads;
          if (q < total) {
            const int e = segs == 32 ? q >> 5 : q / segs;
            const int ch = q - e * segs;
            cp_async16(ring + e * kMaxK + (swz(ch) << 2),
                       F + (long long)colv[j] * k + (ch << 2));
          }
        }
      } else {
        for (int q = t; q < nc * k; q += kThreads) {
          const int e = q / k, f = q - e * k;
          const int col = __ldg(cols + e0 + e);
          cp_async4(ring + e * kMaxK + swz_f(f), F + (long long)col * k + f);
        }
      }
      if (t < nc) {
        cp_async4(sva + st * kChunk + t, va + e0 + t);
        if (kWeighted) cp_async4(sw + st * kChunk + t, wg + e0 + t);
      }
    }
    cp_commit();
  };

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) issue(c);
  for (int c = 0; c < nchunks; ++c) {
    cp_wait<kStages - 2>();
    __syncthreads();
    issue(c + kStages - 1);
    const int st = c % kStages;
    const int nc = min(kChunk, n - c * kChunk);
    const float* ring = s_big + st * kChunk * kMaxK;
    if (warp < 4) {
      if (off_on) {
#pragma unroll 2
        for (int e = 0; e < nc; ++e) {
          const float* v = ring + e * kMaxK;
          float a[8], b[8];
          load_tile(v, I, a);
          load_tile(v, J, b);
          if (kWeighted) {
            const float w = s_w[st * kChunk + e];
#pragma unroll
            for (int q = 0; q < 8; ++q) a[q] *= w;
          }
#pragma unroll
          for (int cc = 0; cc < 8; ++cc)
#pragma unroll
            for (int rr = 0; rr < 8; ++rr)
              acc[rr * 8 + cc] = fmaf(a[rr], b[cc], acc[rr * 8 + cc]);
        }
      }
    } else {
#pragma unroll 2
      for (int e = 0; e < nc; ++e) {
        const float* v = ring + e * kMaxK;
        if (diag_on) {
          float x[8], y[8], yw[8];
          load_tile(v, d, x);
#pragma unroll
          for (int q = 0; q < 8; ++q) y[q] = par ? x[(q + 1) & 7] : x[q];
          const float w = kWeighted ? s_w[st * kChunk + e] : 1.f;
#pragma unroll
          for (int q = 0; q < 8; ++q) yw[q] = kWeighted ? w * y[q] : y[q];
#pragma unroll
          for (int m = 0; m < 18; ++m)
            acc[m] = fmaf(yw[pair_a(m)], y[pair_b(m)], acc[m]);
        }
        const float4 bv =
            *reinterpret_cast<const float4*>(v + (swz(lane) << 2));
        const float av = s_va[st * kChunk + e];
        acc[18] = fmaf(av, bv.x, acc[18]);
        acc[19] = fmaf(av, bv.y, acc[19]);
        acc[20] = fmaf(av, bv.z, acc[20]);
        acc[21] = fmaf(av, bv.w, acc[21]);
      }
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free: the factor's store takes its memory

  // -- the factorisation: right-looking, 8-column panels, in shared memory --
  // The gram's tiles go to the store (transposed, the ridge on the
  // diagonal). For panel p: the factored diagonal tile (p, p) is in the
  // store; the rows below it are solved against it, a row a thread; then
  // the trailing tiles take the panel's rank-8 update in 4×4 quarters
  // spread over warps 0–3, while warp 4 updates tile (p + 1, p + 1) and
  // one of its lanes factors it.
  float* store = s_big;
  if (off_on) {
    float* T = store + tile_of(I, J) * kTileStride;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      *reinterpret_cast<float4*>(T + c * 8) =
          make_float4(acc[c], acc[8 + c], acc[16 + c], acc[24 + c]);
      *reinterpret_cast<float4*>(T + c * 8 + 4) =
          make_float4(acc[32 + c], acc[40 + c], acc[48 + c], acc[56 + c]);
    }
  }
  if (diag_on) {
    float* T = store + tile_of(d, d) * kTileStride;
#pragma unroll
    for (int m = 0; m < 18; ++m) {
      const int pos = par ? pair_pos(m, 1) : pair_pos(m, 0);
      T[(pos & 7) * 8 + (pos >> 3)] = m < 4 ? acc[m] + ridge : acc[m];
    }
  }
  __syncthreads();  // A stored
  if (warp == 4 && lane == 0) factor_diag(store, s_invd, 0, &s_bad);
  for (int p = 0; p < nt; ++p) {
    __syncthreads();  // tile (p, p) factored, the trailing tiles updated
    const int m = nt - 1 - p;  // trailing tiles a side
    if (t < 8 * m) {  // row i below the panel: x = a · L_pp⁻ᵀ
      const int i = 8 * (p + 1) + t;
      float* T = store + tile_of(i >> 3, p) * kTileStride + (i & 7);
      const float* Tpp = store + tile_of(p, p) * kTileStride;
      float x[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) x[c] = T[c * 8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int q = 0; q < c; ++q) x[c] = fmaf(-Tpp[q * 8 + c], x[q], x[c]);
        x[c] *= s_invd[8 * p + c];
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) T[c * 8] = x[c];
    }
    __syncthreads();  // panel p solved
    // quarter u is the (R, C) one, C ≤ R, of the trailing 2m × 2m grid of
    // 4×4 quarters; units 0–2 are tile (p + 1, p + 1), warp 4's
    const int units = m * (2 * m + 1);
    const int u0 = warp == 4 ? (lane < 3 ? lane : units) : 3 + t;
    for (int u = u0; u < units; u += warp == 4 ? units : 4 * 32) {
      int R = static_cast<int>((sqrtf(8.f * u + 1.f) - 1.f) * 0.5f);
      R += (R + 1) * (R + 2) / 2 <= u;
      R -= R * (R + 1) / 2 > u;
      const int C = u - R * (R + 1) / 2;
      const int Iu = p + 1 + (R >> 1), Ju = p + 1 + (C >> 1);
      const int qi = 4 * (R & 1), qj = 4 * (C & 1);
      const float* Li = store + tile_of(Iu, p) * kTileStride + qi;
      const float* Lj = store + tile_of(Ju, p) * kTileStride + qj;
      float* Au = store + tile_of(Iu, Ju) * kTileStride + qj * 8 + qi;
      float4 q4[4];  // column qj + cc of the quarter: rows qi .. qi + 3
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        q4[cc] = *reinterpret_cast<const float4*>(Au + cc * 8);
#pragma unroll 2
      for (int s8 = 0; s8 < 8; ++s8) {
        const float4 li = *reinterpret_cast<const float4*>(Li + s8 * 8);
        const float4 lj = *reinterpret_cast<const float4*>(Lj + s8 * 8);
        const float lc[4] = {lj.x, lj.y, lj.z, lj.w};
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          q4[cc].x = fmaf(-li.x, lc[cc], q4[cc].x);
          q4[cc].y = fmaf(-li.y, lc[cc], q4[cc].y);
          q4[cc].z = fmaf(-li.z, lc[cc], q4[cc].z);
          q4[cc].w = fmaf(-li.w, lc[cc], q4[cc].w);
        }
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        *reinterpret_cast<float4*>(Au + cc * 8) = q4[cc];
    }
    if (warp == 4 && m > 0) {  // tile (p + 1, p + 1) updated: factor it
      __syncwarp();
      if (lane == 0) factor_diag(store, s_invd, p + 1, &s_bad);
    }
  }
  __syncthreads();  // the whole factor stored

  // -- the solves: L y = b, then Lᵀ x = y, in warp 4, by 8-row panels -------
  // A lane holds rows 4·lane .. 4·lane + 3 (tile lane / 2, from row
  // 4·(lane & 1) of it). For each panel every lane loads the panel's
  // triangle and its own rows' tile first, takes the panel's 8 values from
  // its two lanes by shuffles, solves the 8×8 triangle itself, and the
  // lanes of the later (forward) or earlier (back) tiles take the panel's
  // update: 8 FMAs a row.
  if (warp == 4) {
    const int tl = lane >> 1, r0 = 4 * (lane & 1);
    float y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = acc[18 + j];
    for (int p = 0; p < nt; ++p) {
      const float* Tpp = store + tile_of(p, p) * kTileStride;
      float inv[8], lo[8][8], up[8][4];
      load8(s_invd + 8 * p, inv);
#pragma unroll
      for (int c = 1; c < 8; ++c)
#pragma unroll
        for (int q = 0; q < c; ++q) lo[c][q] = Tpp[q * 8 + c];  // L_pp[c][q]
      const bool below = tl > p && tl < nt;
      if (below) {  // L[i][panel] of this lane's rows i, by column
        const float* T = store + tile_of(tl, p) * kTileStride + r0;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float4 l = *reinterpret_cast<const float4*>(T + q * 8);
          up[q][0] = l.x; up[q][1] = l.y; up[q][2] = l.z; up[q][3] = l.w;
        }
      }
      float yp[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        yp[j] = __shfl_sync(0xffffffffu, y[j], 2 * p);
        yp[4 + j] = __shfl_sync(0xffffffffu, y[j], 2 * p + 1);
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {  // L_pp y_p = b_p
#pragma unroll
        for (int q = 0; q < c; ++q) yp[c] = fmaf(-lo[c][q], yp[q], yp[c]);
        yp[c] *= inv[c];
      }
      if (tl == p) {
#pragma unroll
        for (int j = 0; j < 4; ++j) y[j] = r0 ? yp[4 + j] : yp[j];
      } else if (below) {  // b_i −= L[i][panel] · y_p
#pragma unroll
        for (int q = 0; q < 8; ++q)
#pragma unroll
          for (int j = 0; j < 4; ++j) y[j] = fmaf(-up[q][j], yp[q], y[j]);
      }
    }
    for (int p = nt - 1; p >= 0; --p) {
      const float* Tpp = store + tile_of(p, p) * kTileStride;
      float inv[8], lo[8][8], lt[4][8];
      load8(s_invd + 8 * p, inv);
#pragma unroll
      for (int c = 0; c < 7; ++c)
#pragma unroll
        for (int q = c + 1; q < 8; ++q) lo[q][c] = Tpp[c * 8 + q];  // L_pp[q][c]
      const bool above = tl < p;
      if (above) {  // L[panel][i] of this lane's rows i, by row
        const float* T = store + tile_of(p, tl) * kTileStride + r0 * 8;
#pragma unroll
        for (int j = 0; j < 4; ++j) load8(T + j * 8, lt[j]);
      }
      float xp[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        xp[j] = __shfl_sync(0xffffffffu, y[j], 2 * p);
        xp[4 + j] = __shfl_sync(0xffffffffu, y[j], 2 * p + 1);
      }
#pragma unroll
      for (int c = 7; c >= 0; --c) {  // L_ppᵀ x_p = y_p
#pragma unroll
        for (int q = c + 1; q < 8; ++q) xp[c] = fmaf(-lo[q][c], xp[q], xp[c]);
        xp[c] *= inv[c];
      }
      if (tl == p) {
#pragma unroll
        for (int j = 0; j < 4; ++j) y[j] = r0 ? xp[4 + j] : xp[j];
      } else if (above) {  // y_i −= L[panel][i]ᵀ · x_p
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 8; ++q) y[j] = fmaf(-lt[j][q], xp[q], y[j]);
      }
    }
    const bool bad = s_bad != 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = 4 * lane + j;
      if (i < k) out[(long long)row * k + i] = bad ? NAN : y[j];
    }
  }
}

}  // namespace

// One half-step over a CSR plan of n_rows solved rows. F [n_other, k] f32;
// rows, cnt int32 [n_rows]; ptr int64 [n_rows]; cols int32 and va f32
// [nnz]; wg f32 [nnz] or null (weights 1); scale f32 [n_rows] or null;
// G f32 [k, k] or null; out f32 [num_rows, k], zeroed by the caller.
// Returns the launch's CUDA error code (0: launched).
extern "C" int als_solve_launch(const void* F, int k, const void* rows,
                                const void* ptr, const void* cnt,
                                const void* cols, const void* va,
                                const void* wg, const void* scale,
                                const void* G, float lam, void* out,
                                int n_rows, void* stream) {
  if (k <= 0 || k > kMaxK || n_rows < 0) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int vec16 =
      (k % 4 == 0) && (reinterpret_cast<uintptr_t>(F) % 16 == 0) ? 1 : 0;
  const float* f = static_cast<const float*>(F);
  const int* r = static_cast<const int*>(rows);
  const long long* p = static_cast<const long long*>(ptr);
  const int* c = static_cast<const int*>(cnt);
  const int* co = static_cast<const int*>(cols);
  const float* a = static_cast<const float*>(va);
  const float* w = static_cast<const float*>(wg);
  const float* s = static_cast<const float*>(scale);
  const float* g = static_cast<const float*>(G);
  float* o = static_cast<float*>(out);
  if (w != nullptr)
    als_solve_kernel<true><<<n_rows, kThreads, 0, st>>>(
        f, k, vec16, r, p, c, co, a, w, s, g, lam, o);
  else
    als_solve_kernel<false><<<n_rows, kThreads, 0, st>>>(
        f, k, vec16, r, p, c, co, a, w, s, g, lam, o);
  return (int)cudaGetLastError();
}
