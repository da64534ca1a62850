// Stage 1 of the int8 two-stage retriever for NVIDIA Hopper (sm_90a),
// bound to Python with ctypes (ops/stage1_select.py).
//
// Replaces no TPU kernel: the JAX package computes stage 1 with XLA ops
// (large_scale_recommendation_tpu/serving/retrieval.py::_stage1_flat, an
// int32 product, two elementwise passes, a scatter-min and lax.top_k). The
// port did the same with torch ops, which wrote a [b, N] f32 score matrix
// (2.3 GB for a 256-row bucket over 2,262,292 items) and passed over it
// about ten times. These kernels select the same candidates without it.
//
// What they compute, for one bucket of b query rows: for every (query i,
// item j) the score
//   s = f32(qU[i] · Q[j])  (an exact int32 dot of int8 codes)
//       * f32(u_scale[i] * scale[j])  + item_w[j]
// then s = min(s, w) for each exclusion (i, j, w) of the bucket; and per
// row the kc largest scores with their items. The epilogue uses
// __int2float_rn, __fmul_rn and __fadd_rn so nvcc cannot contract the
// multiply and the add into an FMA: every score is bit-equal to the torch
// route's (a product of int8 values in f32 is exact below rank 1,040).
//
// Selection is an exact radix select on the scores' order-preserving
// uint32 keys, in rounds of 11, 11 and 10 bits; every pass recomputes the
// scores on the tensor cores (mma.sync m16n8k32 s8 → s32; the rank padded
// to 32 with zero codes, and the k order permuted alike in A and B so a
// lane loads 8 contiguous bytes a k-step), so no [b, N] buffer exists. A
// scan kernel (a warp a row) turns each round's [b, 2048] histogram into
// the bin of the row's kc-th key on the card, with no host synchronisation.
//
// Two kernels run the passes:
//   stage1_pass_kernel (narrow): a block of 32 rows walks an item chunk,
//     each warp its own 32-item groups with its codes in registers, and
//     counts into a per-row shared-memory histogram (u16 pairs a word; a
//     chunk holds at most 65,472 items). At any rank and alignment it runs
//     every pass (count, count, count, emit).
//   stage1_wide_kernel: at ranks 32, 64 and 128 (codes 16-byte aligned) a
//     block of 8 warps × 16 rows stages each 64 items' codes, scales and
//     weights in shared memory once for its 128 rows. Its passes act on
//     few keys, so a score below the row's bound is dropped by one compare
//     and the rare hits use global atomics.
// The fast path (wide ranks):
//   1. pass 0 on a sample (the catalog's first 1/16, narrow), scanned: a
//      subset's kc-th largest key is at most the whole catalog's, so the
//      start of its bin bounds T from below;
//   2. pass 0 (wide): only keys at or above that bound are counted (about
//      the top 16·kc of a row); scan;
//   3. pass 1 (wide): keys in the chosen 11-bit bin; scan;
//   4. pass 2 (wide): keys in the chosen 22-bit bin are counted and listed
//      (at most 64 a row); keys above it are above T and go straight to
//      the output; scan → T;
//   5. stage1_finish_kernel: each row's listed keys above T, then as many
//      equal to T as it needs, fill the rest of its kc slots;
//   6. only where a list overflowed (ties): the emit pass over everything
//      (a device flag gates it; stage1_reset_kernel clears its counters).
// Without a sample (fewer than 800·kc items) pass 0 counts every key in
// the narrow kernel. Ties at T enter in whatever order the atomics give
// (which of several tied items enters at the kc-th place is left open by
// the contract); the set is exact by construction. The wrapper sorts the
// [b, kc] pairs into lax.top_k's order.
//
// Exclusions arrive as per-row sorted (column, weight) lists (built by the
// wrapper from the triple; pads dropped). Each thread sees its items of a
// row in increasing order, so it walks a pointer through that row's list:
// a group of 32 items with none of its rows' exclusions (nearly all) takes
// the straight-line path, and a score in one that has them takes min()
// over its duplicates, as the scatter-min.
//
// What bounds it on this card. A bucket needs 2·b·N·r integer operations
// (74 G at b 256, r 64: 0.037 ms at 1,979 TOP/s) and one read of the
// catalog (N·(r + 8) B, 163 MB: 0.049 ms at 3.35 TB/s). Each pass instead
// issues an f32 epilogue of about seven instructions for each of the b·N
// scores (a conversion, two multiplies, an add, the bounds' compares),
// which is what bounds it: on an H100 a wide pass takes ~0.5 ms of which
// the staging and the int8 products alone take ~0.15. The design keeps the
// passes few and the epilogue short; the grid runs the row tiles of one
// item chunk side by side, so each pass reads the catalog from HBM about
// once and the 50 MB L2 serves the repeats.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNTiles = 4;                // n8 tiles a warp scores at once
constexpr int kGroup = 8 * kNTiles;       // items of a warp's group
constexpr int kBins = 2048;               // bins of the global histogram
constexpr int kMaxChunk = 65504;          // items a narrow block (u16 counts)
constexpr int kMaxRank = 1039;            // exact in f32 below 1,040
constexpr int kWaves = 2;                 // waves of resident blocks a pass
// the narrow kernel: 32 rows a block, 16 warps (generic: every pass;
// fast path: the sample's pass 0)
constexpr int kMTn = 2, kWarpsN = 16;
// the wide kernel: 8 warps of 16 rows share each staged item group, 3
// blocks an SM (80 registers a thread)
constexpr int kWMT = 1, kWideWarps = 8, kWideBlocks = 3;
constexpr int kWideRows = 16 * kWMT * kWideWarps;
constexpr int kStageItems = 2 * kGroup;   // items staged a step

// digits of the three rounds, from the top: 11, 11 and 10 bits
__host__ __device__ constexpr int round_bits(int m) { return m < 2 ? 11 : 10; }
__host__ __device__ constexpr int round_shift(int m) {
  return m == 0 ? 21 : m == 1 ? 10 : 0;
}
// u16 pairs a row of a block's histogram in round m (+1: banks)
__host__ __device__ constexpr int hist_words(int m) {
  return (1 << round_bits(m)) / 2 + 1;
}

struct Params {
  const int8_t* qu;        // [b, r] query codes
  const float* u_scale;    // [b]
  const int8_t* q;         // [n, r] catalog codes
  const float* scale;      // [n]
  const float* item_w;     // [n]
  const int* excl_off;     // [b + 1] row starts in excl_col / excl_w
  const int* excl_col;     // per row ascending columns
  const float* excl_w;     // their weights (all < 0)
  unsigned* hist;          // [b, kBins] zeroed
  unsigned* state;         // [b, 4]: prefix, k_rem, count > T, count == T
  unsigned* flag;          // one word after state: a row's list overflowed
  unsigned* tiny;          // [b, tc, 2]: (key, item) in pass 2's last bin
  const unsigned* gate;    // null, or the flag: the kernel runs if set
  float* out_v;            // [b, kc]
  int64_t* out_r;          // [b, kc]
  int b, n, r, ks, kc;
  int chunk, row_tiles;    // the grid of the running kernel
  int sampled;             // pass 0: state[0] holds a sample's round-0 bin
  int tc;                  // slots of a row's list
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An order-preserving map of f32 onto uint32: a larger score, a larger key.
__device__ __forceinline__ unsigned key_of(float s) {
  unsigned u = __float_as_uint(s);
  return u ^ ((unsigned)((int)u >> 31) | 0x80000000u);
}

__device__ __forceinline__ float score_of(unsigned k) {
  return __uint_as_float(k ^ (k >> 31 ? 0x80000000u : 0xFFFFFFFFu));
}

// 8 code bytes of an item row at byte p (zeros past the rank).
template <bool kAligned>
__device__ __forceinline__ uint2 load8(const int8_t* row, int p, int r) {
  if (kAligned) return __ldg(reinterpret_cast<const uint2*>(row + p));
  unsigned w[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    unsigned byte = p + i < r ? (unsigned)(uint8_t)__ldg(row + p + i) : 0u;
    w[i >> 2] |= byte << (8 * (i & 3));
  }
  return make_uint2(w[0], w[1]);
}

// The scatter-min of the exclusion list walked up to item j (items of a
// row reach a thread in increasing order).
__device__ __forceinline__ float exclude(float s, int j, int& p, int end,
                                         int& next, const int* col,
                                         const float* w) {
  while (next < j) {
    ++p;
    next = p < end ? __ldg(col + p) : INT32_MAX;
  }
  while (next == j) {
    s = fminf(s, __ldg(w + p));
    ++p;
    next = p < end ? __ldg(col + p) : INT32_MAX;
  }
  return s;
}

// A thread's kR query rows in a pass: row i is base + 16·(i/2) + 8·(i%2)
// + g (the rows of its mma fragments).
template <int kR>
struct Rows {
  float us[kR];
  float low[kR];     // the least score whose key can matter in this pass
  float high[kR];    // passes 1–2: the least score past the prefix's bin
  unsigned pre[kR];  // the prefix chosen so far (T in the emit pass)
  int need[kR];      // keys equal to T the row takes (emit pass)
  int ep[kR], ee[kR], nx[kR];  // exclusion list: position, end, column
  bool live[kR];

  __device__ __forceinline__ int row(int base, int i, int g) const {
    return base + (i >> 1) * 16 + (i & 1) * 8 + g;
  }

  template <int MODE, bool kFuse = false>
  __device__ __forceinline__ void init(const Params& p, int base, int g,
                                       int j_begin) {
    constexpr int kShift = MODE < 3 ? round_shift(MODE) : 0;
    constexpr int kBitsR = MODE < 3 ? round_bits(MODE) : 0;
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int rw = row(base, i, g);
      live[i] = rw < p.b;
      us[i] = 0.f;
      pre[i] = MODE == 3 ? 0xFFFFFFFFu : 0u;
      low[i] = __uint_as_float(0x7FFFFFFFu);  // NaN: no score reaches it
      high[i] = __uint_as_float(0x7F800000u);  // +inf
      need[i] = 0;
      ep[i] = ee[i] = 0;
      nx[i] = INT32_MAX;
      if (!live[i]) continue;
      us[i] = p.u_scale[rw];
      low[i] = __uint_as_float(0xFF800000u);  // -inf: every score
      if (MODE > 0 || p.sampled) {
        const unsigned st0 = p.state[4 * rw];
        if (MODE > 0) pre[i] = st0;
        // the float of the least key with the prefix (of T; in pass 0 of
        // the sample's bin, a bound below T: a subset's kc-th largest
        // score is at most the whole catalog's)
        const float l = score_of(MODE == 3   ? st0
                                 : MODE == 0 ? st0 << kShift
                                             : st0 << (kShift + kBitsR));
        if (l == l) low[i] = l;  // a NaN bound filters nothing
        // keys past the bin (a larger prefix) count in no histogram
        const unsigned top = (st0 + 1u) << (kShift + kBitsR);
        if ((MODE == 1 || (MODE == 2 && !kFuse)) && top != 0u) {
          const float h = score_of(top);
          if (h == h) high[i] = h;
        }
      }
      if (MODE == 3) need[i] = (int)p.state[4 * rw + 1];
      int lo = p.excl_off[rw], hi = p.excl_off[rw + 1];
      ee[i] = hi;
      while (lo < hi) {  // first column >= j_begin
        const int mid = (lo + hi) >> 1;
        if (p.excl_col[mid] < j_begin) lo = mid + 1; else hi = mid;
      }
      ep[i] = lo;
      nx[i] = lo < ee[i] ? p.excl_col[lo] : INT32_MAX;
    }
  }
};

// The epilogue of one group of kGroup items for a thread's rows: every
// score finished with the route's f32 rounding (no FMA), keyed, and
// counted (MODE 0–2: hist_add(row, digit) for keys carrying the prefix) or
// emitted (MODE 3: emit(row, i, key, item, score) for keys >= T); pass 2
// of the wide kernel (kFuse) also sends the keys above its bin to the
// output and lists the bin's keys. The common group (whole, and no
// exclusion of this thread's rows inside it) is straight-line code: every
// score first, then one compare each against the row's bounds (no key
// outside them can matter in this pass), the rest only on a hit.
// Otherwise each score checks its item against the chunk's end and walks
// the exclusion lists.
template <int MODE, int kMT, bool kFuse, typename HistAdd, typename Emit>
__device__ __forceinline__ void finish_group(
    const Params& p, Rows<2 * kMT>& R, int (&acc)[kMT][kNTiles][4], int jg,
    int j_end, const float (&sc)[kNTiles][2], const float (&wv)[kNTiles][2],
    int base, int g, int t, HistAdd hist_add, Emit emit) {
  constexpr int kR = 2 * kMT;
  constexpr int kShift = MODE < 3 ? round_shift(MODE) : 0;
  constexpr int kBitsR = MODE < 3 ? round_bits(MODE) : 0;
  auto score = [&](int dot, int i, float s_j, float w_j) {
    return __fadd_rn(__fmul_rn(__int2float_rn(dot), __fmul_rn(R.us[i], s_j)),
                     w_j);
  };
  auto act = [&](unsigned key, int i, int j, float s) {
    if (MODE > 0 && !R.live[i]) return;
    const int rw = R.row(base, i, g);
    if constexpr (MODE == 2 && kFuse) {
      const unsigned top = key >> (kShift + kBitsR);
      if (top > R.pre[i]) {  // above the last bin: above T
        const int slot = (int)atomicAdd(p.state + 4 * rw + 2, 1u);
        p.out_v[(size_t)rw * p.kc + slot] = s;
        p.out_r[(size_t)rw * p.kc + slot] = j;
      } else if (top == R.pre[i]) {
        hist_add(rw, key & ((1u << kBitsR) - 1u));
        const unsigned q = atomicAdd(p.state + 4 * rw + 3, 1u);
        if (q < (unsigned)p.tc) {
          unsigned* slot = p.tiny + 2 * ((size_t)rw * p.tc + q);
          slot[0] = key;
          slot[1] = (unsigned)j;
        }
      }
    } else if constexpr (MODE < 3) {
      // the round's digit of keys that carry the prefix chosen so far
      if (MODE == 0 || (key >> (kShift + kBitsR)) == R.pre[i])
        hist_add(rw, (key >> kShift) & ((1u << kBitsR) - 1u));
    } else if (key >= R.pre[i]) {
      emit(rw, i, key, j, s);
    }
  };
  bool quiet = jg + kGroup <= j_end;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    while (R.nx[i] < jg) {  // past columns other threads scored
      ++R.ep[i];
      R.nx[i] = R.ep[i] < R.ee[i] ? __ldg(p.excl_col + R.ep[i]) : INT32_MAX;
    }
    quiet = quiet && R.nx[i] >= jg + kGroup;
  }
  if (quiet) {
    float sv[kMT][kNTiles][4];
    bool hit = false;
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          const int c = (i & 1) * 2 + e;
          const float v = score(acc[i >> 1][nt][c], i, sc[nt][e], wv[nt][e]);
          sv[i >> 1][nt][c] = v;
          hit |= v >= R.low[i] && !(v > R.high[i]);
        }
    if (!hit) return;
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          const float v = sv[i >> 1][nt][(i & 1) * 2 + e];
          if (v >= R.low[i] && !(v > R.high[i]))
            act(key_of(v), i, jg + nt * 8 + 2 * t + e, v);
        }
    return;
  }
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = jg + nt * 8 + 2 * t + e;
      if (j >= j_end) continue;
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        float s = score(acc[i >> 1][nt][(i & 1) * 2 + e], i, sc[nt][e],
                        wv[nt][e]);
        s = exclude(s, j, R.ep[i], R.ee[i], R.nx[i], p.excl_col, p.excl_w);
        if (MODE > 0 || s >= R.low[i]) act(key_of(s), i, j, s);
      }
    }
  }
}

// Emit a key >= T straight to the output: a slot from the row's count of
// keys above T, or of keys equal to T while the row still needs them.
template <int kR>
__device__ __forceinline__ void emit_global(const Params& p, const Rows<kR>& R,
                                            int rw, int i, unsigned key, int j,
                                            float s) {
  int slot = -1;
  if (key > R.pre[i]) {
    slot = (int)atomicAdd(p.state + 4 * rw + 2, 1u);
  } else {
    const int q = (int)atomicAdd(p.state + 4 * rw + 3, 1u);
    if (q < R.need[i]) slot = p.kc - R.need[i] + q;
  }
  if (slot >= 0) {
    p.out_v[(size_t)rw * p.kc + slot] = s;
    p.out_r[(size_t)rw * p.kc + slot] = j;
  }
}

// The narrow kernel: one pass over the scores of a (16·kMT-row tile, item
// chunk) block, each warp walking its own 32-item groups with its codes in
// registers (the next group's loads in flight). Pass 0 of every rank runs
// here: its per-row histogram lives in shared memory as pairs of u16
// counts. At ranks the wide kernel does not take, every pass runs here. KS
// is the padded rank over 32 when fixed at compile time (0: p.ks).
template <int MODE, int KS, bool kAligned, int kMT, int kWarps>
__global__ void __launch_bounds__(32 * kWarps)
stage1_pass_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kHist = MODE < 3;
  constexpr int kRows = 16 * kMT;
  constexpr int kWords = kHist ? hist_words(MODE) : 0;
  constexpr int kThreads = 32 * kWarps;
  const int ks = KS > 0 ? KS : p.ks;
  const int rp = 32 * ks;
  const int a_stride = rp + 4;
  unsigned* hist = reinterpret_cast<unsigned*>(smem);
  unsigned char* a_tile = smem + kRows * kWords * 4;

  const int row0 = (blockIdx.x % p.row_tiles) * kRows;
  const int j_begin = (blockIdx.x / p.row_tiles) * p.chunk;
  const int j_end = min(p.n, j_begin + p.chunk);

  for (int i = threadIdx.x; i < kRows * kWords; i += kThreads) hist[i] = 0;
  for (int i = threadIdx.x; i < kRows * rp; i += kThreads) {
    const int lr = i / rp, c = i - lr * rp, row = row0 + lr;
    a_tile[lr * a_stride + c] =
        row < p.b && c < p.r ? (unsigned char)p.qu[(size_t)row * p.r + c] : 0;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  Rows<2 * kMT> R;
  R.template init<MODE>(p, row0, g, j_begin);
  __syncthreads();

  auto hist_add = [&](int row, unsigned d) {
    atomicAdd(hist + (row - row0) * kWords + (d >> 1), 1u << ((d & 1u) << 4));
  };
  auto emit = [&](int rw, int i, unsigned key, int j, float s) {
    emit_global(p, R, rw, i, key, j, s);
  };
  // A fragments of k-step s: rows g and g + 8 of each m tile, the k order
  // permuted as the B loads (a lane's 8 bytes at 8·ks·t + 8·s)
  auto a_frag = [&](int s, unsigned (&a)[kMT][4]) {
    const int off = 8 * ks * t + 8 * s;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const unsigned char* r0 = a_tile + (16 * mt + g) * a_stride + off;
      const unsigned char* r8 = r0 + 8 * a_stride;
      a[mt][0] = *reinterpret_cast<const unsigned*>(r0);
      a[mt][1] = *reinterpret_cast<const unsigned*>(r8);
      a[mt][2] = *reinterpret_cast<const unsigned*>(r0 + 4);
      a[mt][3] = *reinterpret_cast<const unsigned*>(r8 + 4);
    }
  };
  // the scales and weights of a group's items (this thread's columns)
  auto item_terms = [&](int jg, float (&sc)[kNTiles][2],
                        float (&wv)[kNTiles][2]) {
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = min(jg + nt * 8 + 2 * t + e, j_end - 1);
        sc[nt][e] = __ldg(p.scale + j);
        wv[nt][e] = __ldg(p.item_w + j);
      }
  };

  constexpr int kStep = kWarps * kGroup;
  if constexpr (KS > 0) {
    constexpr int kPairs = (kAligned && KS % 2 == 0) ? KS / 2 : 0;
    auto fetch = [&](int jg, uint2 (&bv)[KS][kNTiles]) {
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        const int j = jg + nt * 8 + g;
        const bool ok = j < j_end;
        const int8_t* row = p.q + (size_t)(ok ? j : j_begin) * p.r;
        if constexpr (kPairs > 0) {
#pragma unroll
          for (int s2 = 0; s2 < kPairs; ++s2) {
            const uint4 v = ok ? __ldg(reinterpret_cast<const uint4*>(
                                     row + 16 * kPairs * t + 16 * s2))
                               : make_uint4(0u, 0u, 0u, 0u);
            bv[2 * s2][nt] = make_uint2(v.x, v.y);
            bv[2 * s2 + 1][nt] = make_uint2(v.z, v.w);
          }
        } else {
#pragma unroll
          for (int s = 0; s < KS; ++s)
            bv[s][nt] = ok ? load8<kAligned>(row, 8 * KS * t + 8 * s, p.r)
                           : make_uint2(0u, 0u);
        }
      }
    };
    uint2 bq[KS][kNTiles];
    int jg = j_begin + warp * kGroup;
    if (jg < j_end) fetch(jg, bq);
    for (; jg < j_end; jg += kStep) {
      uint2 bn[KS][kNTiles];
      if (jg + kStep < j_end) fetch(jg + kStep, bn);
      float sc[kNTiles][2], wv[kNTiles][2];
      item_terms(jg, sc, wv);
      int acc[kMT][kNTiles][4] = {};
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        unsigned a[kMT][4];
        a_frag(s, a);
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
            mma_s8(acc[mt][nt], a[mt], bq[s][nt].x, bq[s][nt].y);
      }
      finish_group<MODE, kMT, false>(p, R, acc, jg, j_end, sc, wv, row0, g,
                                     t, hist_add, emit);
#pragma unroll
      for (int s = 0; s < KS; ++s)
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt) bq[s][nt] = bn[s][nt];
    }
  } else {
    for (int jg = j_begin + warp * kGroup; jg < j_end; jg += kStep) {
      float sc[kNTiles][2], wv[kNTiles][2];
      item_terms(jg, sc, wv);
      int acc[kMT][kNTiles][4] = {};
      const int8_t* brow[kNTiles];
      bool bok[kNTiles];
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        const int j = jg + nt * 8 + g;
        bok[nt] = j < j_end;
        brow[nt] = p.q + (size_t)(bok[nt] ? j : j_begin) * p.r;
      }
      for (int s = 0; s < ks; ++s) {
        unsigned a[kMT][4];
        a_frag(s, a);
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt) {
          const uint2 bv = bok[nt]
              ? load8<kAligned>(brow[nt], 8 * ks * t + 8 * s, p.r)
              : make_uint2(0u, 0u);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
            mma_s8(acc[mt][nt], a[mt], bv.x, bv.y);
        }
      }
      finish_group<MODE, kMT, false>(p, R, acc, jg, j_end, sc, wv, row0, g,
                                     t, hist_add, emit);
    }
  }

  if constexpr (kHist) {
    __syncthreads();
    constexpr int kPairsR = (1 << round_bits(MODE)) / 2;
    for (int i = threadIdx.x; i < kRows * kPairsR; i += kThreads) {
      const int lr = i / kPairsR, wi = i - lr * kPairsR, row = row0 + lr;
      if (row >= p.b) continue;
      const unsigned v = hist[lr * kWords + wi];
      if (!v) continue;
      unsigned* dst = p.hist + (size_t)row * kBins + 2 * wi;
      if (v & 0xFFFFu) atomicAdd(dst, v & 0xFFFFu);
      if (v >> 16) atomicAdd(dst + 1, v >> 16);
    }
  }
}

// The wide kernel (every pass after the first count, and pass 0 after a
// sample, at a rank of 32·KS with codes 16-byte aligned): each warp holds
// the A fragments of 16·kWMT query rows in registers and scores every item
// of the block's chunk. Each step stages kStageItems items' codes, scales
// and weights in shared memory once for all the block's rows (the next
// step's loads in flight during this one's work). The keys a pass acts on
// are rare: histogram hits go to the global histogram with atomics, and
// emitted keys take their slots with atomics.
template <int MODE, int KS>
__global__ void __launch_bounds__(32 * kWideWarps, kWideBlocks)
stage1_wide_kernel(const Params p) {
  if (p.gate != nullptr && *p.gate == 0u) return;  // a fallback not needed
  constexpr bool kFuse = MODE == 2;
  constexpr int kRP = 32 * KS;
  constexpr int kPieces = kStageItems * kRP / 16;  // 16-byte pieces a stage
  constexpr int kThreads = 32 * kWideWarps;
  constexpr int kPer = (kPieces + kThreads - 1) / kThreads;
  constexpr int kTPer = (2 * kStageItems + kThreads - 1) / kThreads;
  __shared__ __align__(16) unsigned char codes[2][kStageItems * kRP];
  __shared__ __align__(16) float terms[2][2][kStageItems];  // scale, weight

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (blockIdx.x % p.row_tiles) * kWideRows;
  const int j_begin = (blockIdx.x / p.row_tiles) * p.chunk;
  const int j_end = min(p.n, j_begin + p.chunk);
  const int base = row0 + 16 * kWMT * warp;
  const bool busy = base < p.b;
  Rows<2 * kWMT> R;
  R.template init<MODE, kFuse>(p, base, g, j_begin);
  unsigned a[KS][kWMT][4];  // this warp's rows, the k order permuted as B's
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int mt = 0; mt < kWMT; ++mt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = base + 16 * mt + g + 8 * (q & 1);
        a[s][mt][q] = row < p.b
            ? __ldg(reinterpret_cast<const unsigned*>(
                  p.qu + (size_t)row * p.r + 8 * KS * t + 8 * s + 4 * (q >> 1)))
            : 0u;
      }
  auto hist_add = [&](int row, unsigned d) {
    atomicAdd(p.hist + (size_t)row * kBins + d, 1u);
  };
  auto emit = [&](int rw, int i, unsigned key, int j, float s) {
    emit_global(p, R, rw, i, key, j, s);
  };
  uint4 cr[kPer];
  float tv[kTPer];
  auto load_stage = [&](int js) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int idx = threadIdx.x + u * kThreads;
      const int item = idx / (kRP / 16), piece = idx % (kRP / 16);
      const int j = js + item;
      cr[u] = idx < kPieces && j < j_end
          ? __ldg(reinterpret_cast<const uint4*>(p.q + (size_t)j * kRP) +
                  piece)
          : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kTPer; ++u) {
      const int idx = threadIdx.x + u * kThreads;
      const int j = js + idx % kStageItems;
      tv[u] = idx < 2 * kStageItems && j < j_end
          ? __ldg((idx < kStageItems ? p.scale : p.item_w) + j) : 0.f;
    }
  };
  auto store_stage = [&](int buf) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int idx = threadIdx.x + u * kThreads;
      if (idx < kPieces)
        reinterpret_cast<uint4*>(codes[buf])[idx] = cr[u];
    }
#pragma unroll
    for (int u = 0; u < kTPer; ++u) {
      const int idx = threadIdx.x + u * kThreads;
      if (idx < 2 * kStageItems)
        terms[buf][idx / kStageItems][idx % kStageItems] = tv[u];
    }
  };

  load_stage(j_begin);
  store_stage(0);
  __syncthreads();
  int buf = 0;
  for (int js = j_begin; js < j_end; js += kStageItems, buf ^= 1) {
    const bool more = js + kStageItems < j_end;
    if (more) load_stage(js + kStageItems);
    if (busy) {
#pragma unroll
      for (int sg = 0; sg < kStageItems / kGroup; ++sg) {
        const int jg = js + sg * kGroup;
        if (jg >= j_end) break;
        int acc[kWMT][kNTiles][4] = {};
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt) {
          // a lane's 8·KS contiguous bytes: 16-byte loads where they pair
          const unsigned char* crow =
              codes[buf] + (sg * kGroup + nt * 8 + g) * kRP + 8 * KS * t;
          uint2 bv[KS];
          if constexpr (KS % 2 == 0) {
#pragma unroll
            for (int s2 = 0; s2 < KS / 2; ++s2) {
              const uint4 v = *reinterpret_cast<const uint4*>(crow + 16 * s2);
              bv[2 * s2] = make_uint2(v.x, v.y);
              bv[2 * s2 + 1] = make_uint2(v.z, v.w);
            }
          } else {
#pragma unroll
            for (int s = 0; s < KS; ++s)
              bv[s] = *reinterpret_cast<const uint2*>(crow + 8 * s);
          }
#pragma unroll
          for (int s = 0; s < KS; ++s)
#pragma unroll
            for (int mt = 0; mt < kWMT; ++mt)
              mma_s8(acc[mt][nt], a[s][mt], bv[s].x, bv[s].y);
        }
        float sc[kNTiles][2], wv[kNTiles][2];
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt) {
          const int it = sg * kGroup + nt * 8 + 2 * t;
          const float2 s2 = *reinterpret_cast<const float2*>(&terms[buf][0][it]);
          const float2 w2 = *reinterpret_cast<const float2*>(&terms[buf][1][it]);
          sc[nt][0] = s2.x; sc[nt][1] = s2.y;
          wv[nt][0] = w2.x; wv[nt][1] = w2.y;
        }
        finish_group<MODE, kWMT, kFuse>(p, R, acc, jg, j_end, sc, wv, base, g,
                                        t, hist_add, emit);
      }
    }
    if (more) store_stage(buf ^ 1);
    __syncthreads();
  }
}

// After pass 2's scan, a row's output from its list: the listed keys
// above T fill the slots after those pass 2 emitted, then the keys equal
// to T the row needs fill the last ones. A list past its slots sets the
// flag, and the emit pass runs after all (stage1_reset_kernel first).
__global__ void stage1_finish_kernel(const Params p) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= p.b) return;
  const unsigned* st = p.state + 4 * row;
  const unsigned n = st[3];
  if (n > (unsigned)p.tc) {
    atomicExch(p.flag, 1u);
    return;
  }
  const unsigned T = st[0];
  const int need = (int)st[1];
  int gt = (int)st[2], eq = 0;
  for (unsigned q = 0; q < n; ++q) {
    const unsigned* e = p.tiny + 2 * ((size_t)row * p.tc + q);
    const unsigned key = e[0];
    int slot;
    if (key > T) {
      slot = gt++;
    } else if (key == T && eq < need) {
      slot = p.kc - need + eq++;
    } else {
      continue;
    }
    p.out_v[(size_t)row * p.kc + slot] = score_of(key);
    p.out_r[(size_t)row * p.kc + slot] = (int64_t)e[1];
  }
}

// The emit pass's counters cleared, where a list overflowed.
__global__ void stage1_reset_kernel(const Params p) {
  if (*p.flag == 0u) return;
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= p.b) return;
  p.state[4 * row + 2] = 0u;
  p.state[4 * row + 3] = 0u;
}

// One warp a row: the round's bin that holds the row's k_rem-th largest
// key (bins scanned from the top), the prefix extended by it, k_rem less
// the keys above it; then the histogram row zeroed for the next round.
template <int ROUND>
__global__ void stage1_scan_kernel(unsigned* hist, unsigned* state, int kc) {
  constexpr int kBitsR = round_bits(ROUND);
  constexpr int kB = 1 << kBitsR, kPer = kB / 32;
  const int row = blockIdx.x, lane = threadIdx.x;
  unsigned* h = hist + (size_t)row * kBins;
  unsigned* st = state + 4 * row;
  const unsigned k_rem = ROUND == 0 ? (unsigned)kc : st[1];
  const unsigned prefix = ROUND == 0 ? 0u : st[0];
  const int top = kB - lane * kPer;  // this lane's bins: [top - kPer, top)
  unsigned sum = 0;
  for (int d = top - kPer; d < top; ++d) sum += h[d];
  unsigned incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned v = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += v;
  }
  const unsigned reach = __ballot_sync(0xFFFFFFFFu, incl >= k_rem);
  if (lane == __ffs(reach) - 1) {
    unsigned above = incl - sum;
    int d = top - 1;
    for (; d > top - kPer; --d) {
      const unsigned c = h[d];
      if (above + c >= k_rem) break;
      above += c;
    }
    st[0] = (prefix << kBitsR) | (unsigned)d;
    st[1] = k_rem - above;
  }
  __syncwarp();
  for (int d = top - kPer; d < top; ++d) h[d] = 0;
}

// the grid of a pass: row tiles × item chunks (the row tiles of a chunk
// adjacent, so they run together and share the chunk in L2), about
// kWaves waves of `resident` blocks, chunks of whole stages, at most
// `max_chunk` items
inline int cut_grid(Params& p, int rows, int resident, int max_chunk) {
  p.row_tiles = (p.b + rows - 1) / rows;
  const int want = (kWaves * resident + p.row_tiles - 1) / p.row_tiles;
  int chunks = (p.n + max_chunk - 1) / max_chunk;
  if (chunks < want) chunks = want;
  int chunk = (p.n + chunks - 1) / chunks;
  chunk = (chunk + kStageItems - 1) / kStageItems * kStageItems;
  p.chunk = chunk < max_chunk ? chunk : max_chunk / kStageItems * kStageItems;
  return p.row_tiles * ((p.n + p.chunk - 1) / p.chunk);
}

template <int MODE, int KS, bool kAligned, int kMT, int kWarps>
cudaError_t narrow_pass(Params p, int sms, cudaStream_t stream) {
  auto kernel = stage1_pass_kernel<MODE, KS, kAligned, kMT, kWarps>;
  const int smem = 16 * kMT * ((MODE < 3 ? hist_words(MODE) * 4 : 0)
                               + 32 * p.ks + 4);
  // set on every launch: the attribute belongs to the current device
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int grid = cut_grid(p, 16 * kMT, sms, kMaxChunk);
  kernel<<<grid, 32 * kWarps, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int MODE, int KS>
cudaError_t wide_pass(Params p, int sms, cudaStream_t stream) {
  const int grid = cut_grid(p, kWideRows, kWideBlocks * sms, 1 << 30);
  stage1_wide_kernel<MODE, KS><<<grid, 32 * kWideWarps, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int ROUND>
cudaError_t scan(const Params& p, cudaStream_t stream) {
  stage1_scan_kernel<ROUND><<<p.b, 32, 0, stream>>>(p.hist, p.state, p.kc);
  return cudaGetLastError();
}

// every pass in the narrow kernel (any rank, any alignment)
template <bool kAligned>
cudaError_t run_generic(const Params& p, int sms, cudaStream_t st) {
  cudaError_t err;
  if ((err = narrow_pass<0, 0, kAligned, kMTn, kWarpsN>(p, sms, st)))
    return err;
  if ((err = scan<0>(p, st))) return err;
  if ((err = narrow_pass<1, 0, kAligned, kMTn, kWarpsN>(p, sms, st)))
    return err;
  if ((err = scan<1>(p, st))) return err;
  if ((err = narrow_pass<2, 0, kAligned, kMTn, kWarpsN>(p, sms, st)))
    return err;
  if ((err = scan<2>(p, st))) return err;
  return narrow_pass<3, 0, kAligned, kMTn, kWarpsN>(p, sms, st);
}

// At a rank of 32·KS: where the catalog holds at least 800·kc items, pass
// 0 first counts a sample (its first 1/16, in the narrow kernel) and then
// counts, in the wide kernel, only the keys at or above the sample's bin
// of its kc-th key (about the top 16·kc of a row); else pass 0 counts
// every key in the narrow kernel. Passes 1–3 run in the wide kernel.
template <int KS>
cudaError_t run_fast(Params p, int sms, cudaStream_t st) {
  cudaError_t err;
  Params sample = p;
  sample.n = p.n / 16 / kStageItems * kStageItems;
  if ((long long)p.kc * 800 <= p.n && sample.n >= p.kc) {
    if ((err = narrow_pass<0, KS, true, kMTn, kWarpsN>(sample, sms,
                                                                   st)))
      return err;
    if ((err = scan<0>(p, st))) return err;
    p.sampled = 1;
    if ((err = wide_pass<0, KS>(p, sms, st))) return err;
    p.sampled = 0;
  } else {
    if ((err = narrow_pass<0, KS, true, kMTn, kWarpsN>(p, sms, st)))
      return err;
  }
  if ((err = scan<0>(p, st))) return err;
  if ((err = wide_pass<1, KS>(p, sms, st))) return err;
  if ((err = scan<1>(p, st))) return err;
  if ((err = wide_pass<2, KS>(p, sms, st))) return err;
  if ((err = scan<2>(p, st))) return err;
  const int rows = (p.b + 255) / 256;
  stage1_finish_kernel<<<rows, 256, 0, st>>>(p);
  if ((err = cudaGetLastError())) return err;
  stage1_reset_kernel<<<rows, 256, 0, st>>>(p);
  if ((err = cudaGetLastError())) return err;
  p.gate = p.flag;
  return wide_pass<3, KS>(p, sms, st);
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C entry points; each returns the first CUDA error of its launches.
// ---------------------------------------------------------------------------

// The whole selection of one bucket on `stream` into out_v / out_r ([b,
// kc], in no order), with scratch `hist` ([b, 2048] u32), `state` ([b + 1,
// 4] u32; both zeroed here) and `tiny` ([b, tc, 2] u32).
extern "C" int stage1_select_launch(
    const void* qu, const void* u_scale, const void* q, const void* scale,
    const void* item_w, const void* excl_off, const void* excl_col,
    const void* excl_w, int b, int n, int r, int kc, void* hist,
    void* state, void* tiny, int tc, void* out_v, void* out_r,
    void* stream) {
  if (b <= 0 || n <= 0 || r <= 0 || r > kMaxRank || kc <= 0 || kc > n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if ((err = cudaMemsetAsync(hist, 0, sizeof(unsigned) * kBins * (size_t)b, st)))
    return (int)err;
  if ((err = cudaMemsetAsync(state, 0, sizeof(unsigned) * 4 * (size_t)(b + 1),
                             st)))
    return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev))) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)))
    return (int)err;
  Params p;
  p.qu = static_cast<const int8_t*>(qu);
  p.u_scale = static_cast<const float*>(u_scale);
  p.q = static_cast<const int8_t*>(q);
  p.scale = static_cast<const float*>(scale);
  p.item_w = static_cast<const float*>(item_w);
  p.excl_off = static_cast<const int*>(excl_off);
  p.excl_col = static_cast<const int*>(excl_col);
  p.excl_w = static_cast<const float*>(excl_w);
  p.hist = static_cast<unsigned*>(hist);
  p.state = static_cast<unsigned*>(state);
  p.flag = p.state + 4 * (size_t)b;
  p.tiny = static_cast<unsigned*>(tiny);
  p.tc = tc;
  p.gate = nullptr;
  p.out_v = static_cast<float*>(out_v);
  p.out_r = static_cast<int64_t*>(out_r);
  p.b = b;
  p.n = n;
  p.r = r;
  p.ks = (r + 31) / 32;
  p.kc = kc;
  p.chunk = p.row_tiles = p.sampled = 0;
  const bool aligned =
      r % 32 == 0 && (reinterpret_cast<uintptr_t>(q) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(qu) & 3) == 0;
  if (aligned && r == 32) return (int)run_fast<1>(p, sms, st);
  if (aligned && r == 64) return (int)run_fast<2>(p, sms, st);
  if (aligned && r == 128) return (int)run_fast<4>(p, sms, st);
  if (aligned) return (int)run_generic<true>(p, sms, st);
  return (int)run_generic<false>(p, sms, st);
}
