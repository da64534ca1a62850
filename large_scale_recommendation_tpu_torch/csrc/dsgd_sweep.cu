// DSGD stratum sweep for NVIDIA Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the two TPU kernels of the JAX package's ops/pallas_sgd.py:
//   _sweep_kernel   (ops/pallas_sgd.py:172, one (stratum, block) visit)
//   _stratum_kernel (ops/pallas_sgd.py:440, all k visits of one stratum)
// Both apply one λ/ω minibatch rule (ops/pallas_sgd.py:573-600). For each
// minibatch g of the stratum, in order, and for every entry of it:
//   gather u = U[su], v = V[si]                   (all reads before any write)
//   e  = (r − u·v)·w
//   du = η·(e·v − (λ/max(ω_u,1))·u·w)·icu,   dv symmetrically
//   add du into U[su], dv into V[si], one entry at a time in entry order
//   (duplicates accumulate; minibatch g+1 sees g's writes)
//
// Design: row-owning warps. The k block visits of a stratum are row-disjoint
// in U and in V, so minibatch g of every visit is one step of two launches.
// A step plan (ops/cuda_sgd.py::build_step_plan, built once per fit) lists
// each step's real entries twice: grouped by V row and by U row (a
// "segment": one per row and step), each segment in the minibatch's entry
// order, with every position's row and the entry's streams stored beside it
// in that order. A warp owns the segments that start in kOwn consecutive
// positions, so each row has exactly one owner; a segment longer than
// `chunk` is owned by a thread block of its own instead (below).
//   sgd_item_rows_kernel (A)  per owned item row, lanes over the rank: reads
//                             v_old and ω_v once, walks the row's entries
//                             gathering u_old per entry, writes each e =
//                             (r − u·v)·w to a per-entry f32 buffer, adds
//                             each dv into the row in entry order, writes
//                             V[i] in place and v_old into the snapshot
//                             (an f32 table by item row).
//   sgd_user_rows_kernel (B)  per owned user row: reads u_old and ω_u once,
//                             walks the entries reading each one's e and its
//                             item's v_old from the snapshot, adds each du
//                             into the row in entry order, writes U[u] in
//                             place.
// A warp loads its positions' plan streams lane-parallel in one coalesced
// round and walks them kAhead at a time, issuing an entry's gathers (and a
// starting segment's old row and ω) before using any of them: per warp a
// few rounds of dependent loads for ~kOwn entries, where one warp per
// segment paid three rounds for ~2–5 entries. Both orders give the same
// arithmetic, so the two designs' tables are bit-equal.
// Why the launch boundary A → B is the only barrier a step needs: in A, V
// row i is read and written by its owner alone (its segment holds every
// entry of item i in the step, and the visits are row-disjoint), and A
// writes no U, so every u it gathers is u_old. B reads no V (v_old comes
// from the snapshot, e from A's buffer) and U row u is read and written by
// its owner alone. The next step's A sees both tables' writes (stream
// order).
//
// Padding. Entries of weight 0 are in no segment. The layout gives padding
// global row 0 in every visit: kept, visit p > 0's padding would make a
// second owner of visit 0's row 0 and race with it. Their deltas are exactly
// zero, so dropping them changes nothing.
//
// Determinism. No atomics: every row is written by one owner that adds the
// deltas in a fixed order. A segment of at most `chunk` entries adds them
// one at a time in entry order, the sequential read-modify-write order of
// the TPU kernels (ops/pallas_sgd.py:593-600). A longer segment (skewed ids)
// would set the launch's tail if one warp walked it, so it gets a block of
// its own: its entries are cut into chunks of `chunk`, dealt round robin to
// the block's kWarps warps; each warp sums its chunks in order, and warp 0
// adds the kWarps partials to the old row in warp order. Either way the
// result depends on the inputs alone, so two runs are bit-equal. What
// differs from JAX is the order of the dot reduction and, for long
// segments, the grouping of the sum.
//
// Bound. The function of one step (all k visits) must read each distinct U
// and V row it touches once, with its ω, write each of them back once, and
// read 24 B of streams per entry (su, si, r, w, icu, icv). At the bench
// geometry (k 8, mb 32,768, rank 128 f32; 117,816 distinct U and 55,628 V
// rows in step 0) that is ~185 MB, ~0.055 ms at the H100's 3.35 TB/s; the
// f32 operations (~12·rank per entry) are far below the card's rate. Split
// by what each kernel must move: A the distinct-row reads of both sides
// with ω, the streams and V's writes; B U's writes.
// What this design moves beyond that, per step: one gathered U row per
// real entry in A and one snapshot row per real entry in B (the rows the
// step touches, ~28 MB at the bench, inside the 50 MB L2), the snapshot
// written once per item row, 4 B of e written and read per entry, and the
// plan (20 B per entry and side). About 0.3 GB per step at the bench,
// against the ~1.34 GB of the earlier delta/scatter pair (whose
// [k, mb, r] du/dv scratch alone was 537 MB written and read back). Kernel
// A's per-entry gathers come mostly from HBM (the U table is 83 MB), and
// A runs near what random 512-byte row gathers sustain; fewer bytes (bf16
// rows) is what would move it.
//
// bf16 factor storage (the half=True branch of both TPU kernels,
// ops/pallas_sgd.py:193-198, :226-228, :270-274 and :475-478, :552-554,
// :604-606): the tables rest in bf16; each visit works on an f32 copy of
// its slices and rounds back once at the visit's end. Each U and V block is
// visited exactly once per stratum, so that is one upcast and one downcast
// of both whole tables per stratum:
//   bf16_to_f32_kernel  fills the f32 work tables from the bf16 tables
//                       (exact: the bf16 bits shifted into the f32 high half)
//   [n_mb steps of the two f32 kernels above on the work tables]
//   f32_to_bf16_kernel  rounds the work tables back (round to nearest even,
//                       __float2bfloat16_rn, the rounding of Tensor.to and of
//                       jnp.astype).
// Both cast kernels take the two tables in one launch, 16-byte loads and
// stores, a grid-stride loop over 8-element vectors, and a scalar tail. Their
// bound is bytes: n·(2 + 4) B per cast. Gathering bf16 rows in the step
// kernels and dropping the whole-table casts is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;     // warps per thread block
constexpr int kMaxCols = 8;   // columns per lane: rank <= 32 * kMaxCols
constexpr int kAhead = 2;     // entries whose gathers a warp issues together
constexpr int kOwn = 16;      // positions whose short segments a warp owns
constexpr int kWindow = 32;   // positions a warp loads in one round
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = INT_MIN;  // no row (outside the step)

template <int NC>
__device__ __forceinline__ void load_row(float (&x)[NC],
                                         const float* __restrict__ row,
                                         int lane, int rank) {
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = lane + 32 * i;
    x[i] = c < rank ? row[c] : 0.0f;
  }
}

template <int NC>
__device__ __forceinline__ void store_row(float* __restrict__ row,
                                          const float (&x)[NC], int lane,
                                          int rank) {
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = lane + 32 * i;
    if (c < rank) row[c] = x[i];
  }
}

// u·v over the warp (each lane's columns, then a butterfly of shuffles).
template <int NC>
__device__ __forceinline__ float warp_dot(const float (&u)[NC],
                                          const float (&v)[NC]) {
  float dot = 0.0f;
#pragma unroll
  for (int i = 0; i < NC; ++i) dot += u[i] * v[i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    dot += __shfl_xor_sync(kFull, dot, off);
  return dot;
}

// Long segments: one block each; the entries [beg, end) are cut into chunks
// of `chunk`, dealt round robin to the block's warps, each walking its
// chunks in entry order with kAhead entries' loads in flight.

// Item side, entries [beg, end) of one item row (old value v, regularizer
// reg_v = λ/max(ω_v,1)): per entry, gather u, write e = (r − u·v)·w, add dv
// into acc in entry order.
template <int NC>
__device__ __forceinline__ void item_walk(
    const float* __restrict__ U, const int32_t* __restrict__ su,
    const float* __restrict__ sr, const float* __restrict__ sw,
    const float* __restrict__ sc, float* __restrict__ e_buf, int e0,
    int beg, int end, const float (&v)[NC], float reg_v, float lr, int lane,
    int rank, float (&acc)[NC]) {
  for (int t = beg; t < end; t += kAhead) {
    float u[kAhead][NC], dot[kAhead], r[kAhead], w[kAhead], c[kAhead];
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      const bool ok = t + q < end;
      const int64_t row = ok ? su[t + q] : 0;
      r[q] = ok ? sr[t + q] : 0.0f;
      w[q] = ok ? sw[t + q] : 0.0f;
      c[q] = ok ? sc[t + q] : 0.0f;
      load_row(u[q], U + row * rank, lane, ok ? rank : 0);
    }
#pragma unroll
    for (int q = 0; q < kAhead; ++q) dot[q] = warp_dot(u[q], v);
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      if (t + q < end) {
        const float err = (r[q] - dot[q]) * w[q];
        if (lane == 0) e_buf[t + q - e0] = err;
#pragma unroll
        for (int i = 0; i < NC; ++i)
          acc[i] += (lr * (err * u[q][i] - reg_v * v[i] * w[q])) * c[q];
      }
    }
  }
}

// User side, entries [beg, end) of one user row (old value u, regularizer
// reg_u): per entry, read e and the item's v_old from the snapshot, add du
// into acc in entry order.
template <int NC>
__device__ __forceinline__ void user_walk(
    const int32_t* __restrict__ epos, const int32_t* __restrict__ vrow,
    const float* __restrict__ sw, const float* __restrict__ sc,
    const float* __restrict__ e_buf, int e0, const float* __restrict__ snap,
    int beg, int end, const float (&u)[NC], float reg_u, float lr, int lane,
    int rank, float (&acc)[NC]) {
  for (int t = beg; t < end; t += kAhead) {
    float v[kAhead][NC], err[kAhead], w[kAhead], c[kAhead];
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      const bool ok = t + q < end;
      const int64_t row = ok ? vrow[t + q] : 0;
      err[q] = ok ? e_buf[epos[t + q] - e0] : 0.0f;
      w[q] = ok ? sw[t + q] : 0.0f;
      c[q] = ok ? sc[t + q] : 0.0f;
      load_row(v[q], snap + row * rank, lane, ok ? rank : 0);
    }
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      if (t + q < end) {
#pragma unroll
        for (int i = 0; i < NC; ++i)
          acc[i] += (lr * (err[q] * v[q][i] - reg_u * u[i] * w[q])) * c[q];
      }
    }
  }
}

// A long segment's kWarps partial sums, added to the old row in warp order
// by warp 0 (the only warp that returns true).
template <int NC>
__device__ __forceinline__ bool combine_partials(float (&acc)[NC],
                                                 const float (&old)[NC],
                                                 int warp, int lane) {
  __shared__ float part[kWarps][32 * kMaxCols];
#pragma unroll
  for (int i = 0; i < NC; ++i) part[warp][lane + 32 * i] = acc[i];
  __syncthreads();
  if (warp != 0) return false;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    acc[i] = old[i];
    for (int w = 0; w < kWarps; ++w) acc[i] += part[w][lane + 32 * i];
  }
  return true;
}

// Short segments: a warp owns the short segments that start in kOwn
// consecutive positions of the step's row-grouped order (a segment ends at
// most chunk − 1 <= 31 positions later, inside the two 32-position windows
// from there). Its lanes load the first window's plan streams in one
// coalesced round (the second window only when the last owned segment
// reaches it) and the warp reads them back by shuffle; then it walks the
// owned positions in order, kAhead at a time, gathering each entry's row
// (and, where a segment starts, that row's old value and ω) before using
// any of them. A segment's deltas are added one at a time in entry order,
// starting from its old row, and the row is stored when the next segment
// starts.
struct Window {
  int first, end;  // owned offsets [first, end) from base; first < 0: none
};

// Which offsets from `base` this warp owns, from each lane's row of the
// first window (ra) and the row at base − 1 (before); loads the second
// window's rows into rb (else kNone) when the last owned segment reaches
// it.
__device__ __forceinline__ Window own_window(
    const int32_t* __restrict__ prow, int pb, int e1, int ra, int before,
    int lane, int& rb) {
  const int prev = __shfl_up_sync(kFull, ra, 1);
  const unsigned starts = __ballot_sync(
      kFull, lane < kOwn && ra >= 0 && ra != (lane == 0 ? before : prev));
  rb = kNone;
  if (!starts) return Window{-1, -1};
  const int last = 31 - __clz(starts);
  const int last_row = __shfl_sync(kFull, ra, last);
  // the first offset after `last` whose row differs: in this window, or
  // else in the next
  const unsigned diff_a =
      __ballot_sync(kFull, ra != last_row) & ~((2u << last) - 1);
  if (diff_a) return Window{__ffs(starts) - 1, __ffs(diff_a) - 1};
  rb = pb < e1 ? prow[pb] : kNone;
  const unsigned diff_b = __ballot_sync(kFull, rb != last_row);
  return Window{__ffs(starts) - 1,
                kWindow + (diff_b ? __ffs(diff_b) - 1 : kWindow)};
}

// A lane's value for window offset o (0 <= o < 2·kWindow) from the two
// windows' lane-parallel registers a, b.
template <typename T>
__device__ __forceinline__ T at(T a, T b, int o) {
  const T x = __shfl_sync(kFull, a, o & 31);
  const T y = __shfl_sync(kFull, b, o & 31);
  return o < kWindow ? x : y;
}

template <int NC>
__global__ void __launch_bounds__(kWarps * 32) sgd_item_rows_kernel(
    const float* __restrict__ U, float* __restrict__ V,
    const float* __restrict__ omega_v, const int32_t* __restrict__ prow,
    const int32_t* __restrict__ su, const float* __restrict__ sr,
    const float* __restrict__ sw, const float* __restrict__ sc, int e0,
    int e1, const int32_t* __restrict__ longs, int n_long, int chunk,
    float* __restrict__ e_buf, float* __restrict__ snap, int rank, float lr,
    float lam) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if ((int)blockIdx.x < n_long) {
    const int beg = longs[2 * blockIdx.x], end = longs[2 * blockIdx.x + 1];
    const int64_t row = ~prow[beg];
    float* vp = V + row * rank;
    float v[NC], acc[NC];
    load_row(v, vp, lane, rank);
    const float reg_v = lam / fmaxf(omega_v[row], 1.0f);
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[i] = 0.0f;
    for (int lo = beg + warp * chunk; lo < end; lo += kWarps * chunk)
      item_walk(U, su, sr, sw, sc, e_buf, e0, lo, min(lo + chunk, end), v,
                reg_v, lr, lane, rank, acc);
    if (!combine_partials(acc, v, warp, lane)) return;
    store_row(vp, acc, lane, rank);
    store_row(snap + row * rank, v, lane, rank);
    return;
  }
  const int base = e0 + (((int)blockIdx.x - n_long) * kWarps + warp) * kOwn;
  if (base >= e1) return;
  const int pa = base + lane, pb = pa + kWindow;
  const int ra = pa < e1 ? prow[pa] : kNone;
  const int before = base > e0 ? prow[base - 1] : kNone;
  const int ua = pa < e1 ? su[pa] : 0;
  const float rva = pa < e1 ? sr[pa] : 0.0f;
  const float wa = pa < e1 ? sw[pa] : 0.0f;
  const float ca = pa < e1 ? sc[pa] : 0.0f;
  int rb;
  const Window own = own_window(prow, pb, e1, ra, before, lane, rb);
  if (own.first < 0) return;
  int ub = 0;
  float rvb = 0.0f, wb = 0.0f, cb = 0.0f;
  if (own.end > kWindow && pb < e1) {
    ub = su[pb];
    rvb = sr[pb];
    wb = sw[pb];
    cb = sc[pb];
  }
  float acc[NC], vcur[NC], reg_v = 0.0f, ea = 0.0f, eb = 0.0f;
  int cur = kNone, prev = kNone;
  for (int o = own.first; o < own.end; o += kAhead) {
    float u[kAhead][NC], vold[kAhead][NC], om[kAhead], r[kAhead], w[kAhead],
        c[kAhead];
    int row[kAhead];
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      const int oq = o + q;
      row[q] = at(ra, rb, oq);
      const int64_t urow = at(ua, ub, oq);
      r[q] = at(rva, rvb, oq);
      w[q] = at(wa, wb, oq);
      c[q] = at(ca, cb, oq);
      const bool live = oq < own.end && row[q] >= 0;
      const bool starts = live && row[q] != (q == 0 ? prev : row[q - 1]);
      load_row(u[q], U + urow * rank, lane, live ? rank : 0);
      load_row(vold[q], V + (int64_t)(starts ? row[q] : 0) * rank, lane,
               starts ? rank : 0);
      om[q] = starts ? omega_v[row[q]] : 0.0f;
      if (oq >= own.end) row[q] = kNone;
    }
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      if (row[q] < 0) continue;
      if (row[q] != cur) {  // a segment starts: store the one before
        if (cur != kNone) {
          store_row(V + (int64_t)cur * rank, acc, lane, rank);
          store_row(snap + (int64_t)cur * rank, vcur, lane, rank);
        }
        cur = row[q];
        reg_v = lam / fmaxf(om[q], 1.0f);
#pragma unroll
        for (int i = 0; i < NC; ++i) acc[i] = vcur[i] = vold[q][i];
      }
      const float err = (r[q] - warp_dot(u[q], vcur)) * w[q];
      if (lane == ((o + q) & 31)) {
        if (o + q < kWindow) ea = err; else eb = err;
      }
#pragma unroll
      for (int i = 0; i < NC; ++i)
        acc[i] += (lr * (err * u[q][i] - reg_v * vcur[i] * w[q])) * c[q];
    }
    prev = row[kAhead - 1];
  }
  store_row(V + (int64_t)cur * rank, acc, lane, rank);
  store_row(snap + (int64_t)cur * rank, vcur, lane, rank);
  if (lane >= own.first && lane < own.end && ra >= 0)
    e_buf[pa - e0] = ea;
  if (kWindow + lane < own.end && rb >= 0) e_buf[pb - e0] = eb;
}

template <int NC>
__global__ void __launch_bounds__(kWarps * 32) sgd_user_rows_kernel(
    float* __restrict__ U, const float* __restrict__ omega_u,
    const int32_t* __restrict__ prow, const int32_t* __restrict__ epos,
    const int32_t* __restrict__ vrow, const float* __restrict__ sw,
    const float* __restrict__ sc, int e0, int e1,
    const int32_t* __restrict__ longs, int n_long, int chunk,
    const float* __restrict__ e_buf, const float* __restrict__ snap,
    int rank, float lr, float lam) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if ((int)blockIdx.x < n_long) {
    const int beg = longs[2 * blockIdx.x], end = longs[2 * blockIdx.x + 1];
    const int64_t row = ~prow[beg];
    float* up = U + row * rank;
    float u[NC], acc[NC];
    load_row(u, up, lane, rank);
    const float reg_u = lam / fmaxf(omega_u[row], 1.0f);
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[i] = 0.0f;
    for (int lo = beg + warp * chunk; lo < end; lo += kWarps * chunk)
      user_walk(epos, vrow, sw, sc, e_buf, e0, snap, lo,
                min(lo + chunk, end), u, reg_u, lr, lane, rank, acc);
    if (!combine_partials(acc, u, warp, lane)) return;
    store_row(up, acc, lane, rank);
    return;
  }
  const int base = e0 + (((int)blockIdx.x - n_long) * kWarps + warp) * kOwn;
  if (base >= e1) return;
  const int pa = base + lane, pb = pa + kWindow;
  const int ra = pa < e1 ? prow[pa] : kNone;
  const int before = base > e0 ? prow[base - 1] : kNone;
  const int va = pa < e1 ? vrow[pa] : 0;
  const int ia = pa < e1 ? epos[pa] : e0;
  const float wa = pa < e1 ? sw[pa] : 0.0f;
  const float ca = pa < e1 ? sc[pa] : 0.0f;
  int rb;
  const Window own = own_window(prow, pb, e1, ra, before, lane, rb);
  if (own.first < 0) return;
  const float era = ra >= 0 && lane >= own.first && lane < own.end
                        ? e_buf[ia - e0] : 0.0f;
  int vb = 0;
  float wb = 0.0f, cb = 0.0f, erb = 0.0f;
  if (own.end > kWindow && pb < e1) {
    vb = vrow[pb];
    wb = sw[pb];
    cb = sc[pb];
    if (rb >= 0 && kWindow + lane < own.end) erb = e_buf[epos[pb] - e0];
  }
  float acc[NC], ucur[NC], reg_u = 0.0f;
  int cur = kNone, prev = kNone;
  for (int o = own.first; o < own.end; o += kAhead) {
    float v[kAhead][NC], uold[kAhead][NC], om[kAhead], err[kAhead], w[kAhead],
        c[kAhead];
    int row[kAhead];
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      const int oq = o + q;
      row[q] = at(ra, rb, oq);
      const int64_t item = at(va, vb, oq);
      err[q] = at(era, erb, oq);
      w[q] = at(wa, wb, oq);
      c[q] = at(ca, cb, oq);
      const bool live = oq < own.end && row[q] >= 0;
      const bool starts = live && row[q] != (q == 0 ? prev : row[q - 1]);
      load_row(v[q], snap + item * rank, lane, live ? rank : 0);
      load_row(uold[q], U + (int64_t)(starts ? row[q] : 0) * rank, lane,
               starts ? rank : 0);
      om[q] = starts ? omega_u[row[q]] : 0.0f;
      if (oq >= own.end) row[q] = kNone;
    }
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      if (row[q] < 0) continue;
      if (row[q] != cur) {  // a segment starts: store the one before
        if (cur != kNone) store_row(U + (int64_t)cur * rank, acc, lane, rank);
        cur = row[q];
        reg_u = lam / fmaxf(om[q], 1.0f);
#pragma unroll
        for (int i = 0; i < NC; ++i) acc[i] = ucur[i] = uold[q][i];
      }
#pragma unroll
      for (int i = 0; i < NC; ++i)
        acc[i] += (lr * (err[q] * v[q][i] - reg_u * ucur[i] * w[q])) * c[q];
    }
    prev = row[kAhead - 1];
  }
  store_row(U + (int64_t)cur * rank, acc, lane, rank);
}

// One block per long segment, then one warp per kOwn positions; at least
// one block (a step with no real entries launches one that returns).
dim3 step_grid(int e0, int e1, int n_long) {
  const int windows = (e1 - e0 + kOwn - 1) / kOwn;
  const int blocks = n_long + (windows + kWarps - 1) / kWarps;
  return dim3((unsigned)(blocks > 0 ? blocks : 1));
}

// Runs the statement(s) with constexpr NC = columns per lane (rank <= 32·NC).
#define DSGD_WITH_COLS(rank, ...)                             \
  switch (((rank) + 31) / 32) {                               \
    case 1: { constexpr int NC = 1; __VA_ARGS__; } break;     \
    case 2: { constexpr int NC = 2; __VA_ARGS__; } break;     \
    case 3: { constexpr int NC = 3; __VA_ARGS__; } break;     \
    case 4: { constexpr int NC = 4; __VA_ARGS__; } break;     \
    case 5: { constexpr int NC = 5; __VA_ARGS__; } break;     \
    case 6: { constexpr int NC = 6; __VA_ARGS__; } break;     \
    case 7: { constexpr int NC = 7; __VA_ARGS__; } break;     \
    case 8: { constexpr int NC = 8; __VA_ARGS__; } break;     \
    default: return (int)cudaErrorInvalidValue;               \
  }

constexpr int kCastThreads = 256;
constexpr int kVec = 8;  // bf16 elements per 16-byte vector

__device__ __forceinline__ float bf16_bits_to_f32(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x = lo
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Tables a and b as one index space of 8-element vectors: vector v < va is
// a's, the rest are b's.
__global__ void bf16_to_f32_kernel(
    const uint16_t* __restrict__ a16, float* __restrict__ a32, int64_t na,
    const uint16_t* __restrict__ b16, float* __restrict__ b32, int64_t nb) {
  const int64_t va = na / kVec, vb = nb / kVec;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       v < va + vb; v += stride) {
    const bool in_a = v < va;
    const int64_t o = in_a ? v : v - va;
    const uint4 w = reinterpret_cast<const uint4*>(in_a ? a16 : b16)[o];
    float4* dst = reinterpret_cast<float4*>(in_a ? a32 : b32) + 2 * o;
    dst[0] = make_float4(bf16_bits_to_f32(w.x & 0xffffu),
                         bf16_bits_to_f32(w.x >> 16),
                         bf16_bits_to_f32(w.y & 0xffffu),
                         bf16_bits_to_f32(w.y >> 16));
    dst[1] = make_float4(bf16_bits_to_f32(w.z & 0xffffu),
                         bf16_bits_to_f32(w.z >> 16),
                         bf16_bits_to_f32(w.w & 0xffffu),
                         bf16_bits_to_f32(w.w >> 16));
  }
  if (blockIdx.x == 0 && threadIdx.x < kVec) {  // the ragged tails
    const int64_t ta = va * kVec + threadIdx.x, tb = vb * kVec + threadIdx.x;
    if (ta < na) a32[ta] = bf16_bits_to_f32(a16[ta]);
    if (tb < nb) b32[tb] = bf16_bits_to_f32(b16[tb]);
  }
}

__global__ void f32_to_bf16_kernel(
    const float* __restrict__ a32, uint16_t* __restrict__ a16, int64_t na,
    const float* __restrict__ b32, uint16_t* __restrict__ b16, int64_t nb) {
  const int64_t va = na / kVec, vb = nb / kVec;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       v < va + vb; v += stride) {
    const bool in_a = v < va;
    const int64_t o = in_a ? v : v - va;
    const float4* src = reinterpret_cast<const float4*>(in_a ? a32 : b32)
                        + 2 * o;
    const float4 x = src[0], y = src[1];
    reinterpret_cast<uint4*>(in_a ? a16 : b16)[o] = make_uint4(
        pack_bf16x2(x.x, x.y), pack_bf16x2(x.z, x.w), pack_bf16x2(y.x, y.y),
        pack_bf16x2(y.z, y.w));
  }
  if (blockIdx.x == 0 && threadIdx.x < kVec) {
    const int64_t ta = va * kVec + threadIdx.x, tb = vb * kVec + threadIdx.x;
    const __nv_bfloat16 ra = __float2bfloat16_rn(ta < na ? a32[ta] : 0.0f);
    const __nv_bfloat16 rb = __float2bfloat16_rn(tb < nb ? b32[tb] : 0.0f);
    if (ta < na) a16[ta] = *reinterpret_cast<const uint16_t*>(&ra);
    if (tb < nb) b16[tb] = *reinterpret_cast<const uint16_t*>(&rb);
  }
}

unsigned cast_blocks(int64_t na, int64_t nb) {
  const int64_t vecs = na / kVec + nb / kVec;
  const int64_t want = (vecs + kCastThreads - 1) / kCastThreads;
  // a grid-stride loop: a few waves of blocks per SM are enough
  return (unsigned)(want < 1 ? 1 : (want > 132 * 16 ? 132 * 16 : want));
}

}  // namespace

// Plain C entry points; each returns cudaGetLastError() of its launch.
// One step's plan slice: its positions [e0, e1) of the per-position arrays
// (`prow` rows, ~row in a long segment, then the streams), and `longs`
// [n_long, 2] (the long segments' [beg, end) positions); e_buf is indexed
// by position − e0, the snapshot by item row; 1 <= chunk <= 32.
extern "C" int dsgd_sweep_max_rank() { return 32 * kMaxCols; }

extern "C" int sgd_item_rows_launch(
    const void* U, void* V, const void* omega_v, const void* prow,
    const void* su, const void* sr, const void* sw, const void* sc, int e0,
    int e1, const void* longs, int n_long, int chunk, void* e_buf,
    void* snap, int rank, float lr, float lam, void* stream) {
  if (chunk < 1 || chunk > kWindow) return (int)cudaErrorInvalidValue;
  DSGD_WITH_COLS(rank,
    sgd_item_rows_kernel<NC>
        <<<step_grid(e0, e1, n_long), kWarps * 32, 0,
           (cudaStream_t)stream>>>(
            (const float*)U, (float*)V, (const float*)omega_v,
            (const int32_t*)prow, (const int32_t*)su, (const float*)sr,
            (const float*)sw, (const float*)sc, e0, e1,
            (const int32_t*)longs, n_long, chunk, (float*)e_buf,
            (float*)snap, rank, lr, lam))
  return (int)cudaGetLastError();
}

extern "C" int sgd_user_rows_launch(
    void* U, const void* omega_u, const void* prow, const void* epos,
    const void* vrow, const void* sw, const void* sc, int e0, int e1,
    const void* longs, int n_long, int chunk, const void* e_buf,
    const void* snap, int rank, float lr, float lam, void* stream) {
  if (chunk < 1 || chunk > kWindow) return (int)cudaErrorInvalidValue;
  DSGD_WITH_COLS(rank,
    sgd_user_rows_kernel<NC>
        <<<step_grid(e0, e1, n_long), kWarps * 32, 0,
           (cudaStream_t)stream>>>(
            (float*)U, (const float*)omega_u, (const int32_t*)prow,
            (const int32_t*)epos, (const int32_t*)vrow, (const float*)sw,
            (const float*)sc, e0, e1, (const int32_t*)longs, n_long, chunk,
            (const float*)e_buf, (const float*)snap, rank, lr, lam))
  return (int)cudaGetLastError();
}

// Both tables in one launch; every pointer 16-byte aligned.
extern "C" int bf16_to_f32_launch(const void* a16, void* a32, int64_t na,
                                  const void* b16, void* b32, int64_t nb,
                                  void* stream) {
  bf16_to_f32_kernel<<<cast_blocks(na, nb), kCastThreads, 0,
                       (cudaStream_t)stream>>>(
      (const uint16_t*)a16, (float*)a32, na, (const uint16_t*)b16,
      (float*)b32, nb);
  return (int)cudaGetLastError();
}

extern "C" int f32_to_bf16_launch(const void* a32, void* a16, int64_t na,
                                  const void* b32, void* b16, int64_t nb,
                                  void* stream) {
  f32_to_bf16_kernel<<<cast_blocks(na, nb), kCastThreads, 0,
                       (cudaStream_t)stream>>>(
      (const float*)a32, (uint16_t*)a16, na, (const float*)b32,
      (uint16_t*)b16, nb);
  return (int)cudaGetLastError();
}
