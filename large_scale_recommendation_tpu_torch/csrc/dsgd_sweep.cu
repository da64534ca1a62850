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
// Algorithm: row-owning warps. The k block visits of a stratum are
// row-disjoint in U and in V, so minibatch g of every visit is one step of
// two launches. A step plan (ops/cuda_sgd.py::build_step_plan, built once
// per fit) lists each step's real entries twice: grouped by V row and by U
// row (a "segment": one per row and step), each segment in the minibatch's
// entry order, with every position's row and the entry's streams stored
// beside it in that order. A warp owns the segments that start in kOwn
// consecutive positions, so each row has exactly one owner; a segment
// longer than `chunk` is owned by a thread block of its own (below).
//   sgd_item_rows_kernel (A)  per owned item row: v_old and ω_v once, then
//                             per entry the gathered u_old, e = (r − u·v)·w
//                             into a per-entry f32 buffer, dv added into the
//                             row in entry order; V[i] written in place and
//                             v_old into the snapshot (f32, by item row).
//   sgd_user_rows_kernel (B)  per owned user row: u_old and ω_u once, then
//                             per entry its e and its item's v_old from the
//                             snapshot, du added in entry order; U[u]
//                             written in place.
// The launch boundary A → B is the only barrier a step needs: in A, V row
// i is read and written by its owner alone (its segment holds every entry
// of item i in the step, and the visits are row-disjoint), and A writes no
// U, so every u it gathers is u_old. B reads no V (v_old comes from the
// snapshot, e from A's buffer) and U row u is read and written by its owner
// alone. The next step's A sees both tables' writes (stream order).
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
// gets a block of its own: its entries are cut into chunks of `chunk`,
// dealt round robin to the block's kWarps warps; each warp sums its chunks
// in order, and warp 0 adds the kWarps partials to the old row in warp
// order. Either way the result depends on the inputs alone, so two runs are
// bit-equal. What differs from JAX is the order of the dot reduction and,
// for long segments, the grouping of the sum.
//
// Bound. The function of one step (all k visits) must read each distinct U
// and V row it touches once, with its ω, write each of them back once, and
// read 24 B of streams per entry (su, si, r, w, icu, icv). At the bench
// geometry (k 8, mb 32,768, rank 128 f32; 117,816 distinct U and 55,628 V
// rows in step 0) that is ~185 MB, ~0.055 ms at the H100's 3.35 TB/s; the
// f32 operations (~12·rank per entry) are far below the card's rate. Split
// by what each kernel must move: A the distinct-row reads of both sides
// with ω, the streams and V's writes; B U's writes.
//
// What bounds the pair on this card: random 512-byte row traffic, not the
// instruction stream any more. Measured with scripts/torch_step_pair_bench.py
// (H100 80GB HBM3, 700 W, the bench step): the previous pair took 0.142 ms (A
// 0.076, B 0.066; the same from a cold L2), with 75 / 63 registers a
// thread (24 / 32 warps an SM), ~10 warp shuffles an entry to read back
// its scalars (A 5 more for its dot), four 4-byte loads a 512-byte row and
// two entries' gathers in flight a warp. This pair takes ~0.127 ms (A
// ~0.063, B ~0.064) with 48 / 55 registers: A gained, B barely moved. A
// kernel that only reads each of B's 117,816 distinct U rows and writes it
// back in place, one warp a row, takes 0.046 ms (2.6 TB/s): B's own row
// traffic, not its issue, sets B's floor, and B spends the rest on its
// per-entry snapshot gathers and the entries' scalars (a ring of 4 or of
// 8 made no difference to it). The step's bound assumes streaming rates
// for those rows.
//   - 16-byte rows: where rank % 4 == 0 (and the tables are 16-byte
//     aligned) a lane holds 4 contiguous columns, so a 128-column row is one
//     access a warp; other ranks keep one column a lane (W = 1 below).
//   - a ring of kStages = 8 row slots a warp in shared memory, filled with
//     cp.async (16 bytes a lane; 4 on the W = 1 route): the gathered rows
//     and each segment's old row are queued in the order they are used,
//     kStages ahead of their use, so a warp keeps up to 8 row loads in
//     flight whatever its registers (4 measured ~2% slower on the step, 12
//     ~10%: 58 KB a block leaves 3 blocks an SM). Each lane copies and
//     reads back only its own columns, so its own cp.async.wait_group is
//     the only synchronisation (no mbarrier, no cross-lane wait).
//   - the owned positions' scalars (the gathered row, r or e, w, the
//     collision scale; at a segment start its row and λ/max(ω,1)) staged in
//     shared memory once per warp and read back as one 16-byte broadcast an
//     entry, in place of the shuffles.
//   - L2 eviction priorities (createpolicy): A's U gathers, the snapshot
//     and e that A writes for B, and B's snapshot gathers evict last
//     (~1% on the warm step, nothing resolved over a stratum); the rest
//     keeps the normal priority (evict_first there, or V's rows kept in
//     place of U's, moved nothing).
//   - the plan walks a step's visits in order in A and in reverse in B
//     (ops/cuda_sgd.py::_visit_order), so B starts on the rows A touched
//     last: ~3% on stratum 0 against row order alone.
// What the design still moves beyond the bound, per step: one gathered U
// row per real entry in A and one snapshot row per real entry in B (L2
// traffic: the rows of one visit, ~7.5 MB of U and ~3.5 MB of snapshot, are
// re-read within it), each touched U row read again by B after A gathered
// it, the snapshot written once per item row, 4 B of e written and read
// per entry, and the plan (20 B per entry and side).
//
// bf16 factor storage (the half=True branch of both TPU kernels,
// ops/pallas_sgd.py:193-198, :226-228, :270-274 and :475-478, :552-554,
// :604-606): the tables rest in bf16; each visit works on an f32 copy of
// its slices and rounds back once at the visit's end. Every U and V block is
// visited once per stratum, so a row's work value is its bf16 value until
// its first step in the stratum, and its stored value after the stratum is
// the bf16 rounding of its work value after its last step; a row the
// stratum never touches round-trips unchanged. The same two kernels, built
// with H = true (sgd_*_rows_bf16_launch), take the bf16 tables beside one
// f32 work table a side and a touch-flag byte per plan position
// (ops/cuda_sgd.py::build_step_plan): kFirst / kLast mark the position's
// segment row at its first / last step in the stratum, kGatherFirst (kernel
// A) the gathered U row at its first. A first-touch row is read from the
// bf16 table and upcast exactly on its read from shared memory (the bf16
// bits in the f32 high half); a last-touch row is rounded to nearest even
// (__float2bfloat16_rn, the rounding of Tensor.to, of jnp.astype and of
// f32_to_bf16_kernel) and written to the bf16 table; every other read and
// write goes to the work table. The snapshot and e stay f32. Each lane keeps
// its columns and the dot its reduction order, so the tables come out
// bit-equal to the earlier route below, with no cast launch.
// Bound: the f32 step's, less 2 B a column of each row's first read and
// last write in the stratum (~0.61 ms a stratum at the bench geometry
// against the f32 pair's ~0.64). What the design does about its costs:
//   - the flags are dense only at a stratum's first and last steps; a warp
//     whose window holds no flag runs the f32 body, paying one byte a
//     position (loaded beside the rows) and one vote;
//   - a bf16 row lands in its ring slot as it is (the slot's first 2·rank
//     bytes), each lane copying its own 4 columns (one 8-byte cp.async.ca),
//     so a lane reads back only what it copied, as in the f32 ring (16-byte
//     copies of 8 columns by half the lanes, with a __syncwarp before the
//     read, made the stratum slower: scripts/torch_step_pair_bench.py,
//     variant wide16); the W = 1 route (no 2-byte cp.async) loads them
//     plainly and stores them upcast;
//   - f32 and bf16 rows are queued by separate fills and only a take that
//     may meet a bf16 row tests for one (kernel B's snapshot rows never
//     do), so the per-entry path of the bf16 body adds one test in A;
//   - kernel A's bf16 build at rank <= 128 is held to 5 blocks an SM
//     (kBlocksA), the f32 build's occupancy.
//   bf16_to_f32_kernel  the earlier route, kept as the baseline the flagged
//   f32_to_bf16_kernel  one is held against (no path of the port calls it):
//                       both whole tables upcast (exact) at the stratum's
//                       start, the f32 pair on the work tables, both rounded
//                       back (round to nearest even) at its end.
// Both cast kernels take the two tables in one launch, 16-byte loads and
// stores, a grid-stride loop over 8-element vectors, and a scalar tail. Their
// bound is bytes: n·(2 + 4) B per cast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

// the block's dynamic shared memory: each warp's ring, entries and starts
extern __shared__ float4 dsgd_smem[];

namespace {

constexpr int kWarps = 8;     // warps per thread block
constexpr int kMaxCols = 8;   // columns per lane: rank <= 32 * kMaxCols
constexpr int kStages = 8;    // row loads a warp keeps in flight (its ring)
constexpr int kOwn = 16;      // positions whose short segments a warp owns
constexpr int kWindow = 32;   // positions a warp loads in one round
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = INT_MIN;  // no row (outside the step)
// resident blocks an SM that the bf16 build of kernel A at 4 columns a lane
// and one chunk (rank <= 128) is held to: the f32 build's (left to itself
// the bf16 build takes more registers and holds one block fewer)
constexpr int kBlocksA = 5;
static_assert(kStages >= 2, "a segment start takes two slots at once");

// touch flags of a plan position (H = true): its segment's row at its first
// / last step in the stratum; kernel A: the gathered U row at its first
constexpr unsigned kFirst = 1u, kLast = 2u, kGatherFirst = 4u;

using bf16_t = uint16_t;  // a bf16 table's raw bits

__device__ __forceinline__ float bf16_bits_to_f32(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x = lo
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ bf16_t round_bf16(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}


// -- L2 eviction priorities and hinted accesses ------------------------------

struct Policies {
  uint64_t keep;  // read again within the step
  uint64_t once;  // read or written once in the step
};

// `keep` evicts last. `once` keeps the normal priority: evict_first there
// did not move the bench step (scripts/torch_step_pair_bench.py, variant
// once_first).
__device__ __forceinline__ Policies policies() {
  Policies p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p.keep));
  asm("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;" : "=l"(p.once));
  return p;
}

__device__ __forceinline__ int ld_int(const int32_t* p, uint64_t pol) {
  int v;
  asm volatile("ld.global.L2::cache_hint.b32 %0, [%1], %2;"
               : "=r"(v) : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ float ld_float(const float* p, uint64_t pol) {
  float v;
  asm volatile("ld.global.L2::cache_hint.f32 %0, [%1], %2;"
               : "=f"(v) : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ void st_float(float* p, float v, uint64_t pol) {
  asm volatile("st.global.L2::cache_hint.f32 [%0], %1, %2;"
               :: "l"(p), "f"(v), "l"(pol) : "memory");
}

// -- rows: a lane holds NCH chunks of W contiguous columns --------------------
// Chunk j of lane l covers columns [W·(l + 32j), W·(l + 32j) + W). W = 4 (one
// 16-byte access a lane) needs rank % 4 == 0 and 16-byte aligned tables; W =
// 1 takes any rank. A chunk at or past `rank` is 0 and never stored.

template <int W>
__device__ __forceinline__ int col(int j, int lane) {
  return W * (lane + 32 * j);
}

template <int W, int NCH>
__device__ __forceinline__ void load_row(float (&x)[W * NCH],
                                         const float* row, int lane,
                                         int rank, uint64_t pol) {
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int c = col<W>(j, lane);
    if constexpr (W == 4) {
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (c < rank)
        asm volatile("ld.global.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, "
                     "[%4], %5;"
                     : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                     : "l"(row + c), "l"(pol));
      x[4 * j] = v.x;
      x[4 * j + 1] = v.y;
      x[4 * j + 2] = v.z;
      x[4 * j + 3] = v.w;
    } else {
      x[j] = c < rank ? ld_float(row + c, pol) : 0.0f;
    }
  }
}

template <int W, int NCH>
__device__ __forceinline__ void store_row(float* row,
                                          const float (&x)[W * NCH],
                                          int lane, int rank, uint64_t pol) {
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int c = col<W>(j, lane);
    if (c >= rank) continue;
    if constexpr (W == 4) {
      asm volatile("st.global.L2::cache_hint.v4.f32 [%0], {%1, %2, %3, %4}, "
                   "%5;"
                   :: "l"(row + c), "f"(x[4 * j]), "f"(x[4 * j + 1]),
                      "f"(x[4 * j + 2]), "f"(x[4 * j + 3]), "l"(pol)
                   : "memory");
    } else {
      st_float(row + c, x[j], pol);
    }
  }
}

// A bf16 row's columns of this lane, upcast (plain loads: a segment's old
// row on the long route).
template <int W, int NCH>
__device__ __forceinline__ void load_row16(float (&x)[W * NCH],
                                           const bf16_t* row, int lane,
                                           int rank) {
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int c = col<W>(j, lane);
    if constexpr (W == 4) {
      const uint2 v = c < rank ? *reinterpret_cast<const uint2*>(row + c)
                               : make_uint2(0u, 0u);
      x[4 * j] = bf16_bits_to_f32(v.x & 0xffffu);
      x[4 * j + 1] = bf16_bits_to_f32(v.x >> 16);
      x[4 * j + 2] = bf16_bits_to_f32(v.y & 0xffffu);
      x[4 * j + 3] = bf16_bits_to_f32(v.y >> 16);
    } else {
      x[j] = c < rank ? bf16_bits_to_f32(row[c]) : 0.0f;
    }
  }
}

// This lane's columns rounded to bf16 (nearest even) into a bf16 row.
template <int W, int NCH>
__device__ __forceinline__ void store_row16(bf16_t* row,
                                            const float (&x)[W * NCH],
                                            int lane, int rank) {
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int c = col<W>(j, lane);
    if (c >= rank) continue;
    if constexpr (W == 4)
      *reinterpret_cast<uint2*>(row + c) =
          make_uint2(pack_bf16x2(x[4 * j], x[4 * j + 1]),
                     pack_bf16x2(x[4 * j + 2], x[4 * j + 3]));
    else
      row[c] = round_bf16(x[j]);
  }
}

// A segment's row into its table: the bf16 one at its last step (H), else
// the f32 one.
template <int W, int NCH, bool H>
__device__ __forceinline__ void put_row(float* row32, bf16_t* row16,
                                        bool last, const float (&x)[W * NCH],
                                        int lane, int rank, uint64_t pol) {
  if (H && last)
    store_row16<W, NCH>(row16, x, lane, rank);
  else
    store_row<W, NCH>(row32, x, lane, rank, pol);
}

// u·v over the warp (each lane's columns, then a butterfly of shuffles).
template <int N>
__device__ __forceinline__ float warp_dot(const float (&u)[N],
                                          const float (&v)[N]) {
  float dot = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) dot += u[i] * v[i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    dot += __shfl_xor_sync(kFull, dot, off);
  return dot;
}

// -- a warp's shared memory ---------------------------------------------------

// An owned position's scalars, staged by the lane that loaded them and read
// back by every lane as one 16-byte broadcast: the row its entry gathers,
// then kernel A's r (kernel B's e), w and collision scale.
struct alignas(16) Entry {
  int gather;
  float x, w, c;
};

// A segment start's row and its regularizer λ/max(ω, 1).
struct alignas(8) Start {
  int row;
  float reg;
};

template <int W, int NCH>
struct WarpSmem {
  static constexpr int kCap = 32 * W * NCH;  // floats in a ring slot
  static constexpr int kRingBytes = kStages * kCap * 4;
  static constexpr int kBytes = kRingBytes + 2 * kWindow * sizeof(Entry) +
                                kOwn * sizeof(Start);
  float* ring;
  Entry* entries;  // by window offset, [2 · kWindow]
  Start* starts;   // by window offset, [kOwn]

  __device__ explicit WarpSmem(int warp) {
    char* base = reinterpret_cast<char*>(dsgd_smem) + warp * kBytes;
    ring = reinterpret_cast<float*>(base);
    entries = reinterpret_cast<Entry*>(base + kRingBytes);
    starts = reinterpret_cast<Start*>(base + kRingBytes +
                                      2 * kWindow * sizeof(Entry));
  }
};

template <int W, int NCH>
constexpr int block_smem_bytes() {
  return kWarps * WarpSmem<W, NCH>::kBytes;
}

// -- the ring: kStages row loads in flight, used in the order queued ----------
// One cp.async group per queued row (an empty one past the warp's last row),
// so before the n-th take n + kStages groups are committed and
// cp.async.wait_group kStages − 1 means row n has landed. A lane copies and
// reads back only its own chunks: its own wait is all the synchronisation.
// A slot is refilled only after the row taken from it has been used and the
// warp has passed a __syncwarp. With H, a queued row may be a bf16 row
// (fill16, header): `half` marks its slot until its take (warp-uniform).

template <int W>
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           uint64_t pol) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (W == 4)
    asm volatile(
        "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;"
        :: "r"(d), "l"(src), "l"(pol) : "memory");
  else
    asm volatile(
        "cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 4, %2;"
        :: "r"(d), "l"(src), "l"(pol) : "memory");
}

// 8 bytes (4 bf16 columns).
__device__ __forceinline__ void copy_async8(void* dst, const bf16_t* src,
                                            uint64_t pol) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 8, %2;"
               :: "r"(d), "l"(src), "l"(pol) : "memory");
}

template <int W, int NCH, bool H = false>
struct Ring {
  static constexpr int kCap = WarpSmem<W, NCH>::kCap;
  float* slots;
  int fill_at = 0, take_at = 0;
  unsigned half = 0u;  // H, W = 4: bit s while slot s holds bf16 bits

  __device__ explicit Ring(float* s) : slots(s) {}

  // Queue one f32 row (nullptr: nothing left to queue).
  __device__ __forceinline__ void fill(const float* row, uint64_t pol,
                                       int lane, int rank) {
    if (row != nullptr) {
      float* slot = slots + fill_at * kCap;
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        const int c = col<W>(j, lane);
        if (c < rank) copy_async<W>(slot + c, row + c, pol);
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
    fill_at = fill_at + 1 == kStages ? 0 : fill_at + 1;
  }

  // Queue one bf16 row (H); its slot is marked until its take (B16).
  __device__ __forceinline__ void fill16(const bf16_t* row, uint64_t pol,
                                         int lane, int rank) {
    float* slot = slots + fill_at * kCap;
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int c = col<W>(j, lane);
      if (c >= rank) continue;
      if constexpr (W == 4)  // this lane's 4 columns at 2·c bytes
        copy_async8(reinterpret_cast<bf16_t*>(slot) + c, row + c, pol);
      else
        slot[c] = bf16_bits_to_f32(row[c]);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
    if constexpr (W == 4) half |= 1u << fill_at;
    fill_at = fill_at + 1 == kStages ? 0 : fill_at + 1;
  }

  // The oldest queued row, into registers; kPending = the groups that may
  // still be in flight (kStages − 1, or kStages − 2 for a second take
  // before a refill); B16: the row may be a bf16 row (H; a take that never
  // meets one skips the test).
  template <int kPending, bool B16 = H>
  __device__ __forceinline__ void take(float (&x)[W * NCH], int lane,
                                       int rank) {
    asm volatile("cp.async.wait_group %0;" :: "n"(kPending) : "memory");
    const float* slot = slots + take_at * kCap;
    const bool b16 = B16 && W == 4 && ((half >> take_at) & 1u);
    if (b16) half &= ~(1u << take_at);
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int c = col<W>(j, lane);
      if constexpr (W == 4 && !B16) {
        const float4 v = c < rank
                             ? *reinterpret_cast<const float4*>(slot + c)
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        x[4 * j] = v.x;
        x[4 * j + 1] = v.y;
        x[4 * j + 2] = v.z;
        x[4 * j + 3] = v.w;
      } else if constexpr (W == 4) {
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (b16) {  // the row's bf16 bits: this lane's 4 at 2·c bytes
          if (c < rank) {
            const uint2 b = *reinterpret_cast<const uint2*>(
                reinterpret_cast<const bf16_t*>(slot) + c);
            v = make_float4(bf16_bits_to_f32(b.x & 0xffffu),
                            bf16_bits_to_f32(b.x >> 16),
                            bf16_bits_to_f32(b.y & 0xffffu),
                            bf16_bits_to_f32(b.y >> 16));
          }
        } else if (c < rank) {
          v = *reinterpret_cast<const float4*>(slot + c);
        }
        x[4 * j] = v.x;
        x[4 * j + 1] = v.y;
        x[4 * j + 2] = v.z;
        x[4 * j + 3] = v.w;
      } else {
        x[j] = c < rank ? slot[c] : 0.0f;
      }
    }
    take_at = take_at + 1 == kStages ? 0 : take_at + 1;
  }
};

// -- long segments: a block each ----------------------------------------------
// The entries [beg, end) are cut into chunks of `chunk`, dealt round robin to
// the block's warps, each walking its chunks in entry order through its ring
// (the feed below queues the gathered rows; the walk loads each chunk's
// scalars lane-parallel and reads them back by shuffle). Then warp 0 adds the
// kWarps partial sums to the old row in warp order.

// The rows a warp of a long block gathers, in its walk's order: `idx` holds
// the gathered row of position lo + lane of the chunk being queued (~row
// where HG and the row is at its first step: read from the bf16 table).
struct LongFeed {
  int lo, t, idx;
};

template <bool HG>
__device__ __forceinline__ int chunk_row(const int32_t* gather,
                                         const uint8_t* flag, int lo, int end,
                                         int chunk, int lane, uint64_t pol) {
  if constexpr (!HG) {
    return lane < chunk && lo + lane < end ? ld_int(gather + lo + lane, pol)
                                           : 0;
  } else {
    if (lane >= chunk || lo + lane >= end) return 0;
    const int row = ld_int(gather + lo + lane, pol);
    return flag[lo + lane] & kGatherFirst ? ~row : row;
  }
}

template <int W, int NCH, bool HG>
__device__ __forceinline__ void feed_long(Ring<W, NCH, HG>& ring, LongFeed& f,
                                          const float* table,
                                          const bf16_t* table16,
                                          const int32_t* gather,
                                          const uint8_t* flag, int end,
                                          int chunk, int lane, int rank,
                                          const Policies& pol) {
  const float* src = nullptr;
  const bf16_t* src16 = nullptr;  // HG: a first-touch row
  if (f.lo < end) {
    const int g = __shfl_sync(kFull, f.idx, f.t - f.lo);
    if (HG && g < 0)
      src16 = table16 + (int64_t)~g * rank;
    else
      src = table + (int64_t)g * rank;
    if (++f.t == min(f.lo + chunk, end)) {
      f.lo += kWarps * chunk;
      f.t = f.lo;
      if (f.lo < end) f.idx = chunk_row<HG>(gather, flag, f.lo, end, chunk,
                                            lane, pol.once);
    }
  }
  if (HG && src16 != nullptr)  // read once in the stratum
    ring.fill16(src16, pol.once, lane, rank);
  else
    ring.fill(src, pol.keep, lane, rank);
}

template <int W, int NCH, bool HG>
__device__ __forceinline__ LongFeed start_long(
    Ring<W, NCH, HG>& ring, const float* table, const bf16_t* table16,
    const int32_t* gather, const uint8_t* flag, int beg, int end, int chunk,
    int warp, int lane, int rank, const Policies& pol) {
  LongFeed f{beg + warp * chunk, beg + warp * chunk, 0};
  if (f.lo < end)
    f.idx = chunk_row<HG>(gather, flag, f.lo, end, chunk, lane, pol.once);
  for (int s = 0; s < kStages; ++s)
    feed_long(ring, f, table, table16, gather, flag, end, chunk, lane, rank,
              pol);
  return f;
}

// A long segment's kWarps partial sums, added to the old row in warp order
// by warp 0 (the only warp that returns true). The partials go through the
// warps' rings, idle by then.
template <int W, int NCH>
__device__ __forceinline__ bool combine_partials(float (&acc)[W * NCH],
                                                 const float (&old)[W * NCH],
                                                 int warp, int lane,
                                                 int rank) {
  constexpr int N = W * NCH;
  asm volatile("cp.async.wait_all;" ::: "memory");
  float* mine = WarpSmem<W, NCH>(warp).ring;
#pragma unroll
  for (int j = 0; j < NCH; ++j)
#pragma unroll
    for (int k = 0; k < W; ++k) mine[col<W>(j, lane) + k] = acc[W * j + k];
  __syncthreads();
  if (warp != 0) return false;
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = old[i];
  for (int w = 0; w < kWarps; ++w) {
    const float* part = WarpSmem<W, NCH>(w).ring;
#pragma unroll
    for (int j = 0; j < NCH; ++j)
#pragma unroll
      for (int k = 0; k < W; ++k) acc[W * j + k] += part[col<W>(j, lane) + k];
  }
  return true;
}

// A long segment's old row: from the bf16 table at its first step (H).
template <int W, int NCH, bool H>
__device__ __forceinline__ void get_row(float (&x)[W * NCH],
                                        const float* row32,
                                        const bf16_t* row16, bool first,
                                        int lane, int rank, uint64_t pol) {
  if (H && first)
    load_row16<W, NCH>(x, row16, lane, rank);
  else
    load_row<W, NCH>(x, row32, lane, rank, pol);
}

// Kernel A's long segment: per entry, the gathered u, e = (r − u·v)·w into
// e_buf, dv added into acc in entry order; then the row and its snapshot.
template <int W, int NCH, bool H>
__device__ __forceinline__ void item_long(
    const float* __restrict__ U, float* __restrict__ V,
    const bf16_t* __restrict__ U16, bf16_t* __restrict__ V16,
    const float* __restrict__ omega_v, const int32_t* __restrict__ prow,
    const int32_t* __restrict__ su, const float* __restrict__ sr,
    const float* __restrict__ sw, const float* __restrict__ sc,
    const uint8_t* __restrict__ flag, int e0,
    const int32_t* __restrict__ longs, int chunk, float* __restrict__ e_buf,
    float* __restrict__ snap, int rank, float lr, float lam, int warp,
    int lane, const Policies& pol) {
  constexpr int N = W * NCH;
  const int beg = longs[2 * blockIdx.x], end = longs[2 * blockIdx.x + 1];
  const int64_t row = ~prow[beg];
  const unsigned touch = H ? flag[beg] : 0u;  // the segment's: one row
  Ring<W, NCH, H> ring(WarpSmem<W, NCH>(warp).ring);
  LongFeed f = start_long(ring, U, U16, su, flag, beg, end, chunk, warp,
                          lane, rank, pol);
  float v[N], acc[N];
  get_row<W, NCH, H>(v, V + row * rank, V16 + row * rank, touch & kFirst,
                     lane, rank, pol.once);
  const float reg_v = lam / fmaxf(ld_float(omega_v + row, pol.once), 1.0f);
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.0f;
  for (int lo = beg + warp * chunk; lo < end; lo += kWarps * chunk) {
    const int hi = min(lo + chunk, end), p = lo + lane;
    const bool in = lane < chunk && p < hi;
    const float r_l = in ? ld_float(sr + p, pol.once) : 0.0f;
    const float w_l = in ? ld_float(sw + p, pol.once) : 0.0f;
    const float c_l = in ? ld_float(sc + p, pol.once) : 0.0f;
    float e_l = 0.0f;
    for (int t = lo; t < hi; ++t) {
      float u[N];
      ring.template take<kStages - 1>(u, lane, rank);
      const int q = t - lo;
      const float r = __shfl_sync(kFull, r_l, q);
      const float w = __shfl_sync(kFull, w_l, q);
      const float c = __shfl_sync(kFull, c_l, q);
      const float err = (r - warp_dot(u, v)) * w;
      if (lane == q) e_l = err;
#pragma unroll
      for (int i = 0; i < N; ++i)
        acc[i] += (lr * (err * u[i] - reg_v * v[i] * w)) * c;
      __syncwarp();
      feed_long(ring, f, U, U16, su, flag, end, chunk, lane, rank, pol);
    }
    if (in) st_float(e_buf + p - e0, e_l, pol.keep);
  }
  if (!combine_partials<W, NCH>(acc, v, warp, lane, rank)) return;
  put_row<W, NCH, H>(V + row * rank, V16 + row * rank, touch & kLast, acc,
                     lane, rank, pol.once);
  store_row<W, NCH>(snap + row * rank, v, lane, rank, pol.keep);
}

// Kernel B's long segment: per entry, its e and its item's snapshot row, du
// added into acc in entry order; then the row.
template <int W, int NCH, bool H>
__device__ __forceinline__ void user_long(
    float* __restrict__ U, bf16_t* __restrict__ U16,
    const float* __restrict__ omega_u, const int32_t* __restrict__ prow,
    const int32_t* __restrict__ epos, const int32_t* __restrict__ vrow,
    const float* __restrict__ sw, const float* __restrict__ sc,
    const uint8_t* __restrict__ flag, int e0,
    const int32_t* __restrict__ longs, int chunk,
    const float* __restrict__ e_buf, const float* __restrict__ snap,
    int rank, float lr, float lam, int warp, int lane, const Policies& pol) {
  constexpr int N = W * NCH;
  const int beg = longs[2 * blockIdx.x], end = longs[2 * blockIdx.x + 1];
  const int64_t row = ~prow[beg];
  const unsigned touch = H ? flag[beg] : 0u;
  Ring<W, NCH> ring(WarpSmem<W, NCH>(warp).ring);
  LongFeed f = start_long(ring, snap, nullptr, vrow, nullptr, beg, end,
                          chunk, warp, lane, rank, pol);
  float u[N], acc[N];
  get_row<W, NCH, H>(u, U + row * rank, U16 + row * rank, touch & kFirst,
                     lane, rank, pol.once);
  const float reg_u = lam / fmaxf(ld_float(omega_u + row, pol.once), 1.0f);
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.0f;
  for (int lo = beg + warp * chunk; lo < end; lo += kWarps * chunk) {
    const int hi = min(lo + chunk, end), p = lo + lane;
    const bool in = lane < chunk && p < hi;
    const float e_l =
        in ? ld_float(e_buf + ld_int(epos + p, pol.once) - e0, pol.once)
           : 0.0f;
    const float w_l = in ? ld_float(sw + p, pol.once) : 0.0f;
    const float c_l = in ? ld_float(sc + p, pol.once) : 0.0f;
    for (int t = lo; t < hi; ++t) {
      float v[N];
      ring.template take<kStages - 1>(v, lane, rank);
      const int q = t - lo;
      const float err = __shfl_sync(kFull, e_l, q);
      const float w = __shfl_sync(kFull, w_l, q);
      const float c = __shfl_sync(kFull, c_l, q);
#pragma unroll
      for (int i = 0; i < N; ++i)
        acc[i] += (lr * (err * v[i] - reg_u * u[i] * w)) * c;
      __syncwarp();
      feed_long(ring, f, snap, nullptr, vrow, nullptr, end, chunk, lane,
                rank, pol);
    }
  }
  if (!combine_partials<W, NCH>(acc, u, warp, lane, rank)) return;
  put_row<W, NCH, H>(U + row * rank, U16 + row * rank, touch & kLast, acc,
                     lane, rank, pol.once);
}

// -- short segments: a warp owns those that start in kOwn positions -----------
// A segment ends at most chunk − 1 <= 31 positions after it starts, inside
// the two 32-position windows from the warp's base. Its lanes load the first
// window's rows in one coalesced round (the second window's only when the
// last owned segment reaches it) and find the owned offsets by ballot; they
// stage each owned position's scalars (and each start's row and λ/max(ω,1))
// in shared memory, queue the first kStages row loads, and then the warp
// walks the owned positions in order: at a segment start it stores the
// previous row and takes the new row's old value from the ring, then per
// position it takes the gathered row, adds the delta, and queues the next
// loads. A segment's deltas are added one at a time in entry order, starting
// from its old row.

struct Window {
  int first, end;   // owned offsets [first, end) from base; first < 0: none
  unsigned starts;  // bit o: an owned segment starts at offset o (< kOwn)
};

// Which offsets from `base` this warp owns, from each lane's row of the
// first window (ra) and the row at base − 1 (before); loads the second
// window's rows into rb (else kNone) when the last owned segment reaches
// it.
__device__ __forceinline__ Window own_window(
    const int32_t* __restrict__ prow, int pb, int e1, int ra, int before,
    int lane, int& rb, uint64_t pol) {
  const int prev = __shfl_up_sync(kFull, ra, 1);
  const unsigned starts = __ballot_sync(
      kFull, lane < kOwn && ra >= 0 && ra != (lane == 0 ? before : prev));
  rb = kNone;
  if (!starts) return Window{-1, -1, 0u};
  const int last = 31 - __clz(starts);
  const int last_row = __shfl_sync(kFull, ra, last);
  // the first offset after `last` whose row differs: in this window, or
  // else in the next
  const unsigned diff_a =
      __ballot_sync(kFull, ra != last_row) & ~((2u << last) - 1);
  if (diff_a) return Window{__ffs(starts) - 1, __ffs(diff_a) - 1, starts};
  rb = pb < e1 ? ld_int(prow + pb, pol) : kNone;
  const unsigned diff_b = __ballot_sync(kFull, rb != last_row);
  return Window{__ffs(starts) - 1,
                kWindow + (diff_b ? __ffs(diff_b) - 1 : kWindow), starts};
}

__device__ __forceinline__ bool starts_at(const Window& own, int o) {
  return o < kOwn && ((own.starts >> o) & 1u);
}

// A short-segment warp's row loads in the order it uses them: at a segment
// start the row's old value (from `olds`, or from `olds16` where H and bit o
// of `firsts`), then each position's gathered row (from `gathered`, or from
// `gathered16` where GH and the entry's gather is ~row).
struct ShortFeed {
  int o;     // next position to queue
  bool old;  // its segment's old row is queued
};

template <bool GH, int W, int NCH, bool H>
__device__ __forceinline__ void feed_short(
    Ring<W, NCH, H>& ring, ShortFeed& f, const Window& own,
    const WarpSmem<W, NCH>& sm, const float* olds, const bf16_t* olds16,
    unsigned firsts, uint64_t old_pol, const float* gathered,
    const bf16_t* gathered16, uint64_t gather_pol, int lane, int rank) {
  if constexpr (!H) {
    const float* src = nullptr;
    uint64_t pol = gather_pol;
    if (f.o < own.end) {
      if (!f.old && starts_at(own, f.o)) {
        src = olds + (int64_t)sm.starts[f.o].row * rank;
        pol = old_pol;
        f.old = true;
      } else {
        src = gathered + (int64_t)sm.entries[f.o].gather * rank;
        ++f.o;
        f.old = false;
      }
    }
    ring.fill(src, pol, lane, rank);
  } else if (f.o >= own.end) {
    ring.fill(nullptr, gather_pol, lane, rank);
  } else if (!f.old && starts_at(own, f.o)) {
    const int64_t at = (int64_t)sm.starts[f.o].row * rank;
    if ((firsts >> f.o) & 1u)
      ring.fill16(olds16 + at, old_pol, lane, rank);
    else
      ring.fill(olds + at, old_pol, lane, rank);
    f.old = true;
  } else {
    const int g = sm.entries[f.o].gather;
    if (GH && g < 0)  // read once in the stratum: the normal priority
      ring.fill16(gathered16 + (int64_t)~g * rank, old_pol, lane, rank);
    else
      ring.fill(gathered + (int64_t)g * rank, gather_pol, lane, rank);
    ++f.o;
    f.old = false;
  }
}

// H: the touch flags of the window's owned starts as two masks by offset
// (the starts lie in the first window, whose flags `fa` the lanes hold).
struct Touch {
  unsigned firsts, lasts;
};

template <bool H>
__device__ __forceinline__ Touch start_touch(bool starter, unsigned fa) {
  if (!H) return Touch{0u, 0u};
  return Touch{__ballot_sync(kFull, starter && (fa & kFirst)),
               __ballot_sync(kFull, starter && (fa & kLast))};
}

// Kernel A's owned window (short segments); H: the flagged route, `fa` /
// `fb` the touch flags of the window's positions (a first-touch gather is
// staged as ~row).
template <int W, int NCH, bool H>
__device__ __forceinline__ void item_short(
    const float* __restrict__ U, float* __restrict__ V,
    const bf16_t* __restrict__ U16, bf16_t* __restrict__ V16,
    const float* __restrict__ omega_v, const int32_t* __restrict__ su,
    const float* __restrict__ sr, const float* __restrict__ sw,
    const float* __restrict__ sc, int e0, float* __restrict__ e_buf,
    float* __restrict__ snap, int rank, float lr, float lam, int warp,
    int lane, const Policies& pol, const Window& own, int pa, int pb, int ra,
    bool in_a, bool in_b, unsigned fa, unsigned fb) {
  constexpr int N = W * NCH;
  const WarpSmem<W, NCH> sm(warp);
  if (in_a) {
    const int g = ld_int(su + pa, pol.once);
    sm.entries[lane] = Entry{H && (fa & kGatherFirst) ? ~g : g,
                             ld_float(sr + pa, pol.once),
                             ld_float(sw + pa, pol.once),
                             ld_float(sc + pa, pol.once)};
  }
  if (in_b) {
    const int g = ld_int(su + pb, pol.once);
    sm.entries[kWindow + lane] = Entry{H && (fb & kGatherFirst) ? ~g : g,
                                       ld_float(sr + pb, pol.once),
                                       ld_float(sw + pb, pol.once),
                                       ld_float(sc + pb, pol.once)};
  }
  const bool starter = (own.starts >> lane) & 1u;
  if (starter) sm.starts[lane].row = ra;
  const Touch touch = start_touch<H>(starter, fa);
  __syncwarp();
  Ring<W, NCH, H> ring(sm.ring);
  ShortFeed f{own.first, false};
  for (int s = 0; s < kStages; ++s)
    feed_short<H>(ring, f, own, sm, V, V16, touch.firsts, pol.once, U, U16,
                  pol.keep, lane, rank);
  if (starter)
    sm.starts[lane].reg = lam / fmaxf(ld_float(omega_v + ra, pol.once), 1.0f);
  __syncwarp();
  float acc[N], vcur[N], reg_v = 0.0f, ea = 0.0f, eb = 0.0f;
  int cur = kNone;
  bool cur_last = false;
  for (int o = own.first; o < own.end; ++o) {
    const bool st = starts_at(own, o);
    float u[N];
    if (st) {  // a segment starts: store the one before
      if (cur != kNone) {
        put_row<W, NCH, H>(V + (int64_t)cur * rank, V16 + (int64_t)cur * rank,
                           cur_last, acc, lane, rank, pol.once);
        store_row<W, NCH>(snap + (int64_t)cur * rank, vcur, lane, rank,
                          pol.keep);
      }
      const Start s = sm.starts[o];
      cur = s.row;
      cur_last = (touch.lasts >> o) & 1u;
      reg_v = s.reg;
      ring.template take<kStages - 1>(vcur, lane, rank);
      ring.template take<kStages - 2>(u, lane, rank);
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] = vcur[i];
    } else {
      ring.template take<kStages - 1>(u, lane, rank);
    }
    const Entry en = sm.entries[o];
    const float err = (en.x - warp_dot(u, vcur)) * en.w;
    if (lane == (o & 31)) {
      if (o < kWindow) ea = err; else eb = err;
    }
#pragma unroll
    for (int i = 0; i < N; ++i)
      acc[i] += (lr * (err * u[i] - reg_v * vcur[i] * en.w)) * en.c;
    __syncwarp();
    feed_short<H>(ring, f, own, sm, V, V16, touch.firsts, pol.once, U, U16,
                  pol.keep, lane, rank);
    if (st)
      feed_short<H>(ring, f, own, sm, V, V16, touch.firsts, pol.once, U, U16,
                    pol.keep, lane, rank);
  }
  put_row<W, NCH, H>(V + (int64_t)cur * rank, V16 + (int64_t)cur * rank,
                     cur_last, acc, lane, rank, pol.once);
  store_row<W, NCH>(snap + (int64_t)cur * rank, vcur, lane, rank, pol.keep);
  if (in_a) st_float(e_buf + pa - e0, ea, pol.keep);
  if (in_b) st_float(e_buf + pb - e0, eb, pol.keep);
}

// Kernel A's body (the kernels below).
template <int W, int NCH, bool H>
__device__ __forceinline__ void item_rows(
    const float* __restrict__ U, float* __restrict__ V,
    const bf16_t* __restrict__ U16, bf16_t* __restrict__ V16,
    const float* __restrict__ omega_v, const int32_t* __restrict__ prow,
    const int32_t* __restrict__ su, const float* __restrict__ sr,
    const float* __restrict__ sw, const float* __restrict__ sc,
    const uint8_t* __restrict__ flag, int e0, int e1,
    const int32_t* __restrict__ longs, int n_long, int chunk,
    float* __restrict__ e_buf, float* __restrict__ snap, int rank, float lr,
    float lam) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Policies pol = policies();
  if ((int)blockIdx.x < n_long) {
    item_long<W, NCH, H>(U, V, U16, V16, omega_v, prow, su, sr, sw, sc, flag,
                         e0, longs, chunk, e_buf, snap, rank, lr, lam, warp,
                         lane, pol);
    return;
  }
  const int base = e0 + (((int)blockIdx.x - n_long) * kWarps + warp) * kOwn;
  if (base >= e1) return;
  const int pa = base + lane, pb = pa + kWindow;
  const int ra = pa < e1 ? ld_int(prow + pa, pol.once) : kNone;
  const int before = base > e0 ? ld_int(prow + base - 1, pol.once) : kNone;
  // H: the touch flags, loaded beside the rows
  const unsigned la = H && pa < e1 ? flag[pa] : 0u;
  const unsigned lb = H && pb < e1 ? flag[pb] : 0u;
  int rb;
  const Window own = own_window(prow, pb, e1, ra, before, lane, rb,
                                pol.once);
  if (own.first < 0) return;
  const bool in_a = lane >= own.first && lane < own.end;
  const bool in_b = kWindow + lane < own.end;
  if constexpr (H) {  // a window without a touch flag takes the f32 body
    const unsigned fa = in_a ? la : 0u, fb = in_b ? lb : 0u;
    if (__any_sync(kFull, fa | fb)) {
      item_short<W, NCH, true>(U, V, U16, V16, omega_v, su, sr, sw, sc, e0,
                               e_buf, snap, rank, lr, lam, warp, lane, pol,
                               own, pa, pb, ra, in_a, in_b, fa, fb);
      return;
    }
  }
  item_short<W, NCH, false>(U, V, nullptr, nullptr, omega_v, su, sr, sw, sc,
                            e0, e_buf, snap, rank, lr, lam, warp, lane, pol,
                            own, pa, pb, ra, in_a, in_b, 0u, 0u);
}

template <int W, int NCH, bool H>
__global__ void __launch_bounds__(kWarps * 32) sgd_item_rows_kernel(
    const float* __restrict__ U, float* __restrict__ V,
    const bf16_t* __restrict__ U16, bf16_t* __restrict__ V16,
    const float* __restrict__ omega_v, const int32_t* __restrict__ prow,
    const int32_t* __restrict__ su, const float* __restrict__ sr,
    const float* __restrict__ sw, const float* __restrict__ sc,
    const uint8_t* __restrict__ flag, int e0, int e1,
    const int32_t* __restrict__ longs, int n_long, int chunk,
    float* __restrict__ e_buf, float* __restrict__ snap, int rank, float lr,
    float lam) {
  item_rows<W, NCH, H>(U, V, U16, V16, omega_v, prow, su, sr, sw, sc, flag,
                       e0, e1, longs, n_long, chunk, e_buf, snap, rank, lr,
                       lam);
}

// The bf16 build at 4 columns a lane and one chunk (rank <= 128), held to
// the f32 build's resident blocks (kBlocksA).
template <>
__global__ void __launch_bounds__(kWarps * 32, kBlocksA)
    sgd_item_rows_kernel<4, 1, true>(
    const float* __restrict__ U, float* __restrict__ V,
    const bf16_t* __restrict__ U16, bf16_t* __restrict__ V16,
    const float* __restrict__ omega_v, const int32_t* __restrict__ prow,
    const int32_t* __restrict__ su, const float* __restrict__ sr,
    const float* __restrict__ sw, const float* __restrict__ sc,
    const uint8_t* __restrict__ flag, int e0, int e1,
    const int32_t* __restrict__ longs, int n_long, int chunk,
    float* __restrict__ e_buf, float* __restrict__ snap, int rank, float lr,
    float lam) {
  item_rows<4, 1, true>(U, V, U16, V16, omega_v, prow, su, sr, sw, sc, flag,
                        e0, e1, longs, n_long, chunk, e_buf, snap, rank, lr,
                        lam);
}

// Kernel B's owned window (short segments); H: the flagged route, `fa` the
// touch flags of the window's segment starts.
template <int W, int NCH, bool H>
__device__ __forceinline__ void user_short(
    float* __restrict__ U, bf16_t* __restrict__ U16,
    const float* __restrict__ omega_u, const int32_t* __restrict__ epos,
    const int32_t* __restrict__ vrow, const float* __restrict__ sw,
    const float* __restrict__ sc, int e0, const float* __restrict__ e_buf,
    const float* __restrict__ snap, int rank, float lr, float lam, int warp,
    int lane, const Policies& pol, const Window& own, int pa, int pb, int ra,
    bool in_a, bool in_b, bool starter, unsigned fa) {
  constexpr int N = W * NCH;
  const WarpSmem<W, NCH> sm(warp);
  if (in_a)
    sm.entries[lane] = Entry{ld_int(vrow + pa, pol.once), 0.0f,
                             ld_float(sw + pa, pol.once),
                             ld_float(sc + pa, pol.once)};
  if (in_b)
    sm.entries[kWindow + lane] = Entry{ld_int(vrow + pb, pol.once), 0.0f,
                                       ld_float(sw + pb, pol.once),
                                       ld_float(sc + pb, pol.once)};
  if (starter) sm.starts[lane].row = ra;
  const Touch touch = start_touch<H>(starter, fa);
  __syncwarp();
  Ring<W, NCH, H> ring(sm.ring);
  ShortFeed f{own.first, false};
  for (int s = 0; s < kStages; ++s)
    feed_short<false>(ring, f, own, sm, U, U16, touch.firsts, pol.once,
                      snap, nullptr, pol.keep, lane, rank);
  // the second round of scalars (each depends on a first-round load) while
  // the first rows are in flight
  if (in_a)
    sm.entries[lane].x =
        ld_float(e_buf + ld_int(epos + pa, pol.once) - e0, pol.once);
  if (in_b)
    sm.entries[kWindow + lane].x =
        ld_float(e_buf + ld_int(epos + pb, pol.once) - e0, pol.once);
  if (starter)
    sm.starts[lane].reg = lam / fmaxf(ld_float(omega_u + ra, pol.once), 1.0f);
  __syncwarp();
  float acc[N], ucur[N], reg_u = 0.0f;
  int cur = kNone;
  bool cur_last = false;
  for (int o = own.first; o < own.end; ++o) {
    const bool st = starts_at(own, o);
    float v[N];
    if (st) {  // a segment starts: store the one before
      if (cur != kNone)
        put_row<W, NCH, H>(U + (int64_t)cur * rank, U16 + (int64_t)cur * rank,
                           cur_last, acc, lane, rank, pol.once);
      const Start s = sm.starts[o];
      cur = s.row;
      cur_last = (touch.lasts >> o) & 1u;
      reg_u = s.reg;
      ring.template take<kStages - 1>(ucur, lane, rank);
      ring.template take<kStages - 2, false>(v, lane, rank);  // snapshot
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] = ucur[i];
    } else {
      ring.template take<kStages - 1, false>(v, lane, rank);
    }
    const Entry en = sm.entries[o];
#pragma unroll
    for (int i = 0; i < N; ++i)
      acc[i] += (lr * (en.x * v[i] - reg_u * ucur[i] * en.w)) * en.c;
    __syncwarp();
    feed_short<false>(ring, f, own, sm, U, U16, touch.firsts, pol.once,
                      snap, nullptr, pol.keep, lane, rank);
    if (st)
      feed_short<false>(ring, f, own, sm, U, U16, touch.firsts, pol.once,
                        snap, nullptr, pol.keep, lane, rank);
  }
  put_row<W, NCH, H>(U + (int64_t)cur * rank, U16 + (int64_t)cur * rank,
                     cur_last, acc, lane, rank, pol.once);
}

template <int W, int NCH, bool H>
__global__ void __launch_bounds__(kWarps * 32) sgd_user_rows_kernel(
    float* __restrict__ U, bf16_t* __restrict__ U16,
    const float* __restrict__ omega_u, const int32_t* __restrict__ prow,
    const int32_t* __restrict__ epos, const int32_t* __restrict__ vrow,
    const float* __restrict__ sw, const float* __restrict__ sc,
    const uint8_t* __restrict__ flag, int e0, int e1,
    const int32_t* __restrict__ longs, int n_long, int chunk,
    const float* __restrict__ e_buf, const float* __restrict__ snap,
    int rank, float lr, float lam) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Policies pol = policies();
  if ((int)blockIdx.x < n_long) {
    user_long<W, NCH, H>(U, U16, omega_u, prow, epos, vrow, sw, sc, flag, e0,
                         longs, chunk, e_buf, snap, rank, lr, lam, warp, lane,
                         pol);
    return;
  }
  const int base = e0 + (((int)blockIdx.x - n_long) * kWarps + warp) * kOwn;
  if (base >= e1) return;
  const int pa = base + lane, pb = pa + kWindow;
  const int ra = pa < e1 ? ld_int(prow + pa, pol.once) : kNone;
  const int before = base > e0 ? ld_int(prow + base - 1, pol.once) : kNone;
  const unsigned la = H && pa < e1 ? flag[pa] : 0u;  // beside the rows
  int rb;
  const Window own = own_window(prow, pb, e1, ra, before, lane, rb,
                                pol.once);
  if (own.first < 0) return;
  const bool in_a = lane >= own.first && lane < own.end;
  const bool in_b = kWindow + lane < own.end;
  const bool starter = (own.starts >> lane) & 1u;
  if constexpr (H) {  // a window without a touch flag takes the f32 body
    const unsigned fa = starter ? la : 0u;
    if (__any_sync(kFull, fa)) {
      user_short<W, NCH, true>(U, U16, omega_u, epos, vrow, sw, sc, e0, e_buf,
                               snap, rank, lr, lam, warp, lane, pol, own, pa,
                               pb, ra, in_a, in_b, starter, fa);
      return;
    }
  }
  user_short<W, NCH, false>(U, nullptr, omega_u, epos, vrow, sw, sc, e0,
                            e_buf, snap, rank, lr, lam, warp, lane, pol, own,
                            pa, pb, ra, in_a, in_b, starter, 0u);
}

// One block per long segment, then one warp per kOwn positions; at least
// one block (a step with no real entries launches one that returns).
dim3 step_grid(int e0, int e1, int n_long) {
  const int windows = (e1 - e0 + kOwn - 1) / kOwn;
  const int blocks = n_long + (windows + kWarps - 1) / kWarps;
  return dim3((unsigned)(blocks > 0 ? blocks : 1));
}

// Above 48 KB a kernel's dynamic shared memory must be allowed first.
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

bool aligned8(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 8 == 0;
}

// Runs the statement(s) with constexpr W (columns per chunk: 4 where `vec`,
// else 1) and NCH (chunks per lane) for `rank` (<= 32·W·NCH).
#define DSGD_WITH_COLS(rank, vec, ...)                                   \
  if (vec) {                                                             \
    switch (((rank) + 127) / 128) {                                      \
      case 1: { constexpr int W = 4, NCH = 1; __VA_ARGS__; } break;      \
      case 2: { constexpr int W = 4, NCH = 2; __VA_ARGS__; } break;      \
      default: return (int)cudaErrorInvalidValue;                        \
    }                                                                    \
  } else {                                                               \
    switch (((rank) + 31) / 32) {                                        \
      case 1: { constexpr int W = 1, NCH = 1; __VA_ARGS__; } break;      \
      case 2: { constexpr int W = 1, NCH = 2; __VA_ARGS__; } break;      \
      case 3: { constexpr int W = 1, NCH = 3; __VA_ARGS__; } break;      \
      case 4: { constexpr int W = 1, NCH = 4; __VA_ARGS__; } break;      \
      case 5: { constexpr int W = 1, NCH = 5; __VA_ARGS__; } break;      \
      case 6: { constexpr int W = 1, NCH = 6; __VA_ARGS__; } break;      \
      case 7: { constexpr int W = 1, NCH = 7; __VA_ARGS__; } break;      \
      case 8: { constexpr int W = 1, NCH = 8; __VA_ARGS__; } break;      \
      default: return (int)cudaErrorInvalidValue;                        \
    }                                                                    \
  }

// Registers a thread, dynamic shared memory and resident blocks an SM of
// one kernel at its launch shape.
template <typename Kernel>
int kernel_attrs(Kernel kernel, int smem, int* out) {
  if (int rc = allow_smem(kernel, smem)) return rc;
  cudaFuncAttributes fa;
  if (cudaError_t rc = cudaFuncGetAttributes(&fa, kernel)) return (int)rc;
  int blocks = 0;
  if (cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kernel, kWarps * 32, smem))
    return (int)rc;
  out[0] = fa.numRegs;
  out[1] = smem;
  out[2] = blocks;
  return 0;
}

constexpr int kCastThreads = 256;
constexpr int kVec = 8;  // bf16 elements per 16-byte vector

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

// Kernel A / kernel B at <W, NCH, H> (H = false: the bf16 pointers and the
// flags are null). Returns cudaGetLastError() of the launch.
template <int W, int NCH, bool H>
int launch_item(const void* U, void* V, const void* U16, void* V16,
                const void* omega_v, const void* prow, const void* su,
                const void* sr, const void* sw, const void* sc,
                const void* flag, int e0, int e1, const void* longs,
                int n_long, int chunk, void* e_buf, void* snap, int rank,
                float lr, float lam, void* stream) {
  const int smem = block_smem_bytes<W, NCH>();
  if (int rc = allow_smem(sgd_item_rows_kernel<W, NCH, H>, smem)) return rc;
  sgd_item_rows_kernel<W, NCH, H>
      <<<step_grid(e0, e1, n_long), kWarps * 32, smem,
         (cudaStream_t)stream>>>(
          (const float*)U, (float*)V, (const bf16_t*)U16, (bf16_t*)V16,
          (const float*)omega_v, (const int32_t*)prow, (const int32_t*)su,
          (const float*)sr, (const float*)sw, (const float*)sc,
          (const uint8_t*)flag, e0, e1, (const int32_t*)longs, n_long, chunk,
          (float*)e_buf, (float*)snap, rank, lr, lam);
  return (int)cudaGetLastError();
}

template <int W, int NCH, bool H>
int launch_user(void* U, void* U16, const void* omega_u, const void* prow,
                const void* epos, const void* vrow, const void* sw,
                const void* sc, const void* flag, int e0, int e1,
                const void* longs, int n_long, int chunk, const void* e_buf,
                const void* snap, int rank, float lr, float lam,
                void* stream) {
  const int smem = block_smem_bytes<W, NCH>();
  if (int rc = allow_smem(sgd_user_rows_kernel<W, NCH, H>, smem)) return rc;
  sgd_user_rows_kernel<W, NCH, H>
      <<<step_grid(e0, e1, n_long), kWarps * 32, smem,
         (cudaStream_t)stream>>>(
          (float*)U, (bf16_t*)U16, (const float*)omega_u,
          (const int32_t*)prow, (const int32_t*)epos, (const int32_t*)vrow,
          (const float*)sw, (const float*)sc, (const uint8_t*)flag, e0, e1,
          (const int32_t*)longs, n_long, chunk, (const float*)e_buf,
          (const float*)snap, rank, lr, lam);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points; each returns cudaGetLastError() of its launch.
// One step's plan slice: its positions [e0, e1) of the per-position arrays
// (`prow` rows, ~row in a long segment, then the streams), and `longs`
// [n_long, 2] (the long segments' [beg, end) positions); e_buf is indexed
// by position − e0, the snapshot by item row; 1 <= chunk <= 32. The 16-byte
// route (W = 4) runs where rank % 4 == 0 and every table is 16-byte
// aligned, the 4-byte route otherwise.
extern "C" int dsgd_sweep_max_rank() { return 32 * kMaxCols; }

extern "C" int sgd_item_rows_launch(
    const void* U, void* V, const void* omega_v, const void* prow,
    const void* su, const void* sr, const void* sw, const void* sc, int e0,
    int e1, const void* longs, int n_long, int chunk, void* e_buf,
    void* snap, int rank, float lr, float lam, void* stream) {
  if (chunk < 1 || chunk > kWindow) return (int)cudaErrorInvalidValue;
  const bool vec = rank % 4 == 0 && aligned16(U) && aligned16(V) &&
                   aligned16(snap);
  int rc = 0;
  DSGD_WITH_COLS(rank, vec,
    rc = launch_item<W, NCH, false>(U, V, nullptr, nullptr, omega_v, prow,
                                    su, sr, sw, sc, nullptr, e0, e1, longs,
                                    n_long, chunk, e_buf, snap, rank, lr,
                                    lam, stream))
  return rc;
}

extern "C" int sgd_user_rows_launch(
    void* U, const void* omega_u, const void* prow, const void* epos,
    const void* vrow, const void* sw, const void* sc, int e0, int e1,
    const void* longs, int n_long, int chunk, const void* e_buf,
    const void* snap, int rank, float lr, float lam, void* stream) {
  if (chunk < 1 || chunk > kWindow) return (int)cudaErrorInvalidValue;
  const bool vec = rank % 4 == 0 && aligned16(U) && aligned16(snap);
  int rc = 0;
  DSGD_WITH_COLS(rank, vec,
    rc = launch_user<W, NCH, false>(U, nullptr, omega_u, prow, epos, vrow,
                                    sw, sc, nullptr, e0, e1, longs, n_long,
                                    chunk, e_buf, snap, rank, lr, lam,
                                    stream))
  return rc;
}

// The bf16 route: U / V are the f32 work tables, U16 / V16 the bf16 tables
// (the same shapes), `flag` the side's touch flags (one byte a position,
// indexed like the streams). The 16-byte route also needs the bf16 tables
// 8-byte aligned (4 bf16 columns a copy).
extern "C" int sgd_item_rows_bf16_launch(
    const void* U, void* V, const void* U16, void* V16, const void* flag,
    const void* omega_v, const void* prow, const void* su, const void* sr,
    const void* sw, const void* sc, int e0, int e1, const void* longs,
    int n_long, int chunk, void* e_buf, void* snap, int rank, float lr,
    float lam, void* stream) {
  if (chunk < 1 || chunk > kWindow) return (int)cudaErrorInvalidValue;
  const bool vec = rank % 4 == 0 && aligned16(U) && aligned16(V) &&
                   aligned16(snap) && aligned8(U16) && aligned8(V16);
  int rc = 0;
  DSGD_WITH_COLS(rank, vec,
    rc = launch_item<W, NCH, true>(U, V, U16, V16, omega_v, prow, su, sr, sw,
                                   sc, flag, e0, e1, longs, n_long, chunk,
                                   e_buf, snap, rank, lr, lam, stream))
  return rc;
}

extern "C" int sgd_user_rows_bf16_launch(
    void* U, void* U16, const void* flag, const void* omega_u,
    const void* prow, const void* epos, const void* vrow, const void* sw,
    const void* sc, int e0, int e1, const void* longs, int n_long, int chunk,
    const void* e_buf, const void* snap, int rank, float lr, float lam,
    void* stream) {
  if (chunk < 1 || chunk > kWindow) return (int)cudaErrorInvalidValue;
  const bool vec = rank % 4 == 0 && aligned16(U) && aligned16(snap) &&
                   aligned8(U16);
  int rc = 0;
  DSGD_WITH_COLS(rank, vec,
    rc = launch_user<W, NCH, true>(U, U16, omega_u, prow, epos, vrow, sw, sc,
                                   flag, e0, e1, longs, n_long, chunk, e_buf,
                                   snap, rank, lr, lam, stream))
  return rc;
}

// The step kernels at `rank` on the route `vec` selects (nonzero: 16-byte):
// out[0..2] kernel A's registers a thread, dynamic shared memory bytes a
// block and resident blocks an SM; out[3..5] kernel B's.
extern "C" int dsgd_step_kernel_attrs(int rank, int vec, int* out) {
  DSGD_WITH_COLS(rank, vec != 0,
    const int smem = block_smem_bytes<W, NCH>();
    if (int rc = kernel_attrs(sgd_item_rows_kernel<W, NCH, false>, smem, out))
      return rc;
    if (int rc = kernel_attrs(sgd_user_rows_kernel<W, NCH, false>, smem,
                                 out + 3))
      return rc)
  return 0;
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
