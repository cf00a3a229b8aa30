// The layered truncated-list EMS super-layer step (K3), one warp per row.
//
// Replaces the XLA ops of ems_nbldpc_tpu/ops/listcn.py on the list path:
// topk_list (:93, the packed-key sort from q down to nm; in the exact mode
// minconv.topk_message), rotate_ids (:79, the XOR-fold GF rotation),
// list_combine (:145: its budgeted staircase branch :194-241, candidate
// sums, GF-major dedup sort, value-major best-nm sort; and its exact
// branch :167-193 over all na * nb candidates in f32), fb_checknode_list
// (:244, chain form), saturate_list (:359) and expand_list (:374, with
// minconv.scatter_topk_dense), and the gathers, VN extrinsic, freeze and
// scatters of the sweep body around them
// (ems_nbldpc_tpu/decoder/layered.py:567-611).  Its plain version, which
// it equals bit for bit, is ops/listcn.list_layer_plain.  Three forms run
// it: the fast step (list_kernel<ST, false>: the staircase, nm <= 64, a
// row within a block's shared memory; the bench row's), whose design the
// notes below describe; its exact form (list_kernel<ST, true>: the exact
// mode, nbOper <= 0, within the same limits; the CLI's `--storage
// compressed` default; see "the exact mode"); and the general step
// (list_general_kernel: every other shape, nm past 64 and rows past
// shared memory; see "the general step").
//
// list_layer_launch / list_layer_bf16_launch: one super-layer, in place on
// the state APP [F, N+1, q] and the compressed CtoV (cv_v [F, E+1, nm],
// cv_g [F, E+1, nm] uint8, cv_sat [F, E+1]), f32 or bf16:
//   for each frame f with active[f], each row r < G of the layer, each
//   slot i < dc (column c = cols[r,i], edge e = edges[r,i]):
//     ctov_i = min(scatter_min(cv_v[f,e], cv_g[f,e], fill 1e9), cv_sat[f,e])
//     mvc_i  = APP[f,c] - ctov_i;  mvc_i -= min mvc_i
//     list_i = the nm smallest keys (bf16bits(min(mvc_i[s], 1e9)) << 8 | s)
//              as (value, h_i * s), or the neutral list at a padded slot
//   the F/B chain over the lists (list_combine's staircase merges),
//   out_i = the extrinsic list of slot i, its ids rotated by h_i^-1, then
//   for each real slot i:
//     ov = out_i - out_i[0];  sat = (largest ov < 5e8, or 0) + offset
//     cv_v[f,e] = min(ov, sat); cv_g[f,e] = ids; cv_sat[f,e] = sat
//     APP[f,c] = mvc_i + min(scatter_min(cv_v[f,e], ids, fill 1e9), sat)
//   Frozen frames are neither read nor written, and padded slots write
//   nothing, so the padding column N and edge E keep their values.
// On a bf16 state each load widens to f32 (exact) and the step rounds to
// nearest even (__float2bfloat16_rn, torch's .to(torch.bfloat16)) where
// the plain version's bf16 tensors round: ctov, mvc, mvc - min, the
// stored values and sat, the dense output, and APP.  The f32 `sat` feeds
// the dense output, as in the plain version.  An f32 state rounds nowhere.
//
// Why the bits agree.  Every selection is of unique packed keys (a value's
// bf16 bits over its GF id), so its result does not depend on the order
// the candidates are visited: the top-nm of a message is the nm smallest
// of its 256 keys, in order; a merge takes each staircase candidate
// {(i+1)(j+1) <= nbOper} once, folds it into a per-GF minimum of its bf16
// bits with a shared-memory atomicMin, and selects from the 256 keys
// (min bits << 8 | g), an absent g as the plain version's dup marker
// 0x7FFFFFFF, which comes out as value 1e9 and id = the slot.  That is
// "the first of each GF run, then the nm smallest" of the plain version's
// two sorts.  Sums are single __fadd_rn, differences __fsub_rn, and the
// rest are exact minima, maxima and integer logic.
//
// What bounds it on an H100 (3.35 TB/s).  The bench row's call [F = 128,
// 1350 rows, dc = 4, q = 256], nm = 32, nbOper = 64, must read the APP
// rows and the compressed CtoV once and write them once: 843,264,000 B on
// a bf16 state, 0.2517 ms, and 1,642,291,200 B on an f32 one, 0.4902 ms.
// Its operations (216 candidate sums a merge, 6 merges a row) are far
// below that at 67 TFLOP/s.  What holds it is instruction work and its
// latency, not bytes: 10 top-nm selections of 256 keys a row (4
// truncations, 6 merges), each a chain of warp shuffles and integer
// minima; 6 x 216 shared-memory atomics for the merges' per-GF minima;
// 8 rotations and 8 dense expansions a row.
//
// What this design does about it.
// * One warp owns one row at a time and walks the rows of a persistent
//   grid; no block barrier after the staircase's pair table is built.
// * A selection sorts each lane's 8 keys in registers, then runs a bitonic
//   top-32 on the lanes' 4 smallest (128 keys), halving the registers a
//   lane holds at each round (4 -> 2 -> 1) and moving each round's result
//   into the next layout by shuffles; the few keys it leaves out that
//   belong to the nm smallest (a lane's 5th or later, rare) are inserted
//   one at a time.  nm > 32 runs a 64-key form on all 256 keys, out of
//   line.  The former form sorted runs of 32 of all 256 keys and kept all
//   8 registers through three rounds: 96 shuffles a selection against 44
//   now (24 to sort the runs, 19 for the two halvings, 1 for the check).
// * A warp keeps one 256-entry table, cleared (two 16-byte stores a lane)
//   before each use (14 a row at dc = 4): the expansions' and the merges'
//   per-GF minima and the 64-key form's scratch.  Two tables, the merges'
//   epoch-tagged so as never to be cleared, ran 6% slower (PERF.md §6).
// * A list entry is one u32 (the key), so a candidate reads two words and
//   takes its value with one byte permute; the merge is one out-of-line
//   function, so that its code is not copied three times (inlined, the
//   kernel ran ~5% slower: the inline_merges variant).
// * APP rows move as 8- or 16-byte vectors (4 symbols a lane a access);
//   mvc stays in shared memory in the state's type; warp minima and maxima
//   are one redux.sync on order-preserving keys.
// * A rotation (multiplication by h or h^-1) is two 16-entry XOR tables
//   held one entry a lane and read by two shuffles.
// Where the fast step stands (chip_variants.py --list, the former form and
// this one in turns; NVIDIA H100 80GB HBM3, 700 W): 1.83 ms a call on the bf16
// state (14% of its bound) and 1.73 on the f32 one (28%), against 3.28 /
// 3.17 for the former form, with 64 registers and no spills (68-76 bytes
// before); the plain version takes ~103 ms.  Diagnostics (bf16 / f32):
// without its selections 1.04 / 0.97 ms (2.0 ms of selections before,
// ~0.8 now), without the merges 1.02 / 0.93, without the merges'
// candidates 1.58 / 1.48, without the rotations 1.71 / 1.62.
// A column or an edge out of range traps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>
#include <vector>

namespace {

typedef __nv_bfloat16 bf16_t;

constexpr unsigned FULL = 0xffffffffu;
constexpr float BIG = 1e9f;             // ops/listcn.BIG = ops/minconv.INF
constexpr float HALF_BIG = 5e8f;        // listcn.saturate_list's BIG / 2
constexpr unsigned DUP = 0x7fffffffu;   // listcn._DUP
constexpr unsigned ABSENT = 0xffffffffu;
constexpr unsigned DUP_ENTRY = 0x014e6e00u;  // an unfilled list entry
//                       (flag bit 24, bf16(BIG) bits, the slot as its id)
constexpr unsigned BIG_BITS = 0x4e6e6b28u;  // __float_as_uint(1e9f)
constexpr unsigned long long NONE64 = ~0ULL;
constexpr int WARPS = 4;                // warps per block
constexpr int BLOCKS_SM = 8;            // blocks an SM the registers aim at
// the same for the exact mode: on a bf16 state 8 (64 registers), on an
// f32 one 6, as many as its shared memory lets an SM hold at dc = 4, q =
// 256 (33 KB a block), so 80 registers cost no occupancy there
constexpr int EXACT_BLOCKS_SM_BF16 = 8;
constexpr int EXACT_BLOCKS_SM_F32 = 6;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_NM = 64;              // list length: two entries a lane
constexpr int TAB = 256;                // GF ids (8 bits)
constexpr long long BLOCK_LIMIT = 232448;  // dynamic shared memory a block
//                                            may use on Hopper
constexpr int WS_BLOCKS_SM = 2;         // workspace slots: blocks an SM

// Launches on this device, counted by the kernel itself, so that the
// launches a CUDA graph replays count too (list_launches).
__device__ unsigned long long g_launches = 0;

struct Params {
  void* app;                   // [F, app_rows, q] (float or bf16)
  void* cv_v;                  // [F, cv_rows, nm] (the same)
  uint8_t* cv_g;               // [F, cv_rows, nm]
  void* cv_sat;                // [F, cv_rows] (the same)
  long long app_rows, cv_rows;
  const uint8_t* active;       // [F] (0 = frozen)
  const int* cols;             // [G, dc] columns of APP
  const int* edges;            // [G, dc] edges of CtoV
  const int* rc_in;            // [G, dc, logq] basis columns of h
  const int* rc_out;           // [G, dc, logq] basis columns of h^-1
  const uint8_t* valid;        // [G, dc] (0 = padded slot) or null
  long long T, G;              // rows F * G, layer rows
  int dc, q, logq, nm, nboper, npairs;
  int vec;                     // APP rows as 8- / 16-byte vectors
  float offset;
  unsigned char* ws;           // the general step's workspace, or null
  long long ws_bytes;          // its size
};

__host__ __device__ inline long long align16(long long b) {
  return (b + 15) / 16 * 16;
}

// Lists a row holds: the dc inputs (later the middle outputs), then the
// forward F[1..dc-2] and backward B[1..dc-2] partial merges.
__host__ __device__ inline int n_lists(int dc) {
  return dc <= 2 ? dc : 3 * dc - 4;
}

// Shared memory of one warp, carved in this order: mvc [dc, q] in the
// state's type (elem bytes), the lists [lists, nm] (one u32 an entry; in
// the exact mode two, a value's f32 bits and its GF id) and one table
// [256] (u32), cleared before each use: the expansions' and the merges'
// per-GF minima, and a slow selection's scratch; the exact mode keeps a
// second table, the scratch and the tail's counts.
struct Layout {
  long long lists, tab, total;
};

__host__ __device__ inline Layout layout(int dc, int q, int nm, int elem,
                                         bool exact) {
  const long long words = exact ? 2 : 1;
  Layout l;
  l.lists = align16(static_cast<long long>(elem) * dc * q);
  l.tab = l.lists + align16(4 * words * n_lists(dc) * nm);
  l.total = l.tab + 4 * words * TAB;
  return l;
}

// Staircase candidates {(i+1)(j+1) <= nbOper}, i, j < nm (list_combine's
// w = min(nbOper, nm * nm) and row widths min(nm, w / (i+1))).
__host__ __device__ inline int row_width(int i, int nm, int nboper) {
  const long long w =
      nboper < static_cast<long long>(nm) * nm ? nboper
                                               : static_cast<long long>(nm) * nm;
  const long long wi = w / (i + 1);
  return static_cast<int>(wi < nm ? wi : nm);
}

__host__ __device__ inline int staircase_pairs(int nm, int nboper) {
  int n = 0;
  for (int i = 0; i < nm; ++i) n += row_width(i, nm, nboper);
  return n;
}

// The staircase whose pairs a block tables: nbOper's, and in the exact
// mode (nboper <= 0) its merges' first pass, {(i+1)(j+1) <= 2 nm} (216
// candidates at nm = 32; {(i+1)(j+1) <= nm} ran 3-4% slower).
__host__ __device__ inline int table_budget(int nm, int nboper) {
  return nboper >= 1 ? nboper : 2 * nm;
}

// Order-preserving unsigned key of a float (-0 maps to +0's key).
__device__ __forceinline__ unsigned fkey(float f) {
  const unsigned b = __float_as_uint(f == 0.0f ? 0.0f : f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float fval(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// listcn._bf16_bits: the bf16 bit pattern of min(x, BIG), rounded to
// nearest even; and listcn._from_bf16_bits.
__device__ __forceinline__ unsigned bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(fminf(x, BIG)));
}

__device__ __forceinline__ float from_bits(unsigned b) {
  return __uint_as_float(b << 16);
}

// A list entry: its value's bf16 bits over its GF id, as a selection's
// key; an unfilled one (the plain version's dup marker: value BIG, id the
// slot) is DUP_ENTRY | slot.  In a merge's sums an unfilled entry may
// stand for bf16(BIG) (sum_value): a sum with BIG or with bf16(BIG) (every
// value is >= 0) rounds to the same bits, bf16(BIG), after the clamp at
// BIG; the saturation and the stored values need BIG itself (value).
__device__ __forceinline__ float sum_value(unsigned c) {
  return __uint_as_float(__byte_perm(c, 0, 0x2144));  // bits 8..23 << 8
}

__device__ __forceinline__ float entry_value(unsigned c) {
  return c >> 24 ? BIG : sum_value(c);
}

__device__ __forceinline__ unsigned entry_id(unsigned c) { return c & 0xff; }

// An exact list entry: (a value's f32 bits, its GF id); unfilled, (BIG,
// the slot).
__device__ __forceinline__ float entry_value(uint2 c) {
  return __uint_as_float(c.x);
}

__device__ __forceinline__ unsigned entry_id(uint2 c) { return c.y & 0xff; }

// Entry e of the merge's identity (listcn.neutral_list): 0 at GF 0, then
// unfilled.
template <class E>
__device__ __forceinline__ E neutral_entry(int e);

template <>
__device__ __forceinline__ unsigned neutral_entry<unsigned>(int e) {
  return e == 0 ? 0u : (DUP_ENTRY | e);
}

template <>
__device__ __forceinline__ uint2 neutral_entry<uint2>(int e) {
  return e == 0 ? make_uint2(0u, 0u) : make_uint2(BIG_BITS, e);
}

// warp-wide min and max of floats, by redux.sync on their keys
__device__ __forceinline__ float warp_min(float v) {
  return fval(__reduce_min_sync(FULL, fkey(v)));
}

__device__ __forceinline__ float warp_max(float v) {
  return fval(__reduce_max_sync(FULL, fkey(v)));
}

__device__ __forceinline__ unsigned short bf16_raw(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// Two values rounded to bf16 by one conversion: their bits (x low).
__device__ __forceinline__ unsigned bf16x2(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const unsigned*>(&h);
}

// A lane's 8 values rounded to the state's type.
template <class ST>
__device__ __forceinline__ void rnd8(float (&v)[8]) {}

template <>
__device__ __forceinline__ void rnd8<bf16_t>(float (&v)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = from_bits(bf16_raw(v[i]));
}

__device__ __forceinline__ float ld(const float* p) { return *p; }

__device__ __forceinline__ float ld(const bf16_t* p) {
  return from_bits(*reinterpret_cast<const unsigned short*>(p));
}

__device__ __forceinline__ void st(float* p, float v) { *p = v; }

__device__ __forceinline__ void st(bf16_t* p, float v) {
  *reinterpret_cast<unsigned short*>(p) = bf16_raw(v);
}

// A lane's 8 symbols of a q-row: s = 128 (i / 4) + 4 lane + i % 4, so that
// four consecutive symbols make one 8- or 16-byte access and a warp's
// accesses are contiguous (no bank conflicts in shared memory).
__device__ __forceinline__ int sym(int lane, int i) {
  return (i >> 2) * 128 + 4 * lane + (i & 3);
}

// Four consecutive elements of a row (at a multiple of 4) as f32, and
// back, rounded to the row's type.
__device__ __forceinline__ void ld4(const float* p, float* v) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

__device__ __forceinline__ void ld4(const bf16_t* p, float* v) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(x.x << 16); v[1] = __uint_as_float(x.x & 0xffff0000u);
  v[2] = __uint_as_float(x.y << 16); v[3] = __uint_as_float(x.y & 0xffff0000u);
}

__device__ __forceinline__ void st4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void st4(bf16_t* p, const float* v) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(bf16x2(v[0], v[1]), bf16x2(v[2], v[3]));
}

// A lane's 8 elements of a q-row (sym order); absent symbols are left.
template <class ST>
__device__ __forceinline__ void load_row(const ST* row, float (&v)[8], int q,
                                         bool vec, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = sym(lane, 4 * h);
    if (vec) {
      if (s < q) ld4(row + s, v + 4 * h);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (s + i < q) v[4 * h + i] = ld(row + s + i);
    }
  }
}

template <class ST>
__device__ __forceinline__ void store_row(ST* row, const float (&v)[8],
                                          int q, bool vec, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = sym(lane, 4 * h);
    if (vec) {
      if (s < q) st4(row + s, v + 4 * h);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (s + i < q) st(row + s + i, v[4 * h + i]);
    }
  }
}

// The 256 u32 of a warp's table in sym order, and a fill of all of it.
__device__ __forceinline__ void read_tab(const unsigned* tab, unsigned (&t)[8],
                                         int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint4 x = *reinterpret_cast<const uint4*>(tab + sym(lane, 4 * h));
    t[4 * h] = x.x; t[4 * h + 1] = x.y; t[4 * h + 2] = x.z; t[4 * h + 3] = x.w;
  }
}

__device__ __forceinline__ void fill_tab(unsigned* tab, unsigned v,
                                         int lane) {
  const uint4 x = make_uint4(v, v, v, v);
  *reinterpret_cast<uint4*>(tab + sym(lane, 0)) = x;
  *reinterpret_cast<uint4*>(tab + sym(lane, 4)) = x;
}

// ---- the selection: the nm smallest of the warp's 256 unique keys ----
//
// Each lane first sorts its 8 keys (sort8).  Then a bitonic top-k in the
// form whose comparators all ascend: sort runs of RUN keys (key p =
// R lane + i in register i), then halve: of two ascending runs A, B keep
// C[j] = min(A[j], B[RUN-1-j]) (the RUN smallest of both, a bitonic run)
// and merge it.  Each halving also halves the registers a lane holds, so
// that a later merge moves half the keys of the one before: a lane of A
// computes the first half of its positions of C, its mirror lane of B the
// second half, and one shuffle a register puts C in the blocked layout of
// the next round.  For nm <= 32 it runs on the lanes' 4 smallest alone
// (128 keys, R = 4 -> 2 -> 1), which misses only keys of a lane that
// holds 5 or more of the nm smallest: those (its 5th key and on, while
// below the nm-th found) are inserted one at a time.  nm > 32 runs on all
// 256 keys with RUN = 64 (R = 8 -> 4 -> 2), out of line.
// tests/test_torch_list_layer.py replays these steps on the CPU.
__device__ __forceinline__ void cx(unsigned& a, unsigned& b) {
  const unsigned lo = min(a, b), hi = max(a, b);
  a = lo;
  b = hi;
}

__device__ __forceinline__ unsigned cx_lane(unsigned a, unsigned o,
                                            bool upper) {
  return upper ? max(a, o) : min(a, o);
}

// A lane's 8 keys ascending: the 19-comparator network.
__device__ __forceinline__ void sort8(unsigned (&k)[8]) {
  cx(k[0], k[2]); cx(k[1], k[3]); cx(k[4], k[6]); cx(k[5], k[7]);
  cx(k[0], k[4]); cx(k[1], k[5]); cx(k[2], k[6]); cx(k[3], k[7]);
  cx(k[0], k[1]); cx(k[2], k[3]); cx(k[4], k[5]); cx(k[6], k[7]);
  cx(k[2], k[4]); cx(k[3], k[5]);
  cx(k[1], k[4]); cx(k[3], k[6]);
  cx(k[1], k[2]); cx(k[3], k[4]); cx(k[5], k[6]);
}

// Half-cleaners of strides run/2 .. 1 over a bitonic run of keys
// p = R lane + i: it comes out ascending.
template <int R>
__device__ __forceinline__ void half_clean(unsigned (&k)[8], int lane,
                                           int run) {
#pragma unroll
  for (int s = run >> 1; s > 0; s >>= 1) {
    if (s >= R) {
      const int d = s / R;
      const bool upper = (lane & d) != 0;
#pragma unroll
      for (int i = 0; i < R; ++i)
        k[i] = cx_lane(k[i], __shfl_xor_sync(FULL, k[i], d), upper);
    } else {
#pragma unroll
      for (int i = 0; i < R; ++i)
        if (!(i & s)) cx(k[i], k[i | s]);
    }
  }
}

// One halving: runs of RUN keys over L lanes with R registers each ->
// half as many runs over 2L lanes with R/2 registers, merged.  Position
// nlo R/2 + i of the merged run comes from register i of lane nlo / 2 of
// A (nlo even) or of its mirror lane in B (nlo odd).
template <int RUN, int R, int L>
__device__ __forceinline__ void halve(unsigned (&k)[8], int lane) {
  constexpr int R2 = R / 2;
  const bool upper = (lane & L) != 0;
  unsigned c[R2];
#pragma unroll
  for (int i = 0; i < R2; ++i) {
    const unsigned o =
        __shfl_xor_sync(FULL, upper ? k[R - 1 - i] : k[R2 + i], 2 * L - 1);
    c[i] = upper ? min(o, k[R2 - 1 - i]) : min(k[i], o);
  }
  const int nlo = lane & (2 * L - 1);
  const int src = (lane & ~(2 * L - 1)) +
                  ((nlo & 1) ? L + ((nlo >> 1) ^ (L - 1)) : nlo >> 1);
#pragma unroll
  for (int i = 0; i < R2; ++i) k[i] = __shfl_sync(FULL, c[i], src);
  half_clean<R2>(k, lane, RUN);
}

// Ascending runs of RUN keys p = R lane + i from ascending runs of R in
// each lane: each merge of two runs opens by comparing key p with
// p ^ (size - 1).
template <int R, int RUN>
__device__ __forceinline__ void sort_runs(unsigned (&k)[8], int lane) {
#pragma unroll
  for (int size = 2 * R; size <= RUN; size <<= 1) {
    const int m = (size - 1) / R;              // lanes of the mirror
    const bool upper = (lane & (size / (2 * R))) != 0;
    unsigned o[R];
#pragma unroll
    for (int i = 0; i < R; ++i) o[i] = __shfl_xor_sync(FULL, k[R - 1 - i], m);
#pragma unroll
    for (int i = 0; i < R; ++i) k[i] = cx_lane(k[i], o[i], upper);
    half_clean<R>(k, lane, size >> 1);
  }
}

// The 64 smallest of 256 keys whose lanes hold them ascending (sort8):
// entry e = 2 l + i in register i of lane l.
__device__ __forceinline__ void top64(unsigned (&k)[8], int lane) {
  sort_runs<8, 64>(k, lane);
  halve<64, 8, 8>(k, lane);
  halve<64, 4, 16>(k, lane);
}

// nm <= 32, the lanes' keys ascending: the 32 smallest of the lanes' 4
// smallest (128 keys), the same steps on half the registers; lane j gets
// the j-th.
__device__ __forceinline__ unsigned top_fast(const unsigned (&k)[8],
                                             int lane) {
  unsigned w[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = k[i];
  sort_runs<4, 32>(w, lane);
  halve<32, 4, 8>(w, lane);
  halve<32, 2, 16>(w, lane);
  return w[0];
}

// The keys top_fast left out that belong to the nm smallest: while a
// lane's next key (its 5th, 6th, ...) lies below the nm-th of the warp's
// list w (lane j its j-th), insert it there (the list's last drops).  A
// lane's keys ascend, so once its next is not below the nm-th, none of
// the rest is.  Rarely any: a lane must hold 5 or more of the nm smallest.
__device__ __forceinline__ void insert_rest(const unsigned (&k)[8],
                                            unsigned& w, int nm, int lane) {
  unsigned t = __shfl_sync(FULL, w, nm - 1);
  unsigned next = k[4];
  int i = 4;
  for (unsigned ball; (ball = __ballot_sync(FULL, next < t)) != 0;) {
    const int src = __ffs(ball) - 1;
    const unsigned x = __shfl_sync(FULL, next, src);
    const unsigned below = __shfl_up_sync(FULL, w, 1);
    w = w < x ? w : (lane == 0 || below < x ? x : below);
    t = __shfl_sync(FULL, w, nm - 1);
    if (lane == src) {
      ++i;
      next = i == 5 ? k[5] : i == 6 ? k[6] : i == 7 ? k[7] : ABSENT;
    }
  }
}

// The 64 smallest of the 256 keys at scr (key 8 lane + i: the lane's
// i-th, each lane's ascending), written back ascending to scr[0, 64).
// Out of line: it runs only for nm > 32, and one copy keeps the kernel's
// code small.
__device__ __noinline__ void select_slow(unsigned* scr, int lane) {
  unsigned k[8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint4 x = *reinterpret_cast<const uint4*>(scr + 8 * lane + 4 * h);
    k[4 * h] = x.x; k[4 * h + 1] = x.y; k[4 * h + 2] = x.z; k[4 * h + 3] = x.w;
  }
  __syncwarp();
  top64(k, lane);
  *reinterpret_cast<uint2*>(scr + 2 * lane) = make_uint2(k[0], k[1]);
  __syncwarp();
}

// The nm smallest of the warp's 256 keys, ascending: out[u] = entry
// lane + 32 u (u < 2; entries past nm are unspecified).  For nm > 32 it
// overwrites the 256 words at scr, which may be the table the keys were
// just read from: every lane's reads end before the first write.
__device__ __forceinline__ void select_nm(unsigned (&k)[8],
                                          unsigned (&out)[2], unsigned* scr,
                                          int nm, int lane) {
  sort8(k);
  out[1] = DUP;
  if (nm <= 32) {
    out[0] = top_fast(k, lane);
    insert_rest(k, out[0], nm, lane);
    return;
  }
  __syncwarp();
  *reinterpret_cast<uint4*>(scr + 8 * lane) = make_uint4(k[0], k[1], k[2], k[3]);
  *reinterpret_cast<uint4*>(scr + 8 * lane + 4) =
      make_uint4(k[4], k[5], k[6], k[7]);
  __syncwarp();
  select_slow(scr, lane);
  out[0] = scr[lane];
  out[1] = scr[lane + 32];
  __syncwarp();
}

// A slot's rotation (listcn.rotate_ids: the XOR of the GF(2)-basis
// columns, rc_in or rc_out, of an id's bits) as two 16-entry tables held
// one entry a lane: lane n < 16 the XOR of the columns of n's bits 0-3,
// lane 16 + n of n's bits 4-7.  rotate is warp-wide (every lane calls it).
__device__ __forceinline__ int rot_table(const int* col, int logq,
                                         int lane) {
  const int n = lane & 15, first = lane >> 4 << 2;
  int t = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if ((n >> b & 1) && first + b < logq) t ^= __ldg(col + first + b);
  return t;
}

__device__ __forceinline__ int rotate(int g, int table) {
  return __shfl_sync(FULL, table, g & 15) ^
         __shfl_sync(FULL, table, 16 | (g >> 4 & 15));
}

// One staircase merge (list_combine, nbOper > 0): out = the nm smallest
// distinct-GF sums of the lists a and b, the per-GF minima of their bf16
// bits folded into the warp's table.  Out of line (one copy).
__device__ __noinline__ void merge(const unsigned* la, const unsigned* lb,
                                   unsigned* lo, unsigned* tab,
                                   const uint16_t* pairs, int npairs, int nm,
                                   int lane) {
  fill_tab(tab, ABSENT, lane);
  __syncwarp();
  for (int c = lane; c < npairs; c += 32) {
    const unsigned p = pairs[c];
    const unsigned a = la[p >> 8], b = lb[p & 0xff];
    atomicMin(tab + ((a ^ b) & 0xff),
              bf16_bits(__fadd_rn(sum_value(a), sum_value(b))));
  }
  __syncwarp();
  unsigned k[8];
  read_tab(tab, k, lane);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    k[i] = k[i] != ABSENT ? (k[i] << 8 | sym(lane, i)) : DUP;
  unsigned out[2];
  select_nm(k, out, tab, nm, lane);
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int e = lane + 32 * u;
    if (e < nm) lo[e] = out[u] == DUP ? (DUP_ENTRY | e) : out[u];
  }
  __syncwarp();
}

// ---- the exact mode (nboper <= 0) in the fast step's structure ----
//
// An exact key is a value's f32 bits over its GF id (39 bits: values are
// >= 0).  A selection runs the staircase's 32-bit steps above (select_nm)
// on the value's bits less their low 8, over the id, then reads the chosen
// values back from a table by id and keeps the result where the two
// orders cannot differ (exact_ok); else it sorts the 39-bit keys
// (sort_exact).  A bf16 state's truncations need no check: their values
// are bf16.  A merge folds the staircase {(i+1)(j+1) <= 2 nm} first,
// selects, and then visits only the candidates outside it whose sum can
// still be among the nm smallest; see merge_exact.  A list entry is two
// words (uint2: the value's f32 bits, the id), and a warp keeps two
// tables: the minima (or a truncation's values, read back by id) and the
// nm > 32 selection's scratch (or the tail's counts).
// Why the bits agree: the exact keys are unique (one per GF id, or one per
// symbol), so a selection's result is the plain version's stable sort
// (equal values by id, as its last sort, stable over GF-sorted runs, has
// them); every candidate that can reach the nm smallest is folded; sums
// are single __fadd_rn, and the rest is exact.
// What holds it (chip_variants.py --list diagnostics, NVIDIA H100 80GB
// HBM3, 700 W): at the bench row's shape (F = 128, 1350 rows, dc = 4, nm
// = 32) 2.19 ms a call on a bf16 state and 2.75 on an f32 one, against
// 14.4 / 14.0 for the general step's 256-key sorts, in the same call, and
// 0.25 / 0.49 ms bounds.  On the bf16 state its merges' selections with
// their checks take ~0.8 ms (the checks ~0.3) and its merges' candidates
// ~0.5; on the f32 state the checks and the sorts they call for take
// ~0.9.  The bf16 instance spills 80 bytes at 64 registers; 80 registers
// (6 blocks an SM) ran slower there, and faster on the f32 state, whose
// shared memory holds an SM to 6 blocks anyway.

__device__ __forceinline__ void cx64(unsigned long long& a,
                                     unsigned long long& b, bool up) {
  const bool lt = a < b;
  const unsigned long long lo = lt ? a : b, hi = lt ? b : a;
  a = up ? lo : hi;
  b = up ? hi : lo;
}

// The warp's 256 keys (key p = 8 lane + i in register i) sorted ascending
// in place: a bitonic sort, strides of 8 and more across lanes.
__device__ __forceinline__ void sort256(unsigned long long (&k)[8],
                                        int lane) {
#pragma unroll
  for (int size = 2; size <= 256; size <<= 1) {
#pragma unroll
    for (int s = size >> 1; s > 0; s >>= 1) {
      if (s >= 8) {
        const int d = s >> 3;
        // ascending runs keep the minimum in their lower half
        const bool keep_min = ((lane & d) != 0) != (((8 * lane) & size) == 0);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const unsigned long long o = __shfl_xor_sync(FULL, k[i], d);
          k[i] = keep_min ? (o < k[i] ? o : k[i]) : (o > k[i] ? o : k[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (!(i & s)) cx64(k[i], k[i | s], ((8 * lane + i) & size) == 0);
      }
    }
  }
}

// The n smallest exact keys of the 256 values at vals (a value's f32 bits
// by GF id, present where below lim), by one 64-bit sort, into out[0, n)
// as (value bits, id).  Out of line: the rare selections the 32-bit keys
// cannot settle.
__device__ __noinline__ void sort_exact(const unsigned* vals, unsigned lim,
                                        uint2* out, int n, int lane) {
  unsigned long long k[8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint4 x = *reinterpret_cast<const uint4*>(vals + 8 * lane + 4 * h);
    const unsigned v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      k[4 * h + i] = v[i] < lim ? (static_cast<unsigned long long>(v[i]) << 8 |
                                   static_cast<unsigned>(8 * lane + 4 * h + i))
                                : NONE64;
  }
  sort256(k, lane);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int e = 8 * lane + i;
    if (e < n)
      out[e] = make_uint2(static_cast<unsigned>(k[i] >> 8),
                          static_cast<unsigned>(k[i]) & 0xff);
  }
  __syncwarp();
}

// Whether a selection of 32-bit keys (out: entry lane + 32 u, a value's
// bits less their low 8 over its id; full: the chosen values' bits) holds
// the n smallest exact keys in order.  Within one high part the 32-bit
// keys order by id alone, so it does where two chosen neighbours of one
// high part have one value, and every key of the n-th's high part among
// the values at vals (present where below lim) has the n-th's.  (Asking
// only that neighbours ascend and that no key past the n-th's id lies
// below it calls fewer sorts, but ran 7% slower on a bf16 state.)
__device__ __forceinline__ bool exact_ok(const unsigned* vals, unsigned lim,
                                         const unsigned (&out)[2],
                                         const unsigned (&full)[2], int n,
                                         int nm, int lane) {
  if (n == 0) return true;
  bool bad = false;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (u == 1 && nm <= 32) break;
    unsigned pk = __shfl_up_sync(FULL, out[u], 1);
    unsigned pf = __shfl_up_sync(FULL, full[u], 1);
    if (u == 1) {
      const unsigned k0 = __shfl_sync(FULL, out[0], 31);
      const unsigned f0 = __shfl_sync(FULL, full[0], 31);
      if (lane == 0) {
        pk = k0;
        pf = f0;
      }
    }
    const int e = lane + 32 * u;
    if (e >= 1 && e < n && (pk >> 8) == (out[u] >> 8) && pf != full[u])
      bad = true;
  }
  const int last = n - 1;
  const unsigned lk = __shfl_sync(FULL, last < 32 ? out[0] : out[1],
                                  last & 31);
  const unsigned lf = __shfl_sync(FULL, last < 32 ? full[0] : full[1],
                                  last & 31);
  unsigned v[8];
  read_tab(vals, v, lane);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (v[i] < lim && (v[i] >> 8) == (lk >> 8) && v[i] != lf) bad = true;
  return !__any_sync(FULL, bad);
}

// The nm smallest 32-bit keys of the 256 values at vals (a value's f32
// bits by id, present where below lim): out (entry lane + 32 u; scr the
// nm > 32 form's scratch), and the values full of the n <= nm present ones
// chosen; whether the result is the exact keys' (exact_ok).
__device__ __forceinline__ bool select_exact(const unsigned* vals,
                                             unsigned lim,
                                             unsigned (&out)[2],
                                             unsigned (&full)[2],
                                             unsigned* scr, int n, int nm,
                                             int lane) {
  unsigned k[8];
  read_tab(vals, k, lane);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    k[i] = k[i] < lim ? ((k[i] & ~0xffu) | sym(lane, i)) : ABSENT;
  select_nm(k, out, scr, nm, lane);
#pragma unroll
  for (int u = 0; u < 2; ++u)
    full[u] = lane + 32 * u < n ? vals[out[u] & 0xff] : 0u;
  return exact_ok(vals, lim, out, full, n, nm, lane);
}

// The exact truncation (minconv.topk_message: values ascending, equal ones
// by symbol) of a slot's values a (f32, rounded to the state's type; sym
// order) into its list lk, ids rotated (rt); tab holds the values by
// symbol for the read-back, scr is the second table.  A bf16 state's
// values are bf16: their f32 bits end in 16 zeros, so the 32-bit keys are
// the exact ones, and the selection needs neither read-back nor check.
template <class ST>
__device__ __forceinline__ void truncate_exact(const float (&a)[8],
                                               uint2* lk, unsigned* tab,
                                               unsigned* scr, int rt, int q,
                                               int nm, int lane) {
  if constexpr (sizeof(ST) == 2) {
    unsigned k[8], out[2];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      k[i] = sym(lane, i) < q ? __float_as_uint(a[i]) | sym(lane, i) : ABSENT;
    select_nm(k, out, scr, nm, lane);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = lane + 32 * u;
      if (u == 0 || nm > 32) {
        const unsigned g = rotate(out[u] & 0xff, rt) & 0xff;
        if (e < nm) lk[e] = make_uint2(out[u] & ~0xffu, g);
      }
    }
    __syncwarp();
    return;
  }
  unsigned v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    v[i] = sym(lane, i) < q ? __float_as_uint(a[i]) : ABSENT;
#pragma unroll
  for (int h = 0; h < 2; ++h)
    *reinterpret_cast<uint4*>(tab + sym(lane, 4 * h)) =
        make_uint4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
  __syncwarp();
  unsigned out[2], full[2];
  const bool kept = select_exact(tab, ABSENT, out, full, scr, nm, nm, lane);
  if (!kept) sort_exact(tab, ABSENT, lk, nm, lane);
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int e = lane + 32 * u;
    if (u == 0 || nm > 32) {
      const unsigned id = kept ? out[u] & 0xff : (e < nm ? lk[e].y : 0u);
      const unsigned g = rotate(id, rt) & 0xff;
      if (e < nm) lk[e] = make_uint2(kept ? full[u] : lk[e].x, g);
    }
  }
  __syncwarp();
}

// A candidate's sum, clamped at BIG, as f32 bits.
__device__ __forceinline__ unsigned sum_bits(uint2 a, uint2 b) {
  return __float_as_uint(
      fminf(__fadd_rn(entry_value(a), entry_value(b)), BIG));
}

// The exact merge's tail, where only nh < nm GF ids have a sum below BIG:
// as the plain version's list goes on, value BIG, then the GF ids of
// every candidate left (a masked duplicate or a sum clamped at BIG) in id
// order, each as often as such candidates have it: counted into cnt, and
// placed by a warp prefix sum of the counts (less one for a head).
__device__ __forceinline__ void exact_tail(const uint2* la, const uint2* lb,
                                           uint2* lo, const unsigned* tab,
                                           unsigned* cnt, int nh, int nm,
                                           int lane) {
  fill_tab(cnt, 0u, lane);
  __syncwarp();
  for (int i = 0; i < nm; ++i) {
    const unsigned ga = la[i].y;
    for (int j = lane; j < nm; j += 32)
      atomicAdd(cnt + ((ga ^ lb[j].y) & 0xff), 1u);
  }
  __syncwarp();
  int d[8], sum = 0;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int g = 8 * lane + u;
    d[u] = static_cast<int>(cnt[g]) - (tab[g] < BIG_BITS ? 1 : 0);
    sum += d[u];
  }
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += y;
  }
  int pos = nh + incl - sum;
#pragma unroll
  for (int u = 0; u < 8; ++u)
    for (int c = 0; c < d[u] && pos < nm; ++c, ++pos)
      lo[pos] = make_uint2(BIG_BITS, 8 * lane + u);
}

// One exact merge (list_combine, nbOper <= 0; w0, w1: the staircase's
// widths of the lane's rows, lane and lane + 32): out = the nm smallest
// distinct-GF sums of the lists a and b (f32, clamped at BIG), their
// per-GF minima folded into tab by atomicMin.  First the staircase's
// candidates (pairs), and a selection.  Both lists ascend and __fadd_rn
// is monotone, so with nm GF ids below BIG a candidate whose sum exceeds
// the nm-th's value cannot enter the nm smallest nor lower a kept
// minimum; the bound is the largest value of the nm-th's 32-bit key, so
// it holds whether or not that selection was exact.  Then each row i
// (one a lane) visits its candidates past the staircase up to its first
// sum past the bound; if one lowered a minimum, the selection runs again.
// With fewer than nm ids below BIG every other candidate is visited, and
// the tail follows.  Out of line (one copy).
__device__ __noinline__ void merge_exact(const uint2* la, const uint2* lb,
                                         uint2* lo, unsigned* tab,
                                         const uint16_t* pairs, int npairs,
                                         int nm, int w0, int w1, int lane) {
  unsigned* scr = tab + TAB;
  const int budget = table_budget(nm, 0);  // the pairs' staircase
  fill_tab(tab, ABSENT, lane);
  __syncwarp();
  for (int c = lane; c < npairs; c += 32) {
    const unsigned p = pairs[c];
    const uint2 a = la[p >> 8], b = lb[p & 0xff];
    atomicMin(tab + ((a.y ^ b.y) & 0xff), sum_bits(a, b));
  }
  // the smallest first sum past the staircase of the lane's rows, taken
  // before the selection so that its loads are off the path to the bound
  unsigned first = ABSENT;
  for (int i = lane, j0 = w0; i < nm; i += 32, j0 = w1)
    if (j0 < nm) first = min(first, sum_bits(la[i], lb[j0]));
  unsigned out[2], full[2];
  int nh, n;
  bool kept;
  for (int pass = 0;; ++pass) {
    __syncwarp();
    unsigned v[8];
    read_tab(tab, v, lane);
    int heads = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) heads += v[i] < BIG_BITS;
    nh = __reduce_add_sync(FULL, heads);
    n = nh < nm ? nh : nm;
    kept = select_exact(tab, BIG_BITS, out, full, scr, n, nm, lane);
    if (pass == 1) break;
    if (nh >= nm) {
      const unsigned bound =
          __shfl_sync(FULL, nm <= 32 ? out[0] : out[1], (nm - 1) & 31) |
          0xffu;
      if (!__any_sync(FULL, first <= bound)) break;
      bool lowered = false;
      for (int i = lane, j0 = w0; i < nm; i += 32, j0 = w1) {
        const uint2 a = la[i];
        for (int j = j0; j < nm; ++j) {
          const uint2 b = lb[j];
          const unsigned s = sum_bits(a, b);
          if (s > bound) break;
          lowered |= atomicMin(tab + ((a.y ^ b.y) & 0xff), s) > s;
        }
      }
      if (!__any_sync(FULL, lowered)) break;
    } else {
      for (int i = 0; i < nm; ++i) {
        const uint2 a = la[i];
        for (int j = row_width(i, nm, budget) + lane; j < nm; j += 32)
          atomicMin(tab + ((a.y ^ lb[j].y) & 0xff), sum_bits(a, lb[j]));
      }
    }
  }
  if (kept) {
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (lane + 32 * u < n) lo[lane + 32 * u] = make_uint2(full[u], out[u] & 0xff);
  } else {
    sort_exact(tab, BIG_BITS, lo, n, lane);
  }
  if (nh < nm) exact_tail(la, lb, lo, tab, scr, nh, nm, lane);
  __syncwarp();
}

// The fast step (EXACT false: the staircase, nbOper >= 1) and the exact
// mode in its structure (EXACT: nbOper <= 0), nm <= 64, one row's lists
// in a block's shared memory.
template <class ST, bool EXACT>
__global__ void __launch_bounds__(
    THREADS, !EXACT ? BLOCKS_SM
             : sizeof(ST) == 2 ? EXACT_BLOCKS_SM_BF16 : EXACT_BLOCKS_SM_F32)
    list_kernel(const Params p) {
  typedef typename std::conditional<EXACT, uint2, unsigned>::type Entry;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&g_launches, 1ULL);
  const int dc = p.dc, q = p.q, nm = p.nm, logq = p.logq;
  const bool vec = p.vec != 0;
  // the staircase's (i, j) pairs, once a block
  const int budget = table_budget(nm, p.nboper);
  uint16_t* pairs = reinterpret_cast<uint16_t*>(smem_raw);
  for (int idx = threadIdx.x; idx < nm * nm; idx += blockDim.x) {
    const int i = idx / nm, j = idx % nm;
    if (j < row_width(i, nm, budget)) {
      int off = 0;
      for (int u = 0; u < i; ++u) off += row_width(u, nm, budget);
      pairs[off + j] = static_cast<uint16_t>(i << 8 | j);
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  const Layout lay = layout(dc, q, nm, sizeof(ST), EXACT);
  unsigned char* base =
      smem_raw + align16(2LL * p.npairs) + lay.total * warp;
  ST* mvc = reinterpret_cast<ST*>(base);
  Entry* lists = reinterpret_cast<Entry*>(base + lay.lists);
  unsigned* tab = reinterpret_cast<unsigned*>(base + lay.tab);
  const unsigned empty = fkey(BIG);  // an expansion's absent symbol
  // list L: entries lists + L nm; F[t] = dc + t - 1 (F[0] = 0),
  // B[t] = 2 dc - 3 + t (B[dc-1] = dc - 1)
  auto fwd = [&](int t) { return t == 0 ? 0 : dc + t - 1; };
  auto bwd = [&](int t) { return t == dc - 1 ? dc - 1 : 2 * dc - 3 + t; };
  // the exact merges' rows of this lane: past the staircase from w0, w1
  const int w0 = row_width(lane, nm, budget);
  const int w1 = row_width(lane + 32, nm, budget);
  auto merge_lists = [&](const Entry* x, const Entry* y, Entry* o) {
    if constexpr (EXACT)
      merge_exact(x, y, o, tab, pairs, p.npairs, nm, w0, w1, lane);
    else
      merge(x, y, o, tab, pairs, p.npairs, nm, lane);
  };
  ST* app = static_cast<ST*>(p.app);
  ST* cv_v = static_cast<ST*>(p.cv_v);
  ST* cv_sat = static_cast<ST*>(p.cv_sat);

  for (long long t = static_cast<long long>(blockIdx.x) * wpb + warp;
       t < p.T; t += static_cast<long long>(gridDim.x) * wpb) {
    const long long f = t / p.G, r = t % p.G;
    if (!__ldg(p.active + f)) continue;
    const int* rcols = p.cols + r * dc;
    const int* redges = p.edges + r * dc;
    // 1. the slots' lists: gathers, VN extrinsic, truncation, rotation
    for (int k = 0; k < dc; ++k) {
      Entry* lk = lists + k * nm;
      if (p.valid && !__ldg(p.valid + r * dc + k)) {
        for (int e = lane; e < nm; e += 32) lk[e] = neutral_entry<Entry>(e);
        continue;
      }
      const int col = __ldg(rcols + k), edge = __ldg(redges + k);
      if (col < 0 || col >= p.app_rows || edge < 0 || edge >= p.cv_rows)
        __trap();
      const long long ce = f * p.cv_rows + edge;
      const int rt = rot_table(p.rc_in + (r * dc + k) * logq, logq, lane);
      float a[8] = {};
      load_row(app + (f * p.app_rows + col) * q, a, q, vec, lane);
      fill_tab(tab, empty, lane);
      __syncwarp();
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int e = lane + 32 * u;
        if (e < nm)
          atomicMin(tab + p.cv_g[ce * nm + e], fkey(ld(cv_v + ce * nm + e)));
      }
      const float sat = ld(cv_sat + ce);
      __syncwarp();
      unsigned tt[8];
      read_tab(tab, tt, lane);
      float c[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) c[i] = fminf(fval(tt[i]), sat);
      rnd8<ST>(c);
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = __fsub_rn(a[i], c[i]);
      rnd8<ST>(a);
      float mn = __int_as_float(0x7f800000);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (sym(lane, i) < q) mn = fminf(mn, a[i]);
      mn = warp_min(mn);
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = __fsub_rn(a[i], mn);
      rnd8<ST>(a);
      store_row(mvc + k * q, a, q, q >= 4, lane);
      if constexpr (EXACT) {
        truncate_exact<ST>(a, lk, tab, tab + TAB, rt, q, nm, lane);
      } else {
        unsigned key[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int s = sym(lane, i);
          key[i] = s < q ? bf16_bits(a[i]) << 8 | s : ABSENT;
        }
        unsigned out[2];
        select_nm(key, out, tab, nm, lane);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int e = lane + 32 * u;
          if (u == 0 || nm > 32) {
            const int g = rotate(out[u] & 0xff, rt) & 0xff;
            if (e < nm) lk[e] = (out[u] & 0xffffff00u) | g;
          }
        }
        __syncwarp();
      }
    }
    // 2. the F/B chain (fb_checknode_list): dc = 1 the neutral list, dc = 2
    // the swap, else the forward and backward merges, then the middles
    // (out[k] into list k, which no later merge reads)
    if (dc == 1) {
      for (int e = lane; e < nm; e += 32) lists[e] = neutral_entry<Entry>(e);
      __syncwarp();
    }
    for (int u = 1; dc >= 3 && u <= dc - 2; ++u) {
      const int a = fwd(u - 1), o = fwd(u);
      merge_lists(lists + a * nm, lists + u * nm, lists + o * nm);
      const int v = dc - 1 - u, b = bwd(v + 1), ob = bwd(v);
      merge_lists(lists + b * nm, lists + v * nm, lists + ob * nm);
    }
    for (int u = 1; dc >= 3 && u <= dc - 2; ++u) {
      const int a = fwd(u - 1), b = bwd(u + 1);
      merge_lists(lists + a * nm, lists + b * nm, lists + u * nm);
    }
    // 3. rotate out, saturate, write back the real slots
    for (int k = 0; k < dc; ++k) {
      if (p.valid && !__ldg(p.valid + r * dc + k)) continue;
      const int src = dc == 1 ? 0
                      : dc == 2 ? 1 - k
                      : k == 0 ? bwd(1)
                      : k == dc - 1 ? fwd(dc - 2) : k;
      const Entry* ol = lists + src * nm;
      const int rt = rot_table(p.rc_out + (r * dc + k) * logq, logq, lane);
      const float v0 = entry_value(ol[0]);
      float v[2];
      int g[2];
      float last = 0.0f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int e = lane + 32 * u;
        const Entry c = e < nm ? ol[e] : Entry();
        g[u] = u == 0 || nm > 32 ? rotate(entry_id(c), rt) & 0xff : 0;
        if (e < nm) {
          v[u] = __fsub_rn(entry_value(c), v0);
          if (v[u] < HALF_BIG) last = fmaxf(last, v[u]);
        }
      }
      const float sat = __fadd_rn(warp_max(last), p.offset);
      const int col = __ldg(rcols + k), edge = __ldg(redges + k);
      const long long ce = f * p.cv_rows + edge;
      fill_tab(tab, empty, lane);
      __syncwarp();
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int e = lane + 32 * u;
        if (e < nm) {
          v[u] = fminf(v[u], sat);
          st(cv_v + ce * nm + e, v[u]);
          p.cv_g[ce * nm + e] = static_cast<uint8_t>(g[u]);
          atomicMin(tab + g[u], fkey(v[u]));
        }
      }
      if (lane == 0) st(cv_sat + ce, sat);
      __syncwarp();
      unsigned tt[8];
      read_tab(tab, tt, lane);
      float m[8] = {}, o[8];
      load_row(mvc + k * q, m, q, q >= 4, lane);
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i] = fminf(fval(tt[i]), sat);
      rnd8<ST>(o);
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i] = __fadd_rn(m[i], o[i]);
      store_row(app + (f * p.app_rows + col) * q, o, q, vec, lane);
      __syncwarp();
    }
  }
}

// ---- the general step: every shape list_kernel does not take ----
//
// Lists of 65 to q = 256 entries on either merge, and rows whose lists do
// not fit a block's shared memory.  Its steps around the merges are the
// fast step's (the same gathers, rounding points, rotations, saturation
// and write-back); a row's mvc goes to shared memory (or its workspace
// slot) first, and each mode builds its lists from it:
// * The staircase (nbOper >= 1; list_general_kernel<ST, false, WS>): one
//   u32 an entry, the fast step's key (a value's bf16 bits over its GF
//   id) with its DUP_ENTRY marker.  A truncation or a merge writes its
//   256 keys to the warp's table, sorts them with one 32-bit bitonic
//   network (sort8, then runs of 16 to 256 across the lanes) and keeps the
//   first nm; a merge folds the staircase's candidates (the block's pair
//   table) into per-GF minima by shared-memory atomics, as the fast step's.
// * The exact merge (nbOper <= 0; list_general_kernel<ST, true, WS>) at
//   q = 256, dc >= 3 and nm = q (nothing truncated): dense.  An exact
//   merge's heads are the per-GF minima of all na * nb sums clamped at
//   BIG, whatever the lists' order, so each list is held as a q-vector by
//   GF id and each merge is the XOR min-convolution of two vectors
//   (dense_pair, K1's dense merge: register tiling over XOR cosets, two
//   candidates a three-input integer minimum on the f32 bits, two merges a
//   pass).  At nm = q every truncation is the identity: an input is its
//   mvc rotated, and a merge's q heads are its list as a set.  Only the dc
//   output lists are sorted, for cv_v / cv_g.  A row where a merge has
//   fewer than q heads below BIG (the tail, whose entries depend on the
//   lists' GF id multisets) runs again from its mvc through the list form,
//   its lists in the warp's workspace slot.
// * The exact list form (the other exact shapes, and the dense form's
//   tails): two words an entry (uint2: a value's f32 bits, its GF id), the
//   exact form's pruned merge (merge_exact: the staircase {(i+1)(j+1) <=
//   2 nm} first, then only the candidates that can still reach the nm
//   smallest) at 8 entries a lane.
// An exact selection sorts 32-bit keys (a value's bits 30..7 over its GF
// id); only neighbours of one high part can then be out of their exact
// order, and odd-even passes over them repair it (select_exact_out).
// mvc and the lists live in shared memory where one warp's fit a block
// beside the pair table (the dense form: four warps'; SHARED); else in a
// global workspace of one slot a warp of the grid, one allocation a call
// (WORKSPACE, list_workspace_bytes), where the dense form's tail lists
// lie on either path.  The pair table and the two 256-entry tables stay
// in shared memory.
// Why the bits agree: the staircase's keys are the fast step's and are
// unique; the exact keys are unique, so each selection's result is the
// plain version's stable sort (equal values by GF id); a dense merge's
// minima are exact, so the order of its candidates cannot change a bit;
// sums are single __fadd_rn, and the rest is exact.
// Where it stands (chip_variants.py --list --general, in turns with the
// former general step: 256-key 64-bit sorts and a shared-memory atomic a
// candidate; F = 128, 1350 rows, dc = 4; NVIDIA H100 80GB HBM3, 700 W):
// the exact merge at nm = q 8.49 ms a call on a bf16 state and 8.44 on an
// f32 one (24% of its 2.04 ms bound, operations) against 109; at nm = 128
// (the list form) 6.9 / 7.3 against 27.8; the staircase at nm = 65,
// nbOper = 64, 4.12 against 21.0, and at nm = 128, nbOper = 256, 5.06
// against 28.7; the workspace (dc = 34, nm = q) 3.5 against 38.6.  At nm
// = q the dense merges take ~5.0 ms; a row with a tail costs about what
// it did (a half-padded layer: 81 against 125 ms).  Below nm = q the list
// form runs: a dense form there would need truncations between its merges,
// and measured faster only at some nm of 208 to 255 (no user of which is
// known).

constexpr int GTABS = 2 * 4 * TAB;    // a warp's minima and counts tables
// blocks an SM the registers aim at: the staircase's instance, the exact
constexpr int GEN_BLOCKS_SM_STAIR = 6;
constexpr int GEN_BLOCKS_SM_EXACT = 4;

// Where a shape runs (list_path).
enum Path { REFUSED = 0, FAST = 1, SHARED = 2, WORKSPACE = 3, EXACT = 4 };

// How the general step merges: the staircase, the exact list form, dense.
enum GMode { G_STAIR = 0, G_LIST = 1, G_DENSE = 2 };

__host__ __device__ inline int gmode(int dc, int q, int nm, int nboper) {
  return nboper >= 1 ? G_STAIR
         : (q == TAB && nm == q && dc >= 3) ? G_DENSE
                                            : G_LIST;
}

// One warp's rows of the general step: mvc [dc, q] (the state's type),
// then its lists (u32 [lists, nm] for the staircase, uint2 [lists, nm]
// for the exact list form, f32 [lists, q] for the dense form), in shared
// memory or in its workspace slot; and the dense form's tail lists (uint2
// [lists, nm], which a row needs only when it has a tail) always in the
// workspace slot, past the rows where those are there too.
struct GLayout {
  long long lists, rows, tail;
};

__host__ __device__ inline GLayout glayout(int dc, int q, int nm, int nboper,
                                           int elem) {
  const int mode = gmode(dc, q, nm, nboper);
  GLayout l;
  l.lists = align16(static_cast<long long>(elem) * dc * q);
  l.rows = l.lists + align16((mode == G_DENSE  ? 4LL * q
                              : mode == G_STAIR ? 4LL * nm
                                                : 8LL * nm) *
                             n_lists(dc));
  l.tail = mode == G_DENSE ? align16(8LL * n_lists(dc) * nm) : 0;
  return l;
}

// One warp's workspace slot on a path: its rows from the workspace, and
// the dense form's tail lists on either path.
__host__ __device__ inline long long ws_slot(const GLayout& l, bool ws) {
  return (ws ? l.rows : 0) + l.tail;
}

// The warp's 256 keys ascending, key p = 8 lane + i in register i.
__device__ __forceinline__ void sort256u(unsigned (&k)[8], int lane) {
  sort8(k);
  sort_runs<8, 256>(k, lane);
}

// The staircase's selection: the n smallest keys (bits << 8 | g) of the
// 256 bf16 bits at tab (by GF id or symbol, ABSENT where none) into
// out[0, n) ascending, an absent one as the dup marker (DUP_ENTRY | e).
__device__ __noinline__ void select_stair_out(const unsigned* tab, int n,
                                              unsigned* out, int lane) {
  unsigned k[8];
  read_tab(tab, k, lane);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    k[i] = k[i] != ABSENT ? (k[i] << 8 | sym(lane, i)) : DUP;
  sort256u(k, lane);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int e = 8 * lane + i;
    if (e < n) out[e] = k[i] == DUP ? (DUP_ENTRY | e) : k[i];
  }
  __syncwarp();
}

// Whether exact key (f, the id of k) lies above (g, the id of m).
__device__ __forceinline__ bool exact_above(unsigned f, unsigned k,
                                            unsigned g, unsigned m) {
  return f > g || (f == g && (k & 0xff) > (m & 0xff));
}

// The exact selection: the n smallest exact keys (value, GF id) of the 256
// values at vals (a value's f32 bits by id, present where below lim; n at
// most the present ones) into out[0, n) ascending as (value bits, id).
// It sorts 32-bit keys, a value's bits 30..7 over its id: within one high
// part those order by id alone, so only neighbours of one high part can
// be out of their exact order, and odd-even transposition passes over
// those pairs (rarely more than one, which finds none out of order) put
// every such run in its exact order.  Out of line (one copy).
__device__ __noinline__ void select_exact_out(const unsigned* vals,
                                              unsigned lim, int n,
                                              uint2* out, int lane) {
  unsigned k[8], f[8];
  read_tab(vals, k, lane);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    k[i] = k[i] < lim ? (min(k[i], 0x7fffffffu) >> 7 << 8 | sym(lane, i))
                      : ABSENT;
  sort256u(k, lane);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = vals[k[i] & 0xff];
  // a pair (a, b) of neighbours is swapped where it shares a high part
  // and its exact keys descend
  auto fix = [&](int a, int b, bool& moved) {
    if ((k[a] >> 8) == (k[b] >> 8) && exact_above(f[a], k[a], f[b], k[b])) {
      const unsigned tk = k[a], tf = f[a];
      k[a] = k[b], f[a] = f[b], k[b] = tk, f[b] = tf;
      moved = true;
    }
  };
  for (bool moved = true; __any_sync(FULL, moved);) {
    moved = false;
#pragma unroll
    for (int i = 0; i < 8; i += 2) fix(i, i + 1, moved);
#pragma unroll
    for (int i = 1; i < 7; i += 2) fix(i, i + 1, moved);
    // the pair across lanes: register 7 of a lane, register 0 of the next
    const unsigned nk = __shfl_down_sync(FULL, k[0], 1);
    const unsigned nf = __shfl_down_sync(FULL, f[0], 1);
    const unsigned pk = __shfl_up_sync(FULL, k[7], 1);
    const unsigned pf = __shfl_up_sync(FULL, f[7], 1);
    if (lane < 31 && (k[7] >> 8) == (nk >> 8) &&
        exact_above(f[7], k[7], nf, nk)) {
      k[7] = nk, f[7] = nf, moved = true;
    }
    if (lane > 0 && (pk >> 8) == (k[0] >> 8) &&
        exact_above(pf, pk, f[0], k[0])) {
      k[0] = pk, f[0] = pf, moved = true;
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int e = 8 * lane + i;
    if (e < n) out[e] = make_uint2(f[i], k[i] & 0xff);
  }
  __syncwarp();
}

// One staircase merge of the general step (list_combine, nbOper > 0): the
// fast step's merge with its selection over all 256 keys.
__device__ __noinline__ void merge_stair(const unsigned* la,
                                         const unsigned* lb, unsigned* lo,
                                         unsigned* tab,
                                         const uint16_t* pairs, int npairs,
                                         int nm, int lane) {
  fill_tab(tab, ABSENT, lane);
  __syncwarp();
  for (int c = lane; c < npairs; c += 32) {
    const unsigned p = pairs[c];
    const unsigned a = la[p >> 8], b = lb[p & 0xff];
    atomicMin(tab + ((a ^ b) & 0xff),
              bf16_bits(__fadd_rn(sum_value(a), sum_value(b))));
  }
  __syncwarp();
  select_stair_out(tab, nm, lo, lane);
}

// One exact merge of the list form (list_combine, nbOper <= 0): the exact
// form's merge_exact with lists of up to 256 entries.  The staircase's
// candidates (pairs) and a selection; both lists ascend and __fadd_rn is
// monotone, so with nm GF ids below BIG a candidate whose sum exceeds the
// nm-th's value cannot enter the nm smallest nor lower a kept minimum.
// Then each row i (lane, lane + 32, ...) visits its candidates past the
// staircase up to its first sum past that value; if one lowered a minimum,
// the selection runs again.  With fewer than nm ids below BIG every other
// candidate is visited, and the tail follows.  Out of line (one copy).
// Kept apart from merge_exact: one template of both, on the selection and
// the rows' widths, cost the exact form 7% on a bf16 state (2.34 against
// 2.19 ms a call at nm = 32; NVIDIA H100 80GB HBM3, 700 W).
__device__ __noinline__ void merge_exact_long(const uint2* la, const uint2* lb,
                                              uint2* lo, unsigned* tab,
                                              const uint16_t* pairs,
                                              int npairs, int nm, int lane) {
  const int budget = table_budget(nm, 0);  // the pair table's
  fill_tab(tab, ABSENT, lane);
  __syncwarp();
  for (int c = lane; c < npairs; c += 32) {
    const unsigned p = pairs[c];
    const uint2 a = la[p >> 8], b = lb[p & 0xff];
    atomicMin(tab + ((a.y ^ b.y) & 0xff), sum_bits(a, b));
  }
  // the smallest first sum past the staircase of the lane's rows
  unsigned first = ABSENT;
  for (int i = lane; i < nm; i += 32) {
    const int j0 = row_width(i, nm, budget);
    if (j0 < nm) first = min(first, sum_bits(la[i], lb[j0]));
  }
  int nh;
  for (int pass = 0;; ++pass) {
    __syncwarp();
    unsigned v[8];
    read_tab(tab, v, lane);
    int heads = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) heads += v[i] < BIG_BITS;
    nh = __reduce_add_sync(FULL, heads);
    select_exact_out(tab, BIG_BITS, nh < nm ? nh : nm, lo, lane);
    if (pass == 1) break;
    if (nh >= nm) {
      const unsigned bound = lo[nm - 1].x;
      if (!__any_sync(FULL, first <= bound)) break;
      bool lowered = false;
      for (int i = lane; i < nm; i += 32) {
        const uint2 a = la[i];
        for (int j = row_width(i, nm, budget); j < nm; ++j) {
          const uint2 b = lb[j];
          const unsigned s = sum_bits(a, b);
          if (s > bound) break;
          lowered |= atomicMin(tab + ((a.y ^ b.y) & 0xff), s) > s;
        }
      }
      if (!__any_sync(FULL, lowered)) break;
    } else {
      for (int i = 0; i < nm; ++i) {
        const uint2 a = la[i];
        for (int j = row_width(i, nm, budget) + lane; j < nm; j += 32)
          atomicMin(tab + ((a.y ^ lb[j].y) & 0xff), sum_bits(a, lb[j]));
      }
    }
  }
  if (nh < nm) exact_tail(la, lb, lo, tab, tab + TAB, nh, nm, lane);
  __syncwarp();
}

// Symbols 8 j + (R ^ hl) of a dense q = 256 vector, R < 8, in r[R]: two
// 16-byte loads, the half at hl (0 or 4) first; and the inverse.
__device__ __forceinline__ void load_chunk8(const float* v, int j, int hl,
                                            float (&r)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(v + 8 * j + hl);
  const float4 b = *reinterpret_cast<const float4*>(v + 8 * j + (hl ^ 4));
  r[0] = a.x, r[1] = a.y, r[2] = a.z, r[3] = a.w;
  r[4] = b.x, r[5] = b.y, r[6] = b.z, r[7] = b.w;
}

__device__ __forceinline__ void store_chunk8(float* v, int j, int hl,
                                             const float (&r)[8]) {
  *reinterpret_cast<float4*>(v + 8 * j + hl) =
      make_float4(r[0], r[1], r[2], r[3]);
  *reinterpret_cast<float4*>(v + 8 * j + (hl ^ 4)) =
      make_float4(r[4], r[5], r[6], r[7]);
}

// Two exact merges as dense min-convolutions at q = 256 (K1's dense_merge,
// csrc/fb_checknode.cu): o_k[s] = min(min_a u_k[a] + v_k[a ^ s], BIG).
// Lane l owns outputs 8 l .. 8 l + 7 (in the half order hl = l & 4); chunk
// c of u (a broadcast) meets chunk c ^ l of v, 64 candidates in registers
// with every index fixed at compile time.  The f32 bits of sums of
// non-negative values order as unsigned integers do (a value with its sign
// bit set, which the decoder never makes, counts as above every other, as
// the list form's atomicMin has it), so two candidates take one
// three-input integer minimum.  Stores both outputs (never an input of the
// pass) and returns their heads, the GF ids below BIG.
__device__ __forceinline__ int2 dense_pair(const float* u0, const float* v0,
                                           float* o0, const float* u1,
                                           const float* v1, float* o1,
                                           int lane) {
  const float* const u[2] = {u0, u1};
  const float* const v[2] = {v0, v1};
  const int hl = lane & 4;
  unsigned o[2][8];
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int t = 0; t < 8; ++t) o[k][t] = ABSENT;
#pragma unroll 2
  for (int c = 0; c < 32; ++c) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      float a[8], b[8];
      load_chunk8(u[k], c, 0, a);
      load_chunk8(v[k], c ^ lane, hl, b);
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int t2 = 0; t2 < 8; t2 += 2)
          o[k][t] = __vimin3_u32(
              o[k][t], __float_as_uint(__fadd_rn(a[t2], b[t2 ^ t])),
              __float_as_uint(__fadd_rn(a[t2 + 1], b[(t2 + 1) ^ t])));
    }
  }
  int h[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    float r[8];
    int heads = 0;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const unsigned x = min(o[k][t], BIG_BITS);
      heads += x < BIG_BITS;
      r[t] = __uint_as_float(x);
    }
    store_chunk8(k ? o1 : o0, lane, hl, r);
    h[k] = __reduce_add_sync(FULL, heads);
  }
  __syncwarp();
  return make_int2(h[0], h[1]);
}

// EX: the exact merge (the dense form and the list form), else the
// staircase.  WS: the rows run from the workspace (a template argument, so
// that the shared-memory form's pointers stay shared-memory ones).
template <class ST, bool EX, bool WS>
__global__ void __launch_bounds__(
    THREADS, EX ? GEN_BLOCKS_SM_EXACT : GEN_BLOCKS_SM_STAIR)
    list_general_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&g_launches, 1ULL);
  const int dc = p.dc, q = p.q, nm = p.nm, logq = p.logq;
  const bool vec = p.vec != 0;
  const int mode = EX ? gmode(dc, q, nm, p.nboper) : G_STAIR;
  // the staircase's (i, j) pairs, once a block, a row a thread
  const int budget = table_budget(nm, p.nboper);
  uint16_t* pairs = reinterpret_cast<uint16_t*>(smem_raw);
  for (int i = threadIdx.x; i < nm; i += blockDim.x) {
    const int w = row_width(i, nm, budget);
    int off = 0;
    for (int u = 0; w > 0 && u < i; ++u) off += row_width(u, nm, budget);
    for (int j = 0; j < w; ++j)
      pairs[off + j] = static_cast<uint16_t>(i << 8 | j);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  const GLayout lay = glayout(dc, q, nm, p.nboper, sizeof(ST));
  unsigned char* after = smem_raw + align16(2LL * p.npairs);
  unsigned* tab = reinterpret_cast<unsigned*>(after + GTABS * warp);
  uint2* tab2 = reinterpret_cast<uint2*>(tab);  // both tables, 256 entries
  unsigned char* slot =
      p.ws + (static_cast<long long>(blockIdx.x) * wpb + warp) *
                 ws_slot(lay, WS);
  unsigned char* base =
      WS ? slot : after + static_cast<long long>(GTABS) * wpb + lay.rows * warp;
  ST* mvc = reinterpret_cast<ST*>(base);
  unsigned* sl = reinterpret_cast<unsigned*>(base + lay.lists);
  float* dv = reinterpret_cast<float*>(base + lay.lists);
  // the exact list form's lists: the dense form's tails past its slot's rows
  uint2* xl = reinterpret_cast<uint2*>(
      mode == G_DENSE ? slot + (WS ? lay.rows : 0) : base + lay.lists);
  const unsigned empty = fkey(BIG);  // an expansion's absent symbol
  // list L: entries at L nm (dense: L q); F[t] = dc + t - 1 (F[0] = 0),
  // B[t] = 2 dc - 3 + t (B[dc-1] = dc - 1)
  auto fwd = [&](int t) { return t == 0 ? 0 : dc + t - 1; };
  auto bwd = [&](int t) { return t == dc - 1 ? dc - 1 : 2 * dc - 3 + t; };
  ST* app = static_cast<ST*>(p.app);
  ST* cv_v = static_cast<ST*>(p.cv_v);
  ST* cv_sat = static_cast<ST*>(p.cv_sat);

  for (long long t = static_cast<long long>(blockIdx.x) * wpb + warp;
       t < p.T; t += static_cast<long long>(gridDim.x) * wpb) {
    const long long f = t / p.G, r = t % p.G;
    if (!__ldg(p.active + f)) continue;
    const int* rcols = p.cols + r * dc;
    const int* redges = p.edges + r * dc;
    auto real = [&](int k) { return !p.valid || __ldg(p.valid + r * dc + k); };
    auto rot_in = [&](int k) {
      return rot_table(p.rc_in + (r * dc + k) * logq, logq, lane);
    };
    // 1. mvc of the real slots: gathers, VN extrinsic, normalisation
    for (int k = 0; k < dc; ++k) {
      if (!real(k)) continue;
      const int col = __ldg(rcols + k), edge = __ldg(redges + k);
      if (col < 0 || col >= p.app_rows || edge < 0 || edge >= p.cv_rows)
        __trap();
      const long long ce = f * p.cv_rows + edge;
      float a[8] = {};
      load_row(app + (f * p.app_rows + col) * q, a, q, vec, lane);
      fill_tab(tab, empty, lane);
      __syncwarp();
      for (int e = lane; e < nm; e += 32)
        atomicMin(tab + p.cv_g[ce * nm + e], fkey(ld(cv_v + ce * nm + e)));
      const float sat = ld(cv_sat + ce);
      __syncwarp();
      unsigned tt[8];
      read_tab(tab, tt, lane);
      float c[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) c[i] = fminf(fval(tt[i]), sat);
      rnd8<ST>(c);
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = __fsub_rn(a[i], c[i]);
      rnd8<ST>(a);
      float mn = __int_as_float(0x7f800000);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (sym(lane, i) < q) mn = fminf(mn, a[i]);
      mn = warp_min(mn);
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = __fsub_rn(a[i], mn);
      rnd8<ST>(a);
      store_row(mvc + k * q, a, q, q >= 4, lane);
      __syncwarp();
    }
    // a real slot's mvc (sym order, f32) from shared memory
    auto mvc_row = [&](int k, float (&a)[8]) {
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = 0.0f;
      load_row(mvc + k * q, a, q, q >= 4, lane);
    };
    // 2. the slots' lists and the F/B chain (fb_checknode_list): dc = 1 the
    // neutral list, dc = 2 the swap, else the forward and backward merges,
    // then the middles (out[k] into list k, which no later merge reads)
    bool tail = false;
    if constexpr (EX) {
      if (mode == G_DENSE) {
        // the inputs as q-vectors by GF id: mvc rotated (the truncation,
        // minconv.topk_message, is the identity at nm = q)
        for (int k = 0; k < dc; ++k) {
          float* d = dv + k * q;
          if (!real(k)) {  // listcn.neutral_list
#pragma unroll
            for (int i = 0; i < 8; ++i)
              d[sym(lane, i)] = sym(lane, i) == 0 ? 0.0f : BIG;
            __syncwarp();
            continue;
          }
          float a[8];
          mvc_row(k, a);
          const int rt = rot_in(k);
#pragma unroll
          for (int i = 0; i < 8; ++i)
            d[rotate(sym(lane, i), rt) & 0xff] = a[i];
          __syncwarp();
        }
        // the merges, two a pass: the chain's forward and backward step,
        // then the middles in pairs (an odd last one twice)
        const int chain = dc - 2, passes = chain + (chain + 1) / 2;
        for (int ps = 0; ps < passes && !tail; ++ps) {
          int x0, y0, o0, x1, y1, o1;
          if (ps < chain) {
            const int u = ps + 1, v = dc - 1 - u;
            x0 = fwd(u - 1), y0 = u, o0 = fwd(u);
            x1 = bwd(v + 1), y1 = v, o1 = bwd(v);
          } else {
            const int u = 2 * (ps - chain) + 1, u2 = min(u + 1, dc - 2);
            x0 = fwd(u - 1), y0 = bwd(u + 1), o0 = u;
            x1 = fwd(u2 - 1), y1 = bwd(u2 + 1), o1 = u2;
          }
          const int2 h = dense_pair(dv + x0 * q, dv + y0 * q, dv + o0 * q,
                                    dv + x1 * q, dv + y1 * q, dv + o1 * q,
                                    lane);
          tail = h.x < nm || h.y < nm;
        }
      }
      if (mode == G_LIST || tail) {
        // the exact truncations (minconv.topk_message: values ascending,
        // equal ones by symbol), ids rotated, and the list form's merges
        for (int k = 0; k < dc; ++k) {
          uint2* lk = xl + k * nm;
          if (!real(k)) {
            for (int e = lane; e < nm; e += 32)
              lk[e] = neutral_entry<uint2>(e);
            continue;
          }
          float a[8];
          mvc_row(k, a);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            unsigned v[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              v[i] = sym(lane, 4 * h + i) < q ? __float_as_uint(a[4 * h + i])
                                              : ABSENT;
            *reinterpret_cast<uint4*>(tab + sym(lane, 4 * h)) =
                make_uint4(v[0], v[1], v[2], v[3]);
          }
          __syncwarp();
          select_exact_out(tab, ABSENT, nm, lk, lane);
          const int rt = rot_in(k);
          for (int u = 0; 32 * u < nm; ++u) {
            const int e = lane + 32 * u;
            const unsigned id = e < nm ? lk[e].y : 0u;
            const int g = rotate(static_cast<int>(id), rt) & 0xff;
            if (e < nm) lk[e].y = g;
          }
          __syncwarp();
        }
        if (dc == 1) {
          for (int e = lane; e < nm; e += 32) xl[e] = neutral_entry<uint2>(e);
          __syncwarp();
        }
        auto merge_at = [&](int x, int y, int o) {
          merge_exact_long(xl + x * nm, xl + y * nm, xl + o * nm, tab, pairs,
                           p.npairs, nm, lane);
        };
        for (int u = 1; dc >= 3 && u <= dc - 2; ++u) {
          merge_at(fwd(u - 1), u, fwd(u));
          const int v = dc - 1 - u;
          merge_at(bwd(v + 1), v, bwd(v));
        }
        for (int u = 1; dc >= 3 && u <= dc - 2; ++u)
          merge_at(fwd(u - 1), bwd(u + 1), u);
      }
    } else {
      // the staircase's truncations (listcn.topk_list: the bf16 keys),
      // ids rotated, and its merges
      for (int k = 0; k < dc; ++k) {
        unsigned* lk = sl + k * nm;
        if (!real(k)) {
          for (int e = lane; e < nm; e += 32)
            lk[e] = neutral_entry<unsigned>(e);
          continue;
        }
        float a[8];
        mvc_row(k, a);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          unsigned v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            v[i] = sym(lane, 4 * h + i) < q ? bf16_bits(a[4 * h + i]) : ABSENT;
          *reinterpret_cast<uint4*>(tab + sym(lane, 4 * h)) =
              make_uint4(v[0], v[1], v[2], v[3]);
        }
        __syncwarp();
        select_stair_out(tab, nm, lk, lane);
        const int rt = rot_in(k);
        for (int u = 0; 32 * u < nm; ++u) {
          const int e = lane + 32 * u;
          const unsigned x = e < nm ? lk[e] : 0u;
          const int g = rotate(static_cast<int>(x & 0xff), rt) & 0xff;
          if (e < nm) lk[e] = (x & 0xffffff00u) | g;
        }
        __syncwarp();
      }
      if (dc == 1) {
        for (int e = lane; e < nm; e += 32) sl[e] = neutral_entry<unsigned>(e);
        __syncwarp();
      }
      auto merge_at = [&](int x, int y, int o) {
        merge_stair(sl + x * nm, sl + y * nm, sl + o * nm, tab, pairs,
                    p.npairs, nm, lane);
      };
      for (int u = 1; dc >= 3 && u <= dc - 2; ++u) {
        merge_at(fwd(u - 1), u, fwd(u));
        const int v = dc - 1 - u;
        merge_at(bwd(v + 1), v, bwd(v));
      }
      for (int u = 1; dc >= 3 && u <= dc - 2; ++u)
        merge_at(fwd(u - 1), bwd(u + 1), u);
    }
    // 3. rotate out, saturate, write back the real slots; entry lane + 32 u
    // of the output list in register u
    for (int k = 0; k < dc; ++k) {
      if (!real(k)) continue;
      const int src = dc == 1 ? 0
                      : dc == 2 ? 1 - k
                      : k == 0 ? bwd(1)
                      : k == dc - 1 ? fwd(dc - 2) : k;
      float val[8];
      unsigned id[8];
      if constexpr (EX) {
        const uint2* ol = xl + src * nm;
        if (mode == G_DENSE && !tail) {
          // the nm smallest heads, ascending
          select_exact_out(reinterpret_cast<const unsigned*>(dv + src * q),
                           BIG_BITS, nm, tab2, lane);
          ol = tab2;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int e = lane + 32 * u;
          const uint2 c = e < nm ? ol[e] : make_uint2(0u, 0u);
          val[u] = __uint_as_float(c.x);
          id[u] = c.y & 0xff;
        }
      } else {
        const unsigned* ol = sl + src * nm;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int e = lane + 32 * u;
          const unsigned c = e < nm ? ol[e] : 0u;
          val[u] = entry_value(c);
          id[u] = entry_id(c);
        }
      }
      __syncwarp();
      const int rt = rot_table(p.rc_out + (r * dc + k) * logq, logq, lane);
      const float v0 = __shfl_sync(FULL, val[0], 0);
      float v[8];
      int g[8];
      float last = 0.0f;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = lane + 32 * u;
        if (32 * u < nm) {
          g[u] = rotate(static_cast<int>(id[u]), rt) & 0xff;
          v[u] = __fsub_rn(val[u], v0);
          if (e < nm && v[u] < HALF_BIG) last = fmaxf(last, v[u]);
        }
      }
      const float sat = __fadd_rn(warp_max(last), p.offset);
      const int col = __ldg(rcols + k), edge = __ldg(redges + k);
      const long long ce = f * p.cv_rows + edge;
      fill_tab(tab, empty, lane);
      __syncwarp();
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = lane + 32 * u;
        if (e < nm) {
          v[u] = fminf(v[u], sat);
          st(cv_v + ce * nm + e, v[u]);
          p.cv_g[ce * nm + e] = static_cast<uint8_t>(g[u]);
          atomicMin(tab + g[u], fkey(v[u]));
        }
      }
      if (lane == 0) st(cv_sat + ce, sat);
      __syncwarp();
      unsigned tt[8];
      read_tab(tab, tt, lane);
      float m[8] = {}, o[8];
      load_row(mvc + k * q, m, q, q >= 4, lane);
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i] = fminf(fval(tt[i]), sat);
      rnd8<ST>(o);
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i] = __fadd_rn(m[i], o[i]);
      store_row(app + (f * p.app_rows + col) * q, o, q, vec, lane);
      __syncwarp();
    }
  }
}

// Warps a block of list_kernel for a list CN it takes (q a power of two
// <= 256, 1 <= nm <= min(q, 64), dc >= 1; nboper >= 1 the fast step, else
// the exact mode) on a state of `elem` bytes a value: WARPS, fewer where
// their shared memory and the staircase's pair table do not fit one
// block; 0 where it does not take the shape or not even one warp fits.
int warps_for(int dc, int q, int nm, int nboper, int elem) {
  if (q < 2 || q > TAB || (q & (q - 1)) || nm < 1 || nm > q ||
      nm > MAX_NM || dc < 1)
    return 0;
  const long long room =
      BLOCK_LIMIT - align16(2LL * staircase_pairs(nm, table_budget(nm, nboper)));
  const long long w = room / layout(dc, q, nm, elem, nboper < 1).total;
  return static_cast<int>(w < WARPS ? (w < 0 ? 0 : w) : WARPS);
}

// The general step's pair table a block (the staircase's, or the exact
// list form's first pass).
long long pair_bytes(int nm, int nboper) {
  return align16(2LL * staircase_pairs(nm, table_budget(nm, nboper)));
}

// Where a shape runs, decided on an f32 state's sizes so that a bf16 state
// takes the same path: list_kernel where it takes the shape (the fast
// step, or the exact mode for nboper <= 0), else the general step with
// its rows in shared memory where one warp's fit a block beside the pair
// table (the dense form: WARPS warps', as a block of fewer held its
// merges to a warp or two an SM and lost to the workspace), else from the
// workspace.  Its limits are the plain version's
// (ops/cuda_list.limits_error).
int path_for(int dc, int q, int nm, int nboper) {
  if (q < 2 || q > TAB || (q & (q - 1)) || nm < 1 || nm > q || dc < 1)
    return REFUSED;
  if (warps_for(dc, q, nm, nboper, 4) >= 1) return nboper >= 1 ? FAST : EXACT;
  const int warps = gmode(dc, q, nm, nboper) == G_DENSE ? WARPS : 1;
  if (pair_bytes(nm, nboper) +
          warps * (glayout(dc, q, nm, nboper, 4).rows + GTABS) <=
      BLOCK_LIMIT)
    return SHARED;
  return WORKSPACE;
}

// Warps a block on a state of `elem` bytes a value, 0 where refused.
int warps_of(int dc, int q, int nm, int nboper, int elem) {
  switch (path_for(dc, q, nm, nboper)) {
    case FAST:
    case EXACT:
      return warps_for(dc, q, nm, nboper, elem);
    case SHARED: {
      const long long w = (BLOCK_LIMIT - pair_bytes(nm, nboper)) /
                          (glayout(dc, q, nm, nboper, elem).rows + GTABS);
      return static_cast<int>(w < WARPS ? w : WARPS);
    }
    case WORKSPACE:
      return WARPS;
    default:
      return 0;
  }
}

// The block shape of an f32 state (a bf16 state's warps are smaller: its
// block holds as many, or more).
int block_warps(int dc, int q, int nm, int nboper) {
  return warps_of(dc, q, nm, nboper, 4);
}

// A launch configuration, found once for each device, state type and
// shape (the attributes and the occupancy query do not run per launch).
struct Config {
  int dev, dc, q, nm, nboper;
  int path;
  int wpb;              // warps a block
  long long smem;       // dynamic shared memory a block
  long long resident;   // blocks resident on the device
};

template <class ST>
auto kernel_of(int path, int nboper) {
  const bool ws = path == WORKSPACE;
  return path == FAST    ? list_kernel<ST, false>
         : path == EXACT ? list_kernel<ST, true>
         : nboper >= 1   ? (ws ? list_general_kernel<ST, false, true>
                               : list_general_kernel<ST, false, false>)
         : ws            ? list_general_kernel<ST, true, true>
                         : list_general_kernel<ST, true, false>;
}

template <class ST>
int launch_config(const Params& p, Config& out) {
  static std::mutex mu;
  static std::vector<Config> seen;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  std::lock_guard<std::mutex> hold(mu);
  for (const Config& c : seen)
    if (c.dev == dev && c.dc == p.dc && c.q == p.q && c.nm == p.nm &&
        c.nboper == p.nboper) {
      out = c;
      return 0;
    }
  Config c = {dev, p.dc, p.q, p.nm, p.nboper, 0, 0, 0, 0};
  const int elem = static_cast<int>(sizeof(ST));
  c.path = path_for(p.dc, p.q, p.nm, p.nboper);
  c.wpb = warps_of(p.dc, p.q, p.nm, p.nboper, elem);
  if (c.wpb < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (c.path == FAST || c.path == EXACT)
    c.smem = align16(2LL * p.npairs) +
             c.wpb * layout(p.dc, p.q, p.nm, elem, c.path == EXACT).total;
  else if (c.path == SHARED)
    c.smem = align16(2LL * p.npairs) +
             c.wpb * (glayout(p.dc, p.q, p.nm, p.nboper, elem).rows + GTABS);
  else
    c.smem = align16(2LL * p.npairs) + c.wpb * static_cast<long long>(GTABS);
  auto kern = kernel_of<ST>(c.path, p.nboper);
  // the same value for every shape, so no shape's setting undoes another's
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(BLOCK_LIMIT));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(kern,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kern, 32 * c.wpb, static_cast<size_t>(c.smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  c.resident = static_cast<long long>(sms) * per_sm;
  seen.push_back(c);
  out = c;
  return 0;
}

template <class ST>
int launch(Params p, void* stream) {
  if (p.T <= 0) return 0;
  Config c;
  const int err = launch_config<ST>(p, c);
  if (err) return err;
  // 4 consecutive values as one access: 16 (f32) or 8 (bf16) bytes
  p.vec = p.q >= 4 &&
          reinterpret_cast<uintptr_t>(p.app) % (4 * sizeof(ST)) == 0;
  const long long need = (p.T + c.wpb - 1) / c.wpb;
  long long blocks = need < c.resident ? need : c.resident;
  const long long slot =
      c.path == FAST || c.path == EXACT
          ? 0
          : ws_slot(glayout(p.dc, p.q, p.nm, p.nboper, sizeof(ST)),
                    c.path == WORKSPACE);
  if (slot > 0) {
    // one workspace slot a warp of the grid
    const long long fit = p.ws_bytes / slot / c.wpb;
    if (!p.ws || fit < 1) return static_cast<int>(cudaErrorInvalidValue);
    blocks = blocks < fit ? blocks : fit;
  } else {
    p.ws = nullptr;
  }
  auto kern = kernel_of<ST>(c.path, p.nboper);
  kern<<<static_cast<unsigned>(blocks), 32 * c.wpb,
         static_cast<size_t>(c.smem), static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The entries' checks and parameters; 0, or a CUDA error code.
int layer_params(Params& p, void* app, void* cv_v, uint8_t* cv_g,
                 void* cv_sat, long long F, long long app_rows,
                 long long cv_rows, const uint8_t* active, const int* cols,
                 const int* edges, const int* rc_in, const int* rc_out,
                 const uint8_t* valid, long long G, int dc, int q, int nm,
                 int nboper, float offset, void* ws, long long ws_bytes) {
  if (block_warps(dc, q, nm, nboper) < 1 || G < 1 || F < 0 || !app ||
      !cv_v || !cv_g || !cv_sat || !active || !cols || !edges || !rc_in ||
      !rc_out)
    return static_cast<int>(cudaErrorInvalidValue);
  int logq = 0;
  while ((1 << logq) < q) ++logq;
  p.app = app;
  p.cv_v = cv_v;
  p.cv_g = cv_g;
  p.cv_sat = cv_sat;
  p.app_rows = app_rows;
  p.cv_rows = cv_rows;
  p.active = active;
  p.cols = cols;
  p.edges = edges;
  p.rc_in = rc_in;
  p.rc_out = rc_out;
  p.valid = valid;
  p.T = F * G;
  p.G = G;
  p.dc = dc;
  p.q = q;
  p.logq = logq;
  p.nm = nm;
  p.nboper = nboper;
  p.npairs = staircase_pairs(nm, table_budget(nm, nboper));
  p.offset = offset;
  p.ws = static_cast<unsigned char*>(ws);
  p.ws_bytes = ws_bytes;
  return 0;
}

}  // namespace

extern "C" {

// One layered list-EMS super-layer, in place.  app: [F, app_rows, q],
// cv_v: [F, cv_rows, nm], cv_sat: [F, cv_rows] contiguous float32; cv_g:
// [F, cv_rows, nm] uint8; active: [F] bytes (0 = frozen); cols, edges:
// [G, dc] int32 APP columns and CtoV edges of the layer's rows (distinct
// among the real slots; out of range: a trap); rc_in, rc_out: [G, dc,
// log2 q] int32 GF(2)-basis columns of h and h^-1; valid: [G, dc] bytes (0
// = padded slot) or null; nboper <= 0 the exact merge, >= 1 the
// staircase's budget; ws: a device workspace of ws_bytes, at least
// list_workspace_bytes, where that is not 0 (else ignored).  Requires q a power of two <= 256, 1 <= nm <= q, dc >= 1.
// Launches on `stream`, does not synchronise, returns a CUDA error code
// (0 = launched; cudaErrorInvalidValue for arguments out of range).
int list_layer_launch(float* app, float* cv_v, uint8_t* cv_g, float* cv_sat,
                      long long F, long long app_rows, long long cv_rows,
                      const uint8_t* active, const int* cols,
                      const int* edges, const int* rc_in, const int* rc_out,
                      const uint8_t* valid, long long G, int dc, int q,
                      int nm, int nboper, float offset, void* ws,
                      long long ws_bytes, void* stream) {
  Params p = {};
  const int err = layer_params(p, app, cv_v, cv_g, cv_sat, F, app_rows,
                               cv_rows, active, cols, edges, rc_in, rc_out,
                               valid, G, dc, q, nm, nboper, offset, ws,
                               ws_bytes);
  return err ? err : launch<float>(p, stream);
}

// The same on a bf16 state: app, cv_v, cv_sat contiguous bfloat16 (each
// load widens to f32, each rounding point rounds to nearest even).  Same
// requirements and return value.
int list_layer_bf16_launch(void* app, void* cv_v, uint8_t* cv_g,
                           void* cv_sat, long long F, long long app_rows,
                           long long cv_rows, const uint8_t* active,
                           const int* cols, const int* edges,
                           const int* rc_in, const int* rc_out,
                           const uint8_t* valid, long long G, int dc, int q,
                           int nm, int nboper, float offset, void* ws,
                           long long ws_bytes, void* stream) {
  Params p = {};
  const int err = layer_params(p, app, cv_v, cv_g, cv_sat, F, app_rows,
                               cv_rows, active, cols, edges, rc_in, rc_out,
                               valid, G, dc, q, nm, nboper, offset, ws,
                               ws_bytes);
  return err ? err : launch<bf16_t>(p, stream);
}

// Where this list CN runs: 0 refused, 1 the fast step, 2 the general step
// in shared memory, 3 the general step from a workspace, 4 the exact mode
// in the fast step's structure.
int list_path(int dc, int q, int nm, int nboper) {
  return path_for(dc, q, nm, nboper);
}

// The device workspace, in bytes, that a launch on T = F * G rows of a
// state of `elem` bytes a value needs on the current device: one slot a
// warp of the grid (ws_slot: the rows of list_path WORKSPACE, of
// WS_BLOCKS_SM blocks an SM; the dense form's tail lists on the SHARED
// path too, of as many warps as its registers let an SM hold), fewer for
// fewer rows; 0 where the shape needs none; minus a CUDA error code.
long long list_workspace_bytes(long long T, int dc, int q, int nm, int nboper,
                               int elem) {
  const int path = path_for(dc, q, nm, nboper);
  if ((path != SHARED && path != WORKSPACE) || T <= 0) return 0;
  const long long slot =
      ws_slot(glayout(dc, q, nm, nboper, elem), path == WORKSPACE);
  if (slot == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return -static_cast<long long>(e);
  const long long warps = (T + WARPS - 1) / WARPS * WARPS;
  const long long cap =
      static_cast<long long>(path == WORKSPACE ? WS_BLOCKS_SM
                                               : GEN_BLOCKS_SM_EXACT) *
      WARPS * sms;
  return (warps < cap ? warps : cap) * slot;
}

// The kernel's launches on the current device since the library was loaded
// or last reset (counted on the device, graph replays included).
// Synchronises the device.
int list_launches(unsigned long long* out) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(out, g_launches, sizeof(g_launches));
  return static_cast<int>(e);
}

// Set list_launches' count to 0.  Synchronises the device.
int list_reset_launches() {
  const unsigned long long zero = 0;
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(g_launches, &zero, sizeof(zero));
  return static_cast<int>(e);
}

}  // extern "C"
