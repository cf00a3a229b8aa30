// The exact bubble check node (K9), one warp per group of rows, and the
// whole layered bubble super-layer step around it in one launch.
//
// Replaces the XLA ops of ems_nbldpc_tpu/ops/bubble_cn.py (_elementary, a
// lax.fori_loop of nbOper extract-min steps over 8 or 4 bubbles,
// elementary_bubble_batch, fb_checknode_bubble with its dense scatter)
// and the truncation, rotations, padding mask, saturation, normalisation,
// gathers and write-back around its call sites.  Three entry points share
// one device-side row routine:
//
// * bubble_layer_launch: one super-layer of the layered sweep, in place on
//   the decoder state APP [F, N+1, q] and CtoV [F, E+1, q] (f32):
//     for each frame f with active[f], each row r < G of the layer:
//       mvc_i = APP[f, cols[r,i]] - CtoV[f, edges[r,i]];  mvc_i -= min mvc_i
//       mcv   = CN(mvc) (below, with the tables of row r)
//       for each real slot i (valid[r,i]):
//         CtoV[f, edges[r,i]] = mcv_i;  APP[f, cols[r,i]] = mvc_i + mcv_i
//   Frozen frames are neither read nor written, and padded slots write
//   nothing, so the padding column N and edge E keep their values.
// * bubble_layer_bf16_launch: the same step on a bf16 state: each load
//   (both reads of APP and CtoV) widens to f32 (exact), the step computes
//   in f32 exactly as above, and each store rounds to bf16 (to nearest,
//   ties to even, as torch's .to(torch.bfloat16)), so it equals
//   bubble_layer_plain on that state bit for bit too.
// * bubble_rows_launch: CN on rows x [T, dc, q] -> out [T, dc, q], row t
//   with the tables of row t % G (the flooding schedule).
//
// CN of one row x [dc, q] (unrotated, min-normalised VN-to-CN messages),
// with the per-position tables rot_in, rot_out [G, dc, q] (uint8) and the
// optional valid [G, dc]:
//   1. truncate: entries above the message's nm-th smallest value -> INF
//      (ties with it stay), when `truncate` and nm < q;
//   2. rotate in: vr[u] = x[rot_in[u]];
//   3. mask: invalid slots become the delta message (0 at 0, INF elsewhere);
//   4. each slot's list: its nm smallest (value, GF id) pairs in ascending
//      order, the lower id first among equal values (a stable sort's head,
//      lax.top_k's order), minus the first value;
//   5. the forward/backward bubble check node, elementary steps E:
//        F[0] = list(0),  F[k] = E(F[k-1], list(k))     k = 1..dc-2
//        B[dc-1] = list(dc-1), B[k] = E(B[k+1], list(k)) k = dc-2..1
//        out[0] = B[1], out[dc-1] = F[dc-2],
//        out[i] = E(F[i-1], B[i+1])                     i = 1..dc-2,
//      E the nbOper-step bubble extract-min of ops/bubble_cn
//      (`variant` 8: the 8-bubble of the C reference's bubble_decoder.c;
//      L: the v2 decoder's 4-bubble L shape), with its GF dedup, its
//      validity break before the write and boundary break after it, and
//      BIG = 1e5 sentinels;
//   6. the dense output: (last kept) + offset everywhere, "last" the
//      largest kept value (offset alone when nothing was kept), the kept
//      values at their GF ids;
//   7. rotate out: y[c] = dense[rot_out[c]];
//   8. saturate: min(y, nm-th smallest + offset), when `saturate`, nm < q;
//   9. normalise: subtract the message minimum.
// Every step is a selection, a gather, an exact min or max, or one f32
// add or subtract written as __fadd_rn / __fsub_rn (nvcc contracts
// nothing), so the result equals the plain compositions
// (ops/bubble_cn.bubble_rows_plain, ops/cuda_bubble.bubble_layer_plain) bit
// for bit.  Step 8 runs only for a negative offset: with offset >= 0 every
// kept value is <= last <= last + offset = the fill, so the nm-th smallest
// is the fill or, with nm kept, last itself, and min(y, nm-th + offset)
// changes nothing.
//
// What bounds it on an H100 (3.35 TB/s).  The layered call [F = 128, 1350
// rows, dc = 4, q = 256], nm = 32, nbOper = 64, must read the APP and CtoV
// rows once and write both once, 2.83 GB: 0.846 ms (the bare call on
// 172,800 rows, 1.42 GB: 0.42 ms).  Its 3 (dc - 2) = 6 elementary steps a
// row are at most 64 serial extract-min steps each.  What is hard is that
// every part is latency-bound: the selections are chains of warp
// exchanges, the merges serial and data dependent.
//
// What this design does about it.
// * No block barrier and no shared tile: each warp owns a group of R rows
//   (R = 8 at dc = 4, nm = 32) and walks the groups of a persistent grid.
//   Its shared memory holds one staged message, the 3 dc - 4 lists of its
//   R rows (f32 values, uint8 ids, a count each) and each lane's `seen`
//   set: 13,440 bytes at the default shape, so 16 warps share an SM (the
//   64-row tile of the design before this one allowed 8).
// * Selection without a bisection, for nm <= 32: each lane sorts its 8
//   (key, id) pairs in registers; the warp sorts the lanes' smallest
//   (lane j then holds entry j of the running list); while some lane's
//   next pair lies below the running nm-th, those pairs go in, up to 8
//   one at a time (a ballot finds the place, a shuffle makes room), more
//   by a bitonic sort and merge; one ballot ends it.  The list comes out
//   sorted, lower id first among equal values (the 64-bit key is the
//   value's order-preserving bits over the id), and its nm-th key is the
//   truncation threshold.  For nm > 32 the bisection of the design before
//   this one takes its place (32 warp reductions, a ballot take, a rank
//   count).
// * The merges run one lane per (row, chain), then one per (row, middle
//   output), over the warp's R rows: 2 R of 32 lanes, then (dc - 2) R.
// * The dense output is built in the warp's staging buffer, one message at
//   a time; the layered entry reads APP and CtoV again there to form mvc
//   (no room to keep it: the lists hold the shared memory), its loads
//   issued before the dense output is built, so it moves 1.5 times the
//   bytes of its bound.
// Where it stands (chip_smoke.py 3e and chip_variants.py --bubble, NVIDIA
// H100 80GB HBM3, 700 W): 4.2 ms per layered call at F = 128, 20% of the
// bound (the torch passes around the bare kernel: 11.3 ms), 3.7 ms
// for the bare entry at T = 172,800.  The merges take ~1.1 ms of the
// fused step, the selections ~0.8 and the re-read ~0.8.  Selecting two
// messages side by side spilled registers (6.6 ms bare); an L2 prefetch of
// a group's rows cost the fused step 1 ms.
// A column, an edge or a rotation table entry out of range traps.
// On a bf16 state (3e, the same card): 3.89 ms against 4.20 on the f32
// state in the same turns; with each load widened at once it took 5.61 ms
// (a load issued early then stalled at the widening), so the loads stay
// raw 16 bits until their first use (Raw, widen).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;
typedef __nv_bfloat16 bf16_t;

constexpr unsigned FULL = 0xffffffffu;
constexpr float INF_COST = 1e9f;          // ops/minconv.INF
constexpr float BIG = 1e5f;               // ops/bubble_cn.BIG
constexpr int WARPS = 4;                  // warps per block
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_R = 16;                 // rows a warp holds (2 R lanes)
constexpr int TARGET_WARPS = 16;          // warps an SM that R aims at
constexpr int TOPNM_MAX = 32;             // nm the register top-nm selects
constexpr int INSERT_MAX = 8;             // its candidates inserted singly
constexpr long long SM_SMEM = 233472;     // shared memory of an SM
constexpr long long BLOCK_LIMIT = 232448; // dynamic shared memory a block
//                                           may use on Hopper
constexpr long long BLOCK_RESERVED = 1024;  // the system's share a block

// Launches on this device, [0] of bubble_rows_launch and [1] of
// bubble_layer_launch, counted by the kernel itself, so that the launches
// a CUDA graph replays count too (bubble_launches).
__device__ unsigned long long g_launches[2] = {0, 0};

struct Params {
  void* app;                   // layer: state [F, N+1, q] (float or bf16)
  void* ctov;                  // layer: state [F, E+1, q] (the same)
  long long app_frame;         // elements per frame of app, ctov
  long long ctov_frame;
  long long app_rows;          // rows per frame of app, ctov
  long long ctov_rows;
  const uint8_t* active;       // layer: [F] (0 = frozen)
  const int* cols;             // layer: [G, dc] columns of APP
  const int* edges;            // layer: [G, dc] edges of CtoV
  const float* x;              // rows: [T, dc, q] input rows
  float* out;                  // rows: [T, dc, q] output rows
  long long T, G;              // rows (layer: F * G), table rows
  int dc, q, nm, nb_oper;
  const uint8_t* rot_in;       // [G, dc, q]
  const uint8_t* rot_out;
  const uint8_t* valid;        // [G, dc] (0 = padding slot) or null
  int truncate, saturate;      // steps 1 and 8
  float offset;
  int R;                       // rows a warp holds
};

// Shared memory of one warp, carved in this order (ops/cuda_bubble.py
// warp_bytes mirrors it): the staging buffer [2 q] f32 (a message, or
// the bisection's nm sort keys); the list values
// [3 dc - 4, nm, R] f32 and ids (uint8); the lists' counts [3 dc - 4, R]
// (uint16); each lane's seen set [words, 32].
struct Layout {
  long long lv, lg, cnt, seen, total;
};

__host__ __device__ inline long long align16(long long b) {
  return (b + 15) / 16 * 16;
}

__host__ __device__ inline Layout layout(int dc, int q, int nm, int R) {
  const long long lists = 3LL * dc - 4;
  const long long entries = lists * nm * R;
  const int words = q >= 32 ? q / 32 : 1;
  Layout l;
  l.lv = align16(8LL * q);
  l.lg = l.lv + align16(4 * entries);
  l.cnt = l.lg + align16(entries);
  l.seen = l.cnt + align16(2 * lists * R);
  l.total = l.seen + 4LL * words * 32;
  return l;
}

// Order-preserving unsigned key of a float (-0 maps to +0's key).
__device__ __forceinline__ unsigned fkey(float f) {
  const unsigned b = __float_as_uint(f == 0.0f ? 0.0f : f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float fval(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// A (value, id) pair as one 64-bit key ascending in (value, id): the
// value's key, then the id, then whether the value is -0 (which orders
// as +0 but must come back as itself).
__device__ __forceinline__ u64 pair_key(float v, int id) {
  return static_cast<u64>(fkey(v)) << 32 |
         static_cast<unsigned>(id << 1 | (__float_as_uint(v) == 0x80000000u));
}

__device__ __forceinline__ float pair_val(u64 k) {
  return (k & 1ull) ? -0.0f : fval(static_cast<unsigned>(k >> 32));
}

__device__ __forceinline__ int pair_id(u64 k) {
  return static_cast<int>(k >> 1) & 0xff;
}

__device__ __forceinline__ u64 kmin64(u64 a, u64 b) { return a < b ? a : b; }
__device__ __forceinline__ u64 kmax64(u64 a, u64 b) { return a < b ? b : a; }

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// A state element as loaded (Raw<ST>::T: a bf16's 16 bits), kept so until
// its first use, where it widens to f32 (exactly), so that its load's
// latency stays hidden behind the work between; and an f32 stored to the
// state (a bf16 state rounds it to nearest even).
template <class ST>
struct Raw {
  typedef float T;
};

template <>
struct Raw<bf16_t> {
  typedef unsigned T;
};

__device__ __forceinline__ float ld_raw(const float* p) { return *p; }

__device__ __forceinline__ unsigned ld_raw(const bf16_t* p) {
  return *reinterpret_cast<const unsigned short*>(p);
}

__device__ __forceinline__ float widen(float x) { return x; }

__device__ __forceinline__ float widen(unsigned x) {
  return __uint_as_float(x << 16);
}

__device__ __forceinline__ void st_state(float* p, float v) { *p = v; }

__device__ __forceinline__ void st_state(bf16_t* p, float v) {
  *reinterpret_cast<unsigned short*>(p) =
      __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// The symbol lane `lane` holds in register i (q < 32: lanes >= q hold
// copies and are off).
template <int PER>
__device__ __forceinline__ int sym(int lane, int i, int q) {
  return PER == 1 ? (lane & (q - 1)) : lane + 32 * i;
}

// One compare-exchange across lanes at distance j.
__device__ __forceinline__ u64 cx(u64 x, int j, bool keep_min) {
  const u64 y = __shfl_xor_sync(FULL, x, j);
  return keep_min ? kmin64(x, y) : kmax64(x, y);
}

// Sort a lane's PER keys ascending in registers (a bitonic network).
template <int PER>
__device__ __forceinline__ void lane_sort(u64 (&k)[PER]) {
#pragma unroll
  for (int s = 2; s <= PER; s <<= 1)
#pragma unroll
    for (int j = s >> 1; j > 0; j >>= 1)
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int p = i ^ j;
        if (p > i) {
          const bool up = (i & s) == 0;
          const u64 lo = kmin64(k[i], k[p]), hi = kmax64(k[i], k[p]);
          k[i] = up ? lo : hi;
          k[p] = up ? hi : lo;
        }
      }
}

// Sort one key a lane across the warp, ascending (lane j gets the j-th
// smallest) or descending.
__device__ __forceinline__ u64 warp_sort(u64 x, int lane, bool desc) {
#pragma unroll
  for (int s = 2; s <= 32; s <<= 1)
#pragma unroll
    for (int j = s >> 1; j > 0; j >>= 1)
      x = cx(x, j, ((lane & j) == 0) == (((lane & s) == 0) != desc));
  return x;
}

// A bitonic sequence one key a lane, sorted ascending.
__device__ __forceinline__ u64 warp_merge(u64 x, int lane) {
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) x = cx(x, j, (lane & j) == 0);
  return x;
}

// Drop a lane's smallest key (its keys sorted ascending).
template <int PER>
__device__ __forceinline__ void pop(u64 (&k)[PER]) {
#pragma unroll
  for (int i = 0; i + 1 < PER; ++i) k[i] = k[i + 1];
  k[PER - 1] = ~0ull;
}

// The nm <= 32 smallest of the keys the lanes hold in k (absent: ~0),
// sorted: lane j returns the j-th.  Each lane sorts its keys; the warp
// sorts the lanes' smallest; then, while some lane's next key lies below
// the running nm-th, those keys go in: up to INSERT_MAX one at a time
// (a ballot finds the place, a shuffle makes room), more by a bitonic
// sort of the candidates and a bitonic merge.  A candidate that falls
// past the 32 kept is past the nm-th, and so is the rest of its lane.
template <int PER>
__device__ __forceinline__ u64 top_nm(u64 (&k)[PER], int nm, int lane) {
  lane_sort<PER>(k);
  u64 t = warp_sort(k[0], lane, false);
  pop<PER>(k);
#pragma unroll 1
  while (true) {
    const bool take = k[0] < __shfl_sync(FULL, t, nm - 1);
    unsigned ball = __ballot_sync(FULL, take);
    if (!ball) break;
    const u64 c = take ? k[0] : ~0ull;
    if (take) pop<PER>(k);
    if (__popc(ball) <= INSERT_MAX) {
#pragma unroll 1
      while (ball) {
        const u64 x = __shfl_sync(FULL, c, __ffs(ball) - 1);
        ball &= ball - 1;
        const int at = __popc(__ballot_sync(FULL, t < x));
        const u64 up = __shfl_up_sync(FULL, t, 1);
        t = lane < at ? t : lane == at ? x : up;
      }
    } else {
      t = warp_merge(kmin64(t, warp_sort(c, lane, true)), lane);
    }
  }
  return t;
}

// The n-th smallest (1-based, counted with multiplicity) of the keys the
// lanes hold in key (absent: ~0u, never counted): a bisection on the key
// bits, one warp reduction a bit.
template <int PER>
__device__ __forceinline__ unsigned kth_key(const unsigned (&key)[PER],
                                            int n) {
  unsigned r = 0;
#pragma unroll 1
  for (int b = 31; b >= 0; --b) {
    const unsigned t = r | (1u << b);
    unsigned c = 0;
#pragma unroll
    for (int i = 0; i < PER; ++i) c += key[i] < t;
    r = __reduce_add_sync(FULL, c) < static_cast<unsigned>(n) ? t : r;
  }
  return r;
}

// The nm smallest pairs (key[i], id) of a message whose nm-th smallest key
// is kth, as sort keys into tmp [nm], unordered: every pair below kth,
// then those equal to it in the ids' order (register i of every lane,
// then i + 1, ...) until nm are taken.
template <int PER>
__device__ __forceinline__ void take_list(const unsigned (&key)[PER],
                                          const u64 (&pk)[PER], unsigned kth,
                                          int nm, int lane, u64* tmp) {
  const unsigned below = (1u << lane) - 1u;
  unsigned bl[PER], be[PER];
  int nless = 0;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    bl[i] = __ballot_sync(FULL, key[i] < kth);
    be[i] = __ballot_sync(FULL, key[i] == kth);
    nless += __popc(bl[i]);
  }
  const int need = nm - nless;
  int bless = 0, beq = 0;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    if (bl[i] >> lane & 1u) {
      tmp[bless + __popc(bl[i] & below)] = pk[i];
    } else if (be[i] >> lane & 1u) {
      const int e = beq + __popc(be[i] & below);
      if (e < need) tmp[nless + e] = pk[i];
    }
    bless += __popc(bl[i]);
    beq += __popc(be[i]);
  }
}

// A list of the warp's lists: entry j of row r at (j * R + r).
struct List {
  float* v;
  uint8_t* g;
  uint16_t* n;                 // its count of row r at n[r]
};

// One exact elementary step (ops/bubble_cn.elementary_bubble_batch on one
// pair of lists) for row r: `out` = E(a, b), at most nb_oper extract-min
// steps.  NBUB = 8: rows 0..3 at column 0 move right, row 4 at columns
// 0..3 moves down, seeds and advances check index bounds only.  NBUB = 4
// (the L shape): (0, 0) and (1, 0) move right, (2, 0) and (2, 1) move
// down, and a candidate with an unfilled entry is BIG.  Once the JAX
// loop's `done` flag is set nothing changes any more, so this loop breaks
// there.  Lists are filled from the front: entries past a list's count
// hold BIG.  A bubble keeps its value and, packed in one word, its (i, j),
// the GF id of its sum (read when it moves, off the next step's path) and
// its place; the first minimal bubble is found by a tree that takes the
// right one only when strictly smaller.
template <int NBUB>
__device__ __forceinline__ void elementary(List a, List b, List out, int r,
                                           int R, int nm, int nb_oper,
                                           int qmask, unsigned* seen,
                                           int words) {
  constexpr int HALF = NBUB / 2;
  constexpr bool CHECK_IDS = NBUB == 4;
  const int na = a.n[r], nb = b.n[r];
  for (int k = 0; k < nm; ++k) out.v[k * R + r] = BIG;
  for (int w = 0; w < words; ++w) seen[w * 32] = 0u;
  // bubble t at (i, j): its value, and i | j << 9 | gf << 18 | t << 26
  auto make = [&](int i, int j, int t, float& v) -> unsigned {
    bool ok = i < nm && j < nm;
    const bool filled = i < na && j < nb;
    if (CHECK_IDS) ok = ok && filled;
    v = ok ? __fadd_rn(a.v[i * R + r], b.v[j * R + r]) : BIG;
    const unsigned gf =
        filled ? (a.g[i * R + r] ^ b.g[j * R + r]) & qmask : 0u;
    return i | j << 9 | gf << 18 | t << 26;
  };
  float bv[NBUB];
  unsigned bp[NBUB];
#pragma unroll
  for (int t = 0; t < NBUB; ++t) {
    const int i = NBUB == 8 ? (t < HALF ? t : HALF) : (t < 2 ? t : 2);
    const int j = NBUB == 8 ? (t < HALF ? 0 : t - HALF) : (t < 3 ? 0 : 1);
    bp[t] = make(i, j, t, bv[t]);
  }
  int s = 0;
  for (int op = 0; op < nb_oper; ++op) {
    // the first minimal bubble, as argmin
    float v[NBUB];
    unsigned w[NBUB];
#pragma unroll
    for (int t = 0; t < NBUB; ++t) {
      v[t] = bv[t];
      w[t] = bp[t];
    }
#pragma unroll
    for (int span = 1; span < NBUB; span <<= 1)
#pragma unroll
      for (int t = 0; t + span < NBUB; t += 2 * span)
        if (v[t + span] < v[t]) {
          v[t] = v[t + span];
          w[t] = w[t + span];
        }
    const float m = v[0];
    const int i = w[0] & 511, j = w[0] >> 9 & 511, pos = w[0] >> 26;
    // validity break before the write (an index past nm or past a count)
    if (i >= na || j >= nb) break;
    const int gf = w[0] >> 18 & 255;
    unsigned* sw = seen + (gf >> 5) * 32;
    const unsigned bit = 1u << (gf & 31), word = *sw;
    if (!(word & bit)) {
      *sw = word | bit;
      out.v[s * R + r] = m;
      out.g[s * R + r] = static_cast<uint8_t>(gf);
      if (++s >= nm) break;
    }
    // boundary break after the write
    if (i >= nm - 1 || j >= nm - 1) break;
    const bool down = pos >= HALF;
    float nv;
    const unsigned np = make(down ? i + 1 : i, down ? j : j + 1, pos, nv);
#pragma unroll
    for (int t = 0; t < NBUB; ++t) {
      if (t == pos) {
        bv[t] = nv;
        bp[t] = np;
      }
    }
  }
  out.n[r] = static_cast<uint16_t>(s);
}

// A table entry of a rotation (< q, else a fault).
__device__ __forceinline__ int rot_entry(const uint8_t* tab, long long i,
                                         int q) {
  const int u = __ldg(tab + i);
  if (u >= q) __trap();
  return u;
}

// The APP column and CtoV edge of slot k of layer row g (in range, else a
// fault).
__device__ __forceinline__ void slot_rows(const Params& p, long long g, int k,
                                          long long& col, long long& edge) {
  col = __ldg(p.cols + g * p.dc + k);
  edge = __ldg(p.edges + g * p.dc + k);
  if (col < 0 || col >= p.app_rows || edge < 0 || edge >= p.ctov_rows)
    __trap();
}

// mvc = a - c minus its min (lanes that are off: +inf), a and c widened.
template <int PER, class T>
__device__ __forceinline__ void extrinsic(const T (&a)[PER],
                                          const T (&c)[PER], bool on,
                                          float (&v)[PER]) {
  float mn = __int_as_float(0x7f800000);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    v[i] = on ? __fsub_rn(widen(a[i]), widen(c[i]))
              : __int_as_float(0x7f800000);
    mn = fminf(mn, v[i]);
  }
  mn = warp_min(mn);
#pragma unroll
  for (int i = 0; i < PER; ++i) v[i] = __fsub_rn(v[i], mn);
}

// The lane's symbols of one APP row and one CtoV row of frame f (state
// elements of type ST), raw.
template <int PER, class ST, class T = typename Raw<ST>::T>
__device__ __forceinline__ void load_slot(const Params& p, long long f,
                                          long long col, long long edge,
                                          int lane, bool on, T (&a)[PER],
                                          T (&c)[PER]) {
  const ST* arow = static_cast<const ST*>(p.app) + f * p.app_frame +
                   col * p.q;
  const ST* crow = static_cast<const ST*>(p.ctov) + f * p.ctov_frame +
                   edge * p.q;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int s = sym<PER>(lane, i, p.q);
    a[i] = on ? ld_raw(arow + s) : T(0);
    c[i] = on ? ld_raw(crow + s) : T(0);
  }
}

// The loads of slot k of row `row` (layer: its APP and CtoV symbols;
// rows: x's) into a and c, and its rotation into rin; nothing for a
// padded slot.  Returns whether the slot is real.
template <int PER, bool LAYER, class ST, class T = typename Raw<ST>::T>
__device__ __forceinline__ bool load_in(const Params& p, long long row,
                                        int k, int lane, T (&a)[PER],
                                        T (&c)[PER], int (&rin)[PER]) {
  const int dc = p.dc, q = p.q;
  const long long g = row % p.G;
  const bool on = lane < q;
  if (p.valid && !__ldg(p.valid + g * dc + k)) return false;
#pragma unroll
  for (int i = 0; i < PER; ++i)
    rin[i] = rot_entry(p.rot_in, (g * dc + k) * q + sym<PER>(lane, i, q), q);
  if constexpr (LAYER) {
    long long col, edge;
    slot_rows(p, g, k, col, edge);
    load_slot<PER, ST>(p, row / p.G, col, edge, lane, on, a, c);
  } else {
    const float* src = p.x + (row * dc + k) * q;
#pragma unroll
    for (int i = 0; i < PER; ++i)
      a[i] = on ? __ldg(src + sym<PER>(lane, i, q)) : 0.0f;
  }
  return true;
}

// Steps 1-4 for row `row` (the warp's row r): the dc lists, sorted, minus
// their first value, each of count nm; stg holds q floats, then nm sort
// keys.
template <int PER, bool LAYER, class ST>
__device__ __forceinline__ void build_lists(const Params& p, long long row,
                                            int r, float* stg, float* lv,
                                            uint8_t* lg, uint16_t* cnt,
                                            int lane) {
  const int dc = p.dc, q = p.q, nm = p.nm, R = p.R;
  const bool on = lane < q;
  const unsigned key_inf = fkey(INF_COST);
  u64* tmp = reinterpret_cast<u64*>(stg);
  typename Raw<ST>::T a[PER], c[PER];
  int rin[PER];
  bool real = load_in<PER, LAYER, ST>(p, row, 0, lane, a, c, rin);
  for (int k = 0; k < dc; ++k) {
    float* lvk = lv + static_cast<long long>(k) * nm * R + r;
    uint8_t* lgk = lg + static_cast<long long>(k) * nm * R + r;
    if (lane == 0) cnt[k * R + r] = static_cast<uint16_t>(nm);
    if (!real) {
      // a padded slot: the delta message's list, (0, 0) then (INF, 1), ...
      for (int e = lane; e < nm; e += 32) {
        lvk[e * R] = e == 0 ? 0.0f : INF_COST;
        lgk[e * R] = static_cast<uint8_t>(e);
      }
      if (k + 1 < dc)
        real = load_in<PER, LAYER, ST>(p, row, k + 1, lane, a, c, rin);
      continue;
    }
    // stage the message (layer: mvc), unrotated, and rotate it in
    float v[PER];
    if (LAYER)
      extrinsic<PER>(a, c, on, v);
    else
#pragma unroll
      for (int i = 0; i < PER; ++i) v[i] = widen(a[i]);
    if (on)
#pragma unroll
      for (int i = 0; i < PER; ++i) stg[sym<PER>(lane, i, q)] = v[i];
    __syncwarp();
#pragma unroll
    for (int i = 0; i < PER; ++i) v[i] = stg[rin[i]];
    __syncwarp();
    if (nm <= TOPNM_MAX) {
      // the register top-nm; a message whose nm-th value is INF or more
      // would lose entries to the truncation (ties with INF, or values
      // above it), so it selects again from the truncated values
      unsigned thr = ~0u;
#pragma unroll 1
      for (int pass = 0; pass < 2; ++pass) {
        u64 key[PER];
#pragma unroll
        for (int i = 0; i < PER; ++i)
          key[i] = on ? pair_key(fkey(v[i]) > thr ? INF_COST : v[i],
                                 sym<PER>(lane, i, q))
                      : ~0ull;
        const u64 t = top_nm<PER>(key, nm, lane);
        const unsigned kth =
            static_cast<unsigned>(__shfl_sync(FULL, t, nm - 1) >> 32);
        if (pass == 0 && p.truncate && kth >= key_inf) {
          thr = kth;
          continue;
        }
        const float first = pair_val(__shfl_sync(FULL, t, 0));
        if (lane < nm) {
          lvk[lane * R] = __fsub_rn(pair_val(t), first);
          lgk[lane * R] = static_cast<uint8_t>(pair_id(t));
        }
        break;
      }
    } else {
      // the bisection: the nm-th key (after the truncation, when it is
      // above INF), the pairs up to it, ranked
      unsigned key[PER];
      u64 pk[PER];
#pragma unroll
      for (int i = 0; i < PER; ++i) key[i] = on ? fkey(v[i]) : ~0u;
      unsigned kth = kth_key<PER>(key, nm);
      if (p.truncate) {
#pragma unroll
        for (int i = 0; i < PER; ++i)
          if (on && key[i] > kth) {
            v[i] = INF_COST;
            key[i] = key_inf;
          }
        if (kth > key_inf) kth = kth_key<PER>(key, nm);
      }
#pragma unroll
      for (int i = 0; i < PER; ++i) pk[i] = pair_key(v[i], sym<PER>(lane, i, q));
      take_list<PER>(key, pk, kth, nm, lane, tmp);
      __syncwarp();
      for (int e = lane; e < nm; e += 32) {
        const u64 x = tmp[e];
        int rank = 0;
        for (int j = 0; j < nm; ++j) rank += tmp[j] < x;
        lvk[rank * R] = pair_val(x);
        lgk[rank * R] = static_cast<uint8_t>(pair_id(x));
      }
      __syncwarp();
      const float first = lvk[0];
      __syncwarp();
      for (int e = lane; e < nm; e += 32)
        lvk[e * R] = __fsub_rn(lvk[e * R], first);
    }
    __syncwarp();
    if (k + 1 < dc)
      real = load_in<PER, LAYER, ST>(p, row, k + 1, lane, a, c, rin);
  }
}

// Steps 6-9 for slot k of row `row` (the warp's row r) from list L, into
// out (rows) or CtoV and APP (layer, real slots only: mvc read again).
template <int PER, bool LAYER, class ST>
__device__ __forceinline__ void write_slot(const Params& p, long long row,
                                           int k, List L, int r, float* dense,
                                           int lane) {
  const int dc = p.dc, q = p.q, R = p.R;
  const long long g = row % p.G, f = row / p.G;
  const bool on = lane < q;
  long long col = 0, edge = 0;
  typename Raw<ST>::T a[PER], c[PER];
  if (LAYER) {
    if (p.valid && !__ldg(p.valid + g * dc + k)) return;
    slot_rows(p, g, k, col, edge);
    // issued here, first used at the write-back
    load_slot<PER, ST>(p, f, col, edge, lane, on, a, c);
  }
  int rout[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i)
    rout[i] = rot_entry(p.rot_out, (g * dc + k) * q + sym<PER>(lane, i, q), q);
  const int n = L.n[r];
  unsigned kmax = 0;
  for (int j = lane; j < n; j += 32) kmax = max(kmax, fkey(L.v[j * R + r]));
  kmax = __reduce_max_sync(FULL, kmax);
  const float fill = n > 0 ? __fadd_rn(fval(kmax), p.offset) : p.offset;
  if (on)
#pragma unroll
    for (int i = 0; i < PER; ++i) dense[sym<PER>(lane, i, q)] = fill;
  __syncwarp();
  for (int j = lane; j < n; j += 32) dense[L.g[j * R + r]] = L.v[j * R + r];
  __syncwarp();
  float y[PER];
  unsigned key[PER], kmin = ~0u;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    y[i] = dense[rout[i]];
    key[i] = on ? fkey(y[i]) : ~0u;
    kmin = min(kmin, key[i]);
  }
  __syncwarp();
  float thr = __int_as_float(0x7f800000);
  if (p.saturate && !(p.offset >= 0.0f))
    thr = __fadd_rn(fval(kth_key<PER>(key, p.nm)), p.offset);
  const float mn = fminf(fval(__reduce_min_sync(FULL, kmin)), thr);
  if (LAYER) {
    float mvc[PER];
    extrinsic<PER>(a, c, on, mvc);
    if (!on) return;
    ST* crow = static_cast<ST*>(p.ctov) + f * p.ctov_frame + edge * q;
    ST* arow = static_cast<ST*>(p.app) + f * p.app_frame + col * q;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int s = sym<PER>(lane, i, q);
      const float o = __fsub_rn(fminf(y[i], thr), mn);
      st_state(crow + s, o);
      st_state(arow + s, __fadd_rn(mvc[i], o));
    }
  } else {
    if (!on) return;
    float* o = p.out + (row * dc + k) * q;
#pragma unroll
    for (int i = 0; i < PER; ++i)
      o[sym<PER>(lane, i, q)] = __fsub_rn(fminf(y[i], thr), mn);
  }
}

template <int PER, int NBUB, bool LAYER, class ST>
__global__ void __launch_bounds__(THREADS, TARGET_WARPS / WARPS)
    bubble_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(&g_launches[LAYER ? 1 : 0], 1ULL);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  const int dc = p.dc, q = p.q, nm = p.nm, R = p.R;
  const Layout lay = layout(dc, q, nm, R);
  unsigned char* base = smem_raw + lay.total * warp;
  float* stg = reinterpret_cast<float*>(base);
  float* lv = reinterpret_cast<float*>(base + lay.lv);
  uint8_t* lg = base + lay.lg;
  uint16_t* cnt = reinterpret_cast<uint16_t*>(base + lay.cnt);
  unsigned* seen = reinterpret_cast<unsigned*>(base + lay.seen) + lane;
  const int words = q >= 32 ? q / 32 : 1, qmask = q - 1;
  // list L of the warp's rows; slots: k = list(k) (then out[k], 1 <= k <=
  // dc-2), dc + t - 1 = F[t] and 2 dc - 3 + t = B[t], t = 1..dc-2
  auto list = [&](int L) {
    return List{lv + static_cast<long long>(L) * nm * R,
                lg + static_cast<long long>(L) * nm * R, cnt + L * R};
  };
  auto fwd = [&](int t) { return t == 0 ? 0 : dc + t - 1; };
  auto bwd = [&](int t) { return t == dc - 1 ? dc - 1 : 2 * dc - 3 + t; };

  const long long groups = (p.T + R - 1) / R;
  for (long long gi = static_cast<long long>(blockIdx.x) * wpb + warp;
       gi < groups; gi += static_cast<long long>(gridDim.x) * wpb) {
    const long long t0 = gi * R;
    const int rows = static_cast<int>(min(static_cast<long long>(R),
                                          p.T - t0));
    // the group's rows of active frames
    bool mine = lane < rows;
    if (LAYER && mine) mine = __ldg(p.active + (t0 + lane) / p.G) != 0;
    const unsigned act = __ballot_sync(FULL, mine);
    if (!act) continue;
    // steps 1-4, row by row
    for (int r = 0; r < rows; ++r)
      if (act >> r & 1u)
        build_lists<PER, LAYER, ST>(p, t0 + r, r, stg, lv, lg, cnt, lane);
    // step 5: one lane per (row, chain), then per (row, middle output)
    for (int item = lane; item < 2 * rows; item += 32) {
      const int r = item >> 1;
      if (!(act >> r & 1u)) continue;
      if (item & 1) {
        for (int u = dc - 2; u >= 1; --u)
          elementary<NBUB>(list(bwd(u + 1)), list(u), list(bwd(u)), r, R, nm,
                           p.nb_oper, qmask, seen, words);
      } else {
        for (int t = 1; t <= dc - 2; ++t)
          elementary<NBUB>(list(fwd(t - 1)), list(t), list(fwd(t)), r, R, nm,
                           p.nb_oper, qmask, seen, words);
      }
    }
    __syncwarp();
    for (int item = lane; item < (dc - 2) * rows; item += 32) {
      const int t = 1 + item / rows, r = item % rows;
      if (!(act >> r & 1u)) continue;
      elementary<NBUB>(list(fwd(t - 1)), list(bwd(t + 1)), list(t), r, R, nm,
                       p.nb_oper, qmask, seen, words);
    }
    __syncwarp();
    // steps 6-9, row by row, slot by slot
    for (int r = 0; r < rows; ++r) {
      if (!(act >> r & 1u)) continue;
      for (int k = 0; k < dc; ++k)
        write_slot<PER, LAYER, ST>(
            p, t0 + r, k,
            list(k == 0 ? bwd(1) : k == dc - 1 ? fwd(dc - 2) : k), r, stg,
            lane);
    }
    __syncwarp();
  }
}

// Rows a warp holds: as many (at most MAX_R) as let TARGET_WARPS warps
// share an SM, else 1 if one warp of one row fits a block, else 0
// (ops/cuda_bubble.rows_per_warp mirrors it).
int rows_per_warp(int dc, int q, int nm) {
  const long long budget =
      (SM_SMEM - BLOCK_RESERVED * (TARGET_WARPS / WARPS)) / TARGET_WARPS;
  for (int R = MAX_R; R >= 1; --R)
    if (layout(dc, q, nm, R).total <= budget) return R;
  return layout(dc, q, nm, 1).total <= BLOCK_LIMIT ? 1 : 0;
}

template <int PER, int NBUB, bool LAYER, class ST>
int launch(const Params& p, void* stream) {
  const long long wb = layout(p.dc, p.q, p.nm, p.R).total;
  // WARPS warps a block, fewer where their lists do not fit one
  const int wpb = static_cast<int>(
      BLOCK_LIMIT / wb < WARPS ? BLOCK_LIMIT / wb : WARPS);
  const long long smem = wpb * wb;
  auto kern = bubble_kernel<PER, NBUB, LAYER, ST>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(kern,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kern, 32 * wpb, static_cast<size_t>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long groups = (p.T + p.R - 1) / p.R;
  const long long need = (groups + wpb - 1) / wpb;
  const long long resident = static_cast<long long>(sms) * per_sm;
  kern<<<static_cast<unsigned>(need < resident ? need : resident), 32 * wpb,
         static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int NBUB, bool LAYER, class ST>
int launch_q(const Params& p, void* stream) {
  if (p.q <= 32) return launch<1, NBUB, LAYER, ST>(p, stream);
  if (p.q == 64) return launch<2, NBUB, LAYER, ST>(p, stream);
  if (p.q == 128) return launch<4, NBUB, LAYER, ST>(p, stream);
  return launch<8, NBUB, LAYER, ST>(p, stream);
}

// Check the CN's arguments and fill them in; 0, or a CUDA error code.
int cn_params(Params& p, int dc, int q, int nm, int nb_oper,
              const uint8_t* rot_in, const uint8_t* rot_out,
              const uint8_t* valid, long long G, int truncate, int saturate,
              float offset, int variant) {
  const int R = rows_per_warp(dc, q, nm);
  if (R < 1 || dc < 3 || nm < 1 || nm > q || q < 2 || q > 256 ||
      (q & (q - 1)) || nb_oper < 0 || !rot_in || !rot_out || G < 1 ||
      (variant != 8 && variant != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  p.G = G;
  p.dc = dc;
  p.q = q;
  p.nm = nm;
  p.nb_oper = nb_oper;
  p.rot_in = rot_in;
  p.rot_out = rot_out;
  p.valid = valid;
  p.truncate = truncate && nm < q;
  p.saturate = saturate && nm < q;
  p.offset = offset;
  p.R = R;
  return 0;
}

template <bool LAYER, class ST = float>
int dispatch(const Params& p, int variant, void* stream) {
  if (p.T <= 0) return 0;
  return variant == 8 ? launch_q<8, LAYER, ST>(p, stream)
                      : launch_q<4, LAYER, ST>(p, stream);
}

// The layer entry's checks and parameters; 0, or a CUDA error code.
int layer_params(Params& p, void* app, void* ctov, long long F,
                 long long app_rows, long long ctov_rows,
                 const uint8_t* active, const int* cols, const int* edges,
                 int dc, int q, int nm, int nb_oper, const uint8_t* rot_in,
                 const uint8_t* rot_out, const uint8_t* valid, long long G,
                 int truncate, int saturate, float offset, int variant) {
  const int err = cn_params(p, dc, q, nm, nb_oper, rot_in, rot_out, valid,
                            G, truncate, saturate, offset, variant);
  if (err) return err;
  if (!app || !ctov || !active || !cols || !edges)
    return static_cast<int>(cudaErrorInvalidValue);
  p.app = app;
  p.ctov = ctov;
  p.app_frame = app_rows * q;
  p.ctov_frame = ctov_rows * q;
  p.app_rows = app_rows;
  p.ctov_rows = ctov_rows;
  p.active = active;
  p.cols = cols;
  p.edges = edges;
  p.T = F * G;
  return 0;
}

}  // namespace

extern "C" {

// The CN on rows.  x, out: device pointers to [T, dc, q] contiguous
// float32.  rot_in, rot_out: [G, dc, q] uint8; valid: [G, dc] bytes (0 =
// padding slot) or null; row t uses table row t % G.  variant: 8
// (8-bubble) or 4 (L-bubble).  Requires q a power of two <= 256, dc >= 3,
// 1 <= nm <= q, nb_oper >= 0 and rows_per_warp(dc, q, nm) >= 1 (one row's
// lists within a block's shared memory).
// Launches on `stream`, does not synchronise, returns a CUDA error code
// (0 = launched; cudaErrorInvalidValue for arguments out of range).
int bubble_rows_launch(const float* x, float* out, long long T, int dc,
                       int q, int nm, int nb_oper, const uint8_t* rot_in,
                       const uint8_t* rot_out, const uint8_t* valid,
                       long long G, int truncate, int saturate, float offset,
                       int variant, void* stream) {
  Params p = {};
  const int err = cn_params(p, dc, q, nm, nb_oper, rot_in, rot_out, valid,
                            G > 0 ? G : 1, truncate, saturate, offset,
                            variant);
  if (err) return err;
  p.x = x;
  p.out = out;
  p.T = T;
  return dispatch<false>(p, variant, stream);
}

// One layered super-layer, in place.  app: [F, app_rows, q] and ctov:
// [F, ctov_rows, q] contiguous float32; active: [F] bytes (0 = frozen);
// cols, edges: [G, dc] int32 APP columns and CtoV edges of the layer's
// rows (distinct among the real slots; out of range: a fault); the other
// arguments as for bubble_rows_launch, row r of the layer using row r of
// rot_in, rot_out and valid.
int bubble_layer_launch(float* app, float* ctov, long long F,
                        long long app_rows, long long ctov_rows,
                        const uint8_t* active, const int* cols,
                        const int* edges, int dc, int q, int nm, int nb_oper,
                        const uint8_t* rot_in, const uint8_t* rot_out,
                        const uint8_t* valid, long long G, int truncate,
                        int saturate, float offset, int variant,
                        void* stream) {
  Params p = {};
  const int err = layer_params(p, app, ctov, F, app_rows, ctov_rows, active,
                               cols, edges, dc, q, nm, nb_oper, rot_in,
                               rot_out, valid, G, truncate, saturate, offset,
                               variant);
  return err ? err : dispatch<true>(p, variant, stream);
}

// The same on a bf16 state: app, ctov contiguous bfloat16 (each load
// widens to f32, each store rounds to nearest even).  Same requirements
// and return value.
int bubble_layer_bf16_launch(void* app, void* ctov, long long F,
                             long long app_rows, long long ctov_rows,
                             const uint8_t* active, const int* cols,
                             const int* edges, int dc, int q, int nm,
                             int nb_oper, const uint8_t* rot_in,
                             const uint8_t* rot_out, const uint8_t* valid,
                             long long G, int truncate, int saturate,
                             float offset, int variant, void* stream) {
  Params p = {};
  const int err = layer_params(p, app, ctov, F, app_rows, ctov_rows, active,
                               cols, edges, dc, q, nm, nb_oper, rot_in,
                               rot_out, valid, G, truncate, saturate, offset,
                               variant);
  return err ? err : dispatch<true, bf16_t>(p, variant, stream);
}

// The kernel's launches on the current device since the library was loaded
// or last reset: out[0] by bubble_rows_launch, out[1] by
// bubble_layer_launch and bubble_layer_bf16_launch (counted on the device,
// graph replays included).
// Synchronises the device.
int bubble_launches(unsigned long long* out) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(out, g_launches, sizeof(g_launches));
  return static_cast<int>(e);
}

// Set both counts of bubble_launches to 0.  Synchronises the device.
int bubble_reset_launches() {
  const unsigned long long zero[2] = {0, 0};
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(g_launches, zero, sizeof(zero));
  return static_cast<int>(e);
}

}  // extern "C"
