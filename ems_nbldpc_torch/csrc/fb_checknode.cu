// The whole EMS check-node step of a batch of rows, one warp per row.
//
// Replaces the Pallas TPU kernel ems_nbldpc_tpu/ops/pallas_cn.py
// (fb_checknode_pallas, launch at :138, body _cn_kernel), together with the
// XLA selections and gathers around its call sites.  For every row t of
// x [T, dc, q] (unrotated, min-normalised VN-to-CN messages), with
// g = t % G indexing the per-position tables rot_in, rot_out [G, dc, q]
// (uint8) and the optional valid [G, dc], it computes
//   1. truncate: entries above the message's nm-th smallest value -> INF
//      (ties with it stay), when `truncate` and nm < q;
//   2. rotate in: vr[u] = x[rot_in[u]];
//   3. mask: invalid slots become the delta message (0 at 0, INF elsewhere);
//   4. the forward/backward nm-truncated check node
//        combine(acc, list)[s] = min_j lv[j] + acc[s ^ lg[j]],
//      (lv, lg) the nm smallest (value, GF id) pairs, lower id first among
//      equal values:
//        F[0] = in[0],    F[k] = combine(F[k-1], list(in[k]))   k = 1..dc-2
//        B[dc-1] = in[dc-1], B[k] = combine(B[k+1], list(in[k])) k = dc-2..1
//        out[0] = B[1], out[dc-1] = F[dc-2],
//        out[i] = combine(F[i-1], list(B[i+1]))                i = 1..dc-2;
//   5. rotate out: y[c] = out[rot_out[c]];
//   6. saturate: min(y, nm-th smallest + offset), when `truncate`, nm < q;
//   7. normalise: subtract the message minimum, when `normalize`.
// Null tables mean the identity and no valid mask; with every step but 4
// off this is ops/minconv.fb_checknode_topk, the Pallas kernel's own
// reference.  Every step is a selection, a gather, an exact min or one f32
// add, so the result equals the plain composition (ops/cuda_cn.py,
// ems_rows_plain) bit for bit.
// Two modes widen it to the decoder's other EMS / min-sum routes:
// * `lst` (the lists' length, nm or q) apart from nm (the truncation and
//   saturation rank): lists of all q entries make step 4 the dense
//   min-convolution (minconv.fb_checknode_dense) of the truncated inputs,
//   since each output is then the exact minimum of the same f32 sums.  The
//   kernel then takes no lists: its dense mode (DENSE) merges whole
//   vectors, merge(u, v)[s] = min_a u[a] + v[a ^ s];
// * `round_bf16`: every merge's output rounded to bf16 (nearest even), as
//   fb_checknode_topk computes on bf16 tensors (each sum rounded, and
//   rounding is monotone, so the minimum of the rounded sums is the
//   rounded minimum); the bare entry's inputs are then bf16 values.
// Rows of dc <= 2 have no merge: dc = 2 is the swapped pair and dc = 1 the
// delta message (fb_checknode_dense's cases), with steps 1-3 and 5-7
// around them as for any row.  List-mode rows whose warp does not fit a
// block's shared memory (32-entry lists from dc = 66 on at q = 256), and
// dense rows where fewer than MAX_WARPS warps fit a block (from dc = 20
// at q = 256), run the same code from a workspace in device memory: each
// warp of the grid owns one slot for F, B and the lists, reads its row in
// place and stages nothing.  The caller allocates the workspace for each
// call (ems_rows_workspace_bytes), so a CUDA graph's capture takes it into
// the graph's pool.
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores, 132 SMs issuing at most 128 lanes' instructions a clock each).
// At the layered call [172,800, 4, 256], nm = 32, it must read and write
// 1.42 GB (0.42 ms) and do 17 G candidate adds and mins (0.25 ms): device
// memory bounds it.  The dense mode at the same rows forms 6.8e10
// candidates (3 (dc - 2) merges of q^2 a row), each one f32 add and one
// minimum: 2.03 ms at 67 TFLOP/s, but the card issues them as two
// instructions, so candidate issue, not bytes, bounds it: ~4.1 ms at
// 1.98 GHz (and FMNMX, at half the FADD rate, would take that alone).
// The tensor cores cannot help: wgmma and mma compute sums of products,
// not (min, +), so the check node lives on registers, warp shuffles and
// shared memory.  The earlier design (one block per row, lists ranked by
// O(q^2) compares, two torch.topk and six torch passes around it) issued
// 5x more compares than candidates and ran at 2% of the list mode's bound.
//
// What this design does about it.
// * One warp holds one message: lane l owns symbols l + 32 i (8 per lane at
//   q = 256).  A selection is a 32-step bisection on order-preserving key
//   bits, one __reduce_add_sync per step and no block barrier; two
//   messages are bisected side by side for instruction-level parallelism
//   (four hold 168 registers a thread and fewer warps: slower).
//   A list is then the entries below the nm-th key plus, in GF id order,
//   enough of those equal to it: two ballots per register slot.  The
//   truncation threshold of an input is also its list boundary.
// * List mode: acc lives in the warp's shared memory; for fixed g, s ^ g
//   permutes the low five bits of s within a warp, so the gather has no
//   bank conflicts.  Each lane keeps its outputs in registers and reads
//   each (lv, lg) pair once per j, as one 8-byte broadcast; two chains are
//   combined per pass.
// * Dense mode (dense_merge): register tiling over XOR cosets.  Lane l
//   owns outputs PER l .. PER l + PER - 1; for each of the 32 chunks c it
//   loads u's chunk c (a broadcast) and v's chunk c ^ l, and forms their
//   PER^2 candidates in registers with every index fixed at compile time:
//   per candidate an FADD and half a three-input integer minimum (the
//   f32 bits of sums of non-negative values order as signed integers;
//   rows with a negative input take FMNMX), and 16 loads a 64 candidates
//   where the list form issued a shared-memory gather per candidate.  No
//   list stage: each input is parked once, in the slot that the later of
//   its two chain passes overwrites, so the warp needs the row, F and B
//   (10 KB at dc = 4, q = 256; the lists took 8 KB more).  At q = 256 the
//   lanes read their chunks' 16-byte halves in an order set by bit 2 of
//   the lane, so that no two lanes of a phase meet in a bank.  Two merges
//   per pass, as in the list mode.
// * A persistent grid walks the rows; each warp stages its next row
//   (dc * q * 4 bytes) with cp.async while it computes the current one.
//   The tables are read as uint8 through the read-only path.
//
// Where it stands (chip_smoke.py phase 3, NVIDIA H100 80GB HBM3, 700 W):
// 6.76 ms per layered call, 6.3% of the 0.42 ms bound, against 27.6 ms
// for torch truncation, rotations, saturation and normalisation around
// this kernel's bare check node (4.96 ms).  Instruction issue, not
// memory, limits it: a row runs 3 dc - 2 bisections of 32 steps (10 at
// dc = 4), each step 8 subtractions, 8 sign-bit adds and one warp
// reduction per message, and its merges read 1 KB of shared memory per
// warp per list entry.  At q = 256 a thread holds 128 registers, so 16
// warps share an SM.  The dense mode takes 5.23 ms a layered call
// (chip_variants.py --cn) against 16.2 ms for the list-driven merges it
// replaces, 834 ms for fb_checknode_dense's torch route and the 4.06 ms
// issue floor; its merges alone take ~4.46 ms, the integer minima saving
// ~1.5 ms against FMNMX.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float INF_COST = 1e9f;          // ops/minconv.INF
constexpr int NB = 2;                     // messages bisected side by side
constexpr int MAX_WARPS = 4;              // warps (rows in flight) per block
constexpr long long BLOCK_LIMIT = 232448;  // dynamic shared memory a block
constexpr long long WS_CAP = 256LL << 20;  // workspace bytes a call, at most
// the dense mode's merges: chunks a loop step, three-input integer minima
// on rows with no negative input
constexpr int DENSE_UNROLL = 2;
constexpr bool INT_MIN3 = true;

// Launches of ems_rows_kernel on this device, counted by the kernel itself,
// so that the launches a CUDA graph replays count too (ems_rows_launches).
__device__ unsigned long long g_launches = 0;

struct Params {
  const float* x;
  float* out;
  long long T, G;
  int dc, q, nm;
  const uint8_t* rot_in;
  const uint8_t* rot_out;
  const uint8_t* valid;
  int truncate, normalize, vec16;  // truncate: steps 1 and 6
  float offset;
  int warp_bytes;                  // one warp's shared memory (no workspace)
  int lst;                         // list length: nm, or q (dense)
  int round_bf16;                  // round each merge's output to bf16
  unsigned char* ws;               // the workspace, or null: shared memory
  long long ws_warp_bytes;         // one warp's slot of the workspace
};

// Order-preserving unsigned key of a float (-0 maps to +0's key).
__device__ __forceinline__ unsigned fkey(float f) {
  const unsigned b = __float_as_uint(f == 0.0f ? 0.0f : f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float fval(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// r[m] = the nm-th smallest key of message m, m < N (lanes that hold no
// symbol carry key ~0u and never count).  The N bisections run side by
// side with no branch between them, so their reductions overlap.  Once
// bit 31 is settled with no negative value in any message (the decoder's
// min-normalised costs never have one), every key and every later
// threshold t lies in [2^31, 2^32), so key - t fits in 32 signed bits and
// its sign bit is key < t: two instructions per key instead of three.
template <int PER, int N>
__device__ __forceinline__ void kth_keys_n(const unsigned (&key)[NB][PER],
                                           int nm, unsigned (&r)[NB]) {
  constexpr unsigned H = 0x80000000u;
  const unsigned n = static_cast<unsigned>(nm);
  unsigned neg = 0;
#pragma unroll
  for (int m = 0; m < N; ++m) {
    unsigned c = 0;
#pragma unroll
    for (int i = 0; i < PER; ++i) c += key[m][i] < H;
    c = __reduce_add_sync(FULL, c);
    neg |= c;
    r[m] = c < n ? H : 0u;
  }
  if (neg == 0) {
#pragma unroll 1
    for (int b = 30; b >= 0; --b) {
      const unsigned bit = 1u << b;
#pragma unroll
      for (int m = 0; m < N; ++m) {
        const unsigned t = r[m] | bit;
        unsigned c0 = 0, c1 = 0;
#pragma unroll
        for (int i = 0; i < PER; i += 2) {
          c0 += (key[m][i] - t) >> 31;
          if (i + 1 < PER) c1 += (key[m][i + 1] - t) >> 31;
        }
        const unsigned c = __reduce_add_sync(FULL, c0 + c1);
        r[m] = c < n ? t : r[m];
      }
    }
  } else {
#pragma unroll 1
    for (int b = 30; b >= 0; --b) {
      const unsigned bit = 1u << b;
#pragma unroll
      for (int m = 0; m < N; ++m) {
        const unsigned t = r[m] | bit;
        unsigned c = 0;
#pragma unroll
        for (int i = 0; i < PER; ++i) c += key[m][i] < t;
        c = __reduce_add_sync(FULL, c);
        r[m] = c < n ? t : r[m];
      }
    }
  }
}

// kth_keys_n for the first nb (1 or NB) messages.
template <int PER>
__device__ __forceinline__ void kth_keys(const unsigned (&key)[NB][PER],
                                         int nb, int nm, unsigned (&r)[NB]) {
  static_assert(NB == 2, "one case per message count");
  if (nb == 1)
    kth_keys_n<PER, 1>(key, nm, r);
  else
    kth_keys_n<PER, 2>(key, nm, r);
}

// The list boundaries of the first nb messages for lists of n entries:
// their n-th smallest keys, or for lists of all q symbols ~0u, above every
// symbol's key (take_list then takes them all, with no bisection).
template <int PER>
__device__ __forceinline__ void list_bounds(const unsigned (&key)[NB][PER],
                                            int nb, int n, int q,
                                            unsigned (&r)[NB]) {
  if (n >= q) {
#pragma unroll
    for (int m = 0; m < NB; ++m) r[m] = ~0u;
  } else {
    kth_keys<PER>(key, nb, n, r);
  }
}

// A merge's outputs rounded to bf16, nearest even (round_bf16).
template <int PER, int K>
__device__ __forceinline__ void round_out(float (&o)[K][PER]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < PER; ++i)
      o[k][i] = __bfloat162float(__float2bfloat16_rn(o[k][i]));
}

// The nm smallest (value, GF id) pairs of a message v (this lane reads its
// own symbols s[i]) whose nm-th smallest key is `kth`: every entry below
// it, then those equal to it in GF id order until nm are taken.  Slots are
// unique; their order is free.
template <int PER>
__device__ __forceinline__ void take_list(const unsigned (&key)[PER],
                                          const float* v,
                                          const int (&s)[PER], bool on,
                                          unsigned kth, int nm, int lane,
                                          float2* lst) {
  const unsigned below = (1u << lane) - 1u;
  unsigned bl[PER], be[PER];
  int nless = 0;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    bl[i] = __ballot_sync(FULL, on && key[i] < kth);
    be[i] = __ballot_sync(FULL, on && key[i] == kth);
    nless += __popc(bl[i]);
  }
  const int need = nm - nless;
  int bless = 0, beq = 0;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const float2 e = make_float2(on ? v[s[i]] : 0.0f, __int_as_float(s[i]));
    if (bl[i] >> lane & 1u) {
      lst[bless + __popc(bl[i] & below)] = e;
    } else if (be[i] >> lane & 1u) {
      const int r = beq + __popc(be[i] & below);
      if (r < need) lst[nless + r] = e;
    }
    bless += __popc(bl[i]);
    beq += __popc(be[i]);
  }
}

// o[k][i] = min_j lst[k][j].x + acc[k][s[i] ^ lst[k][j].y], K merges at once.
template <int PER, int K>
__device__ __forceinline__ void combine(const float* const (&acc)[K],
                                        const float2* const (&lst)[K],
                                        int nm, const int (&s)[PER],
                                        float (&o)[K][PER]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < PER; ++i) o[k][i] = __int_as_float(0x7f800000);
#pragma unroll 4
  for (int j = 0; j < nm; ++j) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float2 e = lst[k][j];
      const int g = __float_as_int(e.y);
#pragma unroll
      for (int i = 0; i < PER; ++i)
        o[k][i] = fminf(o[k][i], __fadd_rn(e.x, acc[k][s[i] ^ g]));
    }
  }
}

// r[R] = symbol PER j + (R ^ hl) of a dense-mode vector v, R < PER: chunk j
// in registers; at PER = 8 two 16-byte loads, the half at hl first
// (hl = 0 or 4).
template <int PER>
__device__ __forceinline__ void load_chunk(const float* v, int j, int hl,
                                           float (&r)[PER]) {
  if constexpr (PER == 8) {
    const float4 a = *reinterpret_cast<const float4*>(v + 8 * j + hl);
    const float4 b = *reinterpret_cast<const float4*>(v + 8 * j + (hl ^ 4));
    r[0] = a.x, r[1] = a.y, r[2] = a.z, r[3] = a.w;
    r[4] = b.x, r[5] = b.y, r[6] = b.z, r[7] = b.w;
  } else if constexpr (PER == 4) {
    const float4 a = *reinterpret_cast<const float4*>(v + 4 * j);
    r[0] = a.x, r[1] = a.y, r[2] = a.z, r[3] = a.w;
  } else if constexpr (PER == 2) {
    const float2 a = *reinterpret_cast<const float2*>(v + 2 * j);
    r[0] = a.x, r[1] = a.y;
  } else {
    r[0] = v[j];
  }
}

// The inverse: symbol PER j + (R ^ hl) of v = r[R].
template <int PER>
__device__ __forceinline__ void store_chunk(float* v, int j, int hl,
                                            const float (&r)[PER]) {
  if constexpr (PER == 8) {
    *reinterpret_cast<float4*>(v + 8 * j + hl) =
        make_float4(r[0], r[1], r[2], r[3]);
    *reinterpret_cast<float4*>(v + 8 * j + (hl ^ 4)) =
        make_float4(r[4], r[5], r[6], r[7]);
  } else if constexpr (PER == 4) {
    *reinterpret_cast<float4*>(v + 4 * j) = make_float4(r[0], r[1], r[2],
                                                        r[3]);
  } else if constexpr (PER == 2) {
    *reinterpret_cast<float2*>(v + 2 * j) = make_float2(r[0], r[1]);
  } else {
    v[j] = r[0];
  }
}

// The dense min-convolution of K pairs at once, this lane's coset of
// outputs: o[k][T] = min_a u[k][a] + v[k][a ^ s], s = PER lo + (T ^ hl),
// T < PER.  Chunk c of u (PER symbols, the same for every lane: a
// broadcast) meets chunk c ^ lo of v, since (PER c + t') ^ s = PER (c ^ lo)
// + (t' ^ T ^ hl): PER^2 candidates in registers from 2 PER loaded values,
// every index fixed at compile time.  nch = q / PER chunks (q below 32:
// PER = 1 and lo = lane mod q).  hl: at PER = 8 the lanes load v's chunks
// (and store their outputs) in two 16-byte halves, bit 2 of the lane
// choosing which half first, so that the 8 lanes of a phase, whose chunks
// c ^ lo lie 32 bytes apart, meet 8 distinct bank groups (in one order
// they meet 4, twice each); a lane's registers then hold its outputs in
// that order too.  INT: every operand's f32 bits have the sign bit clear,
// so the sums' bits order as signed integers as their values do (and
// equal values have equal bits): two candidates a three-input integer
// minimum (__vimin3_s32, one instruction on sm_90) in place of two FMNMX.
template <int PER, int K, bool INT>
__device__ __forceinline__ void dense_merge(const float* const (&u)[K],
                                            const float* const (&v)[K],
                                            int nch, int lo, int hl,
                                            float (&o)[K][PER]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int t = 0; t < PER; ++t) o[k][t] = __int_as_float(0x7f800000);
#pragma unroll (DENSE_UNROLL)
  for (int c = 0; c < nch; ++c) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float a[PER], b[PER];
      load_chunk<PER>(u[k], c, 0, a);
      load_chunk<PER>(v[k], c ^ lo, hl, b);
#pragma unroll
      for (int t = 0; t < PER; ++t) {
        if constexpr (INT && PER >= 2) {
#pragma unroll
          for (int t2 = 0; t2 < PER; t2 += 2)
            o[k][t] = __int_as_float(__vimin3_s32(
                __float_as_int(o[k][t]),
                __float_as_int(__fadd_rn(a[t2], b[t2 ^ t])),
                __float_as_int(__fadd_rn(a[t2 + 1], b[(t2 + 1) ^ t]))));
        } else {
#pragma unroll
          for (int t2 = 0; t2 < PER; ++t2)
            o[k][t] = fminf(o[k][t], __fadd_rn(a[t2], b[t2 ^ t]));
        }
      }
    }
  }
}

// dense_merge<PER, K, INT> with INT chosen for the row: `nonneg` (no
// operand of the row's merges has its sign bit set) and INT_MIN3.
template <int PER, int K>
__device__ __forceinline__ void dense_merge_row(const float* const (&u)[K],
                                                const float* const (&v)[K],
                                                int nch, int lo, int hl,
                                                bool nonneg,
                                                float (&o)[K][PER]) {
  if (INT_MIN3 && nonneg)
    dense_merge<PER, K, true>(u, v, nch, lo, hl, o);
  else
    dense_merge<PER, K, false>(u, v, nch, lo, hl, o);
}

__device__ __forceinline__ void stage(const Params& p, float* X,
                                      long long row, int lane) {
  const int n = p.dc * p.q;
  const float* src = p.x + row * n;
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(X));
  if (p.vec16) {
    for (int c = lane; c < n / 4; c += 32)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       dst + 16 * c),
                   "l"(src + 4 * c));
  } else {
    for (int c = lane; c < n; c += 32)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       dst + 4 * c),
                   "l"(src + c));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// WS: the rows run from the workspace (a template argument, so that the
// shared-memory form's pointers stay shared-memory ones: generic loads in
// its merges cost it 1.6x).  DENSE: lists of all q entries (lst == q), the
// dense min-convolution, merged by dense_merge with no list stage.
template <int PER, bool WS, bool DENSE>
__global__ void ems_rows_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&g_launches, 1ULL);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int dc = p.dc, q = p.q, nm = p.nm, lst = p.lst, L = dc - 2;
  const int n = dc * q;
  // the staged row, then F, B and (list mode) the lists, in shared memory;
  // or F, B and the lists in this warp's workspace slot, the row read in
  // place
  float* X = reinterpret_cast<float*>(smem_raw + warp * p.warp_bytes);
  // F[k] at k*q, k = 0..dc-2
  float* Fs = WS ? reinterpret_cast<float*>(
                       p.ws + (static_cast<long long>(blockIdx.x) *
                                   (blockDim.x >> 5) + warp) *
                                  p.ws_warp_bytes)
                 : X + n;
  float* Bs = Fs + (dc - 1) * q;          // B[k] at (k-1)*q, k = 1..dc-1
  // list mode: 2L lists of lst pairs: slot k-1 = list(in[k]), k = 1..L;
  // slot L+k-2 = list(B[k]), k = 2..dc-1
  float2* Lst = reinterpret_cast<float2*>(Bs + (dc - 1) * q);
  const unsigned key_inf = fkey(INF_COST);
  // dense mode: this lane's coset (outputs PER lo .. PER lo + PER - 1, in
  // the half order hl) and the chunks a merge walks
  const int nch = q < 32 ? q : 32;
  const int lo = lane & (nch - 1);
  const int hl = PER == 8 ? lo & 4 : 0;

  int s[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i)
    s[i] = PER == 1 ? (lane & (q - 1)) : lane + 32 * i;
  const bool on = lane < q;               // lanes past q (q < 32) hold copies

  const long long warps = static_cast<long long>(gridDim.x) *
                          (blockDim.x >> 5);
  long long row = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
                  warp;
  if (!WS && row < p.T) stage(p, X, row, lane);
  for (; row < p.T; row += warps) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncwarp();
    const float* Xr = WS ? p.x + row * n : X;
    const long long g = row % p.G;
    const uint8_t* rin = p.rot_in ? p.rot_in + g * n : nullptr;
    const uint8_t* rout = p.rot_out ? p.rot_out + g * n : nullptr;
    const uint8_t* val = p.valid ? p.valid + g * dc : nullptr;
    bool nonneg = true;  // dense mode: no parked input has its sign bit set

    // prologue: rotate in, truncate, mask.  A row of dc = 1 reads no input:
    // its output, the delta message, is parked at F[0], where the epilogue
    // reads out[dc-1].
    if (dc == 1 && on) {
#pragma unroll
      for (int i = 0; i < PER; ++i)
        Fs[s[i]] = s[i] == 0 ? 0.0f : INF_COST;
    }
    if constexpr (DENSE) {
      // each input in[k], finished in registers, is parked once at its
      // home: F[0] and B[dc-1] open the chains; a middle input is read by
      // the forward chain in pass k and by the backward one in pass
      // dc-1-k, so it waits in the slot that the later of the two passes
      // overwrites: F[k] where k >= dc-1-k, else B[k]
      unsigned sign = 0;
      for (int k0 = 0; k0 < (dc > 1 ? dc : 0); k0 += NB) {
        const int nb = min(NB, dc - k0);
        float v[NB][PER];
        unsigned key[NB][PER], kth[NB];
#pragma unroll
        for (int m = 0; m < NB; ++m) {
          if (m < nb) {
            const int k = k0 + m;
#pragma unroll
            for (int i = 0; i < PER; ++i) {
              const int src = rin ? __ldg(rin + k * q + s[i]) : s[i];
              v[m][i] = Xr[k * q + src];
              key[m][i] = on ? fkey(v[m][i]) : ~0u;
            }
          }
        }
        if (p.truncate) kth_keys<PER>(key, nb, nm, kth);
#pragma unroll
        for (int m = 0; m < NB; ++m) {
          if (m < nb) {
            const int k = k0 + m;
            const bool ok = !val || val[k];
            float* home = k == 0 || (k <= L && 2 * k >= dc - 1)
                              ? Fs + k * q
                              : Bs + (k - 1) * q;
#pragma unroll
            for (int i = 0; i < PER; ++i) {
              float x = v[m][i];
              if (p.truncate && key[m][i] > kth[m]) x = INF_COST;
              if (!ok) x = s[i] == 0 ? 0.0f : INF_COST;
              if (on) home[s[i]] = x;
              sign |= __float_as_uint(x);
            }
          }
        }
      }
      nonneg = !__any_sync(FULL, sign >> 31);
    } else {
      // each input in[k] is parked at its home (F[k] for k <= dc-2, whose
      // slots the chain overwrites only after their lists are taken;
      // B[dc-1] for k = dc-1); registers hold the keys, and each lane
      // touches only its own symbols of a home
      for (int k0 = 0; k0 < (dc > 1 ? dc : 0); k0 += NB) {
        const int nb = min(NB, dc - k0);
        unsigned key[NB][PER], kth[NB];
#pragma unroll
        for (int m = 0; m < NB; ++m) {
          if (m < nb) {
            const int k = k0 + m;
            float* home = k <= L ? Fs + k * q : Bs + L * q;
#pragma unroll
            for (int i = 0; i < PER; ++i) {
              const int src = rin ? __ldg(rin + k * q + s[i]) : s[i];
              const float v = Xr[k * q + src];
              key[m][i] = on ? fkey(v) : ~0u;
              if (on) home[s[i]] = v;
            }
          }
        }
        if (p.truncate) {
          kth_keys<PER>(key, nb, nm, kth);
#pragma unroll
          for (int m = 0; m < NB; ++m) {
            if (m < nb) {
              const int k = k0 + m;
              float* home = k <= L ? Fs + k * q : Bs + L * q;
#pragma unroll
              for (int i = 0; i < PER; ++i)
                if (on && key[m][i] > kth[m]) {
                  home[s[i]] = INF_COST;
                  key[m][i] = key_inf;
                }
            }
          }
        }
        unsigned want = 0;
#pragma unroll
        for (int m = 0; m < NB; ++m) {
          if (m < nb) {
            const int k = k0 + m;
            const bool ok = !val || val[k];
            if (!ok) {
              float* home = k <= L ? Fs + k * q : Bs + L * q;
#pragma unroll
              for (int i = 0; i < PER; ++i) {
                const float v = s[i] == 0 ? 0.0f : INF_COST;
                key[m][i] = on ? fkey(v) : ~0u;
                if (on) home[s[i]] = v;
              }
            }
            // the truncation threshold is the list boundary of a valid
            // slot whose lists are nm long
            const bool mid = k >= 1 && k <= L;
            if (mid && !(p.truncate && ok && kth[m] <= key_inf && lst == nm))
              want |= 1u << m;
          }
        }
        if (want) {
          unsigned kth2[NB];
          list_bounds<PER>(key, nb, lst, q, kth2);
#pragma unroll
          for (int m = 0; m < NB; ++m)
            if (want >> m & 1u) kth[m] = kth2[m];
        }
#pragma unroll
        for (int m = 0; m < NB; ++m) {
          const int k = k0 + m;
          if (m < nb && k >= 1 && k <= L)
            take_list<PER>(key[m], Fs + k * q, s, on, kth[m], lst, lane,
                           Lst + (k - 1) * lst);
        }
      }
    }
    __syncwarp();
    // X is consumed: stage the next row while this one computes
    if (!WS && row + warps < p.T) stage(p, X, row + warps, lane);

    if constexpr (DENSE) {
      // forward and backward chains, one step of each per pass
      for (int st = 1; st <= L; ++st) {
        const int kb = dc - 1 - st;
        const float* const u[2] = {
            2 * st >= dc - 1 ? Fs + st * q : Bs + (st - 1) * q,
            2 * kb >= dc - 1 ? Fs + kb * q : Bs + (kb - 1) * q};
        const float* const w[2] = {Fs + (st - 1) * q, Bs + kb * q};
        float o[2][PER];
        dense_merge_row<PER, 2>(u, w, nch, lo, hl, nonneg, o);
        if (p.round_bf16) round_out<PER, 2>(o);
        __syncwarp();  // in[st] or in[kb] may sit in a slot written here
        if (on) {
          store_chunk<PER>(Fs + st * q, lo, hl, o[0]);
          store_chunk<PER>(Bs + (kb - 1) * q, lo, hl, o[1]);
        }
        __syncwarp();
      }
      // middle merges, two per pass: out[i] = F[i-1] (x) B[i+1] goes to
      // B[i+1]'s slot
      for (int i0 = 1; i0 <= L; i0 += 2) {
        if (i0 < L) {
          const float* const u[2] = {Fs + (i0 - 1) * q, Fs + i0 * q};
          const float* const w[2] = {Bs + i0 * q, Bs + (i0 + 1) * q};
          float o[2][PER];
          dense_merge_row<PER, 2>(u, w, nch, lo, hl, nonneg, o);
          if (p.round_bf16) round_out<PER, 2>(o);
          __syncwarp();
          if (on) {
            store_chunk<PER>(Bs + i0 * q, lo, hl, o[0]);
            store_chunk<PER>(Bs + (i0 + 1) * q, lo, hl, o[1]);
          }
        } else {
          const float* const u[1] = {Fs + (i0 - 1) * q};
          const float* const w[1] = {Bs + i0 * q};
          float o[1][PER];
          dense_merge_row<PER, 1>(u, w, nch, lo, hl, nonneg, o);
          if (p.round_bf16) round_out<PER, 1>(o);
          __syncwarp();
          if (on) store_chunk<PER>(Bs + i0 * q, lo, hl, o[0]);
        }
      }
      __syncwarp();
    } else {
      // forward and backward chains, one step of each per pass
      for (int st = 1; st <= L; ++st) {
        const int kb = dc - 1 - st;
        const float* const acc[2] = {Fs + (st - 1) * q, Bs + kb * q};
        const float2* const ls[2] = {Lst + (st - 1) * lst,
                                     Lst + (kb - 1) * lst};
        float o[2][PER];
        combine<PER, 2>(acc, ls, lst, s, o);
        if (p.round_bf16) round_out<PER, 2>(o);
        if (on) {
#pragma unroll
          for (int i = 0; i < PER; ++i) {
            Fs[st * q + s[i]] = o[0][i];
            Bs[(kb - 1) * q + s[i]] = o[1][i];
          }
        }
        __syncwarp();
      }

      // lists of B[2..dc-1]
      for (int k0 = 2; k0 <= dc - 1; k0 += NB) {
        const int nb = min(NB, dc - k0);
        unsigned key[NB][PER], kth[NB];
#pragma unroll
        for (int m = 0; m < NB; ++m) {
          if (m < nb) {
#pragma unroll
            for (int i = 0; i < PER; ++i)
              key[m][i] = on ? fkey(Bs[(k0 + m - 1) * q + s[i]]) : ~0u;
          }
        }
        list_bounds<PER>(key, nb, lst, q, kth);
#pragma unroll
        for (int m = 0; m < NB; ++m)
          if (m < nb)
            take_list<PER>(key[m], Bs + (k0 + m - 1) * q, s, on, kth[m], lst,
                           lane, Lst + (L + k0 + m - 2) * lst);
      }
      __syncwarp();

      // middle merges, two per pass: out[i] goes to B[i+1]'s slot, whose
      // list is taken
      for (int i0 = 1; i0 <= L; i0 += 2) {
        if (i0 < L) {
          const float* const acc[2] = {Fs + (i0 - 1) * q, Fs + i0 * q};
          const float2* const ls[2] = {Lst + (L + i0 - 1) * lst,
                                       Lst + (L + i0) * lst};
          float o[2][PER];
          combine<PER, 2>(acc, ls, lst, s, o);
          if (p.round_bf16) round_out<PER, 2>(o);
          if (on) {
#pragma unroll
            for (int i = 0; i < PER; ++i) {
              Bs[i0 * q + s[i]] = o[0][i];
              Bs[(i0 + 1) * q + s[i]] = o[1][i];
            }
          }
        } else {
          const float* const acc[1] = {Fs + (i0 - 1) * q};
          const float2* const ls[1] = {Lst + (L + i0 - 1) * lst};
          float o[1][PER];
          combine<PER, 1>(acc, ls, lst, s, o);
          if (p.round_bf16) round_out<PER, 1>(o);
          if (on) {
#pragma unroll
            for (int i = 0; i < PER; ++i) Bs[i0 * q + s[i]] = o[0][i];
          }
        }
      }
      __syncwarp();
    }

    // epilogue: rotate out, saturate, normalise, store; out[k] sits at
    // Bs[k] for k <= dc-2 and at F[max(dc-2, 0)] for k = dc-1
    float* y = p.out + row * n;
    const int last = L > 0 ? L : 0;
    for (int k0 = 0; k0 < dc; k0 += NB) {
      const int nb = min(NB, dc - k0);
      unsigned key[NB][PER], kth[NB];
#pragma unroll
      for (int m = 0; m < NB; ++m) {
        if (m < nb) {
          const int k = k0 + m;
          const float* src = k <= L ? Bs + k * q : Fs + last * q;
#pragma unroll
          for (int i = 0; i < PER; ++i) {
            const int c = rout ? __ldg(rout + k * q + s[i]) : s[i];
            key[m][i] = on ? fkey(src[c]) : ~0u;
          }
        }
      }
      if (p.truncate) kth_keys<PER>(key, nb, nm, kth);
#pragma unroll
      for (int m = 0; m < NB; ++m) {
        if (m < nb) {
          const int k = k0 + m;
          const float* src = k <= L ? Bs + k * q : Fs + last * q;
          float thr = __int_as_float(0x7f800000);
          if (p.truncate) thr = __fadd_rn(fval(kth[m]), p.offset);
          float mn = 0.0f;
          if (p.normalize) {
            unsigned kmin = ~0u;
#pragma unroll
            for (int i = 0; i < PER; ++i) kmin = min(kmin, key[m][i]);
            mn = fminf(fval(__reduce_min_sync(FULL, kmin)), thr);
          }
          if (on) {
#pragma unroll
            for (int i = 0; i < PER; ++i) {
              const int c = rout ? __ldg(rout + k * q + s[i]) : s[i];
              float r = src[c];
              if (p.truncate) r = fminf(r, thr);
              if (p.normalize) r = __fsub_rn(r, mn);
              y[k * q + s[i]] = r;
            }
          }
        }
      }
    }
    __syncwarp();
  }
}

// The grid of a call: warps a block, dynamic shared memory a block, and
// blocks.  Rows in shared memory where shared_rows (as many warps a block
// as fit, at most MAX_WARPS), else MAX_WARPS warps from the workspace, its
// blocks capped so that the workspace stays within WS_CAP (but one block a
// multiprocessor).
struct Grid {
  int warps, smem;
  long long blocks;
};

// Whether a call's rows run from shared memory: in the list mode where one
// warp's row fits a block; in the dense mode where MAX_WARPS warps' rows
// do.  A dense row is issue-bound: a block of one or two warps would leave
// a multiprocessor's schedulers idle, and the workspace form keeps
// MAX_WARPS warps a block at any dc.
bool shared_rows(const Params& p) {
  const long long warps = p.lst == p.q ? MAX_WARPS : 1;
  return p.warp_bytes * warps <= BLOCK_LIMIT;
}

template <int PER, bool WS, bool DENSE>
int plan(const Params& p, Grid& gr) {
  const auto kernel = ems_rows_kernel<PER, WS, DENSE>;
  const bool shared = !WS;
  gr.warps = shared ? max(1, min(MAX_WARPS, static_cast<int>(
                                                BLOCK_LIMIT / p.warp_bytes)))
                    : MAX_WARPS;
  gr.smem = shared ? gr.warps * p.warp_bytes : 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, gr.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    32 * gr.warps, gr.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long need = (p.T + gr.warps - 1) / gr.warps;
  const long long resident = static_cast<long long>(sms) * max(per_sm, 1);
  gr.blocks = need < resident ? need : resident;
  if (!shared) {
    long long cap = WS_CAP / (gr.warps * p.ws_warp_bytes);
    cap = cap > sms ? cap : sms;
    gr.blocks = gr.blocks < cap ? gr.blocks : cap;
  }
  return 0;
}

// The workspace a call needs, in bytes: one slot a warp of the grid where
// its rows do not run from shared memory, else 0.
template <int PER>
long long workspace_bytes(const Params& p) {
  if (shared_rows(p)) return 0;
  Grid gr;
  const int err = p.lst == p.q ? plan<PER, true, true>(p, gr)
                               : plan<PER, true, false>(p, gr);
  if (err) return -err;
  return gr.blocks * gr.warps * p.ws_warp_bytes;
}

template <int PER, bool DENSE>
int launch_mode(const Params& p, long long ws_bytes, cudaStream_t st) {
  Grid gr;
  if (shared_rows(p)) {
    const int err = plan<PER, false, DENSE>(p, gr);
    if (err) return err;
    ems_rows_kernel<PER, false, DENSE>
        <<<static_cast<unsigned>(gr.blocks), 32 * gr.warps, gr.smem, st>>>(p);
  } else {
    const int err = plan<PER, true, DENSE>(p, gr);
    if (err) return err;
    // no more warps than the workspace has slots
    const long long fit = ws_bytes / (gr.warps * p.ws_warp_bytes);
    if (!p.ws || fit < 1) return static_cast<int>(cudaErrorInvalidValue);
    gr.blocks = gr.blocks < fit ? gr.blocks : fit;
    ems_rows_kernel<PER, true, DENSE>
        <<<static_cast<unsigned>(gr.blocks), 32 * gr.warps, 0, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int PER>
int launch(const Params& p, long long ws_bytes, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  return p.lst == p.q ? launch_mode<PER, true>(p, ws_bytes, st)
                      : launch_mode<PER, false>(p, ws_bytes, st);
}

// The lists' bytes of one warp: 2(dc-2) lists of lst (value, id) pairs in
// the list mode, none in the dense mode (lst == q).
long long list_bytes(int dc, int q, int lst) {
  return lst < q ? 16LL * (dc > 2 ? dc - 2 : 0) * lst : 0;
}

// Shared memory of one warp: the staged row, F[0..dc-2] (F[0] at dc = 1),
// B[1..dc-1] and the lists.
long long smem_bytes(int dc, int q, int lst) {
  const long long b = 4LL * (dc + 2LL * (dc > 1 ? dc - 1 : 1)) * q +
                      list_bytes(dc, q, lst);
  return (b + 15) / 16 * 16;
}

// One warp's workspace slot: F, B and the lists (the row is read in place).
long long slot_bytes(int dc, int q, int lst) {
  const long long b = 8LL * (dc > 1 ? dc - 1 : 1) * q +
                      list_bytes(dc, q, lst);
  return (b + 15) / 16 * 16;
}

// The parameters of a call, or false for arguments out of range.
bool make_params(Params& p, const float* x, float* out, long long T, int dc,
                 int q, int nm, const uint8_t* rot_in, const uint8_t* rot_out,
                 const uint8_t* valid, long long G, int truncate,
                 int normalize, float offset, int lst, int round_bf16,
                 void* ws) {
  if (q < 2 || q > 256 || (q & (q - 1)) || dc < 1 || nm < 1 || nm > q ||
      (lst != nm && lst != q))
    return false;
  p.x = x;
  p.out = out;
  p.T = T;
  p.G = G > 0 ? G : 1;
  p.dc = dc;
  p.q = q;
  p.nm = nm;
  p.rot_in = rot_in;
  p.rot_out = rot_out;
  p.valid = valid;
  p.truncate = truncate && nm < q;
  p.normalize = normalize;
  p.vec16 = (dc * q) % 4 == 0 &&
            reinterpret_cast<uintptr_t>(x) % 16 == 0;
  p.offset = offset;
  p.lst = lst;
  p.round_bf16 = round_bf16;
  const long long wb = smem_bytes(dc, q, lst);
  p.warp_bytes = static_cast<int>(wb < BLOCK_LIMIT + 16 ? wb
                                                        : BLOCK_LIMIT + 16);
  p.ws = static_cast<unsigned char*>(ws);
  p.ws_warp_bytes = slot_bytes(dc, q, lst);
  return true;
}

}  // namespace

extern "C" {

// The device workspace, in bytes, that ems_rows_launch needs for these
// rows on the current device (0 where a row fits shared memory), or minus
// a CUDA error code.
long long ems_rows_workspace_bytes(long long T, int dc, int q, int nm,
                                   int lst) {
  Params p;
  if (!make_params(p, nullptr, nullptr, T, dc, q, nm, nullptr, nullptr,
                   nullptr, 1, 0, 0, 0.0f, lst, 0, nullptr))
    return -static_cast<long long>(cudaErrorInvalidValue);
  if (T <= 0) return 0;
  if (q <= 32) return workspace_bytes<1>(p);
  if (q == 64) return workspace_bytes<2>(p);
  if (q == 128) return workspace_bytes<4>(p);
  return workspace_bytes<8>(p);
}

// x, out: device pointers to [T, dc, q] contiguous float32.  rot_in,
// rot_out: [G, dc, q] uint8 or null (identity); valid: [G, dc] bytes (0 =
// padding slot) or null; row t uses table row t % G; lst: the lists'
// length, nm or q (the dense min-convolution); round_bf16: each merge's
// output rounded to bf16; ws: a device workspace of ws_bytes, at least
// ems_rows_workspace_bytes, where that is not 0 (else ignored).  Requires
// q a power of two <= 256, dc >= 1, 1 <= nm <= q and lst nm or q.
// Launches on `stream`, does not synchronise, returns a CUDA error code
// (0 = launched).
int ems_rows_launch(const float* x, float* out, long long T, int dc, int q,
                    int nm, const uint8_t* rot_in, const uint8_t* rot_out,
                    const uint8_t* valid, long long G, int truncate,
                    int normalize, float offset, int lst, int round_bf16,
                    void* ws, long long ws_bytes, void* stream) {
  Params p;
  if (!make_params(p, x, out, T, dc, q, nm, rot_in, rot_out, valid, G,
                   truncate, normalize, offset, lst, round_bf16, ws))
    return static_cast<int>(cudaErrorInvalidValue);
  if (T <= 0) return 0;
  if (q <= 32) return launch<1>(p, ws_bytes, stream);
  if (q == 64) return launch<2>(p, ws_bytes, stream);
  if (q == 128) return launch<4>(p, ws_bytes, stream);
  return launch<8>(p, ws_bytes, stream);
}

// The kernel's launches on the current device since the library was loaded
// or last reset, into *out (counted on the device, graph replays included).
// Synchronises the device.
int ems_rows_launches(unsigned long long* out) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(out, g_launches, sizeof(g_launches));
  return static_cast<int>(e);
}

// Set the count of ems_rows_launches to 0.  Synchronises the device.
int ems_rows_reset_launches() {
  const unsigned long long zero = 0;
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(g_launches, &zero, sizeof(zero));
  return static_cast<int>(e);
}

}  // extern "C"
