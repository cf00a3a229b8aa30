// The syndrome-EMS check node, one warp per row, and the whole layered
// syndrome super-layer step around it in one launch.
//
// Replaces the XLA sorts of ems_nbldpc_tpu/ops/syndrome_cn.py
// (syndrome_checknode, :240), with the top-k selection and the rotations
// around its call sites (decoder/layered.py:138-150, 170-172, 196-203 and
// decoder/flooding.py:118-130, 163-170).  Three entry points share one
// device-side row routine:
//
// * syndrome_layer_launch: one super-layer of the layered sweep, in place on
//   the decoder state APP [F, N+1, q] and CtoV [F, E+1, q] (f32):
//     for each frame f with active[f], each row r < G of the layer:
//       mvc_i = APP[f, cols[r,i]] - CtoV[f, edges[r,i]];  mvc_i -= min mvc_i
//       mcv   = CN(mvc) (below, with the tables of row r)
//       for each real slot i (valid[r,i]):
//         CtoV[f, edges[r,i]] = mcv_i;  APP[f, cols[r,i]] = mvc_i + mcv_i
//   Frozen frames are neither read nor written, and padded slots write
//   nothing, so the padding column N and edge E keep their zeros.
// * syndrome_layer_bf16_launch: the same step on a bf16 state: each load
//   widens to f32 (exact), the step computes in f32 exactly as above, and
//   each store rounds to bf16 (to nearest, ties to even, as torch's
//   .to(torch.bfloat16)), so it equals syndrome_layer_plain on that state
//   bit for bit too.
// * syndrome_rows_launch: CN on rows x [T, dc, q] -> out [T, dc, q], row t
//   with the tables of row t % G (the flooding schedule).
//
// CN of one row x [dc, q] (unrotated, min-normalised VN-to-CN messages),
// with the per-position tables rot_in, rot_out [G, dc, q] (uint8) and the
// optional valid [G, dc], the config table [C, dc] (uint8, entry k: the
// k-th best entry of that edge) and the saturation ranks kth [dc] (per
// presorted edge position) shared by all rows:
//   1. rotate in: vr[u] = x[rot_in[u]]; invalid slots become the delta
//      message (0 at symbol 0, INF elsewhere);
//   2. per edge, the nm smallest (value, GF id) pairs, ascending, lower id
//      first among equal values (ops/minconv.topk_message);
//   3. presort (optional): edges by their 2nd-best value, the first
//      min(4, dc) again by their 3rd-best, both stable;
//   4. per config c: llr = ((v_0 + v_1) + ...) + v_{dc-1}, f32 in presorted
//      slot order, and gf = the XOR of the chosen ids;
//   5. per presorted edge position t, over the configs with no deviation on
//      t ("masked"), with vbits = bf16 bits of min(llr, INF) and the bucket
//      b = gf ^ (t's best id):
//        sat   = the kth[t]-th smallest vbits, counted with multiplicity;
//        v1, v2 = the smallest vbits of each bucket (ties: the lowest
//                config) and the smallest of the bucket's other configs;
//        comb  = bayes(v1, v2) (v1 * a factor of v2 - v1) or v1, rounded
//                to bf16 again (cbits);
//        the buckets ranked by (cbits << 8) | b keep their value when among
//        the first keep = min(C, kth[t] + 1, q), INF otherwise;
//        out   = value > sat ? sat + offset : value;
//      written to t's original edge;
//   6. rotate out: y[c] = out[rot_out[c]], and subtract the message minimum.
// Every step is integer or bf16-key logic but for the config sums, the bayes
// multiply and sat + offset, each one f32 operation in the plain version's
// order, so the result equals ops/cuda_syndrome.syndrome_rows_plain and
// syndrome_layer_plain (the JAX version's sort-based form) bit for bit.
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s f32).  The layered call
// [F = 128, 1350 rows, dc = 4, q = 256] must read the APP and CtoV rows once
// and write both once, 2.83 GB: 0.846 ms.  Its operations are a few
// thousand integer and shared-memory steps a row (C = 993 configs summed
// over dc edges, ~489 masked configs a position passed twice, four list
// selections of ~25 counting steps over 8 keys a lane), about 2 G in all:
// memory bounds the work, instruction issue bounds this design.  The JAX
// form sorts [rows, C] int32 keys three times per edge; the design before
// this one (one 256-thread block per row, 8-bit radix selections through
// contended shared histograms, 25-60 block barriers a row) took 9.09 ms for
// the CN alone, with the sweep's torch passes around it besides.
//
// What this design does about it.
// * One warp per row, no block barrier: every step is warp-synchronous
//   (shuffles, ballots, __reduce_*_sync, __syncwarp).  A warp's shared
//   memory is 12,192 bytes at the default configuration (the staged row
//   4 KB, the config syndromes 4 KB, lists and scratch 2 KB, buckets
//   2 KB), so 18 rows are in flight on an SM; a persistent grid walks the
//   active rows.
// * The per-position lists of masked configs are built once on the host
//   (uint16, ops/cuda_syndrome.position_lists), which also checks every
//   deviation against nm and every kth[t] against its position's count, so
//   the kernel walks ~489 configs a position, not 993, and needs no trap.
// * Selections by halving an interval over keys held in registers (a
//   position's masked configs 16 a lane, more spill to a shared array; a
//   list's 8 symbols a lane; the buckets' rank keys 8 a lane), one
//   compare and one predicated add a key and one __reduce_add_sync a
//   step, not shared histograms.  The interval comes from each lane's two
//   smallest keys (rank_bounds): at most 32 keys lie below the smallest
//   second-smallest, at least 32 (64) at or below the largest smallest
//   (second-smallest), which narrows the saturation search from 16 bits
//   to ~8 and the `keep` search to a few more.
// * Bucket minima by a 32-bit shared atomicMin of (vbits << 16) | c over
//   the q buckets of the warp (scattered keys: little contention), the
//   loads of a position's configs all issued before their first use.
// * The row is staged once (all edges' loads issued before the VN
//   extrinsic's normalisation) and rotated on read; each position's output
//   is rotated (its table loaded when the position starts), normalised and
//   written back as soon as it is known, with streaming stores (the state
//   is read again only a super-layer later).
// Where it stands (chip_smoke.py 3c and chip_variants.py --syndrome, NVIDIA
// H100 80GB HBM3, 700 W): 5.08 ms per layered call at F = 128, 16.6% of
// the bound (the torch passes around the bare entry: 12.5 ms), 4.87 ms for
// the bare entry at T = 172,800.  The four positions take ~60% of it, the
// lists ~25%.
// On a bf16 state (3c, the same card): 4.98 ms against 5.07 on the f32
// state in the same turns.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NONE = 0xffffffffu;
constexpr float INF_COST = 1e9f;        // ops/minconv.INF
constexpr int REG_CFG = 16;             // masked configs a lane holds
constexpr int kSmemLimit = 232448;      // shared memory a block may use
constexpr int kMaxWarps = 16;           // warps per block to try

// Launches on this device, [0] of syndrome_rows_launch and [1] of
// syndrome_layer_launch, counted by the kernel itself, so that the
// launches a CUDA graph replays count too (syndrome_launches).
__device__ unsigned long long g_launches[2] = {0, 0};

typedef __nv_bfloat16 bf16_t;

struct Params {
  void* app;                   // layer: state [F, N+1, q] (float or bf16)
  void* ctov;                  // layer: state [F, E+1, q] (the same)
  long long app_frame;         // elements per frame of app, ctov
  long long ctov_frame;
  const uint8_t* active;       // layer: [F] (0 = frozen)
  const int* cols;             // layer: [G, dc] columns of APP
  const int* edges;            // layer: [G, dc] edges of CtoV
  const float* x;              // rows: [T, dc, q] input rows
  float* out;                  // rows: [T, dc, q] output rows
  long long T;                 // rows (layer: F * G)
  int G, dc, q, nm, C;
  const uint8_t* rot_in;       // [G, dc, q]
  const uint8_t* rot_out;
  const uint8_t* valid;        // [G, dc] (0 = padding slot) or null
  const uint8_t* table;        // [C, dc] deviations, each < nm
  const int* kth;              // [dc], kth[t] < count of position t
  const int* pos_off;          // [dc + 1] offsets into pos_cfg
  const uint16_t* pos_cfg;     // per position, its masked configs
  int max_masked;              // the largest count of a position
  int bayes, presort;
  float offset;
};

__host__ __device__ constexpr long long align16(long long b) {
  return (b + 15) / 16 * 16;
}

// Shared memory of one warp, carved in this order (ops/cuda_syndrome.py
// smem_bytes mirrors it): the staged row S [dc, q] f32; the lists LA
// [dc, nm] (value bits, id); the scratch U (at least 256 bytes): the
// lists' candidates [dc, nm] (8-byte keys), then the presorted lists, then
// per position the gathered saturation keys and the output [q];
// the config syndromes W [C] ((vbits << 16) | gf); the buckets B1, B2 [q];
// the edge order [dc]; the masked keys past the registers' 32 * REG_CFG.
struct Layout {
  long long S, LA, U, W, B1, B2, ORD, VB, total;
};

__host__ __device__ Layout layout(int dc, int q, int nm, int C,
                                  int max_masked) {
  Layout l;
  long long o = 0;
  const long long lists = 8LL * dc * nm;
  const long long spill = max_masked - 32LL * REG_CFG;
  l.S = o;   o += align16(4LL * dc * q);
  l.LA = o;  o += align16(lists);
  const long long scratch = lists > 4LL * q ? lists : 4LL * q;
  l.U = o;   o += align16(scratch > 256 ? scratch : 256);
  l.W = o;   o += align16(4LL * C);
  l.B1 = o;  o += align16(4LL * q);
  l.B2 = o;  o += align16(4LL * q);
  l.ORD = o; o += align16(4LL * dc);
  l.VB = o;  o += align16(spill > 0 ? 2 * spill : 0);
  l.total = o;
  return l;
}

// Order-preserving unsigned key of a float (-0 maps to +0's key).
__device__ __forceinline__ unsigned fkey(float f) {
  const unsigned b = __float_as_uint(f == 0.0f ? 0.0f : f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The float of a key (+0 for the key of -0).
__device__ __forceinline__ unsigned fkey_bits(unsigned k) {
  return (k & 0x80000000u) ? (k & 0x7fffffffu) : ~k;
}

// bf16 bits of a finite float, rounded to nearest even (c10::BFloat16's
// and XLA's rounding).
__device__ __forceinline__ unsigned bf16_bits(float f) {
  const unsigned u = __float_as_uint(f);
  return ((u + 0x7fffu + ((u >> 16) & 1u)) >> 16) & 0xffffu;
}

__device__ __forceinline__ float bf16_value(unsigned bits) {
  return __uint_as_float(bits << 16);
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// A state element as f32 (a bf16 widens exactly), and an f32 stored to the
// state with a streaming store (a bf16 state rounds it to nearest even).
__device__ __forceinline__ float ld_state(const float* p) { return *p; }

__device__ __forceinline__ float ld_state(const bf16_t* p) {
  return __uint_as_float(
      static_cast<unsigned>(*reinterpret_cast<const unsigned short*>(p))
      << 16);
}

__device__ __forceinline__ void st_state(float* p, float v) { __stcs(p, v); }

__device__ __forceinline__ void st_state(bf16_t* p, float v) {
  __stcs(reinterpret_cast<unsigned short*>(p),
         __bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

// The symbol lane `lane` holds in register i (q < 32: every lane holds
// one, lanes >= q duplicates).
template <int PER>
__device__ __forceinline__ int sym(int lane, int i, int q) {
  return PER == 1 ? (lane & (q - 1)) : lane + 32 * i;
}

// c + (key < t): one compare and one predicated add.
__device__ __forceinline__ unsigned count_lt(unsigned c, unsigned key,
                                             unsigned t) {
  asm("{\n\t.reg .pred p;\n\tsetp.lt.u32 p, %1, %2;\n\t"
      "@p add.u32 %0, %0, 1;\n\t}"
      : "+r"(c) : "r"(key), "r"(t));
  return c;
}

// The largest x in [a, b] whose warp-wide count(x) is at most k, given
// count(a) <= k, by halving the interval (not a bit at a time, so that a
// narrow interval takes few steps wherever it lies).
template <class Count>
__device__ __forceinline__ unsigned warp_search(unsigned a, unsigned b,
                                                unsigned k, Count count) {
#pragma unroll 1
  while (a < b) {
    const unsigned mid = a + (b - a + 1) / 2;
    if (__reduce_add_sync(FULL, count(mid)) <= k)
      a = mid;
    else
      b = mid - 1;
  }
  return a;
}

// Per lane, the smallest and second smallest of its keys (absent keys are
// ~0u), folded in one at a time.
__device__ __forceinline__ void two_smallest(unsigned v, unsigned& m1,
                                             unsigned& m2) {
  m2 = min(m2, max(m1, v));
  m1 = min(m1, v);
}

// The interval [a, b] that holds the k-th smallest key (0-based, with
// multiplicity) of the warp, from each lane's two smallest keys (m1 <= m2)
// and the warp's largest key hi: below the smallest m2 lie at most 32 keys
// (a lane's m1 only), and at or below the largest m1 (m2) at least 32 (64).
__device__ __forceinline__ void rank_bounds(unsigned m1, unsigned m2,
                                            unsigned hi, unsigned k,
                                            unsigned& a, unsigned& b) {
  a = k >= 32 ? __reduce_min_sync(FULL, m2) : __reduce_min_sync(FULL, m1);
  b = k < 32 ? __reduce_max_sync(FULL, m1)
      : k < 64 ? __reduce_max_sync(FULL, m2) : hi;
  b = min(b, hi);
}

// The first row at or after t (stride nw) of an active frame.
template <bool LAYER>
__device__ __forceinline__ long long next_active(const Params& p,
                                                 long long t, int nw) {
  if (LAYER)
    while (t < p.T && !__ldg(p.active + t / p.G)) t += nw;
  return t;
}

// The nm smallest (key, id) of one edge whose keys a lane holds in key[]
// (~0u: none) with ids id[], in the order key[0] of every lane, key[1] of
// every lane, ... which is the ids' order; into cand [nm] as
// (key << 8) | id, unordered: halving an interval finds the nm-th smallest
// key, a ballot takes the keys below it and the ties in id order.
template <int N>
__device__ __forceinline__ void take_list(const unsigned (&key)[N],
                                          const unsigned (&id)[N], int nm,
                                          int lane,
                                          unsigned long long* cand) {
  unsigned m1 = ~0u, m2 = ~0u, hi = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    two_smallest(key[i], m1, m2);
    if (key[i] != ~0u) hi = max(hi, key[i]);
  }
  unsigned lo, top;
  const unsigned k = static_cast<unsigned>(nm - 1);
  rank_bounds(m1, m2, __reduce_max_sync(FULL, hi), k, lo, top);
  auto count = [&](unsigned t) {
    unsigned c = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) c = count_lt(c, key[i], t);
    return c;
  };
  if (k < 32) {
    // below the smallest m2 lie at most 32 keys: often no more than k
    const unsigned a2 = __reduce_min_sync(FULL, m2);
    if (a2 > lo && a2 <= top && __reduce_add_sync(FULL, count(a2)) <= k)
      lo = a2;
  }
  const unsigned r = warp_search(lo, top, k, count);
  const unsigned below = (1u << lane) - 1u;
  unsigned bl[N], be[N];
  int nless = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    bl[i] = __ballot_sync(FULL, key[i] < r);
    be[i] = __ballot_sync(FULL, key[i] == r);
    nless += __popc(bl[i]);
  }
  const int need = nm - nless;
  int bless = 0, beq = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    int slot = -1;
    if (bl[i] >> lane & 1u) {
      slot = bless + __popc(bl[i] & below);
    } else if (be[i] >> lane & 1u) {
      const int eq = beq + __popc(be[i] & below);
      if (eq < need) slot = nless + eq;
    }
    if (slot >= 0)
      cand[slot] = static_cast<unsigned long long>(key[i]) << 8 | id[i];
    bless += __popc(bl[i]);
    beq += __popc(be[i]);
  }
}

// 1-2: the nm best (value, id) of each rotated edge of the staged row S,
// ascending, lower id first among equal values, into LA [dc, nm]; U is
// scratch.  A rank count orders the nm taken.
template <int PER>
__device__ __forceinline__ void build_lists(const Params& p, const float* S,
                                            long long g, int lane,
                                            unsigned long long* U,
                                            uint2* LA) {
  const int dc = p.dc, q = p.q, nm = p.nm;
  const bool on = lane < q;
  for (int k = 0; k < dc; ++k) {
    const bool ok = !p.valid || __ldg(p.valid + g * dc + k);
    const uint8_t* rin = p.rot_in + (g * dc + k) * q;
    unsigned key[PER], id[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int s = sym<PER>(lane, i, q);
      const float sv = S[k * q + __ldg(rin + s)];
      const float v = ok ? sv : (s == 0 ? 0.0f : INF_COST);
      key[i] = on ? fkey(v) : ~0u;
      id[i] = static_cast<unsigned>(s);
    }
    take_list<PER>(key, id, nm, lane, U + static_cast<long long>(k) * nm);
  }
  __syncwarp();
  // order each edge's nm candidates by (key, id): a rank is a slot; a lane
  // ranks entries of all edges, four counts side by side
  for (int j0 = lane; j0 < dc * nm; j0 += 128) {
    unsigned long long cj[4];
    const unsigned long long* cand[4];
    int rank[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = min(j0 + 32 * u, dc * nm - 1);
      cand[u] = U + j / nm * nm;
      cj[u] = U[j];
      rank[u] = 0;
    }
#pragma unroll 4
    for (int i = 0; i < nm; ++i) {
#pragma unroll
      for (int u = 0; u < 4; ++u) rank[u] += cand[u][i] < cj[u];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + 32 * u;
      if (j < dc * nm)
        LA[j / nm * nm + rank[u]] =
            make_uint2(fkey_bits(static_cast<unsigned>(cj[u] >> 8)),
                       static_cast<unsigned>(cj[u] & 0xffu));
    }
  }
  __syncwarp();
}

// 3: the edge order into ord [dc] (stable ranks; lane k owns edge k).
__device__ __forceinline__ void presort_edges(const Params& p, const uint2* LA,
                                              int* ord, int lane) {
  const int dc = p.dc, nm = p.nm;
  if (!p.presort) {
    if (lane < dc) ord[lane] = lane;
    __syncwarp();
    return;
  }
  const float v1 = lane < dc ? __uint_as_float(LA[lane * nm + 1].x) : 0.0f;
  int rank = 0;
  for (int j = 0; j < dc; ++j) {
    const float vj = __shfl_sync(FULL, v1, j);
    rank += vj < v1 || (vj == v1 && j < lane);
  }
  if (lane < dc) ord[rank] = lane;
  __syncwarp();
  const int border = min(4, dc);
  const int e = lane < border ? ord[lane] : 0;
  const float v2 = lane < border ? __uint_as_float(LA[e * nm + 2].x) : 0.0f;
  rank = 0;
  for (int j = 0; j < border; ++j) {
    const float vj = __shfl_sync(FULL, v2, j);
    rank += vj < v2 || (vj == v2 && j < lane);
  }
  __syncwarp();
  if (lane < border) ord[rank] = e;
  __syncwarp();
}

// 4: the presorted lists into Lp, then each config's (vbits << 16) | gf
// into W.
__device__ __forceinline__ void config_syndromes(const Params& p,
                                                 const uint2* LA,
                                                 const int* ord, uint2* Lp,
                                                 unsigned* W, int lane) {
  const int dc = p.dc, nm = p.nm;
  for (int i = lane; i < dc * nm; i += 32) {
    const int j = i / nm;
    Lp[i] = LA[ord[j] * nm + (i - j * nm)];
  }
  __syncwarp();
  if (dc == 4 && (reinterpret_cast<uintptr_t>(p.table) & 3) == 0) {
    // one table word a config, four configs side by side
    const unsigned* tw = reinterpret_cast<const unsigned*>(p.table);
    for (int c0 = lane; c0 < p.C; c0 += 128) {
      unsigned w[4], x[4];
      float s[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        w[u] = __ldg(tw + min(c0 + 32 * u, p.C - 1));
        s[u] = 0.0f;
        x[u] = 0;
      }
#pragma unroll
      for (int h = 0; h < 4; ++h) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const uint2 v = Lp[h * nm + (w[u] >> (8 * h) & 0xffu)];
          s[u] = __fadd_rn(s[u], __uint_as_float(v.x));
          x[u] ^= v.y;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c0 + 32 * u < p.C)
          W[c0 + 32 * u] = bf16_bits(fminf(s[u], INF_COST)) << 16 | x[u];
    }
  } else {
    for (int c = lane; c < p.C; c += 32) {
      const uint8_t* row = p.table + static_cast<long long>(c) * dc;
      float s = 0.0f;
      unsigned x = 0;
      for (int j = 0; j < dc; ++j) {
        const uint2 v = Lp[j * nm + __ldg(row + j)];
        s = __fadd_rn(s, __uint_as_float(v.x));
        x ^= v.y;
      }
      W[c] = bf16_bits(fminf(s, INF_COST)) << 16 | x;
    }
  }
  __syncwarp();
}

// The bayes factor of a bucket's two best values, as bayes_combine.
__device__ __forceinline__ float bayes(float v1, float v2) {
  const float dif = __fsub_rn(v2, v1);
  const float f = dif < 0.1f ? 0.5f
                  : dif < 0.2f ? 0.75f
                  : dif < 1.0f ? 0.825f
                  : dif < 2.0f ? 0.9375f
                               : 1.0f;
  const bool finite = (__float_as_uint(v2) & 0x7f800000u) != 0x7f800000u;
  return finite && v2 < 5e8f ? __fmul_rn(v1, f) : v1;
}

// 5-6 for presorted position t: the output of edge et = ord[t], rotated
// out and normalised, written to out (rows) or to CtoV and APP (layer, of
// element type ST).
template <int PER, bool LAYER, class ST>
__device__ __forceinline__ void position(const Params& p, const float* S,
                                         const uint2* LA, const unsigned* W,
                                         unsigned* B1, unsigned* B2,
                                         float* O, uint16_t* VB, int et,
                                         int t, long long row, long long g,
                                         int lane) {
  const int q = p.q, C = p.C;
  const bool on = lane < q;
  const unsigned g0 = LA[et * p.nm].y;
  const unsigned k = static_cast<unsigned>(__ldg(p.kth + t));
  const unsigned keep = min(static_cast<unsigned>(C),
                            min(k + 1, static_cast<unsigned>(q)));
  const int beg = __ldg(p.pos_off + t);
  const int cnt = __ldg(p.pos_off + t + 1) - beg;
  const uint16_t* ml = p.pos_cfg + beg;
  // the rotate-out table of the edge, loaded now, used last
  const uint8_t* rout = p.rot_out + (g * p.dc + et) * q;
  unsigned ro[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) ro[i] = __ldg(rout + sym<PER>(lane, i, q));
  for (int b = lane; b < q; b += 32) B1[b] = B2[b] = NONE;
  __syncwarp();

  // the masked configs' keys (vbits << 16) | c and buckets stay in
  // registers, the vbits of those past 32 * REG_CFG go to VB.  The loads
  // are made for every slot (clamped ids), so that they all issue before
  // the first is used
  unsigned kc[REG_CFG], bb[REG_CFG];
#pragma unroll
  for (int j = 0; j < REG_CFG; ++j)
    kc[j] = __ldg(ml + min(lane + 32 * j, cnt - 1));
#pragma unroll
  for (int j = 0; j < REG_CFG; ++j) {
    const unsigned w = W[kc[j]];
    const bool in = lane + 32 * j < cnt;
    bb[j] = (w & 0xffu) ^ g0;
    kc[j] = in ? (w & 0xffff0000u) | kc[j] : NONE;
  }
  for (int i = lane + 32 * REG_CFG; i < cnt; i += 32)
    VB[i - 32 * REG_CFG] = static_cast<uint16_t>(W[__ldg(ml + i)] >> 16);
  __syncwarp();

  // sat: the k-th smallest vbits (with multiplicity), by halving the
  // interval the lanes' two smallest bound (rank_bounds).  Keys:
  // (vbits << 16) | c, and vbits < tt when the key is below tt << 16
  unsigned m1 = 0xffffu, m2 = 0xffffu, hi = 0;
#pragma unroll
  for (int j = 0; j < REG_CFG; ++j) {
    two_smallest(kc[j] >> 16, m1, m2);
    if (kc[j] != NONE) hi = max(hi, kc[j] >> 16);
  }
  for (int i = lane + 32 * REG_CFG; i < cnt; i += 32) {
    const unsigned v = VB[i - 32 * REG_CFG];
    two_smallest(v, m1, m2);
    hi = max(hi, v);
  }
  unsigned lo, top;
  rank_bounds(m1, m2, __reduce_max_sync(FULL, hi), k, lo, top);
  const unsigned sb = warp_search(lo, top, k, [&](unsigned tt) {
    const unsigned key = tt << 16;
    unsigned c = 0;
#pragma unroll
    for (int j = 0; j < REG_CFG; ++j) c = count_lt(c, kc[j], key);
    for (int i = lane + 32 * REG_CFG; i < cnt; i += 32)
      c = count_lt(c, VB[i - 32 * REG_CFG], tt);
    return c;
  });
  const float sat = bf16_value(sb);

  // bucket minima
#pragma unroll
  for (int j = 0; j < REG_CFG; ++j)
    if (kc[j] != NONE) atomicMin(&B1[bb[j]], kc[j]);
  for (int i = lane + 32 * REG_CFG; i < cnt; i += 32) {
    const unsigned c = __ldg(ml + i);
    const unsigned w = W[c];
    atomicMin(&B1[(w & 0xffu) ^ g0], (w & 0xffff0000u) | c);
  }
  __syncwarp();

  // the buckets' second smallest: the smallest vbits of their other configs
  if (p.bayes) {
    unsigned m[REG_CFG];
#pragma unroll
    for (int j = 0; j < REG_CFG; ++j) m[j] = B1[bb[j]];
#pragma unroll
    for (int j = 0; j < REG_CFG; ++j)
      if (kc[j] != NONE && (m[j] & 0xffffu) != (kc[j] & 0xffffu))
        atomicMin(&B2[bb[j]], kc[j] >> 16);
    for (int i = lane + 32 * REG_CFG; i < cnt; i += 32) {
      const unsigned c = __ldg(ml + i);
      const unsigned w = W[c];
      const unsigned b = (w & 0xffu) ^ g0;
      if ((B1[b] & 0xffffu) != c)
        atomicMin(&B2[b], w >> 16);
    }
  }
  __syncwarp();

  // each bucket's combined value; rank keys of those at or below sat
  unsigned key2[PER];
  float kv[PER];
  unsigned nle = 0, k1 = NONE, k2 = NONE, khi = 0;
  unsigned b1[PER], b2[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    b1[i] = B1[sym<PER>(lane, i, q)];
    b2[i] = B2[sym<PER>(lane, i, q)];
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int b = sym<PER>(lane, i, q);
    key2[i] = NONE;
    kv[i] = INF_COST;
    if (on && b1[i] != NONE) {
      const float v1 = bf16_value(b1[i] >> 16);
      float comb = v1;
      if (p.bayes)
        comb = bayes(v1, b2[i] != NONE ? bf16_value(b2[i]) : INF_COST);
      const unsigned cb = bf16_bits(fminf(comb, INF_COST));
      kv[i] = bf16_value(cb);
      if (!(kv[i] > sat)) {
        key2[i] = cb << 8 | static_cast<unsigned>(b);
        ++nle;
        two_smallest(key2[i], k1, k2);
        khi = max(khi, key2[i]);
      }
    }
  }
  nle = __reduce_add_sync(FULL, nle);
  // buckets at or below sat rank before all others: when more of them than
  // `keep`, only the `keep` smallest keys stay (thr = the largest kept)
  unsigned thr = NONE;
  if (nle > keep) {
    unsigned lo, top;
    rank_bounds(k1, k2, __reduce_max_sync(FULL, khi), keep - 1, lo, top);
    thr = warp_search(lo, top, keep - 1, [&](unsigned tt) {
      unsigned c = 0;
#pragma unroll
      for (int i = 0; i < PER; ++i) c = count_lt(c, key2[i], tt);
      return c;
    });
  }
  const float sat_off = __fadd_rn(sat, p.offset);
  if (on) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const float o = key2[i] != NONE && key2[i] <= thr ? kv[i] : INF_COST;
      O[sym<PER>(lane, i, q)] = o > sat ? sat_off : o;
    }
  }
  __syncwarp();

  // rotate out, normalise, store
  float y[PER];
  float mn = __int_as_float(0x7f800000);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    y[i] = O[ro[i]];
    if (on) mn = fminf(mn, y[i]);
  }
  mn = warp_min(mn);
  if (on) {
    if (LAYER) {
      const long long r = g;
      if (!p.valid || __ldg(p.valid + r * p.dc + et)) {
        const long long f = row / p.G;
        ST* crow = static_cast<ST*>(p.ctov) + f * p.ctov_frame +
                   static_cast<long long>(__ldg(p.edges + r * p.dc + et)) * q;
        ST* arow = static_cast<ST*>(p.app) + f * p.app_frame +
                   static_cast<long long>(__ldg(p.cols + r * p.dc + et)) * q;
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          const int c = sym<PER>(lane, i, q);
          const float m = __fsub_rn(y[i], mn);
          st_state(crow + c, m);
          st_state(arow + c, __fadd_rn(S[et * q + c], m));
        }
      }
    } else {
      float* o = p.out + (row * p.dc + et) * q;
#pragma unroll
      for (int i = 0; i < PER; ++i)
        o[sym<PER>(lane, i, q)] = __fsub_rn(y[i], mn);
    }
  }
  __syncwarp();
}

template <int PER, bool LAYER, class ST>
__global__ void syndrome_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(&g_launches[LAYER ? 1 : 0], 1ULL);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  const int dc = p.dc, q = p.q;
  const bool on = lane < q;
  const Layout L = layout(dc, q, p.nm, p.C, p.max_masked);
  unsigned char* base = smem_raw + L.total * warp;
  float* S = reinterpret_cast<float*>(base + L.S);
  uint2* LA = reinterpret_cast<uint2*>(base + L.LA);
  unsigned long long* U = reinterpret_cast<unsigned long long*>(base + L.U);
  unsigned* W = reinterpret_cast<unsigned*>(base + L.W);
  unsigned* B1 = reinterpret_cast<unsigned*>(base + L.B1);
  unsigned* B2 = reinterpret_cast<unsigned*>(base + L.B2);
  int* ord = reinterpret_cast<int*>(base + L.ORD);
  uint16_t* VB = reinterpret_cast<uint16_t*>(base + L.VB);

  const int nw = gridDim.x * wpb;
  for (long long row = next_active<LAYER>(p, blockIdx.x * wpb + warp, nw);
       row < p.T; row = next_active<LAYER>(p, row + nw, nw)) {
    const long long g = row % p.G;
    // stage the row: layer, mvc = APP - CtoV minus its min (real slots),
    // the loads of all edges first, then the normalisation; rows, x as it is
    if (LAYER) {
      const long long f = row / p.G;
#pragma unroll 4
      for (int k = 0; k < dc; ++k) {
        if (p.valid && !__ldg(p.valid + g * dc + k)) continue;
        const ST* arow =
            static_cast<const ST*>(p.app) + f * p.app_frame +
            static_cast<long long>(__ldg(p.cols + g * dc + k)) * q;
        const ST* crow =
            static_cast<const ST*>(p.ctov) + f * p.ctov_frame +
            static_cast<long long>(__ldg(p.edges + g * dc + k)) * q;
        if (on) {
#pragma unroll
          for (int i = 0; i < PER; ++i) {
            const int s = sym<PER>(lane, i, q);
            S[k * q + s] = __fsub_rn(ld_state(arow + s), ld_state(crow + s));
          }
        }
      }
      __syncwarp();
      for (int k = 0; k < dc; ++k) {
        if (p.valid && !__ldg(p.valid + g * dc + k)) continue;
        float v[PER];
        float mn = __int_as_float(0x7f800000);
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          v[i] = S[k * q + sym<PER>(lane, i, q)];
          if (on) mn = fminf(mn, v[i]);
        }
        mn = warp_min(mn);
        if (on) {
#pragma unroll
          for (int i = 0; i < PER; ++i)
            S[k * q + sym<PER>(lane, i, q)] = __fsub_rn(v[i], mn);
        }
      }
    } else if (on) {
      for (int k = 0; k < dc; ++k) {
        const float* src = p.x + (row * dc + k) * q;
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          const int s = sym<PER>(lane, i, q);
          S[k * q + s] = __ldg(src + s);
        }
      }
    }
    __syncwarp();
    build_lists<PER>(p, S, g, lane, U, LA);
    presort_edges(p, LA, ord, lane);
    config_syndromes(p, LA, ord, reinterpret_cast<uint2*>(U), W, lane);
    for (int t = 0; t < dc; ++t)
      position<PER, LAYER, ST>(p, S, LA, W, B1, B2,
                               reinterpret_cast<float*>(U), VB, ord[t], t,
                               row, g, lane);
  }
}

template <int PER, bool LAYER, class ST>
int launch(const Params& p, void* stream) {
  const long long warp_bytes =
      layout(p.dc, p.q, p.nm, p.C, p.max_masked).total;
  if (warp_bytes > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = syndrome_kernel<PER, LAYER, ST>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(kern,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  // the warps per block that let the most warps reside on an SM
  int wpb = 1, per_sm = 1, best = 0;
  for (int w = 1; w <= kMaxWarps; ++w) {
    const long long smem = w * warp_bytes;
    if (smem > kSmemLimit) break;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kern, 32 * w, static_cast<size_t>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    if (blocks * w > best) {
      best = blocks * w;
      wpb = w;
      per_sm = blocks;
    }
  }
  if (best == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long need = (p.T + wpb - 1) / wpb;
  const long long resident = static_cast<long long>(sms) * per_sm;
  const unsigned grid =
      static_cast<unsigned>(need < resident ? need : resident);
  kern<<<grid, 32 * wpb, static_cast<size_t>(wpb * warp_bytes),
         static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool LAYER, class ST = float>
int dispatch(const Params& p, void* stream) {
  if (p.T <= 0) return 0;
  if (p.q <= 32) return launch<1, LAYER, ST>(p, stream);
  if (p.q == 64) return launch<2, LAYER, ST>(p, stream);
  if (p.q == 128) return launch<4, LAYER, ST>(p, stream);
  return launch<8, LAYER, ST>(p, stream);
}

Params tables(int G, int dc, int q, int nm, const uint8_t* rot_in,
              const uint8_t* rot_out, const uint8_t* valid,
              const uint8_t* table, int C, const int* kth, const int* pos_off,
              const uint16_t* pos_cfg, int max_masked, int bayes,
              int presort, float offset) {
  Params p = {};
  p.G = G > 0 ? G : 1;
  p.dc = dc;
  p.q = q;
  p.nm = nm;
  p.C = C;
  p.rot_in = rot_in;
  p.rot_out = rot_out;
  p.valid = valid;
  p.table = table;
  p.kth = kth;
  p.pos_off = pos_off;
  p.pos_cfg = pos_cfg;
  p.max_masked = max_masked;
  p.bayes = bayes;
  p.presort = presort;
  p.offset = offset;
  return p;
}

// The layer entry's state and index tables.
void layer_state(Params& p, void* app, void* ctov, long long F,
                 long long app_rows, long long ctov_rows,
                 const uint8_t* active, const int* cols, const int* edges) {
  p.app = app;
  p.ctov = ctov;
  p.app_frame = app_rows * p.q;
  p.ctov_frame = ctov_rows * p.q;
  p.active = active;
  p.cols = cols;
  p.edges = edges;
  p.T = F * p.G;
}

}  // namespace

extern "C" {

// Shared memory of one warp (one row in flight), in bytes.
long long syndrome_smem_bytes(int dc, int q, int nm, int C, int max_masked) {
  return layout(dc, q, nm, C, max_masked).total;
}

// The CN on rows.  x, out: device pointers to [T, dc, q] contiguous
// float32.  rot_in, rot_out: [G, dc, q] uint8; valid: [G, dc] bytes (0 =
// padding slot) or null; row t uses table row t % G.  table: [C, dc] uint8
// deviations, each < nm; kth: [dc] int32 saturation ranks; pos_off [dc + 1]
// int32 and pos_cfg uint16: per position the configs with no deviation
// there, ascending (ops/cuda_syndrome.position_lists, which checks the
// deviations and that kth[t] is below position t's count), max_masked the
// largest count.  Requires q a power of two <= 256, 2 <= dc <= 32,
// 1 <= nm <= q (3 <= nm with presort), 1 <= C <= 65536 and one warp's
// syndrome_smem_bytes within the block limit.  Launches on `stream`, does
// not synchronise, returns a CUDA error code (0 = launched).
int syndrome_rows_launch(const float* x, float* out, long long T, int dc,
                         int q, int nm, const uint8_t* rot_in,
                         const uint8_t* rot_out, const uint8_t* valid,
                         int G, const uint8_t* table, int C, const int* kth,
                         const int* pos_off, const uint16_t* pos_cfg,
                         int max_masked, int bayes, int presort, float offset,
                         void* stream) {
  Params p = tables(G, dc, q, nm, rot_in, rot_out, valid, table, C, kth,
                    pos_off, pos_cfg, max_masked, bayes, presort, offset);
  p.x = x;
  p.out = out;
  p.T = T;
  return dispatch<false>(p, stream);
}

// One layered super-layer, in place.  app: [F, app_rows, q] and ctov:
// [F, ctov_rows, q] contiguous float32; active: [F] bytes (0 = frozen);
// cols, edges: [G, dc] int32 APP columns and CtoV edges of the layer's
// rows (distinct among the real slots); the other tables as for
// syndrome_rows_launch, row r of the layer using row r of rot_in, rot_out
// and valid.  Requires F * G < 2^62 besides.
int syndrome_layer_launch(float* app, float* ctov, long long F,
                          long long app_rows, long long ctov_rows,
                          const uint8_t* active, const int* cols,
                          const int* edges, int dc, int q, int nm,
                          const uint8_t* rot_in, const uint8_t* rot_out,
                          const uint8_t* valid, int G, const uint8_t* table,
                          int C, const int* kth, const int* pos_off,
                          const uint16_t* pos_cfg, int max_masked, int bayes,
                          int presort, float offset, void* stream) {
  Params p = tables(G, dc, q, nm, rot_in, rot_out, valid, table, C, kth,
                    pos_off, pos_cfg, max_masked, bayes, presort, offset);
  layer_state(p, app, ctov, F, app_rows, ctov_rows, active, cols, edges);
  return dispatch<true>(p, stream);
}

// The same on a bf16 state: app, ctov contiguous bfloat16 (each load
// widens to f32, each store rounds to nearest even).  Same requirements
// and return value.
int syndrome_layer_bf16_launch(void* app, void* ctov, long long F,
                               long long app_rows, long long ctov_rows,
                               const uint8_t* active, const int* cols,
                               const int* edges, int dc, int q, int nm,
                               const uint8_t* rot_in, const uint8_t* rot_out,
                               const uint8_t* valid, int G,
                               const uint8_t* table, int C, const int* kth,
                               const int* pos_off, const uint16_t* pos_cfg,
                               int max_masked, int bayes, int presort,
                               float offset, void* stream) {
  Params p = tables(G, dc, q, nm, rot_in, rot_out, valid, table, C, kth,
                    pos_off, pos_cfg, max_masked, bayes, presort, offset);
  layer_state(p, app, ctov, F, app_rows, ctov_rows, active, cols, edges);
  return dispatch<true, bf16_t>(p, stream);
}

// The kernel's launches on the current device since the library was loaded
// or last reset: out[0] by syndrome_rows_launch, out[1] by
// syndrome_layer_launch and syndrome_layer_bf16_launch (counted on the
// device, graph replays included).
// Synchronises the device.
int syndrome_launches(unsigned long long* out) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(out, g_launches, sizeof(g_launches));
  return static_cast<int>(e);
}

// Set both counts of syndrome_launches to 0.  Synchronises the device.
int syndrome_reset_launches() {
  const unsigned long long zero[2] = {0, 0};
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(g_launches, zero, sizeof(zero));
  return static_cast<int>(e);
}

}  // extern "C"
