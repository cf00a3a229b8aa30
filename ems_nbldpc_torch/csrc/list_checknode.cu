// The layered truncated-list EMS super-layer step (K3), one warp per row.
//
// Replaces the XLA ops of ems_nbldpc_tpu/ops/listcn.py on the list path:
// topk_list (:93, the packed-key sort from q down to nm), rotate_ids (:79,
// the XOR-fold GF rotation), list_combine (:145, its budgeted staircase
// branch :194-241: candidate sums, GF-major dedup sort, value-major best-nm
// sort), fb_checknode_list (:244, chain form), saturate_list (:359) and
// expand_list (:374, with minconv.scatter_topk_dense), and the gathers, VN
// extrinsic, freeze and scatters of the sweep body around them
// (ems_nbldpc_tpu/decoder/layered.py:567-611).  Its plain version, which
// it equals bit for bit, is ops/listcn.list_layer_plain.
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
// bits with a shared-memory atomicMin, and sorts the 256 keys
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
// below that at 67 TFLOP/s.  What is hard is that it is all selections:
// 10 top-nm selections of 256 keys a row (4 truncations, 6 merges), each a
// chain of warp exchanges, and a scatter-min into a dense message twice a
// slot.
//
// What this design does about it.
// * One warp owns one row at a time and walks the rows of a persistent
//   grid; no block barrier after the staircase's pair table is built.
// * A selection holds the 256 keys in registers, 8 a lane, and keeps the
//   32 (nm <= 32) or 64 smallest: a bitonic sort of runs of 32 in the form
//   whose comparators all ascend, then three rounds that keep the smaller
//   half of two runs (min of one against the other reversed) and merge it
//   (top_keys): no sort in device memory, no histogram, no bisection.
// * The dense messages (the CtoV expansion and the output expansion) and
//   the merges' per-GF minima go through one 256-entry table of the warp
//   in shared memory with atomicMin; mvc stays in shared memory between
//   the truncation and the write-back, so the state is read once and
//   written once.  A rotation XORs basis columns held in registers, one
//   list entry a lane.
// Where it stands (chip_smoke.py 3f and chip_variants.py --list, NVIDIA
// H100 80GB HBM3, 700 W): 3.25 ms a call on the bf16 state, 3.14 on the
// f32 one, against 103 ms for the plain version.  The selections take
// ~2.0 ms of it (1.26 ms without them), a full 256-key sort in their
// place took 4.56 ms, and rotations by a bit loop over the columns in
// device memory, one lane per 8 entries, 5.9 ms.
// A column or an edge out of range traps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

namespace {

typedef __nv_bfloat16 bf16_t;

constexpr unsigned FULL = 0xffffffffu;
constexpr float BIG = 1e9f;             // ops/listcn.BIG = ops/minconv.INF
constexpr float HALF_BIG = 5e8f;        // listcn.saturate_list's BIG / 2
constexpr unsigned DUP = 0x7fffffffu;   // listcn._DUP
constexpr unsigned ABSENT = 0xffffffffu;
constexpr int WARPS = 4;                // warps per block
constexpr int BLOCKS_SM = 8;            // blocks an SM the registers aim at
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_NM = 64;              // list length: two entries a lane
constexpr int TAB = 256;                // GF ids (8 bits)
constexpr long long BLOCK_LIMIT = 232448;  // dynamic shared memory a block
//                                            may use on Hopper

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
  float offset;
};

__host__ __device__ inline long long align16(long long b) {
  return (b + 15) / 16 * 16;
}

// Lists a row holds: the dc inputs (later the middle outputs), then the
// forward F[1..dc-2] and backward B[1..dc-2] partial merges.
__host__ __device__ inline int n_lists(int dc) {
  return dc <= 2 ? dc : 3 * dc - 4;
}

// Shared memory of one warp, carved in this order (ops/cuda_list.py
// warp_bytes mirrors it): mvc [dc, q] f32, the list values [lists, nm]
// f32 and ids (uint8), the warp's table [256] (u32).
struct Layout {
  long long lv, lg, tab, total;
};

__host__ __device__ inline Layout layout(int dc, int q, int nm) {
  const long long lists = n_lists(dc);
  Layout l;
  l.lv = align16(4LL * dc * q);
  l.lg = l.lv + align16(4LL * lists * nm);
  l.tab = l.lg + align16(lists * nm);
  l.total = l.tab + 4LL * TAB;
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

// A state element: load widened to f32, round to the state's dtype,
// store (rounded).
__device__ __forceinline__ float ld(const float* p) { return *p; }

__device__ __forceinline__ float ld(const bf16_t* p) {
  return from_bits(*reinterpret_cast<const unsigned short*>(p));
}

template <class ST>
__device__ __forceinline__ float rnd(float x) {
  return x;
}

template <>
__device__ __forceinline__ float rnd<bf16_t>(float x) {
  return from_bits(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
}

__device__ __forceinline__ void st(float* p, float v) { *p = v; }

__device__ __forceinline__ void st(bf16_t* p, float v) {
  *reinterpret_cast<unsigned short*>(p) =
      __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// The comparators of the selection below, all ascending: registers i < j
// of one lane, and register i against the partner lane's value o (the
// lane whose key comes later keeps the larger).
__device__ __forceinline__ void cx(unsigned& a, unsigned& b) {
  const unsigned lo = min(a, b), hi = max(a, b);
  a = lo;
  b = hi;
}

__device__ __forceinline__ unsigned cx_lane(unsigned a, unsigned o,
                                            bool upper) {
  return upper ? max(a, o) : min(a, o);
}

// Half-cleaners of strides run/2 .. 1 over runs of `run` keys (key e =
// 8 lane + i in register i): a bitonic run comes out ascending.  Inlined
// into unrolled loops, so `run` is a constant there.
__device__ __forceinline__ void merge_runs(unsigned (&k)[8], int lane,
                                           int run) {
#pragma unroll
  for (int stride = run >> 1; stride > 0; stride >>= 1) {
    if (stride >= 8) {
      const int d = stride >> 3;
      const bool upper = (lane & d) != 0;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        k[i] = cx_lane(k[i], __shfl_xor_sync(FULL, k[i], d), upper);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (!(i & stride)) cx(k[i], k[i | stride]);
    }
  }
}

// The warp's 256 keys (key e = 8 lane + i in register i) -> the RUN
// smallest, ascending, as keys 0..RUN-1 (lanes 0..RUN/8-1).  A bitonic
// sort of runs of RUN keys in the form whose comparators are all
// ascending (each merge opens by comparing key e with e ^ (size - 1)),
// then log2(256 / RUN) rounds that keep, of two ascending runs A and B,
// min(A[j], B[RUN-1-j]) (the RUN smallest of both, a bitonic run) and
// merge it.  Compared with a full sort of the 256 keys it drops the
// stages past RUN; the keys past RUN are left in no order.
template <int RUN>
__device__ __forceinline__ void top_keys(unsigned (&k)[8], int lane) {
#pragma unroll
  for (int size = 2; size <= RUN; size <<= 1) {
    if (size <= 8) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int j = i ^ (size - 1);
        if (j > i) cx(k[i], k[j]);
      }
    } else {
      const int m = (size - 1) >> 3;           // lanes of the mirror
      const bool upper = (lane & (size >> 4)) != 0;
      unsigned o[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i] = __shfl_xor_sync(FULL, k[7 - i], m);
#pragma unroll
      for (int i = 0; i < 8; ++i) k[i] = cx_lane(k[i], o[i], upper);
    }
    merge_runs(k, lane, size >> 1);
  }
#pragma unroll
  for (int off = RUN >> 3; off < 32; off <<= 1) {
    const int m = off | ((RUN >> 3) - 1);      // B's lanes, reversed
    unsigned o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = __shfl_xor_sync(FULL, k[7 - i], m);
#pragma unroll
    for (int i = 0; i < 8; ++i) k[i] = min(k[i], o[i]);
    merge_runs(k, lane, RUN);
  }
}

// The nm smallest of the warp's 256 keys, ascending, as keys 0..nm-1.
__device__ __forceinline__ void select_nm(unsigned (&k)[8], int nm,
                                          int lane) {
  if (nm <= 32)
    top_keys<32>(k, lane);
  else
    top_keys<64>(k, lane);
}

// A slot's GF(2)-basis columns (rc_in or rc_out), one a register; and
// listcn.rotate_ids of one id: the XOR of the columns of its bits.
__device__ __forceinline__ void load_cols(int (&c)[8], const int* col,
                                          int logq) {
#pragma unroll
  for (int b = 0; b < 8; ++b) c[b] = b < logq ? __ldg(col + b) : 0;
}

__device__ __forceinline__ int rotate(int g, const int (&c)[8]) {
  int out = 0;
#pragma unroll
  for (int b = 0; b < 8; ++b) out ^= (g >> b & 1) ? c[b] : 0;
  return out;
}

// One staircase merge (list_combine, nbOper > 0): out = the nm smallest
// distinct-GF sums of the lists a and b.
__device__ void merge(const float* av, const uint8_t* ag, const float* bv,
                      const uint8_t* bg, float* ov, uint8_t* og,
                      unsigned* tab, const uint16_t* pairs, int npairs,
                      int nm, int lane) {
#pragma unroll
  for (int i = 0; i < 8; ++i) tab[i * 32 + lane] = ABSENT;
  __syncwarp();
  for (int c = lane; c < npairs; c += 32) {
    const unsigned p = pairs[c];
    const int i = p >> 8, j = p & 0xff;
    atomicMin(tab + (ag[i] ^ bg[j]), bf16_bits(__fadd_rn(av[i], bv[j])));
  }
  __syncwarp();
  unsigned k[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int s = i * 32 + lane;
    const unsigned t = tab[s];
    k[i] = t == ABSENT ? DUP : (t << 8 | s);
  }
  select_nm(k, nm, lane);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int e = lane * 8 + i;
    if (e < nm) {
      const bool dup = k[i] == DUP;
      ov[e] = dup ? BIG : from_bits(k[i] >> 8);
      og[e] = static_cast<uint8_t>(dup ? e : k[i] & 0xff);
    }
  }
  __syncwarp();
}

template <class ST>
__global__ void __launch_bounds__(THREADS, BLOCKS_SM)
    list_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&g_launches, 1ULL);
  const int dc = p.dc, q = p.q, nm = p.nm, logq = p.logq;
  // the staircase's (i, j) pairs, once a block
  uint16_t* pairs = reinterpret_cast<uint16_t*>(smem_raw);
  for (int idx = threadIdx.x; idx < nm * nm; idx += blockDim.x) {
    const int i = idx / nm, j = idx % nm;
    if (j < row_width(i, nm, p.nboper)) {
      int off = 0;
      for (int u = 0; u < i; ++u) off += row_width(u, nm, p.nboper);
      pairs[off + j] = static_cast<uint16_t>(i << 8 | j);
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  const Layout lay = layout(dc, q, nm);
  unsigned char* base =
      smem_raw + align16(2LL * p.npairs) + lay.total * warp;
  float* mvc = reinterpret_cast<float*>(base);
  float* lv = reinterpret_cast<float*>(base + lay.lv);
  uint8_t* lg = base + lay.lg;
  unsigned* tab = reinterpret_cast<unsigned*>(base + lay.tab);
  // list L: values lv + L nm, ids lg + L nm; F[t] = dc + t - 1 (F[0] = 0),
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
    // 1. the slots' lists: gathers, VN extrinsic, truncation, rotation
    for (int k = 0; k < dc; ++k) {
      float* lvk = lv + k * nm;
      uint8_t* lgk = lg + k * nm;
      if (p.valid && !__ldg(p.valid + r * dc + k)) {
        for (int e = lane; e < nm; e += 32) {
          lvk[e] = e == 0 ? 0.0f : BIG;
          lgk[e] = static_cast<uint8_t>(e);
        }
        continue;
      }
      const int col = __ldg(rcols + k), edge = __ldg(redges + k);
      if (col < 0 || col >= p.app_rows || edge < 0 || edge >= p.cv_rows)
        __trap();
      const ST* ap = app + (f * p.app_rows + col) * q;
      const long long ce = f * p.cv_rows + edge;
      float a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (i * 32 + lane < q) a[i] = ld(ap + i * 32 + lane);
      const unsigned inf_key = fkey(BIG);
#pragma unroll
      for (int i = 0; i < 8; ++i) tab[i * 32 + lane] = inf_key;
      __syncwarp();
      for (int e = lane; e < nm; e += 32)
        atomicMin(tab + p.cv_g[ce * nm + e], fkey(ld(cv_v + ce * nm + e)));
      const float sat = ld(cv_sat + ce);
      __syncwarp();
      float mn = __int_as_float(0x7f800000);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int s = i * 32 + lane;
        if (s < q) {
          const float c = rnd<ST>(fminf(fval(tab[s]), sat));
          a[i] = rnd<ST>(__fsub_rn(a[i], c));
          mn = fminf(mn, a[i]);
        }
      }
      mn = warp_min(mn);
      unsigned key[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int s = i * 32 + lane;
        if (s < q) {
          a[i] = rnd<ST>(__fsub_rn(a[i], mn));
          mvc[k * q + s] = a[i];
          key[i] = bf16_bits(a[i]) << 8 | s;
        } else {
          key[i] = ABSENT;
        }
      }
      int rc[8];
      load_cols(rc, p.rc_in + (r * dc + k) * logq, logq);
      select_nm(key, nm, lane);
      // the nm smallest through the table (free now): one entry a lane
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (lane * 8 + i < nm) tab[lane * 8 + i] = key[i];
      __syncwarp();
      for (int e = lane; e < nm; e += 32) {
        const unsigned t = tab[e];
        lvk[e] = from_bits(t >> 8);
        lgk[e] = static_cast<uint8_t>(rotate(t & 0xff, rc));
      }
      __syncwarp();
    }
    // 2. the F/B chain (fb_checknode_list): dc = 1 the neutral list, dc = 2
    // the swap, else the forward and backward merges, then the middles
    // (out[k] into list k, which no later merge reads)
    if (dc == 1) {
      for (int e = lane; e < nm; e += 32) {
        lv[e] = e == 0 ? 0.0f : BIG;
        lg[e] = static_cast<uint8_t>(e);
      }
      __syncwarp();
    }
    const uint16_t* pr = pairs;
    for (int u = 1; dc >= 3 && u <= dc - 2; ++u) {
      const int a = fwd(u - 1), o = fwd(u);
      merge(lv + a * nm, lg + a * nm, lv + u * nm, lg + u * nm, lv + o * nm,
            lg + o * nm, tab, pr, p.npairs, nm, lane);
      const int v = dc - 1 - u, b = bwd(v + 1), ob = bwd(v);
      merge(lv + b * nm, lg + b * nm, lv + v * nm, lg + v * nm, lv + ob * nm,
            lg + ob * nm, tab, pr, p.npairs, nm, lane);
    }
    for (int u = 1; dc >= 3 && u <= dc - 2; ++u) {
      const int a = fwd(u - 1), b = bwd(u + 1);
      merge(lv + a * nm, lg + a * nm, lv + b * nm, lg + b * nm, lv + u * nm,
            lg + u * nm, tab, pr, p.npairs, nm, lane);
    }
    // 3. rotate out, saturate, write back the real slots
    for (int k = 0; k < dc; ++k) {
      if (p.valid && !__ldg(p.valid + r * dc + k)) continue;
      const int src = dc == 1 ? 0
                      : dc == 2 ? 1 - k
                      : k == 0 ? bwd(1)
                      : k == dc - 1 ? fwd(dc - 2) : k;
      const float* ov = lv + src * nm;
      const uint8_t* ogr = lg + src * nm;
      int rc[8];
      load_cols(rc, p.rc_out + (r * dc + k) * logq, logq);
      const float v0 = ov[0];
      float v[2];
      int g[2];
      float last = 0.0f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int e = lane + 32 * u;
        if (e < nm) {
          v[u] = __fsub_rn(ov[e], v0);
          g[u] = rotate(ogr[e], rc) & 0xff;
          if (v[u] < HALF_BIG) last = fmaxf(last, v[u]);
        }
      }
      const float sat = __fadd_rn(warp_max(last), p.offset);
      const int col = __ldg(rcols + k), edge = __ldg(redges + k);
      const long long ce = f * p.cv_rows + edge;
      const unsigned inf_key = fkey(BIG);
#pragma unroll
      for (int i = 0; i < 8; ++i) tab[i * 32 + lane] = inf_key;
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
      ST* ap = app + (f * p.app_rows + col) * q;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int s = i * 32 + lane;
        if (s < q) {
          const float d = rnd<ST>(fminf(fval(tab[s]), sat));
          st(ap + s, __fadd_rn(mvc[k * q + s], d));
        }
      }
      __syncwarp();
    }
  }
}

// Warps a block for a list CN the kernel takes (q a power of two <= 256,
// 1 <= nm <= min(q, 64), nboper >= 1, dc >= 1): WARPS, fewer where their
// shared memory and the staircase's pair table do not fit one block; 0
// where it does not take the shape or not even one warp fits.
// ops/cuda_list.py mirrors it (warps_per_block and limits_error), and
// chip_smoke.py holds the two against each other (list_block_warps).
int block_warps(int dc, int q, int nm, int nboper) {
  if (q < 2 || q > TAB || (q & (q - 1)) || nm < 1 || nm > q ||
      nm > MAX_NM || nboper < 1 || dc < 1)
    return 0;
  const long long wb = layout(dc, q, nm).total;
  const long long room =
      BLOCK_LIMIT - align16(2LL * staircase_pairs(nm, nboper));
  const long long w = room / wb;
  return static_cast<int>(w < WARPS ? (w < 0 ? 0 : w) : WARPS);
}

// A launch configuration, found once for each device, state type and
// shape (the attributes and the occupancy query do not run per launch).
struct Config {
  int dev, dc, q, nm, nboper;
  int wpb;              // warps a block
  long long smem;       // dynamic shared memory a block
  long long resident;   // blocks resident on the device
};

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
  Config c = {dev, p.dc, p.q, p.nm, p.nboper, 0, 0, 0};
  c.wpb = block_warps(p.dc, p.q, p.nm, p.nboper);
  c.smem = align16(2LL * p.npairs) + c.wpb * layout(p.dc, p.q, p.nm).total;
  auto kern = list_kernel<ST>;
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
int launch(const Params& p, void* stream) {
  if (p.T <= 0) return 0;
  Config c;
  const int err = launch_config<ST>(p, c);
  if (err) return err;
  const long long need = (p.T + c.wpb - 1) / c.wpb;
  list_kernel<ST><<<static_cast<unsigned>(need < c.resident ? need
                                                            : c.resident),
                    32 * c.wpb, static_cast<size_t>(c.smem),
                    static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The entries' checks and parameters; 0, or a CUDA error code.
int layer_params(Params& p, void* app, void* cv_v, uint8_t* cv_g,
                 void* cv_sat, long long F, long long app_rows,
                 long long cv_rows, const uint8_t* active, const int* cols,
                 const int* edges, const int* rc_in, const int* rc_out,
                 const uint8_t* valid, long long G, int dc, int q, int nm,
                 int nboper, float offset) {
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
  p.npairs = staircase_pairs(nm, nboper);
  p.offset = offset;
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
// = padded slot) or null.  Requires q a power of two <= 256, 1 <= nm <=
// min(q, 64), nboper >= 1, dc >= 1 and one warp's shared memory within a
// block's.  Launches on `stream`, does not synchronise, returns a CUDA
// error code (0 = launched; cudaErrorInvalidValue for arguments out of
// range).
int list_layer_launch(float* app, float* cv_v, uint8_t* cv_g, float* cv_sat,
                      long long F, long long app_rows, long long cv_rows,
                      const uint8_t* active, const int* cols,
                      const int* edges, const int* rc_in, const int* rc_out,
                      const uint8_t* valid, long long G, int dc, int q,
                      int nm, int nboper, float offset, void* stream) {
  Params p = {};
  const int err = layer_params(p, app, cv_v, cv_g, cv_sat, F, app_rows,
                               cv_rows, active, cols, edges, rc_in, rc_out,
                               valid, G, dc, q, nm, nboper, offset);
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
                           int nm, int nboper, float offset, void* stream) {
  Params p = {};
  const int err = layer_params(p, app, cv_v, cv_g, cv_sat, F, app_rows,
                               cv_rows, active, cols, edges, rc_in, rc_out,
                               valid, G, dc, q, nm, nboper, offset);
  return err ? err : launch<bf16_t>(p, stream);
}

// Warps a block for this list CN, 0 where the kernel does not take it (the
// entries' limits; ops/cuda_list.warps_per_block and takes mirror it).
int list_block_warps(int dc, int q, int nm, int nboper) {
  return block_warps(dc, q, nm, nboper);
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
