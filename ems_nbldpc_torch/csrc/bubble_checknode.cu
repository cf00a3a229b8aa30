// The whole exact bubble check-node step of a batch of rows (K9).
//
// Replaces the XLA ops of ems_nbldpc_tpu/ops/bubble_cn.py (_elementary, a
// lax.fori_loop of nbOper extract-min steps over 8 or 4 bubbles,
// elementary_bubble_batch, fb_checknode_bubble with its dense scatter)
// and the truncation, rotations, padding mask, saturation and
// normalisation around its call sites.  For every row t of x [T, dc, q]
// (unrotated, min-normalised VN-to-CN messages), with g = t % G indexing
// the per-position tables rot_in, rot_out [G, dc, q] (uint8) and the
// optional valid [G, dc], it computes
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
// nothing), so the result equals the plain composition
// (ops/bubble_cn.bubble_rows_plain) bit for bit.  Step 8 runs only for a
// negative offset: with offset >= 0 every kept value is <= last <= last +
// offset = the fill, so the nm-th smallest is the fill or, with nm kept,
// last itself, and min(y, nm-th + offset) changes nothing.
//
// What bounds it on an H100 (3.35 TB/s).  At the layered call
// [172,800, 4, 256], nm = 32, nbOper = 64, it must read and write 1.42 GB
// (0.42 ms); its 3 (dc - 2) = 6 elementary steps a row are at most 64
// serial extract-min steps of ~60 instructions each, ~0.1 ms of issue at
// full lane use.  What is hard is that the step is serial and data
// dependent: which bubble moves, whether it breaks, where its output goes.
//
// What this design does about it.  A block of four warps takes a tile of R
// rows (R = 64 at dc = 4, nm = 32) in three phases:
// * A, one warp per row: the selections (a 32-step bisection on
//   order-preserving key bits, two messages side by side, as in
//   fb_checknode.cu), the list taken with two ballots per register slot,
//   then ranked by (key, id) within the warp;
// * B, one thread per (row, chain): the forward and the backward chains,
//   then one thread per (row, middle output).  The lists live in shared
//   memory, entry j of list L of row r at (L nm + j) Rp + r with Rp = R + 1
//   odd, so lanes on neighbouring rows hit neighbouring banks whatever
//   their j; each thread's 256-bit `seen` set is shared memory too;
// * C, one warp per row: the dense output built in the warp's shared
//   memory, rotated out, normalised and stored coalesced.
// 3 dc - 4 lists of nm (float, int16) pairs a row: 1.5 KB at dc = 4,
// nm = 32, so two blocks (128 rows) share an SM.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float INF_COST = 1e9f;          // ops/minconv.INF
constexpr float BIG = 1e5f;               // ops/bubble_cn.BIG
constexpr int NB = 2;                     // messages selected side by side
constexpr int WARPS = 4;                  // warps per block
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_ROWS = 64;              // rows per tile
constexpr long long TWO_BLOCKS = 115000;  // bytes a block may take so that
//                                           two share an SM (228 KB)
constexpr long long BLOCK_LIMIT = 232448; // dynamic shared memory a block
//                                           may use on Hopper

// Launches of bubble_kernel on this device, counted by the kernel itself,
// so that the launches a CUDA graph replays count too
// (bubble_rows_launches).
__device__ unsigned long long g_launches = 0;

struct Params {
  const float* x;
  float* out;
  long long T, G;
  int dc, q, nm, nb_oper;
  const uint8_t* rot_in;
  const uint8_t* rot_out;
  const uint8_t* valid;
  int truncate, saturate;  // steps 1 and 8
  float offset;
  int R, Rp, seen_words;   // rows per tile, list entry stride, seen words
};

// Shared memory of a block, in bytes, and its parts' offsets
// (ops/cuda_bubble.smem_bytes mirrors it).
struct Layout {
  long long lg, warp, seen, total;
};

__host__ __device__ inline long long align16(long long b) {
  return (b + 15) / 16 * 16;
}

__host__ __device__ inline Layout layout(int dc, int q, int nm, int R) {
  const int Rp = R | 1;
  const long long entries = static_cast<long long>(3 * dc - 4) * nm * Rp;
  const int words = q >= 32 ? q / 32 : 1;
  Layout l;
  l.lg = align16(4 * entries);                          // values, f32
  l.warp = l.lg + align16(2 * entries);                 // ids, int16
  l.seen = l.warp + WARPS * align16(4LL * NB * q + 8LL * NB * nm);
  l.total = l.seen + 4LL * words * THREADS;
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

// r[m] = the nm-th smallest key of message m, m < N (lanes that hold no
// symbol carry key ~0u and never count): a bisection on the key bits, the
// N messages side by side (fb_checknode.cu's kth_keys_n).
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
    // every key and every later threshold lies in [2^31, 2^32), so
    // key - t fits in 32 signed bits and its sign bit is key < t
#pragma unroll 1
    for (int b = 30; b >= 0; --b) {
      const unsigned bit = 1u << b;
#pragma unroll
      for (int m = 0; m < N; ++m) {
        const unsigned t = r[m] | bit;
        unsigned c = 0;
#pragma unroll
        for (int i = 0; i < PER; ++i) c += (key[m][i] - t) >> 31;
        c = __reduce_add_sync(FULL, c);
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

template <int PER>
__device__ __forceinline__ void kth_keys(const unsigned (&key)[NB][PER],
                                         int nb, int nm, unsigned (&r)[NB]) {
  static_assert(NB == 2, "one case per message count");
  if (nb == 1)
    kth_keys_n<PER, 1>(key, nm, r);
  else
    kth_keys_n<PER, 2>(key, nm, r);
}

// The nm smallest (value, GF id) pairs of a message (this lane holds the
// values v[i] of its symbols s[i]) whose nm-th smallest key is `kth`:
// every entry below it, then those equal to it in GF id order until nm
// are taken.  Slots are unique; their order is free.
template <int PER>
__device__ __forceinline__ void take_list(const unsigned (&key)[PER],
                                          const float (&v)[PER],
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
    const float2 e = make_float2(v[i], __int_as_float(s[i]));
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

// (key, id) of a list entry as one ascending 64-bit sort key.
__device__ __forceinline__ unsigned long long sort_key(float2 e) {
  return static_cast<unsigned long long>(fkey(e.x)) << 32 |
         static_cast<unsigned>(__float_as_int(e.y));
}

// List L of tile row r: entry j's value at v[j * Rp], its id at g[j * Rp].
struct List {
  float* v;
  short* g;
};

// One exact elementary step (ops/bubble_cn.elementary_bubble_batch on one
// pair of lists): `out` = E(a, b), at most nb_oper extract-min steps.
// NBUB = 8: rows 0..3 at column 0 move right, row 4 at columns 0..3 moves
// down, seeds and advances check index bounds only.  NBUB = 4 (the L
// shape): (0, 0) and (1, 0) move right, (2, 0) and (2, 1) move down, and
// a candidate with an unfilled id is BIG.  Once the JAX loop's `done`
// flag is set nothing changes any more, so this loop breaks there.
template <int NBUB>
__device__ __forceinline__ void elementary(List a, List b, List out, int Rp,
                                           int nm, int nb_oper, int qmask,
                                           unsigned* seen, int words) {
  constexpr int HALF = NBUB / 2;
  constexpr bool CHECK_IDS = NBUB == 4;
  for (int k = 0; k < nm; ++k) {
    out.v[k * Rp] = BIG;
    out.g[k * Rp] = -1;
  }
  for (int w = 0; w < words; ++w) seen[w * THREADS] = 0u;
  auto cand = [&](int i, int j) -> float {
    bool ok = i < nm && j < nm;
    if (CHECK_IDS && ok) ok = a.g[i * Rp] >= 0 && b.g[j * Rp] >= 0;
    return ok ? __fadd_rn(a.v[i * Rp], b.v[j * Rp]) : BIG;
  };
  float bv[NBUB];
  int bi[NBUB], bj[NBUB];
#pragma unroll
  for (int t = 0; t < NBUB; ++t) {
    if (NBUB == 8) {
      bi[t] = t < HALF ? t : HALF;
      bj[t] = t < HALF ? 0 : t - HALF;
    } else {
      bi[t] = t < 2 ? t : 2;
      bj[t] = t < 3 ? 0 : 1;
    }
    bv[t] = cand(bi[t], bj[t]);
  }
  int s = 0;
  for (int op = 0; op < nb_oper; ++op) {
    // the first minimal bubble, as argmin
    int pos = 0, i = bi[0], j = bj[0];
    float m = bv[0];
#pragma unroll
    for (int t = 1; t < NBUB; ++t) {
      if (bv[t] < m) {
        m = bv[t];
        pos = t;
        i = bi[t];
        j = bj[t];
      }
    }
    // validity break before the write
    if (i >= nm || j >= nm) break;
    const int gi = a.g[i * Rp], gj = b.g[j * Rp];
    if (gi < 0 || gj < 0) break;
    const int gf = (gi ^ gj) & qmask;
    unsigned* w = seen + (gf >> 5) * THREADS;
    const unsigned bit = 1u << (gf & 31), word = *w;
    if (!(word & bit)) {
      *w = word | bit;
      out.v[s * Rp] = m;
      out.g[s * Rp] = static_cast<short>(gf);
      if (++s >= nm) break;
    }
    // boundary break after the write
    if (i >= nm - 1 || j >= nm - 1) break;
    const bool down = pos >= HALF;
    const int ni = down ? i + 1 : i, nj = down ? j : j + 1;
    const float nv = cand(ni, nj);
#pragma unroll
    for (int t = 0; t < NBUB; ++t) {
      if (t == pos) {
        bv[t] = nv;
        bi[t] = ni;
        bj[t] = nj;
      }
    }
  }
}

template <int PER, int NBUB>
__global__ void __launch_bounds__(THREADS)
    bubble_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&g_launches, 1ULL);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int dc = p.dc, q = p.q, nm = p.nm, Rp = p.Rp, n = dc * q;
  const Layout lay = layout(dc, q, nm, p.R);
  float* lv = reinterpret_cast<float*>(smem_raw);
  short* lg = reinterpret_cast<short*>(smem_raw + lay.lg);
  float* stg = reinterpret_cast<float*>(
      smem_raw + lay.warp + warp * align16(4LL * NB * q + 8LL * NB * nm));
  float2* tmp = reinterpret_cast<float2*>(stg + NB * q);
  unsigned* seen = reinterpret_cast<unsigned*>(smem_raw + lay.seen) + tid;
  const unsigned key_inf = fkey(INF_COST);

  const long long row0 = static_cast<long long>(blockIdx.x) * p.R;
  const int rows = static_cast<int>(min(static_cast<long long>(p.R),
                                        p.T - row0));
  // list L of tile row r; slots: k = list(k) (then out[k], 1 <= k <= dc-2),
  // dc + t - 1 = F[t] and 2 dc - 3 + t = B[t], t = 1..dc-2
  auto list = [&](int L, int r) {
    const long long o = static_cast<long long>(L) * nm * Rp + r;
    return List{lv + o, lg + o};
  };
  auto fwd = [&](int t) { return t == 0 ? 0 : dc + t - 1; };
  auto bwd = [&](int t) { return t == dc - 1 ? dc - 1 : 2 * dc - 3 + t; };

  int s[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i)
    s[i] = PER == 1 ? (lane & (q - 1)) : lane + 32 * i;
  const bool on = lane < q;               // lanes past q (q < 32) hold copies

  // phase A: steps 1-4, one warp per row
  for (int r = warp; r < rows; r += WARPS) {
    const long long row = row0 + r;
    const long long g = row % p.G;
    const float* xr = p.x + row * n;
    const uint8_t* rin = p.rot_in + g * n;
    const uint8_t* val = p.valid ? p.valid + g * dc : nullptr;
    for (int k0 = 0; k0 < dc; k0 += NB) {
      const int nb = min(NB, dc - k0);
#pragma unroll
      for (int m = 0; m < NB; ++m)
        if (m < nb && on)
#pragma unroll
          for (int i = 0; i < PER; ++i)
            stg[m * q + s[i]] = xr[(k0 + m) * q + s[i]];
      __syncwarp();
      float v[NB][PER];
      unsigned key[NB][PER], kth[NB];
#pragma unroll
      for (int m = 0; m < NB; ++m) {
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          v[m][i] = 0.0f;
          key[m][i] = ~0u;
          if (m < nb && on) {
            v[m][i] = stg[m * q + __ldg(rin + (k0 + m) * q + s[i])];
            key[m][i] = fkey(v[m][i]);
          }
        }
      }
      if (p.truncate) {
        kth_keys<PER>(key, nb, nm, kth);
#pragma unroll
        for (int m = 0; m < NB; ++m)
#pragma unroll
          for (int i = 0; i < PER; ++i)
            if (m < nb && on && key[m][i] > kth[m]) {
              v[m][i] = INF_COST;
              key[m][i] = key_inf;
            }
      }
      unsigned want = 0;
#pragma unroll
      for (int m = 0; m < NB; ++m) {
        if (m < nb) {
          const bool ok = !val || val[k0 + m];
          if (!ok) {
#pragma unroll
            for (int i = 0; i < PER; ++i) {
              v[m][i] = s[i] == 0 ? 0.0f : INF_COST;
              key[m][i] = on ? fkey(v[m][i]) : ~0u;
            }
          }
          // a valid slot's truncation threshold is its list boundary
          if (!(p.truncate && ok && kth[m] <= key_inf)) want |= 1u << m;
        }
      }
      if (want) {
        unsigned kth2[NB];
        kth_keys<PER>(key, nb, nm, kth2);
#pragma unroll
        for (int m = 0; m < NB; ++m)
          if (want >> m & 1u) kth[m] = kth2[m];
      }
#pragma unroll
      for (int m = 0; m < NB; ++m)
        if (m < nb)
          take_list<PER>(key[m], v[m], s, on, kth[m], nm, lane,
                         tmp + m * nm);
      __syncwarp();
      // rank each entry by (key, id) and store the list in order
      for (int m = 0; m < nb; ++m) {
        const List L = list(k0 + m, r);
        for (int j = lane; j < nm; j += 32) {
          const float2 e = tmp[m * nm + j];
          const unsigned long long kk = sort_key(e);
          int rank = 0;
          for (int b = 0; b < nm; ++b) rank += sort_key(tmp[m * nm + b]) < kk;
          L.v[rank * Rp] = e.x;
          L.g[rank * Rp] = static_cast<short>(__float_as_int(e.y));
        }
      }
      __syncwarp();
      // minus the first value
      for (int m = 0; m < nb; ++m) {
        const List L = list(k0 + m, r);
        const float first = L.v[0];
        __syncwarp();
        for (int j = lane; j < nm; j += 32)
          L.v[j * Rp] = __fsub_rn(L.v[j * Rp], first);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // phase B: step 5, one thread per (row, chain), then per (row, output)
  const int words = p.seen_words, qmask = q - 1;
  for (int item = tid; item < 2 * rows; item += THREADS) {
    const int r = item % rows;
    if (item < rows) {
      for (int t = 1; t <= dc - 2; ++t)
        elementary<NBUB>(list(fwd(t - 1), r), list(t, r), list(fwd(t), r), Rp,
                         nm, p.nb_oper, qmask, seen, words);
    } else {
      for (int u = dc - 2; u >= 1; --u)
        elementary<NBUB>(list(bwd(u + 1), r), list(u, r), list(bwd(u), r), Rp,
                         nm, p.nb_oper, qmask, seen, words);
    }
  }
  __syncthreads();
  for (int item = tid; item < (dc - 2) * rows; item += THREADS) {
    const int t = 1 + item / rows, r = item % rows;
    elementary<NBUB>(list(fwd(t - 1), r), list(bwd(t + 1), r), list(t, r), Rp,
                     nm, p.nb_oper, qmask, seen, words);
  }
  __syncthreads();

  // phase C: steps 6-9, one warp per row; the dense output is built in the
  // warp's staging buffer
  float* dense = stg;
  const bool saturate = p.saturate && !(p.offset >= 0.0f);
  for (int r = warp; r < rows; r += WARPS) {
    const long long row = row0 + r;
    const long long g = row % p.G;
    const uint8_t* rout = p.rot_out + g * n;
    float* y = p.out + row * n;
    for (int k = 0; k < dc; ++k) {
      const List L = list(k == 0 ? bwd(1) : k == dc - 1 ? fwd(dc - 2) : k, r);
      unsigned kmax = 0;
      bool any = false;
      for (int j = lane; j < nm; j += 32) {
        if (L.g[j * Rp] >= 0) {
          any = true;
          kmax = max(kmax, fkey(L.v[j * Rp]));
        }
      }
      any = __any_sync(FULL, any);
      kmax = __reduce_max_sync(FULL, kmax);
      const float fill = any ? __fadd_rn(fval(kmax), p.offset) : p.offset;
      if (on)
#pragma unroll
        for (int i = 0; i < PER; ++i) dense[s[i]] = fill;
      __syncwarp();
      for (int j = lane; j < nm; j += 32) {
        const int id = L.g[j * Rp];
        if (id >= 0) dense[id] = L.v[j * Rp];
      }
      __syncwarp();
      float out[PER];
      unsigned key[NB][PER];
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        out[i] = on ? dense[__ldg(rout + k * q + s[i])] : 0.0f;
        key[0][i] = on ? fkey(out[i]) : ~0u;
        key[1][i] = ~0u;
      }
      float thr = __int_as_float(0x7f800000);
      if (saturate) {
        unsigned kth[NB];
        kth_keys_n<PER, 1>(key, nm, kth);
        thr = __fadd_rn(fval(kth[0]), p.offset);
      }
      unsigned kmin = ~0u;
#pragma unroll
      for (int i = 0; i < PER; ++i) kmin = min(kmin, key[0][i]);
      const float mn = fminf(fval(__reduce_min_sync(FULL, kmin)), thr);
      if (on)
#pragma unroll
        for (int i = 0; i < PER; ++i)
          y[k * q + s[i]] = __fsub_rn(fminf(out[i], thr), mn);
      __syncwarp();
    }
  }
}

// Rows per tile: as many as let two blocks share an SM (at most MAX_ROWS),
// else as many as one block holds; 0 if not even one row fits
// (ops/cuda_bubble.tile_rows mirrors it).
int tile_rows(int dc, int q, int nm) {
  for (int R = MAX_ROWS; R >= 1; --R)
    if (layout(dc, q, nm, R).total <= TWO_BLOCKS) return R;
  for (int R = MAX_ROWS; R >= 1; --R)
    if (layout(dc, q, nm, R).total <= BLOCK_LIMIT) return R;
  return 0;
}

template <int PER, int NBUB>
int launch(const Params& p, void* stream) {
  const int smem = static_cast<int>(layout(p.dc, p.q, p.nm, p.R).total);
  cudaError_t e = cudaFuncSetAttribute(
      bubble_kernel<PER, NBUB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(bubble_kernel<PER, NBUB>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = (p.T + p.R - 1) / p.R;
  bubble_kernel<PER, NBUB><<<static_cast<unsigned>(blocks), THREADS, smem,
                             static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int NBUB>
int launch_q(const Params& p, void* stream) {
  if (p.q <= 32) return launch<1, NBUB>(p, stream);
  if (p.q == 64) return launch<2, NBUB>(p, stream);
  if (p.q == 128) return launch<4, NBUB>(p, stream);
  return launch<8, NBUB>(p, stream);
}

}  // namespace

extern "C" {

// x, out: device pointers to [T, dc, q] contiguous float32.  rot_in,
// rot_out: [G, dc, q] uint8; valid: [G, dc] bytes (0 = padding slot) or
// null; row t uses table row t % G.  variant: 8 (8-bubble) or 4 (L-bubble).
// Requires q a power of two <= 256, dc >= 3, 1 <= nm <= q, nb_oper >= 0,
// and bubble_rows_tile(dc, q, nm) >= 1.  Launches on `stream`, does not
// synchronise, returns a CUDA error code (0 = launched; cudaErrorInvalidValue
// for arguments out of range).
int bubble_rows_launch(const float* x, float* out, long long T, int dc,
                       int q, int nm, int nb_oper, const uint8_t* rot_in,
                       const uint8_t* rot_out, const uint8_t* valid,
                       long long G, int truncate, int saturate, float offset,
                       int variant, void* stream) {
  if (T <= 0) return 0;
  const int R = tile_rows(dc, q, nm);
  if (R < 1 || dc < 3 || nm < 1 || nm > q || q > 256 || (q & (q - 1)) ||
      nb_oper < 0 || !rot_in || !rot_out || (variant != 8 && variant != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x;
  p.out = out;
  p.T = T;
  p.G = G > 0 ? G : 1;
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
  p.Rp = R | 1;
  p.seen_words = q >= 32 ? q / 32 : 1;
  return variant == 8 ? launch_q<8>(p, stream) : launch_q<4>(p, stream);
}

// The kernel's launches on the current device since the library was loaded
// or last reset, into *out (counted on the device, graph replays included).
// Synchronises the device.
int bubble_rows_launches(unsigned long long* out) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(out, g_launches, sizeof(g_launches));
  return static_cast<int>(e);
}

// Set the count of bubble_rows_launches to 0.  Synchronises the device.
int bubble_rows_reset_launches() {
  const unsigned long long zero = 0;
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(g_launches, &zero, sizeof(zero));
  return static_cast<int>(e);
}

}  // extern "C"
