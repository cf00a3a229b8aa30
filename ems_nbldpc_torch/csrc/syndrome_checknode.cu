// The whole syndrome-EMS check-node step of a batch of rows, one block per
// row.
//
// Replaces the XLA sorts of ems_nbldpc_tpu/ops/syndrome_cn.py
// (syndrome_checknode, :240), with the top-k selection and the rotations
// around its call sites (decoder/layered.py:138-150, 170-172, 196 and
// decoder/flooding.py:118-130, 163-170).  For every row t of x [T, dc, q]
// (unrotated, min-normalised VN-to-CN messages), with g = t % G indexing the
// per-position tables rot_in, rot_out [G, dc, q] (uint8) and the optional
// valid [G, dc], and with the config table [C, dc] (uint8, entry k: the k-th
// best entry of that edge) and the saturation ranks kth [dc] (per presorted
// edge position) shared by all rows, it computes
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
//        v1, v2 = the smallest and second smallest vbits of each bucket;
//        comb  = bayes(v1, v2) (v1 * a factor of v2 - v1) or v1, rounded
//                to bf16 again (cbits);
//        the buckets ranked by (cbits << 8) | b keep their value when among
//        the first keep = min(C, kth[t] + 1, q), INF otherwise;
//        out   = value > sat ? sat + offset : value;
//      written to t's original edge;
//   6. rotate out: y[c] = out[rot_out[c]], and subtract the message minimum.
// Every step is integer or bf16-key logic but for the config sums, the bayes
// multiply and sat + offset, each one f32 operation in the plain version's
// order, so the result equals ops/cuda_syndrome.syndrome_rows_plain (the
// JAX version's sort-based form) bit for bit.
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s f32).  At the layered
// call [172,800, 4, 256] it must read and write 1.42 GB (0.42 ms); its
// operations are a few thousand integer and shared-memory steps a row (C =
// 993 configs, each summed over dc edges and passed twice per edge), about
// 2 G in all: memory bounds the work, instruction issue and block barriers
// bound this design.  The JAX form sorts [rows, C] int32 keys three times
// per edge; here a row's C syndromes (11 bytes each), its lists and its q
// buckets sit in one block's shared memory and the sorts become
//   * bucket minima by a 32-bit shared atomicMin of (vbits << 16) | c, and
//     a second pass for the smallest vbits of the bucket's other configs;
//   * selections by 8-bit radix passes: a shared histogram, one warp finds
//     the digit of the k-th key by a prefix scan (two passes for the 16-bit
//     saturation key, three for the 24-bit bucket ranks, only when more
//     buckets lie at or below sat than are kept);
//   * each edge's top-nm list by a 32-step warp bisection on order-
//     preserving float keys (as ops/cuda_cn's kernel), then a rank count
//     among the nm survivors.
// A simple design: one block of 256 threads per row, no persistence, the
// row staged with coalesced loads.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NONE = 0xffffffffu;
constexpr float INF_COST = 1e9f;        // ops/minconv.INF
constexpr int NT = 256;                 // threads per block (>= q)
constexpr int NW = NT / 32;
constexpr int MAX_DC = 32;              // the deviation mask is 32 bits

// Launches of syndrome_rows_kernel on this device, counted by the kernel
// itself, so that the launches a CUDA graph replays count too.
__device__ unsigned long long g_launches = 0;

struct Params {
  const float* x;
  float* out;
  long long T, G;
  int dc, q, nm, C;
  const uint8_t* rot_in;
  const uint8_t* rot_out;
  const uint8_t* valid;
  const uint8_t* table;
  const int* kth;
  int bayes, presort;
  float offset;
};

// Order-preserving unsigned key of a float (-0 maps to +0's key).
__device__ __forceinline__ unsigned fkey(float f) {
  const unsigned b = __float_as_uint(f == 0.0f ? 0.0f : f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
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

__host__ __device__ constexpr long long align16(long long b) {
  return (b + 15) / 16 * 16;
}

// Shared memory of one block (ops/cuda_syndrome.smem_bytes mirrors it):
// staged row / output and rotated row (2 dc q f32), sorted and candidate
// lists (4 dc nm words), per config llr, deviation mask, vbits and gf
// (11 bytes), two bucket arrays (2 q words), two histograms of 256 words,
// the edge order and a few scalars.
__host__ __device__ long long smem_bytes(int dc, int q, int nm, int C) {
  return 2 * align16(4LL * dc * q) + 4 * align16(4LL * dc * nm) +
         2 * align16(4LL * C) + align16(2LL * C) + align16(1LL * C) +
         2 * align16(4LL * q) + 2 * 4 * 256 + align16(4 * MAX_DC) + 64;
}

// Warp 0: the digit d of the k-th smallest (0-based, with multiplicity)
// key of a 256-bin histogram and k's rank among the keys of digit d, into
// sh[0], sh[1].  Traps if the histogram holds k or fewer keys.
__device__ __forceinline__ void select_digit(const unsigned* hist,
                                             unsigned k, int lane,
                                             unsigned* sh) {
  unsigned h[8], s = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    h[i] = hist[lane * 8 + i];
    s += h[i];
  }
  unsigned inc = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned n = __shfl_up_sync(FULL, inc, off);
    if (lane >= off) inc += n;
  }
  const unsigned exc = inc - s;
  const bool mine = exc <= k && k < inc;
  if (!__any_sync(FULL, mine)) __trap();
  if (mine) {
    unsigned acc = exc;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (k < acc + h[i]) {
        sh[0] = lane * 8 + i;
        sh[1] = k - acc;
        break;
      }
      acc += h[i];
    }
  }
}

// One warp: the nm smallest (value, id) pairs of message v [q], ascending,
// lower id first among equal values, into lv / lg; tv / tg are scratch of
// nm entries.  Lane l owns symbols l + 32 i.
template <int PER>
__device__ __forceinline__ void top_list(const float* v, int q, int nm,
                                         int lane, float* tv, int* tg,
                                         float* lv, int* lg) {
  int s[PER];
  unsigned key[PER];
  const bool on = lane < q;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    s[i] = PER == 1 ? (lane & (q - 1)) : lane + 32 * i;
    key[i] = on ? fkey(v[s[i]]) : ~0u;
  }
  // the nm-th smallest key: the largest r with #(key < r) < nm
  unsigned r = 0;
  const unsigned n = static_cast<unsigned>(nm);
#pragma unroll 1
  for (int b = 31; b >= 0; --b) {
    const unsigned t = r | (1u << b);
    unsigned c = 0;
#pragma unroll
    for (int i = 0; i < PER; ++i) c += key[i] < t;
    if (__reduce_add_sync(FULL, c) < n) r = t;
  }
  // the entries below it, then those equal to it in id order up to nm
  const unsigned below = (1u << lane) - 1u;
  unsigned bl[PER], be[PER];
  int nless = 0;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    bl[i] = __ballot_sync(FULL, on && key[i] < r);
    be[i] = __ballot_sync(FULL, on && key[i] == r);
    nless += __popc(bl[i]);
  }
  const int need = nm - nless;
  int bless = 0, beq = 0;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    int slot = -1;
    if (bl[i] >> lane & 1u) {
      slot = bless + __popc(bl[i] & below);
    } else if (be[i] >> lane & 1u) {
      const int e = beq + __popc(be[i] & below);
      if (e < need) slot = nless + e;
    }
    if (slot >= 0) {
      tv[slot] = v[s[i]];
      tg[slot] = s[i];
    }
    bless += __popc(bl[i]);
    beq += __popc(be[i]);
  }
  __syncwarp();
  // order the nm survivors by (key, id): each one's rank is its slot
  for (int j = lane; j < nm; j += 32) {
    const unsigned kj = fkey(tv[j]);
    const int gj = tg[j];
    int rank = 0;
    for (int i = 0; i < nm; ++i) {
      const unsigned ki = fkey(tv[i]);
      rank += ki < kj || (ki == kj && tg[i] < gj);
    }
    lv[rank] = tv[j];
    lg[rank] = gj;
  }
  __syncwarp();
}

template <int PER>
__global__ void __launch_bounds__(NT)
    syndrome_rows_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&g_launches, 1ULL);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int dc = p.dc, q = p.q, nm = p.nm, C = p.C;
  const int n = dc * q;
  const long long row = blockIdx.x;
  const long long g = row % p.G;

  unsigned char* base = smem_raw;
  auto take = [&](long long bytes) {
    unsigned char* at = base;
    base += align16(bytes);
    return at;
  };
  float* R = reinterpret_cast<float*>(take(4LL * n));     // row, then output
  float* X = reinterpret_cast<float*>(take(4LL * n));     // rotated row
  float* Lv = reinterpret_cast<float*>(take(4LL * dc * nm));
  int* Lg = reinterpret_cast<int*>(take(4LL * dc * nm));
  float* Tv = reinterpret_cast<float*>(take(4LL * dc * nm));
  int* Tg = reinterpret_cast<int*>(take(4LL * dc * nm));
  float* llr = reinterpret_cast<float*>(take(4LL * C));
  unsigned* dmask = reinterpret_cast<unsigned*>(take(4LL * C));
  uint16_t* vbs = reinterpret_cast<uint16_t*>(take(2LL * C));
  uint8_t* gfc = reinterpret_cast<uint8_t*>(take(1LL * C));
  unsigned* bkt1 = reinterpret_cast<unsigned*>(take(4LL * q));
  unsigned* bkt2 = reinterpret_cast<unsigned*>(take(4LL * q));
  unsigned* hA = reinterpret_cast<unsigned*>(take(4 * 256));
  unsigned* hB = reinterpret_cast<unsigned*>(take(4 * 256));
  int* order = reinterpret_cast<int*>(take(4 * MAX_DC));
  unsigned* sh = reinterpret_cast<unsigned*>(take(64));

  // 1. stage the row (coalesced), then rotate in and mask
  const float* src = p.x + row * n;
  if (n % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int i = tid; i < n / 4; i += NT)
      reinterpret_cast<float4*>(R)[i] =
          __ldg(reinterpret_cast<const float4*>(src) + i);
  } else {
    for (int i = tid; i < n; i += NT) R[i] = __ldg(src + i);
  }
  __syncthreads();
  for (int i = tid; i < n; i += NT) {
    const int k = i / q, u = i - k * q;
    const bool ok = !p.valid || p.valid[g * dc + k];
    float v;
    if (ok)
      v = R[k * q + (p.rot_in ? __ldg(p.rot_in + g * n + i) : u)];
    else
      v = u == 0 ? 0.0f : INF_COST;
    X[i] = v;
  }
  __syncthreads();

  // 2. the lists, one warp per edge
  for (int k = warp; k < dc; k += NW)
    top_list<PER>(X + k * q, q, nm, lane, Tv + k * nm, Tg + k * nm,
                  Lv + k * nm, Lg + k * nm);
  __syncthreads();

  // 3. presort (stable insertion sorts)
  if (tid == 0) {
    for (int k = 0; k < dc; ++k) order[k] = k;
    if (p.presort) {
      for (int k = 1; k < dc; ++k) {
        const int e = order[k];
        const float v = Lv[e * nm + 1];
        int j = k;
        for (; j > 0 && Lv[order[j - 1] * nm + 1] > v; --j)
          order[j] = order[j - 1];
        order[j] = e;
      }
      const int border = min(4, dc);
      for (int k = 1; k < border; ++k) {
        const int e = order[k];
        const float v = Lv[e * nm + 2];
        int j = k;
        for (; j > 0 && Lv[order[j - 1] * nm + 2] > v; --j)
          order[j] = order[j - 1];
        order[j] = e;
      }
    }
  }
  __syncthreads();

  // 4. config syndromes
  for (int c = tid; c < C; c += NT) {
    float s = 0.0f;
    unsigned x = 0, dm = 0;
    for (int j = 0; j < dc; ++j) {
      const unsigned e = __ldg(p.table + static_cast<long long>(c) * dc + j);
      if (e >= static_cast<unsigned>(nm)) __trap();
      const int at = order[j] * nm + e;
      s = __fadd_rn(s, Lv[at]);
      x ^= static_cast<unsigned>(Lg[at]);
      dm |= static_cast<unsigned>(e != 0) << j;
    }
    llr[c] = s;
    gfc[c] = static_cast<uint8_t>(x);
    dmask[c] = dm;
  }

  // 5. per presorted edge position
  const float sat_off = p.offset;
  for (int t = 0; t < dc; ++t) {
    for (int b = tid; b < q; b += NT) bkt1[b] = bkt2[b] = NONE;
    for (int i = tid; i < 256; i += NT) hA[i] = hB[i] = 0;
    __syncthreads();
    const int et = order[t];
    const unsigned g0 = static_cast<unsigned>(Lg[et * nm]);
    const unsigned k = static_cast<unsigned>(p.kth[t]);
    const unsigned keep = min(static_cast<unsigned>(C),
                              min(k + 1, static_cast<unsigned>(q)));
    // bucket minima and the saturation key's high byte
    for (int c = tid; c < C; c += NT) {
      if (dmask[c] >> t & 1u) continue;
      const unsigned vb = bf16_bits(fminf(llr[c], INF_COST));
      vbs[c] = static_cast<uint16_t>(vb);
      atomicMin(&bkt1[gfc[c] ^ g0], vb << 16 | static_cast<unsigned>(c));
      atomicAdd(&hA[vb >> 8], 1u);
    }
    __syncthreads();
    if (warp == 0) select_digit(hA, k, lane, sh);
    __syncthreads();
    const unsigned hi = sh[0], k_lo = sh[1];
    // the buckets' second smallest and the saturation key's low byte
    for (int c = tid; c < C; c += NT) {
      if (dmask[c] >> t & 1u) continue;
      const unsigned vb = vbs[c];
      const unsigned b = gfc[c] ^ g0;
      if (p.bayes && (bkt1[b] & 0xffffu) != static_cast<unsigned>(c))
        atomicMin(&bkt2[b], vb);
      if (vb >> 8 == hi) atomicAdd(&hB[vb & 255u], 1u);
    }
    __syncthreads();
    if (warp == 0) select_digit(hB, k_lo, lane, sh + 2);
    __syncthreads();
    const float sat = bf16_value(hi << 8 | sh[2]);

    // each bucket's combined value; rank keys of those at or below sat
    unsigned key2 = NONE;
    float kv = INF_COST;
    if (tid < q) {
      const unsigned b1 = bkt1[tid];
      if (b1 != NONE) {
        const float v1 = bf16_value(b1 >> 16);
        float comb = v1;
        if (p.bayes) {
          const unsigned b2 = bkt2[tid];
          const float v2 = b2 != NONE ? bf16_value(b2) : INF_COST;
          const float dif = __fsub_rn(v2, v1);
          const float f = dif < 0.1f ? 0.5f
                          : dif < 0.2f ? 0.75f
                          : dif < 1.0f ? 0.825f
                          : dif < 2.0f ? 0.9375f
                                       : 1.0f;
          const bool finite =
              (__float_as_uint(v2) & 0x7f800000u) != 0x7f800000u;
          if (finite && v2 < 5e8f) comb = __fmul_rn(v1, f);
        }
        const unsigned cb = bf16_bits(fminf(comb, INF_COST));
        kv = bf16_value(cb);
        if (!(kv > sat)) key2 = cb << 8 | static_cast<unsigned>(tid);
      }
    }
    const unsigned nle = __syncthreads_count(key2 != NONE);
    // buckets at or below sat rank before all others: when more of them
    // than `keep`, only the `keep` smallest keys stay (thr = the largest)
    unsigned thr = NONE;
    if (nle > keep) {
      unsigned pre = 0, kk = keep - 1;
      for (int shift = 16; shift >= 0; shift -= 8) {
        for (int i = tid; i < 256; i += NT) hA[i] = 0;
        __syncthreads();
        if (key2 != NONE && key2 >> (shift + 8) == pre)
          atomicAdd(&hA[key2 >> shift & 255u], 1u);
        __syncthreads();
        if (warp == 0) select_digit(hA, kk, lane, sh + 4);
        __syncthreads();
        pre = pre << 8 | sh[4];
        kk = sh[5];
      }
      thr = pre;
    }
    if (tid < q) {
      const float o = key2 != NONE && key2 <= thr ? kv : INF_COST;
      R[et * q + tid] = o > sat ? __fadd_rn(sat, sat_off) : o;
    }
    __syncthreads();
  }

  // 6. rotate out, normalise, store: one warp per edge
  float* y = p.out + row * n;
  const bool on = lane < q;
  for (int k = warp; k < dc; k += NW) {
    float v[PER];
    float mn = __int_as_float(0x7f800000);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int u = PER == 1 ? (lane & (q - 1)) : lane + 32 * i;
      const int c = p.rot_out ? __ldg(p.rot_out + g * n + k * q + u) : u;
      v[i] = R[k * q + c];
      if (on) mn = fminf(mn, v[i]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mn = fminf(mn, __shfl_xor_sync(FULL, mn, off));
    if (on) {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int u = PER == 1 ? lane : lane + 32 * i;
        y[k * q + u] = __fsub_rn(v[i], mn);
      }
    }
  }
}

template <int PER>
int launch(const Params& p, void* stream) {
  const int smem = static_cast<int>(smem_bytes(p.dc, p.q, p.nm, p.C));
  cudaError_t e = cudaFuncSetAttribute(
      syndrome_rows_kernel<PER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(syndrome_rows_kernel<PER>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  syndrome_rows_kernel<PER><<<static_cast<unsigned>(p.T), NT, smem,
                              static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory of one block (one row), in bytes.
long long syndrome_rows_smem_bytes(int dc, int q, int nm, int C) {
  return smem_bytes(dc, q, nm, C);
}

// x, out: device pointers to [T, dc, q] contiguous float32.  rot_in,
// rot_out: [G, dc, q] uint8 or null (identity); valid: [G, dc] bytes (0 =
// padding slot) or null; row t uses table row t % G.  table: [C, dc] uint8
// deviations, each < nm (the kernel traps on one that is not); kth: [dc]
// int32 saturation ranks, each below its position's count of configs with
// no deviation there (else the kernel traps).  Requires q a power of two
// <= 256, 2 <= dc <= 32, 1 <= nm <= q (3 <= nm with presort), 1 <= C <=
// 65536, T < 2^31 and smem_bytes within the block limit.  Launches on
// `stream`, does not synchronise, returns a CUDA error code (0 =
// launched).
int syndrome_rows_launch(const float* x, float* out, long long T, int dc,
                         int q, int nm, const uint8_t* rot_in,
                         const uint8_t* rot_out, const uint8_t* valid,
                         long long G, const uint8_t* table, int C,
                         const int* kth, int bayes, int presort, float offset,
                         void* stream) {
  if (T <= 0) return 0;
  Params p;
  p.x = x;
  p.out = out;
  p.T = T;
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
  p.bayes = bayes;
  p.presort = presort;
  p.offset = offset;
  if (q <= 32) return launch<1>(p, stream);
  if (q == 64) return launch<2>(p, stream);
  if (q == 128) return launch<4>(p, stream);
  return launch<8>(p, stream);
}

// The kernel's launches on the current device since the library was loaded
// or last reset, into *out (counted on the device, graph replays included).
// Synchronises the device.
int syndrome_rows_launches(unsigned long long* out) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(out, g_launches, sizeof(g_launches));
  return static_cast<int>(e);
}

// Set the count of syndrome_rows_launches to 0.  Synchronises the device.
int syndrome_rows_reset_launches() {
  const unsigned long long zero = 0;
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(g_launches, &zero, sizeof(zero));
  return static_cast<int>(e);
}

}  // extern "C"
