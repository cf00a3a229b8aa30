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
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores).  At the layered call [172,800, 4, 256], nm = 32, it must read
// and write 1.42 GB (0.42 ms) and do 17 G candidate adds and mins
// (0.25 ms): device memory bounds it.  The tensor cores cannot help:
// wgmma and mma compute sums of products, not (min, +), so the check node
// lives on registers, warp shuffles and shared memory.  The earlier design
// (one block per row, lists ranked by O(q^2) compares, two torch.topk and
// six torch passes around it) issued 5x more compares than candidates and
// ran at 2% of that bound.
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
// * acc lives in the warp's shared memory; for fixed g, s ^ g permutes the
//   low five bits of s within a warp, so the gather has no bank conflicts.
//   Each lane keeps its outputs in registers and reads each (lv, lg) pair
//   once per j, as one 8-byte broadcast; two chains are combined per pass.
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
// warps share an SM.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float INF_COST = 1e9f;          // ops/minconv.INF
constexpr int NB = 2;                     // messages bisected side by side
constexpr int MAX_WARPS = 4;              // warps (rows in flight) per block

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
  int warp_bytes;
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

template <int PER>
__global__ void ems_rows_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&g_launches, 1ULL);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int dc = p.dc, q = p.q, nm = p.nm, L = dc - 2;
  const int n = dc * q;
  float* X = reinterpret_cast<float*>(smem_raw + warp * p.warp_bytes);
  float* Fs = X + n;                      // F[k] at k*q, k = 0..dc-2
  float* Bs = Fs + (dc - 1) * q;          // B[k] at (k-1)*q, k = 1..dc-1
  // 2L lists of nm pairs: slot k-1 = list(in[k]), k = 1..L;
  // slot L+k-2 = list(B[k]), k = 2..dc-1
  float2* Lst = reinterpret_cast<float2*>(Bs + (dc - 1) * q);
  const unsigned key_inf = fkey(INF_COST);

  int s[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i)
    s[i] = PER == 1 ? (lane & (q - 1)) : lane + 32 * i;
  const bool on = lane < q;               // lanes past q (q < 32) hold copies

  const long long warps = static_cast<long long>(gridDim.x) *
                          (blockDim.x >> 5);
  long long row = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
                  warp;
  if (row < p.T) stage(p, X, row, lane);
  for (; row < p.T; row += warps) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncwarp();
    const long long g = row % p.G;
    const uint8_t* rin = p.rot_in ? p.rot_in + g * n : nullptr;
    const uint8_t* rout = p.rot_out ? p.rot_out + g * n : nullptr;
    const uint8_t* val = p.valid ? p.valid + g * dc : nullptr;

    // prologue: rotate in, truncate, mask, parking each input in[k] at
    // its home (F[k] for k <= dc-2, whose slots the chain overwrites only
    // after their lists are taken; B[dc-1] for k = dc-1); registers hold
    // the keys, and each lane touches only its own symbols of a home
    for (int k0 = 0; k0 < dc; k0 += NB) {
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
            const float v = X[k * q + src];
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
          // the truncation threshold is the list boundary of a valid slot
          const bool mid = k >= 1 && k <= L;
          if (mid && !(p.truncate && ok && kth[m] <= key_inf)) want |= 1u << m;
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
      for (int m = 0; m < NB; ++m) {
        const int k = k0 + m;
        if (m < nb && k >= 1 && k <= L)
          take_list<PER>(key[m], Fs + k * q, s, on, kth[m], nm, lane,
                         Lst + (k - 1) * nm);
      }
    }
    __syncwarp();
    // X is consumed: stage the next row while this one computes
    if (row + warps < p.T) stage(p, X, row + warps, lane);

    // forward and backward chains, one step of each per pass
    for (int st = 1; st <= L; ++st) {
      const int kb = dc - 1 - st;
      const float* const acc[2] = {Fs + (st - 1) * q, Bs + kb * q};
      const float2* const lst[2] = {Lst + (st - 1) * nm, Lst + (kb - 1) * nm};
      float o[2][PER];
      combine<PER, 2>(acc, lst, nm, s, o);
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
      kth_keys<PER>(key, nb, nm, kth);
#pragma unroll
      for (int m = 0; m < NB; ++m)
        if (m < nb)
          take_list<PER>(key[m], Bs + (k0 + m - 1) * q, s, on, kth[m], nm,
                         lane, Lst + (L + k0 + m - 2) * nm);
    }
    __syncwarp();

    // middle merges, two per pass: out[i] goes to B[i+1]'s slot, whose
    // list is taken
    for (int i0 = 1; i0 <= L; i0 += 2) {
      if (i0 < L) {
        const float* const acc[2] = {Fs + (i0 - 1) * q, Fs + i0 * q};
        const float2* const lst[2] = {Lst + (L + i0 - 1) * nm,
                                      Lst + (L + i0) * nm};
        float o[2][PER];
        combine<PER, 2>(acc, lst, nm, s, o);
        if (on) {
#pragma unroll
          for (int i = 0; i < PER; ++i) {
            Bs[i0 * q + s[i]] = o[0][i];
            Bs[(i0 + 1) * q + s[i]] = o[1][i];
          }
        }
      } else {
        const float* const acc[1] = {Fs + (i0 - 1) * q};
        const float2* const lst[1] = {Lst + (L + i0 - 1) * nm};
        float o[1][PER];
        combine<PER, 1>(acc, lst, nm, s, o);
        if (on) {
#pragma unroll
          for (int i = 0; i < PER; ++i) Bs[i0 * q + s[i]] = o[0][i];
        }
      }
    }
    __syncwarp();

    // epilogue: rotate out, saturate, normalise, store; out[k] sits at
    // Bs[k] for k <= dc-2 and at F[dc-2] for k = dc-1
    float* y = p.out + row * n;
    for (int k0 = 0; k0 < dc; k0 += NB) {
      const int nb = min(NB, dc - k0);
      unsigned key[NB][PER], kth[NB];
#pragma unroll
      for (int m = 0; m < NB; ++m) {
        if (m < nb) {
          const int k = k0 + m;
          const float* src = k <= L ? Bs + k * q : Fs + L * q;
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
          const float* src = k <= L ? Bs + k * q : Fs + L * q;
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

template <int PER>
int launch(const Params& p, void* stream) {
  const int warps = max(1, min(MAX_WARPS, 232448 / p.warp_bytes));
  const int smem = warps * p.warp_bytes;
  cudaError_t e = cudaFuncSetAttribute(
      ems_rows_kernel<PER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(ems_rows_kernel<PER>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, ems_rows_kernel<PER>, 32 * warps, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long need = (p.T + warps - 1) / warps;
  const long long resident = static_cast<long long>(sms) * max(per_sm, 1);
  const unsigned blocks = static_cast<unsigned>(need < resident ? need
                                                                : resident);
  ems_rows_kernel<PER><<<blocks, 32 * warps, smem,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory of one warp, in bytes (ops/cuda_cn.smem_bytes): the staged
// row, F[0..dc-2], B[1..dc-1] and 2(dc-2) lists of nm (value, id) pairs.
long long ems_rows_smem_bytes(int dc, int q, int nm) {
  const long long b = 4LL * (3LL * dc - 2) * q + 16LL * (dc - 2) * nm;
  return (b + 15) / 16 * 16;
}

// x, out: device pointers to [T, dc, q] contiguous float32.  rot_in,
// rot_out: [G, dc, q] uint8 or null (identity); valid: [G, dc] bytes (0 =
// padding slot) or null; row t uses table row t % G.  Requires q a power
// of two <= 256, dc >= 3, 1 <= nm <= q, and one warp's shared memory
// (ems_rows_smem_bytes) within the block limit.  Launches on `stream`,
// does not synchronise, returns a CUDA error code (0 = launched).
int ems_rows_launch(const float* x, float* out, long long T, int dc, int q,
                    int nm, const uint8_t* rot_in, const uint8_t* rot_out,
                    const uint8_t* valid, long long G, int truncate,
                    int normalize, float offset, void* stream) {
  if (T <= 0) return 0;
  Params p;
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
  p.warp_bytes = static_cast<int>(ems_rows_smem_bytes(dc, q, nm));
  if (q <= 32) return launch<1>(p, stream);
  if (q == 64) return launch<2>(p, stream);
  if (q == 128) return launch<4>(p, stream);
  return launch<8>(p, stream);
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
