// Sum-product (SPA) check node over GF(q), q = 2^m, one row per block.
//
// Replaces the XLA op ems_nbldpc_tpu/ops/fht.py:249 fb_checknode_spa_fused
// (no Pallas kernel there: XLA lowered it as grouped Hadamard matmuls).
// For every row of mvc [T, dc, q] (UN-rotated min-cost VtoC messages,
// f32) with GF coefficients h_i = coefs[row % G][i], it computes the dc
// UN-rotated min-cost CtoV messages [T, dc, q], in the same order of steps
// as its plain torch version ops/fht.spa_checknode_plain:
//   1. p_i = exp(-min(c_i - min c_i, 60)), then p_i /= sum p_i;
//   2. w_i[u] = WHT(p_i)[t_h[u]]        (the GF rotation folded into the
//      transform: t_h = mul_transpose_perm(h), table t_tab[h]);
//   3. o_i = prod_{j != i} w_j          (forward/backward products);
//   4. y_i[s] = o_i[t_h^-1[s]]          (table tinv_tab[h]), then
//      out_i = WHT(y_i) / q;
//   5. out_i = max(out_i, 1e-30), then -log(max(out_i, f32(exp(-60)))),
//      minus its min.
// A padding lane (h = 0) transforms in to the neutral w = sum(p) = 1
// (t_0 = 0), and its output is all-equal probabilities: costs of 0.
//
// Design.  One block per row and max(q, 32) threads; thread u owns symbol
// u of each of the row's dc messages.  The row (dc*q f32, 4 KB at dc = 4,
// q = 256) lives in shared memory, twice, so each of the 2 log2(q)
// butterfly stages reads one buffer and writes the other with one
// __syncthreads per stage; the partner u ^ s of a stage s < 32 lies in
// the same warp, so the stages have no bank conflicts.  The products of
// step 3 are per symbol and need no exchange.  Mins and sums over the q
// symbols are warp shuffles, then one pass over the warps' partials.
// No fast math: the inverse transform sums q terms of O(1) down to
// probabilities near 1e-26, so expf/logf and IEEE division are kept.
//
// What bounds it.  A row reads and writes 4 KB once each (8 KB): at
// T = 128 * 1350 rows that is 1.4 GB per super-layer call, 0.42 ms at the
// card's 3.35 TB/s; the butterflies cost about 16 K flops per row (2.8
// GFLOP per call).  Measured: 4.02 ms per call at that shape on an NVIDIA
// H100 80GB HBM3 at a 700 W power limit (14.64 ms for the plain version),
// ten times the memory floor.  So instruction throughput bounds it, not
// device memory: every value crosses shared memory on each of the 16
// butterfly stages, behind 25 block-wide syncs, and each thread loops over
// the dc messages for the three block reductions and for expf/logf.  Next:
// keep several symbols per thread in registers (the stages below 32 become
// register and warp-shuffle exchanges), several rows per block, and fuse
// the gathers of APP and CtoV, the normalization and the scatters around
// it into one super-layer kernel.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float kLogEps = 60.0f;             // fht._LOG_EPS
constexpr float kPFloor = 0x1.5ae192p-87f;   // float32(exp(-60))
constexpr float kOutFloor = 1e-30f;

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Per-message reductions over the q symbols of S[i*q + u], i < dc: each
// warp reduces its lanes into red[i*nw + warp].  Every thread of the block
// calls it; threads u >= q contribute the neutral element.  The caller
// reads the partials (read_min / read_sum) after the closing sync.
template <bool kMin>
__device__ __forceinline__ void reduce_rows(const float* S, float* red,
                                            int dc, int q, int u, int nw) {
  __syncthreads();  // S is written; earlier partials are read
  for (int i = 0; i < dc; ++i) {
    float v = u < q ? S[i * q + u] : (kMin ? CUDART_INF_F : 0.0f);
    v = kMin ? warp_min(v) : warp_sum(v);
    if ((u & 31) == 0) red[i * nw + (u >> 5)] = v;
  }
  __syncthreads();
}

__device__ __forceinline__ float read_min(const float* red, int i, int nw) {
  float v = red[i * nw];
  for (int w = 1; w < nw; ++w) v = fminf(v, red[i * nw + w]);
  return v;
}

__device__ __forceinline__ float read_sum(const float* red, int i, int nw) {
  float v = red[i * nw];
  for (int w = 1; w < nw; ++w) v += red[i * nw + w];
  return v;
}

// Unnormalized WHT of the dc messages in *src, ping-ponging with *dst;
// on return *src holds the result.  Stage s: lo = x[u], hi = x[u ^ s];
// u without bit s gets lo + hi, u with it gets hi - lo (H[u, v] =
// (-1)^popcount(u & v)).
__device__ __forceinline__ void wht_rows(float*& src, float*& dst, int dc,
                                         int q, int u) {
  for (int s = 1; s < q; s <<= 1) {
    __syncthreads();
    if (u < q) {
      for (int i = 0; i < dc; ++i) {
        const float a = src[i * q + u];
        const float b = src[i * q + (u ^ s)];
        dst[i * q + u] = (u & s) ? b - a : a + b;
      }
    }
    float* t = src;
    src = dst;
    dst = t;
  }
}

__global__ void spa_checknode_kernel(const float* __restrict__ mvc,
                                     const int* __restrict__ coefs,
                                     const uint8_t* __restrict__ t_tab,
                                     const uint8_t* __restrict__ tinv_tab,
                                     float* __restrict__ out, int G, int dc,
                                     int q) {
  extern __shared__ float smem[];
  const int nw = blockDim.x >> 5;
  float* src = smem;                    // [dc][q]
  float* dst = src + dc * q;            // [dc][q]
  float* red = dst + dc * q;            // [dc][nw] per-warp partials
  const int u = threadIdx.x;
  const bool lane = u < q;
  const size_t row = blockIdx.x;
  const int* h = coefs + (row % G) * dc;
  const float* x = mvc + row * dc * q;
  float* y = out + row * dc * q;

  // 1. costs -> probabilities
  if (lane)
    for (int i = 0; i < dc; ++i) src[i * q + u] = x[i * q + u];
  reduce_rows<true>(src, red, dc, q, u, nw);
  if (lane)
    for (int i = 0; i < dc; ++i) {
      const float c = src[i * q + u] - read_min(red, i, nw);
      src[i * q + u] = expf(-fminf(c, kLogEps));
    }
  reduce_rows<false>(src, red, dc, q, u, nw);
  if (lane)
    for (int i = 0; i < dc; ++i) src[i * q + u] /= read_sum(red, i, nw);

  // 2. WHT, then w[u] = WHT(p)[t_h[u]]
  wht_rows(src, dst, dc, q, u);
  __syncthreads();
  if (lane)
    for (int i = 0; i < dc; ++i)
      dst[i * q + u] = src[i * q + t_tab[h[i] * q + u]];
  __syncthreads();  // src is free once every thread has gathered

  // 3. extrinsic products, per symbol: src[i] = prod_{j > i} w_j, then
  //    src[i] *= prod_{j < i} w_j (the association of fht._fb_products)
  if (lane) {
    float b = 1.0f;
    for (int i = dc - 1; i >= 0; --i) {
      src[i * q + u] = b;
      b = b * dst[i * q + u];
    }
    float f = 1.0f;
    for (int i = 0; i < dc; ++i) {
      src[i * q + u] = f * src[i * q + u];
      f = f * dst[i * q + u];
    }
  }
  __syncthreads();

  // 4. y[s] = o[t_h^-1[s]], then WHT / q
  if (lane)
    for (int i = 0; i < dc; ++i)
      dst[i * q + u] = src[i * q + tinv_tab[h[i] * q + u]];
  float* a = dst;
  float* b = src;
  wht_rows(a, b, dc, q, u);

  // 5. probabilities -> costs, minus their min
  if (lane)
    for (int i = 0; i < dc; ++i) {
      const float p = fmaxf(a[i * q + u] / static_cast<float>(q), kOutFloor);
      a[i * q + u] = -logf(fmaxf(p, kPFloor));
    }
  reduce_rows<true>(a, red, dc, q, u, nw);
  if (lane)
    for (int i = 0; i < dc; ++i)
      y[i * q + u] = h[i] == 0 ? 0.0f : a[i * q + u] - read_min(red, i, nw);
}

int block_threads(int q) { return q < 32 ? 32 : q; }

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes (ops/cuda_spa.smem_bytes).
long long spa_checknode_smem_bytes(int dc, int q) {
  return 4LL * (2LL * dc * q + 1LL * dc * (block_threads(q) / 32));
}

// mvc, out: device pointers to [T, dc, q] contiguous float32; coefs:
// [G, dc] int32 with T % G == 0; t_tab, tinv_tab: [q, q] uint8.  Requires
// q a power of two <= 256 and dc >= 2.  Launches on `stream`, does not
// synchronise, returns cudaGetLastError().
int spa_checknode_launch(const float* mvc, const int* coefs,
                         const uint8_t* t_tab, const uint8_t* tinv_tab,
                         float* out, long long T, int G, int dc, int q,
                         void* stream) {
  if (T <= 0) return 0;
  const long long smem = spa_checknode_smem_bytes(dc, q);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        spa_checknode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  spa_checknode_kernel<<<static_cast<unsigned>(T), block_threads(q),
                         static_cast<size_t>(smem),
                         static_cast<cudaStream_t>(stream)>>>(
      mvc, coefs, t_tab, tinv_tab, out, G, dc, q);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
