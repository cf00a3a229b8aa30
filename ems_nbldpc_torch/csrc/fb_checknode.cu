// Forward/backward nm-truncated EMS check node, one row per block.
//
// Replaces the Pallas TPU kernel ems_nbldpc_tpu/ops/pallas_cn.py
// (fb_checknode_pallas, body _cn_kernel).  Computes, for every row of
// vr [T, dc, q] (rotated VN-to-CN messages, min-cost, INF outside each
// message's nm best), the dc extrinsic outputs [T, dc, q] of the check
// node built from truncated tropical XOR-convolutions
//
//     combine(acc, list)[s] = min_j lv[j] + acc[s ^ lg[j]],
//
// with (lv, lg) the nm best (value, GF id) pairs of the incoming side:
//   F[0] = in[0],    F[k] = combine(F[k-1], list(in[k]))   k = 1..dc-2
//   B[dc-1] = in[dc-1], B[k] = combine(B[k+1], list(in[k]))  k = dc-2..1
//   out[0] = B[1],  out[dc-1] = F[dc-2],
//   out[i] = combine(F[i-1], list(B[i+1]))                  i = 1..dc-2.
// This is the meaning of ops/minconv.fb_checknode_topk (its plain torch
// version), which the kernel matches bit for bit: each candidate is one
// f32 add, min is exact, and the lists have the same order.
//
// Design.  One block per row and q threads; thread s owns output symbol s.
// The row's accumulators F and B and its 2(dc-2) lists live in shared
// memory (about 7 KB at dc = 4, q = 256, nm = 32).  The TPU version took
// its lists from XLA top_k outside the kernel, and ran the backward chain
// a second time in XLA, because top_k inside Mosaic was expensive; here
// the block selects its own lists by rank: thread s counts the entries s'
// with v[s'] < v[s], or v[s'] == v[s] and s' < s, and if that rank is
// below nm it writes (v[s], s) to slot rank.  That is lax.top_k's order
// (ascending, lower GF id first among equal values) with no sync rounds.
// The XOR gather acc[s ^ g] is a shared-memory load: for fixed g it
// permutes the low five bits of s within a warp, so it has no bank
// conflicts.
//
// What bounds it.  Rank selection costs q compares per thread per list,
// O(q^2) per list per row, 2(dc-2) lists per row: about 45 G compares per
// super-layer at T = 172,800, dc = 4, q = 256.  The kernel is therefore
// bound by shared-memory loads and integer/compare issue, not by device
// memory (it reads and writes 4 KB per row once): 18.36 ms per call at
// that shape on an NVIDIA H100 80GB HBM3 at a 700 W power limit, about
// 2.5 T compares/s, where its 1.4 GB of reads and writes would take
// 0.42 ms at the card's 3.35 TB/s.  Making it fast (sort
// networks, several rows per block, fusing the gather, rotation and
// truncation around it) is later work.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void select_rank(const float* v, int q, int nm,
                                            int s, float* lv, int* lg) {
  const float x = v[s];
  int rank = 0;
#pragma unroll 8
  for (int t = 0; t < q; ++t) {
    const float y = v[t];
    rank += (y < x) || (y == x && t < s);
  }
  if (rank < nm) {
    lv[rank] = x;
    lg[rank] = s;
  }
}

__device__ __forceinline__ float combine(const float* acc, const float* lv,
                                         const int* lg, int nm, int s) {
  float out = lv[0] + acc[s ^ lg[0]];
  for (int j = 1; j < nm; ++j) out = fminf(out, lv[j] + acc[s ^ lg[j]]);
  return out;
}

__global__ void fb_checknode_kernel(const float* __restrict__ vr,
                                    float* __restrict__ out, int dc, int q,
                                    int nm) {
  extern __shared__ float smem[];
  const int L = dc - 2;                 // number of middle slots
  float* F = smem;                      // F[k] at F + k*q, k = 0..dc-2
  float* B = F + (dc - 1) * q;          // B[k] at B + (k-1)*q, k = 1..dc-1
  float* lv = B + (dc - 1) * q;         // 2L lists of nm values
  int* lg = reinterpret_cast<int*>(lv + 2 * L * nm);  // and their GF ids
  // list slot k-1 = list(in[k]), k = 1..dc-2; slot L+k-2 = list(B[k]),
  // k = 2..dc-1

  const int s = threadIdx.x;
  const size_t row = blockIdx.x;
  const float* x = vr + row * dc * q;
  float* y = out + row * dc * q;

  // in[k] for k = 1..dc-2 is parked in F[k]'s slot until its list is
  // taken; F[k] overwrites it in the chain below.
  for (int k = 0; k < dc - 1; ++k) F[k * q + s] = x[k * q + s];
  B[(dc - 2) * q + s] = x[(dc - 1) * q + s];
  __syncthreads();

  for (int k = 1; k <= L; ++k)
    select_rank(F + k * q, q, nm, s, lv + (k - 1) * nm, lg + (k - 1) * nm);
  __syncthreads();

  // forward and backward chains, one step of each per sync; step `st`
  // reads F[st-1] and B[kb+1] and writes F[st] and B[kb], so no thread
  // reads what another writes within a step
  for (int st = 1; st <= L; ++st) {
    const int kb = dc - 1 - st;
    const float f = combine(F + (st - 1) * q, lv + (st - 1) * nm,
                            lg + (st - 1) * nm, nm, s);
    const float b = combine(B + kb * q, lv + (kb - 1) * nm,
                            lg + (kb - 1) * nm, nm, s);
    F[st * q + s] = f;
    B[(kb - 1) * q + s] = b;
    __syncthreads();
  }

  for (int k = 2; k <= dc - 1; ++k)
    select_rank(B + (k - 1) * q, q, nm, s, lv + (L + k - 2) * nm,
                lg + (L + k - 2) * nm);
  __syncthreads();

  y[s] = B[s];                                   // out[0] = B[1]
  y[(dc - 1) * q + s] = F[(dc - 2) * q + s];     // out[dc-1] = F[dc-2]
  for (int i = 1; i <= L; ++i)
    y[i * q + s] = combine(F + (i - 1) * q, lv + (L + i - 1) * nm,
                           lg + (L + i - 1) * nm, nm, s);
}

// Dynamic shared memory of one block, in bytes (ops/cuda_cn.smem_bytes).
long long smem_bytes(int dc, int q, int nm) {
  return 4LL * (2LL * (dc - 1) * q + 4LL * (dc - 2) * nm);
}

}  // namespace

extern "C" {

// vr, out: device pointers to [T, dc, q] contiguous float32.  Requires
// q a power of two <= 256 (one thread per symbol), dc >= 3, 1 <= nm <= q.
// Launches on `stream`, does not synchronise, returns cudaGetLastError().
int fb_checknode_launch(const float* vr, float* out, long long T, int dc,
                        int q, int nm, void* stream) {
  if (T <= 0) return 0;
  const long long smem = smem_bytes(dc, q, nm);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fb_checknode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fb_checknode_kernel<<<static_cast<unsigned>(T), q,
                        static_cast<size_t>(smem),
                        static_cast<cudaStream_t>(stream)>>>(vr, out, dc, q,
                                                             nm);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
