// The 2-D and 4-D demappers: per received symbol, the cost of every
// constellation point, min-normalised (K8).
//
// Replaces the XLA ops of ems_nbldpc_tpu/models/channels.py channel_2d
// (the distance, :251-258) and qam256_4d (the two products against the
// table, :335-342), which the TPU fused.  In eager torch the 2-D form makes
// [F, N, q, 2] f32 temporaries (2.1 GB each at F = 128, N = 8100,
// q = 256).  For rows r < R (one row a received symbol, R = F * N) and
// candidates g < q, with inv = float32(1 / (2 sigma^2)):
//
// * direct form (the 2-D path, D = 2), in the order of the plain version
//   models/channels.py demap_2d_plain:
//     t_d = y[r,d] - att[r,d] * x[g,d];  s = t_0^2 + t_1^2;  c = s * inv
// * expanded form (the 4-D path, D = 4), as demap_4d_plain:
//     cross = sum_d (att[r,d] * y[r,d]) * x[g,d]
//     pw    = sum_d (att[r,d] * att[r,d]) * (x[g,d] * x[g,d])
//     c = (pw - 2 * cross) * inv            (sums in the order d = 0..3)
// * then out[r, g] = c_g - min_g c_g.
//
// Every product, sum and difference is one IEEE-rounded operation
// (__fmul_rn / __fadd_rn / __fsub_rn), so nvcc contracts none into an FMA
// and the kernel equals its plain version bit for bit.  An erased
// component (att = 0) adds the same term to every candidate; it stays in
// the sum, as in the plain version.
//
// What bounds it on an H100 (3.35 TB/s; 67 TFLOP/s f32 outside the tensor
// cores): the [F, N, q] f32 output.  At [128, 8100, 256] it writes
// 1.062 GB and reads 2 * R * D * 4 B of y and att: 0.3219 ms (D = 2) and
// 0.3268 ms (D = 4); ~10 operations a cost are 2.7 GFLOP (0.04 ms).
//
// What the design does about it: it writes the output once and reads
// nothing else of size.  One warp per row for q >= 32 (lane l holds
// candidates c * 32 * VEC + l * VEC + v, so each store of a warp is a
// contiguous 16-byte-per-lane run, float4 for q >= 128); for q < 32 the
// warp is 32 / q groups of q lanes, one row each.  Each lane keeps its
// candidates' points (and, expanded, their squares) in registers for the
// whole grid-stride loop, so the table is read once a warp; y and att are
// read once a row (one broadcast load a lane); the row minimum is a
// __shfl_xor_sync reduction within the row's lanes.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int kThreads = 256;

// Launches of demap_kernel on this device, counted by the kernel itself
// (one thread of its first block adds one; demap_launches).
__device__ unsigned long long g_launches = 0;

template <int N>
struct Vec;
template <>
struct Vec<1> {
  static __device__ void store(float* p, const float* v) { p[0] = v[0]; }
};
template <>
struct Vec<2> {
  static __device__ void store(float* p, const float* v) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
};
template <>
struct Vec<4> {
  static __device__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// G lanes a row, PER candidates a lane (q = G * PER), D dimensions.
template <int D, bool EXPANDED, int G, int PER>
__global__ void __launch_bounds__(kThreads)
    demap_kernel(const float* __restrict__ y, const float* __restrict__ att,
                 const float* __restrict__ table, const float inv,
                 float* __restrict__ out, const long long rows) {
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&g_launches, 1ULL);
  constexpr int Q = G * PER;
  constexpr int VEC = PER < 4 ? PER : 4;
  constexpr int RPW = 32 / G;  // rows a warp
  const int lane = threadIdx.x & 31;
  const int sub = lane % G;
  const int grp = lane / G;

  // this lane's candidates and, for the expanded form, their squares
  float pt[PER][D];
  float p2[PER][D];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int g = (i / VEC) * G * VEC + sub * VEC + i % VEC;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      pt[i][d] = __ldg(table + g * D + d);
      p2[i][d] = __fmul_rn(pt[i][d], pt[i][d]);
    }
  }

  const long long warp =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long stride =
      (static_cast<long long>(gridDim.x) * kThreads >> 5) * RPW;
  // base depends on the warp only: every lane runs the same iterations
  for (long long base = warp * RPW; base < rows; base += stride) {
    const long long r = base + grp;
    const bool live = r < rows;
    float yv[D], av[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      yv[d] = live ? __ldg(y + r * D + d) : 0.0f;
      av[d] = live ? __ldg(att + r * D + d) : 0.0f;
    }
    float cost[PER];
    float m = INFINITY;
    if (EXPANDED) {
      float ay[D], a2[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        ay[d] = __fmul_rn(av[d], yv[d]);
        a2[d] = __fmul_rn(av[d], av[d]);
      }
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        float cross = __fmul_rn(ay[0], pt[i][0]);
        float pw = __fmul_rn(a2[0], p2[i][0]);
#pragma unroll
        for (int d = 1; d < D; ++d) {
          cross = __fadd_rn(cross, __fmul_rn(ay[d], pt[i][d]));
          pw = __fadd_rn(pw, __fmul_rn(a2[d], p2[i][d]));
        }
        cost[i] = __fmul_rn(__fsub_rn(pw, __fmul_rn(2.0f, cross)), inv);
        m = fminf(m, cost[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        float s = 0.0f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const float t = __fsub_rn(yv[d], __fmul_rn(av[d], pt[i][d]));
          const float sq = __fmul_rn(t, t);
          s = d == 0 ? sq : __fadd_rn(s, sq);
        }
        cost[i] = __fmul_rn(s, inv);
        m = fminf(m, cost[i]);
      }
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      m = fminf(m, __shfl_xor_sync(FULL, m, off));
    if (live) {
      float* row = out + r * Q;
#pragma unroll
      for (int c = 0; c < PER / VEC; ++c) {
        float v[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) v[k] = __fsub_rn(cost[c * VEC + k], m);
        Vec<VEC>::store(row + c * G * VEC + sub * VEC, v);
      }
    }
  }
}

template <int D, bool EXPANDED, int G, int PER>
int launch(const float* y, const float* att, const float* table, float inv,
           float* out, long long rows, cudaStream_t stream) {
  auto kernel = demap_kernel<D, EXPANDED, G, PER>;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long rows_per_block = (kThreads / 32) * (32 / G);
  long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      y, att, table, inv, out, rows);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool EXPANDED>
int dispatch(const float* y, const float* att, const float* table, float inv,
             float* out, long long rows, int q, cudaStream_t s) {
  switch (q) {
    case 2: return launch<D, EXPANDED, 2, 1>(y, att, table, inv, out, rows, s);
    case 4: return launch<D, EXPANDED, 4, 1>(y, att, table, inv, out, rows, s);
    case 8: return launch<D, EXPANDED, 8, 1>(y, att, table, inv, out, rows, s);
    case 16: return launch<D, EXPANDED, 16, 1>(y, att, table, inv, out, rows, s);
    case 32: return launch<D, EXPANDED, 32, 1>(y, att, table, inv, out, rows, s);
    case 64: return launch<D, EXPANDED, 32, 2>(y, att, table, inv, out, rows, s);
    case 128: return launch<D, EXPANDED, 32, 4>(y, att, table, inv, out, rows, s);
    case 256: return launch<D, EXPANDED, 32, 8>(y, att, table, inv, out, rows, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// out[r, g] for rows r < rows and candidates g < q (see the top of this
// file).  y, att: [rows, D] contiguous float32; table: [q, D] float32;
// out: [rows, q] float32, 16-byte aligned.  dims = 2 runs the direct form,
// dims = 4 the expanded form; q a power of two, 2 <= q <= 256.  Launches
// on `stream`, does not synchronise, returns a CUDA error code (0 =
// launched; nothing is launched for rows = 0).
int demap_launch(const float* y, const float* att, const float* table,
                 float inv, float* out, long long rows, int dims, int q,
                 void* stream) {
  if (rows < 0 || (dims != 2 && dims != 4) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dims == 2) return dispatch<2, false>(y, att, table, inv, out, rows, q, s);
  return dispatch<4, true>(y, att, table, inv, out, rows, q, s);
}

// The kernel's launches on the current device since the library was loaded
// or last reset (counted on the device).  Synchronises the device.
int demap_launches(unsigned long long* out) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(out, g_launches, sizeof(g_launches));
  return static_cast<int>(e);
}

// Set the count of demap_launches to 0.  Synchronises the device.
int demap_reset_launches() {
  const unsigned long long zero = 0;
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(g_launches, &zero, sizeof(zero));
  return static_cast<int>(e);
}

}  // extern "C"
