// The layered decoders' hard decisions: the argmin over q of each APP row
// of the active frames, written in place (K4).
//
// Replaces the XLA argmin of ems_nbldpc_tpu/decoder/layered.py (:250,
// :328, :711: jnp.argmin over the APP, then jnp.where on the active
// frames; no Pallas kernel there).  For every frame f with active[f] (every
// frame when active is null: the reset) and every variable v < N:
//     decide[f, v] = argmin_a app[f, v, a]
// with torch.argmin's rule: the lowest index among equal minima (-0 equals
// +0), and a NaN is the minimum (the first NaN wins).  Frames with
// !active[f] are neither read nor written: their decisions stay latched, as
// torch.where(active[:, None], argmin, decide) leaves them.  The APP is
// [F, app_rows, q] (app_rows = N + 1 in the decoders: the padding column
// is not read), float32 or bfloat16 (widened to f32 exactly, bit shifts);
// decide is [F, N] int64.
//
// What bounds it on an H100 (3.35 TB/s): the bytes.  A step reads the APP
// rows of the active frames once and writes their decisions once:
// active * N * (q * elem + 8) bytes: with every frame active at N = 8100,
// q = 256, 8.56 GB at F = 1024 f32 (2.555 ms) and 8.63 GB at F = 2048 bf16
// (2.575 ms); about 5 operations a symbol are far below the card's rate.
// The torch route it replaces read every frame's rows every step,
// converged or not, and made [F, N] int64 temporaries.
//
// What the design does about it.
// * One warp per (frame, variable) row at q = 256 (32 lanes x 32 bytes of
//   f32, 2 x 16-byte vectors a lane; bf16 one vector), 32 / L rows of L
//   lanes below; 16-byte vector loads (8 bytes: a bf16 row at q = 4),
//   streaming (ld.global.cs: each byte is read once a step).
// * A work item is a chunk of U row-groups of one frame (U * 16 bytes a
//   lane: 128 bytes in flight per lane, 4 KB per warp), all loaded before
//   the first shuffle.  A lane scans its symbols in index order with a
//   strict <, then L-lane butterflies of (value, index) pick the lowest
//   index among equal minima.  A NaN, rare, sends its warp's item through
//   a second scan with torch's NaN rule (one NaN-aware scan and butterfly
//   for every item ran 11% slower on bf16 rows at q = 256, 0.5% on f32,
//   H100 80GB HBM3 at 700 W).
// * A persistent grid (the SMs times the resident blocks, fixed for a
//   shape, so a CUDA graph holds it) walks the items frame-major with a
//   stride; a warp finds its next item of an active frame 32 strides at a
//   time (one load of active[] a lane and a ballot), so frozen frames cost
//   no APP read and a step with a handful of active frames a few
//   microseconds.
// * Counters on the device: launches (one thread of the first block) and
//   the rows decided (one atomic a block), so a run can show the frozen
//   frames skipped.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int kWarps = 8;  // warps a block
constexpr int kThreads = 32 * kWarps;

// Launches of decide_kernel on this device and the (frame, variable) rows
// it decided, counted by the kernel itself (decide_counts).
__device__ unsigned long long g_launches = 0;
__device__ unsigned long long g_rows = 0;

struct bf16_t {
  uint16_t bits;
};

struct Params {
  const void* app;          // [F, app_rows, q]
  long long* decide;        // [F, N]
  const uint8_t* active;    // [F] (0 = frozen) or null: every frame
  long long app_frame;      // app_rows * q, elements
  int N;
  int cpf;                  // items a frame
  int T;                    // items: F * cpf
};

// The layout of one row for element type ST at q = Q.
template <class ST, int Q>
struct Row {
  static constexpr int ELEM = sizeof(ST);
  static constexpr int V = 16 / ELEM < Q ? 16 / ELEM : Q;  // symbols a load
  static constexpr int L = Q / V < 32 ? Q / V : 32;        // lanes a row
  static constexpr int PER = Q / (L * V);                  // loads a lane
  static constexpr int G = 32 / L;                         // rows a warp
  static constexpr int U = 8 / PER;                        // row-groups
  static constexpr int RPI = G * U;                        // rows an item
  static constexpr int VB = V * ELEM;                      // bytes a load
};

template <int VB>
struct Load;
template <>
struct Load<16> {
  static constexpr int WORDS = 4;
  static __device__ __forceinline__ void get(const void* p, uint32_t* w) {
    const uint4 v = __ldcs(reinterpret_cast<const uint4*>(p));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  }
};
template <>
struct Load<8> {
  static constexpr int WORDS = 2;
  static __device__ __forceinline__ void get(const void* p, uint32_t* w) {
    const uint2 v = __ldcs(reinterpret_cast<const uint2*>(p));
    w[0] = v.x;
    w[1] = v.y;
  }
};

// Symbol k of a lane's loaded words, widened to f32 (exact).
template <class ST>
__device__ __forceinline__ float symbol(const uint32_t* w, int k) {
  if constexpr (sizeof(ST) == 4) {
    return __uint_as_float(w[k]);
  } else {
    const uint32_t x = w[k >> 1];
    return __uint_as_float((k & 1) ? (x & 0xffff0000u) : (x << 16));
  }
}

// torch.argmin's order of (value, index) pairs, NaN first: does (v, i)
// come before (bv, bi)?
__device__ __forceinline__ bool before_nan(float v, int i, float bv, int bi) {
  const bool vn = v != v, bn = bv != bv;
  if (vn || bn) return vn && (!bn || i < bi);
  return v < bv || (v == bv && i < bi);
}

// The first item at or after t (stride nw) of an active frame, or one
// >= p.T; warp-uniform.  Lane l looks at t + l * nw.
__device__ __forceinline__ int next_item(const Params& p, int t, int nw,
                                         int lane) {
  if (!p.active) return t;
  while (t < p.T) {
    const int tl = t + lane * nw;
    const bool hit = tl >= p.T || __ldg(p.active + tl / p.cpf) != 0;
    const unsigned m = __ballot_sync(FULL, hit);
    if (m) return t + (__ffs(m) - 1) * nw;
    t += 32 * nw;
  }
  return t;
}

template <class ST, int Q>
__global__ void __launch_bounds__(kThreads)
    decide_kernel(const Params p) {
  using R = Row<ST, Q>;
  using LD = Load<R::VB>;
  constexpr int L = R::L, PER = R::PER, G = R::G, U = R::U;
  constexpr int K = PER * R::V;  // symbols a lane holds of a row
  __shared__ unsigned long long block_rows;
  if (threadIdx.x == 0) block_rows = 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&g_launches, 1ULL);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lg = lane % L, grp = lane / L;
  const int nw = gridDim.x * kWarps;
  const ST* app = static_cast<const ST*>(p.app);
  long long rows = 0;
  for (int t = next_item(p, blockIdx.x * kWarps + warp, nw, lane); t < p.T;
       t = next_item(p, t + nw, nw, lane)) {
    const int f = t / p.cpf;
    const int row0 = (t - f * p.cpf) * R::RPI;
    const ST* frame = app + static_cast<long long>(f) * p.app_frame;
    uint32_t w[U][PER][LD::WORDS];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int v = row0 + u * G + grp;
      if (v < p.N) {
        const ST* row = frame + static_cast<long long>(v) * Q;
#pragma unroll
        for (int c = 0; c < PER; ++c)
          LD::get(row + (c * L + lg) * R::V, w[u][c]);
      } else {
#pragma unroll
        for (int c = 0; c < PER; ++c)
#pragma unroll
          for (int j = 0; j < LD::WORDS; ++j) w[u][c][j] = 0;
      }
    }
    float bv[U];
    int bk[U];
    bool nan = false;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      bv[u] = symbol<ST>(w[u][0], 0);
      bk[u] = 0;
      nan |= bv[u] != bv[u];
#pragma unroll
      for (int k = 1; k < K; ++k) {
        const float x = symbol<ST>(w[u][k / R::V], k % R::V);
        nan |= x != x;
        if (x < bv[u]) {
          bv[u] = x;
          bk[u] = k;
        }
      }
    }
    // lane-local index k -> the symbol's index in the row
    int bi[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      bi[u] = ((bk[u] / R::V) * L + lg) * R::V + bk[u] % R::V;
    if (__any_sync(FULL, nan)) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        bv[u] = symbol<ST>(w[u][0], 0);
        bi[u] = lg * R::V;
#pragma unroll
        for (int k = 1; k < K; ++k) {
          const float x = symbol<ST>(w[u][k / R::V], k % R::V);
          const int i = ((k / R::V) * L + lg) * R::V + k % R::V;
          if (before_nan(x, i, bv[u], bi[u])) {
            bv[u] = x;
            bi[u] = i;
          }
        }
      }
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1)
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float ov = __shfl_xor_sync(FULL, bv[u], off);
          const int oi = __shfl_xor_sync(FULL, bi[u], off);
          if (before_nan(ov, oi, bv[u], bi[u])) {
            bv[u] = ov;
            bi[u] = oi;
          }
        }
    } else {
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1)
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float ov = __shfl_xor_sync(FULL, bv[u], off);
          const int oi = __shfl_xor_sync(FULL, bi[u], off);
          if (ov < bv[u] || (ov == bv[u] && oi < bi[u])) {
            bv[u] = ov;
            bi[u] = oi;
          }
        }
    }
    long long* out = p.decide + static_cast<long long>(f) * p.N;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int v = row0 + u * G + grp;
      if (lg == 0 && v < p.N) out[v] = bi[u];
    }
    const int left = p.N - row0;
    rows += left < R::RPI ? left : R::RPI;
  }
  if (lane == 0 && rows)
    atomicAdd(&block_rows, static_cast<unsigned long long>(rows));
  __syncthreads();
  if (threadIdx.x == 0 && block_rows) atomicAdd(&g_rows, block_rows);
}

template <class ST, int Q>
int launch(const void* app, long long* decide, const uint8_t* active,
           long long F, long long app_rows, int N, void* stream) {
  using R = Row<ST, Q>;
  if (reinterpret_cast<uintptr_t>(app) % R::VB != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long cpf = (N + R::RPI - 1) / R::RPI;
  const long long T = F * cpf;
  // t + 32 * nw stays an int (nw < 2^20 warps)
  if (T >= (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return 0;
  Params p;
  p.app = app;
  p.decide = decide;
  p.active = active;
  p.app_frame = app_rows * Q;
  p.N = N;
  p.cpf = static_cast<int>(cpf);
  p.T = static_cast<int>(T);
  auto kern = decide_kernel<ST, Q>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                    0);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long need = (T + kWarps - 1) / kWarps;
  const long long resident = static_cast<long long>(sms) * per_sm;
  const unsigned grid =
      static_cast<unsigned>(need < resident ? need : resident);
  kern<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <class ST>
int dispatch(const void* app, long long* decide, const uint8_t* active,
             long long F, long long app_rows, int N, int q, void* stream) {
  if (F < 0 || N < 0 || app_rows < N)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (q) {
    case 4: return launch<ST, 4>(app, decide, active, F, app_rows, N, stream);
    case 8: return launch<ST, 8>(app, decide, active, F, app_rows, N, stream);
    case 16: return launch<ST, 16>(app, decide, active, F, app_rows, N, stream);
    case 32: return launch<ST, 32>(app, decide, active, F, app_rows, N, stream);
    case 64: return launch<ST, 64>(app, decide, active, F, app_rows, N, stream);
    case 128:
      return launch<ST, 128>(app, decide, active, F, app_rows, N, stream);
    case 256:
      return launch<ST, 256>(app, decide, active, F, app_rows, N, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// decide[f, v] = argmin_a app[f, v, a] for v < N of every frame f with
// active[f] (see the top of this file).  app: [F, app_rows, q] contiguous
// float32, app_rows >= N, aligned to 16 bytes; decide: [F, N]
// contiguous int64; active: [F] bytes (0 = frozen), or null for every
// frame; q a power of two in 4..256.  Launches on `stream`, does not synchronise, returns a
// CUDA error code (0 = launched; nothing is launched for F * N = 0).
int decide_launch(const float* app, long long* decide, const uint8_t* active,
                  long long F, long long app_rows, int N, int q,
                  void* stream) {
  return dispatch<float>(app, decide, active, F, app_rows, N, q, stream);
}

// The same on a bfloat16 APP, aligned to 16 bytes (8 at q = 4).
int decide_bf16_launch(const void* app, long long* decide,
                       const uint8_t* active, long long F, long long app_rows,
                       int N, int q, void* stream) {
  return dispatch<bf16_t>(app, decide, active, F, app_rows, N, q, stream);
}

// The kernel's launches and the rows it decided on the current device since
// the library was loaded or last reset (counted on the device).
// Synchronises the device.
int decide_counts(unsigned long long* launches, unsigned long long* rows) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(launches, g_launches, sizeof(g_launches));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(rows, g_rows, sizeof(g_rows));
  return static_cast<int>(e);
}

// Set both counts of decide_counts to 0.  Synchronises the device.
int decide_reset_counts() {
  const unsigned long long zero = 0;
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(g_launches, &zero, sizeof(zero));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_rows, &zero, sizeof(zero));
  return static_cast<int>(e);
}

}  // extern "C"
