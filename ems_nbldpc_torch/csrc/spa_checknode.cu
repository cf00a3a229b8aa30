// The sum-product (SPA) check node over GF(q), q = 2^m, one warp per row,
// and the whole layered SPA super-layer step around it in one launch.
//
// Replaces the XLA op ems_nbldpc_tpu/ops/fht.py:249 fb_checknode_spa_fused
// (no Pallas kernel there: XLA lowered it as grouped Hadamard matmuls),
// together with the gathers, normalisation, freeze and scatters around its
// layered call site (ems_nbldpc_tpu/decoder/layered.py:127-137).  Two entry
// points share one device-side row routine:
//
// * spa_layer_launch: one super-layer of the layered sweep, in place on the
//   decoder state APP [F, N+1, q] and CtoV [F, E+1, q] (f32):
//     for each frame f with active[f], each row r < G of the layer:
//       mvc_i = APP[f, cols[r,i]] - CtoV[f, edges[r,i]];  mvc_i -= min mvc_i
//       mcv   = SPA_CN(mvc, coefs[r])
//       CtoV[f, edges[r,i]] = mcv_i;  APP[f, cols[r,i]] = mvc_i + mcv_i
//   Frames with !active[f] are neither read nor written.
// * spa_checknode_launch: the bare CN on gathered rows mvc [T, dc, q] with
//   coefficients coefs[t % G] -> out [T, dc, q] (the flooding schedule).
//
// SPA_CN, in the order of steps of its plain version ops/fht.py
// spa_checknode_plain:
//   1. p_i = exp(-min(c_i - min c_i, 60)), then p_i /= sum p_i;
//   2. w_i[u] = WHT(p_i)[t_h[u]]  (the GF rotation folded into the
//      transform: t_h = fht.mul_transpose_perm(h));
//   3. o_i = prod_{j != i} w_j    (forward/backward products, with the
//      association of fht._fb_products);
//   4. y_i[s] = o_i[t_h^-1[s]], then out_i = WHT(y_i) / q;
//   5. -log(max(max(out_i, 1e-30), f32(exp(-60)))), minus its min.
// A padding slot (h = 0) transforms to the neutral w = sum(p) = 1 (t_0 = 0)
// and its output is 0.  In the fused step the min subtracted in step 1 is
// the normalisation of mvc itself, and the sweep's second normalisation of
// the output (min 0 already) is left out: both were exact no-ops.  p_i /=
// sum is taken as p_i * (1 / sum), one rounding more (<= 1 ulp); expf and
// logf are the accurate ones (no fast math): the inverse transform cancels
// q terms of O(1) down to probabilities near 1e-26.
//
// In place is safe.  A super-layer's rows share no column and no edge, so
// each element of APP and CtoV has one reader-writer, except the padding
// column N and edge E, which padded slots (coefficient 0) all read and
// write: they hold 0, and a padded slot writes back mvc = 0 - 0 and
// mcv = 0, so the concurrent accesses see and store the same zeros, as the
// torch sweep's scatters do.  So the warps may stage and write back their
// rows in any order.
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores).  The layered call [F = 128, 1350 rows, dc = 4, q = 256] must read
// the APP and CtoV rows once and write both once, 2.83 GB: 0.845 ms; its
// transforms and exp/log are ~22 operations a symbol, 3.9 GFLOP (0.06 ms).
// Device memory bounds it.  The tensor cores cannot help: TF32 keeps too
// few digits for the inverse transform, and a WHT is 16 adds a symbol.
// The earlier kernel (one 256-thread block per row, every butterfly stage
// through shared memory, 25 block-wide syncs a row, torch passes around
// it) ran the CN alone at 4.02 ms on an NVIDIA H100 80GB HBM3 at 700 W,
// ten times its own floor: instruction throughput, not memory, limited it.
//
// What this design does about it.
// * One warp per row, no block-wide sync.  Lane l holds VEC = min(PER, 4)
//   consecutive symbols of a message in each of PER / VEC chunks of
//   32 * VEC (at q = 256: symbols 4l..4l+3 and 128+4l..128+4l+3, two
//   16-byte vectors), so 3 of the 8 butterfly stages are register-only and
//   5 are __shfl_xor_sync exchanges; a min or a sum is 5 shuffles.  For
//   q < 32 the warp is 32 / q groups of q lanes, one message each.
// * t_h and t_h^-1 are GF(2)-linear, so a symbol's source index is the XOR
//   of the images of its lane bits and its register bits: the block keeps
//   8 bytes of basis images per coefficient in shared memory and reads no
//   256-byte table row.  The permuted exchange goes through the warp's
//   own shared memory (__syncwarp only), which also holds the
//   transform-domain messages for the products.
// * A persistent grid walks the active rows; each warp stages a row's
//   2 dc message rows (1 KB each at q = 256) with cp.async into one row
//   buffer, and many resident warps cover the latency (18 an SM at dc = 4,
//   q = 256: 12 KB of shared memory a warp).  The next row's CtoV rows
//   stage during this row's inverse transforms, into the half of the
//   buffer the products have freed, and its APP rows after the write-back.
//   The launcher picks the warps per block that let the most warps reside.
// * Streaming stores for the write-back: the state (3.2 GB at F = 128) is
//   read again only a super-layer later, long out of the 50 MB L2.
//
// Where it stands (chip_smoke.py phase 3b and chip_variants.py, NVIDIA H100
// 80GB HBM3, 700 W): 1.215 ms per layered call at F = 128, 70% of the
// 0.845 ms bound, against 9.6 ms for the torch route it replaces; the bare
// entry 0.87 ms on the same 172,800 gathered rows.  With the exp/log,
// transforms and permutations removed the call still takes 1.045 ms, so
// the memory traffic of the gathered 1 KB rows (2.7 TB/s) limits it, and
// the math adds ~0.16 ms the resident warps do not hide.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float kLogEps = 60.0f;             // fht._LOG_EPS
constexpr float kPFloor = 0x1.5ae192p-87f;   // float32(exp(-60))
constexpr float kOutFloor = 1e-30f;
constexpr int kSmemLimit = 232448;           // shared memory a block may use
constexpr int kMaxWarps = 16;                // warps per block to try

// Launches of spa_row_kernel on this device, [0] of the bare entry and [1]
// of the fused one, counted by the kernel itself, so that the launches a
// CUDA graph replays count too (spa_launches).
__device__ unsigned long long g_launches[2] = {0, 0};

struct Params {
  float* app;                  // fused: state [F, N+1, q]
  float* ctov;                 // fused: state [F, E+1, q]
  long long app_frame;         // floats per frame of app, ctov
  long long ctov_frame;
  unsigned app_rows;           // rows per frame of app, ctov
  unsigned ctov_rows;
  const uint8_t* active;       // fused: [F] (0 = frozen)
  const int* cols;             // fused: [G, dc] columns of APP
  const int* edges;            // fused: [G, dc] edges of CtoV
  const float* x;              // bare: [T, dc, q] input rows
  float* out;                  // bare: [T, dc, q] output rows
  const int* coefs;            // [G, dc] (0 = padding slot)
  const uint8_t* t_tab;        // [q, q] fht.transpose_perm_tables
  const uint8_t* tinv_tab;
  int T, G, dc, q;
  int vec16;                   // 16-byte copies and vector stores
  int warp_floats;             // floats of one warp's shared memory
};

template <int PER>
struct Layout {
  static constexpr int VEC = PER < 4 ? PER : 4;  // consecutive symbols
  static constexpr int NCH = PER / VEC;          // chunks of 32 * VEC
};

__device__ __forceinline__ float group_min(float v, int lw) {
  for (int o = lw >> 1; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v, int lw) {
  for (int o = lw >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Image of x under a GF(2)-linear index map given by its basis images (byte
// b of bas is the image of 1 << b).
__device__ __forceinline__ unsigned lin_image(unsigned long long bas,
                                              unsigned x) {
  unsigned r = 0;
#pragma unroll
  for (int b = 0; b < 8; ++b)
    if (x >> b & 1u) r ^= static_cast<unsigned>(bas >> (8 * b)) & 0xffu;
  return r;
}

// The register part of the symbol index of register j (chunk stride cs).
template <int PER>
__device__ __forceinline__ unsigned reg_part(int j, int cs) {
  constexpr int VEC = Layout<PER>::VEC;
  return static_cast<unsigned>((j / VEC) * cs + j % VEC);
}

// This lane's symbols of one message row in shared memory: chunk c at
// row + c * cs + off, VEC consecutive floats.
template <int PER>
__device__ __forceinline__ void load_own(const float* row, int off, int cs,
                                         float (&v)[PER]) {
  constexpr int VEC = Layout<PER>::VEC, NCH = Layout<PER>::NCH;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const float* s = row + c * cs + off;
    if (VEC == 4) {
      const float4 a = *reinterpret_cast<const float4*>(s);
      v[4 * c] = a.x;
      v[4 * c + 1] = a.y;
      v[4 * c + 2] = a.z;
      v[4 * c + 3] = a.w;
    } else if (VEC == 2) {
      const float2 a = *reinterpret_cast<const float2*>(s);
      v[2 * c] = a.x;
      v[2 * c + 1] = a.y;
    } else {
      v[c] = s[0];
    }
  }
}

template <int PER>
__device__ __forceinline__ void store_own(float* row, int off, int cs,
                                          const float (&v)[PER]) {
  constexpr int VEC = Layout<PER>::VEC, NCH = Layout<PER>::NCH;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    float* d = row + c * cs + off;
    if (VEC == 4) {
      *reinterpret_cast<float4*>(d) =
          make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
    } else if (VEC == 2) {
      *reinterpret_cast<float2*>(d) = make_float2(v[2 * c], v[2 * c + 1]);
    } else {
      d[0] = v[c];
    }
  }
}

// The same to device memory, with streaming stores; vector stores when
// `vec` (16-byte aligned rows).
template <int PER>
__device__ __forceinline__ void store_global(float* row, int off, int cs,
                                             const float (&v)[PER],
                                             bool vec) {
  constexpr int VEC = Layout<PER>::VEC, NCH = Layout<PER>::NCH;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    float* d = row + c * cs + off;
    if (VEC == 4 && vec) {
      __stcs(reinterpret_cast<float4*>(d),
             make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]));
    } else if (VEC == 2 && vec) {
      __stcs(reinterpret_cast<float2*>(d), make_float2(v[2 * c], v[2 * c + 1]));
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) __stcs(d + k, v[VEC * c + k]);
    }
  }
}

// Unnormalised WHT of one message held as PER symbols a lane over lw lanes
// (H[u, v] = (-1)^popcount(u & v)): the low register bits, then the lane
// bits by shuffles, then the chunk bits.  A pair (lo without bit s, hi with
// it) becomes (lo + hi, lo - hi).
template <int PER>
__device__ __forceinline__ void wht(float (&x)[PER], int lane, int lw) {
  constexpr int VEC = Layout<PER>::VEC;
#pragma unroll
  for (int s = 1; s < VEC; s <<= 1)
#pragma unroll
    for (int j = 0; j < PER; ++j)
      if (!(j & s)) {
        const float a = x[j], b = x[j + s];
        x[j] = a + b;
        x[j + s] = a - b;
      }
#pragma unroll
  for (int o = 1; o < lw; o <<= 1) {
    const float sg = (lane & o) ? -1.0f : 1.0f;  // hi lanes: lo - hi
#pragma unroll
    for (int j = 0; j < PER; ++j)
      x[j] = fmaf(sg, x[j], __shfl_xor_sync(FULL, x[j], o));
  }
#pragma unroll
  for (int s = VEC; s < PER; s <<= 1)
#pragma unroll
    for (int j = 0; j < PER; ++j)
      if (!(j & s)) {
        const float a = x[j], b = x[j + s];
        x[j] = a + b;
        x[j + s] = a - b;
      }
}

// Stage message rows k0 <= k < k1 of row t into S[k] with cp.async, as one
// commit group: fused, k < dc are the APP rows and dc <= k < 2 dc the CtoV
// rows; bare, the dc input rows.  A column or edge out of range traps here,
// before its first use (a device-side fault, as PyTorch's index kernels
// assert), so a bad table never reads or writes outside the state.
template <bool FUSED>
__device__ __forceinline__ void stage(const Params& p, float* S, int t,
                                      int k0, int k1, int lane) {
  const int q = p.q, dc = p.dc;
  const int f = t / p.G, r = t - f * p.G;
  const unsigned dst0 = static_cast<unsigned>(__cvta_generic_to_shared(S));
  for (int k = k0; k < k1; ++k) {
    const float* src;
    if (FUSED) {
      const unsigned idx = static_cast<unsigned>(
          __ldg(k < dc ? p.cols + r * dc + k : p.edges + r * dc + k - dc));
      if (idx >= (k < dc ? p.app_rows : p.ctov_rows)) __trap();
      src = k < dc ? p.app + f * p.app_frame + static_cast<long long>(idx) * q
                   : p.ctov + f * p.ctov_frame +
                         static_cast<long long>(idx) * q;
    } else {
      src = p.x + (static_cast<long long>(t) * dc + k) * q;
    }
    const unsigned dst = dst0 + 4u * k * q;
    if (p.vec16) {
      for (int c = lane; c < q / 4; c += 32)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         dst + 16 * c),
                     "l"(src + 4 * c));
    } else {
      for (int c = lane; c < q; c += 32)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                         dst + 4 * c),
                     "l"(src + c));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The first row at or after t (stride nw) of an active frame.
__device__ __forceinline__ int next_active(const Params& p, int t, int nw) {
  if (p.active)
    while (t < p.T && !__ldg(p.active + t / p.G)) t += nw;
  return t;
}

// One row t: S holds its staged message rows, Bf is the warp's product
// buffer [dc][q], basis the block's [2][q] basis images (t_h, t_h^-1).
// Once the products are taken, the next row tn (if any) starts to stage
// into the part of S that is free: its CtoV rows (fused) or all its rows.
template <int PER, bool FUSED>
__device__ __forceinline__ void spa_row(const Params& p, float* S, float* Bf,
                                        const unsigned long long* basis,
                                        int t, int tn, int lane) {
  constexpr int VEC = Layout<PER>::VEC;
  const int q = p.q, dc = p.dc;
  const int lw = PER == 1 ? (q < 32 ? q : 32) : 32;  // lanes per message
  const int ng = 32 / lw;                            // messages side by side
  const int grp = lane / lw;
  const int off = (lane & (lw - 1)) * VEC;  // lane part of the symbol index
  const int cs = lw * VEC;                  // chunk stride
  const int f = t / p.G, r = t - f * p.G;
  const int* h = p.coefs + r * dc;
  float* A = S;                         // inputs; fused: then mvc
  float* W = FUSED ? S + dc * q : S;    // fused: CtoV rows; then WHT(p_i)

  // 1, 2a: normalise, probabilities, forward transform into W
  for (int i0 = 0; i0 < dc; i0 += ng) {
    const int i = i0 + grp;
    const bool on = i < dc;             // q < 32: groups past dc idle
    float x[PER];
    if (on) {
      load_own<PER>(A + i * q, off, cs, x);
      if (FUSED) {
        float c[PER];
        load_own<PER>(W + i * q, off, cs, c);
#pragma unroll
        for (int j = 0; j < PER; ++j) x[j] = x[j] - c[j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < PER; ++j) x[j] = 0.0f;
    }
    float m = x[0];
#pragma unroll
    for (int j = 1; j < PER; ++j) m = fminf(m, x[j]);
    m = group_min(m, lw);
#pragma unroll
    for (int j = 0; j < PER; ++j) x[j] = x[j] - m;
    if (FUSED && on) store_own<PER>(A + i * q, off, cs, x);
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      x[j] = expf(-fminf(x[j], kLogEps));
      s += x[j];
    }
    const float inv = 1.0f / group_sum(s, lw);
#pragma unroll
    for (int j = 0; j < PER; ++j) x[j] = x[j] * inv;
    wht<PER>(x, lane, lw);
    if (on) store_own<PER>(W + i * q, off, cs, x);
  }
  __syncwarp();

  // 2b, 3: w_i = W_i[t_h], products per symbol (for q < 32 the first group
  // holds every symbol): Bf[i] = prod_{j > i} w_j, then times prod_{j < i};
  // a coefficient out of range traps at its first use
  if (grp == 0) {
    float b[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) b[j] = 1.0f;
    for (int i = dc - 1; i >= 0; --i) {
      const int hi = __ldg(h + i);
      if (static_cast<unsigned>(hi) >= static_cast<unsigned>(q)) __trap();
      const unsigned long long bas = basis[hi];
      const unsigned lt = lin_image(bas, off);
      const float* Wi = W + i * q;
      float w[PER];
#pragma unroll
      for (int j = 0; j < PER; ++j)
        w[j] = Wi[lt ^ lin_image(bas, reg_part<PER>(j, cs))];
      store_own<PER>(Bf + i * q, off, cs, b);
#pragma unroll
      for (int j = 0; j < PER; ++j) b[j] = b[j] * w[j];
    }
    float fw[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) fw[j] = 1.0f;
    for (int i = 0; i < dc; ++i) {
      const unsigned long long bas = basis[__ldg(h + i)];
      const unsigned lt = lin_image(bas, off);
      const float* Wi = W + i * q;
      float o[PER];
      load_own<PER>(Bf + i * q, off, cs, o);
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        o[j] = fw[j] * o[j];
        fw[j] = fw[j] * Wi[lt ^ lin_image(bas, reg_part<PER>(j, cs))];
      }
      store_own<PER>(Bf + i * q, off, cs, o);
    }
  }
  __syncwarp();
  if (tn < p.T) stage<FUSED>(p, S, tn, FUSED ? dc : 0, FUSED ? 2 * dc : dc,
                             lane);

  // 4, 5: y_i = o_i[t_h^-1], inverse transform, costs, write back
  const float invq = 1.0f / static_cast<float>(q);  // exact: q = 2^m
  for (int i0 = 0; i0 < dc; i0 += ng) {
    const int i = i0 + grp;
    const bool on = i < dc;
    const int hi = on ? __ldg(h + i) : 0;
    float y[PER];
    if (on) {
      const unsigned long long bas = basis[q + hi];
      const unsigned lt = lin_image(bas, off);
#pragma unroll
      for (int j = 0; j < PER; ++j)
        y[j] = Bf[i * q + (lt ^ lin_image(bas, reg_part<PER>(j, cs)))];
    } else {
#pragma unroll
      for (int j = 0; j < PER; ++j) y[j] = 1.0f;
    }
    wht<PER>(y, lane, lw);
#pragma unroll
    for (int j = 0; j < PER; ++j)
      y[j] = -logf(fmaxf(fmaxf(y[j] * invq, kOutFloor), kPFloor));
    float m = y[0];
#pragma unroll
    for (int j = 1; j < PER; ++j) m = fminf(m, y[j]);
    m = group_min(m, lw);
#pragma unroll
    for (int j = 0; j < PER; ++j) y[j] = hi == 0 ? 0.0f : y[j] - m;
    if (!on) continue;
    if (FUSED) {
      float mv[PER];
      load_own<PER>(A + i * q, off, cs, mv);
      float* crow = p.ctov + f * p.ctov_frame +
                    static_cast<long long>(__ldg(p.edges + r * dc + i)) * q;
      float* arow = p.app + f * p.app_frame +
                    static_cast<long long>(__ldg(p.cols + r * dc + i)) * q;
      store_global<PER>(crow, off, cs, y, p.vec16);
#pragma unroll
      for (int j = 0; j < PER; ++j) mv[j] = mv[j] + y[j];
      store_global<PER>(arow, off, cs, mv, p.vec16);
    } else {
      store_global<PER>(p.out + (static_cast<long long>(t) * dc + i) * q,
                        off, cs, y, p.vec16);
    }
  }
}

template <int PER, bool FUSED>
__global__ void spa_row_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(&g_launches[FUSED ? 1 : 0], 1ULL);
  const int q = p.q;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;

  // basis images of t_h (entries 0..q-1) and t_h^-1 (q..2q-1), 8 bytes each
  auto* basis = reinterpret_cast<unsigned long long*>(smem_raw);
  for (int e = threadIdx.x; e < 2 * q; e += blockDim.x) {
    const uint8_t* tab = e < q ? p.t_tab + e * q : p.tinv_tab + (e - q) * q;
    unsigned long long b = 0;
    for (int k = 0; (1 << k) < q; ++k)
      b |= static_cast<unsigned long long>(__ldg(tab + (1 << k))) << (8 * k);
    basis[e] = b;
  }
  __syncthreads();

  // the warp's row buffer (2 dc or dc message rows), then its products
  float* S = reinterpret_cast<float*>(smem_raw + 16 * q) +
             static_cast<long long>(warp) * p.warp_floats;
  float* Bf = S + p.warp_floats - p.dc * q;
  const int nw = gridDim.x * wpb;
  int t = next_active(p, blockIdx.x * wpb + warp, nw);
  if (t < p.T) stage<FUSED>(p, S, t, 0, FUSED ? 2 * p.dc : p.dc, lane);
  while (t < p.T) {
    const int tn = next_active(p, t + nw, nw);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncwarp();
    spa_row<PER, FUSED>(p, S, Bf, basis, t, tn, lane);
    __syncwarp();
    // the mvc rows are consumed: the next row's APP rows
    if (FUSED && tn < p.T) stage<FUSED>(p, S, tn, 0, p.dc, lane);
    t = tn;
  }
}

// Shared memory of one warp, in floats: its row buffer and products.
int warp_floats(int dc, int q, bool fused) {
  return ((fused ? 2 : 1) + 1) * dc * q;
}

template <int PER, bool FUSED>
int launch(Params p, void* stream) {
  const int basis_bytes = 16 * p.q;
  p.warp_floats = warp_floats(p.dc, p.q, FUSED);
  const int warp_bytes = 4 * p.warp_floats;
  if (basis_bytes + warp_bytes > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = spa_row_kernel<PER, FUSED>;
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
    const int smem = basis_bytes + w * warp_bytes;
    if (smem > kSmemLimit) break;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, 32 * w,
                                                      smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (blocks * w > best) {
      best = blocks * w;
      wpb = w;
      per_sm = blocks;
    }
  }
  const long long need = (static_cast<long long>(p.T) + wpb - 1) / wpb;
  const long long resident = static_cast<long long>(sms) * per_sm;
  const unsigned grid =
      static_cast<unsigned>(need < resident ? need : resident);
  kern<<<grid, 32 * wpb, basis_bytes + wpb * warp_bytes,
         static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool FUSED>
int dispatch(const Params& p, void* stream) {
  if (p.q <= 32) return launch<1, FUSED>(p, stream);
  if (p.q == 64) return launch<2, FUSED>(p, stream);
  if (p.q == 128) return launch<4, FUSED>(p, stream);
  return launch<8, FUSED>(p, stream);
}

bool valid_shape(int dc, int q, long long T) {
  return q >= 2 && q <= 256 && (q & (q - 1)) == 0 && dc >= 2 &&
         T < (1LL << 30);
}

}  // namespace

extern "C" {

// The least dynamic shared memory of a launch, in bytes (ops/cuda_spa.py
// smem_bytes): the block's basis images and one warp.
long long spa_smem_bytes(int dc, int q, int fused) {
  return 16LL * q + 4LL * warp_floats(dc, q, fused != 0);
}

// One layered super-layer, in place.  app: [F, app_rows, q] and ctov:
// [F, ctov_rows, q] contiguous float32 on the device; active: [F] bytes (0
// = frozen frame); cols, edges, coefs: [G, dc] int32 (each row's APP
// columns, CtoV edges and GF coefficients, 0 = padding slot; a layer's
// columns and edges are distinct but for the padding column and edge, which
// hold 0); t_tab, tinv_tab: [q, q] uint8, GF(2)-linear maps
// (fht.transpose_perm_tables).  Requires q a power of two <= 256, dc >= 2,
// F * G < 2^30; a column, edge or coefficient out of range traps in the
// kernel.  Launches on `stream`, does not synchronise, returns a CUDA error
// code (0 = launched).
int spa_layer_launch(float* app, float* ctov, long long F, long long app_rows,
                     long long ctov_rows, const uint8_t* active,
                     const int* cols, const int* edges, const int* coefs,
                     const uint8_t* t_tab, const uint8_t* tinv_tab, int G,
                     int dc, int q, void* stream) {
  const long long T = F * G;
  if (!valid_shape(dc, q, T) || G <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T <= 0) return 0;
  Params p = {};
  p.app = app;
  p.ctov = ctov;
  p.app_frame = app_rows * q;
  p.ctov_frame = ctov_rows * q;
  p.app_rows = static_cast<unsigned>(app_rows);
  p.ctov_rows = static_cast<unsigned>(ctov_rows);
  p.active = active;
  p.cols = cols;
  p.edges = edges;
  p.coefs = coefs;
  p.t_tab = t_tab;
  p.tinv_tab = tinv_tab;
  p.T = static_cast<int>(T);
  p.G = G;
  p.dc = dc;
  p.q = q;
  p.vec16 = q % 4 == 0 && reinterpret_cast<uintptr_t>(app) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(ctov) % 16 == 0;
  return dispatch<true>(p, stream);
}

// The bare check node.  mvc, out: [T, dc, q] contiguous float32 on the
// device; coefs: [G, dc] int32 with T % G == 0 (row t uses coefs[t % G]);
// t_tab, tinv_tab as above.  Same requirements and return value.
int spa_checknode_launch(const float* mvc, const int* coefs,
                         const uint8_t* t_tab, const uint8_t* tinv_tab,
                         float* out, long long T, int G, int dc, int q,
                         void* stream) {
  if (!valid_shape(dc, q, T) || G <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T <= 0) return 0;
  Params p = {};
  p.x = mvc;
  p.out = out;
  p.coefs = coefs;
  p.t_tab = t_tab;
  p.tinv_tab = tinv_tab;
  p.T = static_cast<int>(T);
  p.G = G;
  p.dc = dc;
  p.q = q;
  p.vec16 = q % 4 == 0 && reinterpret_cast<uintptr_t>(mvc) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return dispatch<false>(p, stream);
}

// The kernel's launches on the current device since the library was loaded
// or last reset: out[0] by spa_checknode_launch, out[1] by spa_layer_launch
// (counted on the device, graph replays included).  Synchronises the device.
int spa_launches(unsigned long long* out) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(out, g_launches, sizeof(g_launches));
  return static_cast<int>(e);
}

// Set both counts of spa_launches to 0.  Synchronises the device.
int spa_reset_launches() {
  const unsigned long long zero[2] = {0, 0};
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(g_launches, zero, sizeof(zero));
  return static_cast<int>(e);
}

}  // extern "C"
