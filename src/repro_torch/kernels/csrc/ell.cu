// The row-padded ELL linears,
//
//   ell_matmul:      y[m, n] = Σ_j x[m, idx[n, j]] · vals[n, j]
//   ell_lr_matmul:   ... + Σ_r p[m, r] · u_r[n],  p = x @ Vᵀ in fp32
//   slab_ell_matmul: ... + Σ_r u_r[n] · Σ_k s[n, k] · (x[m, k] · v_r[k])
//
// Replace the TPU kernels repro/kernels/ell.py::ell_matmul (_kernel_ell,
// pallas_call at ell.py:105), ::ell_lr_matmul (_kernel_ell_lr, pallas_call
// at ell.py:149) and ::slab_ell_matmul (_kernel_slab_ell, pallas_call at
// ell.py:209).
//
// ell_matmul and ell_lr_matmul (sparse-ell, lowrank-ell) are
// slab_ell_matmul with the binary term removed or swapped for the
// projection. Their bound is bytes too: vals + idx ((2 + 2)·K_max per
// row at bf16, K_max ≈ D_in/2 for a 50 % pruner, i.e. about the dense
// matrix: ELL wins on bytes only strictly below K_max = D_in/2) plus x, y
// and, for lowrank-ell, u and v. They stage x alone, column-major, so the
// shared tile is half slab_ell's and two blocks fit an SM at K = 11008,
// M = 4. K needs no multiple of 32 (there are no sign words): staging
// falls back to element loads when K is not a multiple of the vector
// width. The projection p (M, R) does not depend on the output row, so
// each block forms it once per M tile from the staged x (lowrank_proj:
// all warps share K, fixed-order reduction) and every row adds
// Σ_r p[m, r] · u_r[row] after its warp reduction.
//
// slab_ell_matmul's bound on the H100 (3.35 TB/s): at the serve path's
// M = 1-8 the work is
// a GEMV, so the floor is bytes / 3.35 TB/s with bytes = vals + idx +
// sign words + u + v + x + y. At llama2-7b widths, CR 0.5 and bf16 that
// is (2 + 2)·K_max + K/8 per output row, K_max ≈ 0.437·K: about 0.94x
// the dense bf16 matrix, so even at the bound this format barely beats
// a dense GEMV. The operations (about 2·M·(K_max + K·r) per row) are far
// below the tensor-core line.
//
// Design against that bound: one warp per output row streams the row's
// vals/idx with 16-byte loads (consecutive lanes on consecutive chunks,
// so loads coalesce) and its K/32 sign words exactly once per M tile.
// x sits in shared memory column-major, so each gathered column
// x[:, idx] is one load for all batch rows and never touches device
// memory; the row-independent x ⊙ v_r sits beside it row-major for the
// binary pass. Before staging, each warp asks L2 for its row's planes,
// so the passes read from L2 rather than wait on device memory. ELL pads
// are value 0 at a real zero column; ids are still checked against K.
// No tensor cores, TMA or wgmma yet.
//
// The grouped-expert forms: slab_ell_matmul_g (replaces repro/kernels/
// grouped.py::slab_ell_matmul_g, _kernel_slab_ell_g, pallas_call at
// grouped.py:142), ell_matmul_g (::ell_matmul_g, _kernel_ell_g,
// pallas_call at grouped.py:64) and ell_lr_matmul_g (::ell_lr_matmul_g,
// _kernel_ell_lr_g, pallas_call at grouped.py:103): the same kernels on a
// grid with the expert as its y dimension (slab_common.cuh), so one
// launch serves a whole bucket of E experts, each with its own x (M, K),
// planes and y; the 2-D entry points are the E = 1 launch. An ELL row
// starts at entry (e·N + row)·K_max of the stacked planes, so with an odd
// K_max and 2-byte ids its 16-byte alignment follows the global row:
// sparse_pass finds the boundary from that start. At the MoE decode
// shapes (M = 2-6 rows per expert) each is a GEMV per expert, bound by
// the E experts' plane bytes. These grouped forms are the first design:
// bf16 launches from 3 rows per expert run grouped_tc.cu's redesign of
// each (same C symbol; grouped.slab_ell_g_kernel / ell_g_kernel pick the
// library), so here they serve f32, 1-2 rows per expert and K too wide
// for grouped_tc.cu's staged x, counted as slab_ell_matmul_g@ell.cu,
// ell_matmul_g@ell.cu and ell_lr_matmul_g@ell.cu. So, likewise, are the
// 2-D ell_matmul, ell_lr_matmul and slab_ell_matmul: their bf16 launches
// from a row crossover run grouped_tc.cu's split gather (ell.ell_kernel,
// ::ell_lr_kernel and ::slab_ell_kernel pick the library), and these
// serve f32, fewer rows and wider K, counted as ell_matmul@ell.cu,
// ell_lr_matmul@ell.cu and slab_ell_matmul@ell.cu.
#include "slab_common.cuh"

namespace slab {

template <typename T, typename I, int MTP>
__global__ void __launch_bounds__(kWarps * 32)
slab_ell_kernel(const T* __restrict__ x, const T* __restrict__ vals,
                const I* __restrict__ idx, const uint32_t* __restrict__ bp,
                const T* __restrict__ u, const T* __restrict__ v,
                T* __restrict__ y, int M, int N, int K, int kmax, int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xk = reinterpret_cast<T*>(smem_raw);     // (K, MTP) column-major x
  T* xv = xk + (size_t)MTP * K;               // (MTP, K) x ⊙ v_r
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool live = row < N;
  const size_t ex = blockIdx.y;               // expert (0 for a 2-D launch)
  x += ex * M * K;
  y += ex * M * N;
  u += ex * R * N;
  v += ex * R * K;
  const size_t grow = ex * N + row;           // row of the stacked planes
  const uint32_t* bp_row = bp + grow * (K / 32);
  const unsigned k_lim = (unsigned)K;
  auto col_of = [k_lim](int, I code) {
    return (unsigned)code < k_lim ? (int)code : -1;
  };

  if (live) {
    prefetch_l2(vals + grow * kmax, (size_t)kmax * sizeof(T), lane);
    prefetch_l2(idx + grow * kmax, (size_t)kmax * sizeof(I), lane);
    prefetch_l2(bp_row, (size_t)K / 8, lane);
  }
  for (int m0 = 0; m0 < M; m0 += MTP) {
    const int mt = min(MTP, M - m0);
    __syncthreads();                 // the previous tile's readers are done
    stage_tile<T, MTP, true>(xk, xv, x, v, m0, mt, K);
    __syncthreads();
    float acc[MTP], part[MTP];
#pragma unroll
    for (int m = 0; m < MTP; ++m) acc[m] = 0.f;
    if (live)
      sparse_pass<T, I, MTP>(acc, xk, vals + grow * kmax, idx + grow * kmax,
                             grow * kmax, kmax, col_of, lane);
    for (int r = 0; r < R; ++r) {
      if (r > 0) {
        __syncthreads();             // xv of the previous rank is consumed
        stage_tile<T, MTP, true>(nullptr, xv, x, v + (size_t)r * K, m0, mt,
                                 K);
        __syncthreads();
      }
      if (live) {
#pragma unroll
        for (int m = 0; m < MTP; ++m) part[m] = 0.f;
        column_pass<T, MTP>(acc, part, xk, xv, K, bp_row, nullptr, lane);
        const float ur = to_f32(u[(size_t)r * N + row]);
#pragma unroll
        for (int m = 0; m < MTP; ++m) acc[m] += ur * part[m];
      }
    }
    if (live) store_row<T, MTP>(acc, y, m0, mt, N, row, lane);
  }
}

template <typename T, typename I>
static int launch(const void* x, const void* vals, const void* idx,
                  const void* bp, const void* u, const void* v, void* y,
                  int E, int M, int N, int K, int kmax, int R,
                  void* stream) {
  if (!aligned16(vals) || !aligned16(idx) || !aligned16(bp))
    return (int)cudaErrorMisalignedAddress;
  size_t smem = 0;
  const int mtp = pick_mtp(M, K, sizeof(T), &smem);
  const dim3 grid((N + kWarps - 1) / kWarps, E);
  SLAB_DISPATCH_MTP(mtp, {
    auto kern = slab_ell_kernel<T, I, MTP>;
    cudaError_t e = prepare(kern, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
        (const T*)x, (const T*)vals, (const I*)idx, (const uint32_t*)bp,
        (const T*)u, (const T*)v, (T*)y, M, N, K, kmax, R);
  });
  return (int)cudaGetLastError();
}

// ell_matmul / ell_lr_matmul (LR): one warp per output row, x staged alone.
template <typename T, typename I, int MTP, bool LR>
__global__ void __launch_bounds__(kWarps * 32)
ell_kernel(const T* __restrict__ x, const T* __restrict__ vals,
           const I* __restrict__ idx, const T* __restrict__ u,
           const T* __restrict__ v, T* __restrict__ y, int M, int N, int K,
           int kmax, int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xk = reinterpret_cast<T*>(smem_raw);     // (K, MTP) column-major x
  float* p = reinterpret_cast<float*>(
      smem_raw + align16_up((size_t)MTP * K * sizeof(T)));   // (R, MTP)
  float* part = p + (size_t)R * MTP;          // (kWarps, R, MTP)
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool live = row < N;
  const size_t ex = blockIdx.y;               // expert (0 for a 2-D launch)
  x += ex * M * K;
  y += ex * M * N;
  if (LR) {
    u += ex * R * N;
    v += ex * R * K;
  }
  const size_t start = (ex * N + row) * kmax; // the row's first entry
  const unsigned k_lim = (unsigned)K;
  auto col_of = [k_lim](int, I code) {
    return (unsigned)code < k_lim ? (int)code : -1;
  };
  if (live) {
    prefetch_l2(vals + start, (size_t)kmax * sizeof(T), lane);
    prefetch_l2(idx + start, (size_t)kmax * sizeof(I), lane);
  }
  for (int m0 = 0; m0 < M; m0 += MTP) {
    const int mt = min(MTP, M - m0);
    __syncthreads();                 // the previous tile's readers are done
    stage_x<T, MTP, true>(xk, x, m0, mt, K);
    __syncthreads();
    if (LR) lowrank_proj<T, MTP, true>(p, part, xk, v, K, R);
    float acc[MTP];
#pragma unroll
    for (int m = 0; m < MTP; ++m) acc[m] = 0.f;
    if (live) {
      sparse_pass<T, I, MTP>(acc, xk, vals + start, idx + start, start,
                             kmax, col_of, lane);
      store_row<T, MTP>(acc, y, m0, mt, N, row, lane, LR ? p : nullptr, u,
                        R);
    }
  }
}

template <typename T, typename I, bool LR>
static int launch_ell(const void* x, const void* vals, const void* idx,
                      const void* u, const void* v, void* y, int E, int M,
                      int N, int K, int kmax, int R, void* stream) {
  if (!aligned16(vals) || !aligned16(idx))
    return (int)cudaErrorMisalignedAddress;
  size_t smem = 0;
  const int mtp = pick_mtp(M, K, sizeof(T), &smem, 1,
                           LR ? lowrank_smem(R) : 0);
  const dim3 grid((N + kWarps - 1) / kWarps, E);
  SLAB_DISPATCH_MTP(mtp, {
    auto kern = ell_kernel<T, I, MTP, LR>;
    cudaError_t e = prepare(kern, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
        (const T*)x, (const T*)vals, (const I*)idx, (const T*)u,
        (const T*)v, (T*)y, M, N, K, kmax, R);
  });
  return (int)cudaGetLastError();
}

template <bool LR>
static int dispatch_ell(int dtype, int idx_bytes, const void* x,
                        const void* vals, const void* idx, const void* u,
                        const void* v, void* y, int E, int M, int N, int K,
                        int kmax, int R, void* stream) {
  if (E <= 0 || E > kMaxExperts || M <= 0 || N <= 0 || K <= 0 ||
      kmax <= 0 || (LR && R <= 0))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && idx_bytes == 2)
    return launch_ell<float, uint16_t, LR>(x, vals, idx, u, v, y, E, M, N, K,
                                           kmax, R, stream);
  if (dtype == 0 && idx_bytes == 4)
    return launch_ell<float, uint32_t, LR>(x, vals, idx, u, v, y, E, M, N, K,
                                           kmax, R, stream);
  if (dtype == 1 && idx_bytes == 2)
    return launch_ell<__nv_bfloat16, uint16_t, LR>(x, vals, idx, u, v, y, E,
                                                   M, N, K, kmax, R, stream);
  if (dtype == 1 && idx_bytes == 4)
    return launch_ell<__nv_bfloat16, uint32_t, LR>(x, vals, idx, u, v, y, E,
                                                   M, N, K, kmax, R, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace slab

// dtype: 0 = float32, 1 = bfloat16; idx_bytes: 2 (uint16 ids) or 4.
// Launch on ``stream``, allocate nothing, return cudaGetLastError().
extern "C" int ell_matmul(int dtype, int idx_bytes, const void* x,
                          const void* vals, const void* idx, void* y, int M,
                          int N, int K, int kmax, void* stream) {
  return slab::dispatch_ell<false>(dtype, idx_bytes, x, vals, idx, nullptr,
                                   nullptr, y, 1, M, N, K, kmax, 0, stream);
}

extern "C" int ell_lr_matmul(int dtype, int idx_bytes, const void* x,
                             const void* vals, const void* idx,
                             const void* u, const void* v, void* y, int M,
                             int N, int K, int kmax, int R, void* stream) {
  return slab::dispatch_ell<true>(dtype, idx_bytes, x, vals, idx, u, v, y, 1,
                                  M, N, K, kmax, R, stream);
}

// The grouped forms: E experts, x (E, M, K), vals / idx (E, N, K_max),
// u (E, R, N), v (E, R, K), y (E, M, N); one launch.
extern "C" int ell_matmul_g(int dtype, int idx_bytes, const void* x,
                            const void* vals, const void* idx, void* y,
                            int E, int M, int N, int K, int kmax,
                            void* stream) {
  return slab::dispatch_ell<false>(dtype, idx_bytes, x, vals, idx, nullptr,
                                   nullptr, y, E, M, N, K, kmax, 0, stream);
}

extern "C" int ell_lr_matmul_g(int dtype, int idx_bytes, const void* x,
                               const void* vals, const void* idx,
                               const void* u, const void* v, void* y, int E,
                               int M, int N, int K, int kmax, int R,
                               void* stream) {
  return slab::dispatch_ell<true>(dtype, idx_bytes, x, vals, idx, u, v, y, E,
                                  M, N, K, kmax, R, stream);
}

namespace slab {

static int dispatch_slab_ell(int dtype, int idx_bytes, const void* x,
                             const void* vals, const void* idx,
                             const void* bp, const void* u, const void* v,
                             void* y, int E, int M, int N, int K, int kmax,
                             int R, void* stream) {
  if (E <= 0 || E > kMaxExperts || M <= 0 || N <= 0 || K <= 0 || K % 32 ||
      kmax <= 0 || R <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && idx_bytes == 2)
    return launch<float, uint16_t>(x, vals, idx, bp, u, v, y, E, M, N, K,
                                   kmax, R, stream);
  if (dtype == 0 && idx_bytes == 4)
    return launch<float, uint32_t>(x, vals, idx, bp, u, v, y, E, M, N, K,
                                   kmax, R, stream);
  if (dtype == 1 && idx_bytes == 2)
    return launch<__nv_bfloat16, uint16_t>(x, vals, idx, bp, u, v, y, E, M,
                                           N, K, kmax, R, stream);
  if (dtype == 1 && idx_bytes == 4)
    return launch<__nv_bfloat16, uint32_t>(x, vals, idx, bp, u, v, y, E, M,
                                           N, K, kmax, R, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace slab

// dtype: 0 = float32, 1 = bfloat16; idx_bytes: 2 (uint16 ids) or 4.
// Launches on ``stream`` and allocates nothing; returns cudaGetLastError().
extern "C" int slab_ell_matmul(int dtype, int idx_bytes, const void* x,
                               const void* vals, const void* idx,
                               const void* bp, const void* u, const void* v,
                               void* y, int M, int N, int K, int kmax, int R,
                               void* stream) {
  return slab::dispatch_slab_ell(dtype, idx_bytes, x, vals, idx, bp, u, v, y,
                                 1, M, N, K, kmax, R, stream);
}

// The grouped form: E experts, every operand stacked on a leading expert
// dim (x (E, M, K), vals / idx (E, N, K_max), bp (E, N, K/32), u (E, R,
// N), v (E, R, K), y (E, M, N)); one launch.
extern "C" int slab_ell_matmul_g(int dtype, int idx_bytes, const void* x,
                                 const void* vals, const void* idx,
                                 const void* bp, const void* u,
                                 const void* v, void* y, int E, int M, int N,
                                 int K, int kmax, int R, void* stream) {
  return slab::dispatch_slab_ell(dtype, idx_bytes, x, vals, idx, bp, u, v, y,
                                 E, M, N, K, kmax, R, stream);
}
