// slab_ell_matmul: full SLaB linear with a row-padded ELL sparse part,
//
//   y[m, n] = Σ_j x[m, idx[n, j]] · vals[n, j]
//           + Σ_r u_r[n] · Σ_k s[n, k] · (x[m, k] · v_r[k])
//
// Replaces the TPU kernel repro/kernels/ell.py::slab_ell_matmul
// (_kernel_slab_ell, pallas_call at ell.py:209).
//
// Bound on the H100 (3.35 TB/s): at the serve path's M = 1-8 the work is
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
  const uint32_t* bp_row = bp + (size_t)row * (K / 32);
  const unsigned k_lim = (unsigned)K;
  auto col_of = [k_lim](int, I code) {
    return (unsigned)code < k_lim ? (int)code : -1;
  };

  if (live) {
    prefetch_l2(vals + (size_t)row * kmax, (size_t)kmax * sizeof(T), lane);
    prefetch_l2(idx + (size_t)row * kmax, (size_t)kmax * sizeof(I), lane);
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
      sparse_pass<T, I, MTP>(acc, xk, vals + (size_t)row * kmax,
                             idx + (size_t)row * kmax, (size_t)row * kmax,
                             kmax, col_of, lane);
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
                  int M, int N, int K, int kmax, int R, void* stream) {
  if (!aligned16(vals) || !aligned16(idx) || !aligned16(bp))
    return (int)cudaErrorMisalignedAddress;
  size_t smem = 0;
  const int mtp = pick_mtp(M, K, sizeof(T), &smem);
  const dim3 grid((N + kWarps - 1) / kWarps);
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

}  // namespace slab

// dtype: 0 = float32, 1 = bfloat16; idx_bytes: 2 (uint16 ids) or 4.
// Launches on ``stream`` and allocates nothing; returns cudaGetLastError().
extern "C" int slab_ell_matmul(int dtype, int idx_bytes, const void* x,
                               const void* vals, const void* idx,
                               const void* bp, const void* u, const void* v,
                               void* y, int M, int N, int K, int kmax, int R,
                               void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 || kmax <= 0 || R <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && idx_bytes == 2)
    return slab::launch<float, uint16_t>(x, vals, idx, bp, u, v, y, M, N, K,
                                         kmax, R, stream);
  if (dtype == 0 && idx_bytes == 4)
    return slab::launch<float, uint32_t>(x, vals, idx, bp, u, v, y, M, N, K,
                                         kmax, R, stream);
  if (dtype == 1 && idx_bytes == 2)
    return slab::launch<__nv_bfloat16, uint16_t>(x, vals, idx, bp, u, v, y, M,
                                                 N, K, kmax, R, stream);
  if (dtype == 1 && idx_bytes == 4)
    return slab::launch<__nv_bfloat16, uint32_t>(x, vals, idx, bp, u, v, y, M,
                                                 N, K, kmax, R, stream);
  return (int)cudaErrorInvalidValue;
}
