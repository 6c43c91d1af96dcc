// nm_matmul: the N:M semi-structured sparse linear (sparse-nm),
//
//   y[m, n] = Σ_g Σ_j x[m, g·m_pat + idx[n, g, j]] · vals[n, g, j]
//
// values in x's dtype, int8 positions inside each m_pat-group, fp32
// accumulation. Replaces the TPU kernel repro/kernels/nm_sparse.py::
// nm_matmul (_kernel, pallas_call at nm_sparse.py:54), which rebuilds the
// dense tile in VMEM by a comparison one-hot expand and feeds the MXU.
//
// Bound on the H100 (3.35 TB/s), at the serve path's M = 1-8 (a GEMV):
// bytes / 3.35 TB/s, bytes = vals + idx + x + y. 2:4 at bf16 streams
// (2 + 1)/2 = 0.75 of the dense bytes (one int8 position per kept
// value); the operations, 2·M per stored value, are far below either
// compute peak.
//
// Design against that bound: slab_nm_matmul's sparse pass with no binary
// term. One warp per output row streams the row's values and positions
// once per M tile with 16-byte loads (consecutive lanes on consecutive
// chunks); x sits in shared memory column-major, staged alone, so each
// gathered column is one load for every batch row and never touches
// device memory. Each warp asks L2 for its row's planes before the block
// stages x. Positions are checked against m_pat before x is indexed. Only
// m_pat has to divide K: staging falls back to element loads when K is
// not a multiple of the vector width. No sparse tensor cores yet.
//
// nm_matmul_g, the grouped-expert form (replaces repro/kernels/
// grouped.py::nm_matmul_g, _kernel_nm_g, pallas_call at grouped.py:195):
// the same kernel on a grid with the expert as its y dimension
// (slab_common.cuh), one launch per bucket of E experts; at the MoE
// decode shapes (M = 2 rows per expert) a GEMV per expert, bound by the
// E experts' plane bytes.
//
// Both entries are the first design: the bf16 nm_matmul and nm_matmul_g at
// 2:4 / 4:8 run grouped_tc.cu's tensor-core kernels (same C names), and
// these keep f32, the other patterns and the launches below the crossovers
// (kernels/nm_sparse.py::nm_kernel, kernels/grouped.py::nm_g_kernel).
#include "slab_common.cuh"

namespace slab {

template <typename T, int MTP>
__global__ void __launch_bounds__(kWarps * 32)
nm_kernel(const T* __restrict__ x, const T* __restrict__ vals,
          const int8_t* __restrict__ idx, T* __restrict__ y, int M, int N,
          int K, int n_keep, int m_pat) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xk = reinterpret_cast<T*>(smem_raw);     // (K, MTP) column-major x
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool live = row < N;
  const size_t ex = blockIdx.y;               // expert (0 for a 2-D launch)
  x += ex * M * K;
  y += ex * M * N;
  const int per_row = (K / m_pat) * n_keep;   // stored entries per row
  const size_t base = (ex * N + row) * per_row;   // the row's first entry
  // entry e is slot e % n_keep of group e / n_keep; its code is the
  // position inside the group. 2:4 and 4:8 take shifts, not a division.
  const bool pow2 = !(n_keep & (n_keep - 1)) && !(m_pat & (m_pat - 1));
  const int ln = __ffs(n_keep) - 1, lm = __ffs(m_pat) - 1;
  auto col_of = [=](int e, int8_t q) {
    if (q < 0 || q >= m_pat) return -1;
    return (pow2 ? (e >> ln) << lm : (e / n_keep) * m_pat) + q;
  };
  if (live) {
    prefetch_l2(vals + base, (size_t)per_row * sizeof(T), lane);
    prefetch_l2(idx + base, (size_t)per_row, lane);
  }
  for (int m0 = 0; m0 < M; m0 += MTP) {
    const int mt = min(MTP, M - m0);
    __syncthreads();
    stage_x<T, MTP, true>(xk, x, m0, mt, K);
    __syncthreads();
    float acc[MTP];
#pragma unroll
    for (int m = 0; m < MTP; ++m) acc[m] = 0.f;
    if (live) {
      sparse_pass<T, int8_t, MTP>(acc, xk, vals + base, idx + base, base,
                                  per_row, col_of, lane);
      store_row<T, MTP>(acc, y, m0, mt, N, row, lane);
    }
  }
}

template <typename T>
static int launch_nm(const void* x, const void* vals, const void* idx,
                     void* y, int E, int M, int N, int K, int n_keep,
                     int m_pat, void* stream) {
  if (!aligned16(vals) || !aligned16(idx))
    return (int)cudaErrorMisalignedAddress;
  size_t smem = 0;
  const int mtp = pick_mtp(M, K, sizeof(T), &smem, 1);
  const dim3 grid((N + kWarps - 1) / kWarps, E);
  SLAB_DISPATCH_MTP(mtp, {
    auto kern = nm_kernel<T, MTP>;
    cudaError_t e = prepare(kern, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
        (const T*)x, (const T*)vals, (const int8_t*)idx, (T*)y, M, N, K,
        n_keep, m_pat);
  });
  return (int)cudaGetLastError();
}

static int dispatch_nm(int dtype, const void* x, const void* vals,
                       const void* idx, void* y, int E, int M, int N, int K,
                       int n_keep, int m_pat, void* stream) {
  if (E <= 0 || E > kMaxExperts || M <= 0 || N <= 0 || K <= 0 ||
      m_pat <= 0 || K % m_pat || n_keep <= 0 || n_keep > m_pat)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_nm<float>(x, vals, idx, y, E, M, N, K, n_keep, m_pat,
                            stream);
  if (dtype == 1)
    return launch_nm<__nv_bfloat16>(x, vals, idx, y, E, M, N, K, n_keep,
                                    m_pat, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace slab

// dtype: 0 = float32, 1 = bfloat16. Launch on ``stream``, allocate
// nothing, return cudaGetLastError().
extern "C" int nm_matmul(int dtype, const void* x, const void* vals,
                         const void* idx, void* y, int M, int N, int K,
                         int n_keep, int m_pat, void* stream) {
  return slab::dispatch_nm(dtype, x, vals, idx, y, 1, M, N, K, n_keep, m_pat,
                           stream);
}

// The grouped form: E experts, x (E, M, K), vals / idx (E, N, K/m, n),
// y (E, M, N); one launch.
extern "C" int nm_matmul_g(int dtype, const void* x, const void* vals,
                           const void* idx, void* y, int E, int M, int N,
                           int K, int n_keep, int m_pat, void* stream) {
  return slab::dispatch_nm(dtype, x, vals, idx, y, E, M, N, K, n_keep, m_pat,
                           stream);
}
