// slab_matmul and slab_nm_matmul: the fused SLaB linears with a
// dense-masked or an N:M packed sparse part,
//
//   y[m, n] = Σ_k x[m, k] · W_S[n, k]
//           + Σ_r u_r[n] · Σ_k s[n, k] · (x[m, k] · v_r[k])
//
// and slab_lr_matmul, the dense-masked part with the no-binary low-rank
// term instead (lowrank-dense),
//
//   y[m, n] = Σ_k x[m, k] · W_S[n, k] + Σ_r p[m, r] · u_r[n],
//   p = x @ Vᵀ in fp32,
//
// which replaces repro/kernels/slab_matmul.py::slab_lr_matmul
// (_kernel_dense_lr, pallas_call at slab_matmul.py:193). Its planes are
// the dense (N, K) W_S in x's dtype plus u and v, so at its byte bound it
// only ties a dense GEMV: it is the fallback when ELL loses on bytes. It
// stages x alone (row-major), forms p once per block and M tile from the
// staged x (lowrank_proj), streams each row of W_S once with 16-byte loads
// and adds Σ_r p[m, r] · u_r[row] after the warp reduction.
//
// slab_nm_lr_matmul, the N:M part with the no-binary low-rank term
// (lowrank-nm), replaces repro/kernels/slab_matmul.py::slab_nm_lr_matmul
// (_kernel_nm_lr, pallas_call at slab_matmul.py:247): nm_matmul's gather
// from the column-major x tile plus slab_lr_matmul's projection epilogue
// (lowrank_proj, then Σ_r p[m, r] · u_r[row] after the warp reduction).
// 2:4 at bf16 streams (2 + 1)/2 = 0.75 of the dense bytes plus u and v.
//
// binlr_matmul, the binary ⊙ rank-r term alone (binlr: a decomposition
// whose W_S is all zero),
//
//   y[m, n] = Σ_r u_r[n] · Σ_k s[n, k] · (x[m, k] · v_r[k]),
//
// replaces repro/kernels/binlr.py::binlr_matmul (_kernel, pallas_call at
// binlr.py:65): slab_dense's column pass with no W_S. Only the sign words
// (K/8 bytes a row) and u, v stream, 1/16 of the dense bf16 bytes, so the
// kernel is bound by bytes far below a GEMV; x ⊙ v_r is rounded to x's
// dtype before the ±1 contraction, as the reference does.
//
// Replace the TPU kernels repro/kernels/slab_matmul.py::slab_matmul
// (_kernel_dense, pallas_call at slab_matmul.py:77) and ::slab_nm_matmul
// (_kernel_nm, pallas_call at slab_matmul.py:135). The TPU versions grid
// K and carry an fp32 VMEM accumulator across grid steps; Hopper has no
// ordered grid, so each warp loops over the whole of K for its row.
//
// Bound on the H100 (3.35 TB/s), at the serve path's M = 1-8 (a GEMV):
// bytes / 3.35 TB/s, bytes = W_S planes + sign words + u + v + x + y.
//   slab-dense: W_S is (N, K) in x's dtype, so the format costs the dense
//               matrix plus K/8 bytes of signs per row: it can never beat
//               a dense GEMV; it is the fallback when ELL loses on bytes.
//   slab-nm:    n/m of the values plus one int8 position each, e.g. 2:4
//               at bf16 is (2 + 1)/2 + 1/16 = 0.81 of dense bytes.
// Design: one warp per output row streams its plane once per M tile with
// 16-byte loads, consecutive lanes on consecutive chunks (coalesced); x
// and the row-independent x ⊙ v_r live in shared memory
// (slab_common.cuh). slab-dense folds W_S into the binary pass over the
// columns (one read of each x chunk serves both terms); slab-nm gathers
// x from a column-major tile, all batch rows of a column in one load.
// Before staging, each warp asks L2 for its row's planes, so the passes
// read from L2 rather than wait on device memory. N:M positions are
// checked against m before x is indexed.
//
// The bf16 slab_matmul and slab_matmul_g, slab_nm_matmul and
// slab_nm_matmul_g at 2:4 / 4:8, slab_nm_lr_matmul and slab_nm_lr_matmul_g
// at 2:4 / 4:8, slab_lr_matmul and slab_lr_matmul_g, and binlr_matmul and
// binlr_matmul_g run grouped_tc.cu's redesigned kernels (same C names); the
// entries here are their first design, which keeps f32, the other patterns
// and the shapes, ranks and row counts those kernels do not take
// (kernels/slab_matmul.py::slab_dense_kernel, ::slab_nm_kernel,
// ::slab_nm_lr_kernel, ::slab_lr_kernel, kernels/binlr.py::binlr_kernel,
// kernels/grouped.py::slab_g_kernel, ::slab_nm_g_kernel,
// ::slab_nm_lr_g_kernel, ::slab_lr_g_kernel, ::binlr_g_kernel).
//
// The grouped-expert forms (replace repro/kernels/grouped.py::
// slab_matmul_g, _kernel_dense_g, pallas_call at grouped.py:242;
// ::slab_nm_matmul_g, _kernel_nm_full_g, :297; ::slab_lr_matmul_g,
// _kernel_dense_lr_g, :348; ::slab_nm_lr_matmul_g, _kernel_nm_lr_g, :402;
// ::binlr_matmul_g, _kernel_binlr_g, :450): the same kernels on a grid
// with the expert as its y dimension (slab_common.cuh), one launch per
// bucket of E experts; the 2-D entry points are the E = 1 launch. At the
// MoE decode shapes (M = 2-6 rows per expert) each is a GEMV per expert,
// bound by the E experts' plane bytes: dense W_S for slab_lr_matmul_g
// (the dense expert stack's bytes plus u and v: it can only tie a
// batched dense GEMV), n/m of the values plus int8 positions for
// slab_nm_lr_matmul_g, and the sign words alone (1/16 of the dense bf16
// bytes) for binlr_matmul_g, which x ⊙ v_r staging and launch cost
// bound rather than bytes at these sizes.
#include "slab_common.cuh"

namespace slab {

template <typename T, int MTP>
__global__ void __launch_bounds__(kWarps * 32)
slab_dense_kernel(const T* __restrict__ x, const T* __restrict__ ws,
                  const uint32_t* __restrict__ bp, const T* __restrict__ u,
                  const T* __restrict__ v, T* __restrict__ y, int M, int N,
                  int K, int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);     // (MTP, K) x
  T* xv = xs + (size_t)MTP * K;               // (MTP, K) x ⊙ v_r
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
  if (live) {
    prefetch_l2(ws + grow * K, (size_t)K * sizeof(T), lane);
    prefetch_l2(bp_row, (size_t)K / 8, lane);
  }

  for (int m0 = 0; m0 < M; m0 += MTP) {
    const int mt = min(MTP, M - m0);
    __syncthreads();
    stage_tile<T, MTP, false>(xs, xv, x, v, m0, mt, K);
    __syncthreads();
    float acc[MTP], part[MTP];
#pragma unroll
    for (int m = 0; m < MTP; ++m) acc[m] = 0.f;
    for (int r = 0; r < R; ++r) {
      if (r > 0) {
        __syncthreads();
        stage_tile<T, MTP, false>(nullptr, xv, x, v + (size_t)r * K, m0, mt,
                                  K);
        __syncthreads();
      }
      if (live) {
#pragma unroll
        for (int m = 0; m < MTP; ++m) part[m] = 0.f;
        // W_S rides along with the first rank's pass
        column_pass<T, MTP>(acc, part, xs, xv, K, bp_row,
                            r == 0 ? ws + grow * K : nullptr, lane);
        const float ur = to_f32(u[(size_t)r * N + row]);
#pragma unroll
        for (int m = 0; m < MTP; ++m) acc[m] += ur * part[m];
      }
    }
    if (live) store_row<T, MTP>(acc, y, m0, mt, N, row, lane);
  }
}

template <typename T, int MTP>
__global__ void __launch_bounds__(kWarps * 32)
slab_nm_kernel(const T* __restrict__ x, const T* __restrict__ vals,
               const int8_t* __restrict__ idx, const uint32_t* __restrict__ bp,
               const T* __restrict__ u, const T* __restrict__ v,
               T* __restrict__ y, int M, int N, int K, int n_keep, int m_pat,
               int R) {
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
  const int per_row = (K / m_pat) * n_keep;   // stored entries per row
  const size_t base = grow * per_row;         // the row's first entry
  // entry e is slot e % n_keep of group e / n_keep; its code is the
  // position inside the group. 2:4 and 4:8 take shifts, not a division.
  const bool pow2 = !(n_keep & (n_keep - 1)) && !(m_pat & (m_pat - 1));
  const int ln = __ffs(n_keep) - 1, lm = __ffs(m_pat) - 1;
  auto col_of = [=](int e, int8_t p) {
    if (p < 0 || p >= m_pat) return -1;
    return (pow2 ? (e >> ln) << lm : (e / n_keep) * m_pat) + p;
  };
  if (live) {
    prefetch_l2(vals + base, (size_t)per_row * sizeof(T), lane);
    prefetch_l2(idx + base, (size_t)per_row, lane);
    prefetch_l2(bp_row, (size_t)K / 8, lane);
  }

  for (int m0 = 0; m0 < M; m0 += MTP) {
    const int mt = min(MTP, M - m0);
    __syncthreads();
    stage_tile<T, MTP, true>(xk, xv, x, v, m0, mt, K);
    __syncthreads();
    float acc[MTP], part[MTP];
#pragma unroll
    for (int m = 0; m < MTP; ++m) acc[m] = 0.f;
    if (live)
      sparse_pass<T, int8_t, MTP>(acc, xk, vals + base, idx + base, base,
                                  per_row, col_of, lane);
    for (int r = 0; r < R; ++r) {
      if (r > 0) {
        __syncthreads();
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

template <typename T, int MTP>
__global__ void __launch_bounds__(kWarps * 32)
slab_lr_kernel(const T* __restrict__ x, const T* __restrict__ ws,
               const T* __restrict__ u, const T* __restrict__ v,
               T* __restrict__ y, int M, int N, int K, int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);     // (MTP, K) x
  float* p = reinterpret_cast<float*>(
      smem_raw + align16_up((size_t)MTP * K * sizeof(T)));   // (R, MTP)
  float* part = p + (size_t)R * MTP;          // (kWarps, R, MTP)
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool live = row < N;
  const size_t ex = blockIdx.y;               // expert (0 for a 2-D launch)
  x += ex * M * K;
  y += ex * M * N;
  u += ex * R * N;
  v += ex * R * K;
  const T* ws_row = ws + (ex * N + row) * K;  // row of the stacked planes
  if (live) prefetch_l2(ws_row, (size_t)K * sizeof(T), lane);

  for (int m0 = 0; m0 < M; m0 += MTP) {
    const int mt = min(MTP, M - m0);
    __syncthreads();
    stage_x<T, MTP, false>(xs, x, m0, mt, K);
    __syncthreads();
    lowrank_proj<T, MTP, false>(p, part, xs, v, K, R);
    float acc[MTP];
#pragma unroll
    for (int m = 0; m < MTP; ++m) acc[m] = 0.f;
    if (live) {
      dense_pass<T, MTP>(acc, xs, ws_row, K, lane);
      store_row<T, MTP>(acc, y, m0, mt, N, row, lane, p, u, R);
    }
  }
}

template <typename T>
static int launch_lr(const void* x, const void* ws, const void* u,
                     const void* v, void* y, int E, int M, int N, int K,
                     int R, void* stream) {
  if (!aligned16(ws)) return (int)cudaErrorMisalignedAddress;
  size_t smem = 0;
  const int mtp = pick_mtp(M, K, sizeof(T), &smem, 1, lowrank_smem(R));
  const dim3 grid((N + kWarps - 1) / kWarps, E);
  SLAB_DISPATCH_MTP(mtp, {
    auto kern = slab_lr_kernel<T, MTP>;
    cudaError_t e = prepare(kern, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
        (const T*)x, (const T*)ws, (const T*)u, (const T*)v, (T*)y, M, N, K,
        R);
  });
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_dense(const void* x, const void* ws, const void* bp,
                        const void* u, const void* v, void* y, int E, int M,
                        int N, int K, int R, void* stream) {
  if (!aligned16(ws) || !aligned16(bp))
    return (int)cudaErrorMisalignedAddress;
  size_t smem = 0;
  const int mtp = pick_mtp(M, K, sizeof(T), &smem);
  const dim3 grid((N + kWarps - 1) / kWarps, E);
  SLAB_DISPATCH_MTP(mtp, {
    auto kern = slab_dense_kernel<T, MTP>;
    cudaError_t e = prepare(kern, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
        (const T*)x, (const T*)ws, (const uint32_t*)bp, (const T*)u,
        (const T*)v, (T*)y, M, N, K, R);
  });
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_nm(const void* x, const void* vals, const void* idx,
                     const void* bp, const void* u, const void* v, void* y,
                     int E, int M, int N, int K, int n_keep, int m_pat, int R,
                     void* stream) {
  if (!aligned16(vals) || !aligned16(idx) || !aligned16(bp))
    return (int)cudaErrorMisalignedAddress;
  size_t smem = 0;
  const int mtp = pick_mtp(M, K, sizeof(T), &smem);
  const dim3 grid((N + kWarps - 1) / kWarps, E);
  SLAB_DISPATCH_MTP(mtp, {
    auto kern = slab_nm_kernel<T, MTP>;
    cudaError_t e = prepare(kern, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
        (const T*)x, (const T*)vals, (const int8_t*)idx, (const uint32_t*)bp,
        (const T*)u, (const T*)v, (T*)y, M, N, K, n_keep, m_pat, R);
  });
  return (int)cudaGetLastError();
}

template <typename T, int MTP>
__global__ void __launch_bounds__(kWarps * 32)
nm_lr_kernel(const T* __restrict__ x, const T* __restrict__ vals,
             const int8_t* __restrict__ idx, const T* __restrict__ u,
             const T* __restrict__ v, T* __restrict__ y, int M, int N, int K,
             int n_keep, int m_pat, int R) {
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
  u += ex * R * N;
  v += ex * R * K;
  const int per_row = (K / m_pat) * n_keep;   // stored entries per row
  const size_t base = (ex * N + row) * per_row;   // the row's first entry
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
    lowrank_proj<T, MTP, true>(p, part, xk, v, K, R);
    float acc[MTP];
#pragma unroll
    for (int m = 0; m < MTP; ++m) acc[m] = 0.f;
    if (live) {
      sparse_pass<T, int8_t, MTP>(acc, xk, vals + base, idx + base, base,
                                  per_row, col_of, lane);
      store_row<T, MTP>(acc, y, m0, mt, N, row, lane, p, u, R);
    }
  }
}

template <typename T, int MTP>
__global__ void __launch_bounds__(kWarps * 32)
binlr_kernel(const T* __restrict__ x, const uint32_t* __restrict__ bp,
             const T* __restrict__ u, const T* __restrict__ v,
             T* __restrict__ y, int M, int N, int K, int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xv = reinterpret_cast<T*>(smem_raw);     // (MTP, K) x ⊙ v_r
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool live = row < N;
  const size_t ex = blockIdx.y;               // expert (0 for a 2-D launch)
  x += ex * M * K;
  y += ex * M * N;
  u += ex * R * N;
  v += ex * R * K;
  const uint32_t* bp_row = bp + (ex * N + row) * (K / 32);
  if (live) prefetch_l2(bp_row, (size_t)K / 8, lane);

  for (int m0 = 0; m0 < M; m0 += MTP) {
    const int mt = min(MTP, M - m0);
    float acc[MTP], part[MTP];
#pragma unroll
    for (int m = 0; m < MTP; ++m) acc[m] = 0.f;
    for (int r = 0; r < R; ++r) {
      __syncthreads();
      stage_tile<T, MTP, false>(nullptr, xv, x, v + (size_t)r * K, m0, mt,
                                K);
      __syncthreads();
      if (live) {
#pragma unroll
        for (int m = 0; m < MTP; ++m) part[m] = 0.f;
        column_pass<T, MTP>(acc, part, nullptr, xv, K, bp_row, nullptr,
                            lane);
        const float ur = to_f32(u[(size_t)r * N + row]);
#pragma unroll
        for (int m = 0; m < MTP; ++m) acc[m] += ur * part[m];
      }
    }
    if (live) store_row<T, MTP>(acc, y, m0, mt, N, row, lane);
  }
}

template <typename T>
static int launch_nm_lr(const void* x, const void* vals, const void* idx,
                        const void* u, const void* v, void* y, int E, int M,
                        int N, int K, int n_keep, int m_pat, int R,
                        void* stream) {
  if (!aligned16(vals) || !aligned16(idx))
    return (int)cudaErrorMisalignedAddress;
  size_t smem = 0;
  const int mtp = pick_mtp(M, K, sizeof(T), &smem, 1, lowrank_smem(R));
  const dim3 grid((N + kWarps - 1) / kWarps, E);
  SLAB_DISPATCH_MTP(mtp, {
    auto kern = nm_lr_kernel<T, MTP>;
    cudaError_t e = prepare(kern, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
        (const T*)x, (const T*)vals, (const int8_t*)idx, (const T*)u,
        (const T*)v, (T*)y, M, N, K, n_keep, m_pat, R);
  });
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_binlr(const void* x, const void* bp, const void* u,
                        const void* v, void* y, int E, int M, int N, int K,
                        int R, void* stream) {
  if (!aligned16(bp)) return (int)cudaErrorMisalignedAddress;
  size_t smem = 0;
  const int mtp = pick_mtp(M, K, sizeof(T), &smem, 1);
  const dim3 grid((N + kWarps - 1) / kWarps, E);
  SLAB_DISPATCH_MTP(mtp, {
    auto kern = binlr_kernel<T, MTP>;
    cudaError_t e = prepare(kern, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
        (const T*)x, (const uint32_t*)bp, (const T*)u, (const T*)v, (T*)y,
        M, N, K, R);
  });
  return (int)cudaGetLastError();
}

static int dispatch_dense(int dtype, const void* x, const void* ws,
                          const void* bp, const void* u, const void* v,
                          void* y, int E, int M, int N, int K, int R,
                          void* stream) {
  if (E <= 0 || E > kMaxExperts || M <= 0 || N <= 0 || K <= 0 || K % 32 ||
      R <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_dense<float>(x, ws, bp, u, v, y, E, M, N, K, R, stream);
  if (dtype == 1)
    return launch_dense<__nv_bfloat16>(x, ws, bp, u, v, y, E, M, N, K, R,
                                       stream);
  return (int)cudaErrorInvalidValue;
}

static int dispatch_lr(int dtype, const void* x, const void* ws,
                       const void* u, const void* v, void* y, int E, int M,
                       int N, int K, int R, void* stream) {
  if (E <= 0 || E > kMaxExperts || M <= 0 || N <= 0 || K <= 0 || R <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_lr<float>(x, ws, u, v, y, E, M, N, K, R, stream);
  if (dtype == 1)
    return launch_lr<__nv_bfloat16>(x, ws, u, v, y, E, M, N, K, R, stream);
  return (int)cudaErrorInvalidValue;
}

static int dispatch_nm_lr(int dtype, const void* x, const void* vals,
                          const void* idx, const void* u, const void* v,
                          void* y, int E, int M, int N, int K, int n_keep,
                          int m_pat, int R, void* stream) {
  if (E <= 0 || E > kMaxExperts || M <= 0 || N <= 0 || K <= 0 || R <= 0 ||
      m_pat <= 0 || K % m_pat || n_keep <= 0 || n_keep > m_pat)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_nm_lr<float>(x, vals, idx, u, v, y, E, M, N, K, n_keep,
                               m_pat, R, stream);
  if (dtype == 1)
    return launch_nm_lr<__nv_bfloat16>(x, vals, idx, u, v, y, E, M, N, K,
                                       n_keep, m_pat, R, stream);
  return (int)cudaErrorInvalidValue;
}

static int dispatch_binlr(int dtype, const void* x, const void* bp,
                          const void* u, const void* v, void* y, int E,
                          int M, int N, int K, int R, void* stream) {
  if (E <= 0 || E > kMaxExperts || M <= 0 || N <= 0 || K <= 0 || K % 32 ||
      R <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_binlr<float>(x, bp, u, v, y, E, M, N, K, R, stream);
  if (dtype == 1)
    return launch_binlr<__nv_bfloat16>(x, bp, u, v, y, E, M, N, K, R,
                                       stream);
  return (int)cudaErrorInvalidValue;
}

static int dispatch_nm(int dtype, const void* x, const void* vals,
                       const void* idx, const void* bp, const void* u,
                       const void* v, void* y, int E, int M, int N, int K,
                       int n_keep, int m_pat, int R, void* stream) {
  if (E <= 0 || E > kMaxExperts || M <= 0 || N <= 0 || K <= 0 || K % 32 ||
      R <= 0 || m_pat <= 0 || K % m_pat || n_keep <= 0 || n_keep > m_pat)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_nm<float>(x, vals, idx, bp, u, v, y, E, M, N, K, n_keep,
                            m_pat, R, stream);
  if (dtype == 1)
    return launch_nm<__nv_bfloat16>(x, vals, idx, bp, u, v, y, E, M, N, K,
                                    n_keep, m_pat, R, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace slab

// dtype: 0 = float32, 1 = bfloat16. Launch on ``stream``, allocate
// nothing, return cudaGetLastError().
extern "C" int slab_matmul(int dtype, const void* x, const void* ws,
                           const void* bp, const void* u, const void* v,
                           void* y, int M, int N, int K, int R,
                           void* stream) {
  return slab::dispatch_dense(dtype, x, ws, bp, u, v, y, 1, M, N, K, R,
                              stream);
}

extern "C" int slab_nm_matmul(int dtype, const void* x, const void* vals,
                              const void* idx, const void* bp, const void* u,
                              const void* v, void* y, int M, int N, int K,
                              int n_keep, int m_pat, int R, void* stream) {
  return slab::dispatch_nm(dtype, x, vals, idx, bp, u, v, y, 1, M, N, K,
                           n_keep, m_pat, R, stream);
}

// The grouped forms: E experts, every operand stacked on a leading
// expert dim (x (E, M, K), ws (E, N, K) or vals / idx (E, N, K/m, n),
// bp (E, N, K/32), u (E, R, N), v (E, R, K), y (E, M, N)); one launch.
extern "C" int slab_matmul_g(int dtype, const void* x, const void* ws,
                             const void* bp, const void* u, const void* v,
                             void* y, int E, int M, int N, int K, int R,
                             void* stream) {
  return slab::dispatch_dense(dtype, x, ws, bp, u, v, y, E, M, N, K, R,
                              stream);
}

extern "C" int slab_nm_matmul_g(int dtype, const void* x, const void* vals,
                                const void* idx, const void* bp,
                                const void* u, const void* v, void* y, int E,
                                int M, int N, int K, int n_keep, int m_pat,
                                int R, void* stream) {
  return slab::dispatch_nm(dtype, x, vals, idx, bp, u, v, y, E, M, N, K,
                           n_keep, m_pat, R, stream);
}

extern "C" int slab_lr_matmul(int dtype, const void* x, const void* ws,
                              const void* u, const void* v, void* y, int M,
                              int N, int K, int R, void* stream) {
  return slab::dispatch_lr(dtype, x, ws, u, v, y, 1, M, N, K, R, stream);
}

extern "C" int slab_nm_lr_matmul(int dtype, const void* x, const void* vals,
                                 const void* idx, const void* u,
                                 const void* v, void* y, int M, int N, int K,
                                 int n_keep, int m_pat, int R, void* stream) {
  return slab::dispatch_nm_lr(dtype, x, vals, idx, u, v, y, 1, M, N, K,
                              n_keep, m_pat, R, stream);
}

extern "C" int binlr_matmul(int dtype, const void* x, const void* bp,
                            const void* u, const void* v, void* y, int M,
                            int N, int K, int R, void* stream) {
  return slab::dispatch_binlr(dtype, x, bp, u, v, y, 1, M, N, K, R, stream);
}

// The grouped forms without a sparse-binary pair: ws (E, N, K) or vals /
// idx (E, N, K/m, n), bp (E, N, K/32), u (E, R, N), v (E, R, K), x (E,
// M, K), y (E, M, N); one launch.
extern "C" int slab_lr_matmul_g(int dtype, const void* x, const void* ws,
                                const void* u, const void* v, void* y, int E,
                                int M, int N, int K, int R, void* stream) {
  return slab::dispatch_lr(dtype, x, ws, u, v, y, E, M, N, K, R, stream);
}

extern "C" int slab_nm_lr_matmul_g(int dtype, const void* x,
                                   const void* vals, const void* idx,
                                   const void* u, const void* v, void* y,
                                   int E, int M, int N, int K, int n_keep,
                                   int m_pat, int R, void* stream) {
  return slab::dispatch_nm_lr(dtype, x, vals, idx, u, v, y, E, M, N, K,
                              n_keep, m_pat, R, stream);
}

extern "C" int binlr_matmul_g(int dtype, const void* x, const void* bp,
                              const void* u, const void* v, void* y, int E,
                              int M, int N, int K, int R, void* stream) {
  return slab::dispatch_binlr(dtype, x, bp, u, v, y, E, M, N, K, R, stream);
}
