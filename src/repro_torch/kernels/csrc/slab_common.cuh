// Shared device helpers of the SLaB kernels: the counterpart of
// repro/kernels/common.py (bit unpack, the binary ⊙ rank-r term and the
// no-binary low-rank projection).
//
// Layout of every kernel in this directory: one warp owns one output
// row n of y (M, N) and loops over the whole of K; a block's kWarps warps
// cover consecutive rows and share one shared-memory tile of x. The
// batch rows of x are staged MTP at a time (MTP a power of two <= 8; x is
// tiny on the serve path, M = 1-8), so the weight planes stream from
// device memory once per M tile and x is read from shared memory, out of
// the critical path. Weight planes are read with 16-byte vector loads.
// Accumulation is fp32; y is written in x's dtype.
//
// Sign words: bit j of word w is column 32w + j, a set bit means +1.
// Words are read as uint32 (the host carries them as int32 views).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace slab {

constexpr int kWarps = 16;   // output rows per block (one warp each)
constexpr int kMaxMt = 8;    // batch rows of x staged per pass

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// Elements of T in one 16-byte vector.
template <typename T> struct Vec { static constexpr int n = 16 / sizeof(T); };

// 16 bytes at p (16-byte aligned) -> Vec<T>::n floats.
__device__ __forceinline__ void load16(const float* p, float (&o)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  o[0] = q.x; o[1] = q.y; o[2] = q.z; o[3] = q.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&o)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // bf16 -> f32 is a 16-bit shift
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
// The same from device memory, through the read-only path.
__device__ __forceinline__ void ldg16(const float* p, float (&o)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = q.x; o[1] = q.y; o[2] = q.z; o[3] = q.w;
}
__device__ __forceinline__ void ldg16(const __nv_bfloat16* p, float (&o)[8]) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// N consecutive values of type E as one (up to 16-byte aligned) load
// or store.
template <typename E, int N>
struct alignas(sizeof(E) * N < 16 ? sizeof(E) * N : 16) Pack {
  E v[N];
};

template <typename E, int N>
__device__ __forceinline__ Pack<E, N> load_pack(const E* p) {
  return *reinterpret_cast<const Pack<E, N>*>(p);
}

__host__ __device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Stage one M tile (rows m0 .. m0+mt-1 of x, zero rows up to MTP):
//   xv[m * K + k] = x[m0 + m, k] * v_r[k], rounded to T — the reference
//     forms x ⊙ v_r in x.dtype before the ±1 contraction, so the bf16
//     kernel rounds there too. It does not depend on the output row, so
//     the block forms it once per M tile and rank;
//   xs (unless null): x itself, row-major xs[m * K + k] or, with COLS,
//     column-major xs[k * MTP + m] so one load fetches every batch row of
//     a gathered column.
// x and v are read in 16-byte chunks when aligned (one chunk per thread
// per step), else element by element.
template <typename T, int MTP, bool COLS>
__device__ __forceinline__ void stage_tile(T* xs, T* xv,
                                           const T* __restrict__ x,
                                           const T* __restrict__ vr, int m0,
                                           int mt, int K) {
  constexpr int V = Vec<T>::n;
  const int nch = K / V;
  const bool vec = aligned16(x) && aligned16(vr);
  for (int i = threadIdx.x; i < MTP * nch; i += blockDim.x) {
    const int m = i / nch, k0 = (i - m * nch) * V;
    float xf[V], vf[V];
    if (m < mt) {
      const T* xp = x + (size_t)(m0 + m) * K + k0;
      if (vec) {
        ldg16(xp, xf);
        ldg16(vr + k0, vf);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          xf[j] = to_f32(xp[j]);
          vf[j] = to_f32(vr[k0 + j]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) xf[j] = vf[j] = 0.f;
    }
    Pack<T, V> pv;
#pragma unroll
    for (int j = 0; j < V; ++j) pv.v[j] = from_f32<T>(xf[j] * vf[j]);
    *reinterpret_cast<Pack<T, V>*>(xv + m * K + k0) = pv;
    if (xs == nullptr) continue;
    if (COLS) {
#pragma unroll
      for (int j = 0; j < V; ++j) xs[(k0 + j) * MTP + m] = from_f32<T>(xf[j]);
    } else {
      Pack<T, V> px;
#pragma unroll
      for (int j = 0; j < V; ++j) px.v[j] = from_f32<T>(xf[j]);
      *reinterpret_cast<Pack<T, V>*>(xs + m * K + k0) = px;
    }
  }
}

// Stage one M tile of x alone (no x ⊙ v): rows m0 .. m0+mt-1, zero rows
// up to MTP, row-major xs[m * K + k] or, with COLS, column-major
// xs[k * MTP + m]. Any K: 16-byte chunks when K is a multiple of the
// vector width and x is aligned, else element by element.
template <typename T, int MTP, bool COLS>
__device__ __forceinline__ void stage_x(T* xs, const T* __restrict__ x,
                                        int m0, int mt, int K) {
  constexpr int V = Vec<T>::n;
  if (K % V == 0 && aligned16(x)) {
    const int nch = K / V;
    for (int i = threadIdx.x; i < MTP * nch; i += blockDim.x) {
      const int m = i / nch, k0 = (i - m * nch) * V;
      float xf[V];
      if (m < mt) {
        ldg16(x + (size_t)(m0 + m) * K + k0, xf);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) xf[j] = 0.f;
      }
      if (COLS) {
#pragma unroll
        for (int j = 0; j < V; ++j) xs[(k0 + j) * MTP + m] = from_f32<T>(xf[j]);
      } else {
        Pack<T, V> px;
#pragma unroll
        for (int j = 0; j < V; ++j) px.v[j] = from_f32<T>(xf[j]);
        *reinterpret_cast<Pack<T, V>*>(xs + m * K + k0) = px;
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < MTP * K; i += blockDim.x) {
    const int m = i / K, k = i - m * K;
    const T val = m < mt ? x[(size_t)(m0 + m) * K + k] : from_f32<T>(0.f);
    xs[COLS ? k * MTP + m : m * K + k] = val;
  }
}

// Ask L2 for [p, p + bytes): one prefetch per 128-byte line, spread over
// the warp's lanes. Issued before the block stages x, so the row's
// planes are on their way while the tile is built.
__device__ __forceinline__ void prefetch_l2(const void* p, size_t bytes,
                                            int lane) {
  const uintptr_t lo = reinterpret_cast<uintptr_t>(p) & ~uintptr_t(127);
  const uintptr_t hi = reinterpret_cast<uintptr_t>(p) + bytes;
  for (uintptr_t q = lo + 128 * (uintptr_t)lane; q < hi; q += 32 * 128)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(q));
}

// One pass over the columns of a row, Vec<T>::n consecutive columns per
// lane per step (16-byte loads; consecutive lanes on consecutive
// chunks, so device loads coalesce and shared loads are conflict-free):
//   part[m] += Σ_k s[row, k] · xv[m, k]             (binary term)
//   acc[m]  += Σ_k W_S[row, k] · xs[m, k]           (if ws_row != null)
// The ±1 is applied by flipping the sign bit of xv, no select.
template <typename T, int MTP>
__device__ __forceinline__ void column_pass(
    float (&acc)[MTP], float (&part)[MTP], const T* xs, const T* xv, int K,
    const uint32_t* __restrict__ bp_row, const T* __restrict__ ws_row,
    int lane) {
  constexpr int V = Vec<T>::n;
  const int nch = K / V;
#pragma unroll 2
  for (int c = lane; c < nch; c += 32) {
    const int k0 = c * V;
    const uint32_t word = __ldg(bp_row + (k0 >> 5)) >> (k0 & 31);
    float w[V];
    if (ws_row != nullptr) ldg16(ws_row + k0, w);
#pragma unroll
    for (int m = 0; m < MTP; ++m) {
      float t[V];
      load16(xv + m * K + k0, t);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const uint32_t flip = (~(word >> j) & 1u) << 31;
        part[m] += __uint_as_float(__float_as_uint(t[j]) ^ flip);
      }
      if (ws_row != nullptr) {
        float xx[V];
        load16(xs + m * K + k0, xx);
#pragma unroll
        for (int j = 0; j < V; ++j) acc[m] += w[j] * xx[j];
      }
    }
  }
}

// One pass over a dense row of W_S against the row-major x tile:
//   acc[m] += Σ_k W_S[row, k] · xs[m, k]
// 16-byte loads when K is a multiple of the vector width (the row then
// starts aligned), else one element per lane per step.
template <typename T, int MTP>
__device__ __forceinline__ void dense_pass(float (&acc)[MTP], const T* xs,
                                           const T* __restrict__ ws_row,
                                           int K, int lane) {
  constexpr int V = Vec<T>::n;
  if (K % V == 0) {
    const int nch = K / V;
#pragma unroll 2
    for (int c = lane; c < nch; c += 32) {
      const int k0 = c * V;
      float w[V];
      ldg16(ws_row + k0, w);
#pragma unroll
      for (int m = 0; m < MTP; ++m) {
        float xx[V];
        load16(xs + m * K + k0, xx);
#pragma unroll
        for (int j = 0; j < V; ++j) acc[m] += w[j] * xx[j];
      }
    }
    return;
  }
  for (int k = lane; k < K; k += 32) {
    const float w = to_f32(ws_row[k]);
#pragma unroll
    for (int m = 0; m < MTP; ++m) acc[m] += w * to_f32(xs[m * K + k]);
  }
}

// The no-binary low-rank projection of one staged M tile, formed once
// per block: p[r * MTP + m] = Σ_k x[m, k] · v_r[k] in fp32 from fp32
// copies of x and v (the reference does not round it through x's dtype).
// Every warp takes a strided share of K; the kWarps partial sums go
// through part (kWarps · R · MTP floats) and are added in warp order, so
// the result does not depend on scheduling. Contains __syncthreads: the
// whole block calls it.
template <typename T, int MTP, bool COLS>
__device__ __forceinline__ void lowrank_proj(float* p, float* part,
                                             const T* xs,
                                             const T* __restrict__ v, int K,
                                             int R) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = 0; r < R; ++r) {
    const T* vr = v + (size_t)r * K;
    float acc[MTP];
#pragma unroll
    for (int m = 0; m < MTP; ++m) acc[m] = 0.f;
    for (int k = warp * 32 + lane; k < K; k += kWarps * 32) {
      const float vk = to_f32(vr[k]);
#pragma unroll
      for (int m = 0; m < MTP; ++m)
        acc[m] += to_f32(xs[COLS ? k * MTP + m : m * K + k]) * vk;
    }
#pragma unroll
    for (int m = 0; m < MTP; ++m) {
      const float t = warp_sum(acc[m]);
      if (lane == 0) part[(warp * R + r) * MTP + m] = t;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R * MTP; i += blockDim.x) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += part[w * R * MTP + i];
    p[i] = t;
  }
  __syncthreads();
}

// One gathered column of the column-major x tile: every batch row.
template <typename T, int MTP>
__device__ __forceinline__ void gather_add(float (&acc)[MTP], const T* xk,
                                           int col, float w) {
  const Pack<T, MTP> q = load_pack<T, MTP>(xk + (size_t)col * MTP);
#pragma unroll
  for (int m = 0; m < MTP; ++m) acc[m] += w * to_f32(q.v[m]);
}

// Stream one row's stored sparse entries e in [0, count): value vrow[e],
// code irow[e]; col_of(e, code) gives the column (or -1 to skip). The
// row may start anywhere (ELL rows are K_max long), so a scalar head
// reaches the first 16-byte boundary, the body loads Vec<T>::n values
// and codes per lane, and a scalar tail finishes.
template <typename T, typename I, int MTP, typename ColOf>
__device__ __forceinline__ void sparse_pass(float (&acc)[MTP], const T* xk,
                                            const T* __restrict__ vrow,
                                            const I* __restrict__ irow,
                                            size_t start, int count,
                                            ColOf col_of, int lane) {
  constexpr int V = Vec<T>::n;
  int head = (int)((V - (int)(start % V)) % V);
  head = head < count ? head : count;
  for (int e = lane; e < head; e += 32) {
    const int col = col_of(e, irow[e]);
    if (col >= 0) gather_add<T, MTP>(acc, xk, col, to_f32(vrow[e]));
  }
  const int nv = (count - head) / V;
#pragma unroll 2
  for (int c = lane; c < nv; c += 32) {
    const int e0 = head + c * V;
    float w[V];
    ldg16(vrow + e0, w);
    const Pack<I, V> q = load_pack<I, V>(irow + e0);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int col = col_of(e0 + j, q.v[j]);
      if (col >= 0) gather_add<T, MTP>(acc, xk, col, w[j]);
    }
  }
  for (int e = head + nv * V + lane; e < count; e += 32) {
    const int col = col_of(e, irow[e]);
    if (col >= 0) gather_add<T, MTP>(acc, xk, col, to_f32(vrow[e]));
  }
}

// Warp-reduce acc and write y[m0 + m, row] for m < mt. With a projection
// p (lowrank_proj) the low-rank term Σ_r p[r, m] · u_r[row] is added to
// the reduced sum before the store, in fp32.
template <typename T, int MTP>
__device__ __forceinline__ void store_row(float (&acc)[MTP],
                                          T* __restrict__ y, int m0, int mt,
                                          int N, int row, int lane,
                                          const float* p = nullptr,
                                          const T* __restrict__ u = nullptr,
                                          int R = 0) {
#pragma unroll
  for (int m = 0; m < MTP; ++m) {
    float t = warp_sum(acc[m]);
    if (lane == 0 && m < mt) {
      if (p != nullptr) {
        float lr = 0.f;
        for (int r = 0; r < R; ++r)
          lr += p[r * MTP + m] * to_f32(u[(size_t)r * N + row]);
        t += lr;
      }
      y[(size_t)(m0 + m) * N + row] = from_f32<T>(t);
    }
  }
}

__host__ __device__ constexpr size_t align16_up(size_t b) {
  return (b + 15) & ~size_t(15);
}

// Host side: the batch-tile width MTP (a power of two, <= kMaxMt, no
// wider than M needs) whose ``tiles`` shared tiles of MTP·K elements
// (x, and x ⊙ v for the binary kernels), rounded up to 16 bytes, plus
// ``extra`` bytes fit the card's shared memory per block. 0 when even
// MTP = 1 does not.
inline int pick_mtp(int M, int K, size_t elt, size_t* smem, int tiles = 2,
                    size_t extra = 0) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  int mtp = 1;
  while (mtp < kMaxMt && mtp < M) mtp *= 2;
  auto bytes = [&](int t) {
    return align16_up((size_t)tiles * K * elt * t) + extra;
  };
  while (mtp >= 1 && bytes(mtp) > (size_t)optin) mtp /= 2;
  *smem = mtp ? bytes(mtp) : 0;
  return mtp;
}

// Shared bytes of lowrank_proj's projection and partial sums at rank R
// (sized for the widest tile, kMaxMt).
inline size_t lowrank_smem(int R) {
  return (size_t)(kWarps + 1) * kMaxMt * R * sizeof(float);
}

template <typename Kern>
inline cudaError_t prepare(Kern kernel, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  return cudaSuccess;
}

// One thread's copy of `bytes` (a multiple of 16) from device memory into
// shared memory by the tensor memory accelerator; completion is counted
// on the mbarrier `bar` (cp.async.bulk, sm_90).
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// The one arrival of a phase, expecting `bytes` of bulk copies.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// Grouped-expert launches put the expert on the grid's y dimension (one
// launch for a bucket of E experts; a 2-D launch has E = 1). A kernel
// moves its per-expert operands x (E, M, K), y (E, M, N), u (E, R, N)
// and v (E, R, K) to blockIdx.y's slice and addresses its weight planes
// by the global row e·N + row of the stacked (E·N, ...) planes, from
// their 16-byte aligned base, so a row's alignment is that of its global
// row.
constexpr int kMaxExperts = 65535;   // the grid's y limit

// Run the statement(s) with a constexpr MTP equal to the runtime tile
// width chosen by pick_mtp.
#define SLAB_DISPATCH_MTP(mtp, ...)                            \
  switch (mtp) {                                               \
    case 1: { constexpr int MTP = 1; __VA_ARGS__; } break;     \
    case 2: { constexpr int MTP = 2; __VA_ARGS__; } break;     \
    case 4: { constexpr int MTP = 4; __VA_ARGS__; } break;     \
    case 8: { constexpr int MTP = 8; __VA_ARGS__; } break;     \
    default: return (int)cudaErrorInvalidValue;                \
  }

}  // namespace slab
