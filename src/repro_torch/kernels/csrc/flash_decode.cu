// flash_decode_paged and flash_decode: grouped-query single-token
// attention against a KV cache, online softmax in fp32,
//
//   out[r, h, g, :] = Σ_s p_s · V[s, h, :],  p = softmax_s(q[r, h, g] · K[s, h])
//
// over the first lengths[r] tokens of row r. q is pre-scaled by 1/√dh.
// The cache is in q's dtype, or int8 with one f32 scale per (token, head);
// int8 K and V are dequantized in registers (k · k_scale) before the dot,
// as the TPU kernel does in VMEM.
//
// flash_decode_paged replaces repro/kernels/flash_decode.py::
// flash_decode_paged (_paged_kernel, pallas_call at flash_decode.py:236):
// the cache is a pool of (n_blocks, bs, KV, dh) blocks and token s of row
// r lives in block block_tables[r, s / bs] at offset s % bs. The TPU
// kernel scalar-prefetches the table into its index maps; here each block
// reads the ids itself. Chunks past the length are never read, so a
// zero-length row touches nothing and returns exact zeros.
//
// flash_decode replaces repro/kernels/flash_decode.py::flash_decode
// (_kernel, pallas_call at flash_decode.py:130): the same body on a
// contiguous (B, S, KV, dh) cache, which is a pool of B blocks of S
// tokens with the identity table. The TPU kernel pads S to its chunk and
// never skips a chunk: a row of length 0 keeps its running max at -1e30,
// so every slot of the padded span, padding included, gets weight
// exp(0) = 1 and the row returns Σ_s V[s] / S_pad. This kernel keeps that
// result: at length 0 it reads all S tokens with masked scores and adds
// the pad_count = S_pad - S zero slots to the normaliser.
//
// Bound on the H100: bytes, (valid K + V [+ scales]; V alone on a
// length-0 contiguous row) + q + out, over 3.35 TB/s; two flops a byte at
// most, far below either compute peak.
//
// Design: one thread block per (kv head, row, chunk of query heads),
// kWarps warps. A chunk is all G heads of the group up to 16, fewer when
// the merge buffers below would pass the card's opt-in shared memory
// (G 16 at dh 256 needs 264 KB), so any G runs; a chunk rereads the
// group's K/V. Warps take
// tiles of kTok consecutive tokens in turn; every lane holds the dh
// elements d = lane + 32 i (coalesced loads, any dh up to 256, so
// stablelm's 160 works) of the tile's K and V and of the G query heads,
// so each K/V load serves all G heads of the group (the GQA reuse). The
// kTok tokens' loads are issued together, then each score is a warp
// reduction and the running max m, normaliser l and weighted sum acc (per
// head, fp32) are updated once per tile. The warps' partial states are
// merged in shared memory in warp order, so the result does not depend on
// scheduling; out = acc / max(l, 1e-30) in q's dtype. Split-KV across
// blocks (flash-decoding) is not done: a row of R · KV < 132 blocks
// leaves SMs idle, and the longest row sets the time. Each warp's token
// loop is serial work (2-byte loads a lane, a warp reduction per token
// and head), so more warps per block shorten the longest row's loop; at
// 16 warps the register file allows one block per SM.
#include "slab_common.cuh"

namespace fd {

using slab::from_f32;
using slab::to_f32;
using slab::warp_sum;

constexpr int kWarps = 16;    // warps per (row, kv head) block
constexpr int kTok = 4;       // tokens a warp loads per step
constexpr int kMaxDpl = 8;    // elements per lane: dh <= 256
constexpr int kMaxGc = 16;    // query heads one block takes (GP <= 16)
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  const unsigned short b = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float((uint32_t)b << 16);
}
__device__ __forceinline__ float ld(const int8_t* p) {
  return (float)__ldg(reinterpret_cast<const signed char*>(p));
}

// T: q / out (and an unquantized cache) type; KT: the cache element type
// (T, or int8_t with scales); GP: query heads per kv head, rounded up.
template <typename T, typename KT, int GP>
__global__ void __launch_bounds__(kWarps * 32)
flash_decode_kernel(const T* __restrict__ q, const KT* __restrict__ kc,
                    const KT* __restrict__ vc, const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ bt,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int KV, int G_all, int gc, int dh, int bs, int n_bt,
                    int n_blocks, int pad_count, int skip_empty) {
  extern __shared__ float sm[];   // acc (kWarps, G, dh), m, l (kWarps, G)
  const int h = blockIdx.x, r = blockIdx.y;
  const int g0 = blockIdx.z * gc;                // this block's query heads
  const int G = min(gc, G_all - g0);             // g0 .. g0 + G - 1
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int dpl = (dh + 31) / 32;
  const int len = lengths[r];
  const int n_max = n_bt * bs;
  const int n_proc = len > 0 ? min(len, n_max) : (skip_empty ? 0 : n_max);

  float qr[GP][kMaxDpl], acc[GP][kMaxDpl], m[GP], l[GP];
  const T* qp = q + (((size_t)r * KV + h) * G_all + g0) * dh;
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    m[g] = kNeg;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxDpl; ++i) {
      const int d = lane + 32 * i;
      acc[g][i] = 0.f;
      qr[g][i] = (g < G && i < dpl && d < dh) ? to_f32(qp[g * dh + d]) : 0.f;
    }
  }

  const int n_tiles = (n_proc + kTok - 1) / kTok;
  for (int t = warp; t < n_tiles; t += kWarps) {
    float kk[kTok][kMaxDpl], vv[kTok][kMaxDpl];
    bool live[kTok], scored[kTok];
#pragma unroll
    for (int j = 0; j < kTok; ++j) {
      const int pos = t * kTok + j;
      live[j] = pos < n_proc;
      scored[j] = pos < len;      // false only on a length-0 contiguous row
      size_t ro = 0;
      float ksc = 1.f, vsc = 1.f;
      if (live[j]) {
        int blk = bt ? bt[(size_t)r * n_bt + pos / bs] : r;
        blk = min(max(blk, 0), n_blocks - 1);
        ro = ((size_t)blk * bs + pos % bs) * KV + h;
        if (ks != nullptr) {
          if (scored[j]) ksc = __ldg(ks + ro);
          vsc = __ldg(vs + ro);
        }
      }
#pragma unroll
      for (int i = 0; i < kMaxDpl; ++i) {
        const int d = lane + 32 * i;
        const bool in = live[j] && i < dpl && d < dh;
        kk[j][i] = (in && scored[j]) ? ld(kc + ro * dh + d) * ksc : 0.f;
        vv[j][i] = in ? ld(vc + ro * dh + d) * vsc : 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      if (g >= G) break;
      float s[kTok];
      float mx = m[g];
#pragma unroll
      for (int j = 0; j < kTok; ++j) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxDpl; ++i) part += qr[g][i] * kk[j][i];
        part = warp_sum(part);
        s[j] = scored[j] ? part : kNeg;
        if (live[j]) mx = fmaxf(mx, s[j]);
      }
      const float alpha = expf(m[g] - mx);
      float p[kTok], psum = 0.f;
#pragma unroll
      for (int j = 0; j < kTok; ++j) {
        p[j] = live[j] ? expf(s[j] - mx) : 0.f;
        psum += p[j];
      }
      l[g] = l[g] * alpha + psum;
#pragma unroll
      for (int i = 0; i < kMaxDpl; ++i) {
        float a = acc[g][i] * alpha;
#pragma unroll
        for (int j = 0; j < kTok; ++j) a += p[j] * vv[j][i];
        acc[g][i] = a;
      }
      m[g] = mx;
    }
  }

  float* s_acc = sm;                                   // (kWarps, G, dh)
  float* s_m = sm + (size_t)kWarps * G * dh;           // (kWarps, G)
  float* s_l = s_m + kWarps * G;                       // (kWarps, G)
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int i = 0; i < kMaxDpl; ++i) {
      const int d = lane + 32 * i;
      if (i < dpl && d < dh) s_acc[((size_t)warp * G + g) * dh + d] = acc[g][i];
    }
    if (lane == 0) {
      s_m[warp * G + g] = m[g];
      s_l[warp * G + g] = l[g];
    }
  }
  __syncthreads();
  T* op = out + (((size_t)r * KV + h) * G_all + g0) * dh;
  for (int e = threadIdx.x; e < G * dh; e += blockDim.x) {
    const int g = e / dh, d = e - g * dh;
    float mf = kNeg;
    for (int w = 0; w < kWarps; ++w) mf = fmaxf(mf, s_m[w * G + g]);
    float lf = 0.f, af = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(s_m[w * G + g] - mf);
      lf += s_l[w * G + g] * c;
      af += s_acc[((size_t)w * G + g) * dh + d] * c;
    }
    lf += (float)pad_count * expf(kNeg - mf);
    op[g * dh + d] = from_f32<T>(af / fmaxf(lf, 1e-30f));
  }
}

inline size_t smem_bytes(int G, int dh) {
  return ((size_t)kWarps * G * dh + 2 * (size_t)kWarps * G) * sizeof(float);
}

template <typename T, typename KT, int GP>
static int launch_gp(const void* q, const void* k, const void* v,
                     const float* ks, const float* vs, const int* bt,
                     const int* lengths, void* out, int R, int KV, int G,
                     int gc, int dh, int bs, int n_bt, int n_blocks,
                     int pad_count, int skip_empty, void* stream) {
  auto kern = flash_decode_kernel<T, KT, GP>;
  const size_t smem = smem_bytes(gc, dh);
  cudaError_t e = slab::prepare(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(KV, R, (G + gc - 1) / gc);
  kern<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const KT*)k, (const KT*)v, ks, vs, bt, lengths, (T*)out,
      KV, G, gc, dh, bs, n_bt, n_blocks, pad_count, skip_empty);
  return (int)cudaGetLastError();
}

template <typename T, typename KT>
static int launch(const void* q, const void* k, const void* v,
                  const float* ks, const float* vs, const int* bt,
                  const int* lengths, void* out, int R, int KV, int G, int dh,
                  int bs, int n_bt, int n_blocks, int pad_count,
                  int skip_empty, void* stream) {
  // Query heads per block: all G up to kMaxGc, fewer when their merge
  // buffers pass the card's opt-in shared memory (G 16 at dh 256 needs
  // 264 KB); the grid's z dimension walks the chunks.
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  int gc = min(G, kMaxGc);
  while (gc > 1 && smem_bytes(gc, dh) > (size_t)optin) gc = (gc + 1) / 2;
  if (smem_bytes(gc, dh) > (size_t)optin) return (int)cudaErrorInvalidValue;
#define FD_LAUNCH(GP)                                                      \
  return launch_gp<T, KT, GP>(q, k, v, ks, vs, bt, lengths, out, R, KV, G, \
                              gc, dh, bs, n_bt, n_blocks, pad_count,       \
                              skip_empty, stream)
  if (gc <= 1) FD_LAUNCH(1);
  if (gc <= 4) FD_LAUNCH(4);
  if (gc <= 8) FD_LAUNCH(8);
  FD_LAUNCH(16);
#undef FD_LAUNCH
}

static int dispatch(int dtype, int quant, const void* q, const void* k,
                    const void* v, const float* ks, const float* vs,
                    const int* bt, const int* lengths, void* out, int R,
                    int KV, int G, int dh, int bs, int n_bt, int n_blocks,
                    int pad_count, int skip_empty, void* stream) {
  if (R <= 0 || KV <= 0 || G <= 0 || dh <= 0 || dh > 32 * kMaxDpl ||
      bs <= 0 || n_bt <= 0 || n_blocks <= 0 || pad_count < 0 || R > 65535 ||
      (G + kMaxGc - 1) / kMaxGc > 65535)
    return (int)cudaErrorInvalidValue;
  if (quant && (ks == nullptr || vs == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!quant) ks = vs = nullptr;
#define FD_ARGS q, k, v, ks, vs, bt, lengths, out, R, KV, G, dh, bs, n_bt, \
                n_blocks, pad_count, skip_empty, stream
  if (dtype == 0)
    return quant ? launch<float, int8_t>(FD_ARGS)
                 : launch<float, float>(FD_ARGS);
  if (dtype == 1)
    return quant ? launch<__nv_bfloat16, int8_t>(FD_ARGS)
                 : launch<__nv_bfloat16, __nv_bfloat16>(FD_ARGS);
#undef FD_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace fd

// dtype of q / out (and of an unquantized cache): 0 = float32,
// 1 = bfloat16. quant: the cache is int8 with f32 scales ks / vs. Launch
// on ``stream``, allocate nothing, return cudaGetLastError().

// q (R, KV, G, dh); k / v pools (n_blocks, bs, KV, dh); ks / vs
// (n_blocks, bs, KV); block_tables (R, n_bt) int32; lengths (R,) int32.
extern "C" int flash_decode_paged(int dtype, int quant, const void* q,
                                  const void* k, const void* v,
                                  const float* ks, const float* vs,
                                  const int* block_tables,
                                  const int* lengths, void* out, int R,
                                  int KV, int G, int dh, int n_blocks, int bs,
                                  int n_bt, void* stream) {
  if (block_tables == nullptr) return (int)cudaErrorInvalidValue;
  return fd::dispatch(dtype, quant, q, k, v, ks, vs, block_tables, lengths,
                      out, R, KV, G, dh, bs, n_bt, n_blocks, 0, 1, stream);
}

// q (B, KV, G, dh); k / v (B, S, KV, dh); ks / vs (B, S, KV); lengths (B,)
// int32, each <= S; pad_count = S_pad - S, the zero slots the reference's
// chunking adds (weighted only on a length-0 row).
extern "C" int flash_decode(int dtype, int quant, const void* q,
                            const void* k, const void* v, const float* ks,
                            const float* vs, const int* lengths, void* out,
                            int B, int KV, int G, int dh, int S,
                            int pad_count, void* stream) {
  return fd::dispatch(dtype, quant, q, k, v, ks, vs, nullptr, lengths, out,
                      B, KV, G, dh, S, 1, B, pad_count, 0, stream);
}
