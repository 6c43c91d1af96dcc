// flash_decode_paged and flash_decode: grouped-query single-token
// attention against a KV cache, online softmax in fp32,
//
//   out[r, h, g, :] = Σ_s p_s · V[s, h, :],  p = softmax_s(q[r, h, g] · K[s, h])
//
// over the first lengths[r] tokens of row r. q is pre-scaled by 1/√dh.
// The cache is in q's dtype, or int8 with one f32 scale per (token, head);
// an int8 token's scale multiplies its dot (k_scale) and its softmax
// weight (v_scale), which is the reference's dequantize-then-dot up to
// rounding.
//
// flash_decode_paged replaces repro/kernels/flash_decode.py::
// flash_decode_paged (_paged_kernel, pallas_call at flash_decode.py:236):
// the cache is a pool of (n_blocks, bs, KV, dh) blocks and token s of row
// r lives in block block_tables[r, s / bs] at offset s % bs (ids clamped
// to the pool). Tokens past the length are never read, so a zero-length
// row touches nothing and returns exact zeros.
//
// flash_decode replaces repro/kernels/flash_decode.py::flash_decode
// (_kernel, pallas_call at flash_decode.py:130): the same body on a
// contiguous (B, S, KV, dh) cache, which is a pool of B blocks of S
// tokens with the identity table. The TPU kernel pads S to its chunk and
// never skips a chunk: a row of length 0 keeps its running max at -1e30,
// so every slot of the padded span, padding included, gets weight
// exp(0) = 1 and the row returns Σ_s V[s] / S_pad. This kernel keeps that
// result: at length 0 it reads V (not K) of all S tokens with masked
// scores and adds the pad_count = S_pad - S zero slots to the normaliser.
//
// Bound on the H100: bytes, (valid K + V [+ scales]; V alone on a
// length-0 contiguous row) + q + out, over 3.35 TB/s; at most 2·G flops a
// cache element, far below the fp32 peak for the G of the models.
//
// Design (flash-decoding): the grid is (split x query-head chunk, kv
// head, row). A split is split_len consecutive tokens of a row; the host
// picks split_len from shapes alone (flash_decode.py plan_splits) so the
// grid fills the card whatever the lengths, and a split that starts past
// its row's length exits at once. A block of 4 warps streams its split in
// tiles of kTile tokens through a ring of kStages shared-memory stages:
// each K and V row of a tile arrives by one bulk copy (the tensor memory
// accelerator, cp.async.bulk, completion on the stage's mbarrier), 16
// rows a warp; the next tile, and on the paged path the block ids of the
// one after, are in flight while the current tile is scored.
// Every query head of the chunk reads the tile from shared memory, which
// is where the GQA reuse comes from, and per-lane state is the same at
// any G:
//   scores   lane = token; a warp takes (head, slice of dh) tasks and
//            dots the K row with q (in shared memory, f32);
//   softmax  one warp per head: max and sum over the tile's 32 tokens by
//            shuffles, running m / l in shared memory;
//   p·V      a thread owns up to kItems (head, 8 columns, token phase)
//            items with 8 fp32 sums each in registers;
// then the items are summed over token phases. A row with one live split
// is normalised and written out by that block; otherwise each split
// writes (m, l, acc) in fp32 to the caller's scratch and combine_kernel
// merges the row's splits in split order (no atomics: the result does
// not depend on scheduling). K/V rows are padded in shared memory to an
// odd number of 16-byte units, so the lanes' 16-byte reads of 32
// different rows do not conflict. What binds (PERF.md §6): at decode
// shapes each tile's chain of dependent steps (three block barriers,
// shuffles, shared-memory round trips) rather than the bytes; the split
// count trades that latency against per-block set-up and the merge.
#include <algorithm>

#include "slab_common.cuh"

namespace fd {

using slab::bulk_copy;
using slab::from_f32;
using slab::mbar_expect;
using slab::mbar_init;
using slab::mbar_wait;
using slab::to_f32;
using slab::warp_sum;

constexpr int kThreads = 128;               // 4 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                   // tokens a stage (a lane each)
constexpr int kStages = 2;                  // ring depth
constexpr int kItems = 4;                   // p·V items a thread
constexpr int kMaxUnits = kItems * kThreads;  // heads x dh_pad / 8 a block
constexpr int kMaxHeads = 64;               // query heads a block
constexpr int kMaxSplits = 1024;
constexpr float kNeg = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;        // int8 scales (n_blocks, bs, KV), else null
  const float* vs;
  const int* bt;          // (R, n_bt) block ids, null for contiguous
  const int* lengths;     // (R,)
  void* out;              // (R, KV, G, dh)
  float* part;            // (R, KV, G, n_split, dh) acc, then (.., 2) m, l
  int R, KV, G, gc, dh, dh_pad, rb, slices, jt;
  int bs, n_bt, n_blocks, pad_count, skip_empty, split_len, n_split;
  int ring_bytes;
};

// 8 consecutive cache elements in shared memory -> fp32.
__device__ __forceinline__ void unit8(const float* p, float (&o)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void unit8(const __nv_bfloat16* p, float (&o)[8]) {
  slab::load16(p, o);
}
__device__ __forceinline__ void unit8(const int8_t* p, float (&o)[8]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[i] = (float)(int8_t)(w.x >> (8 * i));
    o[4 + i] = (float)(int8_t)(w.y >> (8 * i));
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int N> struct RawOf;
template <> struct RawOf<1> { using type = uint8_t; };
template <> struct RawOf<2> { using type = uint16_t; };
template <> struct RawOf<4> { using type = uint32_t; };

// Tokens a split processes: all S slots on a length-0 contiguous row.
__device__ __forceinline__ int n_processed(int len, int n_max,
                                           int skip_empty) {
  return len > 0 ? min(len, n_max) : (skip_empty ? 0 : n_max);
}

// T: q / out type; KT: the cache element type (T, or int8_t with scales);
// VEC: rows of dh · sizeof(KT) bytes, a multiple of 16, on 16-byte
// boundaries (bulk copies), else element copies.
template <typename T, typename KT, bool VEC>
__global__ void __launch_bounds__(kThreads)
attend_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[kStages];     // a stage's copies
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int split = blockIdx.x % p.n_split;
  const int g0 = (blockIdx.x / p.n_split) * p.gc;
  const int h = blockIdx.y, r = blockIdx.z;
  const int G = min(p.gc, p.G - g0);
  const int len = p.lengths[r];
  const int n_max = p.n_bt * p.bs;
  const int t0 = split * p.split_len;
  // This lane's token in the next tile (tiles 0, 1, 2, ... in turn): its
  // position, table column and offset advance by kTile a tile without a
  // division, and on the paged path its table entry is read a tile ahead
  // (the first before the length is known).
  const int* bt_row = p.bt == nullptr ? nullptr : p.bt + (size_t)r * p.n_bt;
  const int step_col = kTile / p.bs, step_off = kTile - step_col * p.bs;
  int pos = t0 + lane, col = pos / p.bs, off = pos - col * p.bs;
  int blk_next = r;
  if (bt_row != nullptr && pos < n_max) blk_next = __ldg(bt_row + col);
  const int n_proc = n_processed(len, n_max, p.skip_empty);
  const int n_scored = len > 0 ? min(len, n_max) : 0;   // K is read below
  const int t1 = min(t0 + p.split_len, n_proc);
  if (t0 > 0 && t0 >= n_proc) return;            // past the row's length
  // A row with one live split (or none: a paged length-0 row) is written
  // out here; the merge skips it.
  const bool direct = n_proc <= p.split_len;

  const int units = p.dh_pad / 8;
  const int gu = G * units;
  const int stage_bytes = 2 * kTile * p.rb + 2 * kTile * (int)sizeof(float);
  unsigned char* ring = smem;
  float* qbuf = reinterpret_cast<float*>(smem + p.ring_bytes);  // (G, dh_pad)
  float* sp = qbuf + p.gc * p.dh_pad;        // (G, slices, kTile) dots
  float* pw = sp + p.gc * p.slices * kTile;  // (G, kTile) weights
  float* st_m = pw + p.gc * kTile;           // running max, sum, rescale
  float* st_l = st_m + p.gc;
  float* st_a = st_l + p.gc;

  const T* qp = static_cast<const T*>(p.q) +
                (((size_t)r * p.KV + h) * p.G + g0) * p.dh;
  for (int e = threadIdx.x; e < G * p.dh_pad; e += kThreads) {
    const int g = e / p.dh_pad, d = e - g * p.dh_pad;
    qbuf[e] = d < p.dh ? to_f32(qp[g * p.dh + d]) : 0.f;
  }
  for (int g = threadIdx.x; g < G; g += kThreads) {
    st_m[g] = kNeg;
    st_l[g] = 0.f;
  }

  // p·V items: item i = j * gu + task, task = g * units + u (8 columns
  // from 8u), j the token phase (tokens j, j + jt, ...).
  const int n_items = gu * p.jt;
  int it_g[kItems], it_u[kItems], it_j[kItems];
  float acc[kItems][8];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const int j = i / gu, task = i - j * gu;
    it_j[k] = i < n_items ? j : kTile;       // kTile: an empty item
    it_g[k] = task / units;
    it_u[k] = task - it_g[k] * units;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[k][e] = 0.f;
  }

  using Raw = typename RawOf<sizeof(KT)>::type;   // the element's bits
  const KT* kc = static_cast<const KT*>(p.k);
  const KT* vc = static_cast<const KT*>(p.v);
  const bool quant = p.ks != nullptr;
  // The lane's token row (token-head row of dh elements) in the next
  // tile, -1 past the split.
  auto next_row = [&]() -> int {
    int row = -1;
    if (pos < t1) {
      const int blk = min(max(blk_next, 0), p.n_blocks - 1);
      row = (blk * p.bs + (bt_row != nullptr ? off : pos)) * p.KV + h;
    }                                        // < 2^31 (dispatch)
    pos += kTile;
    col += step_col;
    off += step_off;
    if (off >= p.bs) {
      off -= p.bs;
      ++col;
    }
    if (bt_row != nullptr && pos < t1) blk_next = __ldg(bt_row + col);
    return row;
  };
  // Tile t's copies into its stage, K rows then V rows. VEC: one bulk
  // copy a row, 16 a warp (bulk copies from one warp issue one at a
  // time), and thread 0 arms the stage's mbarrier with the bytes to
  // expect.
  // Else every thread copies elements (piece x, x + kThreads, ..., of
  // 2·kTile rows of dh_pad, zero past dh; its first (row, piece) and its
  // step are worked out once). int8 scales arrive by 4-byte cp.async.
  const int iters = (2 * kTile * p.dh_pad + kThreads - 1) / kThreads;
  const int ri0 = threadIdx.x / p.dh_pad, pc0 = threadIdx.x - ri0 * p.dh_pad;
  const int dri = kThreads / p.dh_pad, dpc = kThreads - dri * p.dh_pad;
  const uint32_t row_bytes = p.dh * (uint32_t)sizeof(KT);
  if (VEC && threadIdx.x < kStages) {
    mbar_init(&bars[threadIdx.x]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // Every thread calls it (both paths shuffle rows between lanes).
  auto issue = [&](int t, int row) {
    unsigned char* st = ring + (t % kStages) * stage_bytes;
    const int base = t0 + t * kTile;
    const int nv = min(kTile, t1 - base);               // V rows
    const int nk = max(0, min(nv, n_scored - base));    // K rows
    if (VEC) {
      // warp w: tokens 8w .. 8w + 7, lanes 0-7 their K rows, 8-15 V
      if (threadIdx.x == 0) mbar_expect(&bars[t % kStages],
                                        (nk + nv) * row_bytes);
      const int tok = warp * 8 + (lane & 7), is_v = (lane >> 3) & 1;
      const int rw = __shfl_sync(0xffffffffu, row, tok);
      if (lane < 16 && tok < (is_v ? nv : nk))
        bulk_copy(st + (is_v * kTile + tok) * p.rb,
                  (is_v ? vc : kc) + (size_t)rw * p.dh, row_bytes,
                  &bars[t % kStages]);
    } else {
      int ri = ri0, pc = pc0;
      for (int it = 0; it < iters; ++it) {
        const int which = ri >= kTile, tok = ri - which * kTile;
        const int rw = __shfl_sync(0xffffffffu, row, tok & 31);
        if (ri < 2 * kTile && tok < (which ? nv : nk)) {
          const Raw* src = reinterpret_cast<const Raw*>(which ? vc : kc) +
                           (size_t)rw * p.dh;
          reinterpret_cast<Raw*>(st + ri * p.rb)[pc] =
              pc < p.dh ? src[pc] : Raw(0);
        }
        ri += dri;
        pc += dpc;
        if (pc >= p.dh_pad) {
          pc -= p.dh_pad;
          ++ri;
        }
      }
    }
    if (quant && warp >= 2) {      // warp 2: K scales, warp 3: V scales
      const int w = warp - 2;
      float* sc = reinterpret_cast<float*>(st + 2 * kTile * p.rb);
      if (lane < (w ? nv : nk))
        cp_async4(sc + w * kTile + lane, (w ? p.vs : p.ks) + row);
    }
  };

  // With several slices a head (G · slices <= kWarps), warp w's one
  // scoring task: head sc_g, units [sc_u0, sc_u1).
  const int sc_g = warp / p.slices, sc_sl = warp - sc_g * p.slices;
  const int sc_u0 = sc_sl * units / p.slices;
  const int sc_u1 = (sc_sl + 1) * units / p.slices;

  const int n_tiles = t1 > t0 ? (t1 - t0 + kTile - 1) / kTile : 0;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    const int row = next_row();
    if (s < n_tiles) issue(s, row);
    cp_async_commit();
  }
  int row_next = next_row();
  for (int t = 0; t < n_tiles; ++t) {
    if (VEC) mbar_wait(&bars[t % kStages], (t / kStages) & 1);
    cp_async_wait<kStages - 2>();
    __syncthreads();                 // tile t landed; stage t-1 is free
    // The barrier orders every thread's reads of stage t-1 (generic proxy)
    // before this point; each thread that then issues a bulk copy into
    // that stage (async proxy) fences the two proxies itself, so the copy
    // cannot overtake those reads. Every thread runs the fence (one a
    // tile), so whichever lanes issue are covered.
    if (VEC) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const int tn = t + kStages - 1;
    if (tn < n_tiles) issue(tn, row_next);
    cp_async_commit();
    row_next = next_row();

    const unsigned char* st = ring + (t % kStages) * stage_bytes;
    const float* sc = reinterpret_cast<const float*>(st + 2 * kTile * p.rb);
    const int base = t0 + t * kTile;
    const int n_live = min(kTile, t1 - base);

    // scores: lane = token, a warp per (head, slice of dh) task
    const KT* krow = reinterpret_cast<const KT*>(st + lane * p.rb);
    for (int task = warp; task < G * p.slices; task += kWarps) {
      const bool one = p.slices == 1;          // else one task a warp
      const int g = one ? task : sc_g;
      const int u1 = one ? units : sc_u1;
      const float* qg = qbuf + g * p.dh_pad;
      float s = 0.f;
#pragma unroll 4
      for (int u = one ? 0 : sc_u0; u < u1; ++u) {
        float kv8[8];
        unit8(krow + u * 8, kv8);
        const float4 qa = reinterpret_cast<const float4*>(qg + u * 8)[0];
        const float4 qb = reinterpret_cast<const float4*>(qg + u * 8)[1];
        s += qa.x * kv8[0] + qa.y * kv8[1] + qa.z * kv8[2] + qa.w * kv8[3] +
             qb.x * kv8[4] + qb.y * kv8[5] + qb.z * kv8[6] + qb.w * kv8[7];
      }
      sp[task * kTile + lane] = s;
    }
    // one slice a head: the warp that scored head g also normalises it
    if (p.slices > 1)
      __syncthreads();
    else
      __syncwarp();

    // online softmax over the tile, one warp per head
    for (int g = warp; g < G; g += kWarps) {
      const bool live = lane < n_live;
      float s = kNeg;
      if (live && base + lane < n_scored) {
        s = 0.f;
#pragma unroll 4
        for (int sl = 0; sl < p.slices; ++sl)
          s += sp[(g * p.slices + sl) * kTile + lane];
        if (quant) s *= sc[lane];
      }
      const float m_old = st_m[g];
      const float mx = fmaxf(m_old, warp_max(live ? s : kNeg));
      const float e = live ? expf(s - mx) : 0.f;
      const float sum = warp_sum(e);
      const float alpha = expf(m_old - mx);
      pw[g * kTile + lane] = quant ? e * sc[kTile + lane] : e;
      __syncwarp();
      if (lane == 0) {
        st_m[g] = mx;
        st_l[g] = st_l[g] * alpha + sum;
        st_a[g] = alpha;
      }
    }
    __syncthreads();

    // p·V into the items' registers
    const unsigned char* vrows = st + kTile * p.rb;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (it_j[k] >= kTile) continue;
      const int g = it_g[k];
      const float alpha = st_a[g];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[k][e] *= alpha;
#pragma unroll 4
      for (int tk = it_j[k]; tk < n_live; tk += p.jt) {
        const float w = pw[g * kTile + tk];
        float v8[8];
        unit8(reinterpret_cast<const KT*>(vrows + tk * p.rb) + it_u[k] * 8,
              v8);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[k][e] += w * v8[e];
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                   // the ring becomes the merge buffer

  float* mb = reinterpret_cast<float*>(ring);        // (n_items, 8)
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (it_j[k] >= kTile) continue;
    float* o = mb + (size_t)(threadIdx.x + k * kThreads) * 8;
    reinterpret_cast<float4*>(o)[0] =
        make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
    reinterpret_cast<float4*>(o)[1] =
        make_float4(acc[k][4], acc[k][5], acc[k][6], acc[k][7]);
  }
  __syncthreads();
  const size_t row0 = ((size_t)r * p.KV + h) * p.G + g0;
  for (int e = threadIdx.x; e < G * p.dh; e += kThreads) {
    const int g = e / p.dh, d = e - g * p.dh;
    const int task = g * units + d / 8;
    float a = 0.f;
    for (int j = 0; j < p.jt; ++j) a += mb[(j * gu + task) * 8 + (d & 7)];
    if (direct) {
      const float lf = st_l[g] + (float)p.pad_count * expf(kNeg - st_m[g]);
      static_cast<T*>(p.out)[(row0 + g) * p.dh + d] =
          from_f32<T>(a / fmaxf(lf, 1e-30f));
    } else {
      p.part[((row0 + g) * p.n_split + split) * p.dh + d] = a;
    }
  }
  if (!direct) {
    float* ml = p.part + (size_t)p.R * p.KV * p.G * p.n_split * p.dh;
    for (int g = threadIdx.x; g < G; g += kThreads) {
      ml[((row0 + g) * p.n_split + split) * 2] = st_m[g];
      ml[((row0 + g) * p.n_split + split) * 2 + 1] = st_l[g];
    }
  }
}

// Merge the live splits of one (row, kv head, query head) in split order:
// out = Σ_s c_s acc_s / (Σ_s c_s l_s + pad_count · e^(-1e30 - m)), c_s =
// e^(m_s - m), m = max_s m_s. Rows with at most one live split were
// written out by attend_kernel.
template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const Params p) {
  __shared__ float c[kMaxSplits];
  __shared__ float norm;
  const size_t row = blockIdx.x;                 // (r, h, g) flattened
  const int r = (int)(row / ((size_t)p.KV * p.G));
  const int n_proc = n_processed(p.lengths[r], p.n_bt * p.bs, p.skip_empty);
  if (n_proc <= p.split_len) return;            // written out by its split
  const int n_live = (n_proc + p.split_len - 1) / p.split_len;
  const float* ml = p.part + (size_t)p.R * p.KV * p.G * p.n_split * p.dh +
                    row * p.n_split * 2;
  if (threadIdx.x == 0) {
    float mf = kNeg, lf = 0.f;
    for (int s = 0; s < n_live; ++s) mf = fmaxf(mf, ml[2 * s]);
    for (int s = 0; s < n_live; ++s) {
      c[s] = expf(ml[2 * s] - mf);
      lf += ml[2 * s + 1] * c[s];
    }
    norm = fmaxf(lf + (float)p.pad_count * expf(kNeg - mf), 1e-30f);
  }
  __syncthreads();
  const float* acc = p.part + row * p.n_split * p.dh;
  for (int d = threadIdx.x; d < p.dh; d += kThreads) {
    float a = 0.f;
    for (int s = 0; s < n_live; ++s) a += acc[(size_t)s * p.dh + d] * c[s];
    static_cast<T*>(p.out)[row * p.dh + d] = from_f32<T>(a / norm);
  }
}

// Shared memory of attend_kernel: the ring (or the merge buffer, which
// reuses it), q, the partial dots, the weights and the running state.
inline void smem_layout(Params& p, size_t* total) {
  const size_t stage = 2 * (size_t)kTile * p.rb + 2 * kTile * sizeof(float);
  const size_t merge =
      (size_t)p.gc * (p.dh_pad / 8) * p.jt * 8 * sizeof(float);
  p.ring_bytes = (int)std::max(kStages * stage, merge);
  *total = p.ring_bytes + sizeof(float) *
           ((size_t)p.gc * p.dh_pad + (size_t)p.gc * p.slices * kTile +
            (size_t)p.gc * kTile + 3 * (size_t)p.gc);
}

// Token phases of the p·V items: the fewest tokens a thread walks per
// tile, ties to fewer phases (a smaller merge).
inline int pick_jt(int gu) {
  int best = 1, cost = 1 << 30;
  for (int jt = 1; jt <= kTile && gu * jt <= kMaxUnits; ++jt) {
    const int c = ((gu * jt + kThreads - 1) / kThreads) *
                  ((kTile + jt - 1) / jt);
    if (c < cost) { cost = c; best = jt; }
  }
  return best;
}

template <typename T, typename KT>
static int launch(Params p, void* stream) {
  const int units = p.dh_pad / 8;
  p.slices = std::max(1, std::min(kWarps / p.gc, units));
  p.jt = pick_jt(p.gc * units);
  const bool vec = p.dh % 16 == 0 && slab::aligned16(p.k) &&
                   slab::aligned16(p.v);
  const int n16 = p.dh_pad * (int)sizeof(KT) / 16;
  p.rb = (n16 | 1) * 16;
  size_t smem = 0;
  smem_layout(p, &smem);
  auto kern = vec ? attend_kernel<T, KT, true> : attend_kernel<T, KT, false>;
  cudaError_t e = slab::prepare(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const int n_gc = (p.G + p.gc - 1) / p.gc;
  const dim3 grid(p.n_split * n_gc, p.KV, p.R);
  kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.n_split == 1) return (int)e;
  combine_kernel<T><<<(unsigned)((size_t)p.R * p.KV * p.G), kThreads, 0,
                      (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

static int dispatch(int dtype, int quant, Params p, void* stream) {
  p.dh_pad = (p.dh + 15) / 16 * 16;
  const long long n_max = (long long)p.n_bt * p.bs;
  if (p.R <= 0 || p.KV <= 0 || p.G <= 0 || p.dh <= 0 || p.dh > 256 ||
      p.bs <= 0 || p.n_bt <= 0 || p.n_blocks <= 0 || p.pad_count < 0 ||
      p.R > 65535 || p.KV > 65535 || n_max > 0x7fffffff ||
      (long long)p.n_blocks * p.bs * p.KV > 0x7fffffff ||
      p.gc <= 0 || p.gc > p.G || p.gc > kMaxHeads ||
      p.gc * (p.dh_pad / 8) > kMaxUnits || p.split_len <= 0 ||
      p.split_len % kTile != 0 ||
      (long long)p.split_len * (p.n_split - 1) >= n_max ||
      (long long)p.split_len * p.n_split < n_max ||
      p.n_split > kMaxSplits ||
      (long long)p.n_split * ((p.G + p.gc - 1) / p.gc) > 0x7fffffff ||
      (p.n_split > 1 && p.part == nullptr))
    return (int)cudaErrorInvalidValue;
  if (quant && (p.ks == nullptr || p.vs == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!quant) p.ks = p.vs = nullptr;
  if (dtype == 0)
    return quant ? launch<float, int8_t>(p, stream)
                 : launch<float, float>(p, stream);
  if (dtype == 1)
    return quant ? launch<__nv_bfloat16, int8_t>(p, stream)
                 : launch<__nv_bfloat16, __nv_bfloat16>(p, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace fd

// dtype of q / out (and of an unquantized cache): 0 = float32,
// 1 = bfloat16. quant: the cache is int8 with f32 scales ks / vs. gc:
// query heads a block; split_len: tokens a split (a multiple of 32), with
// n_split = ceil(n_bt · bs / split_len) (S for flash_decode); part: f32
// scratch of R · KV · G · n_split · (dh + 2) floats when n_split > 1,
// else unused (flash_decode.py plan_splits / head_chunk). Launch on
// ``stream``, allocate nothing, return cudaGetLastError().

// q (R, KV, G, dh); k / v pools (n_blocks, bs, KV, dh); ks / vs
// (n_blocks, bs, KV); block_tables (R, n_bt) int32; lengths (R,) int32.
extern "C" int flash_decode_paged(int dtype, int quant, const void* q,
                                  const void* k, const void* v,
                                  const float* ks, const float* vs,
                                  const int* block_tables,
                                  const int* lengths, void* out, float* part,
                                  int R, int KV, int G, int dh, int n_blocks,
                                  int bs, int n_bt, int gc, int split_len,
                                  int n_split, void* stream) {
  if (block_tables == nullptr) return (int)cudaErrorInvalidValue;
  fd::Params p{q, k, v, ks, vs, block_tables, lengths, out, part, R, KV, G,
               gc, dh, 0, 0, 0, 0, bs, n_bt, n_blocks, 0, 1, split_len,
               n_split, 0};
  return fd::dispatch(dtype, quant, p, stream);
}

// q (B, KV, G, dh); k / v (B, S, KV, dh); ks / vs (B, S, KV); lengths (B,)
// int32, each <= S; pad_count = S_pad - S, the zero slots the reference's
// chunking adds (weighted only on a length-0 row).
extern "C" int flash_decode(int dtype, int quant, const void* q,
                            const void* k, const void* v, const float* ks,
                            const float* vs, const int* lengths, void* out,
                            float* part, int B, int KV, int G, int dh, int S,
                            int pad_count, int gc, int split_len,
                            int n_split, void* stream) {
  fd::Params p{q, k, v, ks, vs, nullptr, lengths, out, part, B, KV, G, gc,
               dh, 0, 0, 0, 0, S, 1, B, pad_count, 0, split_len, n_split,
               0};
  return fd::dispatch(dtype, quant, p, stream);
}
