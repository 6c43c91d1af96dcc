// The bf16 kernels redesigned for Hopper, grouped-expert and 2-D:
//
//   slab_ell_matmul_g:    y[e] = x[e] · (W_S + Σ_r u_r v_rᵀ ⊙ B)ᵀ   (#14)
//   slab_nm_lr_matmul_g:  y[e] = x[e] · (W_S + U Vᵀ)ᵀ              (#19)
//   slab_lr_matmul_g:     the same with a dense W_S                (#18)
//   slab_nm_matmul:       y = x · (W_S + Σ_r u_r v_rᵀ ⊙ B)ᵀ, N:M   (#2)
//   slab_nm_matmul_g:     the same for every expert e              (#17)
//   binlr_matmul_g:       y[e] = x[e] · (Σ_r u_r v_rᵀ ⊙ B)ᵀ        (#20)
//   nm_matmul:            y = x · W_Sᵀ, N:M                        (#8)
//   slab_nm_lr_matmul:    y = x · (W_S + U Vᵀ)ᵀ, N:M               (#7)
//   ell_matmul_g:         y[e] = x[e] · W_Sᵀ                       (#12)
//   ell_lr_matmul_g:      y[e] = x[e] · W_Sᵀ + (x[e] · Vᵀ) · U     (#13)
//   slab_ell_matmul:      y = x · (W_S + Σ_r u_r v_rᵀ ⊙ B)ᵀ, ELL   (#1)
//   ell_lr_matmul:        y = x · W_Sᵀ + (x · Vᵀ) · U, ELL         (#5)
//   slab_matmul:          y = x · (W_S + Σ_r u_r v_rᵀ ⊙ B)ᵀ, dense (#3)
//   slab_matmul_g:        the same for every expert e              (#16)
//   ell_matmul:           y = x · W_Sᵀ, ELL                        (#4)
//   slab_lr_matmul:       y = x · W_Sᵀ + (x · Vᵀ) · U, dense       (#6)
//
// Replace repro/kernels/grouped.py::slab_ell_matmul_g (_kernel_slab_ell_g,
// pallas_call at grouped.py:142), ::slab_nm_lr_matmul_g
// (_kernel_nm_lr_g, pallas_call at grouped.py:402), ::slab_lr_matmul_g
// (_kernel_dense_lr_g, pallas_call at grouped.py:348),
// ::slab_nm_matmul_g (_kernel_nm_full_g, pallas_call at grouped.py:297),
// ::binlr_matmul_g (_kernel_binlr_g, pallas_call at grouped.py:450),
// ::ell_matmul_g (_kernel_ell_g, pallas_call at grouped.py:64),
// ::ell_lr_matmul_g (_kernel_ell_lr_g, pallas_call at grouped.py:103),
// repro/kernels/slab_matmul.py::slab_nm_matmul (_kernel_nm, pallas_call
// at slab_matmul.py:135), ::slab_nm_lr_matmul (_kernel_nm_lr,
// pallas_call at slab_matmul.py:247), repro/kernels/nm_sparse.py::
// nm_matmul (_kernel, pallas_call at nm_sparse.py:54) and
// repro/kernels/ell.py::slab_ell_matmul (_kernel_slab_ell, pallas_call at
// ell.py:209), ::ell_lr_matmul (_kernel_ell_lr, pallas_call at
// ell.py:149) and ::ell_matmul (_kernel_ell, pallas_call at ell.py:105),
// repro/kernels/slab_matmul.py::slab_matmul (_kernel_dense, pallas_call
// at slab_matmul.py:77) and ::slab_lr_matmul (_kernel_dense_lr,
// pallas_call at slab_matmul.py:193) and repro/kernels/grouped.py::
// slab_matmul_g (_kernel_dense_g, pallas_call at grouped.py:242) for bf16
// operands.
// The first design (ell.cu, slab_matmul.cu, nm_sparse.cu) keeps the f32
// launches, which hold 1e-5 without TF32, #19's, #17's, #8's, #7's and
// #2's patterns other than 2:4 / 4:8, #17, #2, #3 and #16 at ranks whose
// x ⊙ v_r tiles do not fit a block, #20 past rank 4, #12, #13 and #14 at 1-2
// rows per expert, where its 2-byte gathers are cheaper than these
// kernels' 16-byte ones (grouped.TC_MIN_ROWS, grouped.ELL_TC_MIN_ROWS),
// #1, #4 and #5 where x does not fit a block (their section below), #6 at
// K % 8 != 0.
// #14, #19, #18, #17, #20, #8, #7, #2, #3, #16, #6 and #1's ±1 term use
// the tensor cores; #12, #13, #4 and #5, whose work is all gather, do
// not.
//
// #14 and #19's bound on the H100: bytes. At the MoE decode shapes (1-32
// rows per expert) each expert is a skinny GEMM: the E experts' planes (ELL vals +
// ids + sign words, or N:M vals + int8 positions) stream once from device
// memory, about 345 MB (#14) and 280 MB (#19) at deepseek-moe-16b's
// (1408, 2048) stack, against 2·M FLOP per stored weight, far below the
// tensor-core line. So wgmma is not needed: mma.sync m16n8k16 retires the
// products at a small share of the issue slots, and the design is about
// the instructions spent per streamed byte.
//
// What the first design (one warp per output row on CUDA cores) lost and
// what this one does about it:
//  - x was staged column-major with scalar 2-byte stores, a 32-way bank
//    conflict at 8 batch rows, in every block of 16 rows. Here a block
//    owns kRows = 128 output rows of one expert (grid (⌈N/128⌉, E)) and
//    stages x once per 8·NTP batch rows with 16-byte stores: #14 as NTP
//    column-major planes (one 16-byte row of 8 batch rows per column k),
//    so an ELL gather is one 16-byte load for all 8 rows and
//    ldmatrix.trans reads the mma's B fragment without conflicts; #19 as
//    a row-major tile whose 16-byte units are swizzled so that its B
//    loads are conflict-free.
//  - #14's ±1 contraction cost ~5 CUDA-core instructions per (column,
//    batch row). Here it is an mma with the weights as A (swap-AB: yᵀ =
//    Ŵ·xᵀ, 16 weight rows by up to 8 batch rows): A's elements are ±u_r[n]
//    decoded in registers from the sign words (u's bf16 bits with the
//    sign bit set for a clear sign bit), B is x ⊙ v_r rounded to bf16 as
//    the reference rounds it, so every product u·(±1)·bf16(x·v) is exact
//    in fp32 and only the order of summation changes. More than 8 batch
//    rows loop over n-tiles that reuse the decoded A fragments; the next
//    128 columns' sign words load during this chunk's steps.
//  - #14's W_S takes the gather route: the four lanes of an mma row group
//    split rows g and g + 8 into 8-entry blocks (coalesced 16-byte loads),
//    each entry one 16-byte shared load of its x column and an FMA per
//    batch row, reduced into the C fragment. The other route, each
//    128-column chunk's entries scattered into a zeroed 16 x 128 shared
//    tile fed to the same mma, was built and timed against it on an H100
//    and lost at every M from 1 to 32 (PERF.md): its data-dependent walk
//    over each chunk's entries diverges across lanes and costs more than
//    the gathers it saves, so it was dropped.
//  - #19's N:M part is an mma too. Its A fragments are decoded in
//    registers from vals and positions: the mma sums over k in any order,
//    so within each 128-column chunk lane q of a row group owns the 32
//    consecutive columns 32q .. 32q + 31 (the k-slots 2q, 2q+1, 2q+8,
//    2q+9 of step s are its columns 4s + 0..3), reads them as two
//    16-byte value loads and one 16-byte position load per row, a chunk
//    ahead of their use, and reads B as four 16-byte loads of its x row.
//    A position outside [0, m) matches no column and contributes 0, as
//    before.
//  - #19's projection p = x·Vᵀ was formed in every block of 16 rows; now
//    once per block of 128, in fp32 from the staged x with a fixed
//    reduction order, and Σ_r p[m, r]·u_r[n] is added in the epilogue.
//  - The first design's L2 prefetch of each warp's planes is gone: builds
//    with it ran slower (the demand loads are already whole 128-byte
//    lines, issued ahead).
#include <cuda.h>

#include <type_traits>

#include "slab_common.cuh"

namespace tc {

using bf16 = __nv_bfloat16;
using slab::aligned16;
using slab::mbar_expect;
using slab::mbar_init;
using slab::mbar_wait;

constexpr int kWarps = 8;            // warps per block, 16 weight rows each
constexpr int kRows = 16 * kWarps;   // output rows per block
constexpr int kMaxNtp = 4;           // 8-row n-tiles staged per pass

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// A read-only load that also asks L2 for the 256-byte block around it, so
// that the next chunks of a row (sign words, 2:4 planes) arrive from L2
// (builds without it were slower on an H100: PERF.md)
__device__ __forceinline__ uint32_t ldg_l2(const uint32_t* p) {
  uint32_t r;
  asm("ld.global.nc.L2::256B.u32 %0, [%1];\n" : "=r"(r) : "l"(p));
  return r;
}
__device__ __forceinline__ uint4 ldg_l2(const uint4* p) {
  uint4 r;
  asm("ld.global.nc.L2::256B.v4.u32 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t& b0, uint32_t& b1,
                                              const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(a));
}

// bf16 bits -> f32 (the low or the high half of a word)
__device__ __forceinline__ float lo_f(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_f(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
// two f32 -> one word of two bf16, round to nearest even (lo in bits 0-15)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
__device__ __forceinline__ uint32_t bits16(bf16 v) {
  return (uint32_t)__bfloat16_as_ushort(v);
}

// ---------------------------------------------------------------- #14

// Stage batch rows m0 .. m0 + 8·ntp - 1 of x (zero rows past M) as ntp
// column-major planes of K 16-byte rows (row k: x[m0 + 8t .. + 7, k]). A
// thread takes an 8 x 8 block: eight 16-byte loads (one per batch row,
// coalesced across lanes), a register transpose, eight 16-byte stores
// (one per column; lanes 128 bytes apart share a bank group, an 8-way
// conflict paid once per block, where a swizzle would cost every gather
// four instructions).
__device__ __forceinline__ void stage_cols(uint4* xs, const bf16* __restrict__ x,
                                           int m0, int M, int K, int ntp) {
  const int nkb = K / 8;
  const bool vec = aligned16(x);
  for (int i = threadIdx.x; i < ntp * nkb; i += blockDim.x) {
    const int t = i / nkb, kb = i - t * nkb;
    uint32_t w[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int m = m0 + 8 * t + r;
      if (m < M) {
        const bf16* p = x + (size_t)m * K + kb * 8;
        if (vec) {
          const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
          w[r][0] = q.x; w[r][1] = q.y; w[r][2] = q.z; w[r][3] = q.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            w[r][j] = bits16(p[2 * j]) | (bits16(p[2 * j + 1]) << 16);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) w[r][j] = 0u;
      }
    }
    uint4* plane = xs + (size_t)t * K;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t sel = (j & 1) ? 0x7632u : 0x5410u;
      uint4 o;
      o.x = __byte_perm(w[0][j >> 1], w[1][j >> 1], sel);
      o.y = __byte_perm(w[2][j >> 1], w[3][j >> 1], sel);
      o.z = __byte_perm(w[4][j >> 1], w[5][j >> 1], sel);
      o.w = __byte_perm(w[6][j >> 1], w[7][j >> 1], sel);
      plane[kb * 8 + j] = o;
    }
  }
}

// ±u_r on the A side: a clear sign bit (-1) sets the bf16 sign bit.
// u2 holds u's bits in both halves; b's bit 0 is the low column.
__device__ __forceinline__ uint32_t sign_pair(uint32_t u2, uint32_t b) {
  return u2 ^ (((~b & 1u) << 15) | ((~b & 2u) << 30));
}

// Four sign words of one row from column kw·32 on (zeros past the row).
__device__ __forceinline__ uint4 sign_words(const uint32_t* __restrict__ row,
                                            int kw, int W, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(row + kw));
  uint4 o;
  o.x = kw < W ? __ldg(row + kw) : 0u;
  o.y = kw + 1 < W ? __ldg(row + kw + 1) : 0u;
  o.z = kw + 2 < W ? __ldg(row + kw + 2) : 0u;
  o.w = kw + 3 < W ? __ldg(row + kw + 3) : 0u;
  return o;
}

__device__ __forceinline__ uint32_t word_of(const uint4& q, int i) {
  return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
}

// Eight ELL entries from entry e0 (a multiple of 8): vals and ids.
template <typename I> struct Ids8;
template <> struct Ids8<uint16_t> {
  uint4 a;
  __device__ __forceinline__ void load(const uint16_t* p) {
    a = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ uint32_t at(int j) const {
    return (word_of(a, j >> 1) >> ((j & 1) * 16)) & 0xffffu;
  }
};
template <> struct Ids8<uint32_t> {
  uint4 a, b;
  __device__ __forceinline__ void load(const uint32_t* p) {
    a = __ldg(reinterpret_cast<const uint4*>(p));
    b = __ldg(reinterpret_cast<const uint4*>(p + 4));
  }
  __device__ __forceinline__ uint32_t at(int j) const {
    return j < 4 ? word_of(a, j) : word_of(b, j - 4);
  }
};

// acc[t][m] += w · x[t·8 + m, col] for entries jlo <= j < jhi of one
// 8-entry block that name a column below K: one 16-byte load of the
// column per n-tile, 8 FMAs.
template <int NTP>
__device__ __forceinline__ void gather_entry(float (&acc)[NTP][8],
                                             const uint4* xs, uint32_t vw,
                                             int j, uint32_t col, int K) {
  const float w = (j & 1) ? hi_f(vw) : lo_f(vw);
  const uint4* xc = xs + col;
#pragma unroll
  for (int t = 0; t < NTP; ++t) {
    const uint4 q = xc[(size_t)t * K];
    acc[t][0] += w * lo_f(q.x); acc[t][1] += w * hi_f(q.x);
    acc[t][2] += w * lo_f(q.y); acc[t][3] += w * hi_f(q.y);
    acc[t][4] += w * lo_f(q.z); acc[t][5] += w * hi_f(q.z);
    acc[t][6] += w * lo_f(q.w); acc[t][7] += w * hi_f(q.w);
  }
}

template <typename I, int NTP>
__device__ __forceinline__ void gather8(float (&acc)[NTP][8], const uint4* xs,
                                        const uint4& vv, const Ids8<I>& ii,
                                        int jlo, int jhi, int K) {
  if (jlo == 0 && jhi == 8) {        // a whole block: the common case
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t col = ii.at(j);
      if (col < (uint32_t)K)
        gather_entry<NTP>(acc, xs, word_of(vv, j >> 1), j, col, K);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t col = ii.at(j);
    if (j >= jlo && j < jhi && col < (uint32_t)K)
      gather_entry<NTP>(acc, xs, word_of(vv, j >> 1), j, col, K);
  }
}

// The entries [jlo, jhi) of the block from entry e0 that lie in [lo, hi).
__device__ __forceinline__ void block_span(size_t e0, size_t lo, size_t hi,
                                           int& jlo, int& jhi) {
  jlo = e0 < lo ? (int)(lo - e0) : 0;
  jhi = hi - e0 >= 8 ? 8 : (int)(hi - e0);
}

constexpr int kTileK = 128;     // columns of one sign-word chunk
constexpr int kMaxR = 4;        // ranks whose u values (#14) or sums (#20)
                                // stay in registers

// One k16 step of Σ_r (±u_r) · bf16(x ⊙ v_r) into c: A is u_r's bits with
// the sign bit set where the sign word's bit is clear (f: rows g / g + 8,
// bits of columns 2q, 2q + 1 at 0-1 and of 2q + 8, 2q + 9 at 8-9); B is
// the staged x fragment times v_r (v2: v_r at those columns).
template <int NTP>
__device__ __forceinline__ void binary_step(float (&c)[NTP][4],
                                            const uint32_t (&bx)[NTP][2],
                                            uint32_t fa, uint32_t fb,
                                            uint32_t u2a, uint32_t u2b,
                                            uint32_t v01, uint32_t v89) {
  const uint32_t a0 = sign_pair(u2a, fa & 3u);
  const uint32_t a1 = sign_pair(u2b, fb & 3u);
  const uint32_t a2 = sign_pair(u2a, (fa >> 8) & 3u);
  const uint32_t a3 = sign_pair(u2b, (fb >> 8) & 3u);
  const float v0 = lo_f(v01), v1 = hi_f(v01), v8 = lo_f(v89), v9 = hi_f(v89);
#pragma unroll
  for (int t = 0; t < NTP; ++t) {
    const uint32_t b0 = pack_bf16(lo_f(bx[t][0]) * v0, hi_f(bx[t][0]) * v1);
    const uint32_t b1 = pack_bf16(lo_f(bx[t][1]) * v8, hi_f(bx[t][1]) * v9);
    mma_bf16(c[t], a0, a1, a2, a3, b0, b1);
  }
}

template <typename I, int NTP>
__global__ void __launch_bounds__(kWarps * 32)
slab_ell_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ vals,
                   const I* __restrict__ idx, const uint32_t* __restrict__ bp,
                   const bf16* __restrict__ u, const bf16* __restrict__ v,
                   bf16* __restrict__ y, int M, int N, int K, int kmax,
                   int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* xs = reinterpret_cast<uint4*>(smem_raw);   // NTP planes (K, 8)
  bf16* vs = reinterpret_cast<bf16*>(xs + (size_t)NTP * K);   // (R, K)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const size_t ex = blockIdx.y;
  x += ex * M * K;
  y += ex * M * N;
  u += ex * R * N;
  v += ex * R * K;
  const int row0 = blockIdx.x * kRows + warp * 16;
  const bool live = row0 < N;
  // this lane's rows g and g + 8 (rows past N load the last row's planes;
  // their results are not stored)
  const int ra = min(row0 + g, N - 1), rb = min(row0 + g + 8, N - 1);
  const size_t sa = (ex * N + ra) * kmax, sb = (ex * N + rb) * kmax;
  const int W = K / 32;
  const uint32_t* bpa = bp + (ex * N + ra) * W;
  const uint32_t* bpb = bp + (ex * N + rb) * W;
  const bool wvec = (W % 4) == 0;
  for (int i = threadIdx.x; i < R * K; i += blockDim.x) vs[i] = v[i];
  uint32_t u2a[kMaxR], u2b[kMaxR];   // u_r's bits twice, rows g and g + 8
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) {
    const uint32_t ua = r < R ? bits16(u[(size_t)r * N + ra]) : 0u;
    const uint32_t ub = r < R ? bits16(u[(size_t)r * N + rb]) : 0u;
    u2a[r] = ua | (ua << 16);
    u2b[r] = ub | (ub << 16);
  }
  // the four lanes of a row group take every fourth 8-entry block of its
  // rows (blocks start at 8-entry boundaries of the stacked planes, so
  // every load is 16-byte aligned)
  const size_t la = (sa & ~size_t(7)) + 8 * q, lb = (sb & ~size_t(7)) + 8 * q;
  const size_t ha = sa + kmax, hb = sb + kmax;

  for (int m0 = 0; m0 < M; m0 += 8 * NTP) {
    __syncthreads();                 // the previous pass's readers are done
    stage_cols(xs, x, m0, M, K, NTP);
    __syncthreads();
    if (!live) continue;
    float c[NTP][4];
#pragma unroll
    for (int t = 0; t < NTP; ++t)
      c[t][0] = c[t][1] = c[t][2] = c[t][3] = 0.f;

    {  // W_S by the gather, reduced over the row group's four lanes into
       // the C fragment (c0, c1: row g, batch rows 2q, 2q + 1; c2, c3:
       // row g + 8)
      float acc_a[NTP][8], acc_b[NTP][8];
#pragma unroll
      for (int t = 0; t < NTP; ++t)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc_a[t][j] = acc_b[t][j] = 0.f;
#pragma unroll 2
      for (size_t off = 0; la + off < ha || lb + off < hb; off += 32) {
        const bool in_a = la + off < ha, in_b = lb + off < hb;
        uint4 va = make_uint4(0, 0, 0, 0), vb = va;
        Ids8<I> ia, ib;
        if (in_a) {
          va = __ldg(reinterpret_cast<const uint4*>(vals + la + off));
          ia.load(idx + la + off);
        }
        if (in_b) {
          vb = __ldg(reinterpret_cast<const uint4*>(vals + lb + off));
          ib.load(idx + lb + off);
        }
        int jlo, jhi;
        if (in_a) {
          block_span(la + off, sa, ha, jlo, jhi);
          gather8<I, NTP>(acc_a, xs, va, ia, jlo, jhi, K);
        }
        if (in_b) {
          block_span(lb + off, sb, hb, jlo, jhi);
          gather8<I, NTP>(acc_b, xs, vb, ib, jlo, jhi, K);
        }
      }
#pragma unroll
      for (int t = 0; t < NTP; ++t) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float fa = acc_a[t][j], fb = acc_b[t][j];
          fa += __shfl_xor_sync(0xffffffffu, fa, 1);
          fa += __shfl_xor_sync(0xffffffffu, fa, 2);
          fb += __shfl_xor_sync(0xffffffffu, fb, 1);
          fb += __shfl_xor_sync(0xffffffffu, fb, 2);
          if (j == 2 * q) { c[t][0] += fa; c[t][2] += fb; }
          if (j == 2 * q + 1) { c[t][1] += fa; c[t][3] += fb; }
        }
      }
    }

    // Σ_r (±u_r) · bf16(x ⊙ v_r) on the tensor cores, 128 columns a
    // chunk, the next chunk's sign words loading during this one's steps
    uint4 wna = sign_words(bpa, 0, W, wvec), wnb = sign_words(bpb, 0, W, wvec);
    for (int kc = 0; kc < K; kc += kTileK) {
      const uint4 wa = wna, wb = wnb;
      if (kc + kTileK < K) {
        wna = sign_words(bpa, (kc + kTileK) / 32, W, wvec);
        wnb = sign_words(bpb, (kc + kTileK) / 32, W, wvec);
      }
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const int k0 = kc + 16 * s;
        if (k0 >= K) break;
        uint32_t bx[NTP][2];
#pragma unroll
        for (int t = 0; t < NTP; ++t)
          ldsm_x2_trans(bx[t][0], bx[t][1], xs + (size_t)t * K + k0 + (lane & 15));
        const int sh = (s & 1) * 16 + 2 * q;
        const uint32_t fa = word_of(wa, s >> 1) >> sh;
        const uint32_t fb = word_of(wb, s >> 1) >> sh;
        const bf16* vr = vs + k0 + 2 * q;
#pragma unroll
        for (int r = 0; r < kMaxR; ++r) {
          if (r >= R) break;
          binary_step<NTP>(c, bx, fa, fb, u2a[r], u2b[r],
                           *reinterpret_cast<const uint32_t*>(vr + (size_t)r * K),
                           *reinterpret_cast<const uint32_t*>(vr + (size_t)r * K + 8));
        }
        for (int r = kMaxR; r < R; ++r) {
          const uint32_t ua = bits16(u[(size_t)r * N + ra]);
          const uint32_t ub = bits16(u[(size_t)r * N + rb]);
          binary_step<NTP>(c, bx, fa, fb, ua | (ua << 16), ub | (ub << 16),
                           *reinterpret_cast<const uint32_t*>(vr + (size_t)r * K),
                           *reinterpret_cast<const uint32_t*>(vr + (size_t)r * K + 8));
        }
      }
    }

    const int n_a = row0 + g, n_b = row0 + g + 8;
#pragma unroll
    for (int t = 0; t < NTP; ++t) {
      const int m = m0 + 8 * t + 2 * q;
      if (m < M) {
        if (n_a < N) y[(size_t)m * N + n_a] = __float2bfloat16(c[t][0]);
        if (n_b < N) y[(size_t)m * N + n_b] = __float2bfloat16(c[t][2]);
      }
      if (m + 1 < M) {
        if (n_a < N) y[(size_t)(m + 1) * N + n_a] = __float2bfloat16(c[t][1]);
        if (n_b < N) y[(size_t)(m + 1) * N + n_b] = __float2bfloat16(c[t][3]);
      }
    }
  }
}

// The n-tiles per pass: enough for M (up to 4), fewer when their
// shared bytes (per_tile each, plus fixed) pass the card's opt-in limit.
// 0 when even one does not fit.
inline int pick_ntp(int M, size_t per_tile, size_t fixed, size_t* smem) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  int ntp = min((M + 7) / 8, kMaxNtp);
  while (ntp >= 1 && per_tile * ntp + fixed > (size_t)optin) --ntp;
  *smem = ntp ? per_tile * ntp + fixed : 0;
  return ntp;
}

#define TC_DISPATCH_NTP(ntp, ...)                              \
  switch (ntp) {                                               \
    case 1: { constexpr int NTP = 1; __VA_ARGS__; } break;     \
    case 2: { constexpr int NTP = 2; __VA_ARGS__; } break;     \
    case 3: { constexpr int NTP = 3; __VA_ARGS__; } break;     \
    case 4: { constexpr int NTP = 4; __VA_ARGS__; } break;     \
    default: return (int)cudaErrorInvalidValue;                \
  }

template <typename I>
static int launch_slab_ell(const void* x, const void* vals, const void* idx,
                           const void* bp, const void* u, const void* v,
                           void* y, int E, int M, int N, int K, int kmax,
                           int R, void* stream) {
  if (!aligned16(vals) || !aligned16(idx) || !aligned16(bp))
    return (int)cudaErrorMisalignedAddress;
  size_t smem = 0;
  const int ntp = pick_ntp(M, (size_t)K * 16,
                           slab::align16_up((size_t)R * K * sizeof(bf16)),
                           &smem);
  const dim3 grid((N + kRows - 1) / kRows, E);
  TC_DISPATCH_NTP(ntp, {
    auto kern = slab_ell_tc_kernel<I, NTP>;
    cudaError_t e = slab::prepare(kern, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
        (const bf16*)x, (const bf16*)vals, (const I*)idx,
        (const uint32_t*)bp, (const bf16*)u, (const bf16*)v, (bf16*)y, M, N,
        K, kmax, R);
  });
  return (int)cudaGetLastError();
}

}  // namespace tc

// dtype must be 1 (bfloat16): f32 launches go to ell.cu's kernel.
// idx_bytes: 2 (uint16 ids) or 4. x (E, M, K), vals / idx (E, N, K_max),
// bp (E, N, K/32), u (E, R, N), v (E, R, K), y (E, M, N). Launches on
// ``stream``, allocates nothing, returns cudaGetLastError().
extern "C" int slab_ell_matmul_g(int dtype, int idx_bytes, const void* x,
                                 const void* vals, const void* idx,
                                 const void* bp, const void* u,
                                 const void* v, void* y, int E, int M, int N,
                                 int K, int kmax, int R, void* stream) {
  if (dtype != 1 || E <= 0 || E > slab::kMaxExperts || M <= 0 || N <= 0 ||
      K <= 0 || K % 32 || kmax <= 0 || R <= 0)
    return (int)cudaErrorInvalidValue;
  if (idx_bytes == 2)
    return tc::launch_slab_ell<uint16_t>(x, vals, idx, bp, u, v, y, E, M, N,
                                         K, kmax, R, stream);
  if (idx_bytes == 4)
    return tc::launch_slab_ell<uint32_t>(x, vals, idx, bp, u, v, y, E, M, N,
                                         K, kmax, R, stream);
  return (int)cudaErrorInvalidValue;
}

namespace tc {

// -------------- #19, #18, #2, #17, #20, #8, #7, #3, #16, #6, #15, #9
//
// One body, tc_body, serves twelve kernels whose weight rows meet x on the
// tensor cores in one k order:
//
//   slab_nm_lr_matmul_g  y[e] = x[e] · W_S[e]ᵀ + (x[e] · V[e]ᵀ) · U[e],
//                        W_S in N:M form                             (#19)
//   slab_lr_matmul_g     the same with a dense W_S                   (#18)
//   slab_nm_matmul       y = x · W_Sᵀ + Σ_r u_r ⊙ (B · (x ⊙ v_r)ᵀ),
//                        W_S in N:M form, B the ±1 sign words        (#2)
//   slab_nm_matmul_g     #2 for every expert e                       (#17)
//   binlr_matmul_g       y[e] = Σ_r u_r ⊙ (B[e] · (x[e] ⊙ v_r)ᵀ)     (#20)
//   nm_matmul            y = x · W_Sᵀ, W_S in N:M form               (#8)
//   slab_nm_lr_matmul    y = x · W_Sᵀ + (x · Vᵀ) · U, N:M: #19 at E 1 (#7)
//   slab_matmul          y = x · W_Sᵀ + Σ_r u_r ⊙ (B · (x ⊙ v_r)ᵀ),
//                        W_S dense                                   (#3)
//   slab_matmul_g        #3 for every expert e                       (#16)
//   slab_lr_matmul       y = x · W_Sᵀ + (x · Vᵀ) · U, W_S dense: #18
//                        at E 1                                      (#6)
//   nm_matmul_g          #8 for every expert e                       (#15)
//   binlr_matmul         y = Σ_r u_r ⊙ (B · (x ⊙ v_r)ᵀ): #20 at E 1   (#9)
//
// #18 replaces repro/kernels/grouped.py::slab_lr_matmul_g
// (_kernel_dense_lr_g, pallas_call at grouped.py:348), #2
// repro/kernels/slab_matmul.py::slab_nm_matmul (_kernel_nm, pallas_call
// at slab_matmul.py:135), #17 repro/kernels/grouped.py::slab_nm_matmul_g
// (_kernel_nm_full_g, pallas_call at grouped.py:297) and #20
// ::binlr_matmul_g (_kernel_binlr_g, pallas_call at grouped.py:450), #8
// repro/kernels/nm_sparse.py::nm_matmul (_kernel, pallas_call at
// nm_sparse.py:54) and #7 repro/kernels/slab_matmul.py::slab_nm_lr_matmul
// (_kernel_nm_lr, pallas_call at slab_matmul.py:247), #3
// repro/kernels/slab_matmul.py::slab_matmul (_kernel_dense, pallas_call
// at slab_matmul.py:77), #16 repro/kernels/grouped.py::slab_matmul_g
// (_kernel_dense_g, pallas_call at grouped.py:242) and #6
// repro/kernels/slab_matmul.py::slab_lr_matmul (_kernel_dense_lr,
// pallas_call at slab_matmul.py:193), #15 repro/kernels/grouped.py::
// nm_matmul_g (_kernel_nm_g, pallas_call at grouped.py:195) and #9
// repro/kernels/binlr.py::binlr_matmul (_kernel, pallas_call at
// binlr.py:65), for bf16 operands (#2, #17, #8, #7 and #15 at 2:4 and
// 4:8); their f32 launches and the other patterns keep the first design
// (slab_matmul.cu, nm_sparse.cu), which holds 1e-5 without TF32.
//
// A block owns kRows = 128 output rows of one expert, a warp 16 (grid
// (⌈N/128 / tiles a block⌉, E, splits of K)); x is staged once per 8·NTP
// batch rows, and a block may walk several row tiles of its expert
// after staging once; within each 128-column chunk lane q of a row group
// owns columns 32q .. 32q + 31 (the k-slots 2q, 2q+1 / 2q+8, 2q+9 of
// step s are its columns 4s, 4s+1 / 4s+2, 4s+3) on the A and the B side
// alike, and reads B as four 16-byte loads of its x row. What differs is
// where A comes from (the Src template):
//  - NmSrc (#19, #2, #17, #8, #7, #15): decoded in registers from vals and positions read a
//    chunk ahead of their use, two 16-byte value loads and one 16-byte
//    position load a row; 2:4 is decoded by byte permutes, 4:8 by
//    comparisons. A position outside [0, m) matches no column and
//    contributes 0.
//  - DenseSrc (#18, #3, #16, #6): its bound is the dense rows' bytes (#3 and
//    #16 add K/8 bytes of sign words a row, 1.0625x what one
//    torch.matmul or torch.bmm streams), so the design is the stream.
//    Each warp's 16 rows of a chunk arrive by two 2-D copies of a tensor
//    map (cp.async.bulk.tensor on an mbarrier: the tensor memory
//    accelerator, no per-lane address work; 16 rows x 64 columns each,
//    the 128-byte swizzle) into a ring of stages of its own, every stage
//    in flight while the warp works from registers, and the ring is sized
//    so that two blocks share an SM (one block's start, x staged and
//    projected, overlaps the other's stream). The swizzle puts the two
//    rows a quarter-warp reads in different bank groups; lanes q and q +
//    2 share one (a 2-way conflict on the A loads, once a chunk).
//  - NoSrc (#20, #9): no W_S, so no A and no mma for it, and no x tile.
// #2, #17, #3, #16, #20 and #9 add the ±1 term to the same accumulator as
// one more mma a rank and step (#8, #7 and #15 have none): A is ±u_r from the sign bits
// (sign word 4c + q of a row holds exactly lane q's 32 columns of chunk
// c: bits 4s .. 4s + 3 are step s's), B is bf16(x ⊙ v_r), rounded as the reference rounds it and
// staged once a block beside x from the same loads (forming it from the
// x fragment at every step, in every warp, took ~40 % of the kernel on
// an H100). The sign bits become A by two instructions a register: once
// a chunk the word is spread so that the bits of columns j and j + 1 lie
// 16 apart (xspread), then a shift brings a step's pair to bits 15 and
// 31, which flip the sign bits of ±u_r's two halves. #20 and #9 decode A =
// ±1 once a step for all their ranks (at most kMaxR), one accumulator each,
// and scales them by u_r after the sum (accum_binlr_terms' order). The
// per-linear shapes of #2, #8, #7, #3, #6 and #9 give few blocks of 128 rows
// ((4096, 4096): 32 for 132 SMs; (1024, 4096): 8), so K is split across
// blocks from the shapes alone (kernels/slab_matmul.py::plan_nm_splits,
// which counts every expert's row tiles; #3, #16 and #6 by
// ::plan_dense_splits, one wave of two blocks an SM where the runs may be
// that wide, the runs no wider than two blocks' shared memory with
// DenseSrc's 2-stage ring allows, ::dense_split_cap: 11 chunks at rank 1
// with the ±1 term's tiles, 23 with #6's projection sums, so #16's 800
// row tiles split only to fit): each block stages only its columns of x and x ⊙ v_r (the
// tiles stay small at any K) and writes fp32 partial sums (splits, E, M,
// N), and the last block of an expert's row tiles (counted by an atomic
// ticket of that expert and block column) adds them in split order, so
// two launches give the same bits. #7 and #6 carry their low-rank
// projection through the split: a block projects x onto V over its split's columns
// only, and under a split stores that partial projection (fp32, (splits,
// block columns, M, R) after the partial sums) in place of adding it;
// the last block sums the partial projections in split order too and
// adds Σ_r p[m, r]·u_r[n] to the sum of the partial sums before the one
// rounding (the reference's acc + acc_p·u). #2, #17, #20, #8, #7, #3,
// #16, #6, #15 and #9 cap their registers so that two blocks share an SM;
// #19 and #18 run one split.
// #20 and #9 stream only K/8 bytes of sign words a row (256 B at K 2048),
// less than a block's staging reads and writes (x and x ⊙ v_r): so their blocks
// walk several consecutive row tiles of their expert after staging once
// (kernels/slab_matmul.py::plan_tiles_per_block: about two blocks an SM,
// one wave), its sign words are read a chunk ahead as one stream over
// the block's tiles, and u comes from shared memory, staged with x ⊙ v_r.
// Built and timed on an H100 while this was designed (PERF.md gives the
// direction; the builds are not kept): #2's N:M planes through a
// shared-memory ring (bulk copies or cp.async, 3-4 stages) lost to the
// registers at every shape; #18's ring by cp.async lost to the bulk
// copies, and with one block an SM and 4 stages it lost to two blocks
// and 2 stages; one 1-D bulk copy a row (rows padded to 272 bytes in
// place of the swizzle) lost to the two tensor-map boxes by 4-6 % on
// #16, #18 and #3; splits cut for two blocks an SM whatever the waves
// (plan_nm_splits) lost 10-12 % to one wave at #3's MLP shapes. For #20: 3 blocks an SM (registers capped at 85) spilled
// and lost; sign words 4, 8 or 16 chunks ahead, two accumulators a row
// pair and an L2 prefetch instruction a few chunks ahead did not help
// (the last cost #17 and #19 8-30 %); a build whose A took one
// instruction in place of two ran ~15 % faster, so the decode's issue
// cost is a share of what binds (PERF.md §6).
// The projection p = x·Vᵀ of #19, #18, #7 and #6 is formed once a block pass
// in fp32 from the staged x (the split's columns) with a fixed reduction
// order; Σ_r p[m, r]·u_r[n] is added in the epilogue, or by the last
// block of a split launch, before the one rounding.

// The x tile is row-major, Kp = the staged columns rounded up to 128 plus
// 8 of padding a row (16 bytes past a multiple of 128), with the 16-byte
// unit u of a row stored at u ^ ((u >> 2) & 2): the main loop's lanes read
// units 4q + j (q = 0..3) of two rows at once, and those land in eight
// different bank groups.
__device__ __forceinline__ int xr_unit(int u) { return u ^ ((u >> 2) & 2); }
__device__ __forceinline__ int xr_elem(int k) {
  return xr_unit(k >> 3) * 8 + (k & 7);
}

// Stage batch rows m0 .. m0 + 8·ntp - 1 of x (rows ldx apart; zero rows
// past M, zero columns from kw to Kp) with 16-byte stores (none with xr
// null: #20 reads no x tile); with xv (BIN) also bf16(x ⊙ v_r)
// for each of the R ranks (v_r: R rows ldx apart from v) as tiles of the
// same layout from xv + r·8·ntp·sx, from the same loads of x.
__device__ __forceinline__ void stage_rows(bf16* xr, const bf16* __restrict__ x,
                                           int ldx, int m0, int M, int kw,
                                           int Kp, int sx, int ntp,
                                           bf16* xv = nullptr,
                                           const bf16* __restrict__ v = nullptr,
                                           int R = 0) {
  const int nch = Kp / 8;
  const bool vec = aligned16(x) && ldx % 8 == 0 &&
                   (v == nullptr || aligned16(v));
  auto load = [&](const bf16* p, int c) {
    if (vec && c + 8 <= kw) return __ldg(reinterpret_cast<const uint4*>(p));
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t lo = c + 2 * j < kw ? bits16(p[2 * j]) : 0u;
      const uint32_t hi = c + 2 * j + 1 < kw ? bits16(p[2 * j + 1]) : 0u;
      w[j] = lo | (hi << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  };
  // unrolled so that a thread's loads of several units are in flight at
  // once
#pragma unroll 4
  for (int i = threadIdx.x; i < ntp * 8 * nch; i += blockDim.x) {
    const int r = i / nch, ch = i - r * nch, c = ch * 8, m = m0 + r;
    const bool in = m < M && c < kw;
    const uint4 o = in ? load(x + (size_t)m * ldx + c, c)
                       : make_uint4(0, 0, 0, 0);
    const size_t at = (size_t)r * sx + xr_unit(ch) * 8;
    if (xr) *reinterpret_cast<uint4*>(xr + at) = o;
    for (int k = 0; k < R; ++k) {
      uint4 w = make_uint4(0, 0, 0, 0);
      if (in) {
        const uint4 vq = load(v + (size_t)k * ldx + c, c);
        w.x = pack_bf16(lo_f(o.x) * lo_f(vq.x), hi_f(o.x) * hi_f(vq.x));
        w.y = pack_bf16(lo_f(o.y) * lo_f(vq.y), hi_f(o.y) * hi_f(vq.y));
        w.z = pack_bf16(lo_f(o.z) * lo_f(vq.z), hi_f(o.z) * hi_f(vq.z));
        w.w = pack_bf16(lo_f(o.w) * lo_f(vq.w), hi_f(o.w) * hi_f(vq.w));
      }
      *reinterpret_cast<uint4*>(xv + (size_t)k * 8 * ntp * sx + at) = w;
    }
  }
}

// One weight row's stored N:M entries for the 32 columns c .. c + 31 (c a
// multiple of 32): 16 values and 16 int8 positions (2:4 and 4:8 both keep
// half). Entries of groups at or past K read as position -128, which
// matches no column. ``vec``: every row's entries start on a 32-byte
// boundary (K a multiple of 32), so they are two 16-byte value loads and
// one 16-byte position load; ``wide``: at 2:4 they ask L2 for the rest of
// their 256-byte blocks (ldg_l2).
struct NmRaw {
  uint32_t v[8], p[4];
};

template <int NK, int MG>
__device__ __forceinline__ void nm_load(NmRaw& raw,
                                        const bf16* __restrict__ vals,
                                        const int8_t* __restrict__ idx,
                                        size_t base, int c, int K, bool vec,
                                        bool wide) {
  static_assert(32 / MG * NK == 16, "16 stored entries per 32 columns");
  const size_t e = base + (size_t)(c / MG) * NK;
  if (vec && c + 32 <= K) {
    // (4:8, whose decode binds, was slower with the L2 request)
    auto ld = [wide](const void* p) {
      const uint4* q4 = reinterpret_cast<const uint4*>(p);
      if constexpr (NK == 2 && MG == 4)
        if (wide) return ldg_l2(q4);
      return __ldg(q4);
    };
    const uint4 a = ld(vals + e);
    const uint4 b = ld(vals + e + 8);
    const uint4 q = ld(idx + e);
    raw.v[0] = a.x; raw.v[1] = a.y; raw.v[2] = a.z; raw.v[3] = a.w;
    raw.v[4] = b.x; raw.v[5] = b.y; raw.v[6] = b.z; raw.v[7] = b.w;
    raw.p[0] = q.x; raw.p[1] = q.y; raw.p[2] = q.z; raw.p[3] = q.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) raw.v[j] = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) raw.p[j] = 0x80808080u;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (c + (j / NK) * MG >= K) continue;
    raw.v[j >> 1] |= bits16(vals[e + j]) << ((j & 1) * 16);
    const uint32_t pb = (uint32_t)(uint8_t)idx[e + j];
    raw.p[j >> 2] = (raw.p[j >> 2] & ~(0xffu << ((j & 3) * 8))) |
                    (pb << ((j & 3) * 8));
  }
}

// The A elements of those 32 columns, packed two to a word (a[j]:
// columns c + 2j, c + 2j + 1). A position outside [0, MG) matches no
// column; the first of two entries at one position wins (the packer
// never emits two).
template <int NK, int MG>
__device__ __forceinline__ void nm_decode(uint32_t (&a)[16],
                                          const NmRaw& raw) {
  int pos[16];
  uint32_t val[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    pos[j] = (int)(int8_t)((raw.p[j >> 2] >> ((j & 3) * 8)) & 0xffu);
    val[j] = (raw.v[j >> 1] >> ((j & 1) * 16)) & 0xffffu;
  }
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    uint32_t h[2];
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      const int col = i + d, grp = col / MG, j = col % MG;
      uint32_t b = 0u;
#pragma unroll
      for (int n = NK - 1; n >= 0; --n)
        b = pos[grp * NK + n] == j ? val[grp * NK + n] : b;
      h[d] = b;
    }
    a[i / 2] = h[0] | (h[1] << 16);
  }
}

// x << n with n of 32 or more giving 0 (PTX shl clamps the shift)
__device__ __forceinline__ uint32_t shl_clamp(uint32_t x, uint32_t n) {
  uint32_t r;
  asm("shl.b32 %0, %1, %2;\n" : "=r"(r) : "r"(x), "r"(n));
  return r;
}

// 2:4 by byte permutes: group j's two values are word v[j] (entry 0 low),
// their positions bytes 2j, 2j + 1 of p. Column c of the group takes the
// bytes that a selector byte names: 0x54 (the zero word's), 0x10 (entry
// 0) or 0x32 (entry 1), set by XOR at byte 8·position; a position outside
// [0, 4) shifts past the word and sets nothing.
__device__ __forceinline__ void nm_decode_24(uint32_t (&a)[16],
                                             const NmRaw& raw) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t pw = raw.p[j >> 1] >> (16 * (j & 1));
    const uint32_t sel = 0x54545454u ^ shl_clamp(0x44u, (pw & 0xffu) << 3) ^
                         shl_clamp(0x66u, ((pw >> 8) & 0xffu) << 3);
    a[2 * j] = __byte_perm(raw.v[j], 0u, sel);
    a[2 * j + 1] = __byte_perm(raw.v[j], 0u, sel >> 16);
  }
}

// 2:4 by byte permutes, other patterns by comparisons
template <int NK, int MG>
__device__ __forceinline__ void nm_decode_a(uint32_t (&a)[16],
                                            const NmRaw& raw) {
  if constexpr (NK == 2 && MG == 4)
    nm_decode_24(a, raw);
  else
    nm_decode<NK, MG>(a, raw);
}

constexpr int kRingStages = 4;               // most stages of a warp's ring

// The operands of one tc_kernel launch.
struct TcArgs {
  const bf16* x;          // (E, M, K)
  const bf16* w;          // vals (E·N, K/m·n) or the dense W_S (E·N, K)
  const int8_t* idx;      // N:M positions, as vals
  const uint32_t* bp;     // BIN: sign words (E, N, K/32)
  const bf16* u;          // (E, R, N)
  const bf16* v;          // (E, R, K)
  bf16* y;                // (E, M, N)
  float* part;            // split: (splits, E, M, N) partial sums
  int* tickets;           // split: one per expert and block column, zero
                          // between launches
  int M, N, K, R;
  int cps;                // 128-column chunks a split covers
  int stages;             // DenseSrc: stages of each warp's ring
  int tpb;                // row tiles a block walks
};

// Whether a launch's splits are 2048 columns or wider: then a row's
// planes and sign words in a split fill whole 256-byte blocks, and their
// loads ask L2 for the rest of the block (ldg_l2). Narrower splits (#2 at
// its per-linear shapes) lost up to 8 % with it on an H100, #17 and #19
// gained 3-5 % (PERF.md).
__device__ __forceinline__ bool wide_split(const TcArgs& a) {
  return min(a.K, a.cps * 128) >= 2048;
}

// #7 under a split: the partial projections (splits, E, block columns, M,
// R), fp32, after the partial sums (splits, E, M, N) in part; the slot of
// split 0 for expert ex and this block's column.
__device__ __forceinline__ float* proj_part(const TcArgs& a, size_t ex) {
  const size_t E = gridDim.y;
  return a.part + gridDim.z * E * a.M * a.N +
         (ex * gridDim.x + blockIdx.x) * (size_t)a.M * a.R;
}

// A from N:M planes: the row pair's entries of the next chunk in
// registers.
template <int NK, int MG>
struct NmSrc {
  static constexpr bool kA = true, kRing = false;
  static constexpr int kStage = 0, kBlocks = 1, kAlign = 0;
  const bf16* vals;
  const int8_t* idx;
  size_t ba, bb;          // first entries of rows g and g + 8
  int K, q;
  bool vec, wide;
  NmRaw na, nb;           // the next chunk's entries

  __device__ __forceinline__ void init(const TcArgs& a, const CUtensorMap*,
                                       unsigned char*, uint64_t*, int lane) {
    vals = a.w;
    idx = a.idx;
    K = a.K;
    q = lane & 3;
    vec = K % 32 == 0;
    wide = wide_split(a);
  }
  // rows ra (g) and rb (g + 8) of expert ex
  __device__ __forceinline__ void at(const TcArgs& a, size_t ex, int,
                                     int ra, int rb) {
    const size_t per_row = (size_t)(a.K / MG) * NK;
    ba = (ex * a.N + ra) * per_row;
    bb = (ex * a.N + rb) * per_row;
  }
  __device__ __forceinline__ void load(int c) {
    nm_load<NK, MG>(na, vals, idx, ba, c + 32 * q, K, vec, wide);
    nm_load<NK, MG>(nb, vals, idx, bb, c + 32 * q, K, vec, wide);
  }
  __device__ __forceinline__ void begin(int c0, int) { load(c0); }
  // chunk c's A words (rows g, g + 8; a[j]: columns 32q + 2j, + 1), the
  // next chunk's loads issued first
  __device__ __forceinline__ void next(int c, int c1, uint32_t (&aa)[16],
                                       uint32_t (&ab)[16]) {
    const NmRaw ca = na, cb = nb;
    if (c + 128 < c1) load(c + 128);
    nm_decode_a<NK, MG>(aa, ca);
    nm_decode_a<NK, MG>(ab, cb);
  }
};

// One box of 16 rows x 64 columns of a tensor map (cp.async.bulk.tensor,
// the 128-byte swizzle) into shared memory, counted on the mbarrier `bar`.
__device__ __forceinline__ void tma_rows(void* dst, const CUtensorMap* map,
                                         int col, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          slab::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
      "r"(slab::smem_u32(bar))
      : "memory");
}

// A from dense rows: each warp's ring of stages in shared memory. Lane 0
// copies a chunk of the warp's 16 rows as two boxes of the launch's
// tensor map (columns c .. c + 63 and c + 64 .. c + 127; rows past the
// plane and columns past K arrive as zeros, the second box is skipped
// past K), so a stage is two halves of 16 rows of 128 bytes whose 16-byte
// unit u of row r sits at u ^ (r % 8): the two rows a quarter-warp reads
// fall in different bank groups. The ring starts on a 1024-byte boundary
// (the swizzle's span).
struct DenseSrc {
  static constexpr bool kA = true, kRing = true;
  static constexpr int kHalf = 16 * 128;      // 16 rows of 64 columns
  static constexpr int kStage = 2 * kHalf;
  static constexpr int kBlocks = 2;           // blocks an SM (shared memory)
  static constexpr int kAlign = 1024;
  const CUtensorMap* map;
  unsigned char* ring;    // this warp's stages
  uint64_t* bars;         // and their mbarriers
  int K, stages, lane, row;  // row: the warp's first row in the map
  uint32_t issued, used;  // chunks copied / read, over every pass and tile

  __device__ __forceinline__ void init(const TcArgs& a, const CUtensorMap* m,
                                       unsigned char* r, uint64_t* b,
                                       int l) {
    map = m;
    ring = r;
    bars = b;
    K = a.K;
    stages = a.stages;
    lane = l;
    issued = used = 0;
  }
  // the warp's 16 rows from row0 of expert ex
  __device__ __forceinline__ void at(const TcArgs& a, size_t ex, int row0,
                                     int, int) {
    row = (int)(ex * a.N) + row0;
  }
  __device__ __forceinline__ void issue(int c) {
    const int st = issued % stages;
    if (lane == 0) {
      const bool two = c + 64 < K;
      mbar_expect(&bars[st], two ? 2u * kHalf : (uint32_t)kHalf);
      tma_rows(ring + st * kStage, map, c, row, &bars[st]);
      if (two)
        tma_rows(ring + st * kStage + kHalf, map, c + 64, row, &bars[st]);
    }
    ++issued;
  }
  __device__ __forceinline__ void begin(int c0, int c1) {
    for (int i = 0; i < stages && c0 + 128 * i < c1; ++i) issue(c0 + 128 * i);
  }
  // chunk c's A words from its stage (zero past K); the stage then takes
  // the chunk `stages` ahead. Lane q's 32 columns are units 4(q & 1) ..
  // 4(q & 1) + 3 of half q >> 1.
  __device__ __forceinline__ void next(int c, int c1, uint32_t (&aa)[16],
                                       uint32_t (&ab)[16]) {
    const int st = used % stages;
    mbar_wait(&bars[st], (used / stages) & 1u);
    const int g = lane >> 2, q = lane & 3;
    const unsigned char* pa =
        ring + st * kStage + (q >> 1) * kHalf + g * 128;
    const unsigned char* pb = pa + 8 * 128;
    const int left = K - c - 32 * q;        // this lane's columns left
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int at = ((4 * (q & 1) + j) ^ g) * 16;
      uint4 wa = *reinterpret_cast<const uint4*>(pa + at);
      uint4 wb = *reinterpret_cast<const uint4*>(pb + at);
      if (8 * j >= left) wa = wb = make_uint4(0, 0, 0, 0);
      aa[4 * j] = wa.x; aa[4 * j + 1] = wa.y;
      aa[4 * j + 2] = wa.z; aa[4 * j + 3] = wa.w;
      ab[4 * j] = wb.x; ab[4 * j + 1] = wb.y;
      ab[4 * j + 2] = wb.z; ab[4 * j + 3] = wb.w;
    }
    __syncwarp();                         // every lane has read the stage
    // ... and those generic-proxy reads come before the async proxy's
    // copy into it (without the fence #18's results went wrong now and
    // then on an H100)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (c + 128 * stages < c1) issue(c + 128 * stages);
    ++used;
  }
};

// No A (#20: a W_S of zeros is not stored): the body skips A's loads, its
// mma and the x tile.
struct NoSrc {
  static constexpr bool kA = false, kRing = false;
  static constexpr int kStage = 0, kBlocks = 1, kAlign = 0;
  __device__ __forceinline__ void init(const TcArgs&, const CUtensorMap*,
                                       unsigned char*, uint64_t*, int) {}
  __device__ __forceinline__ void at(const TcArgs&, size_t, int, int, int) {}
  __device__ __forceinline__ void begin(int, int) {}
  __device__ __forceinline__ void next(int, int, uint32_t (&)[16],
                                       uint32_t (&)[16]) {}
};

// A lane's sign word of a chunk spread for the ±1 A fragments: bits j and
// j + 1 of the word (j even, j < 16) at bits j and j + 16 of lo, bits j +
// 16 and j + 17 at bits j and j + 16 of hi. Step s's four columns 4s ..
// 4s + 3 then sit at bits 15 and 31 of (lo or hi) << (15 - 4(s % 4)) and
// << (13 - 4(s % 4)).
__device__ __forceinline__ void xspread(uint32_t w, uint32_t& lo,
                                        uint32_t& hi) {
  lo = __byte_perm(w, w << 15, 0x7610);
  hi = __byte_perm(w, w >> 1, 0x7632);
}

// The lane's four 16-byte units of a staged row in a chunk (columns 32q
// .. 32q + 31) as the B words of the chunk's 8 steps: xr_unit(u) of u =
// chunk / 8 + 4q + j is chunk / 8 + ((4q + j) ^ (q & 2)), so unit j is
// at row + 32q + (8j ^ 8(q & 2)) elements.
__device__ __forceinline__ void load_units(uint32_t (&bw)[16], const bf16* row,
                                           int q) {
  const bf16* at = row + 32 * q;
  const int flip = 8 * (q & 2);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint4 b = *reinterpret_cast<const uint4*>(at + ((8 * j) ^ flip));
    bw[4 * j] = b.x; bw[4 * j + 1] = b.y;
    bw[4 * j + 2] = b.z; bw[4 * j + 3] = b.w;
  }
}

// A bf16 value's bits twice, both sign bits flipped: the ±1 term's A
// words before the sign bits of their columns flip them back.
__device__ __forceinline__ uint32_t flipped_pair(bf16 v) {
  const uint32_t b = bits16(v);
  return (b | (b << 16)) ^ 0x80008000u;
}

// The A words of step s of the ±1 term (rows g and g + 8, k-slots 2q, 2q+1
// and 2q+8, 2q+9: the step's columns 4s .. 4s + 3), from the spread sign
// words sa (row g) and sb (row g + 8), whose step-s bits sit at 15 and 31
// after a shift (xspread), and ua / ub (flipped_pair of ±u_r or of 1): a
// set sign bit flips a sign back.
__device__ __forceinline__ void bin_a(uint32_t (&A)[4],
                                      const uint32_t (&sa)[2],
                                      const uint32_t (&sb)[2], int s,
                                      uint32_t ua, uint32_t ub) {
  constexpr uint32_t kSigns = 0x80008000u;
  const uint32_t fa = sa[s / 4], fb = sb[s / 4];
  const int sh = 15 - 4 * (s % 4);
  A[0] = ua ^ ((fa << sh) & kSigns);
  A[1] = ub ^ ((fb << sh) & kSigns);
  A[2] = ua ^ ((fa << (sh - 2)) & kSigns);
  A[3] = ub ^ ((fb << (sh - 2)) & kSigns);
}

// One chunk of ±u_r · bf16(x ⊙ v_r) into c: B from a row of tile r (the
// lane's units of the row, load_units), A from bin_a.
__device__ __forceinline__ void bin_chunk(float (&c)[4], uint32_t ua,
                                          uint32_t ub,
                                          const uint32_t (&sa)[2],
                                          const uint32_t (&sb)[2],
                                          const bf16* row,
                                          int q) {
  uint32_t bw[16];
  load_units(bw, row, q);
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    uint32_t A[4];
    bin_a(A, sa, sb, s, ua, ub);
    mma_bf16(c, A[0], A[1], A[2], A[3], bw[2 * s], bw[2 * s + 1]);
  }
}

// LR: the low-rank projection and its epilogue term (#19, #18, #7). BIN:
// the ±1 term (#2, #17, #20, #3, #16, #9). SPLIT: K may be split over
// gridDim.z (#2, #17, #20, #8, #7, #3, #16, #6, #15, #9); without it (tc_kernel: #19,
// #18, one split) the split's stores and reduction are not compiled.
// `map`: DenseSrc's tensor map, a kernel parameter.
template <class Src, int NTP, bool LR, bool BIN, bool SPLIT = true>
__device__ __forceinline__ void tc_body(const TcArgs& a,
                                        const CUtensorMap* map,
                                        uint64_t* bars, int& last_split) {
  constexpr int MT = 8 * NTP;                 // batch rows per pass
  constexpr bool kX = Src::kA || LR;          // the x tile is read
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int M = a.M, N = a.N, K = a.K, R = a.R;
  const size_t ex = blockIdx.y, E = gridDim.y;
  const int n_split = SPLIT ? (int)gridDim.z : 1;
  const int k_lo = blockIdx.z * a.cps * 128;  // this split's columns
  const int k_hi = min(K, k_lo + a.cps * 128);
  const int kw = k_hi - k_lo;
  const int Kp = (kw + 127) / 128 * 128, sx = Kp + 8;
  const int tpb = BIN ? a.tpb : 1;            // this block's row tiles
  const int t_lo = blockIdx.x * tpb;
  const int t_hi = min((N + kRows - 1) / kRows, t_lo + tpb);
  const int span = tpb * kRows;               // rows of the block's tiles
  bf16* xr = reinterpret_cast<bf16*>(smem_raw);                 // (MT, sx)
  bf16* xv = xr + (kX ? (size_t)MT * sx : 0);   // BIN: R tiles of x ⊙ v_r
  bf16* us = xv + (BIN ? (size_t)R * MT * sx : 0);  // BIN: (R, span) of u
  float* p = reinterpret_cast<float*>(us + (BIN ? (size_t)R * span : 0));
  float* part = p + (size_t)R * MT;       // LR: p (R, MT), (kWarps, R, MT)
  unsigned char* ring = reinterpret_cast<unsigned char*>(p) +
      (LR ? slab::align16_up((size_t)(kWarps + 1) * R * MT * sizeof(float))
          : 0);
  if constexpr (Src::kAlign > 0)         // on the boundary, in the window
    ring += (Src::kAlign - slab::smem_u32(ring) % Src::kAlign) % Src::kAlign;
  const bf16* x = a.x + ex * M * K;
  bf16* y = a.y + ex * M * N;
  const bf16* u = a.u + ex * R * N;
  const bf16* v = a.v + ex * R * K;

  Src src;
  src.init(a, map, ring + (size_t)warp * a.stages * Src::kStage,
           bars + warp * kRingStages, lane);
  if (Src::kRing) {                  // each warp's own ring, used at once
    if (lane < a.stages) mbar_init(&bars[warp * kRingStages + lane]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    __syncwarp();
  }
  // BIN: the lane's sign words as one stream over the block's tiles in
  // order, a chunk ahead of their use (#20 ran no faster 2, 4, 8 or 16
  // ahead): (ft, fk) is the next chunk to load, of tile ft's rows, into
  // wna / wnb
  uint32_t wna, wnb;
  int ft = t_hi, fk = k_lo;
  auto aim = [&](int t) {
    ft = t < t_hi && t * kRows + warp * 16 < N ? t : t_hi;  // only a last
    fk = k_lo;                                               // tile has none
  };
  const bool whole = wide_split(a);
  auto fetch = [&](uint32_t& wa, uint32_t& wb) {
    if (ft >= t_hi) return;
    const int r0 = ft * kRows + warp * 16;
    const bool in = fk + 32 * q < K;      // zero past K
    const uint32_t* pa = a.bp + (ex * N + min(r0 + g, N - 1)) *
                                    (size_t)(K / 32) + fk / 32 + q;
    const uint32_t* pb = a.bp + (ex * N + min(r0 + g + 8, N - 1)) *
                                    (size_t)(K / 32) + fk / 32 + q;
    wa = in ? (whole ? ldg_l2(pa) : __ldg(pa)) : 0u;
    wb = in ? (whole ? ldg_l2(pb) : __ldg(pb)) : 0u;
    fk += 128;
    if (fk >= k_hi) aim(ft + 1);
  };
  for (int m0 = 0; m0 < M; m0 += MT) {
    for (int t = t_lo; t < t_hi; ++t) {
      // the tile's rows; its first chunks of A load while x is staged (and
      // projected) or the last tile's results are stored
      const int row0 = t * kRows + warp * 16;
      const bool live = row0 < N;
      const int ra = min(row0 + g, N - 1), rb = min(row0 + g + 8, N - 1);
      if constexpr (Src::kA) {
        if (live) {
          src.at(a, ex, row0, ra, rb);
          src.begin(k_lo, k_hi);
        }
      }
      if (t == t_lo) {
        if constexpr (BIN) {
          aim(t_lo);
          fetch(wna, wnb);
        }
        __syncthreads();             // the previous pass's readers are done
        stage_rows(kX ? xr : nullptr, x + k_lo, K, m0, M, kw, Kp, sx, NTP,
                   BIN ? xv : nullptr, BIN ? v + k_lo : nullptr,
                   BIN ? R : 0);
        if constexpr (BIN) {
          for (int i = threadIdx.x; i < R * span; i += blockDim.x) {
            const int r = i / span, j = i - r * span;
            us[i] = u[(size_t)r * N + min(t_lo * kRows + j, N - 1)];
          }
        }
        __syncthreads();
        if (LR) {
          // p[r, m] = Σ_k x[m, k] · v_r[k] over the split's columns in
          // fp32 (the x tile holds columns k_lo .. k_hi - 1): every warp
          // takes a strided share, the partial sums are added in warp order
          for (int r = 0; r < R; ++r) {
            float acc[MT];
#pragma unroll
            for (int m = 0; m < MT; ++m) acc[m] = 0.f;
            for (int k = k_lo + warp * 32 + lane; k < k_hi;
                 k += kWarps * 32) {
              const float vk = __bfloat162float(v[(size_t)r * K + k]);
              const int kk = xr_elem(k - k_lo);
#pragma unroll
              for (int m = 0; m < MT; ++m)
                acc[m] += __bfloat162float(xr[(size_t)m * sx + kk]) * vk;
            }
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              const float s = slab::warp_sum(acc[m]);
              if (lane == 0) part[((size_t)warp * R + r) * MT + m] = s;
            }
          }
          __syncthreads();
          for (int i = threadIdx.x; i < R * MT; i += blockDim.x) {
            float s = 0.f;
            for (int w = 0; w < kWarps; ++w) s += part[(size_t)w * R * MT + i];
            p[i] = s;
            // split: the partial projection goes to the last block
            const int r = i / MT, m = m0 + i - r * MT;
            if (n_split > 1 && m < M)
              proj_part(a, ex)[((size_t)blockIdx.z * E * gridDim.x) * M * R +
                               (size_t)m * R + r] = s;
          }
          __syncthreads();
        }
      }
      if (!live) continue;
      // BIN: u of rows ra and rb in the staged (R, span) u
      const int ja = ra - t_lo * kRows, jb = rb - t_lo * kRows;

      // #20 (no A): its ranks in the reference's order, one accumulator
      // each, scaled by u_r after the sum
      constexpr int kRanked = Src::kA ? 0 : kMaxR;
      float c[NTP][4], cr[kRanked ? kRanked : 1][NTP][4];
#pragma unroll
      for (int tt = 0; tt < NTP; ++tt) {
        c[tt][0] = c[tt][1] = c[tt][2] = c[tt][3] = 0.f;
#pragma unroll
        for (int r = 0; r < kRanked; ++r)
          cr[r][tt][0] = cr[r][tt][1] = cr[r][tt][2] = cr[r][tt][3] = 0.f;
      }
      for (int kc = k_lo; kc < k_hi; kc += 128) {
        uint32_t aa[16], ab[16];
        if constexpr (Src::kA) src.next(kc, k_hi, aa, ab);
        uint32_t sa[2] = {0u, 0u}, sb[2] = {0u, 0u};  // BIN: spread words
        if constexpr (BIN) {
          xspread(wna, sa[0], sa[1]);
          xspread(wnb, sb[0], sb[1]);
          fetch(wna, wnb);
        }
#pragma unroll
        for (int tt = 0; tt < NTP; ++tt) {
          const size_t at = (size_t)(8 * tt + g) * sx + (kc - k_lo);
          if constexpr (Src::kA) {
            uint32_t bw[16];
            load_units(bw, xr + at, q);
#pragma unroll
            for (int s = 0; s < 8; ++s)
              mma_bf16(c[tt], aa[2 * s], ab[2 * s], aa[2 * s + 1],
                       ab[2 * s + 1], bw[2 * s], bw[2 * s + 1]);
          }
          if constexpr (BIN) {
            // Σ_r ±u_r · bf16(x ⊙ v_r), B from tile r: #20's ranks (at
            // most kMaxR) share A = ±1, decoded once a step (a build that
            // decoded ±u_r for each rank was 10 % slower at rank 3, as
            // fast at rank 1); #2 and #17, whose registers are capped,
            // decode ±u_r into c
            if constexpr (kRanked > 0) {
              constexpr uint32_t kOne = 0xBF80BF80u;   // flipped_pair(1)
              uint32_t A[8][4];
#pragma unroll
              for (int s = 0; s < 8; ++s) bin_a(A[s], sa, sb, s, kOne, kOne);
#pragma unroll
              for (int r = 0; r < kRanked; ++r) {
                if (r >= R) break;
                uint32_t bw[16];
                load_units(bw, xv + (size_t)r * MT * sx + at, q);
#pragma unroll
                for (int s = 0; s < 8; ++s)
                  mma_bf16(cr[r][tt], A[s][0], A[s][1], A[s][2], A[s][3],
                           bw[2 * s], bw[2 * s + 1]);
              }
            }
            if constexpr (kRanked == 0) {
              for (int r = 0; r < R; ++r)
                bin_chunk(c[tt], flipped_pair(us[r * span + ja]),
                          flipped_pair(us[r * span + jb]), sa, sb,
                          xv + (size_t)r * MT * sx + at, q);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRanked; ++r) {
        if (r >= R) break;
        const float fa = __bfloat162float(us[r * span + ja]);
        const float fb = __bfloat162float(us[r * span + jb]);
#pragma unroll
        for (int tt = 0; tt < NTP; ++tt) {
          c[tt][0] += cr[r][tt][0] * fa; c[tt][1] += cr[r][tt][1] * fa;
          c[tt][2] += cr[r][tt][2] * fb; c[tt][3] += cr[r][tt][3] * fb;
        }
      }

      const int na = row0 + g, nb = row0 + g + 8;
#pragma unroll
      for (int tt = 0; tt < NTP; ++tt) {
        const int mi = 8 * tt + 2 * q, m = m0 + mi;
        float l0 = 0.f, l1 = 0.f, l2 = 0.f, l3 = 0.f;
        if (LR && n_split == 1) {
          for (int r = 0; r < R; ++r) {
            const float ua = __bfloat162float(u[(size_t)r * N + ra]);
            const float ub = __bfloat162float(u[(size_t)r * N + rb]);
            const float p0 = p[r * MT + mi], p1 = p[r * MT + mi + 1];
            l0 += p0 * ua; l1 += p1 * ua; l2 += p0 * ub; l3 += p1 * ub;
          }
        }
        if (n_split > 1) {             // fp32 partial sums of this split
          float* pt = a.part + ((size_t)blockIdx.z * E + ex) * M * N;
          if (m < M) {
            if (na < N) pt[(size_t)m * N + na] = c[tt][0];
            if (nb < N) pt[(size_t)m * N + nb] = c[tt][2];
          }
          if (m + 1 < M) {
            if (na < N) pt[(size_t)(m + 1) * N + na] = c[tt][1];
            if (nb < N) pt[(size_t)(m + 1) * N + nb] = c[tt][3];
          }
          continue;
        }
        if (m < M) {
          if (na < N) y[(size_t)m * N + na] = __float2bfloat16(c[tt][0] + l0);
          if (nb < N) y[(size_t)m * N + nb] = __float2bfloat16(c[tt][2] + l2);
        }
        if (m + 1 < M) {
          if (na < N)
            y[(size_t)(m + 1) * N + na] = __float2bfloat16(c[tt][1] + l1);
          if (nb < N)
            y[(size_t)(m + 1) * N + nb] = __float2bfloat16(c[tt][3] + l3);
        }
      }
    }
  }
  if (n_split == 1) return;

  // The last block of this expert's block column to finish adds the
  // splits' partial sums in split order (the same bits whichever block is
  // last), with LR Σ_r p[m, r]·u_r[n] of the partial projections summed
  // in split order, and resets its ticket for the next launch.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    int* ticket = a.tickets + ex * gridDim.x + blockIdx.x;
    last_split = atomicAdd(ticket, 1) == n_split - 1;
    if (last_split) *ticket = 0;
  }
  __syncthreads();
  if (!last_split) return;
  __threadfence();
  const int n0 = t_lo * kRows, nr = min(span, N - n0);
  const size_t zs = E * M * N;
  const float* pp = LR ? proj_part(a, ex) : nullptr;
  const size_t pzs = E * gridDim.x * (size_t)M * R;   // one split's p
  // LR: MT rows at a time, their partial projections summed in split
  // order into p first (one load round trip for the rows, none an output)
  for (int mc = 0; mc < M; mc += LR ? MT : M) {
    const int mr = LR ? min(MT, M - mc) : M;
    if (LR) {
      for (int i = threadIdx.x; i < R * mr; i += blockDim.x) {
        const int r = i / mr, m = mc + i - r * mr;
        const float* pm = pp + (size_t)m * R + r;
        float pr = 0.f;
        for (int z0 = 0; z0 < n_split; z0 += 8) {   // 8 loads in flight
          float t[8];
#pragma unroll
          for (int z = 0; z < 8; ++z)
            t[z] = z0 + z < n_split ? __ldcg(pm + (z0 + z) * pzs) : 0.f;
#pragma unroll
          for (int z = 0; z < 8; ++z) pr += t[z];   // in split order
        }
        p[r * MT + m - mc] = pr;
      }
      __syncthreads();
    }
    for (int i = threadIdx.x; i < mr * span; i += blockDim.x) {
      const int m = mc + i / span, nn = i - (m - mc) * span;
      if (nn >= nr) continue;
      // (rank 0's u, loaded beside the partial sums)
      const float u0 = LR ? __bfloat162float(u[n0 + nn]) : 0.f;
      const float* pt = a.part + (ex * M + m) * N + n0 + nn;
      float s = 0.f;
      for (int z0 = 0; z0 < n_split; z0 += 8) {   // 8 loads in flight
        float t[8];
#pragma unroll
        for (int z = 0; z < 8; ++z)
          t[z] = z0 + z < n_split ? __ldcg(pt + (z0 + z) * zs) : 0.f;
#pragma unroll
        for (int z = 0; z < 8; ++z) s += t[z];   // in split order
      }
      if (LR) {
        float l = p[m - mc] * u0;
        for (int r = 1; r < R; ++r)
          l += p[r * MT + m - mc] *
               __bfloat162float(u[(size_t)r * N + n0 + nn]);
        s += l;
      }
      y[(size_t)m * N + n0 + nn] = __float2bfloat16(s);
    }
    if (LR) __syncthreads();              // p is read before the next rows
  }
}

// #19 and #18 (LR); #2 and #3 (BIN), whose registers are capped at one
// n-tile (the decode step's M <= 8) so that kBinMinBlocks blocks share an
// SM (wider tiles would spill under the cap; #20's NoSrc spilled at 3);
// #9 under #2's name; #17, #20, #16 (BIN on experts) and #15 (experts, no
// ±1 term), and #8, #7 and #6 (per linear, no ±1 term, K split), the same
// under names of their own, so that a profile tells them from #2, #19 and
// #18.
constexpr int kBinMinBlocks = 2;

template <class Src, int NTP, bool LR, bool BIN>
__global__ void __launch_bounds__(kWarps * 32)
    tc_kernel(const TcArgs a, const __grid_constant__ CUtensorMap map) {
  __shared__ __align__(8) uint64_t bars[Src::kRing ? kWarps * kRingStages : 1];
  __shared__ int last_split;
  tc_body<Src, NTP, LR, BIN, false>(a, &map, bars, last_split);  // 1 split
}

template <class Src, int NTP, bool LR, bool BIN>
__global__ void __launch_bounds__(kWarps * 32, NTP == 1 ? kBinMinBlocks : 1)
    tc_bin_kernel(const TcArgs a, const __grid_constant__ CUtensorMap map) {
  __shared__ __align__(8) uint64_t bars[Src::kRing ? kWarps * kRingStages : 1];
  __shared__ int last_split;
  tc_body<Src, NTP, LR, BIN>(a, &map, bars, last_split);
}

template <class Src, int NTP, bool LR, bool BIN>
__global__ void __launch_bounds__(kWarps * 32, NTP == 1 ? kBinMinBlocks : 1)
    tc_g_kernel(const TcArgs a, const __grid_constant__ CUtensorMap map) {
  __shared__ __align__(8) uint64_t bars[Src::kRing ? kWarps * kRingStages : 1];
  __shared__ int last_split;
  tc_body<Src, NTP, LR, BIN>(a, &map, bars, last_split);
}

template <class Src, int NTP, bool LR, bool BIN>
__global__ void __launch_bounds__(kWarps * 32, NTP == 1 ? kBinMinBlocks : 1)
    tc_nm_kernel(const TcArgs a, const __grid_constant__ CUtensorMap map) {
  __shared__ __align__(8) uint64_t bars[Src::kRing ? kWarps * kRingStages : 1];
  __shared__ int last_split;
  tc_body<Src, NTP, LR, BIN>(a, &map, bars, last_split);
}

// The __global__ name a launch runs under: tc_kernel (grouped, one split:
// #19, #18), tc_bin_kernel (per linear with the ±1 term: #2, #3, #9),
// tc_g_kernel (grouped, K split: #17, #20, #16 and #15, which has no ±1
// term: tc_g_kernel<tc::NmSrc<…>, NTP, false, false>), tc_nm_kernel
// (per linear without it, K split: #8 and #7 on NmSrc, #6 on DenseSrc, so
// that a profile tells #6, tc_nm_kernel<tc::DenseSrc, ...>, from #18,
// tc_kernel<tc::DenseSrc, ...>).
enum class Entry { kTc, kBin, kG, kNm };

// The batch tiles per pass and ring stages of a launch: the most n-tiles
// (up to what M needs, kMaxNtp), then the most ring stages (kRingStages
// down to 2) whose shared bytes let Src::kBlocks blocks share an SM (and
// fit the card's opt-in limit), else as many blocks as fit. Returns the
// tile count, 0 when nothing fits.
template <class Src, bool LR, bool BIN>
inline int pick_tc(int M, int kw, int R, int tpb, int* stages,
                   size_t* smem) {
  int dev = 0, optin = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&per_sm,
                             cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                             dev) != cudaSuccess)
    return 0;
  const int Kp = (kw + 127) / 128 * 128;
  const int tiles = (Src::kA || LR ? 1 : 0) + (BIN ? R : 0);
  for (int blocks = Src::kBlocks; blocks >= 1; --blocks) {
    const size_t limit = min((size_t)optin, (size_t)per_sm / blocks - 1024);
    for (int ntp = min((M + 7) / 8, kMaxNtp); ntp >= 1; --ntp) {
      for (int st = Src::kRing ? kRingStages : 0;
           st >= (Src::kRing ? 2 : 0); --st) {
        const size_t bytes =
            (size_t)8 * ntp * (Kp + 8) * sizeof(bf16) * tiles +
            (BIN ? (size_t)R * tpb * kRows * sizeof(bf16) : 0) +
            (LR ? slab::align16_up((size_t)(kWarps + 1) * R * 8 * ntp *
                                   sizeof(float))
                : 0) +
            (size_t)st * kWarps * Src::kStage + Src::kAlign;
        if (bytes <= limit) {
          *stages = st;
          *smem = bytes;
          return ntp;
        }
      }
    }
  }
  return 0;
}

// The tensor map of DenseSrc's rows: the (rows, K) bf16 plane in boxes of
// 16 rows x 64 columns, the 128-byte swizzle, zeros past the plane.
// cuTensorMapEncodeTiled comes through the runtime's driver entry point,
// so the library links no libcuda.
inline int encode_rows(CUtensorMap* map, const void* w, int rows, int K) {
  using Encode = decltype(&cuTensorMapEncodeTiled);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * sizeof(bf16)};
  const cuuint32_t box[2] = {64, 16}, elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <class Src, bool LR, bool BIN,
          Entry kEntry = BIN ? Entry::kBin : Entry::kTc>
static int launch_tc(TcArgs a, int E, int n_split, void* stream) {
  CUtensorMap map{};
  if constexpr (Src::kRing) {
    const int e = encode_rows(&map, a.w, E * a.N, a.K);
    if (e) return e;
  }
  size_t smem = 0;
  const int ntp = pick_tc<Src, LR, BIN>(a.M, min(a.K, a.cps * 128), a.R,
                                        a.tpb, &a.stages, &smem);
  const int tiles = (a.N + kRows - 1) / kRows;
  const dim3 grid((tiles + a.tpb - 1) / a.tpb, E, n_split);
  TC_DISPATCH_NTP(ntp, {
    auto kern = [] {
      if constexpr (kEntry == Entry::kG)
        return tc_g_kernel<Src, NTP, LR, BIN>;
      else if constexpr (kEntry == Entry::kNm)
        return tc_nm_kernel<Src, NTP, LR, BIN>;
      else if constexpr (kEntry == Entry::kBin)
        return tc_bin_kernel<Src, NTP, LR, BIN>;
      else return tc_kernel<Src, NTP, LR, BIN>;
    }();
    cudaError_t e = slab::prepare(kern, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(a, map);
  });
  return (int)cudaGetLastError();
}

}  // namespace tc

// dtype must be 1 (bfloat16) and the pattern 2:4 or 4:8: other launches
// go to slab_matmul.cu's kernel. x (E, M, K), vals / idx (E, N, K/m, n),
// u (E, R, N), v (E, R, K), y (E, M, N). Launches on ``stream``,
// allocates nothing, returns cudaGetLastError().
extern "C" int slab_nm_lr_matmul_g(int dtype, const void* x,
                                   const void* vals, const void* idx,
                                   const void* u, const void* v, void* y,
                                   int E, int M, int N, int K, int n_keep,
                                   int m_pat, int R, void* stream) {
  if (dtype != 1 || E <= 0 || E > slab::kMaxExperts || M <= 0 || N <= 0 ||
      K <= 0 || R <= 0 || m_pat <= 0 || K % m_pat)
    return (int)cudaErrorInvalidValue;
  if (!slab::aligned16(vals) || !slab::aligned16(idx))
    return (int)cudaErrorMisalignedAddress;
  tc::TcArgs a{(const tc::bf16*)x, (const tc::bf16*)vals,
               (const int8_t*)idx, nullptr, (const tc::bf16*)u,
               (const tc::bf16*)v, (tc::bf16*)y, nullptr, nullptr,
               M, N, K, R, (K + 127) / 128, 0, 1};
  if (n_keep == 2 && m_pat == 4)
    return tc::launch_tc<tc::NmSrc<2, 4>, true, false>(a, E, 1, stream);
  if (n_keep == 4 && m_pat == 8)
    return tc::launch_tc<tc::NmSrc<4, 8>, true, false>(a, E, 1, stream);
  return (int)cudaErrorInvalidValue;
}

// dtype must be 1 (bfloat16) and K a multiple of 8 (rows on 16-byte
// boundaries, for the bulk copies): other launches go to slab_matmul.cu's
// kernel. x (E, M, K), ws (E, N, K), u (E, R, N), v (E, R, K), y (E, M,
// N). Launches on ``stream``, allocates nothing, returns
// cudaGetLastError().
extern "C" int slab_lr_matmul_g(int dtype, const void* x, const void* ws,
                                const void* u, const void* v, void* y, int E,
                                int M, int N, int K, int R, void* stream) {
  if (dtype != 1 || E <= 0 || E > slab::kMaxExperts || M <= 0 || N <= 0 ||
      K <= 0 || K % 8 || R <= 0)
    return (int)cudaErrorInvalidValue;
  if (!slab::aligned16(ws)) return (int)cudaErrorMisalignedAddress;
  tc::TcArgs a{(const tc::bf16*)x, (const tc::bf16*)ws, nullptr, nullptr,
               (const tc::bf16*)u, (const tc::bf16*)v, (tc::bf16*)y,
               nullptr, nullptr, M, N, K, R, (K + 127) / 128, 0, 1};
  return tc::launch_tc<tc::DenseSrc, true, false>(a, E, 1, stream);
}

namespace tc {

// The split plan of #2, #17, #20, #3 and #16
// (kernels/slab_matmul.py::plan_nm_splits, ::plan_dense_splits and
// ::plan_tiles_per_block): n_split runs of cps chunks cover K, the last
// one not empty, and a split has its scratch.
inline bool split_ok(int K, int n_split, int cps, int tpb, const void* part,
                     const void* tickets) {
  return n_split > 0 && cps > 0 && tpb > 0 &&
         (n_split - 1) * cps * 128 < K && n_split * cps * 128 >= K &&
         n_split <= 65535 &&
         (n_split == 1 || (part != nullptr && tickets != nullptr));
}

}  // namespace tc

// dtype must be 1 (bfloat16) and the pattern 2:4 or 4:8: other launches
// go to slab_matmul.cu's kernel. x (M, K), vals / idx (N, K/m, n), bp (N,
// K/32), u (R, N), v (R, K), y (M, N); K split into n_split runs of cps
// 128-column chunks (the last may be shorter), and with n_split > 1 part
// (n_split, M, N) fp32 scratch and tickets (⌈N/128⌉ ints, zero; zero
// again after the launch). Launches on ``stream``, allocates nothing,
// returns cudaGetLastError().
extern "C" int slab_nm_matmul(int dtype, const void* x, const void* vals,
                              const void* idx, const void* bp, const void* u,
                              const void* v, void* y, void* part,
                              void* tickets, int M, int N, int K, int n_keep,
                              int m_pat, int R, int n_split, int cps,
                              void* stream) {
  if (dtype != 1 || M <= 0 || N <= 0 || K <= 0 || K % 32 || R <= 0 ||
      !tc::split_ok(K, n_split, cps, 1, part, tickets))
    return (int)cudaErrorInvalidValue;
  if (!slab::aligned16(vals) || !slab::aligned16(idx) ||
      !slab::aligned16(bp))
    return (int)cudaErrorMisalignedAddress;
  tc::TcArgs a{(const tc::bf16*)x, (const tc::bf16*)vals,
               (const int8_t*)idx, (const uint32_t*)bp, (const tc::bf16*)u,
               (const tc::bf16*)v, (tc::bf16*)y, (float*)part, (int*)tickets,
               M, N, K, R, cps, 0, 1};
  if (n_keep == 2 && m_pat == 4)
    return tc::launch_tc<tc::NmSrc<2, 4>, false, true>(a, 1, n_split, stream);
  if (n_keep == 4 && m_pat == 8)
    return tc::launch_tc<tc::NmSrc<4, 8>, false, true>(a, 1, n_split, stream);
  return (int)cudaErrorInvalidValue;
}

// #8: dtype must be 1 (bfloat16) and the pattern 2:4 or 4:8: other
// launches go to nm_sparse.cu's kernel. x (M, K), vals / idx (N, K/m, n),
// y (M, N), any K the pattern divides (at K % 32 != 0 the planes are read
// entry by entry); K split into n_split runs of cps 128-column chunks (the
// last may be shorter), and with n_split > 1 part (n_split, M, N) fp32
// scratch and tickets (⌈N/128⌉ ints, zero; zero again after the launch).
// Launches on ``stream``, allocates nothing, returns cudaGetLastError().
extern "C" int nm_matmul(int dtype, const void* x, const void* vals,
                         const void* idx, void* y, void* part, void* tickets,
                         int M, int N, int K, int n_keep, int m_pat,
                         int n_split, int cps, void* stream) {
  if (dtype != 1 || M <= 0 || N <= 0 || K <= 0 || m_pat <= 0 || K % m_pat ||
      !tc::split_ok(K, n_split, cps, 1, part, tickets))
    return (int)cudaErrorInvalidValue;
  if (!slab::aligned16(vals) || !slab::aligned16(idx))
    return (int)cudaErrorMisalignedAddress;
  tc::TcArgs a{(const tc::bf16*)x, (const tc::bf16*)vals,
               (const int8_t*)idx, nullptr, nullptr, nullptr, (tc::bf16*)y,
               (float*)part, (int*)tickets, M, N, K, 0, cps, 0, 1};
  if (n_keep == 2 && m_pat == 4)
    return tc::launch_tc<tc::NmSrc<2, 4>, false, false, tc::Entry::kNm>(
        a, 1, n_split, stream);
  if (n_keep == 4 && m_pat == 8)
    return tc::launch_tc<tc::NmSrc<4, 8>, false, false, tc::Entry::kNm>(
        a, 1, n_split, stream);
  return (int)cudaErrorInvalidValue;
}

// #7 (#19 at one expert, K split): dtype must be 1 (bfloat16) and the
// pattern 2:4 or 4:8: other launches go to slab_matmul.cu's kernel. x (M,
// K), vals / idx (N, K/m, n), u (R, N), v (R, K), y (M, N), any K the
// pattern divides; the split as nm_matmul's, with n_split > 1 part
// holding the (n_split, M, N) partial sums and after them the (n_split,
// ⌈N/128⌉, M, R) partial projections. Launches on ``stream``, allocates
// nothing, returns cudaGetLastError().
extern "C" int slab_nm_lr_matmul(int dtype, const void* x, const void* vals,
                                 const void* idx, const void* u,
                                 const void* v, void* y, void* part,
                                 void* tickets, int M, int N, int K,
                                 int n_keep, int m_pat, int R, int n_split,
                                 int cps, void* stream) {
  if (dtype != 1 || M <= 0 || N <= 0 || K <= 0 || R <= 0 || m_pat <= 0 ||
      K % m_pat || !tc::split_ok(K, n_split, cps, 1, part, tickets))
    return (int)cudaErrorInvalidValue;
  if (!slab::aligned16(vals) || !slab::aligned16(idx))
    return (int)cudaErrorMisalignedAddress;
  tc::TcArgs a{(const tc::bf16*)x, (const tc::bf16*)vals,
               (const int8_t*)idx, nullptr, (const tc::bf16*)u,
               (const tc::bf16*)v, (tc::bf16*)y, (float*)part, (int*)tickets,
               M, N, K, R, cps, 0, 1};
  if (n_keep == 2 && m_pat == 4)
    return tc::launch_tc<tc::NmSrc<2, 4>, true, false, tc::Entry::kNm>(
        a, 1, n_split, stream);
  if (n_keep == 4 && m_pat == 8)
    return tc::launch_tc<tc::NmSrc<4, 8>, true, false, tc::Entry::kNm>(
        a, 1, n_split, stream);
  return (int)cudaErrorInvalidValue;
}

// #2 for every expert of a bucket (#17): dtype must be 1 (bfloat16) and
// the pattern 2:4 or 4:8, other launches go to slab_matmul.cu's kernel.
// x (E, M, K), vals / idx (E, N, K/m, n), bp (E, N, K/32), u (E, R, N),
// v (E, R, K), y (E, M, N); K split into n_split runs of cps chunks, and
// with n_split > 1 part (n_split, E, M, N) fp32 scratch and tickets
// (E·⌈N/128⌉ ints, zero; zero again after the launch). Launches on
// ``stream``, allocates nothing, returns cudaGetLastError().
extern "C" int slab_nm_matmul_g(int dtype, const void* x, const void* vals,
                                const void* idx, const void* bp,
                                const void* u, const void* v, void* y,
                                void* part, void* tickets, int E, int M,
                                int N, int K, int n_keep, int m_pat, int R,
                                int n_split, int cps, void* stream) {
  if (dtype != 1 || E <= 0 || E > slab::kMaxExperts || M <= 0 || N <= 0 ||
      K <= 0 || K % 32 || R <= 0 ||
      !tc::split_ok(K, n_split, cps, 1, part, tickets))
    return (int)cudaErrorInvalidValue;
  if (!slab::aligned16(vals) || !slab::aligned16(idx) ||
      !slab::aligned16(bp))
    return (int)cudaErrorMisalignedAddress;
  tc::TcArgs a{(const tc::bf16*)x, (const tc::bf16*)vals,
               (const int8_t*)idx, (const uint32_t*)bp, (const tc::bf16*)u,
               (const tc::bf16*)v, (tc::bf16*)y, (float*)part, (int*)tickets,
               M, N, K, R, cps, 0, 1};
  if (n_keep == 2 && m_pat == 4)
    return tc::launch_tc<tc::NmSrc<2, 4>, false, true, tc::Entry::kG>(
        a, E, n_split, stream);
  if (n_keep == 4 && m_pat == 8)
    return tc::launch_tc<tc::NmSrc<4, 8>, false, true, tc::Entry::kG>(
        a, E, n_split, stream);
  return (int)cudaErrorInvalidValue;
}

// #15, #8 for every expert of a bucket: dtype must be 1 (bfloat16) and the
// pattern 2:4 or 4:8, other launches go to nm_sparse.cu's kernel. x (E, M,
// K), vals / idx (E, N, K/m, n), y (E, M, N), any K the pattern divides;
// K split into n_split runs of cps chunks, and with n_split > 1 part
// (n_split, E, M, N) fp32 scratch and tickets (E·⌈N/128⌉ ints, zero; zero
// again after the launch). Launches on ``stream``, allocates nothing,
// returns cudaGetLastError().
//
// Bound on the H100: bytes (E experts' N:M planes, 0.75 of the dense bf16
// bytes at 2:4). The first design (nm_sparse.cu's nm_kernel, one warp a
// row, 16 rows a block) staged each expert's x column-major with 2-byte
// stores in every block, asked L2 for each row ahead and did a CUDA-core
// FMA per kept entry and batch row: 52 % of the bound at phi3.5-moe's
// (6400, 4096). Here it is #17's body without the ±1 term: the planes
// decoded in registers a chunk ahead, the tensor cores, and K split only
// as far as a split's x tile needs (plan_nm_splits with every expert's
// row tiles).
extern "C" int nm_matmul_g(int dtype, const void* x, const void* vals,
                           const void* idx, void* y, void* part,
                           void* tickets, int E, int M, int N, int K,
                           int n_keep, int m_pat, int n_split, int cps,
                           void* stream) {
  if (dtype != 1 || E <= 0 || E > slab::kMaxExperts || M <= 0 || N <= 0 ||
      K <= 0 || m_pat <= 0 || K % m_pat ||
      !tc::split_ok(K, n_split, cps, 1, part, tickets))
    return (int)cudaErrorInvalidValue;
  if (!slab::aligned16(vals) || !slab::aligned16(idx))
    return (int)cudaErrorMisalignedAddress;
  tc::TcArgs a{(const tc::bf16*)x, (const tc::bf16*)vals,
               (const int8_t*)idx, nullptr, nullptr, nullptr, (tc::bf16*)y,
               (float*)part, (int*)tickets, M, N, K, 0, cps, 0, 1};
  if (n_keep == 2 && m_pat == 4)
    return tc::launch_tc<tc::NmSrc<2, 4>, false, false, tc::Entry::kG>(
        a, E, n_split, stream);
  if (n_keep == 4 && m_pat == 8)
    return tc::launch_tc<tc::NmSrc<4, 8>, false, false, tc::Entry::kG>(
        a, E, n_split, stream);
  return (int)cudaErrorInvalidValue;
}

// #20: dtype must be 1 (bfloat16) and R at most kMaxR (an accumulator a
// rank), other launches go to slab_matmul.cu's kernel. x (E, M, K), bp
// (E, N, K/32), u (E, R, N), v (E, R, K), y (E, M, N); the split and its
// scratch as slab_nm_matmul_g's, a block walking tpb row tiles of its
// expert (tickets: E·⌈⌈N/128⌉ / tpb⌉). Launches on ``stream``, allocates
// nothing, returns cudaGetLastError().
extern "C" int binlr_matmul_g(int dtype, const void* x, const void* bp,
                              const void* u, const void* v, void* y,
                              void* part, void* tickets, int E, int M, int N,
                              int K, int R, int n_split, int cps, int tpb,
                              void* stream) {
  if (dtype != 1 || E <= 0 || E > slab::kMaxExperts || M <= 0 || N <= 0 ||
      K <= 0 || K % 32 || R <= 0 || R > tc::kMaxR ||
      !tc::split_ok(K, n_split, cps, tpb, part, tickets))
    return (int)cudaErrorInvalidValue;
  if (!slab::aligned16(bp)) return (int)cudaErrorMisalignedAddress;
  tc::TcArgs a{(const tc::bf16*)x, nullptr, nullptr, (const uint32_t*)bp,
               (const tc::bf16*)u, (const tc::bf16*)v, (tc::bf16*)y,
               (float*)part, (int*)tickets, M, N, K, R, cps, 0, tpb};
  return tc::launch_tc<tc::NoSrc, false, true, tc::Entry::kG>(a, E, n_split,
                                                              stream);
}

// #9 (#20 at one linear): dtype must be 1 (bfloat16) and R at most kMaxR,
// other launches go to slab_matmul.cu's kernel. x (M, K), bp (N, K/32), u
// (R, N), v (R, K), y (M, N); the split and its scratch as
// slab_nm_matmul's, a block walking tpb row tiles (tickets:
// ⌈⌈N/128⌉ / tpb⌉). Launches on ``stream``, allocates nothing, returns
// cudaGetLastError().
//
// Bound on the H100: bytes, K/8 of sign words a row (1/16 of the dense bf16
// bytes), far below what a call's fixed cost allows at llama2-7b's shapes.
// The first design (slab_matmul.cu's binlr_kernel, one warp a row, 16 rows
// a block) staged x ⊙ v_r over all of K in every block and walked each
// row's sign words serially with a CUDA-core FMA a bit: 4 % of the bound at
// (4096, 4096). Here it runs as tc_bin_kernel (#2's and #3's entry), so a
// profile tells it from #20's tc_g_kernel<tc::NoSrc, ...>.
extern "C" int binlr_matmul(int dtype, const void* x, const void* bp,
                            const void* u, const void* v, void* y,
                            void* part, void* tickets, int M, int N, int K,
                            int R, int n_split, int cps, int tpb,
                            void* stream) {
  if (dtype != 1 || M <= 0 || N <= 0 || K <= 0 || K % 32 || R <= 0 ||
      R > tc::kMaxR || !tc::split_ok(K, n_split, cps, tpb, part, tickets))
    return (int)cudaErrorInvalidValue;
  if (!slab::aligned16(bp)) return (int)cudaErrorMisalignedAddress;
  tc::TcArgs a{(const tc::bf16*)x, nullptr, nullptr, (const uint32_t*)bp,
               (const tc::bf16*)u, (const tc::bf16*)v, (tc::bf16*)y,
               (float*)part, (int*)tickets, M, N, K, R, cps, 0, tpb};
  return tc::launch_tc<tc::NoSrc, false, true, tc::Entry::kBin>(a, 1, n_split,
                                                                stream);
}

// #6 (#18 at one linear, K split): dtype must be 1 (bfloat16) and K a
// multiple of 8 (the tensor map's row stride is a multiple of 16 bytes):
// other launches go to slab_matmul.cu's kernel. x (M, K), ws (N, K), u (R,
// N), v (R, K), y (M, N); K split into n_split runs of cps 128-column
// chunks (kernels/slab_matmul.py::plan_dense_splits, runs no wider than
// dense_split_cap's low-rank form), and with n_split > 1 part holding the
// (n_split, M, N) partial sums and after them the (n_split, ⌈N/128⌉, M, R)
// partial projections, and tickets (⌈N/128⌉ ints, zero; zero again after
// the launch).
//
// Bound on the H100: bytes (the dense W_S at 2 bytes a weight, 2·M FLOP
// each). The first design (slab_matmul.cu's slab_lr_kernel, one warp a
// row, 16 rows a block) formed the projection x · Vᵀ over all of K in
// every one of its blocks, streamed W_S through CUDA-core FMAs and asked
// L2 for each row ahead; it ran at 31 % of the bound at (4096, 4096).
// Here it is #18's body (DenseSrc's tensor-map ring, tensor cores) at E =
// 1 with K split across the card as #3's is, the projection formed once
// a block over its split's columns and carried through the split as #7's
// is.
extern "C" int slab_lr_matmul(int dtype, const void* x, const void* ws,
                              const void* u, const void* v, void* y,
                              void* part, void* tickets, int M, int N,
                              int K, int R, int n_split, int cps,
                              void* stream) {
  if (dtype != 1 || M <= 0 || N <= 0 || K <= 0 || K % 8 || R <= 0 ||
      !tc::split_ok(K, n_split, cps, 1, part, tickets))
    return (int)cudaErrorInvalidValue;
  if (!slab::aligned16(ws)) return (int)cudaErrorMisalignedAddress;
  tc::TcArgs a{(const tc::bf16*)x, (const tc::bf16*)ws, nullptr, nullptr,
               (const tc::bf16*)u, (const tc::bf16*)v, (tc::bf16*)y,
               (float*)part, (int*)tickets, M, N, K, R, cps, 0, 1};
  return tc::launch_tc<tc::DenseSrc, true, false, tc::Entry::kNm>(
      a, 1, n_split, stream);
}

namespace tc {

// #3 and #16: DenseSrc's ring of dense W_S rows plus the ±1 term, K split
// as #2's and #17's; #3 runs as tc_bin_kernel (#2's entry), #16 as
// tc_g_kernel (#17's), so that a profile tells them apart by entry and
// source.
template <Entry kEntry>
inline int launch_slab_dense(const void* x, const void* ws, const void* bp,
                             const void* u, const void* v, void* y,
                             void* part, void* tickets, int E, int M, int N,
                             int K, int R, int n_split, int cps,
                             void* stream) {
  if (E <= 0 || E > slab::kMaxExperts || M <= 0 || N <= 0 || K <= 0 ||
      K % 32 || R <= 0 || !split_ok(K, n_split, cps, 1, part, tickets))
    return (int)cudaErrorInvalidValue;
  if (!slab::aligned16(ws) || !slab::aligned16(bp))
    return (int)cudaErrorMisalignedAddress;
  TcArgs a{(const bf16*)x, (const bf16*)ws, nullptr, (const uint32_t*)bp,
           (const bf16*)u, (const bf16*)v, (bf16*)y, (float*)part,
           (int*)tickets, M, N, K, R, cps, 0, 1};
  return launch_tc<DenseSrc, false, true, kEntry>(a, E, n_split, stream);
}

}  // namespace tc

// #3: dtype must be 1 (bfloat16) and K a multiple of 32 (sign words; the
// dense rows then start on 16-byte boundaries for the bulk copies): other
// launches go to slab_matmul.cu's kernel. x (M, K), ws (N, K), bp (N,
// K/32), u (R, N), v (R, K), y (M, N); K split into n_split runs of cps
// chunks (kernels/slab_matmul.py::dense_split_cap keeps a run's tiles and
// a 2-stage ring within two blocks an SM), with n_split > 1 part
// (n_split, M, N) fp32 scratch and tickets (⌈N/128⌉ ints, zero; zero
// again after the launch). Launches on ``stream``, allocates nothing,
// returns cudaGetLastError().
extern "C" int slab_matmul(int dtype, const void* x, const void* ws,
                           const void* bp, const void* u, const void* v,
                           void* y, void* part, void* tickets, int M, int N,
                           int K, int R, int n_split, int cps,
                           void* stream) {
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  return tc::launch_slab_dense<tc::Entry::kBin>(
      x, ws, bp, u, v, y, part, tickets, 1, M, N, K, R, n_split, cps, stream);
}

// #16, #3 for every expert of a bucket: as slab_matmul with x (E, M, K),
// ws (E, N, K), bp (E, N, K/32), u (E, R, N), v (E, R, K), y (E, M, N),
// part (n_split, E, M, N) and tickets E·⌈N/128⌉.
extern "C" int slab_matmul_g(int dtype, const void* x, const void* ws,
                             const void* bp, const void* u, const void* v,
                             void* y, void* part, void* tickets, int E,
                             int M, int N, int K, int R, int n_split,
                             int cps, void* stream) {
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  return tc::launch_slab_dense<tc::Entry::kG>(
      x, ws, bp, u, v, y, part, tickets, E, M, N, K, R, n_split, cps, stream);
}

namespace tc {

// ---------------------------------------------------------------- #12, #13
//
// Bound on the H100: bytes. At deepseek-moe-16b's decode shapes (6 rows
// per expert, E 64, (1408, 2048) and (2048, 1408)) the planes (bf16 vals
// + 16-bit ids, K_max ≈ 0.4·K for sparse-ell at CR 0.6, ≈ K/2 for
// lowrank-ell) are 295 MB and 369 MB: 0.089 and 0.111 ms at 3.35 TB/s,
// against 2·M FLOP per stored entry. The first design (ell.cu's
// ell_kernel, one warp per output row, 16 rows a block) staged x
// column-major with scalar 2-byte stores, a 32-way bank conflict at 8
// batch rows, in every block of 16 rows (88 times per expert), and
// formed #13's projection as often; it ran at 15-16 % of the bound.
// This design, and what each part is for:
//  - a block owns kEllRows = 128 output rows of one expert (grid
//    (⌈N/128⌉, E)) and stages x once per 8·NTP batch rows with 16-byte
//    stores into NTP column planes (stage_cols_any: any K, a zero tail
//    and one zero column past K), so a gather is one 16-byte shared load
//    for 8 batch rows (at M <= 4, columns of M rounded up to 1, 2 or 4:
//    stage_cols_narrow); #13's projection is formed once per block pass
//    in fp32 with a fixed reduction order and added before the one
//    rounding;
//  - a group of kEllLanes = 8 lanes streams one row at a time, each lane
//    an 8-entry block (16 bytes of vals, 16 or 32 of ids) per step, so a
//    group reads 128 contiguous bytes of each plane a step; a row's
//    partial blocks (it starts anywhere when K_max is odd) have their
//    values outside the row zeroed, and ids are clamped to the zero
//    column K, so every block runs one branch-free gather; the group
//    reduces its row with a reduce-scatter over shuffles and each lane
//    stores one batch row;
//  - the blocks arrive through a per-thread cp.async ring of kEllStages
//    steps (each thread reads back only what it copied: no barrier),
//    bypassing L1.
// Alternatives built and timed on an H100 while this kernel was designed
// (PERF.md §6 gives their direction; the builds are not kept): with the
// gather taken out, the plane stream alone took most of the kernel's
// time, and gathers made free of bank conflicts saved little. A 4-lane
// group over two rows at once (#14's gather mapping) streamed the planes
// slower still; x as fp32 (no unpacking, twice the shared bytes) lost by
// a wide margin; rings of 2 or 8 steps, blocks loaded into registers
// instead of the ring and 16- or 32-lane groups did not help; 16 warps a
// block gained a few percent and were not taken. The kernel is
// ell_split_kernel (below, with #1 and #5), each row one run of entries.
constexpr int kEllWarps = 8;      // warps per block, 16 output rows each
constexpr int kEllStages = 4;     // steps (8-entry blocks) in flight per thread
constexpr int kEllLanes = 8;      // lanes that stream one row together
constexpr int kEllThreads = kEllWarps * 32;
constexpr int kEllRows = kEllWarps * 16;
constexpr int kEllRowsPerGroup = 16 * kEllLanes / 32;   // rows in turn

// The columns of #12 / #13's x planes: K (any width: there are no sign
// words) plus at least one zero column, rounded up to 8. An id at or past
// K reads zero column K (ids are clamped), so it adds nothing.
__host__ __device__ inline int ell_kp(int K) { return (K + 8) / 8 * 8; }

// stage_cols for any K: batch rows m0 .. m0 + 8·ntp - 1 of x (zero rows
// past M) as ntp planes of kp 16-byte columns, zero from K on. A row of
// x starts on a 16-byte boundary only when K % 8 == 0; otherwise each
// 8-column block is read element by element.
__device__ __forceinline__ void stage_cols_any(uint4* xs,
                                               const bf16* __restrict__ x,
                                               int m0, int M, int K, int kp,
                                               int ntp) {
  const int nkb = kp / 8;
  const bool vec = aligned16(x) && K % 8 == 0;
  for (int i = threadIdx.x; i < ntp * nkb; i += blockDim.x) {
    const int t = i / nkb, kb = i - t * nkb;
    uint32_t w[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int m = m0 + 8 * t + r;
      const bf16* p = x + (size_t)m * K + kb * 8;
      if (m < M && vec && kb * 8 < K) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
        w[r][0] = q.x; w[r][1] = q.y; w[r][2] = q.z; w[r][3] = q.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = kb * 8 + 2 * j;
          const uint32_t lo = m < M && c < K ? bits16(p[2 * j]) : 0u;
          const uint32_t hi = m < M && c + 1 < K ? bits16(p[2 * j + 1]) : 0u;
          w[r][j] = lo | (hi << 16);
        }
      }
    }
    uint4* plane = xs + (size_t)t * kp;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t sel = (j & 1) ? 0x7632u : 0x5410u;
      uint4 o;
      o.x = __byte_perm(w[0][j >> 1], w[1][j >> 1], sel);
      o.y = __byte_perm(w[2][j >> 1], w[3][j >> 1], sel);
      o.z = __byte_perm(w[4][j >> 1], w[5][j >> 1], sel);
      o.w = __byte_perm(w[6][j >> 1], w[7][j >> 1], sel);
      plane[kb * 8 + j] = o;
    }
  }
}

// The 8 batch rows of column col of an n-tile's plane, as floats.
__device__ __forceinline__ void ell_col(float (&v)[8], const uint4* plane,
                                        uint32_t col) {
  const uint4 q = plane[col];
  v[0] = lo_f(q.x); v[1] = hi_f(q.x); v[2] = lo_f(q.y); v[3] = hi_f(q.y);
  v[4] = lo_f(q.z); v[5] = hi_f(q.z); v[6] = lo_f(q.w); v[7] = hi_f(q.w);
}

// One 8-entry block of a row: values and ids.
template <typename I>
struct EllBlock {
  uint4 v;
  Ids8<I> i;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
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


// 16-byte units of one 8-entry block: vals, then 1 (uint16) or 2 (uint32)
// of ids. A thread's ring slot holds unit u at slot[u · threads].
template <typename I>
__host__ __device__ constexpr int ell_units() {
  return sizeof(I) == 2 ? 2 : 3;
}

// 16-byte units of a block's ring: kEllStages steps per thread.
template <typename I>
__host__ __device__ constexpr int ell_ring_units() {
  return kEllStages * ell_units<I>() * kEllThreads;
}

// Copy the block from entry e0 into a ring slot, asynchronously (it
// bypasses L1: the planes are read once).
template <typename I>
__device__ __forceinline__ void ell_copy(uint4* slot,
                                         const bf16* __restrict__ vals,
                                         const I* __restrict__ idx,
                                         size_t e0) {
  cp_async16(slot, vals + e0);
  cp_async16(slot + kEllThreads, idx + e0);
  if constexpr (sizeof(I) == 4)
    cp_async16(slot + 2 * kEllThreads, idx + e0 + 4);
}

template <typename I>
__device__ __forceinline__ void ell_read(EllBlock<I>& b, const uint4* slot) {
  b.v = slot[0];
  b.i.a = slot[kEllThreads];
  if constexpr (sizeof(I) == 4) b.i.b = slot[2 * kEllThreads];
}

// The block b from entry e0 of a row spanning [lo, hi): values outside
// the span (the neighbouring rows', or all of a block past the row's end,
// which was not loaded) are zeroed, so every block runs the same gather:
// its ids are clamped into range and add w = 0.
template <typename I>
__device__ __forceinline__ void ell_mask(EllBlock<I>& b, size_t e0,
                                         size_t lo, size_t hi) {
  if (e0 >= lo && e0 + 8 <= hi) return;   // a whole block
  int jlo = 8, jhi = 0;
  if (e0 < hi) block_span(e0, lo, hi, jlo, jhi);
  const uint32_t keep = (0xffu >> (8 - jhi)) & (0xffu << jlo);
  auto mask = [keep](int i) {      // word i: entries 2i (low), 2i + 1
    return ((keep >> (2 * i)) & 1u ? 0x0000ffffu : 0u) |
           ((keep >> (2 * i + 1)) & 1u ? 0xffff0000u : 0u);
  };
  b.v.x &= mask(0); b.v.y &= mask(1); b.v.z &= mask(2); b.v.w &= mask(3);
}

// acc[t][m] += w_j · x[8t + m, col_j] for entry j of block b: one load of
// the column per n-tile, 8 FMAs.
template <typename I, int NTP>
__device__ __forceinline__ void ell_entry(float (&acc)[NTP][8],
                                          const uint4* xs, int kp, int K,
                                          const EllBlock<I>& b, int j) {
  const uint32_t col = min(b.i.at(j), (uint32_t)K);
  const uint32_t vw = word_of(b.v, j >> 1);
  const float w = (j & 1) ? hi_f(vw) : lo_f(vw);
#pragma unroll
  for (int t = 0; t < NTP; ++t) {
    float xv[8];
    ell_col(xv, xs + (size_t)t * kp, col);
#pragma unroll
    for (int m = 0; m < 8; ++m) acc[t][m] += w * xv[m];
  }
}

// Sum v[0 .. MR - 1] over the row group's 8 lanes; lane l ends with the
// sum of v[l & (MR - 1)] in v[0] (a reduce-scatter over the lane bits
// below MR, then, for MR < 8, a sum over the others).
template <int MR = 8>
__device__ __forceinline__ void ell_reduce(float (&v)[8], int lane) {
#pragma unroll
  for (int h = MR / 2; h >= 1; h >>= 1) {
    const bool up = lane & h;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = up ? v[i] : v[i + h];
      const float keep = up ? v[i + h] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, h);
    }
  }
#pragma unroll
  for (int h = MR; h < 8; h <<= 1)
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], h);
}

// ------------------------------------------------------------ #1, #5, #4
//
//   slab_ell_matmul:  y = x · (W_S + Σ_r u_r v_rᵀ ⊙ B)ᵀ, W_S in ELL form  (#1)
//   ell_lr_matmul:    y = x · W_Sᵀ + (x · Vᵀ) · U, W_S in ELL form        (#5)
//   ell_matmul:       y = x · W_Sᵀ, W_S in ELL form                       (#4)
//
// Replace repro/kernels/ell.py::slab_ell_matmul (_kernel_slab_ell,
// pallas_call at ell.py:209), ::ell_lr_matmul (_kernel_ell_lr,
// pallas_call at ell.py:149) and ::ell_matmul (_kernel_ell, pallas_call at
// ell.py:105) for bf16 operands; f32 launches, fewer rows than
// ell.SLAB_ELL_TC_MIN_ROWS / ELL_LR_TC_MIN_ROWS / ELL_TC_MIN_ROWS and
// shapes whose staged x does not fit a block (ell.ell_split_smem) keep
// the first design (ell.cu).
//
// Bound on the H100: bytes. The planes (bf16 vals + 16-bit ids, K_max ≈
// 0.437·K for slab-ell at CR 0.5, ≈ K/2 for lowrank-ell and ≈ 0.4·K for
// sparse-ell at CR 0.6, plus #1's K/8 bytes of sign words a row) are
// 0.94x, 1.0x and 0.8x the dense bf16 matrix, against 2·M FLOP a stored
// entry at M 1-8. The first design (one warp a row, 16 rows a block)
// staged x in every block with scalar stores and ran at 16-24 % of the
// bound. This is #12 / #13's gather (the same
// kernel, ell_split_kernel) at E = 1, where its blocks of 128 rows are
// too few for the card ((4096, 4096): 32 for 132 SMs). So each row's
// entries are split across blocks. The reference reads a row's entries in
// any order (_gather_accum), and a block cannot know which of them fall
// in a column range without searching the row: block (tile, z) takes the
// run of entries [z·epb, (z + 1)·epb) of each of its rows, counted from
// the 8-entry boundary at or below the row's first entry (epb a multiple
// of one group step, kEllStep; kernels/slab_matmul.py::plan_ell_splits,
// from shapes only), so only a row's first and last 8-entry blocks are
// partial and no run pays a step for its own edges; since the entries may
// name any column, it stages all of x: at M <= 4 as columns of 1, 2 or 4
// batch rows (2, 4 or 8 bytes, stage_cols_narrow: the gather's shared
// load and FMAs shrink with M), else as 8-row column planes
// (stage_cols_any; 64 KB at K 4096 and 8 batch rows, 172 KB at K 11008).
// #1's ±1 term is split by columns as tc_body splits it: split z owns the
// sign-word columns [z·cps·128, (z + 1)·cps·128), stages bf16(x ⊙ v_r)
// over those columns only (stage_rows) and runs the term on the tensor
// cores as #2 does (bin_chunk: A = ±u_r from the sign words, asked for
// four chunks at a time; B the staged tile) before the gather. The two
// terms map rows to lanes differently (a gather group owns a whole row,
// an mma row group rows g and g + 8), so each warp passes its ±1 sums
// through shared memory and the gather adds them before a row's store:
// W_S and the ±1 term make one fp32 partial. Each block stores fp32
// partial sums (splits, M, N); the last block of a row tile (an atomic
// ticket) adds them in split order, so two launches give the same bits,
// and rounds once. #5 projects x onto V in every block over its share of
// K (from the staged x) and stores that partial projection; the
// last block sums them in split order and adds Σ_r p[m, r]·u_r[n] before
// the rounding (the reference's acc + p·u). #4 is the split gather with
// neither term: its partial sums alone. A launch of one split (#12, #13,
// and #1 / #4 / #5 at K_max + 7 <= 64 or N past ~16,900) stores y itself.
// #5's and #4's ring has bytes of its own and is asked for as soon as x
// is staged, so #5's first steps arrive while the block projects; #1's ring takes
// the bytes of the x ⊙ v_r tiles and is asked for after the ±1 term. No
// L2 prefetch (it slowed these kernels' grouped forms). Each choice was
// timed on an H100 against the alternative it replaced (runs counted
// from each row's first entry, #5's projection over all of K in the last
// block or in every block, 8-row columns at every M, #1's ring with bytes
// of its own asked for before x is staged, #5's ring sharing the
// projection's bytes): PERF.md §6.
constexpr int kEllStep = 8 * kEllLanes;   // entries of one group step

// The operands of one ell_split_kernel launch (E experts: grid y).
struct EllArgs {
  const bf16* x;          // (E, M, K)
  const bf16* vals;       // (E, N, K_max)
  const void* idx;        // (E, N, K_max) uint16 or uint32 ids
  const uint32_t* bp;     // #1: sign words (E, N, K/32)
  const bf16* u;          // #1, #5, #13: (E, R, N)
  const bf16* v;          // #1, #5, #13: (E, R, K)
  bf16* y;                // (E, M, N)
  float* part;            // split (E = 1): (splits, M, N) partial sums,
                          // then #5's (splits, row tiles, M, R) partial
                          // projections
  int* tickets;           // split: one per row tile, zero between launches
  int M, N, K, kmax, R;   // R 0 for #12
  int epb;                // entries of each row a split takes
  int cps;                // #1: 128-column chunks of the ±1 term a split takes
};

// Shared bytes of a launch at ntp n-tiles of mr batch rows a column (mr
// < 8: one tile of x at 2·mr bytes a column): x's columns; then for LR
// (#5, #13) the projection (R, 8·ntp), the gather's ring and the warps'
// projection sums (kEllWarps, R, 8·ntp); for BIN (#1) the ±1 sums of each
// warp's rows (kEllWarps·16, 8·ntp), then one region that holds the x ⊙
// v_r tiles (split columns rounded up to 128, plus 8) with u of the
// block's rows, and after the ±1 term the ring; for #12 the ring.
template <typename I, bool LR, bool BIN>
inline size_t ell_split_smem(int ntp, int mr, int K, int R, int cps) {
  const size_t mt = 8 * ntp;
  const size_t ring = (size_t)ell_ring_units<I>() * 16;
  const size_t cols = mr < 8 ? slab::align16_up((size_t)ell_kp(K) * 2 * mr)
                             : (size_t)ntp * ell_kp(K) * 16;
  if (BIN) {
    const size_t sx = (size_t)min((K + 127) / 128, cps) * 128 + 8;
    return cols + (size_t)kEllWarps * 16 * mt * 4 +
           slab::align16_up(max(ring, (size_t)R * mt * sx * 2 +
                                          (size_t)R * kEllRows * 2));
  }
  return cols + ring +
         (LR ? slab::align16_up((size_t)R * mt * 4) +
                   (size_t)kEllWarps * R * mt * 4
             : 0);
}

// stage_cols_any for MR < 8 batch rows (M <= MR): x's rows m0 .. m0 + MR
// - 1 (zero past M) interleaved, one column of MR bf16 after another (2·MR
// bytes), kp columns, zero from K on. A thread takes 8 columns: MR
// 16-byte loads, byte permutes, MR 16-byte stores.
template <int MR>
__device__ __forceinline__ void stage_cols_narrow(uint4* xs,
                                                  const bf16* __restrict__ x,
                                                  int m0, int M, int K,
                                                  int kp) {
  const int nkb = kp / 8;
  const bool vec = aligned16(x) && K % 8 == 0;
  for (int kb = threadIdx.x; kb < nkb; kb += blockDim.x) {
    uint32_t w[MR][4];
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      const int m = m0 + r;
      const bf16* p = x + (size_t)m * K + kb * 8;
      if (m < M && vec && kb * 8 < K) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
        w[r][0] = q.x; w[r][1] = q.y; w[r][2] = q.z; w[r][3] = q.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = kb * 8 + 2 * j;
          const uint32_t lo = m < M && c < K ? bits16(p[2 * j]) : 0u;
          const uint32_t hi = m < M && c + 1 < K ? bits16(p[2 * j + 1]) : 0u;
          w[r][j] = lo | (hi << 16);
        }
      }
    }
    uint4* out = xs + (size_t)kb * MR;
    if constexpr (MR == 1) {
      out[0] = make_uint4(w[0][0], w[0][1], w[0][2], w[0][3]);
    } else if constexpr (MR == 2) {
#pragma unroll
      for (int u = 0; u < 2; ++u)        // columns 4u .. 4u + 3
        out[u] = make_uint4(__byte_perm(w[0][2 * u], w[1][2 * u], 0x5410),
                            __byte_perm(w[0][2 * u], w[1][2 * u], 0x7632),
                            __byte_perm(w[0][2 * u + 1], w[1][2 * u + 1], 0x5410),
                            __byte_perm(w[0][2 * u + 1], w[1][2 * u + 1], 0x7632));
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)        // columns 2u, 2u + 1
        out[u] = make_uint4(__byte_perm(w[0][u], w[1][u], 0x5410),
                            __byte_perm(w[2][u], w[3][u], 0x5410),
                            __byte_perm(w[0][u], w[1][u], 0x7632),
                            __byte_perm(w[2][u], w[3][u], 0x7632));
    }
  }
}

// ell_entry for MR < 8 batch rows from stage_cols_narrow's columns: one
// 2·MR-byte shared load and MR FMAs an entry.
template <typename I, int MR>
__device__ __forceinline__ void ell_entry_narrow(float (&acc)[8],
                                                 const uint4* xs, int K,
                                                 const EllBlock<I>& b,
                                                 int j) {
  const uint32_t col = min(b.i.at(j), (uint32_t)K);
  const uint32_t vw = word_of(b.v, j >> 1);
  const float w = (j & 1) ? hi_f(vw) : lo_f(vw);
  if constexpr (MR == 1) {
    acc[0] += w * lo_f(reinterpret_cast<const uint16_t*>(xs)[col]);
  } else if constexpr (MR == 2) {
    const uint32_t q = reinterpret_cast<const uint32_t*>(xs)[col];
    acc[0] += w * lo_f(q); acc[1] += w * hi_f(q);
  } else {
    const uint2 q = reinterpret_cast<const uint2*>(xs)[col];
    acc[0] += w * lo_f(q.x); acc[1] += w * hi_f(q.x);
    acc[2] += w * lo_f(q.y); acc[3] += w * hi_f(q.y);
  }
}

// p[r, m] = Σ_k x[m, k] · v_r[k] over columns [c0, c1) in fp32 for the
// pass's batch rows, from x's staged columns (zero past M; MR < 8: MR
// rows a column, else NTP planes of 8): every warp takes a strided share
// of the columns, the partial sums (pw: (kEllWarps, R, 8·NTP)) are added
// in warp order. Every thread calls it; it ends on a barrier.
template <int NTP, int MR>
__device__ __forceinline__ void ell_project_x(float* p, float* pw,
                                              const uint4* xs, int kp,
                                              const bf16* __restrict__ v,
                                              int K, int c0, int c1, int R) {
  constexpr int MT = 8 * NTP, MW = MR < 8 ? MR : MT;   // rows, staged rows
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = 0; r < R; ++r) {
    float acc[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[m] = 0.f;
#pragma unroll 2
    for (int k = c0 + threadIdx.x; k < c1; k += kEllThreads) {
      const float vk = __bfloat162float(v[(size_t)r * K + k]);
      if constexpr (MR < 8) {
        const bf16* col = reinterpret_cast<const bf16*>(xs) + (size_t)k * MR;
#pragma unroll
        for (int m = 0; m < MW; ++m) acc[m] += __bfloat162float(col[m]) * vk;
      } else {
#pragma unroll
        for (int t = 0; t < NTP; ++t) {
          float xv[8];
          ell_col(xv, xs + (size_t)t * kp, k);
#pragma unroll
          for (int m = 0; m < 8; ++m) acc[8 * t + m] += xv[m] * vk;
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float s = slab::warp_sum(acc[m]);
      if (lane == 0) pw[((size_t)warp * R + r) * MT + m] = s;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R * MT; i += kEllThreads) {
    float s = 0.f;
    for (int w = 0; w < kEllWarps; ++w) s += pw[(size_t)w * R * MT + i];
    p[i] = s;
  }
  __syncthreads();
}

// #12 (neither term), #13 (LR), #1 (BIN), #5 (LR at E = 1, split) and
// #4 (neither term at E = 1, split):
// y[e] = x[e] · W_S[e]ᵀ (+ the term). Grid (⌈N/128⌉, E, splits): a block
// owns kEllRows output rows of one expert, a warp 16 of them; a group of
// kEllLanes lanes streams kEllRowsPerGroup of those rows one after the
// other, lane k of the group taking the 8-entry blocks at 8k, 8k +
// kEllStep, ... of the split's run of the row, so a group's load is one
// contiguous 16·kEllLanes-byte run of each plane. MR < 8 (M <= MR, one
// n-tile) stages and gathers MR batch rows a column (2·MR bytes) in place
// of 8. NTP and MR last, so that a profile's name part
// "ell_split_kernel<unsigned short, false, true" finds #1 at any tile
// (#12 is <..., false, false, ...>, and #4 the same with SPLIT; #13 and
// #5 differ by SPLIT, and every #4 and #5 launch on the main path
// splits). A
// block's phases, each in flight while the one before it runs: it asks
// for #1's first sign words, stages x (#1 also x ⊙ v_r and u), asks for
// the gather's first ring steps where the ring has bytes of its own (not
// #1), projects its share of K (LR), runs the ±1 term (#1) and asks for
// #1's ring, then gathers. SPLIT (more than one split) compiles the
// partial sums and the tail; without it a block stores y (#12 / #13 then
// use 88-104 registers at one n-tile, two blocks an SM; with the split
// code they used 156, one block, and ran 15 % slower). Registers are
// capped for two blocks an SM at one n-tile with the ±1 term or at M <=
// 4; #5 at 5-8 rows is not capped (it spilled 20 bytes capped).
template <typename I, bool LR, bool BIN, int NTP, int MR, bool SPLIT>
__global__ void __launch_bounds__(kEllThreads,
                                  NTP == 1 && (BIN || MR < 8) ? 2 : 1)
    ell_split_kernel(const EllArgs a) {
  constexpr int MT = 8 * NTP;                 // batch rows per pass
  constexpr int D = kEllStages, U = ell_units<I>();
  constexpr int L = kEllLanes, RG = kEllRowsPerGroup;
  static_assert(MR == 8 || NTP == 1, "narrow columns take one n-tile");
  static_assert(!(LR && BIN), "one second term at most");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int M = a.M, N = a.N, K = a.K, kmax = a.kmax, R = a.R;
  const int kp = ell_kp(K), n_split = SPLIT ? gridDim.z : 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t ex = blockIdx.y;               // the expert
  const size_t row_e = ex * N;                // its first row in the planes
  const bf16* __restrict__ x = a.x + ex * M * K;
  const bf16* __restrict__ vals = a.vals;
  const I* __restrict__ idx = static_cast<const I*>(a.idx);
  const bf16* __restrict__ u = a.u + ex * R * N;
  const bf16* __restrict__ v = a.v + ex * R * K;
  bf16* __restrict__ y = a.y + ex * M * N;
  const int n0 = blockIdx.x * kEllRows;       // the block's first row
  const int z = SPLIT ? blockIdx.z : 0;
  // this split's run of a row: its entries from z·epb past the 8-entry
  // boundary at or below the row's first entry, epb of them
  const size_t z_lo = (size_t)z * a.epb;
  // #1: this split's columns of the ±1 term, [k_lo, k_hi)
  const int k_lo = BIN ? min(K, z * a.cps * 128) : 0;
  const int k_hi = BIN ? min(K, k_lo + a.cps * 128) : 0;
  const int kw = k_hi - k_lo, sx = (kw + 127) / 128 * 128 + 8;
  // #5: this split's share of K for its partial projection, [p_lo, p_hi)
  const int p_cols = (K + n_split - 1) / n_split;
  const int p_lo = min(K, z * p_cols), p_hi = min(K, p_lo + p_cols);
  const size_t cols = MR < 8 ? slab::align16_up((size_t)kp * 2 * MR)
                             : (size_t)NTP * kp * 16;
  uint4* xs = reinterpret_cast<uint4*>(smem_raw);               // x's columns
  float* p = reinterpret_cast<float*>(smem_raw + cols);         // LR: (R, MT)
  float* gs = p + (LR ? slab::align16_up((size_t)R * MT * 4) / 4 : 0);
  uint4* ring = reinterpret_cast<uint4*>(
      gs + (BIN ? kEllWarps * 16 * MT : 0));  // BIN: gs (kEllWarps·16, MT)
  bf16* xv = reinterpret_cast<bf16*>(ring);           // BIN: R tiles (MT, sx)
  bf16* us = xv + (size_t)R * MT * sx;                // BIN: (R, kEllRows)
  float* pw = reinterpret_cast<float*>(ring + ell_ring_units<I>());
                                                      // LR: (kEllWarps, R, MT)
  // LR split: this block's slot of the partial projections
  const int tiles = gridDim.x;
  float* proj = a.part + (size_t)n_split * M * N;
  auto proj_at = [&](int zz, int m, int r) {
    return proj + (((size_t)zz * tiles + blockIdx.x) * M + m) * R + r;
  };

  // the gather over the split's run: group lane / L streams rows r0 ..
  // r0 + RG - 1 of the block, nc steps a row (rows past N read the last
  // row and store nothing; a run past a row's end reads nothing and
  // gathers zeros)
  const int k8 = 8 * (lane % L);
  const int r0 = warp * 16 + (lane / L) * RG;
  const bool live = n0 + warp * 16 < N;
  const int nc = a.epb / kEllStep;
  auto start = [&](int i) {           // the row's first entry
    return (row_e + min(n0 + r0 + i, N - 1)) * (size_t)kmax;
  };
  auto slot = [&](int s) {
    return ring + (size_t)(s % D) * U * kEllThreads + threadIdx.x;
  };
  // the group's steps in order: row fi, step fc of the run. next(e0): the
  // next step's first entry, false past the row's end or the group's rows
  int fi, fc, f;                      // f: the step copy_next copies
  auto next = [&](size_t& e0) {
    if (fi >= RG) return false;
    const size_t lo = start(fi);
    e0 = (lo & ~size_t(7)) + z_lo + (size_t)fc * kEllStep + k8;
    if (++fc == nc) {
      fc = 0;
      ++fi;
    }
    return e0 < lo + kmax;
  };
  auto copy_next = [&]() {
    size_t e0;
    if (next(e0)) ell_copy<I>(slot(f), vals, idx, e0);
    ++f;
    cp_async_commit();
  };
  // a ring of D steps per thread: step f's block arrives by cp.async
  // while the D - 1 steps before it are gathered; a thread reads back
  // only what it copied, so no barrier is needed
  auto ring_begin = [&]() {
    f = fi = fc = 0;
#pragma unroll
    for (int d = 0; d < D - 1; ++d) copy_next();
  };
  // #1: the lane's rows g and g + 8 of the warp (ja, jb in the block) and
  // their sign words of four chunks at a time, asked for a batch ahead
  const int g = lane >> 2, q = lane & 3;
  const int ja = min(n0 + warp * 16 + g, N - 1) - n0;
  const int jb = min(n0 + warp * 16 + g + 8, N - 1) - n0;
  const uint32_t* pa = a.bp + (row_e + n0 + ja) * (K / 32) + q;
  const uint32_t* pb = a.bp + (row_e + n0 + jb) * (K / 32) + q;
  uint32_t wa[4], wb[4];
  auto fetch4 = [&](int kc0) {        // zero past the split and past K
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kc = kc0 + 128 * j;
      const bool in = kc < k_hi && kc + 32 * q < K;
      wa[j] = in ? __ldg(pa + kc / 32) : 0u;
      wb[j] = in ? __ldg(pb + kc / 32) : 0u;
    }
  };

  for (int m0 = 0; m0 < M; m0 += MT) {
    __syncthreads();                 // the previous pass's readers are done
    if (BIN && live) fetch4(k_lo);
    if constexpr (MR < 8)
      stage_cols_narrow<MR>(xs, x, m0, M, K, kp);
    else
      stage_cols_any(xs, x, m0, M, K, kp, NTP);
    if constexpr (BIN) {
      stage_rows(nullptr, x + k_lo, K, m0, M, kw, sx - 8, sx, NTP, xv,
                 v + k_lo, R);
      for (int i = threadIdx.x; i < R * kEllRows; i += kEllThreads) {
        const int r = i / kEllRows, j = i - r * kEllRows;
        us[i] = u[(size_t)r * N + min(n0 + j, N - 1)];
      }
    }
    if (!BIN && live) ring_begin();
    __syncthreads();
    if (LR && !SPLIT) {              // all of K, added at the stores
      ell_project_x<NTP, MR>(p, pw, xs, kp, v, K, 0, K, R);
    } else if (LR) {               // its share of K, for the last block
      ell_project_x<NTP, MR>(p, pw, xs, kp, v, K, p_lo, p_hi, R);
      for (int i = threadIdx.x; i < R * MT; i += kEllThreads) {
        const int r = i / MT, m = i - r * MT;
        if (m0 + m < M) *proj_at(z, m0 + m, r) = p[i];
      }
    }

    if constexpr (BIN) {
      // Σ_r ±u_r · bf16(x ⊙ v_r) over the split's columns on the tensor
      // cores (rows g and g + 8 of the warp, batch rows 2q, 2q + 1 of each
      // n-tile), into gs for the gather's stores
      if (live) {
        float c[NTP][4];
#pragma unroll
        for (int t = 0; t < NTP; ++t) c[t][0] = c[t][1] = c[t][2] = c[t][3] = 0.f;
        for (int kc0 = k_lo; kc0 < k_hi; kc0 += 4 * 128) {
          uint32_t ca[4], cb[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            ca[j] = wa[j];
            cb[j] = wb[j];
          }
          if (kc0 + 4 * 128 < k_hi) fetch4(kc0 + 4 * 128);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kc = kc0 + 128 * j;
            if (kc >= k_hi) break;
            uint32_t sa[2], sb[2];
            xspread(ca[j], sa[0], sa[1]);
            xspread(cb[j], sb[0], sb[1]);
#pragma unroll
            for (int t = 0; t < NTP; ++t) {
              const bf16* row = xv + (size_t)(8 * t + g) * sx + (kc - k_lo);
              for (int r = 0; r < R; ++r)
                bin_chunk(c[t], flipped_pair(us[r * kEllRows + ja]),
                          flipped_pair(us[r * kEllRows + jb]), sa, sb,
                          row + (size_t)r * MT * sx, q);
            }
          }
        }
        float* gw = gs + (size_t)warp * 16 * MT;
#pragma unroll
        for (int t = 0; t < NTP; ++t) {
          const int mi = 8 * t + 2 * q;
          gw[g * MT + mi] = c[t][0];
          gw[g * MT + mi + 1] = c[t][1];
          gw[(g + 8) * MT + mi] = c[t][2];
          gw[(g + 8) * MT + mi + 1] = c[t][3];
        }
      }
      __syncthreads();               // gs is written; x ⊙ v_r and u are
    }                                // read (the ring takes their bytes)
    if (!live) continue;

    if (BIN) ring_begin();
    float acc[NTP][8];
#pragma unroll
    for (int t = 0; t < NTP; ++t)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[t][j] = 0.f;
    int i = 0, c = 0;                 // the step's row and step in the row
    for (int s = 0; s < RG * nc; ++s) {
      copy_next();                   // step s + D - 1
      cp_async_wait<D - 1>();        // step s has landed
      EllBlock<I> b;
      ell_read<I>(b, slot(s));
      const size_t lo = start(i);
      ell_mask<I>(b, (lo & ~size_t(7)) + z_lo + (size_t)c * kEllStep + k8, lo,
                  lo + kmax);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if constexpr (MR < 8)
          ell_entry_narrow<I, MR>(acc[0], xs, K, b, j);
        else
          ell_entry<I, NTP>(acc, xs, kp, K, b, j);
      }
      if (++c < nc) continue;
      // the row's split is done: reduce over the group, add the ±1 sums,
      // store batch row m of each n-tile (the partial sum, or with one
      // split y), start the next row
      const int rr = r0 + i, n = n0 + rr, m = lane & (MR - 1);
      const bool mine = (lane & 7) < MR;
#pragma unroll
      for (int t = 0; t < NTP; ++t) {
        ell_reduce<MR>(acc[t], lane);
        float out = acc[t][0];
        if (BIN) out += gs[(size_t)rr * MT + 8 * t + m];
        const int mm = m0 + 8 * t + m;
        if (mine && n < N && mm < M) {
          if constexpr (SPLIT) {
            a.part[((size_t)z * M + mm) * N + n] = out;
          } else {
            if (LR) {   // Σ_r p[r, m] · u_r[n] in fp32, before the rounding
              float l = 0.f;
              for (int r = 0; r < R; ++r)
                l += p[r * MT + 8 * t + m] *
                     __bfloat162float(u[(size_t)r * N + n]);
              out += l;
            }
            y[(size_t)mm * N + n] = __float2bfloat16(out);
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[t][j] = 0.f;
      }
      c = 0;
      ++i;
    }
    cp_async_wait<0>();
  }
  if constexpr (!SPLIT) return;

  // The last block of this row tile to finish adds the splits' partial
  // sums in split order (the same bits whichever block is last), #5 with
  // Σ_r p[m, r]·u_r[n], p the partial projections summed in split order,
  // and resets its ticket for the next launch.
  __threadfence();
  __syncthreads();
  bool last = false;
  if (threadIdx.x == 0) {
    int* ticket = a.tickets + blockIdx.x;
    last = atomicAdd(ticket, 1) == n_split - 1;
    if (last) *ticket = 0;
  }
  if (!__syncthreads_or(last)) return;
  __threadfence();
  const int nr = min(kEllRows, N - n0);
  const size_t zs = (size_t)M * N;
  for (int mc = 0; mc < M; mc += LR ? MT : M) {
    const int mr = LR ? min(MT, M - mc) : M;
    if constexpr (LR) {
      __syncthreads();               // p is free
      // p: the partial projections summed in split order
      for (int i = threadIdx.x; i < R * mr; i += kEllThreads) {
        const int r = i / mr, m = i - r * mr;
        float pr = 0.f;
        for (int z0 = 0; z0 < n_split; z0 += 8) {   // 8 loads in flight
          float t[8];
#pragma unroll
          for (int zz = 0; zz < 8; ++zz)
            t[zz] = z0 + zz < n_split ? __ldcg(proj_at(z0 + zz, mc + m, r))
                                      : 0.f;
#pragma unroll
          for (int zz = 0; zz < 8; ++zz) pr += t[zz];   // in split order
        }
        p[r * MT + m] = pr;
      }
      __syncthreads();
    }
    for (int i = threadIdx.x; i < mr * kEllRows; i += kEllThreads) {
      const int m = mc + i / kEllRows, nn = i % kEllRows;
      if (nn >= nr) continue;
      const float* pt = a.part + (size_t)m * N + n0 + nn;
      float s = 0.f;
      for (int z0 = 0; z0 < n_split; z0 += 8) {   // 8 loads in flight
        float t[8];
#pragma unroll
        for (int zz = 0; zz < 8; ++zz)
          t[zz] = z0 + zz < n_split ? __ldcg(pt + (z0 + zz) * zs) : 0.f;
#pragma unroll
        for (int zz = 0; zz < 8; ++zz) s += t[zz];   // in split order
      }
      if (LR) {
        float l = 0.f;
        for (int r = 0; r < R; ++r)
          l += p[r * MT + m - mc] *
               __bfloat162float(u[(size_t)r * N + n0 + nn]);
        s += l;
      }
      y[(size_t)m * N + n0 + nn] = __float2bfloat16(s);
    }
    if (LR) __syncthreads();         // p is read before the next rows
  }
}

// The plan (kernels/slab_matmul.py::plan_ell_splits): n_split runs of epb
// entries (a multiple of kEllStep) cover K_max entries from any 8-entry
// boundary (K_max + 7), #1's runs of cps chunks cover K, and a split runs
// at one expert with its scratch.
inline bool ell_split_ok(int E, int K, int kmax, int n_split, int epb,
                         int cps, bool bin, const void* part,
                         const void* tickets) {
  return E > 0 && E <= slab::kMaxExperts && n_split > 0 &&
         n_split <= 65535 && epb > 0 && epb % kEllStep == 0 &&
         (long long)n_split * epb >= (long long)kmax + 7 &&
         (!bin || (cps > 0 && (long long)n_split * cps * 128 >= K)) &&
         (n_split == 1 || (E == 1 && part != nullptr && tickets != nullptr));
}

// Entries a run takes when each row is one run (#12, #13): all K_max of
// them from any 8-entry boundary, in whole group steps.
inline int ell_one_run(int kmax) {
  return (kmax + 7 + kEllStep - 1) / kEllStep * kEllStep;
}

// The batch rows a column at M <= 4 (1, 2 or 4: one n-tile), else the
// most n-tiles (up to what M needs, kMaxNtp) whose shared bytes fit the
// card's opt-in limit; none fitting launches nothing and returns
// cudaErrorInvalidValue.
template <typename I, bool LR, bool BIN>
static int launch_ell_split(const EllArgs& a, int E, int n_split,
                            void* stream) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return (int)cudaErrorInvalidValue;
  const int mr = a.M <= 1 ? 1 : a.M <= 2 ? 2 : a.M <= 4 ? 4 : 8;
  auto bytes = [&](int ntp) {
    return ell_split_smem<I, LR, BIN>(ntp, mr, a.K, a.R, a.cps);
  };
  int ntp = min((a.M + 7) / 8, kMaxNtp);
  while (ntp >= 1 && bytes(ntp) > (size_t)optin) --ntp;
  const size_t smem = ntp >= 1 ? bytes(ntp) : 0;
  const dim3 grid((a.N + kEllRows - 1) / kEllRows, E, n_split);
  auto run = [&](auto kern) {
    cudaError_t e = slab::prepare(kern, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, kEllThreads, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  };
  auto pick = [&](auto split) {
    constexpr bool S = decltype(split)::value;
    if (ntp == 1 && mr == 1) return run(ell_split_kernel<I, LR, BIN, 1, 1, S>);
    if (ntp == 1 && mr == 2) return run(ell_split_kernel<I, LR, BIN, 1, 2, S>);
    if (ntp == 1 && mr == 4) return run(ell_split_kernel<I, LR, BIN, 1, 4, S>);
    TC_DISPATCH_NTP(ntp, {
      return run(ell_split_kernel<I, LR, BIN, NTP, 8, S>);
    });
    return (int)cudaGetLastError();
  };
  // SPLIT only where a launch splits: #12 and #13 (one run a row) and the
  // one-split launches of #1, #4 and #5 keep the split's tail out of
  // their code
  if (n_split > 1) return pick(std::true_type{});
  return pick(std::false_type{});
}

template <bool LR, bool BIN>
static int dispatch_ell_split(int dtype, int idx_bytes, const EllArgs& a,
                              int E, int n_split, void* stream) {
  if (dtype != 1 || a.M <= 0 || a.N <= 0 || a.K <= 0 || a.kmax <= 0 ||
      (LR || BIN ? a.R <= 0 : a.R != 0) || (BIN && a.K % 32) ||
      !ell_split_ok(E, a.K, a.kmax, n_split, a.epb, a.cps, BIN, a.part,
                    a.tickets))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(a.vals) || !aligned16(a.idx) || (BIN && !aligned16(a.bp)))
    return (int)cudaErrorMisalignedAddress;
  if (idx_bytes == 2)
    return launch_ell_split<uint16_t, LR, BIN>(a, E, n_split, stream);
  if (idx_bytes == 4)
    return launch_ell_split<uint32_t, LR, BIN>(a, E, n_split, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

// #12 / #13: dtype must be 1 (bfloat16): f32 launches, launches at fewer
// rows per expert than grouped.ELL_TC_MIN_ROWS, and shapes whose one tile
// does not fit shared memory (grouped.ell_tc_smem) go to ell.cu's kernel.
// idx_bytes: 2 (uint16 ids) or 4. x (E, M, K), vals / idx (E, N, K_max),
// u (E, R, N), v (E, R, K), y (E, M, N); each row is one run (no split).
// Launches on ``stream``, allocates nothing, returns cudaGetLastError().
extern "C" int ell_matmul_g(int dtype, int idx_bytes, const void* x,
                            const void* vals, const void* idx, void* y,
                            int E, int M, int N, int K, int kmax,
                            void* stream) {
  const tc::EllArgs a{(const tc::bf16*)x, (const tc::bf16*)vals, idx,
                      nullptr, nullptr, nullptr, (tc::bf16*)y, nullptr,
                      nullptr, M, N, K, kmax, 0, tc::ell_one_run(kmax), 0};
  return tc::dispatch_ell_split<false, false>(dtype, idx_bytes, a, E, 1,
                                              stream);
}

extern "C" int ell_lr_matmul_g(int dtype, int idx_bytes, const void* x,
                               const void* vals, const void* idx,
                               const void* u, const void* v, void* y, int E,
                               int M, int N, int K, int kmax, int R,
                               void* stream) {
  const tc::EllArgs a{(const tc::bf16*)x, (const tc::bf16*)vals, idx,
                      nullptr, (const tc::bf16*)u, (const tc::bf16*)v,
                      (tc::bf16*)y, nullptr, nullptr, M, N, K, kmax, R,
                      tc::ell_one_run(kmax), 0};
  return tc::dispatch_ell_split<true, false>(dtype, idx_bytes, a, E, 1,
                                             stream);
}

// #1: dtype must be 1 (bfloat16) and K a multiple of 32 (the sign words):
// f32 launches, fewer rows than ell.SLAB_ELL_TC_MIN_ROWS and shapes whose
// staged x does not fit (ell.ell_split_smem) go to ell.cu's kernel.
// idx_bytes: 2 (uint16 ids) or 4. x (M, K), vals / idx (N, K_max), bp (N,
// K/32), u (R, N), v (R, K), y (M, N); each row's entries split into
// n_split runs of epb (a multiple of 64), the ±1 term's columns into runs
// of cps 128-column chunks, and with n_split > 1 part (n_split, M, N) fp32
// scratch and tickets (⌈N/128⌉ ints, zero; zero again after the launch).
// Launches on ``stream``, allocates nothing, returns cudaGetLastError().
extern "C" int slab_ell_matmul(int dtype, int idx_bytes, const void* x,
                               const void* vals, const void* idx,
                               const void* bp, const void* u, const void* v,
                               void* y, void* part, void* tickets, int M,
                               int N, int K, int kmax, int R, int n_split,
                               int epb, int cps, void* stream) {
  const tc::EllArgs a{(const tc::bf16*)x, (const tc::bf16*)vals, idx,
                      (const uint32_t*)bp, (const tc::bf16*)u,
                      (const tc::bf16*)v, (tc::bf16*)y, (float*)part,
                      (int*)tickets, M, N, K, kmax, R, epb, cps};
  return tc::dispatch_ell_split<false, true>(dtype, idx_bytes, a, 1, n_split,
                                             stream);
}

// #4: dtype must be 1 (bfloat16), any K: f32 launches, fewer rows than
// ell.ELL_TC_MIN_ROWS and shapes whose staged x does not fit go to ell.cu's
// kernel. Operands and split as ell_lr_matmul's, without the low-rank term
// (with n_split > 1 part holds the (n_split, M, N) partial sums only).
// Launches on ``stream``, allocates nothing, returns cudaGetLastError().
extern "C" int ell_matmul(int dtype, int idx_bytes, const void* x,
                          const void* vals, const void* idx, void* y,
                          void* part, void* tickets, int M, int N, int K,
                          int kmax, int n_split, int epb, void* stream) {
  const tc::EllArgs a{(const tc::bf16*)x, (const tc::bf16*)vals, idx,
                      nullptr, nullptr, nullptr, (tc::bf16*)y, (float*)part,
                      (int*)tickets, M, N, K, kmax, 0, epb, 0};
  return tc::dispatch_ell_split<false, false>(dtype, idx_bytes, a, 1,
                                              n_split, stream);
}

// #5: dtype must be 1 (bfloat16), any K: f32 launches, fewer rows than
// ell.ELL_LR_TC_MIN_ROWS and shapes whose staged x does not fit go to
// ell.cu's kernel. Operands and split as slab_ell_matmul's, without sign
// words or column runs, and with n_split > 1 part also holds (n_split,
// ⌈N/128⌉, M, R) partial projections. Launches on ``stream``, allocates
// nothing, returns cudaGetLastError().
extern "C" int ell_lr_matmul(int dtype, int idx_bytes, const void* x,
                             const void* vals, const void* idx,
                             const void* u, const void* v, void* y,
                             void* part, void* tickets, int M, int N, int K,
                             int kmax, int R, int n_split, int epb,
                             void* stream) {
  const tc::EllArgs a{(const tc::bf16*)x, (const tc::bf16*)vals, idx,
                      nullptr, (const tc::bf16*)u, (const tc::bf16*)v,
                      (tc::bf16*)y, (float*)part, (int*)tickets, M, N, K,
                      kmax, R, epb, 0};
  return tc::dispatch_ell_split<true, false>(dtype, idx_bytes, a, 1, n_split,
                                             stream);
}
