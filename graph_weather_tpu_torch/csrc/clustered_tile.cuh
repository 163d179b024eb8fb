// The tile machinery shared by the clustered attention's forward
// (clustered_flash.cu: K3a) and backward (clustered_flash_bwd.cu: K3b, K3c)
// and the banded attention's (banded_flash.cu: K4a; banded_flash_bwd.cu:
// K4b) on sm_90a: split-TF32 tensor-core products, per-warp skipping of
// 16-key warp tiles without an edge, and gathered or contiguous rows copied
// into shared memory with cp.async.
//
// Products. Every product of two f32 tiles runs on mma.sync m16n8k8 with
// TF32 inputs and f32 accumulators, in three parts: x = big + small with
// big = rna(x) and small = rna(x - big) (TF32 rounding to nearest, ties
// away, as cvt.rna.tf32.f32), then the cross terms small_a big_b +
// big_a small_b and the big_a big_b term, each summed in f32. The dropped
// small_a small_b term and the rounding of the small parts leave about
// 2^-21 of each product, f32's accuracy for sums of this length (one TF32
// product alone misses by ~2^-11, which a 1e-4 check fails:
// tests/test_torch_clustered_tf32.py).
//
// Layouts. A warp owns 16 "own" rows (receivers in the forward) and walks
// the "streamed" rows (gathered keys) in warp tiles of 16, skipping those in
// which its rows have no edge; a warp tile is two 8-row mma tiles. A
// row-major tile in shared memory has a stride LD = CP + 4 floats (CP a
// multiple of 8), so both fragment patterns below read 32 distinct banks:
//   * row products, s[16 x 8] += own[16 x c] . str[8 x c]^T: the A fragment
//     reads own rows g, g+8 at channels t, t+4; the B fragment streamed row
//     g at channels t, t+4 (g = lane / 4, t = lane % 4);
//   * column products, o[16 x c] += p[16 x 8] . str[8 x c]: p comes from
//     the row product's accumulator, whose thread holds columns 2t, 2t+1.
//     The mma's reduction index k = t is read as streamed row 2t and k = t+4
//     as row 2t+1 (the sum over the 8 rows does not care about their order),
//     so p needs no shuffle: a = (c0, c2, c1, c3), and the B fragment reads
//     streamed rows 2t, 2t+1 at channel g.
// Accumulator c of a thread holds (row g, col 2t), (g, 2t+1), (g+8, 2t),
// (g+8, 2t+1).
//
// bf16 (K3a, K3b, K3c, K4a and K4b on bf16 inputs). Tiles hold bf16 rows with a
// stride LD = CP + 8 elements (CP a multiple of 16), so a row is 16-byte
// aligned and the 32-bit fragment loads of 8 rows x 4 words read 32
// distinct banks. Every product is one mma.sync m16n8k16 with bf16 inputs
// and f32 accumulators:
//   * row products: the A fragment reads own rows g, g+8 at channel pairs
//     (2t, 2t+1) and (2t+8, 2t+9), one 32-bit word each; the B fragment
//     streamed row g at the same pairs;
//   * column products: the two 8-column accumulators of a 16-row warp tile
//     are, once rounded to bf16 in pairs, exactly the A fragment of the
//     m16n8k16 product (no shuffle); the B fragment, streamed rows 2t, 2t+1
//     (+8) at channel g, comes from ldmatrix.trans, four 8 x 8 matrices (two
//     8-channel tiles) a call.
// The accumulator layout is the f32 path's, so the softmax, the edge bits
// and the output code are shared.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace ctile {

constexpr float NEG = -1e30f;   // additive bias off an edge
constexpr float SAFE = -1e28f;  // running-max start: exp(NEG - SAFE) == 0
constexpr int STAGES = 2;       // shared-memory stages of the streamed tiles
constexpr float LOG2E = 1.4426950408889634f;

// exp(x - m) through the MUFU's exp2 (expf costs several instructions
// more). x and m stay in natural units, so the running max and the lse keep
// their bits (-1e28 on a row without an edge); x == m gives exactly 1, and an
// entry off an edge (x - m <= -1e30 + 1e28) exactly 0.
__device__ __forceinline__ float exp_diff(float x, float m) {
  return exp2f((x - m) * LOG2E);
}

using bf16 = __nv_bfloat16;

// Row stride in shared memory of a tile of element T: f32 CP + 4, bf16 CP + 8.
template <class T>
constexpr int row_pad() {
  return sizeof(T) == 4 ? 4 : 8;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// dst[r][0:CP) = row_ptr(r)[0:c), zeros past c (the products read all CP
// channels) or where row_ptr(r) is null; r < nrows. 16-byte copies when
// vec (c a multiple of 16 bytes' elements and every row 16-byte aligned),
// else 4-byte cp.async copies (f32) or 2-byte loads and stores (bf16: there
// is no 2-byte cp.async; they are visible after the tile's __syncthreads).
template <int THREADS, int CP, class T, class RowPtr>
__device__ __forceinline__ void copy_rows(T* dst, int ld, int nrows, int c, bool vec,
                                          const T* any, RowPtr row_ptr) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);  // elements a copy
    constexpr int per_row = CP / E;
    for (int i = threadIdx.x; i < nrows * per_row; i += THREADS) {
      const int r = i / per_row;
      const int d = (i - r * per_row) * E;
      const T* src = row_ptr(r);
      const bool ok = src != nullptr && d < c;
      cp_async16(dst + r * ld + d, ok ? src + d : any, ok);
    }
  } else {
    for (int i = threadIdx.x; i < nrows * CP; i += THREADS) {
      const int r = i / CP;
      const int d = i - r * CP;
      const T* src = row_ptr(r);
      const bool ok = src != nullptr && d < c;
      if constexpr (sizeof(T) == 4) {
        cp_async4(dst + r * ld + d, ok ? src + d : any, ok);
      } else {
        reinterpret_cast<uint16_t*>(dst)[r * ld + d] =
            ok ? reinterpret_cast<const uint16_t*>(src)[d] : uint16_t{0};
      }
    }
  }
}

// dst[d], dst[d + 1] = x0, x1 (x1 only where d + 1 < c), for an output row
// of f32 or bf16 (rounded to nearest); one 8- or 4-byte store when vec.
__device__ __forceinline__ void store2(float* dst, int d, int c, bool vec, float x0, float x1) {
  if (vec) {
    *reinterpret_cast<float2*>(dst + d) = make_float2(x0, x1);
  } else {
    dst[d] = x0;
    if (d + 1 < c) dst[d + 1] = x1;
  }
}

__device__ __forceinline__ void store2(bf16* dst, int d, int c, bool vec, float x0, float x1) {
  if (vec) {
    *reinterpret_cast<__nv_bfloat162*>(dst + d) = __floats2bfloat162_rn(x0, x1);
  } else {
    dst[d] = __float2bfloat16_rn(x0);
    if (d + 1 < c) dst[d + 1] = __float2bfloat16_rn(x1);
  }
}

// --- split-TF32 products -----------------------------------------------------

// x rounded to TF32, to nearest with ties away from zero: the bits of
// cvt.rna.tf32.f32 for every finite x, in two integer instructions (the cvt
// made the forward a third slower: PERF.md §6).
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = rna_tf32(x);
  small = rna_tf32(x - __uint_as_float(big));
}

struct FragA {
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment of 16 rows x 8 channels [k0, k0 + 8) of a row-major tile.
__device__ __forceinline__ FragA load_a(const float* tile, int ld, int k0, int lane) {
  const float* p = tile + (lane >> 2) * ld + k0 + (lane & 3);
  FragA a;
  split(p[0], a.big[0], a.small[0]);
  split(p[8 * ld], a.big[1], a.small[1]);
  split(p[4], a.big[2], a.small[2]);
  split(p[8 * ld + 4], a.big[3], a.small[3]);
  return a;
}

// B fragment of a row product: 8 tile rows (n) x channels [k0, k0 + 8) (k).
__device__ __forceinline__ FragB load_b_rows(const float* tile, int ld, int k0, int lane) {
  const float* p = tile + (lane >> 2) * ld + k0 + (lane & 3);
  FragB b;
  split(p[0], b.big[0], b.small[0]);
  split(p[4], b.big[1], b.small[1]);
  return b;
}

// B fragment of a column product: 8 tile rows (k, in the order 2t, 2t + 1)
// x channels [n0, n0 + 8) (n).
__device__ __forceinline__ FragB load_b_cols(const float* tile, int ld, int n0, int lane) {
  const float* p = tile + 2 * (lane & 3) * ld + n0 + (lane >> 2);
  FragB b;
  split(p[0], b.big[0], b.small[0]);
  split(p[ld], b.big[1], b.small[1]);
  return b;
}

// A fragment of a column product from a row product's accumulator.
__device__ __forceinline__ FragA a_from_acc(const float (&c)[4]) {
  FragA a;
  split(c[0], a.big[0], a.small[0]);
  split(c[2], a.big[1], a.small[1]);
  split(c[1], a.big[2], a.small[2]);
  split(c[3], a.big[3], a.small[3]);
  return a;
}

// One warp tile of a row product: acc[h] = own[16 rows] . str[8h .. 8h + 8)^T
// over channels [k_begin, k_begin + 8 KSTEPS), h = 0, 1 (16 streamed rows).
// The big . big terms and the cross terms go to separate accumulators, so
// four independent mma chains run; no branch inside, so the compiler can
// issue later fragment loads ahead of earlier products.
template <int KSTEPS>
__device__ __forceinline__ void row_products16(float (&acc)[2][4], const float* own,
                                               const float* str, int ld, int k_begin,
                                               int lane) {
  float cross[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[h][e] = cross[h][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int k0 = k_begin + 8 * kk;
    const FragA a = load_a(own, ld, k0, lane);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const FragB b = load_b_rows(str + 8 * h * ld, ld, k0, lane);
      mma_tf32(cross[h], a.small, b.big);
      mma_tf32(cross[h], a.big, b.small);
      mma_tf32(acc[h], a.big, b.big);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[h][e] += cross[h][e];
}

// One warp tile of a column product: acc[n] += p[0] . str[0 .. 8) + p[1] .
// str[8 .. 16) over channels n_begin + 8n .. + 8, for all NN channel tiles
// (NN independent chains; the cross terms first, then big . big).
template <int NN>
__device__ __forceinline__ void col_products16(float (&acc)[NN][4], const float (&p)[2][4],
                                               const float* str, int ld, int n_begin,
                                               int lane) {
  const FragA a0 = a_from_acc(p[0]);
  const FragA a1 = a_from_acc(p[1]);
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    const FragB b0 = load_b_cols(str, ld, n_begin + 8 * n, lane);
    const FragB b1 = load_b_cols(str + 8 * ld, ld, n_begin + 8 * n, lane);
    mma_tf32(acc[n], a0.small, b0.big);
    mma_tf32(acc[n], a0.big, b0.small);
    mma_tf32(acc[n], a1.small, b1.big);
    mma_tf32(acc[n], a1.big, b1.small);
    mma_tf32(acc[n], a0.big, b0.big);
    mma_tf32(acc[n], a1.big, b1.big);
  }
}

// Where the CS warps of a row group each computed a row product over their
// own slice of c: every warp of the group gets the sum of the CS partials,
// added in one fixed order, so all of them hold the same bits. acc holds
// NS warp tiles of 16 streamed rows; `act` marks the ones computed. `part`
// holds RG x CS x NS x 2 x 32 float4s. Every thread of the block calls it.
template <int NS, int CS>
__device__ __forceinline__ void sum_partials(float (&acc)[NS][2][4], float4* part, int rg,
                                             int cs, unsigned act, int lane) {
  float4* mine = part + (rg * CS + cs) * NS * 2 * 32 + lane;
#pragma unroll
  for (int j = 0; j < NS; ++j)
    if ((act >> j) & 1u)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        mine[(2 * j + h) * 32] = make_float4(acc[j][h][0], acc[j][h][1], acc[j][h][2], acc[j][h][3]);
  __syncthreads();
  const float4* group = part + rg * CS * NS * 2 * 32 + lane;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    if (!((act >> j) & 1u)) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float4 s = group[(2 * j + h) * 32];
#pragma unroll
      for (int c = 1; c < CS; ++c) {
        const float4 x = group[((c * NS + j) * 2 + h) * 32];
        s.x += x.x;
        s.y += x.y;
        s.z += x.z;
        s.w += x.w;
      }
      acc[j][h][0] = s.x;
      acc[j][h][1] = s.y;
      acc[j][h][2] = s.z;
      acc[j][h][3] = s.w;
    }
  }
}

// --- bf16 products -------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t word(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// lo in the low half (the lower column of an mma fragment), rounded to nearest.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Four 8 x 8 b16 matrices, transposed: lanes 8i .. 8i + 7 give the row
// addresses of matrix i, and a thread gets, of matrix i, rows 2t, 2t + 1 at
// column g in r[i].
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// One warp tile of a row product over bf16 tiles, as the f32 one:
// acc[h] = own[16 rows] . str[8h .. 8h + 8)^T over channels [k_begin,
// k_begin + 8 KSTEPS). Even and odd 16-channel steps go to separate
// accumulators, so four independent mma chains run.
template <int KSTEPS>
__device__ __forceinline__ void row_products16(float (&acc)[2][4], const bf16* own,
                                               const bf16* str, int ld, int k_begin,
                                               int lane) {
  static_assert(KSTEPS % 2 == 0, "bf16 products take 16 channels a step");
  float odd[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[h][e] = odd[h][e] = 0.f;
  const int off = (lane >> 2) * ld + 2 * (lane & 3) + k_begin;
  auto step = [&](float (&d)[2][4], int k0) {  // 16 channels from k0
    const bf16* a_p = own + off + k0;
    const uint32_t a[4] = {word(a_p), word(a_p + 8 * ld), word(a_p + 8), word(a_p + 8 * ld + 8)};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bf16* b_p = str + 8 * h * ld + off + k0;
      const uint32_t b[2] = {word(b_p), word(b_p + 8)};
      mma_bf16(d[h], a, b);
    }
  };
#pragma unroll
  for (int kk = 0; kk < KSTEPS / 2; kk += 2) {
    step(acc, 16 * kk);
    if (kk + 1 < KSTEPS / 2) step(odd, 16 * (kk + 1));
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[h][e] += odd[h][e];
}

// One warp tile of a column product over a bf16 tile: acc[n] += bf16(p) .
// str[0 .. 16) over channels n_begin + 8n .. + 8, for all NN channel tiles.
// p is rounded to bf16 here, as the TPU kernel rounds it to the value dtype.
template <int NN>
__device__ __forceinline__ void col_products16(float (&acc)[NN][4], const float (&p)[2][4],
                                               const bf16* str, int ld, int n_begin,
                                               int lane) {
  static_assert(NN % 2 == 0, "ldmatrix.x4 loads two 8-channel tiles");
  const uint32_t a[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                         pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
  const int i = lane >> 3;  // matrix: key half i & 1, channel tile i >> 1
  const bf16* row = str + ((i & 1) * 8 + (lane & 7)) * ld + n_begin + (i >> 1) * 8;
#pragma unroll
  for (int n = 0; n < NN; n += 2) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, row + 8 * n);
    const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
    mma_bf16(acc[n], a, b0);
    mma_bf16(acc[n + 1], a, b1);
  }
}

// acc += col_products16 of one warp tile, computed in a fresh accumulator
// and added in f32: the tensor cores' accumulation truncates, and the
// rows at a band's clamped ends (attended by hundreds of receivers) sum
// hundreds of warp tiles, over which that bias would pass 1e-4 (K4a, K4b).
// T: the streamed tile's element, f32 (split-TF32 products) or bf16.
template <int NN, class T>
__device__ __forceinline__ void add_col_products(float (&acc)[NN][4], const float (&p)[2][4],
                                                 const T* str, int ld, int n_begin, int lane) {
  float part[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n) part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.f;
  col_products16<NN>(part, p, str, ld, n_begin, lane);
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
}

// --- which warp tiles hold an edge ---------------------------------------------

constexpr int SUB = 16;  // streamed rows of a warp tile

// Bit i of a word: byte i of w is not 0.
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t w) {
  return ((__vcmpne4(w, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

// The edges of every warp tile of the CTA, from one read of its mask bytes:
// bits[(rg * n_sub + s) * 16 + r] bit c is 1 where own row a0 + 16 rg + r
// has an edge with streamed row 16 s + c, and flags[rg * n_sub + s] is 1
// where any of these 256 bits is; own rows past n_own and streamed rows past
// n_str have none. The mask byte of (own o, streamed s) lies at
// m[o * own_stride + s * str_stride]: one of the two strides is 1 (the
// contiguous direction), the other is u_pad.
template <int RG, int THREADS>
__device__ __forceinline__ void scan_edges(unsigned char* flags, uint16_t* bits,
                                           const signed char* m, long long own_stride,
                                           long long str_stride, int a0, int n_own, int n_str) {
  const int n_sub = (n_str + SUB - 1) / SUB;
  for (int i = threadIdx.x; i < RG * n_sub; i += THREADS) {
    const int rg = i / n_sub;
    const int s = i - rg * n_sub;
    const int o_begin = a0 + 16 * rg;
    const int o_end = min(o_begin + 16, n_own);
    const int s_begin = SUB * s;
    const int s_end = min(s_begin + SUB, n_str);
    uint32_t row[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) row[r] = 0;
    const bool full = o_end - o_begin == 16 && s_end - s_begin == SUB;
    if (full && str_stride == 1 &&
        ((reinterpret_cast<uintptr_t>(m) | own_stride | s_begin) & 15) == 0) {
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(m + (o_begin + r) * own_stride + s_begin));
        row[r] = nonzero_bytes(w.x) | nonzero_bytes(w.y) << 4 | nonzero_bytes(w.z) << 8 |
                 nonzero_bytes(w.w) << 12;
      }
    } else if (full && own_stride == 1 &&
               ((reinterpret_cast<uintptr_t>(m) | str_stride | o_begin) & 15) == 0) {
      for (int c = 0; c < SUB; ++c) {
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(m + (s_begin + c) * str_stride + o_begin));
        const uint32_t col = nonzero_bytes(w.x) | nonzero_bytes(w.y) << 4 | nonzero_bytes(w.z) << 8 |
                             nonzero_bytes(w.w) << 12;
#pragma unroll
        for (int r = 0; r < 16; ++r) row[r] |= ((col >> r) & 1u) << c;
      }
    } else {
      for (int o = o_begin; o < o_end; ++o)
        for (int t = s_begin; t < s_end; ++t)
          if (m[o * own_stride + t * str_stride] != 0) {
#pragma unroll
            for (int r = 0; r < 16; ++r)
              if (r == o - o_begin) row[r] |= 1u << (t - s_begin);
          }
    }
    uint32_t any = 0;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      bits[i * 16 + r] = static_cast<uint16_t>(row[r]);
      any |= row[r];
    }
    flags[i] = any != 0;
  }
}

// Whether the thread's pair (row g + 8 (e / 2), streamed column 8 h + 2 t +
// e % 2) of a warp tile holds an edge, from the tile's bits.
__device__ __forceinline__ bool edge_bit(const uint16_t* tile_bits, int h, int e, int lane) {
  const uint32_t row = tile_bits[(lane >> 2) + 8 * (e >> 1)];
  return (row >> (8 * h + 2 * (lane & 3) + (e & 1))) & 1u;
}

// The streamed tiles (TS rows each) in which any row group has an edge, in
// order, into tiles[0 .. *count); warp 0 builds the list. Call after the
// flags are written and a __syncthreads; __syncthreads after it.
template <int RG, int TS>
__device__ __forceinline__ void list_tiles(int* tiles, int* count,
                                           const unsigned char* flags, int n_str) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int n_sub = (n_str + SUB - 1) / SUB;
  const int n_tiles = (n_str + TS - 1) / TS;
  int n = 0;
  for (int base = 0; base < n_tiles; base += 32) {
    const int tile = base + lane;
    bool has = false;
    if (tile < n_tiles) {
      for (int rg = 0; rg < RG; ++rg)
        for (int j = 0; j < TS / SUB; ++j) {
          const int s = tile * (TS / SUB) + j;
          if (s < n_sub && flags[rg * n_sub + s]) has = true;
        }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, has);
    if (has) tiles[n + __popc(ballot & ((1u << lane) - 1u))] = tile;
    n += __popc(ballot);
  }
  if (lane == 0) *count = n;
}

// The warp tiles of streamed tile `tile` in which row group rg has an edge,
// as bits.
template <int NS>
__device__ __forceinline__ unsigned active_bits(const unsigned char* flags, int rg,
                                                int tile, int n_str) {
  const int n_sub = (n_str + SUB - 1) / SUB;
  unsigned act = 0;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int s = tile * NS + j;
    if (s < n_sub && flags[rg * n_sub + s]) act |= 1u << j;
  }
  return act;
}

}  // namespace ctile
