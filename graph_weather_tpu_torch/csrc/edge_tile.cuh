// The edge-tile machinery shared by the fused edge update's forward
// (edge_mlp.cu: K1 and its partial-product mode K2) and its backward
// (fused_mlp_bwd.cu: K2b) on sm_90a: split-TF32 tensor-core products of a
// [64, K] tile in shared memory with a [K, N] weight streamed through shared
// memory in slices.
//
// Products. Every product runs on mma.sync m16n8k8 with TF32 inputs and f32
// accumulators, as three products (clustered_tile.cuh: x = big + small,
// a.b = small_a big_b + big_a small_b + big_a big_b), which keeps f32's
// accuracy (tests/test_torch_edge_tf32.py). The A operand (the e rows, then
// h0, h1, dh2, dh1 or dh0) lives in one [TE, LDA] buffer; per k-step each
// warp splits its MT A fragments once and reuses them across its NT
// n-tiles, and splits each B fragment once for its MT m-tiles, both by
// ctile::split (big and small rounded to TF32). Leaving small for the mma
// to truncate (it reads a TF32 operand's top 19 bits) saves two of the five
// instructions a value and was 2-7% faster, but it put the forecaster's
// mesh-seed gradient at 0.94 of its limit in chip_smoke.py phase 35, where
// rounding keeps every gradient within the first limit
// (scripts/k2_variants.py --readings, variant trunc).
//
// Pipeline. The weight slices of all the kernel's products form one stream:
// a ring of STAGES slices of KC rows, slice t in stage t % STAGES, copied
// with cp.async STAGES - 1 slices ahead (across product boundaries, over
// the epilogues between products), one __syncthreads a slice. Two stages of
// 16 rows keep a block at 109 KB of shared memory, so two blocks share an
// SM and one multiplies while the other waits at a barrier.
//
// Layout. A block of THREADS = 256 threads (8 warps) owns TE = 64 edges of
// one batch entry and all NMAX = 256 columns of every product. Warp w owns
// the 16 MT rows from row0 = 16 MT (w / CW) and the 8 NT columns from col0 =
// 8 NT (w % CW), in every product: MT m-tiles by NT n-tiles of 4 accumulators
// a thread (64 registers). Thread (g = lane / 4, t = lane % 4) holds, in
// acc[mt][nt], rows r = row0 + 16 mt + g (e = 0, 1) and r + 8 (e = 2, 3) at
// columns c = col0 + 8 nt + 2 t + (e & 1). Column sums of the accumulators
// are shuffles over g, then the RG row groups added in a fixed order. The
// LayerNorm epilogues go row by row instead (warp w the rows 8 w .. 8 w + 7,
// lane l the columns 4 l + j and 128 + 4 l + j, j < 4, row_col) from h2 in
// shared memory, with the accumulators dead: warp shuffles for a row's
// statistics. No atomics: every launch repeats its bits.
//
// Bank conflicts: A rows have a stride LDA = NMAX + 4 (the A fragment reads
// rows g, g + 8 at channels t, t + 4: banks 4 g + t), weight slice rows
// LDB = NMAX + 8 (the B fragment reads rows t, t + 4 at column g: banks
// 8 t + g).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "clustered_tile.cuh"

namespace edge_tile {

using ctile::FragA;

constexpr int TE = 64;        // edges per block
constexpr int NMAX = 256;     // widest layer (H and Fe; wider K1 inputs come in chunks)
constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int KC = 16;        // rows of a weight slice
constexpr int STAGES = 2;     // weight slices in flight or in use
constexpr int MT = 4;         // m-tiles (16 rows) a warp
constexpr int RG = TE / (16 * MT);     // row groups
constexpr int CW = WARPS / RG;         // warps across the columns of a row group
constexpr int NT = NMAX / (8 * CW);    // n-tiles (8 columns) a warp
constexpr int ROWS = TE / WARPS;       // rows a warp in the row-wise epilogues
constexpr int LDA = NMAX + 4;
constexpr int LDB = NMAX + 8;
static_assert(KC % 8 == 0 && RG * 16 * MT == TE && CW * RG == WARPS && NT * 8 * CW == NMAX,
              "edge tile layout");
static_assert(STAGES >= 2 && THREADS == NMAX && NMAX == 256, "edge tile stream");
static_assert(MT * NT * 4 == 64, "a ReLU mask of a thread's accumulators is 64 bits");

// Shared memory: H [TE][LDA] (the A operand), the slice ring [STAGES][KC]
// [LDB], the column-sum scratch [WARPS][NMAX], the tile's sender and
// receiver ids.
constexpr int kH = TE * LDA;
constexpr int kSlice = KC * LDB;
constexpr int kRed = WARPS * NMAX;
constexpr size_t kSmemBytes = sizeof(float) * (kH + STAGES * kSlice + kRed) + sizeof(int) * 2 * TE;
// Two blocks an SM when both fit in its 228 KB (1 KB reserved per block).
constexpr int kBlocksPerSM = 2 * (kSmemBytes + 1024) <= 233472 ? 2 : 1;

using Acc = float[MT][NT][4];

struct Smem {
  float* H;
  float* ring;  // [STAGES][KC][LDB]
  float* red;   // [WARPS][NMAX]
  int* sidx;
  int* ridx;
};

__device__ __forceinline__ Smem carve(float4* base) {
  Smem s;
  s.H = reinterpret_cast<float*>(base);
  s.ring = s.H + kH;
  s.red = s.ring + STAGES * kSlice;
  s.sidx = reinterpret_cast<int*>(s.red + kRed);
  s.ridx = s.sidx + TE;
  return s;
}

// This thread's place in the warp tiles.
struct Place {
  int row0, col0, rg, g, t;
};

__device__ __forceinline__ Place place() {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Place p;
  p.rg = warp / CW;
  p.row0 = 16 * MT * p.rg;
  p.col0 = 8 * NT * (warp % CW);
  p.g = lane >> 2;
  p.t = lane & 3;
  return p;
}

// x, hidden from the compiler: what is derived from it is recomputed where
// it is used, not kept live (and spilled) across the product loops.
__device__ __forceinline__ int opaque(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

__device__ __forceinline__ int acc_row(const Place& q, int mt, int e) {
  return q.row0 + 16 * mt + q.g + 8 * (e >> 1);
}
__device__ __forceinline__ int acc_col(const Place& q, int nt) { return q.col0 + 8 * nt + 2 * q.t; }

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
}

// Whether rows of `width` floats from `p` may be read as float2 (float4).
__device__ __forceinline__ bool vec2_ok(const void* p, int width) {
  return (width & 1) == 0 && (reinterpret_cast<uintptr_t>(p) & 7) == 0;
}
__device__ __forceinline__ bool vec4_ok(const void* p, int width) {
  return (width & 3) == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// (row[c], row[c + 1]), 0 at or past `width`; c is even.
__device__ __forceinline__ float2 load2(const float* row, int c, int width, bool vec) {
  if (vec) return c < width ? *reinterpret_cast<const float2*>(row + c) : make_float2(0.f, 0.f);
  return make_float2(c < width ? row[c] : 0.f, c + 1 < width ? row[c + 1] : 0.f);
}

__device__ __forceinline__ void store2(float* row, int c, int width, bool vec, float a, float b) {
  if (vec) {
    if (c < width) *reinterpret_cast<float2*>(row + c) = make_float2(a, b);
  } else {
    if (c < width) row[c] = a;
    if (c + 1 < width) row[c + 1] = b;
  }
}

// Copies [rows, NMAX] into dst (stride ld), dst[r][d] = src[r][d] with
// src[r] = base + ids[r] * stride (ids == nullptr: r * stride), for d < cols
// and r < n_rows; zeros elsewhere. 16-byte copies when vec4 (cols % 4 == 0,
// base and stride 16-byte aligned), else 4-byte ones; not committed. (As
// ctile::copy_rows, without its row-pointer closure, whose captures the
// compiler kept in local memory in these kernels.)
__device__ __forceinline__ void copy_rows(float* dst, int ld, int rows, const float* base,
                                          const int* ids, long long stride, int n_rows, int cols,
                                          bool vec4) {
  if (vec4) {
#pragma unroll 1
    for (int i = threadIdx.x; i < rows * (NMAX / 4); i += THREADS) {
      const int r = i / (NMAX / 4), d = 4 * (i % (NMAX / 4));
      const bool ok = r < n_rows && d < cols;
      const long long row = ok ? (ids ? ids[r] : r) : 0;
      ctile::cp_async16(dst + r * ld + d, base + row * stride + (ok ? d : 0), ok);
    }
  } else {
#pragma unroll 1
    for (int i = threadIdx.x; i < rows * NMAX; i += THREADS) {
      const int r = i / NMAX, d = i % NMAX;
      const bool ok = r < n_rows && d < cols;
      const long long row = ok ? (ids ? ids[r] : r) : 0;
      ctile::cp_async4(dst + r * ld + d, base + row * stride + (ok ? d : 0), ok);
    }
  }
}

// --- the weight slices -------------------------------------------------------

// One product of the kernel's chain: W [k, n] (row-major) in global memory.
struct Prod {
  const float* w;
  int k, n;
};

// The copies of the weight slices, one stream over every product of the
// kernel in order; `product(params, i)` (of `product_count(params)`) is the
// i-th, each kernel's own. Slice t lands in stage t % STAGES of the ring.
struct Stream {
  int taken;  // slices multiplied so far
  int p, k0;  // the next slice to copy: its product and first row
};

// Copies W rows [k0, k0 + KC) (zero at k >= k_end and past n_cols) into
// `dst`; not committed. 16-byte vectors: thread i copies vector i % 64 of
// rows i / 64 + 4 j.
__device__ __forceinline__ void load_slice(float* dst, const float* W, int k0, int k_end,
                                           int n_cols) {
  if (vec4_ok(W, n_cols)) {
    const int d = 4 * (threadIdx.x & 63);
    const int r0 = threadIdx.x >> 6;
#pragma unroll
    for (int j = 0; j < KC / 4; ++j) {
      const int r = r0 + 4 * j;
      const bool ok = d < n_cols && k0 + r < k_end;
      ctile::cp_async16(dst + r * LDB + d, ok ? W + (long long)(k0 + r) * n_cols + d : W, ok);
    }
  } else {
    copy_rows(dst, LDB, KC, W + (long long)k0 * n_cols, nullptr, n_cols, k_end - k0, n_cols, false);
  }
}

// Copies the stream's next slice (none past the last product) into `stage`
// and commits one group, so that slice t is always group t.
template <class Params>
__device__ __forceinline__ void issue(const Params& prm, Stream& s, float* ring, int stage) {
  if (s.p < product_count(prm)) {
    const Prod pr = product(prm, s.p);
    load_slice(ring + stage * kSlice, pr.w, s.k0, pr.k, pr.n);
    s.k0 += KC;
    if (s.k0 >= pr.k) {
      ++s.p;
      s.k0 = 0;
    }
  }
  ctile::cp_async_commit();
}

// Starts the stream (the caller has copied the first A rows, not committed,
// which join the first slice's group): the first STAGES - 1 slices.
template <class Params>
__device__ __forceinline__ Stream start(const Params& prm, float* ring) {
  Stream s{0, 0, 0};
  for (int i = 0; i < STAGES - 1; ++i) issue(prm, s, ring, i);
  return s;
}

// acc += A[:, k0 : k0 + KC) . slice over the warp's tiles.
__device__ __forceinline__ void mma_slice(Acc& acc, const Place& q, const float* A, int k0,
                                          const float* slice) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < KC / 8; ++ks) {
    FragA a[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      a[mt] = ctile::load_a(A + (q.row0 + 16 * mt) * LDA, LDA, k0 + 8 * ks, lane);
    const float* b = slice + (8 * ks + q.t) * LDB + q.col0 + q.g;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t bb[2], bs[2];
      ctile::split(b[8 * nt], bb[0], bs[0]);
      ctile::split(b[8 * nt + 4 * LDB], bb[1], bs[1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        ctile::mma_tf32(acc[mt][nt], a[mt].small, bb);
        ctile::mma_tf32(acc[mt][nt], a[mt].big, bs);
        ctile::mma_tf32(acc[mt][nt], a[mt].big, bb);
      }
    }
  }
}

// acc += A[:, 0 : pr.k) W for the stream's current product pr (W [pr.k,
// pr.n]), A the [TE, LDA] tile in shared memory, while the stream copies
// STAGES - 1 slices ahead. The caller places a __syncthreads between this
// and any write to A.
template <class Params>
__device__ __forceinline__ void dense(Acc& acc, const Place& q, const float* A, const Params& prm,
                                      Stream& s, float* ring, const Prod pr) {
  const int n = (pr.k + KC - 1) / KC;
  for (int i = 0; i < n; ++i) {
    ctile::cp_async_wait<STAGES - 2>();  // this thread's copies of slice `taken`
    // The slice complete; every warp is past the slice before it, whose
    // stage takes the slice STAGES - 1 ahead.
    __syncthreads();
    issue(prm, s, ring, (s.taken + STAGES - 1) % STAGES);
    mma_slice(acc, q, A, i * KC, ring + (s.taken % STAGES) * kSlice);
    ++s.taken;
  }
}

// A rows [TE, 0 : cols) = src[node(row)][c0 : c0 + cols) for the tile's
// edges, node(row) = ids[row] or the edge itself (ids == nullptr, src then
// the tile's first row); zeros past cols and past the last edge (n_rows
// valid rows). `width` is src's row length. Not committed.
__device__ __forceinline__ void stage_rows(float* A, const float* src, const int* ids, int width,
                                           int c0, int cols, int n_rows) {
  copy_rows(A, LDA, TE, src + c0, ids, width, n_rows, cols,
            vec4_ok(src, width) && (c0 & 3) == 0);
}

// --- epilogues in the accumulators -----------------------------------------------

// Orders the memory accesses before it before those after it in the
// compiler's schedule (no instruction): bounds the loads in flight, so that
// their registers stay few while the accumulators are live.
__device__ __forceinline__ void fence_loads() { asm volatile("" ::: "memory"); }

// acc = p_src[s(row)] + p_dst[r(row)] (no p_dst when nullptr), 0 past width;
// the tile's node ids in sidx, ridx (0 past the last edge). The p_src rows
// load straight into the accumulators, then the p_dst rows one row pair
// (of m-tile mt) at a time.
__device__ __forceinline__ void init_from_partials(Acc& acc, const Place& q, const float* p_src,
                                                   const float* p_dst, const int* sidx,
                                                   const int* ridx, int width) {
  const bool vs = vec2_ok(p_src, width), vd = p_dst != nullptr && vec2_ok(p_dst, width);
  const int first = opaque(q.row0 + q.g), col = opaque(acc_col(q, 0));
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* ps = p_src + (long long)sidx[first + 16 * mt + 8 * h] * width;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 v = load2(ps, col + 8 * nt, width, vs);
        acc[mt][nt][2 * h] = v.x;
        acc[mt][nt][2 * h + 1] = v.y;
      }
    }
  if (p_dst == nullptr) return;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    fence_loads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* pd = p_dst + (long long)ridx[first + 16 * mt + 8 * h] * width;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 d = load2(pd, col + 8 * nt, width, vd);
        acc[mt][nt][2 * h] += d.x;
        acc[mt][nt][2 * h + 1] += d.y;
      }
    }
  }
}

// acc = acc + bias, through a ReLU when `relu`, 0 past n_cols; returns the
// mask of positive entries, bit 4 (NT mt + nt) + e.
__device__ __forceinline__ unsigned long long add_bias(Acc& acc, const Place& q, const float* bias,
                                                       int n_cols, bool relu) {
  const bool vec = vec2_ok(bias, n_cols);
  const int col = opaque(acc_col(q, 0));
  unsigned long long mask = 0ull;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = col + 8 * nt;
    const float2 b = load2(bias, c, n_cols, vec);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = acc[mt][nt][e] + ((e & 1) ? b.y : b.x);
        if (relu) v = fmaxf(v, 0.f);
        v = c + (e & 1) < n_cols ? v : 0.f;
        acc[mt][nt][e] = v;
        if (v > 0.f) mask |= 1ull << (4 * (NT * mt + nt) + e);
      }
  }
  return mask;
}

__device__ __forceinline__ void apply_mask(Acc& acc, unsigned long long mask) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!((mask >> (4 * (NT * mt + nt) + e)) & 1ull)) acc[mt][nt][e] = 0.f;
}

// H rows = acc (all NMAX columns), and the global rows out[e0 + row] of the
// tile's valid edges (columns < width; out == nullptr: none); then acc = 0.
__device__ __forceinline__ void store_rows(float* H, Acc& acc, const Place& q, float* out,
                                           int width, int e0, int n_edges) {
  const bool vec = out != nullptr && vec2_ok(out, width);
  const int first = opaque(q.row0 + q.g), col = opaque(acc_col(q, 0));
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = first + 16 * mt + 8 * h;
      float* orow = out != nullptr && e0 + row < n_edges ? out + (long long)(e0 + row) * width
                                                         : nullptr;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = col + 8 * nt;
        const float a = acc[mt][nt][2 * h], b = acc[mt][nt][2 * h + 1];
        *reinterpret_cast<float2*>(H + row * LDA + c) = make_float2(a, b);
        if (orow != nullptr) store2(orow, c, width, vec, a, b);
        acc[mt][nt][2 * h] = acc[mt][nt][2 * h + 1] = 0.f;
      }
    }
}

// dst[c] (c < n_cols) = the column sums of acc over the tile's rows: shuffles
// over g, then the RG row groups added in order through red (half `half`
// of it: consecutive calls take turns, so that no barrier follows a call).
__device__ __forceinline__ void acc_colsum(const Acc& acc, const Place& q, float* red, int half,
                                           float* dst, int n_cols) {
  float* part = red + half * (RG * NMAX);
  const int col = opaque(acc_col(q, 0));
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v = 0.f;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) v += acc[mt][nt][j] + acc[mt][nt][2 + j];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (q.g == 0) part[q.rg * NMAX + col + 8 * nt + j] = v;
    }
  __syncthreads();
  const int c = threadIdx.x;  // THREADS == NMAX
  if (c < n_cols) {
    float s = part[c];
#pragma unroll
    for (int r = 1; r < RG; ++r) s += part[r * NMAX + c];
    dst[c] = s;
  }
}

// --- row-wise epilogues ---------------------------------------------------------

// Column j < 8 of this lane in a row: 4 l + j, then 128 + 4 l + j - 4.
__device__ __forceinline__ int row_col(int j) {
  return (j < 4 ? 0 : 128 - 4) + (threadIdx.x & 31) * 4 + j;
}

// v[j] = row[row_col(j)], 0 at or past width: two float4 loads when the row
// is 16-byte aligned and width % 4 == 0 (a float4 then lies all inside the
// row or all past it).
__device__ __forceinline__ void load_row8(float (&v)[8], const float* row, int width) {
  const bool vec = vec4_ok(row, width);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = row_col(4 * h);
    if (vec) {
      const float4 x = c < width ? *reinterpret_cast<const float4*>(row + c)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
      v[4 * h] = x.x, v[4 * h + 1] = x.y, v[4 * h + 2] = x.z, v[4 * h + 3] = x.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[4 * h + j] = c + j < width ? row[c + j] : 0.f;
    }
  }
}

// row[row_col(j)] = v[j] for row_col(j) < width (vectorised as load_row8).
__device__ __forceinline__ void store_row8(float* row, const float (&v)[8], int width) {
  const bool vec = vec4_ok(row, width);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = row_col(4 * h);
    if (vec) {
      if (c < width)
        *reinterpret_cast<float4*>(row + c) =
            make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < width) row[c + j] = v[4 * h + j];
    }
  }
}

// The sum of v over the warp; every lane gets the same bits.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// h[j] = (h[j] - mean) rstd for j's column < width, else 0 (eps 1e-5); returns
// rstd. h is a row of the warp, 0 past width.
__device__ __forceinline__ float normalise(float (&h)[8], int width) {
  const float inv = 1.f / width;
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += h[j];
  const float mean = warp_sum(s) * inv;
  float v = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    h[j] = row_col(j) < width ? h[j] - mean : 0.f;
    v += h[j] * h[j];
  }
  const float rstd = rsqrtf(warp_sum(v) * inv + 1e-5f);
#pragma unroll
  for (int j = 0; j < 8; ++j) h[j] *= rstd;
  return rstd;
}

// dst[c] (c < n_cols) = the sum over the warps of their column partials v
// (lane columns row_col), added in warp order through red; ends in a
// barrier, so red is free again.
__device__ __forceinline__ void warp_colsum(const float (&v)[8], float* red, float* dst,
                                            int n_cols) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 8; ++j) red[warp * NMAX + row_col(j)] = v[j];
  __syncthreads();
  const int c = threadIdx.x;  // THREADS == NMAX
  if (c < n_cols) {
    float s = red[c];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) s += red[w * NMAX + c];
    dst[c] = s;
  }
  __syncthreads();
}

}  // namespace edge_tile
