// The edge-tile machinery shared by the fused edge update's forward
// (edge_mlp.cu: K1 and its partial-product mode K2) and its backward
// (fused_mlp_bwd.cu: K2b), FP32 on the CUDA cores of sm_90a.
//
// A block of THREADS = 256 threads owns a tile of TE = 64 edges of one batch
// entry. Products stream their weight through shared memory in KC = 32-row
// slices, loaded with cp.async. Each thread accumulates an 8-row x 8-column
// register tile: rows 8 * warp + r, columns tile_col(j). Warp w owns rows
// 8w..8w+7 in every product, so a row's statistics are warp shuffles and a
// warp only ever reads back the shared-memory rows it wrote itself.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace edge_tile {

constexpr int TE = 64;        // edges per block
constexpr int KC = 32;        // rows of a weight slice (reduction chunk)
constexpr int NMAX = 256;     // widest layer output (H and Fe)
constexpr int THREADS = 256;  // 8 warps
constexpr int ROWS = TE / (THREADS / 32);  // 8 tile rows per warp

// Hs [TE][NMAX] + Bs [KC][NMAX] + As [TE][KC] floats, then two [TE] index
// arrays: 107 KB, so two blocks fit in an SM's 227 KB.
constexpr size_t kSmemBytes =
    sizeof(float) * (TE * NMAX + KC * NMAX + TE * KC) + sizeof(int) * 2 * TE;

// Asynchronous 4-byte copy global -> shared; writes 0 when !ok (src unread).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}

// Waits for this thread's copies, then for every thread's.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
}

// Bs[kk][n] = W[k0 + kk][n] for k0 + kk < k_end and n < n_cols, else 0.
__device__ __forceinline__ void load_weight_slice(float* Bs, const float* W,
                                                  int k0, int k_end,
                                                  int n_cols) {
  const int n = threadIdx.x;  // THREADS == NMAX: one column per thread
#pragma unroll 8
  for (int kk = 0; kk < KC; ++kk) {
    const int k = k0 + kk;
    const bool ok = k < k_end && n < n_cols;
    cp_async4(Bs + kk * NMAX + n, ok ? W + (long long)k * n_cols + n : W, ok);
  }
}

// acc[r][j] += sum_k A[row_r][k] * B[k][col_j] over one KC slice, where
// row_r = 8 * warp + r and col_j = 4 * lane + j (j < 4), 128 + 4 * lane + j - 4.
__device__ __forceinline__ void mma_slice(float (&acc)[ROWS][8],
                                          const float* A, int lda,
                                          const float* Bs) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k4 = 0; k4 < KC; k4 += 4) {
    float4 a[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      a[r] = *reinterpret_cast<const float4*>(A + (warp * ROWS + r) * lda + k4);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* brow = Bs + (k4 + kk) * NMAX;
      const float4 p = *reinterpret_cast<const float4*>(brow + lane * 4);
      const float4 q = *reinterpret_cast<const float4*>(brow + 128 + lane * 4);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float v = kk == 0 ? a[r].x : kk == 1 ? a[r].y : kk == 2 ? a[r].z : a[r].w;
        acc[r][0] = fmaf(v, p.x, acc[r][0]);
        acc[r][1] = fmaf(v, p.y, acc[r][1]);
        acc[r][2] = fmaf(v, p.z, acc[r][2]);
        acc[r][3] = fmaf(v, p.w, acc[r][3]);
        acc[r][4] = fmaf(v, q.x, acc[r][4]);
        acc[r][5] = fmaf(v, q.y, acc[r][5]);
        acc[r][6] = fmaf(v, q.z, acc[r][6]);
        acc[r][7] = fmaf(v, q.w, acc[r][7]);
      }
    }
  }
}

__device__ __forceinline__ int tile_col(int j) {
  return (j < 4 ? 0 : 128 - 4) + (threadIdx.x & 31) * 4 + j;
}

__device__ __forceinline__ void zero(float (&acc)[ROWS][8]) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
}

// Hs[row][col] = relu(acc + bias) for this thread's tile (zero past n_cols).
__device__ __forceinline__ void store_relu(float* Hs, float (&acc)[ROWS][8],
                                           const float* bias, int n_cols) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = tile_col(j);
    const float bj = c < n_cols ? bias[c] : 0.f;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      Hs[(warp * ROWS + r) * NMAX + c] = fmaxf(acc[r][j] + bj, 0.f);
      acc[r][j] = 0.f;
    }
  }
}

// acc += Hs @ W over k in [0, k_end), W is [k_end, n_cols].
__device__ __forceinline__ void dense_from_smem(float (&acc)[ROWS][8],
                                                const float* Hs, float* Bs,
                                                const float* W, int k_end,
                                                int n_cols) {
  for (int k0 = 0; k0 < k_end; k0 += KC) {
    load_weight_slice(Bs, W, k0, k_end, n_cols);
    cp_async_wait_all();
    mma_slice(acc, Hs + k0, NMAX, Bs);
    __syncthreads();
  }
}

// As[row][kk] = src[node(row)][k0 + kk], node(row) = ids[row], or the edge id
// itself when ids == nullptr; 0 past the row width or the last edge.
__device__ __forceinline__ void gather_slice(float* As, const float* src,
                                             const int* ids, int width, int k0,
                                             int e0, int n_edges) {
  for (int i = threadIdx.x; i < TE * KC; i += THREADS) {
    const int row = i / KC;
    const int k = k0 + i % KC;
    const int edge = e0 + row;
    const bool ok = edge < n_edges && k < width;
    const long long node = ids ? ids[row] : edge;
    cp_async4(As + i, ok ? src + node * width + k : src, ok);
  }
}

// v[j] = row[tile_col(j)] for tile_col(j) < width, else 0: two float4 loads
// when the row is 16-byte aligned and width % 4 == 0 (a float4 then lies all
// inside the row or all past it).
__device__ __forceinline__ void load_row8(float (&v)[8], const float* row,
                                          int width) {
  const bool vec = (width & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(row) & 15) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = tile_col(4 * h);
    if (vec) {
      const float4 q = c < width ? *reinterpret_cast<const float4*>(row + c)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
      v[4 * h] = q.x, v[4 * h + 1] = q.y, v[4 * h + 2] = q.z, v[4 * h + 3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[4 * h + j] = c + j < width ? row[c + j] : 0.f;
    }
  }
}

// row[tile_col(j)] = v[j] for tile_col(j) < width (vectorised as load_row8).
__device__ __forceinline__ void store_row8(float* row, const float (&v)[8],
                                           int width) {
  const bool vec = (width & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(row) & 15) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = tile_col(4 * h);
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

// acc[r][j] = p_src[s(row)][c] + p_dst[r(row)][c] (no p_dst when nullptr),
// for c = tile_col(j) < width; 0 elsewhere. Rows are the [N, width] node
// partial products; sidx/ridx the tile's node ids (0 past the last edge).
__device__ __forceinline__ void init_from_partials(float (&acc)[ROWS][8],
                                                   const float* p_src,
                                                   const float* p_dst,
                                                   const int* sidx,
                                                   const int* ridx, int width) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = warp * ROWS + r;
    load_row8(acc[r], p_src + (long long)sidx[row] * width, width);
    if (p_dst != nullptr) {
      float d[8];
      load_row8(d, p_dst + (long long)ridx[row] * width, width);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[r][j] += d[j];
    }
  }
}

}  // namespace edge_tile
