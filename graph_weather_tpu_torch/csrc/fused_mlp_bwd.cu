// Backward of the fused MeshGraphNet edge update (K2b) for Hopper (sm_90a),
// FP32 on the CUDA cores.
//
// The forward is K2, the partial-product mode of edge_mlp.cu (the port of
// graph_weather_tpu/ops/pallas/fused_mlp.py: _kernel, _fused_padded). For
// every edge (s, r) and batch entry b:
//
//     h0 = relu(p_src[b, s] + p_dst[b, r] + e[b, edge] We + b0)
//     h1 = relu(h0 W1 + b1)
//     h2 = h1 W2 + b2
//     e' = LayerNorm(h2) * gamma + beta + e[b, edge]      (eps 1e-5)
//
// The JAX package has no Pallas backward for it (XLA differentiates its
// EdgeBlock); this kernel is the per-edge chain of that gradient. Given dout
// = dL/de', for each tile of TE = 64 edges of one batch entry it
//
//   * recomputes h0 and h1 (written out, with 64-bit ReLU masks of the
//     thread's 8 x 8 tile kept in registers) and h2 with its LayerNorm
//     statistics;
//   * forms dh2 by the LayerNorm backward, rstd (g - mean(g) - n mean(g n))
//     with g = dout gamma and n the normalised h2, as warp shuffles (dh2 =
//     dout without the LayerNorm);
//   * computes dh1 = (dh2 W2^T) [h1 > 0], dh0 = (dh1 W1^T) [h0 > 0] and
//     de = dout + dh0 We^T;
//   * writes h0, h1, dh2, dh1, dh0 and de as [B, E, width] rows, and per
//     tile the column sums of dh0, dh1, dh2, dout n and dout (the bias,
//     gamma and beta gradients), added across warps in a fixed order.
//
// The caller finishes with plain products and sums: the weight gradients
// h1^T dh2, h0^T dh1 and e^T dh0 over the B E rows, the per-tile sums added
// in a fixed order (no atomics anywhere), and dh0 summed to the sender and
// receiver nodes. The transposed weights W2^T, W1^T and We^T come as
// contiguous copies, so the same slice loader and product serve all six
// products.
//
// What bounds it on an H100: 6 products per edge, 2 * 2 * (Fe H + H H + H Fe)
// flops, against about 11 rows of 1 KB moved per edge at width 256 (p_src
// and p_dst rows, e, dout, and the seven rows written): ~70 flops per byte,
// above the FP32 balance point of ~20, so the products bound it. Shared
// memory is K1's: one [64, 256] buffer holds h0, then h1, then dh2, dh1 and
// dh0 in turn (each warp rewrites only its own rows), so two blocks still
// share an SM.

#include "edge_tile.cuh"

namespace {

using namespace edge_tile;

// Slots of the per-tile column sums: [kSlots][B * n_tiles][NMAX].
enum Slot { kB0 = 0, kB1, kB2, kGamma, kBeta, kSlots };

struct Params {
  const int* senders;
  const int* receivers;
  const float* p_src;
  const float* p_dst;
  const float* e;
  const float* dout;
  const float* we;
  const float* b0;
  const float* w1;
  const float* b1;
  const float* w2;
  const float* b2;
  const float* gamma;
  const float* w2t;  // [Fe, H]
  const float* w1t;  // [H, H]
  const float* wet;  // [H, Fe]
  float* h0;
  float* h1;
  float* dh2;
  float* dh1;
  float* dh0;
  float* de;
  float* colsum;
  long long ps_bstride;
  long long pd_bstride;
  long long e_bstride;
  int n_edges;
  int f_e;
  int hidden;
};

// Column sums of v over the block's 64 rows into dst[0, n_cols): each thread
// sums its 8 rows, then thread c adds the 8 warps' partials of column c in
// order, through red ([8][NMAX] floats of shared memory).
__device__ __forceinline__ void block_colsum(const float (&part)[8], float* red,
                                             float* dst, int n_cols) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 8; ++j) red[warp * NMAX + tile_col(j)] = part[j];
  __syncthreads();
  const int c = threadIdx.x;  // THREADS == NMAX
  if (c < n_cols) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) s += red[w * NMAX + c];
    dst[c] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ void tile_colsum(const float (&acc)[ROWS][8],
                                            float* red, float* dst,
                                            int n_cols) {
  float part[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    part[j] = 0.f;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) part[j] += acc[r][j];
  }
  block_colsum(part, red, dst, n_cols);
}

// Hs rows (and the global [E, width] rows `out` of the tile's valid edges)
// = acc, which is zero past `width`; then acc = 0.
__device__ __forceinline__ void store_rows(float* Hs, float (&acc)[ROWS][8],
                                           float* out, int width, int e0,
                                           int n_edges) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = warp * ROWS + r;
#pragma unroll
    for (int j = 0; j < 8; ++j) Hs[row * NMAX + tile_col(j)] = acc[r][j];
    if (e0 + row < n_edges)
      store_row8(out + (long long)(e0 + row) * width, acc[r], width);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
  }
}

// acc = relu(acc + bias) (zero past n_cols), stored as store_rows does;
// returns the mask of positive entries, bit 8 r + j.
__device__ __forceinline__ unsigned long long store_relu_rows(
    float* Hs, float (&acc)[ROWS][8], const float* bias, float* out,
    int n_cols, int e0, int n_edges) {
  unsigned long long mask = 0ull;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = tile_col(j);
    const float bj = c < n_cols ? bias[c] : 0.f;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float v = c < n_cols ? fmaxf(acc[r][j] + bj, 0.f) : 0.f;
      acc[r][j] = v;
      if (v > 0.f) mask |= 1ull << (8 * r + j);
    }
  }
  store_rows(Hs, acc, out, n_cols, e0, n_edges);
  return mask;
}

__device__ __forceinline__ void apply_mask(float (&acc)[ROWS][8],
                                           unsigned long long mask) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (!((mask >> (8 * r + j)) & 1ull)) acc[r][j] = 0.f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(THREADS, 2)
    fused_mlp_bwd_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* Hs = reinterpret_cast<float*>(smem4);  // [TE][NMAX] h0, h1, dh2, dh1, dh0
  float* Bs = Hs + TE * NMAX;                   // [KC][NMAX] weight slice; column-sum scratch
  float* As = Bs + KC * NMAX;                   // [TE][KC] e slice
  int* sidx = reinterpret_cast<int*>(As + TE * KC);
  int* ridx = sidx + TE;

  const int b = blockIdx.y;
  const int e0 = blockIdx.x * TE;
  const int n_tiles = gridDim.x * gridDim.y;
  const int tile = b * gridDim.x + blockIdx.x;
  if (threadIdx.x < TE) {
    const int edge = e0 + threadIdx.x;
    sidx[threadIdx.x] = edge < p.n_edges ? p.senders[edge] : 0;
    ridx[threadIdx.x] = edge < p.n_edges ? p.receivers[edge] : 0;
  }
  __syncthreads();

  const long long rows_b = (long long)b * p.n_edges;  // first row of batch b
  const long long h_off = rows_b * p.hidden;
  const long long fe_off = rows_b * p.f_e;
  const float* e_b = p.e + b * p.e_bstride;
  const float* dout_b = p.dout + fe_off;
  float* col = p.colsum + (long long)tile * NMAX;
  const long long slot = (long long)n_tiles * NMAX;

  // Recompute h0 = relu(p_src[s] + p_dst[r] + e We + b0) and h1.
  float acc[ROWS][8];
  init_from_partials(acc, p.p_src + b * p.ps_bstride,
                     p.p_dst ? p.p_dst + b * p.pd_bstride : nullptr, sidx, ridx,
                     p.hidden);
  const float* e_tile = e_b + (long long)e0 * p.f_e;
  for (int k0 = 0; k0 < p.f_e; k0 += KC) {
    gather_slice(As, e_tile, nullptr, p.f_e, k0, 0, p.n_edges - e0);
    load_weight_slice(Bs, p.we, k0, p.f_e, p.hidden);
    cp_async_wait_all();
    mma_slice(acc, As, KC, Bs);
    __syncthreads();
  }
  const unsigned long long m0 =
      store_relu_rows(Hs, acc, p.b0, p.h0 + h_off, p.hidden, e0, p.n_edges);
  dense_from_smem(acc, Hs, Bs, p.w1, p.hidden, p.hidden);
  const unsigned long long m1 =
      store_relu_rows(Hs, acc, p.b1, p.h1 + h_off, p.hidden, e0, p.n_edges);
  dense_from_smem(acc, Hs, Bs, p.w2, p.hidden, p.f_e);

  // dh2 by the LayerNorm backward, in place of h2 - b2 in acc; with the
  // tile's sums of dout n (gamma) and dout (beta).
  const int warp = threadIdx.x >> 5;
  const float inv_fe = 1.f / p.f_e;
  float sum_dn[8], sum_d[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) sum_dn[j] = sum_d[j] = 0.f;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int edge = e0 + warp * ROWS + r;
    float d[8];
    if (edge < p.n_edges) {
      load_row8(d, dout_b + (long long)edge * p.f_e, p.f_e);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) d[j] = 0.f;
    }
    if (p.gamma == nullptr) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[r][j] = d[j];
      continue;
    }
    float h[8];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tile_col(j);
      h[j] = c < p.f_e ? acc[r][j] + p.b2[c] : 0.f;
      sum += h[j];
    }
    const float mean = warp_sum(sum) * inv_fe;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      h[j] = tile_col(j) < p.f_e ? h[j] - mean : 0.f;
      sq += h[j] * h[j];
    }
    const float rstd = rsqrtf(warp_sum(sq) * inv_fe + 1e-5f);
    float g_sum = 0.f, gn_sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tile_col(j);
      h[j] *= rstd;  // n, 0 past f_e
      sum_dn[j] += d[j] * h[j];
      sum_d[j] += d[j];
      d[j] *= c < p.f_e ? p.gamma[c] : 0.f;  // g
      g_sum += d[j];
      gn_sum += d[j] * h[j];
    }
    const float g_mean = warp_sum(g_sum) * inv_fe;
    const float gn_mean = warp_sum(gn_sum) * inv_fe;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[r][j] = tile_col(j) < p.f_e ? rstd * (d[j] - g_mean - h[j] * gn_mean) : 0.f;
  }
  if (p.gamma != nullptr) {
    block_colsum(sum_dn, Bs, col + kGamma * slot, p.f_e);
    block_colsum(sum_d, Bs, col + kBeta * slot, p.f_e);
  }
  tile_colsum(acc, Bs, col + kB2 * slot, p.f_e);
  store_rows(Hs, acc, p.dh2 + fe_off, p.f_e, e0, p.n_edges);

  // dh1 = (dh2 W2^T) [h1 > 0]
  dense_from_smem(acc, Hs, Bs, p.w2t, p.f_e, p.hidden);
  apply_mask(acc, m1);
  tile_colsum(acc, Bs, col + kB1 * slot, p.hidden);
  store_rows(Hs, acc, p.dh1 + h_off, p.hidden, e0, p.n_edges);

  // dh0 = (dh1 W1^T) [h0 > 0]
  dense_from_smem(acc, Hs, Bs, p.w1t, p.hidden, p.hidden);
  apply_mask(acc, m0);
  tile_colsum(acc, Bs, col + kB0 * slot, p.hidden);
  store_rows(Hs, acc, p.dh0 + h_off, p.hidden, e0, p.n_edges);

  // de = dout + dh0 We^T
  dense_from_smem(acc, Hs, Bs, p.wet, p.hidden, p.f_e);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int edge = e0 + warp * ROWS + r;
    if (edge >= p.n_edges) continue;
    float d[8];
    load_row8(d, dout_b + (long long)edge * p.f_e, p.f_e);
#pragma unroll
    for (int j = 0; j < 8; ++j) d[j] += acc[r][j];
    store_row8(p.de + fe_off + (long long)edge * p.f_e, d, p.f_e);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() after launch.
// p_dst == nullptr: no destination term; gamma == nullptr: no LayerNorm (the
// gamma and beta column sums are then not written). dout and the outputs
// h0, h1, dh1, dh0 [B, E, hidden] and dh2, de [B, E, f_e] are contiguous;
// colsum is [5][B * ceil(E / 64)][256] (slots b0, b1, b2, gamma, beta).
extern "C" int gwt_fused_mlp_backward(
    const int* senders, const int* receivers, const float* p_src,
    long long ps_bstride, const float* p_dst, long long pd_bstride,
    const float* e, long long e_bstride, const float* dout, const float* we,
    const float* b0, const float* w1, const float* b1, const float* w2,
    const float* b2, const float* gamma, const float* w2t, const float* w1t,
    const float* wet, float* h0, float* h1, float* dh2, float* dh1, float* dh0,
    float* de, float* colsum, int n_edges, int batch, int f_e, int hidden,
    void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const Params p{senders, receivers, p_src, p_dst, e, dout, we, b0, w1, b1,
                 w2, b2, gamma, w2t, w1t, wet, h0, h1, dh2, dh1, dh0, de,
                 colsum, ps_bstride, pd_bstride, e_bstride, n_edges, f_e,
                 hidden};
  dim3 grid((n_edges + TE - 1) / TE, batch);
  fused_mlp_bwd_kernel<<<grid, THREADS, kSmemBytes,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
