// Backward of the fused MeshGraphNet edge update (K2b) for Hopper (sm_90a),
// split-TF32 products on the tensor cores.
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
//   * recomputes h0 and h1 (written out; their ReLU masks kept as one 64-bit
//     word each of the thread's accumulators) and h2;
//   * forms dh2 by the LayerNorm backward, row by row from h2 in shared
//     memory, rstd (g - mean(g) - n mean(g n)) with g = dout gamma and n the
//     normalised h2 (dh2 = dout without the LayerNorm);
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
// contiguous copies, so one slice stream and one product serve all six
// products.
//
// What bounds it on an H100: 6 products per edge, 2 * 2 * (Fe H + H H + H Fe)
// flops, against 12 rows of 1 KB moved per edge at width 256 (the p_src and
// p_dst rows, e, dout and the six rows written): ~65 flops per byte, above
// the FP32 balance point of ~20, so the products bound it: 10.4 ms a
// 1-degree train step at the FP32 peak, 4.2 ms as three TF32 products at the
// tensor cores' dense peak. The tiles, the slice stream and the split-TF32
// products are K2's (edge_tile.cuh): one shared [64, 256] buffer holds e,
// then h0, h1, h2, dh2, dh1 and dh0 in turn, so two blocks share an SM.
//
// bf16 (K2b on bf16 operands, the bf16 compute policy). A second kernel body
// over K2's bf16 tiles (edge_tile.cuh: one bf16 m16n8k16 mma.sync per
// product, f32 accumulators) recomputes the chain with the bf16 forward's
// roundings and differentiates it as XLA differentiates the JAX package's
// bf16 EdgeBlock: dh2 by flax's LayerNorm backward in f32 (the fast
// variance), its two parts (through x's centred and statistics upcasts)
// each rounded and added in bf16; dh1 = bf16(dh2 W2^T) [h1 > 0], dh0 =
// bf16(dh1 W1^T) [h0 > 0], de = bf16(dout + bf16(dh0 We^T)). h0, h1, dh2,
// dh1, dh0 and de are written in bf16, the per-tile column sums in f32 (of
// the bf16 values; the LayerNorm's of its f32 terms). 698 GFLOP a 1-degree
// train step is 0.71 ms at the BF16 peak, against ~4.3 GB of rows, 1.29
// ms: bytes bound it.

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

// The kernel's products (edge_tile.cuh's stream) in order: We, W1, W2 (the
// forward again), then W2^T, W1^T and We^T.
__device__ __forceinline__ int product_count(const Params&) { return 6; }

__device__ __forceinline__ Prod product(const Params& p, int i) {
  switch (i) {
    case 0: return {p.we, p.f_e, p.hidden};
    case 1: return {p.w1, p.hidden, p.hidden};
    case 2: return {p.w2, p.hidden, p.f_e};
    case 3: return {p.w2t, p.f_e, p.hidden};
    case 4: return {p.w1t, p.hidden, p.hidden};
    default: return {p.wet, p.hidden, p.f_e};
  }
}

// Where this block's rows of a [B, E, width] output and its column sums
// begin; recomputed at each use (opaque) rather than kept live across the
// product loops.
template <class P>
__device__ __forceinline__ long long batch_row(const P& p) {
  return (long long)opaque(blockIdx.y) * p.n_edges;
}
template <class P>
__device__ __forceinline__ float* colsum_of(const P& p, Slot slot) {
  const int tile = opaque(blockIdx.y * gridDim.x + blockIdx.x);
  return p.colsum + ((long long)slot * gridDim.x * gridDim.y + tile) * NMAX;
}

// dh2 by the LayerNorm backward, row by row from h2 in H (the warp's rows;
// 0 past f_e): written over h2 in H (0 on the rows past the last edge) and
// to p.dh2, with the tile's column sums of dout n (gamma), dout (beta) and
// dh2 (b2). Without gamma, dh2 = dout.
__device__ __forceinline__ void layernorm_backward(const Params& p, const Smem& sm, int e0) {
  const float* dout_b = p.dout + batch_row(p) * p.f_e;
  float* dh2_b = p.dh2 + batch_row(p) * p.f_e;
  float gm[8], cdn[8], cd[8], cb2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) cdn[j] = cd[j] = cb2[j] = 0.f;
  if (p.gamma != nullptr) load_row8(gm, p.gamma, p.f_e);
  const float inv = 1.f / p.f_e;
  const int first = opaque(e0 + (threadIdx.x >> 5) * ROWS);
  for (int r = 0; r < ROWS; ++r) {
    const int edge = first + r, row = edge - e0;
    float d[8], h[8];
    if (edge < p.n_edges) {
      load_row8(d, dout_b + (long long)edge * p.f_e, p.f_e);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) d[j] = 0.f;
    }
    if (p.gamma != nullptr) {
      load_row8(h, sm.H + row * LDA, NMAX);
      const float rstd = normalise(h, p.f_e);  // h = n, 0 past f_e
      float gs = 0.f, gns = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        cdn[j] += d[j] * h[j];
        cd[j] += d[j];
        d[j] *= gm[j];  // g
        gs += d[j];
        gns += d[j] * h[j];
      }
      const float g_mean = warp_sum(gs) * inv, gn_mean = warp_sum(gns) * inv;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        d[j] = row_col(j) < p.f_e ? rstd * (d[j] - g_mean - h[j] * gn_mean) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) cb2[j] += d[j];
    store_row8(sm.H + row * LDA, d, NMAX);
    if (edge < p.n_edges) store_row8(dh2_b + (long long)edge * p.f_e, d, p.f_e);
  }
  if (p.gamma != nullptr) {
    warp_colsum(cdn, sm.red, colsum_of(p, kGamma), p.f_e);
    warp_colsum(cd, sm.red, colsum_of(p, kBeta), p.f_e);
  }
  warp_colsum(cb2, sm.red, colsum_of(p, kB2), p.f_e);
}

__global__ void __launch_bounds__(THREADS, kBlocksPerSM) fused_mlp_bwd_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  const Smem sm = carve(smem4);
  const Place q = place();
  const int b = blockIdx.y;
  const int e0 = blockIdx.x * TE;
  if (threadIdx.x < TE) {
    const int edge = e0 + threadIdx.x;
    sm.sidx[threadIdx.x] = edge < p.n_edges ? p.senders[edge] : 0;
    sm.ridx[threadIdx.x] = edge < p.n_edges ? p.receivers[edge] : 0;
  }
  __syncthreads();

  // Recompute h0 = relu(p_src[s] + p_dst[r] + e We + b0) and h1.
  stage_rows(sm.H, p.e + b * p.e_bstride + (long long)e0 * p.f_e, nullptr, p.f_e, 0, p.f_e,
             p.n_edges - e0);
  Stream s = start(p, sm.ring);
  Acc acc;
  init_from_partials(acc, q, p.p_src + b * p.ps_bstride,
                     p.p_dst ? p.p_dst + b * p.pd_bstride : nullptr, sm.sidx, sm.ridx, p.hidden);
  dense(acc, q, sm.H, p, s, sm.ring, product(p, 0));
  __syncthreads();
  const unsigned long long m0 = add_bias(acc, q, p.b0, p.hidden, true);
  store_rows(sm.H, acc, q, p.h0 + batch_row(p) * p.hidden, p.hidden, e0, p.n_edges);
  dense(acc, q, sm.H, p, s, sm.ring, product(p, 1));
  __syncthreads();
  const unsigned long long m1 = add_bias(acc, q, p.b1, p.hidden, true);
  store_rows(sm.H, acc, q, p.h1 + batch_row(p) * p.hidden, p.hidden, e0, p.n_edges);
  dense(acc, q, sm.H, p, s, sm.ring, product(p, 2));

  // h2 = acc + b2 into H; dh2 by the LayerNorm backward, with the tile's
  // sums of dout n (gamma), dout (beta) and dh2 (b2).
  __syncthreads();
  add_bias(acc, q, p.b2, p.f_e, false);
  store_rows(sm.H, acc, q, nullptr, 0, e0, p.n_edges);
  __syncthreads();
  layernorm_backward(p, sm, e0);

  // dh1 = (dh2 W2^T) [h1 > 0]
  dense(acc, q, sm.H, p, s, sm.ring, product(p, 3));
  apply_mask(acc, m1);
  acc_colsum(acc, q, sm.red, 0, colsum_of(p, kB1), p.hidden);
  store_rows(sm.H, acc, q, p.dh1 + batch_row(p) * p.hidden, p.hidden, e0, p.n_edges);

  // dh0 = (dh1 W1^T) [h0 > 0]
  dense(acc, q, sm.H, p, s, sm.ring, product(p, 4));
  apply_mask(acc, m0);
  acc_colsum(acc, q, sm.red, 1, colsum_of(p, kB0), p.hidden);
  store_rows(sm.H, acc, q, p.dh0 + batch_row(p) * p.hidden, p.hidden, e0, p.n_edges);

  // de = dout + dh0 We^T
  dense(acc, q, sm.H, p, s, sm.ring, product(p, 5));
  const float* dout_b = p.dout + batch_row(p) * p.f_e;
  float* de_b = p.de + batch_row(p) * p.f_e;
  const bool vd = vec2_ok(dout_b, p.f_e), vo = vec2_ok(de_b, p.f_e);
  const int first = opaque(e0 + q.row0 + q.g), col = opaque(acc_col(q, 0));
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int edge = first + 16 * mt + 8 * h;
      fence_loads();
      if (edge >= p.n_edges) continue;
      const float* d_row = dout_b + (long long)edge * p.f_e;
      float* o_row = de_b + (long long)edge * p.f_e;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = col + 8 * nt;
        const float2 d = load2(d_row, c, p.f_e, vd);
        store2(o_row, c, p.f_e, vo, d.x + acc[mt][nt][2 * h], d.y + acc[mt][nt][2 * h + 1]);
      }
    }
}

// --- bf16 (K2b on bf16 operands) --------------------------------------------------

struct Params16 {
  const int* senders;
  const int* receivers;
  const bf16* p_src;
  const bf16* p_dst;
  const bf16* e;
  const bf16* dout;
  const bf16* we;
  const bf16* b0;
  const bf16* w1;
  const bf16* b1;
  const bf16* w2;
  const bf16* b2;
  const bf16* gamma;
  const bf16* w2t;
  const bf16* w1t;
  const bf16* wet;
  bf16* h0;
  bf16* h1;
  bf16* dh2;
  bf16* dh1;
  bf16* dh0;
  bf16* de;
  float* colsum;
  long long ps_bstride;
  long long pd_bstride;
  long long e_bstride;
  int n_edges;
  int f_e;
  int hidden;
};

__device__ __forceinline__ int product_count(const Params16&) { return 6; }

__device__ __forceinline__ Prod16 product(const Params16& p, int i) {
  switch (i) {
    case 0: return {p.we, p.f_e, p.hidden};
    case 1: return {p.w1, p.hidden, p.hidden};
    case 2: return {p.w2, p.hidden, p.f_e};
    case 3: return {p.w2t, p.f_e, p.hidden};
    case 4: return {p.w1t, p.hidden, p.hidden};
    default: return {p.wet, p.hidden, p.f_e};
  }
}

// dh2 by flax's LayerNorm backward under the bf16 policy, row by row from
// h1 W2 (bf16, in H) + b2 in f32, as nn.bf16.layer_norm_backward: the fast
// variance max(0, mean(x^2) - mean(x)^2); the parts through x's centred and
// statistics upcasts each rounded to bf16, then added in bf16. Written
// over H's row (0 on the rows past the last edge) and to p.dh2, with the
// tile's column sums of dout (x - mean) r (gamma), dout (beta) and dh2
// (b2). Without gamma, dh2 = dout.
__device__ __forceinline__ void layernorm_backward16(const Params16& p, const Smem16& sm, int e0) {
  const bf16* dout_b = p.dout + batch_row(p) * p.f_e;
  bf16* dh2_b = p.dh2 + batch_row(p) * p.f_e;
  float gm[8], b2[8], cdn[8], cd[8], cb2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) cdn[j] = cd[j] = cb2[j] = 0.f;
  if (p.gamma != nullptr) {
    load_row8(gm, p.gamma, p.f_e);
    load_row8(b2, p.b2, p.f_e);
  }
  const float n = (float)p.f_e;
  const int first = opaque(e0 + (threadIdx.x >> 5) * ROWS);
  for (int r = 0; r < ROWS; ++r) {
    const int edge = first + r, row = edge - e0;
    float d[8];
    if (edge < p.n_edges) {
      load_row8(d, dout_b + (long long)edge * p.f_e, p.f_e);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) d[j] = 0.f;
    }
    if (p.gamma != nullptr) {
      float x[8], s = 0.f, s2 = 0.f;
      load_row8(x, sm.H + row * LDA16, NMAX);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        x[j] += b2[j];  // 0 past f_e
        s += x[j];
        s2 += x[j] * x[j];
      }
      const float mean = warp_sum(s) / n;
      const float var = fmaxf(warp_sum(s2) / n - mean * mean, 0.f);
      const float rr = rsqrtf(var + 1e-5f);
      float dc[8], c[8], sdc = 0.f, sdr = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = row_col(j) < p.f_e ? x[j] - mean : 0.f;
        dc[j] = d[j] * (rr * gm[j]);  // through the centred upcast
        sdc += dc[j];
        sdr += d[j] * c[j] * gm[j];
        cdn[j] += d[j] * c[j] * rr;
        cd[j] += d[j];
      }
      const float d_var = var > 0.f ? -0.5f * warp_sum(sdr) * (rr * rr * rr) : 0.f;
      const float d_mean = -warp_sum(sdc) - 2.f * mean * d_var;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float stats = (2.f * x[j] * d_var + d_mean) / n;  // through the statistics' upcast
        d[j] = row_col(j) < p.f_e ? round16(round16(dc[j]) + round16(stats)) : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) cb2[j] += d[j];
    store_row8(sm.H + row * LDA16, d, NMAX);
    if (edge < p.n_edges) store_row8(dh2_b + (long long)edge * p.f_e, d, p.f_e);
  }
  if (p.gamma != nullptr) {
    warp_colsum(cdn, sm.red, colsum_of(p, kGamma), p.f_e);
    warp_colsum(cd, sm.red, colsum_of(p, kBeta), p.f_e);
  }
  warp_colsum(cb2, sm.red, colsum_of(p, kB2), p.f_e);
}

__global__ void __launch_bounds__(THREADS, kBlocksPerSM16)
    fused_mlp_bwd_bf16_kernel(const Params16 p) {
  extern __shared__ float4 smem4[];
  const Smem16 sm = carve16(smem4);
  const Place q = place();
  const int b = blockIdx.y;
  const int e0 = blockIdx.x * TE;
  if (threadIdx.x < TE) {
    const int edge = e0 + threadIdx.x;
    sm.sidx[threadIdx.x] = edge < p.n_edges ? p.senders[edge] : 0;
    sm.ridx[threadIdx.x] = edge < p.n_edges ? p.receivers[edge] : 0;
  }
  __syncthreads();

  // Recompute h0 and h1 with the bf16 forward's roundings (edge_mlp.cu).
  stage_rows(sm.H, p.e + b * p.e_bstride + (long long)e0 * p.f_e, p.f_e, p.n_edges - e0);
  Stream s = start(p, sm.ring);
  Acc acc;
  zero(acc);
  dense(acc, q, sm.H, p, s, sm.ring, product(p, 0));
  __syncthreads();
  const unsigned long long m0 =
      first_layer16(acc, q, p.p_src + b * p.ps_bstride,
                    p.p_dst ? p.p_dst + b * p.pd_bstride : nullptr, sm.sidx, sm.ridx, p.b0,
                    p.hidden);
  store_rows(sm.H, acc, q, p.h0 + batch_row(p) * p.hidden, p.hidden, e0, p.n_edges);
  dense(acc, q, sm.H, p, s, sm.ring, product(p, 1));
  __syncthreads();
  const unsigned long long m1 = add_bias_relu16(acc, q, p.b1, p.hidden);
  store_rows(sm.H, acc, q, p.h1 + batch_row(p) * p.hidden, p.hidden, e0, p.n_edges);
  dense(acc, q, sm.H, p, s, sm.ring, product(p, 2));

  // h1 W2 (rounded) into H; dh2 by the LayerNorm backward.
  __syncthreads();
  store_rows(sm.H, acc, q, nullptr, 0, e0, p.n_edges);
  __syncthreads();
  layernorm_backward16(p, sm, e0);

  // dh1 = bf16(dh2 W2^T) [h1 > 0]
  dense(acc, q, sm.H, p, s, sm.ring, product(p, 3));
  round_acc(acc);
  apply_mask(acc, m1);
  acc_colsum(acc, q, sm.red, 0, colsum_of(p, kB1), p.hidden);
  store_rows(sm.H, acc, q, p.dh1 + batch_row(p) * p.hidden, p.hidden, e0, p.n_edges);

  // dh0 = bf16(dh1 W1^T) [h0 > 0]
  dense(acc, q, sm.H, p, s, sm.ring, product(p, 4));
  round_acc(acc);
  apply_mask(acc, m0);
  acc_colsum(acc, q, sm.red, 1, colsum_of(p, kB0), p.hidden);
  store_rows(sm.H, acc, q, p.dh0 + batch_row(p) * p.hidden, p.hidden, e0, p.n_edges);

  // de = bf16(dout + bf16(dh0 We^T))
  dense(acc, q, sm.H, p, s, sm.ring, product(p, 5));
  const bf16* dout_b = p.dout + batch_row(p) * p.f_e;
  bf16* de_b = p.de + batch_row(p) * p.f_e;
  const bool vd = pair_ok(dout_b, p.f_e), vo = pair_ok(de_b, p.f_e);
  const int first = opaque(e0 + q.row0 + q.g), col = opaque(acc_col(q, 0));
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int edge = first + 16 * mt + 8 * h;
      fence_loads();
      if (edge >= p.n_edges) continue;
      const bf16* d_row = dout_b + (long long)edge * p.f_e;
      bf16* o_row = de_b + (long long)edge * p.f_e;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = col + 8 * nt;
        const float2 d = load2(d_row, c, p.f_e, vd);
        store2(o_row, c, p.f_e, vo, d.x + round16(acc[mt][nt][2 * h]),
               d.y + round16(acc[mt][nt][2 * h + 1]));
      }
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

// bf16 (K2b on bf16 operands): every tensor argument but the indices and
// colsum bf16; the arguments as gwt_fused_mlp_backward's.
extern "C" int gwt_fused_mlp_backward_bf16(
    const int* senders, const int* receivers, const __nv_bfloat16* p_src,
    long long ps_bstride, const __nv_bfloat16* p_dst, long long pd_bstride,
    const __nv_bfloat16* e, long long e_bstride, const __nv_bfloat16* dout,
    const __nv_bfloat16* we, const __nv_bfloat16* b0, const __nv_bfloat16* w1,
    const __nv_bfloat16* b1, const __nv_bfloat16* w2, const __nv_bfloat16* b2,
    const __nv_bfloat16* gamma, const __nv_bfloat16* w2t, const __nv_bfloat16* w1t,
    const __nv_bfloat16* wet, __nv_bfloat16* h0, __nv_bfloat16* h1, __nv_bfloat16* dh2,
    __nv_bfloat16* dh1, __nv_bfloat16* dh0, __nv_bfloat16* de, float* colsum, int n_edges,
    int batch, int f_e, int hidden, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_bwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes16);
  if (err != cudaSuccess) return (int)err;
  const Params16 p{senders, receivers, p_src, p_dst, e, dout, we, b0, w1, b1,
                   w2, b2, gamma, w2t, w1t, wet, h0, h1, dh2, dh1, dh0, de,
                   colsum, ps_bstride, pd_bstride, e_bstride, n_edges, f_e,
                   hidden};
  dim3 grid((n_edges + TE - 1) / TE, batch);
  fused_mlp_bwd_bf16_kernel<<<grid, THREADS, kSmemBytes16,
                              static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
