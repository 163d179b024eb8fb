// Fused MeshGraphNet edge update for Hopper (sm_90a), FP32 on the CUDA cores.
//
// Replaces the Pallas TPU kernel graph_weather_tpu/ops/pallas/edge_mlp.py:
// _kernel (launched by _fused_edge_mlp_padded). For every edge (s, r) of a
// destination-sorted graph, and every batch entry b:
//
//     h0 = relu(x_src[b, s] Ws + x_dst[b, r] Wd + e[b, edge] We + b0)
//     h1 = relu(h0 W1 + b1)
//     h2 = h1 W2 + b2
//     e' = LayerNorm(h2) * gamma + beta + e[b, edge]      (eps 1e-5)
//
// with [Ws; Wd; We] = W0, the [F_src + F_dst + F_e, H] kernel of the flax
// TorchLinear_0. x_dst == nullptr skips the Wd term (destination nodes known
// to be zero); gamma == nullptr skips the LayerNorm. A batch stride of 0
// broadcasts an operand over the batch without materialising it.
//
// What bounds it on an H100. Per edge it reads one gathered row of x_src and
// of x_dst and one row of e, and writes one row of e' (4 rows of 1 KB at
// width 256), and does 2 * (3 * F * H + H * H + H * Fe) flops: about 160
// flops per byte, where the card's FP32 balance point is about 20, so the
// three products, not the bytes, are the bound at full width. The TPU kernel kept both node arrays and all weights resident
// in VMEM; here a 64,800 x 256 f32 node array is 66 MB and one 256 x 256
// weight is 256 KB, while a block has at most 227 KB of shared memory. So:
//
//   * a block owns a tile of TE = 64 edges of one batch entry and gathers
//     their rows from global memory itself (the gather Mosaic could not do);
//   * weights stream through shared memory in KC = 32-row slices over the
//     reduction axis (all blocks read the same 1.3 MB, which stays in L2);
//   * every copy into shared memory is a cp.async, so all of a slice's
//     loads are in flight at once without holding registers, and the
//     launch bounds cap a thread at 128 registers, so two blocks share an
//     SM and one computes while the other waits for its slice (measured on
//     an H100 at 700 W: 1.7x faster than register-staged loads at one
//     block per SM);
//   * h0 and h1 live in one shared [64, 256] buffer, h2 in registers: no
//     [E, H] intermediate touches device memory; only e' is written;
//   * each thread accumulates an 8-row x 8-column register tile, with A read
//     as broadcast float4 and B as conflict-free float4, so the FMA units,
//     not shared-memory traffic, set the pace;
//   * warp w owns rows 8w..8w+7 of the tile in all three products, so the
//     LayerNorm row statistics are warp shuffles over registers.
//
// Partial-product mode (K2). It replaces the Pallas TPU kernel
// graph_weather_tpu/ops/pallas/fused_mlp.py: _kernel (launched by
// _fused_padded), which takes the first layer's node terms as partial
// products already gathered per edge. Here the caller makes p_src = x_src Ws
// and p_dst = x_dst Wd once per node (N << E, plain GEMMs), and the kernel
// gathers their rows itself: the tile's accumulator starts from
// p_src[s] + p_dst[r] (each thread adds its 8 x 8 entries from global
// memory), and only We's slices run through the slice loop before W1, W2,
// the LayerNorm and the residual, as above. That is 3 products per edge
// where raw mode does 5 (4 without x_dst): 2 * (Fe * H + H * H + H * Fe)
// flops per edge. Its backward is K2b (fused_mlp_bwd.cu).
//
// Widths up to 256 are accepted; narrower layers run on zero-padded tiles.
// Not yet here: wgmma/TMA and bf16. The helpers are in edge_tile.cuh.

#include "edge_tile.cuh"

namespace {

using namespace edge_tile;

struct Params {
  const int* senders;
  const int* receivers;
  const float* x_src;
  const float* x_dst;
  const float* e;
  const float* w0;
  const float* b0;
  const float* w1;
  const float* b1;
  const float* w2;
  const float* b2;
  const float* gamma;
  const float* beta;
  float* out;
  long long xs_bstride;
  long long xd_bstride;
  long long e_bstride;
  int n_edges;
  int f_src;
  int f_dst;
  int f_e;
  int hidden;
  int partial;  // K2: x_src/x_dst hold [N, hidden] partial products, w0 is We
};

__global__ void __launch_bounds__(THREADS, 2)
    edge_mlp_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* Hs = reinterpret_cast<float*>(smem4);  // [TE][NMAX] h0, then h1
  float* Bs = Hs + TE * NMAX;                   // [KC][NMAX] weight slice
  float* As = Bs + KC * NMAX;                   // [TE][KC] gathered inputs
  int* sidx = reinterpret_cast<int*>(As + TE * KC);
  int* ridx = sidx + TE;

  const int b = blockIdx.y;
  const int e0 = blockIdx.x * TE;
  if (threadIdx.x < TE) {
    const int edge = e0 + threadIdx.x;
    sidx[threadIdx.x] = edge < p.n_edges ? p.senders[edge] : 0;
    ridx[threadIdx.x] = edge < p.n_edges ? p.receivers[edge] : 0;
  }
  __syncthreads();

  const float* e_b = p.e + b * p.e_bstride;
  const float* xs_b = p.x_src + b * p.xs_bstride;
  const float* xd_b = p.x_dst ? p.x_dst + b * p.xd_bstride : nullptr;
  float acc[ROWS][8];
  if (p.partial)
    init_from_partials(acc, xs_b, xd_b, sidx, ridx, p.hidden);
  else
    zero(acc);

  // h0: the row blocks of W0 against their gathered operands (only We's in
  // partial mode), as one loop over slices, so the unrolled product is
  // inlined once here (three inlined copies, one loop per block, measured
  // 3.5% slower on an H100).
  const float* e_tile = e_b + (long long)e0 * p.f_e;
  const float* w_dst = p.w0 + (long long)p.f_src * p.hidden;
  const float* w_e = p.partial ? p.w0 : w_dst + (long long)p.f_dst * p.hidden;
  const int n_src = p.partial ? 0 : (p.f_src + KC - 1) / KC;
  const int n_dst = xd_b && !p.partial ? (p.f_dst + KC - 1) / KC : 0;
  const int n_all = n_src + n_dst + (p.f_e + KC - 1) / KC;
  for (int i = 0; i < n_all; ++i) {
    if (i < n_src) {
      gather_slice(As, xs_b, sidx, p.f_src, i * KC, e0, p.n_edges);
      load_weight_slice(Bs, p.w0, i * KC, p.f_src, p.hidden);
    } else if (i < n_src + n_dst) {
      const int k0 = (i - n_src) * KC;
      gather_slice(As, xd_b, ridx, p.f_dst, k0, e0, p.n_edges);
      load_weight_slice(Bs, w_dst, k0, p.f_dst, p.hidden);
    } else {
      const int k0 = (i - n_src - n_dst) * KC;
      gather_slice(As, e_tile, nullptr, p.f_e, k0, 0, p.n_edges - e0);
      load_weight_slice(Bs, w_e, k0, p.f_e, p.hidden);
    }
    cp_async_wait_all();
    mma_slice(acc, As, KC, Bs);
    __syncthreads();
  }
  store_relu(Hs, acc, p.b0, p.hidden);
  // h1 (each warp reads back only the rows it wrote; the barrier after the
  // first weight slice orders the writes before the reads).
  dense_from_smem(acc, Hs, Bs, p.w1, p.hidden, p.hidden);
  store_relu(Hs, acc, p.b1, p.hidden);
  // h2 stays in registers.
  dense_from_smem(acc, Hs, Bs, p.w2, p.hidden, p.f_e);

  const int warp = threadIdx.x >> 5;
  const float inv_fe = 1.f / p.f_e;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = warp * ROWS + r;
    float h[8];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tile_col(j);
      h[j] = c < p.f_e ? acc[r][j] + p.b2[c] : 0.f;
      sum += h[j];
    }
    float mean = 0.f, rstd = 1.f;
    if (p.gamma != nullptr) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      mean = sum * inv_fe;
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = tile_col(j) < p.f_e ? h[j] - mean : 0.f;
        sq += d * d;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sq += __shfl_xor_sync(0xffffffffu, sq, off);
      rstd = rsqrtf(sq * inv_fe + 1e-5f);
    }
    const int edge = e0 + row;
    if (edge >= p.n_edges) continue;
    const float* e_row = e_b + (long long)edge * p.f_e;
    float* o_row = p.out + ((long long)b * p.n_edges + edge) * p.f_e;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tile_col(j);
      if (c >= p.f_e) continue;
      float y = h[j];
      if (p.gamma != nullptr) y = (y - mean) * rstd * p.gamma[c] + p.beta[c];
      o_row[c] = y + e_row[c];
    }
  }
}

int launch(const Params& p, int batch, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      edge_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.n_edges + TE - 1) / TE, batch);
  edge_mlp_kernel<<<grid, THREADS, kSmemBytes,
                    static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on `stream`, does
// not synchronise, allocates nothing; returns cudaGetLastError() after launch.

// Raw mode (K1): x_src [N_src, f_src] and x_dst [N_dst, f_dst] node rows,
// w0 = [Ws; Wd; We].
extern "C" int gwt_edge_mlp_forward(
    const int* senders, const int* receivers, const float* x_src,
    long long xs_bstride, int f_src, const float* x_dst, long long xd_bstride,
    int f_dst, const float* e, long long e_bstride, int f_e, const float* w0,
    const float* b0, const float* w1, const float* b1, const float* w2,
    const float* b2, const float* gamma, const float* beta, float* out,
    int n_edges, int batch, int hidden, void* stream) {
  const Params p{senders, receivers, x_src, x_dst, e, w0, b0, w1, b1, w2, b2,
                 gamma, beta, out, xs_bstride, xd_bstride, e_bstride, n_edges,
                 f_src, f_dst, f_e, hidden, 0};
  return launch(p, batch, stream);
}

// Partial-product mode (K2): p_src [N_src, hidden] and p_dst [N_dst, hidden]
// (nullptr: no destination term) are x_src Ws and x_dst Wd; we is [f_e, hidden].
extern "C" int gwt_edge_update_forward(
    const int* senders, const int* receivers, const float* p_src,
    long long ps_bstride, const float* p_dst, long long pd_bstride,
    const float* e, long long e_bstride, int f_e, const float* we,
    const float* b0, const float* w1, const float* b1, const float* w2,
    const float* b2, const float* gamma, const float* beta, float* out,
    int n_edges, int batch, int hidden, void* stream) {
  const Params p{senders, receivers, p_src, p_dst, e, we, b0, w1, b1, w2, b2,
                 gamma, beta, out, ps_bstride, pd_bstride, e_bstride, n_edges,
                 hidden, hidden, f_e, hidden, 1};
  return launch(p, batch, stream);
}
