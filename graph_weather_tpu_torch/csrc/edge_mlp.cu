// Fused MeshGraphNet edge update for Hopper (sm_90a), split-TF32 products on
// the tensor cores.
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
// Partial-product mode (K2). It replaces the Pallas TPU kernel
// graph_weather_tpu/ops/pallas/fused_mlp.py: _kernel (launched by
// _fused_padded), which takes the first layer's node terms as partial
// products already gathered per edge. Here the caller makes p_src = x_src Ws
// and p_dst = x_dst Wd once per node (N << E, plain GEMMs), and the kernel
// gathers their rows itself into the accumulators, so only We runs through
// the first layer before W1, W2, the LayerNorm and the residual: 2 (Fe H +
// H H + H Fe) flops per edge where raw mode (K1) does 2 (F_src H + F_dst H +
// Fe H + H H + H Fe). Its backward is K2b (fused_mlp_bwd.cu).
//
// What bounds it on an H100. Per edge it gathers one row of p_src (or
// x_src) and of p_dst, reads one row of e (twice: the first product and the
// residual, the second from L2), and writes one row of e': 4 rows of 1 KB at
// width 256 against 393 KFLOP (K2), ~100 flops a byte, where the card's FP32
// balance point is ~20 and that of its TF32 tensor cores ~150. So products
// bound it: 349 GFLOP a 1-degree forward is 5.2 ms at the FP32 peak, and 2.1
// ms as three TF32 products at the tensor cores' dense peak. The TPU kernel
// kept the node arrays and every weight in VMEM; here a block owns a tile
// of 64 edges of one batch entry and
//
//   * stages the tile's e rows (K1: each gathered input, in chunks of 256
//     columns) into shared memory with cp.async, as the A operand of the
//     first product, and gathers the partial rows straight into the
//     accumulators while that copy is in flight;
//   * streams the weights through shared memory in 16-row slices, two
//     stages, one slice in flight while the other multiplies, across the
//     product boundaries; all blocks read the same weights, which stay in L2;
//   * runs every product as three TF32 mma.sync (edge_tile.cuh), which keeps
//     f32's accuracy at the tensor cores' rate;
//   * keeps h0 and h1 in one shared buffer and h2 in registers: no [E, H]
//     intermediate touches device memory; only e' is written;
//   * does the LayerNorm and the residual row by row from h2 in shared
//     memory, a row's statistics by warp shuffles: every launch repeats its
//     bits.
//
// One kernel body serves both modes, instantiated for each: K2's has a single
// first-layer chunk and fits two blocks an SM in 128 registers without
// spills; K1's keeps its chunk loop and takes the registers of one block an
// SM (it is on no model path).
//
// Widths up to 256 (H, Fe; any F_src and F_dst in K1) are accepted; narrower
// layers run on zero-padded tiles. The helpers are in edge_tile.cuh.
//
// bf16 (K2 on bf16 operands, the bf16 compute policy: the TPU kernel's bf16
// mode, whose e' takes e's dtype). A third instantiation of K2's body over
// bf16 tiles (edge_tile.cuh): one bf16 m16n8k16 mma.sync per product, f32
// accumulators, and each result rounded where XLA rounds the JAX package's
// bf16 EdgeBlock: e We rounded, then ((p_src[s] + p_dst[r]) + e We) + b0
// with each add rounded, ReLU; h0 W1 rounded, + b1 rounded, ReLU; h1 W2
// rounded, + b2 in f32 (that add's only use is the LayerNorm's f32
// statistics, so XLA keeps it in f32); the LayerNorm in f32, rounded; the
// residual rounded. The bf16 tiles halve the bytes staged and moved (e and
// e' rows, the partial rows, the weight slices), and one bf16 product does
// the work of three TF32 ones: 349 GFLOP a 1-degree forward is 0.35 ms at
// the BF16 peak against ~1.6 GB of rows, 0.47 ms, so bytes bound it.

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
};

// A chunk of the first layer's input: columns [c0, c0 + cols) of input
// `which` (0: x_src, gathered by sender; 1: x_dst, by receiver; 2: e) against
// the rows w[0, cols) of W0.
struct Chunk {
  int which, width, c0, cols;
  const float* w;
};

// The parameters with the mode fixed at compile time: the partial-product
// instantiation (K2) has a single first-layer chunk, so it keeps no chunk
// loop and its counters live across the products (the raw one, off every
// model path, has the registers of one block an SM).
template <bool PARTIAL>
struct Mode : Params {};

// The first layer's chunks: in raw mode x_src, x_dst (when given) and e,
// each in chunks of NMAX columns; in partial mode e alone (f_e <= NMAX).
template <bool PARTIAL>
__device__ __forceinline__ int src_chunks(const Mode<PARTIAL>& p) {
  return PARTIAL ? 0 : (p.f_src + NMAX - 1) / NMAX;
}
template <bool PARTIAL>
__device__ __forceinline__ int dst_chunks(const Mode<PARTIAL>& p) {
  return !PARTIAL && p.x_dst ? (p.f_dst + NMAX - 1) / NMAX : 0;
}
template <bool PARTIAL>
__device__ __forceinline__ int chunk_count(const Mode<PARTIAL>& p) {
  return PARTIAL ? 1 : src_chunks(p) + dst_chunks(p) + (p.f_e + NMAX - 1) / NMAX;
}

template <bool PARTIAL>
__device__ __forceinline__ Chunk chunk(const Mode<PARTIAL>& p, int q) {
  const int n_src = src_chunks(p), n_dst = dst_chunks(p);
  Chunk c;
  int row0;  // first row of W0 for this input
  if (q < n_src) {
    c = {0, p.f_src, q * NMAX, 0, nullptr};
    row0 = 0;
  } else if (q < n_src + n_dst) {
    c = {1, p.f_dst, (q - n_src) * NMAX, 0, nullptr};
    row0 = p.f_src;
  } else {
    c = {2, p.f_e, (q - n_src - n_dst) * NMAX, 0, nullptr};
    row0 = PARTIAL ? 0 : p.f_src + p.f_dst;
  }
  c.cols = min(NMAX, c.width - c.c0);
  c.w = p.w0 + (long long)(row0 + c.c0) * p.hidden;
  return c;
}

// The kernel's products (edge_tile.cuh's stream): the first layer's chunks,
// then W1 and W2.
template <bool PARTIAL>
__device__ __forceinline__ int product_count(const Mode<PARTIAL>& p) {
  return chunk_count(p) + 2;
}

template <bool PARTIAL>
__device__ __forceinline__ Prod product(const Mode<PARTIAL>& p, int i) {
  const int n = chunk_count(p);
  if (i < n) {
    const Chunk c = chunk(p, i);
    return {c.w, c.cols, p.hidden};
  }
  if (i == n) return {p.w1, p.hidden, p.hidden};
  return {p.w2, p.hidden, p.f_e};
}

// A rows = the tile's rows of chunk c of batch entry b (not committed).
__device__ __forceinline__ void stage_chunk(const Params& p, const Smem& sm, const Chunk& c, int b,
                                            int e0) {
  if (c.which == 2)
    stage_rows(sm.H, p.e + b * p.e_bstride + (long long)e0 * p.f_e, nullptr, c.width, c.c0,
               c.cols, p.n_edges - e0);
  else if (c.which == 1)
    stage_rows(sm.H, p.x_dst + b * p.xd_bstride, sm.ridx, c.width, c.c0, c.cols, p.n_edges - e0);
  else
    stage_rows(sm.H, p.x_src + b * p.xs_bstride, sm.sidx, c.width, c.c0, c.cols, p.n_edges - e0);
}

template <bool PARTIAL>
__global__ void __launch_bounds__(THREADS, PARTIAL ? kBlocksPerSM : 1)
    edge_mlp_kernel(const Mode<PARTIAL> p) {
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

  // The first chunk's rows and the first slices in flight while the partial
  // rows (K2) are gathered into the accumulators.
  stage_chunk(p, sm, chunk(p, 0), b, e0);
  Stream s = start(p, sm.ring);
  Acc acc;
  if (PARTIAL)
    init_from_partials(acc, q, p.x_src + b * p.xs_bstride,
                       p.x_dst ? p.x_dst + b * p.xd_bstride : nullptr, sm.sidx, sm.ridx, p.hidden);
  else
    zero(acc);

  // h0: W0's row blocks against their inputs, one chunk at a time.
  const int n_chunks = chunk_count(p);
  for (int i = 0; i < n_chunks; ++i) {
    if (i > 0) {
      __syncthreads();  // every warp is done with the last chunk's rows
      stage_chunk(p, sm, chunk(p, i), b, e0);
      ctile::cp_async_commit();
      ctile::cp_async_wait<0>();
    }
    dense(acc, q, sm.H, p, s, sm.ring, product(p, i));
  }
  __syncthreads();
  add_bias(acc, q, p.b0, p.hidden, true);
  store_rows(sm.H, acc, q, nullptr, 0, e0, p.n_edges);
  dense(acc, q, sm.H, p, s, sm.ring, product(p, n_chunks));
  __syncthreads();
  add_bias(acc, q, p.b1, p.hidden, true);
  store_rows(sm.H, acc, q, nullptr, 0, e0, p.n_edges);
  dense(acc, q, sm.H, p, s, sm.ring, product(p, n_chunks + 1));

  // h2 = acc + b2 into H, then row by row its LayerNorm and the residual.
  __syncthreads();
  add_bias(acc, q, p.b2, p.f_e, false);
  store_rows(sm.H, acc, q, nullptr, 0, e0, p.n_edges);
  __syncthreads();
  float gm[8], bt[8];
  if (p.gamma != nullptr) {
    load_row8(gm, p.gamma, p.f_e);
    load_row8(bt, p.beta, p.f_e);
  }
  const int first = opaque(e0 + (threadIdx.x >> 5) * ROWS);
  for (int r = 0; r < ROWS; ++r) {
    const int edge = first + r, row = edge - e0;
    if (edge >= p.n_edges) break;
    float h[8], x[8];
    load_row8(h, sm.H + row * LDA, NMAX);
    if (p.gamma != nullptr) {
      normalise(h, p.f_e);
#pragma unroll
      for (int j = 0; j < 8; ++j) h[j] = h[j] * gm[j] + bt[j];
    }
    const long long bb = opaque(b);
    load_row8(x, p.e + bb * p.e_bstride + (long long)edge * p.f_e, p.f_e);
#pragma unroll
    for (int j = 0; j < 8; ++j) h[j] += x[j];
    store_row8(p.out + (bb * p.n_edges + edge) * p.f_e, h, p.f_e);
  }
}

template <bool PARTIAL>
int launch(const Params& params, int batch, void* stream) {
  Mode<PARTIAL> p;
  static_cast<Params&>(p) = params;
  cudaError_t err = cudaFuncSetAttribute(
      edge_mlp_kernel<PARTIAL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.n_edges + TE - 1) / TE, batch);
  edge_mlp_kernel<PARTIAL><<<grid, THREADS, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// --- bf16 (K2 on bf16 operands) ---------------------------------------------------

struct Params16 {
  const int* senders;
  const int* receivers;
  const bf16* p_src;
  const bf16* p_dst;
  const bf16* e;
  const bf16* we;
  const bf16* b0;
  const bf16* w1;
  const bf16* b1;
  const bf16* w2;
  const bf16* b2;
  const bf16* gamma;
  const bf16* beta;
  bf16* out;
  long long ps_bstride;
  long long pd_bstride;
  long long e_bstride;
  int n_edges;
  int f_e;
  int hidden;
};

__device__ __forceinline__ int product_count(const Params16&) { return 3; }

__device__ __forceinline__ Prod16 product(const Params16& p, int i) {
  if (i == 0) return {p.we, p.f_e, p.hidden};
  if (i == 1) return {p.w1, p.hidden, p.hidden};
  return {p.w2, p.hidden, p.f_e};
}

__global__ void __launch_bounds__(THREADS, kBlocksPerSM16)
    edge_update_bf16_kernel(const Params16 p) {
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

  // e We (the e rows staged with the first slices), then the first layer's
  // rounded sums with the gathered partial rows.
  stage_rows(sm.H, p.e + b * p.e_bstride + (long long)e0 * p.f_e, p.f_e, p.n_edges - e0);
  Stream s = start(p, sm.ring);
  Acc acc;
  zero(acc);
  dense(acc, q, sm.H, p, s, sm.ring, product(p, 0));
  __syncthreads();  // every warp is done with the e rows
  first_layer16(acc, q, p.p_src + b * p.ps_bstride, p.p_dst ? p.p_dst + b * p.pd_bstride : nullptr,
                sm.sidx, sm.ridx, p.b0, p.hidden);
  store_rows(sm.H, acc, q, nullptr, 0, e0, p.n_edges);
  dense(acc, q, sm.H, p, s, sm.ring, product(p, 1));
  __syncthreads();
  add_bias_relu16(acc, q, p.b1, p.hidden);
  store_rows(sm.H, acc, q, nullptr, 0, e0, p.n_edges);
  dense(acc, q, sm.H, p, s, sm.ring, product(p, 2));

  // h1 W2 rounded into H; then row by row + b2 in f32, the LayerNorm in
  // f32 (rounded), the residual (rounded).
  __syncthreads();
  store_rows(sm.H, acc, q, nullptr, 0, e0, p.n_edges);
  __syncthreads();
  float b2[8], gm[8], bt[8];
  load_row8(b2, p.b2, p.f_e);
  if (p.gamma != nullptr) {
    load_row8(gm, p.gamma, p.f_e);
    load_row8(bt, p.beta, p.f_e);
  }
  const int first = opaque(e0 + (threadIdx.x >> 5) * ROWS);
  for (int r = 0; r < ROWS; ++r) {
    const int edge = first + r, row = edge - e0;
    if (edge >= p.n_edges) break;
    float h[8], x[8];
    load_row8(h, sm.H + row * LDA16, NMAX);
    if (p.gamma != nullptr) {
#pragma unroll
      for (int j = 0; j < 8; ++j) h[j] += b2[j];
      normalise(h, p.f_e);
#pragma unroll
      for (int j = 0; j < 8; ++j) h[j] = round16(h[j] * gm[j] + bt[j]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) h[j] = round16(h[j] + b2[j]);
    }
    const long long bb = opaque(b);
    load_row8(x, p.e + bb * p.e_bstride + (long long)edge * p.f_e, p.f_e);
#pragma unroll
    for (int j = 0; j < 8; ++j) h[j] += x[j];
    store_row8(p.out + (bb * p.n_edges + edge) * p.f_e, h, p.f_e);
  }
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
                 f_src, f_dst, f_e, hidden};
  return launch<false>(p, batch, stream);
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
                 hidden, hidden, f_e, hidden};
  return launch<true>(p, batch, stream);
}

// Partial-product mode in bf16 (K2 on bf16 operands): every operand but the
// indices bf16, out bf16; the arguments as gwt_edge_update_forward's.
extern "C" int gwt_edge_update_forward_bf16(
    const int* senders, const int* receivers, const __nv_bfloat16* p_src,
    long long ps_bstride, const __nv_bfloat16* p_dst, long long pd_bstride,
    const __nv_bfloat16* e, long long e_bstride, int f_e, const __nv_bfloat16* we,
    const __nv_bfloat16* b0, const __nv_bfloat16* w1, const __nv_bfloat16* b1,
    const __nv_bfloat16* w2, const __nv_bfloat16* b2, const __nv_bfloat16* gamma,
    const __nv_bfloat16* beta, __nv_bfloat16* out, int n_edges, int batch, int hidden,
    void* stream) {
  const Params16 p{senders, receivers, p_src, p_dst, e, we, b0, w1, b1, w2, b2,
                   gamma, beta, out, ps_bstride, pd_bstride, e_bstride, n_edges,
                   f_e, hidden};
  cudaError_t err = cudaFuncSetAttribute(
      edge_update_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes16);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n_edges + TE - 1) / TE, batch);
  edge_update_bf16_kernel<<<grid, THREADS, kSmemBytes16,
                            static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
