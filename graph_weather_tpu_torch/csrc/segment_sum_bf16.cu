// The bf16 segment sum "S" for Hopper (sm_90a): bf16 edge rows summed to
// their nodes in edge order, each partial sum rounded to bf16.
//
// It replaces no Pallas kernel. The JAX package leaves these sums to XLA:
// jax.ops.segment_sum in bf16 (graph_weather_tpu/ops/scatter.py:
// segment_sum_agg, the grid->mesh aggregation of the forecaster and
// GenCast's segment sums) and the gradient of jnp.take in bf16 (the node
// terms' gradient in every EdgeBlock, graph_weather_tpu/nn/graph_blocks.py:
// _GatherSumLinear). On the CPU both add one edge at a time in edge order
// and round every partial sum to bf16 (an f32 add of the two bf16 values,
// rounded to nearest even), which a sum in f32 rounded once, or a sum in
// another order, does not reproduce: the probes matched 100% under this
// rule, 9% under a single rounding. The port's f32 sums run through padded
// CSR tables in two levels; the old bf16 sum looped over ranks with a host
// sync each. This kernel is the sequential sum, written for the card.
//
// Layout: one thread per (node, column pair) of one batch entry walks the
// node's run of edge ids (the flat CSR: offsets [N + 1], edge ids [E] in
// edge order) and reads the pair from each edge row as one 4-byte word:
// neighbouring threads take neighbouring pairs of the same row, so a warp
// reads 128 contiguous bytes of a row. No atomics, no shared memory: every
// launch repeats its bits, and the plain version (ops/scatter.py:
// segment_sum_bf16_reference) gives the same bits.
//
// What bounds it on an H100: each edge row is read once and each node row
// written once (2 bytes an element) for one f32 add an element, so bytes
// bound it: the 1-degree m2g sender sum (452,460 edges x 256) moves 232 MB,
// 69 us at 3.35 TB/s. A node's chain of dependent adds (up to 1,260 edges)
// is latency the other threads of the SM hide.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;

// a + b in f32, rounded to nearest even bf16, kept as the f32 of that bf16.
__device__ __forceinline__ float add_round(float a, float b) {
  return __bfloat162float(__float2bfloat16_rn(a + b));
}

__global__ void __launch_bounds__(THREADS) segment_sum_bf16_kernel(
    const bf16* __restrict__ rows, long long batch_stride, const int* __restrict__ offsets,
    const int* __restrict__ edge_ids, bf16* __restrict__ out, int n_nodes, int width, int pairs,
    bool vec) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (long long)n_nodes * pairs) return;
  const int node = (int)(i / pairs);
  const int c = 2 * (int)(i - (long long)node * pairs);
  const bool two = c + 1 < width;
  const bf16* base = rows + blockIdx.y * batch_stride + c;
  const int begin = offsets[node], end = offsets[node + 1];
  float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
  for (int j = begin; j < end; ++j) {
    const bf16* row = base + (long long)edge_ids[j] * width;
    if (vec) {
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row));
      a0 = add_round(a0, v.x);
      a1 = add_round(a1, v.y);
    } else {
      a0 = add_round(a0, __bfloat162float(row[0]));
      if (two) a1 = add_round(a1, __bfloat162float(row[1]));
    }
  }
  bf16* o = out + ((long long)blockIdx.y * n_nodes + node) * width + c;
  if (vec) {
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a0, a1);
  } else {
    o[0] = __float2bfloat16_rn(a0);
    if (two) o[1] = __float2bfloat16_rn(a1);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). rows [batch, E, width] bf16 with
// `batch_stride` elements between batch entries (rows of `width` dense);
// out [batch, n_nodes, width] contiguous. Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() after launch.
extern "C" int gwt_segment_sum_bf16(const bf16* rows, long long batch_stride, const int* offsets,
                                    const int* edge_ids, bf16* out, int n_nodes, int width,
                                    int batch, void* stream) {
  const int pairs = (width + 1) / 2;
  const long long threads = (long long)n_nodes * pairs;
  if (threads == 0 || batch == 0) return 0;
  // Pairs as 4-byte words: an even width, and every row 4-byte aligned.
  const bool vec = width % 2 == 0 && batch_stride % 2 == 0 &&
                   (reinterpret_cast<uintptr_t>(rows) & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 3) == 0;
  const dim3 grid((unsigned)((threads + THREADS - 1) / THREADS), batch);
  segment_sum_bf16_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, batch_stride, offsets, edge_ids, out, n_nodes, width, pairs, vec);
  return (int)cudaGetLastError();
}
