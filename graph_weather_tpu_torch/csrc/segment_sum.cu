// The edge-order segment sum "S" for Hopper (sm_90a): edge rows summed to
// their nodes one edge at a time, in edge order; in bf16 each partial sum
// is rounded to bf16, in f32 the sum is f32's own, with no rounding between
// the adds but f32's.
//
// It replaces no Pallas kernel. The JAX package leaves these sums to XLA:
// jax.ops.segment_sum (graph_weather_tpu/ops/scatter.py: segment_sum_agg,
// the grid->mesh aggregation of the forecaster and GenCast's segment sums)
// and the gradient of jnp.take (the node terms' gradient in every
// EdgeBlock, graph_weather_tpu/nn/graph_blocks.py: _GatherSumLinear, and
// every gather onto edges of the GenCast family). On the CPU both add one
// edge at a time in edge order; in bf16 they round every partial sum to
// bf16 (an f32 add of the two bf16 values, rounded to nearest even), which
// a sum in f32 rounded once, or a sum in another order, does not reproduce:
// the probes matched 100% under this rule, 9% under a single rounding. The
// f32 instantiation carries the f32 sums of the GenCast family's graphs
// (DeviceGraph.aggregate where a graph has no padded table, the segment
// softmax's sums, the gradients of the gathers onto edges), which
// index_add_ summed with atomics, in an order that changed from run to run.
//
// Layout: one thread per (node, column pair) of one batch entry walks the
// node's run of edge ids (the flat CSR: offsets [N + 1], edge ids [E] in
// edge order) and reads the pair from each edge row as one word (4 bytes
// in bf16, 8 in f32): neighbouring threads take neighbouring pairs of the
// same row, so a warp reads 128 (256) contiguous bytes of a row. No
// atomics, no shared memory: every launch repeats its bits, and the plain
// version (ops/scatter.py: edge_order_sum_reference) gives the same bits.
//
// What bounds it on an H100: each edge row is read once and each node row
// written once for one add an element, so bytes bound it: the 1-degree m2g
// sender sum (452,460 edges x 256) moves 232 MB in bf16, 69 us at 3.35
// TB/s. A node's chain of dependent adds (up to 1,260 edges) is latency the
// other threads of the SM hide.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int AHEAD = 32;  // rows a thread keeps in flight ahead of its adds

// The element types: how a pair is loaded and stored, and how a partial
// sum takes one more row.
template <class T>
struct Elem;

template <>
struct Elem<bf16> {
  using Pair = __nv_bfloat162;
  __device__ static float to_float(bf16 x) { return __bfloat162float(x); }
  __device__ static float2 pair(Pair x) { return __bfloat1622float2(x); }
  __device__ static Pair make(float a, float b) { return __floats2bfloat162_rn(a, b); }
  __device__ static bf16 one(float a) { return __float2bfloat16_rn(a); }
  // a + b in f32, rounded to nearest even bf16, kept as the f32 of that
  // bf16 (integer ops on the bits: a shorter chain than the conversions;
  // finite values, as __float2bfloat16_rn rounds them).
  __device__ static float add(float a, float b) {
    const unsigned u = __float_as_uint(a + b);
    return __uint_as_float((u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u);
  }
};

template <>
struct Elem<float> {
  using Pair = float2;
  __device__ static float to_float(float x) { return x; }
  __device__ static float2 pair(Pair x) { return x; }
  __device__ static Pair make(float a, float b) { return make_float2(a, b); }
  __device__ static float one(float a) { return a; }
  __device__ static float add(float a, float b) { return a + b; }
};

template <class T>
__global__ void __launch_bounds__(THREADS) segment_sum_kernel(
    const T* __restrict__ rows, long long batch_stride, const int* __restrict__ offsets,
    const int* __restrict__ edge_ids, T* __restrict__ out, int n_nodes, int width, int pairs,
    bool vec) {
  using E = Elem<T>;
  using Pair = typename E::Pair;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (long long)n_nodes * pairs) return;
  const int node = (int)(i / pairs);
  const int c = 2 * (int)(i - (long long)node * pairs);
  const bool two = c + 1 < width;
  const T* base = rows + blockIdx.y * batch_stride + c;
  const int begin = offsets[node], end = offsets[node + 1];
  float a0 = 0.f, a1 = 0.f;
  // A ring of AHEAD rows in flight: each add's row was loaded AHEAD rows
  // before it, so only the adds form a chain (a long run, as a bias
  // gradient's sum over every row, is otherwise one load latency a row).
  auto load = [&](int jj) {
    const T* row = base + (long long)edge_ids[jj] * width;
    return vec ? E::pair(*reinterpret_cast<const Pair*>(row))
               : make_float2(E::to_float(row[0]), two ? E::to_float(row[1]) : 0.f);
  };
  int j = begin;
  if (end - begin >= 2 * AHEAD) {
    float2 ring[AHEAD];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) ring[u] = load(j + u);
    for (; j + 2 * AHEAD <= end; j += AHEAD) {
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        const float2 v = ring[u];
        ring[u] = load(j + AHEAD + u);
        a0 = E::add(a0, v.x);
        a1 = E::add(a1, v.y);
      }
    }
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      a0 = E::add(a0, ring[u].x);
      a1 = E::add(a1, ring[u].y);
    }
    j += AHEAD;
  }
  for (; j < end; ++j) {
    const T* row = base + (long long)edge_ids[j] * width;
    if (vec) {
      const float2 v = E::pair(*reinterpret_cast<const Pair*>(row));
      a0 = E::add(a0, v.x);
      a1 = E::add(a1, v.y);
    } else {
      a0 = E::add(a0, E::to_float(row[0]));
      if (two) a1 = E::add(a1, E::to_float(row[1]));
    }
  }
  T* o = out + ((long long)blockIdx.y * n_nodes + node) * width + c;
  if (vec) {
    *reinterpret_cast<Pair*>(o) = E::make(a0, a1);
  } else {
    o[0] = E::one(a0);
    if (two) o[1] = E::one(a1);
  }
}

template <class T>
int launch(const T* rows, long long batch_stride, const int* offsets, const int* edge_ids, T* out,
           int n_nodes, int width, int batch, void* stream) {
  const int pairs = (width + 1) / 2;
  const long long threads = (long long)n_nodes * pairs;
  if (threads == 0 || batch == 0) return 0;
  // Pairs as one word: an even width, and every row aligned to the pair.
  constexpr uintptr_t align = 2 * sizeof(T) - 1;
  const bool vec = width % 2 == 0 && batch_stride % 2 == 0 &&
                   (reinterpret_cast<uintptr_t>(rows) & align) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & align) == 0;
  const dim3 grid((unsigned)((threads + THREADS - 1) / THREADS), batch);
  segment_sum_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, batch_stride, offsets, edge_ids, out, n_nodes, width, pairs, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). rows [batch, E, width], bf16 or
// f32, with `batch_stride` elements between batch entries (rows of `width`
// dense); out [batch, n_nodes, width] contiguous, of the rows' type.
// Launch on `stream`, do not synchronise, allocate nothing; return
// cudaGetLastError() after launch.
extern "C" int gwt_segment_sum_bf16(const bf16* rows, long long batch_stride, const int* offsets,
                                    const int* edge_ids, bf16* out, int n_nodes, int width,
                                    int batch, void* stream) {
  return launch(rows, batch_stride, offsets, edge_ids, out, n_nodes, width, batch, stream);
}

extern "C" int gwt_segment_sum_f32(const float* rows, long long batch_stride, const int* offsets,
                                   const int* edge_ids, float* out, int n_nodes, int width,
                                   int batch, void* stream) {
  return launch(rows, batch_stride, offsets, edge_ids, out, n_nodes, width, batch, stream);
}
