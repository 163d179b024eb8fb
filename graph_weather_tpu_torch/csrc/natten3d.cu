// 3D neighborhood attention (NATTEN) forward, slot-serial, for Hopper
// (sm_90a), FP32 on the CUDA cores.
//
// Replaces the Pallas TPU kernel K6, graph_weather_tpu/ops/pallas/natten3d.py:
// _natten_fwd_impl (the pallas_call of _natten_kernel), which the JAX package
// runs for the shapes its halo-tiled kernel (natten_flash.py) refuses. Here it
// takes the shapes the port's K5a (natten_flash.cu) refuses: heads wider than
// 128 channels, and heads of 96 or 128 at kernel (5, 7, 7), whose halo does
// not fit in shared memory. q, k, v are [B, D, H, W, heads, ch] f32 (views of
// one fused qkv tensor qualify: positions at a stride of their own, [heads,
// ch] dense). Query i attends to the kd x kh x kw keys of its window: on each
// axis the window starts at clip(i - k/2, 0, size - k), or at i - k/2 modulo
// W on a circular W axis. With q scaled by ch^-0.5 and rpb [heads, 2kd-1,
// 2kh-1, 2kw-1] added at the relative offset key - query + k - 1 (a circular
// axis: slot - k/2 + k - 1),
//
//     out[i] = sum_j softmax_j(q_i . k_j * scale + rpb[rel(i, j)]) v_j,
//
// with the online softmax in f32 from a running max of -1e30, over the slots
// in the order of the JAX package's slot scan (x over kd, y over kh, z over
// kw).
//
// What bounds it on an H100. At the 768-d WeatherMesh's 1-degree latent
// ([1, 14, 45, 90], 8 heads x 96, kernel (5, 7, 7)) one call computes 111.1 M
// (query, key, head) pairs: 42.67 GFLOP (0.637 ms at the 67 TFLOP/s FP32 peak)
// against 697 MB of q, k, v and out (0.208 ms at 3.35 TB/s), so operations
// bound it. The TPU kernel pre-applied the W offsets as z-copies in XLA, fixed
// the window edges with iota masks, summed lanes with a block-diagonal ones
// matrix and added rpb through a one-hot class matmul, all to suit Mosaic;
// none of that is needed here:
//
//   * one CTA of 256 threads owns 32 consecutive positions (along W, then H,
//     then D) of one (batch, head); eight lanes per query split ch (lane l
//     holds channels 4 l + 32 j .. + 3), so one query's k or v row is read as
//     128-byte segments, and a logit is three shuffles;
//   * each query computes its keys' positions and relative ids directly and
//     walks its window slot by slot, reading the k and v rows through L1/L2
//     (neighbouring queries of a CTA share most of their keys); rpb of the
//     head sits in shared memory (n_rel floats, 1,521 at (5, 7, 7));
//   * m, l and the accumulator stay in registers; no halo is staged, so no
//     shape is refused for shared memory except an rpb larger than 227 KB.
//
// Not yet here: staging a slot's rows once for the whole tile, several
// queries per thread, tensor cores, bf16. Each (query, slot) reads 2 x ch
// floats through L1, so L1's bandwidth, not the FP32 pipes, limits it.

#include <cuda_runtime.h>

namespace {

constexpr float NEG = -1e30f;  // running-max start: exp(NEG - s) == 0
constexpr int LANES = 8;       // lanes per query
constexpr int THREADS = 256;
constexpr int QUERIES = THREADS / LANES;  // per CTA

struct Geometry {
  int batch, d, h, w, heads, ch;
  long long q_ps, k_ps, v_ps;  // floats between consecutive positions
  int kd, kh, kw, circular_w;
  float scale;
};

struct Params {
  const float* __restrict__ q;
  const float* __restrict__ k;
  const float* __restrict__ v;
  const float* __restrict__ rpb;  // or null
  float* __restrict__ out;        // [B, D, H, W, heads, ch], dense
  Geometry g;
};

__device__ __forceinline__ int window_start(int i, int size, int k) {
  const int s = i - k / 2;
  return s < 0 ? 0 : (s > size - k ? size - k : s);
}

// This lane's channels of one row: float4 j holds channels 4 l + 32 j + 0..3
// (zero past ch). VEC4: ch, the strides and the pointers allow 16-byte loads.
template <int NV, bool VEC4>
__device__ __forceinline__ void load_row(float4 (&r)[NV], const float* __restrict__ row, int l,
                                         int ch) {
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = 4 * l + 32 * j;
    if (VEC4) {
      r[j] = c < ch ? __ldg(reinterpret_cast<const float4*>(row + c))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      r[j] = make_float4(c < ch ? __ldg(row + c) : 0.f, c + 1 < ch ? __ldg(row + c + 1) : 0.f,
                         c + 2 < ch ? __ldg(row + c + 2) : 0.f,
                         c + 3 < ch ? __ldg(row + c + 3) : 0.f);
    }
  }
}

template <int NV, bool VEC4>
__device__ __forceinline__ void store_row(float* row, const float4 (&r)[NV], float mul, int l,
                                          int ch) {
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = 4 * l + 32 * j;
    const float4 x = make_float4(r[j].x * mul, r[j].y * mul, r[j].z * mul, r[j].w * mul);
    if (VEC4) {
      if (c < ch) *reinterpret_cast<float4*>(row + c) = x;
    } else {
      if (c < ch) row[c] = x.x;
      if (c + 1 < ch) row[c + 1] = x.y;
      if (c + 2 < ch) row[c + 2] = x.z;
      if (c + 3 < ch) row[c + 3] = x.w;
    }
  }
}

template <int NV, bool VEC4>
__global__ void __launch_bounds__(THREADS) natten3d_forward_kernel(const Params p) {
  const Geometry g = p.g;
  extern __shared__ float rs[];  // [n_rel] rpb of this head
  const int nrh = 2 * g.kh - 1, nrw = 2 * g.kw - 1;
  const int n_rel = (2 * g.kd - 1) * nrh * nrw;
  const int head = blockIdx.y;
  if (p.rpb != nullptr) {
    for (int i = threadIdx.x; i < n_rel; i += THREADS) rs[i] = p.rpb[(long long)head * n_rel + i];
    __syncthreads();
  }

  // Eight lanes per query: lanes 8 t .. 8 t + 7 of a warp.
  const int lane = threadIdx.x & 31;
  const int l = lane & (LANES - 1);
  const unsigned group = 0xffu << (lane & ~(LANES - 1));
  const long long n_pos = (long long)g.d * g.h * g.w;
  const long long qi = (long long)blockIdx.x * QUERIES + threadIdx.x / LANES;
  if (qi >= n_pos) return;  // the whole group of eight lanes leaves together
  const int iw = (int)(qi % g.w), ih = (int)(qi / g.w % g.h), id = (int)(qi / ((long long)g.w * g.h));
  const long long b_pos = (long long)blockIdx.z * n_pos;
  const long long pos = b_pos + qi;
  const int col = head * g.ch;

  float4 qr[NV];
  load_row<NV, VEC4>(qr, p.q + pos * g.q_ps + col, l, g.ch);
#pragma unroll
  for (int j = 0; j < NV; ++j)
    qr[j] = make_float4(qr[j].x * g.scale, qr[j].y * g.scale, qr[j].z * g.scale,
                        qr[j].w * g.scale);

  const int sd = window_start(id, g.d, g.kd), sh = window_start(ih, g.h, g.kh);
  const int sw = g.circular_w ? iw - g.kw / 2 : window_start(iw, g.w, g.kw);
  float m = NEG, lsum = 0.f;
  float4 acc[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int x = 0; x < g.kd; ++x) {
    const int key_d = sd + x;
    const int rel_d = (key_d - id + g.kd - 1) * nrh;
    for (int y = 0; y < g.kh; ++y) {
      const int key_h = sh + y;
      const int rel_h = (rel_d + key_h - ih + g.kh - 1) * nrw;
      const long long row = b_pos + ((long long)key_d * g.h + key_h) * g.w;
      for (int z = 0; z < g.kw; ++z) {
        int key_w = sw + z;  // circular: within (-W, 2W) since kw <= W
        if (key_w < 0) key_w += g.w;
        if (key_w >= g.w) key_w -= g.w;
        const long long kp = row + key_w;
        float4 kr[NV];
        load_row<NV, VEC4>(kr, p.k + kp * g.k_ps + col, l, g.ch);
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          s = fmaf(qr[j].x, kr[j].x, s);
          s = fmaf(qr[j].y, kr[j].y, s);
          s = fmaf(qr[j].z, kr[j].z, s);
          s = fmaf(qr[j].w, kr[j].w, s);
        }
        s += __shfl_xor_sync(group, s, 1);
        s += __shfl_xor_sync(group, s, 2);
        s += __shfl_xor_sync(group, s, 4);
        if (p.rpb != nullptr)
          s += rs[rel_h + (g.circular_w ? z + g.kw - 1 - g.kw / 2 : key_w - iw + g.kw - 1)];
        float4 vr[NV];
        load_row<NV, VEC4>(vr, p.v + kp * g.v_ps + col, l, g.ch);
        if (s > m) {
          const float a = expf(m - s);
          lsum *= a;
#pragma unroll
          for (int j = 0; j < NV; ++j)
            acc[j] = make_float4(acc[j].x * a, acc[j].y * a, acc[j].z * a, acc[j].w * a);
          m = s;
        }
        const float pr = expf(s - m);
        lsum += pr;
#pragma unroll
        for (int j = 0; j < NV; ++j)
          acc[j] = make_float4(fmaf(pr, vr[j].x, acc[j].x), fmaf(pr, vr[j].y, acc[j].y),
                               fmaf(pr, vr[j].z, acc[j].z), fmaf(pr, vr[j].w, acc[j].w));
      }
    }
  }

  store_row<NV, VEC4>(p.out + pos * ((long long)g.heads * g.ch) + col, acc, 1.f / lsum, l, g.ch);
}

template <int NV, bool VEC4>
int launch(const Params& p, cudaStream_t stream) {
  const Geometry& g = p.g;
  const int n_rel = (2 * g.kd - 1) * (2 * g.kh - 1) * (2 * g.kw - 1);
  const size_t smem = p.rpb != nullptr ? sizeof(float) * n_rel : 0;
  cudaError_t err = cudaFuncSetAttribute(natten3d_forward_kernel<NV, VEC4>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_pos = (long long)g.d * g.h * g.w;
  const dim3 grid((unsigned)((n_pos + QUERIES - 1) / QUERIES), g.heads, g.batch);
  natten3d_forward_kernel<NV, VEC4><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int NV>
int launch_width(const Params& p, bool vec4, cudaStream_t stream) {
  return vec4 ? launch<NV, true>(p, stream) : launch<NV, false>(p, stream);
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing; returns a cudaError_t (0 on success), or
// cudaErrorInvalidValue for ch > 256. rpb may be null. The host checked the
// kernel against the volume, the rpb against shared memory, and batch and
// heads against the grid's limits (ops/natten3d.py, `takes`).
extern "C" int gwt_natten3d_forward(const float* q, const float* k, const float* v,
                                    const float* rpb, float* out, int batch, int d, int h, int w,
                                    int heads, int ch, long long q_ps, long long k_ps,
                                    long long v_ps, int kd, int kh, int kw, int circular_w,
                                    int vec4, float scale, void* stream) {
  const Params p{q, k, v, rpb, out,
                 Geometry{batch, d, h, w, heads, ch, q_ps, k_ps, v_ps, kd, kh, kw, circular_w,
                          scale}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool v4 = vec4 != 0;
  switch ((ch + 31) / 32) {
    case 1: return launch_width<1>(p, v4, s);
    case 2: return launch_width<2>(p, v4, s);
    case 3: return launch_width<3>(p, v4, s);
    case 4: return launch_width<4>(p, v4, s);
    case 5: return launch_width<5>(p, v4, s);
    case 6: return launch_width<6>(p, v4, s);
    case 7: return launch_width<7>(p, v4, s);
    case 8: return launch_width<8>(p, v4, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
