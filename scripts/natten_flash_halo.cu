// The design of the 3D neighborhood attention forward K5a before its
// redesign (graph_weather_tpu_torch/csrc/natten_flash.cu), kept as a
// variant of scripts/k5a_variants.py: the tile's whole 3D halo of K and V
// staged at once, four lanes a query, one key at a time. Its C entry takes
// the halo tile of ops/natten_flash.py's _pick_tile("fwd", ...).
//
// 3D neighborhood attention (NATTEN) forward for Hopper (sm_90a), FP32 on the
// CUDA cores.
//
// Replaces the Pallas TPU kernel K5a, graph_weather_tpu/ops/pallas/
// natten_flash.py: _flash_fwd_impl (the pallas_call of _flash_kernel).
// q, k, v are [B, D, H, W, heads, ch] f32 (q, k and v may be views of one
// fused qkv tensor: positions at a stride of their own, [heads, ch] dense).
// Query i attends to the kd x kh x kw keys of its window: on each axis the
// window starts at clip(i - k/2, 0, size - k), or at i - k/2 modulo W on a
// circular W axis. With q scaled by ch^-0.5 and rpb [heads, 2kd-1, 2kh-1,
// 2kw-1] added at the relative offset key - query + k - 1 (a circular axis:
// slot - k/2 + k - 1),
//
//     out[i] = sum_j softmax_j(q_i . k_j * scale + rpb[rel(i, j)]) v_j,
//
// and, when the caller asks for it (training), lse[i] = m + log(l) of the
// online softmax, f32 [B, D, H, W, heads], which the backward
// (natten_flash_bwd.cu) reads.
//
// What bounds it on an H100. At WeatherMesh's 1-degree latent ([1, 14, 45,
// 90], 4 heads x 32, kernel (3, 5, 5)) one call moves ~116 MB (q, k, v, out:
// ~35 us at 3.35 TB/s) for 2.2 GFLOP (~33 us on the FP32 pipes). The TPU
// kernel attended each block densely against its whole halo, with class
// masks and a head-block-diagonal key matrix shaped for the 128-lane matrix
// unit; this kernel computes only the pairs that exist:
//
//   * one CTA owns a tile of td x th x tw queries of one (batch, head) and
//     stages the union of their windows (at most tile + k - 1 positions per
//     axis) of K and V, and rpb of its head, in shared memory with cp.async;
//     the host picks the tile that stages the fewest rows over the volume
//     within 227 KB (ops/natten_flash.py, _pick_tile);
//   * four lanes per query split ch (lanes t, t + 8, t + 16, t + 24 of a
//     warp, so one quarter-warp reads eight queries' rows: with rows padded
//     to ch + 4 floats, neighbouring queries hit distinct banks); a logit is
//     two shuffles;
//   * each query runs an online softmax in f32 over its window, rescaling
//     only when the running max grows.
//
// Not yet here: tensor cores, several queries per thread (neighbours share
// most keys), bf16.

#include <cuda_runtime.h>

namespace {

constexpr float NEG = -1e30f;  // running-max start: exp(NEG - s) == 0

struct Geometry {
  int batch, d, h, w, heads, ch;
  long long q_ps, k_ps, v_ps;  // floats between consecutive positions
  int kd, kh, kw, circular_w;
  int td, th, tw;  // queries per tile, per axis
  int ud, uh, uw;  // the most halo positions any tile stages, per axis
  int vec4;        // ch, strides and pointers allow 16-byte copies
  float scale;
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* rpb;  // or null
  float* out;        // [B, D, H, W, heads, ch], dense
  float* lse;        // [B, D, H, W, heads], or null: not written
  Geometry g;
};

__device__ __forceinline__ int window_start(int i, int size, int k) {
  const int s = i - k / 2;
  return s < 0 ? 0 : (s > size - k ? size - k : s);
}

// Queries [i0, i0 + n) of one axis -> first key and number of keys of the
// union of their windows (the first key unwrapped on a circular axis).
__device__ __forceinline__ void window_span(int i0, int n, int size, int k, bool circular,
                                            int& lo, int& span) {
  if (circular) {
    lo = i0 - k / 2;
    span = min(n + k - 1, size);
    return;
  }
  lo = window_start(i0, size, k);
  span = window_start(i0 + n - 1, size, k) + k - lo;
}

__device__ __forceinline__ int wrap(int i, int size) {
  i %= size;
  return i < 0 ? i + size : i;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0));
}

// Waits for this thread's copies, then for every thread's.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 axpy4(float a, const float4 x, float4 y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y), fmaf(a, x.z, y.z), fmaf(a, x.w, y.w));
}

// This lane's channels of one row: float4 jj holds channels 4 l + 16 jj + 0..3
// (zero past ch).
template <int NV>
__device__ __forceinline__ void load_row(float4 (&r)[NV], const float* row, int l, int ch,
                                         bool vec4) {
#pragma unroll
  for (int jj = 0; jj < NV; ++jj) {
    const int c = 4 * l + 16 * jj;
    if (vec4) {
      r[jj] = c < ch ? *reinterpret_cast<const float4*>(row + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      r[jj] = make_float4(c < ch ? row[c] : 0.f, c + 1 < ch ? row[c + 1] : 0.f,
                          c + 2 < ch ? row[c + 2] : 0.f, c + 3 < ch ? row[c + 3] : 0.f);
    }
  }
}

template <int NV>
__device__ __forceinline__ void store_row(float* row, const float4 (&r)[NV], float mul, int l,
                                          int ch, bool vec4) {
#pragma unroll
  for (int jj = 0; jj < NV; ++jj) {
    const int c = 4 * l + 16 * jj;
    const float4 x = make_float4(r[jj].x * mul, r[jj].y * mul, r[jj].z * mul, r[jj].w * mul);
    if (vec4) {
      if (c < ch) *reinterpret_cast<float4*>(row + c) = x;
    } else {
      if (c < ch) row[c] = x.x;
      if (c + 1 < ch) row[c + 1] = x.y;
      if (c + 2 < ch) row[c + 2] = x.z;
      if (c + 3 < ch) row[c + 3] = x.w;
    }
  }
}

template <int CP, int MAXT>
__global__ void __launch_bounds__(MAXT) natten_forward_kernel(const Params p) {
  constexpr int LD = CP + 4;   // shared row stride: bank-conflict-free float4 reads
  constexpr int NV = CP / 16;  // float4s per lane
  const Geometry g = p.g;
  extern __shared__ float4 smem4[];
  const int U = g.ud * g.uh * g.uw;
  float* Ks = reinterpret_cast<float*>(smem4);  // [U][LD]
  float* Vs = Ks + U * LD;                      // [U][LD]
  float* Rs = Vs + U * LD;                      // [n_rel] rpb of this head
  const int nrh = 2 * g.kh - 1, nrw = 2 * g.kw - 1;
  const int n_rel = (2 * g.kd - 1) * nrh * nrw;

  const int ntw = (g.w + g.tw - 1) / g.tw, nth = (g.h + g.th - 1) / g.th;
  const int d0 = blockIdx.x / (ntw * nth) * g.td;
  const int h0 = blockIdx.x / ntw % nth * g.th;
  const int w0 = blockIdx.x % ntw * g.tw;
  const int head = blockIdx.y;
  const long long b_pos = (long long)blockIdx.z * g.d * g.h * g.w;
  int lo_d, sp_d, lo_h, sp_h, lo_w, sp_w;
  window_span(d0, min(g.td, g.d - d0), g.d, g.kd, false, lo_d, sp_d);
  window_span(h0, min(g.th, g.h - h0), g.h, g.kh, false, lo_h, sp_h);
  window_span(w0, min(g.tw, g.w - w0), g.w, g.kw, g.circular_w, lo_w, sp_w);

  // Stage the halo of K and V (zeros in rows no window reaches).
  constexpr int V4 = CP / 4;
  for (int i = threadIdx.x; i < U * V4; i += blockDim.x) {
    const int r = i / V4, c = i % V4 * 4;
    const int dd = r / (g.uh * g.uw), hh = r / g.uw % g.uh, ww = r % g.uw;
    const bool in = dd < sp_d && hh < sp_h && ww < sp_w;
    const long long pos =
        in ? b_pos + ((long long)(lo_d + dd) * g.h + lo_h + hh) * g.w + wrap(lo_w + ww, g.w) : 0;
    const float* kp = p.k + pos * g.k_ps + head * g.ch + c;
    const float* vp = p.v + pos * g.v_ps + head * g.ch + c;
    if (g.vec4) {
      const bool ok = in && c < g.ch;
      cp_async16(Ks + r * LD + c, ok ? kp : p.k, ok);
      cp_async16(Vs + r * LD + c, ok ? vp : p.v, ok);
    } else {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const bool ok = in && c + x < g.ch;
        cp_async4(Ks + r * LD + c + x, ok ? kp + x : p.k, ok);
        cp_async4(Vs + r * LD + c + x, ok ? vp + x : p.v, ok);
      }
    }
  }
  if (p.rpb != nullptr)
    for (int i = threadIdx.x; i < n_rel; i += blockDim.x) Rs[i] = p.rpb[head * n_rel + i];
  cp_async_wait_all();

  // Four lanes per query: lanes t, t + 8, t + 16, t + 24 of a warp.
  const int lane = threadIdx.x & 31;
  const int qi = (threadIdx.x >> 5) * 8 + (lane & 7);
  const int l = lane >> 3;
  const unsigned group = 0x01010101u << (lane & 7);
  if (qi >= g.td * g.th * g.tw) return;
  const int id = d0 + qi / (g.th * g.tw), ih = h0 + qi / g.tw % g.th, iw = w0 + qi % g.tw;
  if (id >= g.d || ih >= g.h || iw >= g.w) return;
  const long long pos = b_pos + ((long long)id * g.h + ih) * g.w + iw;

  float4 qr[NV];
  load_row<NV>(qr, p.q + pos * g.q_ps + head * g.ch, l, g.ch, g.vec4);
#pragma unroll
  for (int jj = 0; jj < NV; ++jj)
    qr[jj] = make_float4(qr[jj].x * g.scale, qr[jj].y * g.scale, qr[jj].z * g.scale,
                         qr[jj].w * g.scale);

  const int sd = window_start(id, g.d, g.kd), sh = window_start(ih, g.h, g.kh);
  const int sw = g.circular_w ? iw - g.kw / 2 : window_start(iw, g.w, g.kw);
  float m = NEG, lsum = 0.f;
  float4 acc[NV];
#pragma unroll
  for (int jj = 0; jj < NV; ++jj) acc[jj] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int x = 0; x < g.kd; ++x) {
    const int row_d = (sd + x - lo_d) * g.uh;
    const int rel_d = (sd + x - id + g.kd - 1) * nrh;
    for (int y = 0; y < g.kh; ++y) {
      const int row_h = (row_d + sh + y - lo_h) * g.uw;
      const int rel_h = (rel_d + sh + y - ih + g.kh - 1) * nrw;
      for (int z = 0; z < g.kw; ++z) {
        int lw = sw + z - lo_w;
        if (lw >= sp_w) lw -= g.w;  // circular halo capped at W positions
        const float* kr = Ks + (row_h + lw) * LD + 4 * l;
        float s = 0.f;
#pragma unroll
        for (int jj = 0; jj < NV; ++jj)
          s = dot4(qr[jj], *reinterpret_cast<const float4*>(kr + 16 * jj), s);
        s += __shfl_xor_sync(group, s, 8);
        s += __shfl_xor_sync(group, s, 16);
        if (p.rpb != nullptr)
          s += Rs[rel_h + (g.circular_w ? z + g.kw - 1 - g.kw / 2 : sw + z - iw + g.kw - 1)];
        if (s > m) {
          const float a = expf(m - s);
          lsum *= a;
#pragma unroll
          for (int jj = 0; jj < NV; ++jj)
            acc[jj] = make_float4(acc[jj].x * a, acc[jj].y * a, acc[jj].z * a, acc[jj].w * a);
          m = s;
        }
        const float pr = expf(s - m);
        lsum += pr;
        const float* vr = Vs + (row_h + lw) * LD + 4 * l;
#pragma unroll
        for (int jj = 0; jj < NV; ++jj)
          acc[jj] = axpy4(pr, *reinterpret_cast<const float4*>(vr + 16 * jj), acc[jj]);
      }
    }
  }

  const int hc = g.heads * g.ch;
  store_row<NV>(p.out + pos * hc + head * g.ch, acc, 1.f / lsum, l, g.ch, g.vec4);
  if (p.lse != nullptr && l == 0) p.lse[pos * g.heads + head] = m + logf(lsum);
}

template <int CP, int MAXT>
int launch(const Params& p, cudaStream_t stream) {
  const Geometry& g = p.g;
  const int threads = (4 * g.td * g.th * g.tw + 31) / 32 * 32;
  if (threads > MAXT) return (int)cudaErrorInvalidValue;
  const int n_rel = (2 * g.kd - 1) * (2 * g.kh - 1) * (2 * g.kw - 1);
  const size_t smem =
      sizeof(float) * ((size_t)2 * g.ud * g.uh * g.uw * (CP + 4) + (p.rpb != nullptr ? n_rel : 0));
  cudaError_t err = cudaFuncSetAttribute(natten_forward_kernel<CP, MAXT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (g.d + g.td - 1) / g.td * ((g.h + g.th - 1) / g.th) * ((g.w + g.tw - 1) / g.tw);
  const dim3 grid(n_tiles, g.heads, g.batch);
  natten_forward_kernel<CP, MAXT><<<grid, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing; returns a cudaError_t (0 on success), or
// cudaErrorInvalidValue for ch > 128 or a tile of more queries than the
// CTA takes. rpb and lse may be null. The tile (td, th, tw) and its halo
// extents (ud, uh, uw) come from the host, which checked them against the
// volume and the shared memory.
extern "C" int gwt_natten_flash_forward(const float* q, const float* k, const float* v,
                                        const float* rpb, float* out, float* lse, int batch,
                                        int d, int h, int w, int heads, int ch, long long q_ps,
                                        long long k_ps, long long v_ps, int kd, int kh, int kw,
                                        int circular_w, int td, int th, int tw, int ud, int uh,
                                        int uw, int vec4, float scale, void* stream) {
  const Params p{q, k, v, rpb, out, lse,
                 Geometry{batch, d, h, w, heads, ch, q_ps, k_ps, v_ps, kd, kh, kw, circular_w,
                          td, th, tw, ud, uh, uw, vec4, scale}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ch <= 16) return launch<16, 512>(p, s);
  if (ch <= 32) return launch<32, 512>(p, s);
  if (ch <= 64) return launch<64, 256>(p, s);
  if (ch <= 128) return launch<128, 128>(p, s);
  return (int)cudaErrorInvalidValue;
}
