// 3D neighborhood attention (NATTEN) backward for Hopper (sm_90a), FP32 on the
// CUDA cores, deterministic (no atomics).
//
// Replaces the Pallas TPU kernel K5b, graph_weather_tpu/ops/pallas/
// natten_flash.py: _flash_bwd_impl (the pallas_call of _flash_bwd_kernel),
// with the XLA halo overlap-add, circular fold and drpb segment-sum that
// followed it. Layouts and semantics are natten_flash.cu's. From the
// forward's lse, delta = rowsum(dO * out) [B, D, H, W, heads] and dO, with
// s = q_i . k_j * scale + rpb[rel(i, j)]:
//
//     p = exp(s - lse_i),  ds = p (dO_i . v_j - delta_i),
//     dq_i = scale sum_j ds k_j,  dk_j = scale sum_i ds q_i,  dv_j = sum_i p dO_i,
//     drpb[head, r] = sum of ds over every pair at relative offset r.
//
// Two kernels (`mode` of the C entry):
//
//   * dq (mode 0), over query tiles, shaped like the forward: the CTA stages
//     the K/V halo of its td x th x tw queries and rpb in shared memory with
//     cp.async; four lanes per query split ch; each query walks its window.
//     It keeps ds of every (query, slot) in shared memory and then sums it
//     per relative offset in a fixed order, one thread per offset, into
//     partial[cta, head, offset]; the host sums that over the CTAs.
//   * dk/dv (mode 1), over key tiles: each key walks the queries whose window
//     holds it. Per axis they are one contiguous range, (0 if j < k else
//     j - (k - 1 - k/2)) .. (size - 1 if j >= size - k else j + k/2), at
//     most k + k/2 positions on an axis of 2k or more; k modulo W on a
//     circular axis. The key's lanes hold k_j, v_j
//     and its dk, dv sums in registers and write them once: no overlap-add.
//     The queries' rows (q, dO, lse, delta) are read through L1: their union
//     for a key tile reaches up to k - 1 + k/2 positions past the tile at the
//     clamped edges, which at kernel (5, 7, 7) outgrows shared memory.
//
// What bounds it on an H100. At WeatherMesh's 1-degree latent ([1, 14, 45,
// 90], 4 heads x 32, kernel (3, 5, 5)) the backward must read q, k, v, out,
// dO and write dq, dk, dv (~232 MB, ~69 us at 3.35 TB/s) and compute s, dp,
// dq, dk and dv over 17 M pairs (5.4 GFLOP, ~81 us on the FP32 pipes); each
// pair is recomputed in both kernels, and its logit and dO.v cost four
// shuffles. Not yet here: tensor cores, bf16.

#include <cuda_runtime.h>

namespace {

constexpr int DQ = 0, DKV = 1;

struct Geometry {
  int batch, d, h, w, heads, ch;
  long long q_ps, k_ps, v_ps;  // floats between consecutive positions
  int kd, kh, kw, circular_w;
  int td, th, tw;  // positions per tile, per axis
  int ud, uh, uw;  // the most halo positions any tile stages, per axis (mode 0)
  int vec4;        // ch, strides and pointers allow 16-byte copies
  float scale;
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* rpb;    // or null
  const float* dout;   // [B, D, H, W, heads, ch], dense
  const float* lse;    // [B, D, H, W, heads]
  const float* delta;  // [B, D, H, W, heads]
  float* dq;           // dense, mode 0
  float* dk;           // dense, mode 1
  float* dv;           // dense, mode 1
  float* partial;      // [B * n_tiles, heads, n_rel] (mode 0, with rpb)
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

// The window slot of relative offset r for query i on one axis, or -1.
__device__ __forceinline__ int slot_of(int r, int i, int size, int k, bool circular) {
  const int s = circular ? r - (k - 1) + k / 2 : i + r - (k - 1) - window_start(i, size, k);
  return s >= 0 && s < k ? s : -1;
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
// (zero past ch), read through the read-only cache.
template <int NV>
__device__ __forceinline__ void load_row(float4 (&r)[NV], const float* row, int l, int ch,
                                         bool vec4) {
#pragma unroll
  for (int jj = 0; jj < NV; ++jj) {
    const int c = 4 * l + 16 * jj;
    if (vec4) {
      r[jj] = c < ch ? __ldg(reinterpret_cast<const float4*>(row + c))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      r[jj] = make_float4(c < ch ? __ldg(row + c) : 0.f, c + 1 < ch ? __ldg(row + c + 1) : 0.f,
                          c + 2 < ch ? __ldg(row + c + 2) : 0.f,
                          c + 3 < ch ? __ldg(row + c + 3) : 0.f);
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

// Tile blockIdx.x of the (td, th, tw) tiling -> its first position per axis.
__device__ __forceinline__ void tile_origin(const Geometry& g, int& d0, int& h0, int& w0) {
  const int ntw = (g.w + g.tw - 1) / g.tw, nth = (g.h + g.th - 1) / g.th;
  d0 = blockIdx.x / (ntw * nth) * g.td;
  h0 = blockIdx.x / ntw % nth * g.th;
  w0 = blockIdx.x % ntw * g.tw;
}

// Four lanes per position: lanes t, t + 8, t + 16, t + 24 of a warp. Returns
// false for a thread past the tile or the volume.
__device__ __forceinline__ bool my_position(const Geometry& g, int d0, int h0, int w0, int& pi,
                                            int& id, int& ih, int& iw) {
  const int lane = threadIdx.x & 31;
  pi = (threadIdx.x >> 5) * 8 + (lane & 7);
  id = d0 + pi / (g.th * g.tw);
  ih = h0 + pi / g.tw % g.th;
  iw = w0 + pi % g.tw;
  return pi < g.td * g.th * g.tw && id < g.d && ih < g.h && iw < g.w;
}

template <int CP, int MAXT>
__global__ void __launch_bounds__(MAXT) natten_dq_kernel(const Params p) {
  constexpr int LD = CP + 4;
  constexpr int NV = CP / 16;
  const Geometry g = p.g;
  extern __shared__ float4 smem4[];
  const int U = g.ud * g.uh * g.uw;
  const int n_slots = g.kd * g.kh * g.kw;
  const int nrh = 2 * g.kh - 1, nrw = 2 * g.kw - 1;
  const int n_rel = (2 * g.kd - 1) * nrh * nrw;
  float* Ks = reinterpret_cast<float*>(smem4);  // [U][LD]
  float* Vs = Ks + U * LD;                      // [U][LD]
  float* Rs = Vs + U * LD;                      // [n_rel] rpb of this head
  float* DSs = Rs + n_rel;                      // [tile queries][n_slots] ds (with rpb)

  int d0, h0, w0;
  tile_origin(g, d0, h0, w0);
  const int head = blockIdx.y;
  const long long b_pos = (long long)blockIdx.z * g.d * g.h * g.w;
  int lo_d, sp_d, lo_h, sp_h, lo_w, sp_w;
  window_span(d0, min(g.td, g.d - d0), g.d, g.kd, false, lo_d, sp_d);
  window_span(h0, min(g.th, g.h - h0), g.h, g.kh, false, lo_h, sp_h);
  window_span(w0, min(g.tw, g.w - w0), g.w, g.kw, g.circular_w, lo_w, sp_w);

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

  const int l = (threadIdx.x & 31) >> 3;
  const unsigned group = 0x01010101u << (threadIdx.x & 7);
  int qi, id, ih, iw;
  if (my_position(g, d0, h0, w0, qi, id, ih, iw)) {
    const long long pos = b_pos + ((long long)id * g.h + ih) * g.w + iw;
    const int hc = g.heads * g.ch;
    float4 qr[NV], dor[NV], dq[NV];
    load_row<NV>(qr, p.q + pos * g.q_ps + head * g.ch, l, g.ch, g.vec4);
    load_row<NV>(dor, p.dout + pos * hc + head * g.ch, l, g.ch, g.vec4);
#pragma unroll
    for (int jj = 0; jj < NV; ++jj) {
      qr[jj] = make_float4(qr[jj].x * g.scale, qr[jj].y * g.scale, qr[jj].z * g.scale,
                           qr[jj].w * g.scale);
      dq[jj] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const float lse = p.lse[pos * g.heads + head];
    const float delta = p.delta[pos * g.heads + head];
    const int sd = window_start(id, g.d, g.kd), sh = window_start(ih, g.h, g.kh);
    const int sw = g.circular_w ? iw - g.kw / 2 : window_start(iw, g.w, g.kw);
    int slot = 0;
    for (int x = 0; x < g.kd; ++x) {
      const int row_d = (sd + x - lo_d) * g.uh;
      const int rel_d = (sd + x - id + g.kd - 1) * nrh;
      for (int y = 0; y < g.kh; ++y) {
        const int row_h = (row_d + sh + y - lo_h) * g.uw;
        const int rel_h = (rel_d + sh + y - ih + g.kh - 1) * nrw;
        for (int z = 0; z < g.kw; ++z, ++slot) {
          int lw = sw + z - lo_w;
          if (lw >= sp_w) lw -= g.w;  // circular halo capped at W positions
          const float* kr = Ks + (row_h + lw) * LD + 4 * l;
          const float* vr = Vs + (row_h + lw) * LD + 4 * l;
          float4 kv[NV];
          float s = 0.f, dp = 0.f;
#pragma unroll
          for (int jj = 0; jj < NV; ++jj) {
            kv[jj] = *reinterpret_cast<const float4*>(kr + 16 * jj);
            s = dot4(qr[jj], kv[jj], s);
            dp = dot4(dor[jj], *reinterpret_cast<const float4*>(vr + 16 * jj), dp);
          }
          s += __shfl_xor_sync(group, s, 8);
          dp += __shfl_xor_sync(group, dp, 8);
          s += __shfl_xor_sync(group, s, 16);
          dp += __shfl_xor_sync(group, dp, 16);
          if (p.rpb != nullptr)
            s += Rs[rel_h + (g.circular_w ? z + g.kw - 1 - g.kw / 2 : sw + z - iw + g.kw - 1)];
          const float ds = expf(s - lse) * (dp - delta);
#pragma unroll
          for (int jj = 0; jj < NV; ++jj) dq[jj] = axpy4(ds, kv[jj], dq[jj]);
          if (p.rpb != nullptr && l == 0) DSs[qi * n_slots + slot] = ds;
        }
      }
    }
    store_row<NV>(p.dq + pos * hc + head * g.ch, dq, g.scale, l, g.ch, g.vec4);
  }
  if (p.rpb == nullptr || p.partial == nullptr) return;
  __syncthreads();

  // drpb partials: offset r sums ds over the tile's queries, in query order.
  const int tq = g.td * g.th * g.tw;
  for (int r = threadIdx.x; r < n_rel; r += blockDim.x) {
    const int rd = r / (nrh * nrw), rh = r / nrw % nrh, rw = r % nrw;
    float sum = 0.f;
    for (int q = 0; q < tq; ++q) {
      const int jd = d0 + q / (g.th * g.tw), jh = h0 + q / g.tw % g.th, jw = w0 + q % g.tw;
      if (jd >= g.d || jh >= g.h || jw >= g.w) continue;
      const int sx = slot_of(rd, jd, g.d, g.kd, false);
      const int sy = slot_of(rh, jh, g.h, g.kh, false);
      const int sz = slot_of(rw, jw, g.w, g.kw, g.circular_w);
      if (sx < 0 || sy < 0 || sz < 0) continue;
      sum += DSs[q * n_slots + (sx * g.kh + sy) * g.kw + sz];
    }
    p.partial[(((long long)blockIdx.z * gridDim.x + blockIdx.x) * g.heads + head) * n_rel + r] =
        sum;
  }
}

template <int CP, int MAXT>
__global__ void __launch_bounds__(MAXT) natten_dkv_kernel(const Params p) {
  constexpr int NV = CP / 16;
  const Geometry g = p.g;
  extern __shared__ float4 smem4[];
  float* Rs = reinterpret_cast<float*>(smem4);  // [n_rel] rpb of this head
  const int nrh = 2 * g.kh - 1, nrw = 2 * g.kw - 1;
  const int n_rel = (2 * g.kd - 1) * nrh * nrw;
  const int head = blockIdx.y;
  if (p.rpb != nullptr) {
    for (int i = threadIdx.x; i < n_rel; i += blockDim.x) Rs[i] = p.rpb[head * n_rel + i];
    __syncthreads();
  }
  int d0, h0, w0, ki, jd, jh, jw;
  tile_origin(g, d0, h0, w0);
  if (!my_position(g, d0, h0, w0, ki, jd, jh, jw)) return;
  const int l = (threadIdx.x & 31) >> 3;
  const unsigned group = 0x01010101u << (threadIdx.x & 7);
  const long long b_pos = (long long)blockIdx.z * g.d * g.h * g.w;
  const long long pos = b_pos + ((long long)jd * g.h + jh) * g.w + jw;
  const int hc = g.heads * g.ch;

  float4 kr[NV], vr[NV], dk[NV], dv[NV];
  load_row<NV>(kr, p.k + pos * g.k_ps + head * g.ch, l, g.ch, g.vec4);
  load_row<NV>(vr, p.v + pos * g.v_ps + head * g.ch, l, g.ch, g.vec4);
#pragma unroll
  for (int jj = 0; jj < NV; ++jj) {
    dk[jj] = make_float4(0.f, 0.f, 0.f, 0.f);
    dv[jj] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // The queries whose window holds this key, per axis.
  const int d_lo = jd < g.kd ? 0 : jd - (g.kd - 1 - g.kd / 2);
  const int d_hi = jd >= g.d - g.kd ? g.d - 1 : jd + g.kd / 2;
  const int h_lo = jh < g.kh ? 0 : jh - (g.kh - 1 - g.kh / 2);
  const int h_hi = jh >= g.h - g.kh ? g.h - 1 : jh + g.kh / 2;
  const int w_lo = g.circular_w || jw < g.kw ? 0 : jw - (g.kw - 1 - g.kw / 2);
  const int n_w = g.circular_w ? g.kw : (jw >= g.w - g.kw ? g.w - 1 : jw + g.kw / 2) - w_lo + 1;

  for (int id = d_lo; id <= d_hi; ++id) {
    const int rel_d = (jd - id + g.kd - 1) * nrh;
    for (int ih = h_lo; ih <= h_hi; ++ih) {
      const int rel_h = (rel_d + jh - ih + g.kh - 1) * nrw;
      const long long row = b_pos + ((long long)id * g.h + ih) * g.w;
      for (int t = 0; t < n_w; ++t) {
        // circular: slot t of query jw + kw/2 - t holds this key
        const int iw = g.circular_w ? wrap(jw + g.kw / 2 - t, g.w) : w_lo + t;
        const int rel_w = g.circular_w ? t + g.kw - 1 - g.kw / 2 : jw - iw + g.kw - 1;
        const long long qpos = row + iw;
        float4 qv[NV], dov[NV];
        load_row<NV>(qv, p.q + qpos * g.q_ps + head * g.ch, l, g.ch, g.vec4);
        load_row<NV>(dov, p.dout + qpos * hc + head * g.ch, l, g.ch, g.vec4);
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int jj = 0; jj < NV; ++jj) {
          s = dot4(qv[jj], kr[jj], s);
          dp = dot4(dov[jj], vr[jj], dp);
        }
        s += __shfl_xor_sync(group, s, 8);
        dp += __shfl_xor_sync(group, dp, 8);
        s += __shfl_xor_sync(group, s, 16);
        dp += __shfl_xor_sync(group, dp, 16);
        s *= g.scale;
        if (p.rpb != nullptr) s += Rs[rel_h + rel_w];
        const float pr = expf(s - __ldg(p.lse + qpos * g.heads + head));
        const float ds = pr * (dp - __ldg(p.delta + qpos * g.heads + head));
#pragma unroll
        for (int jj = 0; jj < NV; ++jj) {
          dv[jj] = axpy4(pr, dov[jj], dv[jj]);
          dk[jj] = axpy4(ds, qv[jj], dk[jj]);
        }
      }
    }
  }
  store_row<NV>(p.dk + pos * hc + head * g.ch, dk, g.scale, l, g.ch, g.vec4);
  store_row<NV>(p.dv + pos * hc + head * g.ch, dv, 1.f, l, g.ch, g.vec4);
}

template <int CP, int MAXT>
int launch(int mode, const Params& p, cudaStream_t stream) {
  const Geometry& g = p.g;
  const int tq = g.td * g.th * g.tw;
  const int threads = (4 * tq + 31) / 32 * 32;
  if (threads > MAXT) return (int)cudaErrorInvalidValue;
  const int n_rel = (2 * g.kd - 1) * (2 * g.kh - 1) * (2 * g.kw - 1);
  const int n_tiles = (g.d + g.td - 1) / g.td * ((g.h + g.th - 1) / g.th) * ((g.w + g.tw - 1) / g.tw);
  const dim3 grid(n_tiles, g.heads, g.batch);
  size_t smem = p.rpb != nullptr ? sizeof(float) * n_rel : 0;
  if (mode == DQ) {
    smem += sizeof(float) * (size_t)2 * g.ud * g.uh * g.uw * (CP + 4);
    if (p.rpb != nullptr) smem += sizeof(float) * (size_t)tq * g.kd * g.kh * g.kw;
    cudaError_t err = cudaFuncSetAttribute(natten_dq_kernel<CP, MAXT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    natten_dq_kernel<CP, MAXT><<<grid, threads, smem, stream>>>(p);
  } else {
    natten_dkv_kernel<CP, MAXT><<<grid, threads, smem, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). mode 0: dq, and the drpb partials
// when rpb and partial are given; mode 1: dk and dv. Launches on `stream`,
// does not synchronise, allocates nothing; returns a cudaError_t (0 on
// success), or cudaErrorInvalidValue for ch > 128, an unknown mode or a tile
// of more positions than the CTA takes. The tile and (mode 0) its halo
// extents come from the host, which checked them against the volume and the
// shared memory.
extern "C" int gwt_natten_flash_backward(int mode, const float* q, const float* k,
                                         const float* v, const float* rpb, const float* dout,
                                         const float* lse, const float* delta, float* dq,
                                         float* dk, float* dv, float* partial, int batch, int d,
                                         int h, int w, int heads, int ch, long long q_ps,
                                         long long k_ps, long long v_ps, int kd, int kh, int kw,
                                         int circular_w, int td, int th, int tw, int ud, int uh,
                                         int uw, int vec4, float scale, void* stream) {
  if (mode != DQ && mode != DKV) return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, rpb, dout, lse, delta, dq, dk, dv, partial,
                 Geometry{batch, d, h, w, heads, ch, q_ps, k_ps, v_ps, kd, kh, kw, circular_w,
                          td, th, tw, ud, uh, uw, vec4, scale}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ch <= 16) return launch<16, 512>(mode, p, s);
  if (ch <= 32) return launch<32, 512>(mode, p, s);
  if (ch <= 64) return launch<64, 256>(mode, p, s);
  if (ch <= 128) return launch<128, 128>(mode, p, s);
  return (int)cudaErrorInvalidValue;
}
