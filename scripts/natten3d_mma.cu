// The other design of the 3D neighborhood attention forward K6 (see
// graph_weather_tpu_torch/csrc/natten3d.cu for the function, the layout and
// the staging of the window slabs, which this file shares), timed against it
// by scripts/natten3d_variants.py on the 768-d WeatherMesh's layer and built
// only there: split-TF32 tensor-core products instead of register-tiled FP32.
//
//   * a CTA owns 4 NWH x 4 NWW query positions of one D plane; each warp
//     owns 4 x 4 of them, the 16 rows of its mma tiles;
//   * the slabs are staged as in the shipped kernel, in items of RY union
//     rows by RX union columns, two cp.async stages;
//   * a warp takes the keys of the item that lie in its own 4 x 4 queries'
//     union (at most 10 x 10 at (5, 7, 7), 49% of them in each query's
//     window) in chunks of 8 NT keys: the logits of its 16 queries against
//     the chunk as mma.sync m16n8k8 products split into three TF32 products
//     (f32 accuracy), then the window from coordinates, rpb and the online
//     softmax, then p . v as split-TF32 products from the logits' registers;
//   * q of a warp stays in registers (in shared memory at CP = 256).
//
// The C entry takes (cp, nt, nwh, nww, ry, rx) after `scale`.

#include "clustered_tile.cuh"

namespace {

using namespace ctile;

constexpr float NEG_MAX = -1e30f;  // running-max start

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
  int nwh, nww;  // warps of a CTA along H and W (4 x 4 queries each)
  int ry, rx;    // union rows and columns of an item
  int vec4;      // ch, the strides and the pointers allow 16-byte copies
};

__device__ __forceinline__ int window_start(int i, int size, int k) {
  const int s = i - k / 2;
  return s < 0 ? 0 : (s > size - k ? size - k : s);
}

// The window start of query i on the W axis, unreduced on a circular axis.
__device__ __forceinline__ int start_w(const Geometry& g, int i) {
  return g.circular_w ? i - g.kw / 2 : window_start(i, g.w, g.kw);
}

// An unreduced column of a union, within (-W, 2W) since kw <= W, reduced.
__device__ __forceinline__ int wrap_w(const Geometry& g, int col) {
  return col < 0 ? col + g.w : (col >= g.w ? col - g.w : col);
}

// n / d for 0 <= n < 2^20 and 1 <= d, as one multiply: (n + 1/2) / d lies at
// least 1 / (2 d) from an integer, far above the rounding of the product.
__device__ __forceinline__ int div_small(int n, float inv_d) {
  return __float2int_rz((static_cast<float>(n) + 0.5f) * inv_d);
}

// CP: padded head width (a multiple of 8); NT: 8-key mma tiles per chunk;
// QSMEM: q of each warp in shared memory instead of registers.
template <int CP, int NT, bool QSMEM>
__global__ void __launch_bounds__(256, 1) natten3d_forward_kernel(const Params p) {
  constexpr int LD = CP + 4;  // floats per staged row
  constexpr int KS = CP / 8;  // k-steps of q . k, channel tiles of p . v
  const Geometry& g = p.g;
  const int threads = 32 * p.nwh * p.nww;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  const int th = 4 * p.nwh, tw = 4 * p.nww;
  const int tiles_w = (g.w + tw - 1) / tw, tiles_h = (g.h + th - 1) / th;
  const int tile_w = blockIdx.x % tiles_w;
  const int tile_h = blockIdx.x / tiles_w % tiles_h;
  const int qd = blockIdx.x / (tiles_w * tiles_h);
  const int head = blockIdx.y;
  const long long b_pos = (long long)blockIdx.z * g.d * g.h * g.w;
  const int h0 = tile_h * th, w0 = tile_w * tw;
  const int hl = min(h0 + th, g.h) - 1, wl = min(w0 + tw, g.w) - 1;  // last queries
  // The tile's union of windows: rows [u0h, u1h), unreduced columns [u0w, u1w).
  const int u0h = window_start(h0, g.h, g.kh), u1h = window_start(hl, g.h, g.kh) + g.kh;
  const int u0w = start_w(g, w0), u1w = start_w(g, wl) + g.kw;
  const int sd = window_start(qd, g.d, g.kd);
  const int strips_h = (u1h - u0h + p.ry - 1) / p.ry, strips_w = (u1w - u0w + p.rx - 1) / p.rx;
  const int n_items = g.kd * strips_h * strips_w;
  const int item_floats = p.ry * p.rx * LD;

  extern __shared__ float4 smem4[];
  float* stage_base = reinterpret_cast<float*>(smem4);  // [2][K, V][ry * rx][LD]
  float* q_smem = stage_base + 2 * 2 * item_floats;     // QSMEM: [warps][16][LD]

  // This warp's queries: rows h0 + 4 wh + .., columns w0 + 4 ww + ..; queries
  // past the volume repeat its last one (computed, never stored).
  const int wh = warp / p.nww, ww = warp % p.nww;
  const int qh0 = h0 + 4 * wh, qw0 = w0 + 4 * ww;
  const bool warp_live = qh0 < g.h && qw0 < g.w;
  const int qh_last = min(qh0 + 3, g.h - 1), qw_last = min(qw0 + 3, g.w - 1);
  // Its union: rows [wu0h, wu1h), columns [wu0w, wu1w).
  const int wu0h = window_start(min(qh0, g.h - 1), g.h, g.kh);
  const int wu1h = window_start(qh_last, g.h, g.kh) + g.kh;
  const int wu0w = start_w(g, min(qw0, g.w - 1)), wu1w = start_w(g, qw_last) + g.kw;
  // This thread's two query rows of the mma tiles: gq and gq + 8, that is
  // (qh0 + gq / 4, qw0 + gq % 4) and two rows further down.
  int qh[2], qw[2], sh[2], sw[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qh[r] = min(qh0 + gq / 4 + 2 * r, g.h - 1);
    qw[r] = min(qw0 + gq % 4, g.w - 1);
    sh[r] = window_start(qh[r], g.h, g.kh);
    sw[r] = start_w(g, qw[r]);
  }
  const int col = head * g.ch;

  // q: registers (the A fragments' raw floats) or this warp's rows in
  // shared memory; zeros past ch.
  float qf[QSMEM ? 1 : KS][4];
  float* qs = q_smem + warp * 16 * LD;
  {
    const long long pos0 = b_pos + ((long long)qd * g.h + qh[0]) * g.w + qw[0];
    const long long pos1 = b_pos + ((long long)qd * g.h + qh[1]) * g.w + qw[1];
    const float* r0 = p.q + pos0 * g.q_ps + col;
    const float* r1 = p.q + pos1 * g.q_ps + col;
    if constexpr (QSMEM) {
      for (int i = lane; i < 16 * CP; i += 32) {
        const int r = i / CP, c = i - r * CP;
        const int hh = min(qh0 + (r & 7) / 4 + 2 * (r >> 3), g.h - 1);
        const int wq = min(qw0 + r % 4, g.w - 1);
        const long long pos = b_pos + ((long long)qd * g.h + hh) * g.w + wq;
        qs[r * LD + c] = c < g.ch ? __ldg(p.q + pos * g.q_ps + col + c) : 0.f;
      }
      __syncwarp();
    } else {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int c0 = 8 * ks + t4, c1 = c0 + 4;
        qf[ks][0] = c0 < g.ch ? __ldg(r0 + c0) : 0.f;
        qf[ks][1] = c0 < g.ch ? __ldg(r1 + c0) : 0.f;
        qf[ks][2] = c1 < g.ch ? __ldg(r0 + c1) : 0.f;
        qf[ks][3] = c1 < g.ch ? __ldg(r1 + c1) : 0.f;
      }
    }
  }

  // Item `it`: slab x, union rows [y0, y1), unreduced columns [c0, c1).
  auto item_of = [&](int it, int& x, int& y0, int& y1, int& c0, int& c1) {
    const int sw_i = it % strips_w, rest = it / strips_w;
    const int sh_i = rest % strips_h;
    x = rest / strips_h;
    y0 = u0h + sh_i * p.ry;
    y1 = min(y0 + p.ry, u1h);
    c0 = u0w + sw_i * p.rx;
    c1 = min(c0 + p.rx, u1w);
  };
  auto copy_item = [&](int it, int stage) {
    int x, y0, y1, c0, c1;
    item_of(it, x, y0, y1, c0, c1);
    const int ncols = c1 - c0, nrows = (y1 - y0) * ncols;
    const float inv_cols = 1.f / ncols;
    float* ks_ = stage_base + stage * 2 * item_floats;
    float* vs_ = ks_ + item_floats;
    const long long plane = b_pos + (long long)(sd + x) * g.h * g.w;
    if (p.vec4) {
      constexpr int per_row = CP / 4;
      for (int i = tid; i < nrows * per_row; i += threads) {
        const int r = i / per_row, c = (i - r * per_row) * 4;
        const int yy = div_small(r, inv_cols);
        const int y = y0 + yy, cw = wrap_w(g, c0 + r - yy * ncols);
        const long long pos = plane + (long long)y * g.w + cw;
        const bool ok = c < g.ch;
        cp_async16(ks_ + r * LD + c, ok ? p.k + pos * g.k_ps + col + c : p.k, ok);
        cp_async16(vs_ + r * LD + c, ok ? p.v + pos * g.v_ps + col + c : p.v, ok);
      }
    } else {
      for (int i = tid; i < nrows * CP; i += threads) {
        const int r = i / CP, c = i - r * CP;
        const int yy = div_small(r, inv_cols);
        const int y = y0 + yy, cw = wrap_w(g, c0 + r - yy * ncols);
        const long long pos = plane + (long long)y * g.w + cw;
        const bool ok = c < g.ch;
        cp_async4(ks_ + r * LD + c, ok ? p.k + pos * g.k_ps + col + c : p.k, ok);
        cp_async4(vs_ + r * LD + c, ok ? p.v + pos * g.v_ps + col + c : p.v, ok);
      }
    }
  };

  const int nrh = 2 * g.kh - 1, nrw = 2 * g.kw - 1;
  const float* rpb_head = p.rpb ? p.rpb + (long long)head * (2 * g.kd - 1) * nrh * nrw : nullptr;

  float m[2] = {NEG_MAX, NEG_MAX}, l[2] = {0.f, 0.f};
  float o[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  copy_item(0, 0);
  cp_async_commit();
  for (int it = 0; it < n_items; ++it) {
    if (it + 1 < n_items) copy_item(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    int x, y0, y1, c0, c1;
    item_of(it, x, y0, y1, c0, c1);
    const float* ks_ = stage_base + (it & 1) * 2 * item_floats;
    const float* vs_ = ks_ + item_floats;
    // This warp's keys of the item: rows [ky0, ky1), columns [kc0, kc1).
    const int ky0 = max(y0, wu0h), ky1 = min(y1, wu1h);
    const int kc0 = max(c0, wu0w), kc1 = min(c1, wu1w);
    const int ncols = c1 - c0, nkc = kc1 - kc0;
    const int n_keys = warp_live && ky1 > ky0 && nkc > 0 ? (ky1 - ky0) * nkc : 0;
    const float* rpb_d = rpb_head ? rpb_head + (long long)(sd + x - qd + g.kd - 1) * nrh * nrw : nullptr;
    // The staged row of this warp's key n (clamped into the item: a key past
    // n_keys is masked, but must read finite data).
    const float inv_nkc = 1.f / max(nkc, 1);
    auto key_row = [&](int n) -> int {
      n = min(n, n_keys - 1);
      const int yy = div_small(n, inv_nkc);
      return (ky0 + yy - y0) * ncols + (kc0 + n - yy * nkc - c0);
    };

    for (int k0 = 0; k0 < n_keys; k0 += 8 * NT) {
      // Logits of the chunk's keys k0 .. k0 + 8 NT: s[nt] holds (row gq, key
      // 8 nt + 2 t4), (gq, +1), (gq + 8, 2 t4), (gq + 8, +1).
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      int brow[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) brow[nt] = key_row(k0 + 8 * nt + gq) * LD;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        FragA a;
        if constexpr (QSMEM) {
          a = load_a(qs, LD, 8 * kk, lane);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) split(qf[kk][e], a.big[e], a.small[e]);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (k0 + 8 * nt >= n_keys) continue;
          const float* kr = ks_ + brow[nt] + 8 * kk + t4;
          FragB bf;
          split(kr[0], bf.big[0], bf.small[0]);
          split(kr[4], bf.big[1], bf.small[1]);
          mma_tf32(s[nt], a.small, bf.big);
          mma_tf32(s[nt], a.big, bf.small);
          mma_tf32(s[nt], a.big, bf.big);
        }
      }
      // The window and rpb, then the online softmax: p in s.
      float cmax[2] = {NEG_MAX, NEG_MAX};
      unsigned valid = 0;  // bit 4 nt + e
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = k0 + 8 * nt + 2 * t4 + j;
          const int yy = div_small(n, inv_nkc);
          const int y = ky0 + yy, cu = kc0 + n - yy * nkc;  // key row, unreduced column
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 2 * r + j;
            const bool in = n < n_keys && y >= sh[r] && y < sh[r] + g.kh && cu >= sw[r] &&
                            cu < sw[r] + g.kw;
            float xv = s[nt][e] * g.scale;
            if (rpb_d != nullptr && in)
              xv += __ldg(rpb_d + (y - qh[r] + g.kh - 1) * nrw + (cu - qw[r] + g.kw - 1));
            s[nt][e] = xv;
            if (in) {
              valid |= 1u << (4 * nt + e);
              cmax[r] = fmaxf(cmax[r], xv);
            }
          }
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        cmax[r] = fmaxf(cmax[r], __shfl_xor_sync(0xffffffffu, cmax[r], 1));
        cmax[r] = fmaxf(cmax[r], __shfl_xor_sync(0xffffffffu, cmax[r], 2));
        const float m_new = fmaxf(m[r], cmax[r]);
        alpha[r] = exp_diff(m[r], m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pr = (valid >> (4 * nt + e)) & 1u ? exp_diff(s[nt][e], m[e >> 1]) : 0.f;
          s[nt][e] = pr;
          l[e >> 1] += pr;
        }
      // o += p . v over the chunk's keys.
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (k0 + 8 * nt >= n_keys) continue;
        const FragA a = a_from_acc(s[nt]);
        const float* v0 = vs_ + key_row(k0 + 8 * nt + 2 * t4) * LD + gq;
        const float* v1 = vs_ + key_row(k0 + 8 * nt + 2 * t4 + 1) * LD + gq;
#pragma unroll
        for (int n = 0; n < KS; ++n) {
          FragB bf;
          split(v0[8 * n], bf.big[0], bf.small[0]);
          split(v1[8 * n], bf.big[1], bf.small[1]);
          mma_tf32(o[n], a.small, bf.big);
          mma_tf32(o[n], a.big, bf.small);
          mma_tf32(o[n], a.big, bf.big);
        }
      }
    }
    __syncthreads();  // the stage is free for the copy two items on
  }
  cp_async_wait<0>();

  // out = o / l, rows gq and gq + 8 where they are queries of the volume.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (!warp_live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int hq = qh0 + gq / 4 + 2 * r, wq = qw0 + gq % 4;
    if (hq >= g.h || wq >= g.w) continue;
    const long long pos = b_pos + ((long long)qd * g.h + hq) * g.w + wq;
    float* dst = p.out + pos * ((long long)g.heads * g.ch) + col;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int n = 0; n < KS; ++n) {
      const int c = 8 * n + 2 * t4;
      if (c < g.ch) dst[c] = o[n][2 * r] * inv;
      if (c + 1 < g.ch) dst[c + 1] = o[n][2 * r + 1] * inv;
    }
  }
}

template <int CP, int NT, bool QSMEM>
int launch(const Params& p, cudaStream_t stream) {
  const Geometry& g = p.g;
  constexpr int LD = CP + 4;
  const int warps = p.nwh * p.nww;
  const size_t smem = sizeof(float) * ((size_t)2 * 2 * p.ry * p.rx * LD +
                                       (QSMEM ? (size_t)warps * 16 * LD : 0));
  cudaError_t err = cudaFuncSetAttribute(natten3d_forward_kernel<CP, NT, QSMEM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int th = 4 * p.nwh, tw = 4 * p.nww;
  const long long tiles = (long long)g.d * ((g.h + th - 1) / th) * ((g.w + tw - 1) / tw);
  const dim3 grid((unsigned)tiles, g.heads, g.batch);
  natten3d_forward_kernel<CP, NT, QSMEM><<<grid, 32 * warps, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing; returns a cudaError_t (0 on success), or
// cudaErrorInvalidValue for a (cp, nt) that no instantiation has or a plan
// out of range. rpb may be null; lse is not written (the same C interface as
// natten3d.cu's, whose lse serves training). The host checked the kernel against the volume and
// batch and heads against the grid's limits (ops/natten3d.py, `takes`), and
// chose cp (the padded head width: 16, 32, 64, 96, 128 or 256) and nt (the
// 8-key tiles of a chunk: 8, and 4 at cp 256), the warp grid
// nwh x nww (at most 8 warps) and the item strip ry x rx so that two stages
// of K and V fit in shared memory (`plan`).
extern "C" int gwt_natten3d_forward(const float* q, const float* k, const float* v,
                                    const float* rpb, float* out, float* /*lse*/, int batch,
                                    int d, int h, int w, int heads, int ch, long long q_ps,
                                    long long k_ps,
                                    long long v_ps, int kd, int kh, int kw, int circular_w,
                                    int vec4, float scale, int cp, int nt, int nwh, int nww,
                                    int ry, int rx, void* stream) {
  const Params p{q, k, v, rpb, out,
                 Geometry{batch, d, h, w, heads, ch, q_ps, k_ps, v_ps, kd, kh, kw, circular_w,
                          scale},
                 nwh, nww, ry, rx, vec4};
  if (nwh < 1 || nww < 1 || nwh * nww > 8 || ry < 1 || rx < 1 || ch > cp)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cp * 16 + nt) {
    case 16 * 16 + 8: return launch<16, 8, false>(p, s);
    case 32 * 16 + 8: return launch<32, 8, false>(p, s);
    case 64 * 16 + 8: return launch<64, 8, false>(p, s);
    case 96 * 16 + 8: return launch<96, 8, false>(p, s);
    case 128 * 16 + 8: return launch<128, 8, false>(p, s);
    case 256 * 16 + 4: return launch<256, 4, true>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
