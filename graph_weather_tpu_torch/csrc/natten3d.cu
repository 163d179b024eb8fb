// 3D neighborhood attention (NATTEN) forward for Hopper (sm_90a), with each
// window slab staged once per tile in shared memory and register-tiled FP32
// products on the CUDA cores.
//
// Replaces the Pallas TPU kernel K6, graph_weather_tpu/ops/pallas/natten3d.py:
// _natten_fwd_impl (the pallas_call of _natten_kernel), which the JAX package
// runs for the shapes its halo-tiled kernel (natten_flash.py) refuses. Here it
// takes the shapes the port's K5a (natten_flash.cu) refuses: heads wider than
// 128 channels, and heads of 96 or 128 at kernel (5, 7, 7), whose 3D halo does
// not fit in shared memory. q, k, v are [B, D, H, W, heads, ch] f32 (views of
// one fused qkv tensor qualify: positions at a stride of their own, [heads,
// ch] dense). Query i attends to the kd x kh x kw keys of its window: on each
// axis the window starts at clip(i - k/2, 0, size - k), or at i - k/2 modulo
// W on a circular W axis. With q scaled by ch^-0.5 and rpb [heads, 2kd-1,
// 2kh-1, 2kw-1] added at the relative offset key - query + k - 1 (on a
// circular axis the same in unreduced coordinates: slot - k/2 + k - 1),
//
//     out[i] = sum_j softmax_j(q_i . k_j * scale + rpb[rel(i, j)]) v_j,
//
// with an online softmax in f32 from a running max of -1e30.
//
// What bounds it on an H100. At the 768-d WeatherMesh's 1-degree latent
// ([1, 14, 45, 90], 8 heads x 96, kernel (5, 7, 7)) one call computes 111.1 M
// (query, key, head) pairs: 42.67 GFLOP (0.637 ms at the 67 TFLOP/s FP32 peak)
// against 697 MB of q, k, v and out (0.208 ms at 3.35 TB/s), so operations
// bound it; read per (query, key) pair, k and v would take ~85 GB per layer
// through L1. Neighbouring queries share most of their keys, so the kernel
// stages each key once per tile and feeds each staged element to several
// queries:
//
//   * a CTA owns ROWS query rows (one warp each) by TW columns of one D
//     plane, of one (batch, head); a group of LANES lanes owns four
//     W-neighbouring queries, each lane ch / LANES of their channels
//     (float4 i of lane l: channels 4 l + 4 LANES i ..), so each k or v
//     float4 read from shared memory feeds four queries' FMAs;
//   * for each of the kd key planes (slabs) of the tile's D window, the CTA
//     copies the union of its queries' windows in that plane, at most
//     (ROWS + kh - 1) x (TW + kw - 1) positions (fewer at a clamped edge,
//     wrapped on a circular W axis), K and V, into shared memory with
//     cp.async; an item is a strip of ry of the union's rows by rx of its
//     columns (the whole slab where it fits), and the next item's copies are
//     in flight in a second stage while the current one is computed;
//   * per key row of the query row's window, in chunks of the four windows'
//     union of columns (4 + kw - 1 of them, 10 at kw = 7, 70% in a window),
//     the lanes form the 4 x 10 partial logits, sum them across the group by
//     a reduce-scatter (shuffles, no shared memory), leave each logit with
//     one lane, which masks it by its query's window (from coordinates), adds
//     rpb (read through L1, so that every rpb `takes` accepts, up to 227 KB
//     a head, leaves shared memory to the slabs) and runs the online
//     softmax step of its query;
//     p is then broadcast back (shuffles) and each lane accumulates p . v
//     for its channels of the four queries.
// A second design, split-TF32 tensor-core products of a warp's 4 x 4
// queries against its union (scripts/natten3d_mma.cu), ran 5.1-5.2 ms per
// layer on the 768-d layer against this one's 4.1-4.2 (scripts/
// natten3d_variants.py, PERF.md): the union's keys outside each window (51%
// there) and the three products of each split cost more than the FMAs they
// replace. Here shared-memory bandwidth and the shuffles share the limit
// with the FMA pipes.
// The host (ops/natten3d.py, `plan`) picks the lanes per query group, the
// CTA's rows and the item strip from the shape, before any launch, within
// 227 KB.
//
// For training the kernel also writes lse = m + log l [B, D, H, W, heads]
// in natural-log units (`lse` not null), from which the backward K6b
// (natten3d_bwd.cu) recomputes p on the same tiles: its dq pass is this
// loop with ds in place of p, its dk/dv pass the same staging with the roles
// of the query tile and the key slabs swapped. Serving passes null.
//
// bf16 (the JAX package's bf16 policy, gwt_natten3d_forward_bf16): q, k, v,
// rpb and out bf16, one instantiation of the same kernel on the element type.
// Its slabs are staged as f32, converted on the copy (plain loads, not
// cp.async), so it takes the f32 kernel's plans; the sums, the softmax and
// lse stay f32. q-hat is q times the bf16 scale in f32, unrounded, as XLA
// computes the JAX package's slot scan (`x * scale` upcast at once), and
// out is rounded to bf16 once; for training it also writes out32, the f32
// result before that rounding, from which the backward's delta is formed
// (the scan's gradient runs on that f32 value).
//
// Not yet here: tensor cores; bf16 staging by cp.async (slabs of half the
// bytes, larger items).

#include "clustered_tile.cuh"
#include "natten_elem.cuh"

namespace {

using namespace ctile;
using nelem::bf16;

constexpr float NEG_MAX = -1e30f;  // running-max start
constexpr int NQ = 4;              // W-neighbouring queries of a lane group
constexpr int NC = 10;             // columns of a chunk (the union at kw = 7)

struct Geometry {
  int batch, d, h, w, heads, ch;
  long long q_ps, k_ps, v_ps;  // floats between consecutive positions
  int kd, kh, kw, circular_w;
  float scale;
};

template <class T>
struct Params {
  const T* __restrict__ q;
  const T* __restrict__ k;
  const T* __restrict__ v;
  const T* __restrict__ rpb;  // or null
  T* __restrict__ out;        // [B, D, H, W, heads, ch], dense
  float* __restrict__ lse;    // [B, D, H, W, heads], or null
  float* __restrict__ out32;  // bf16 only: out before its rounding, f32, or null
  Geometry g;
  int rows;    // query rows of a CTA, one warp each
  int ry, rx;  // union rows and columns of an item
  int vec4;    // ch, the strides and the pointers allow 16-byte copies
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

// The CL channels a lane holds of a staged row (or a q or out row): float4
// i at channels 4 l + 4 LANES i .. + 3, so that the lanes of a group read
// one row's consecutive 16-byte words.
template <int CL, int LANES>
__device__ __forceinline__ void load_slice(float (&x)[CL], const float* row, int l) {
#pragma unroll
  for (int i = 0; i < CL / 4; ++i) {
    const float4 t = *reinterpret_cast<const float4*>(row + 4 * l + 4 * LANES * i);
    x[4 * i] = t.x;
    x[4 * i + 1] = t.y;
    x[4 * i + 2] = t.z;
    x[4 * i + 3] = t.w;
  }
}

// CL: channels of a lane (CP = CL LANES, a multiple of 32); LANES: lanes of
// a query group (8 or 16). The reduce-scatter leaves lane bits (from the
// top of the group) b1 b0 with query j = 2 b1 + b0 and the next bit with
// half of the chunk's columns; at 16 lanes the lowest bit's two lanes hold
// the same sums.
template <int CL, int LANES, class T>
__global__ void __launch_bounds__(256, 1) natten3d_forward_kernel(const Params<T> p) {
  constexpr int CP = CL * LANES;
  constexpr int LD = CP + 4;  // floats per staged row
  constexpr int GROUPS = 32 / LANES;
  constexpr int TW = NQ * GROUPS;  // query columns of a CTA
  constexpr int HALF = LANES / 8;  // the lane bit that picks the chunk's half
  const Geometry& g = p.g;
  const int threads = 32 * p.rows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int l = lane % LANES, base = lane - l;
  const int tiles_w = (g.w + TW - 1) / TW, tiles_h = (g.h + p.rows - 1) / p.rows;
  const int tile_w = blockIdx.x % tiles_w;
  const int tile_h = blockIdx.x / tiles_w % tiles_h;
  const int qd = blockIdx.x / (tiles_w * tiles_h);
  const int head = blockIdx.y;
  const long long b_pos = (long long)blockIdx.z * g.d * g.h * g.w;
  const int h0 = tile_h * p.rows, w0 = tile_w * TW;
  const int hl = min(h0 + p.rows, g.h) - 1, wl = min(w0 + TW, g.w) - 1;  // last queries
  // The tile's union of windows: rows [u0h, u1h), unreduced columns [u0w, u1w).
  const int u0h = window_start(h0, g.h, g.kh), u1h = window_start(hl, g.h, g.kh) + g.kh;
  const int u0w = start_w(g, w0), u1w = start_w(g, wl) + g.kw;
  const int sd = window_start(qd, g.d, g.kd);
  const int strips_h = (u1h - u0h + p.ry - 1) / p.ry, strips_w = (u1w - u0w + p.rx - 1) / p.rx;
  const int n_items = g.kd * strips_h * strips_w;
  const int item_floats = p.ry * p.rx * LD;

  extern __shared__ float4 smem4[];
  float* stage_base = reinterpret_cast<float*>(smem4);  // [2][K, V][ry * rx][LD]

  // This warp's query row and this group's four queries (repeating the last
  // query of the volume past it: computed, never stored).
  const bool row_live = h0 + warp < g.h;
  const int qh = min(h0 + warp, g.h - 1);
  const int sh = window_start(qh, g.h, g.kh);
  const int qw0 = w0 + NQ * (lane / LANES);
  int qw[NQ], sw[NQ];
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    qw[j] = min(qw0 + j, g.w - 1);
    sw[j] = start_w(g, qw[j]);
  }
  // The four windows' columns: [sw[0], sw[NQ - 1] + kw), in chunks of NC (as
  // many for every group of the warp: 3 + kw columns at most).
  const int n_chunks = (NQ - 1 + g.kw + NC - 1) / NC;
  // After the reduce-scatter this lane holds query my_j, columns my_u0 .. + 4.
  const int my_j = 2 * ((l / (LANES / 2)) & 1) + ((l / (LANES / 4)) & 1);
  const int my_u0 = (NC / 2) * ((l / HALF) & 1);
  const int my_qw = min(qw0 + my_j, g.w - 1);
  const int my_sw = start_w(g, my_qw);
  const int col = head * g.ch;

  float qr[NQ][CL], o[NQ][CL];
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    const T* row = p.q + (b_pos + ((long long)qd * g.h + qh) * g.w + qw[j]) * g.q_ps + col;
#pragma unroll
    for (int i = 0; i < CL / 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * l + 4 * LANES * i + e;
        qr[j][4 * i + e] = c < g.ch ? nelem::to_f(__ldg(row + c)) * g.scale : 0.f;
        o[j][4 * i + e] = 0.f;
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
    if constexpr (nelem::is_bf16<T>) {
      constexpr int per_row = CP / 8;  // eight channels a thread, converted to f32
      for (int i = tid; i < nrows * per_row; i += threads) {
        const int r = i / per_row, c = (i - r * per_row) * 8;
        const int yy = div_small(r, inv_cols);
        const long long pos = plane + (long long)(y0 + yy) * g.w + wrap_w(g, c0 + r - yy * ncols);
        nelem::convert8(ks_ + r * LD, p.k + pos * g.k_ps + col, c, g.ch, p.vec4, true);
        nelem::convert8(vs_ + r * LD, p.v + pos * g.v_ps + col, c, g.ch, p.vec4, true);
      }
    } else if (p.vec4) {
      constexpr int per_row = CP / 4;
      for (int i = tid; i < nrows * per_row; i += threads) {
        const int r = i / per_row, c = (i - r * per_row) * 4;
        const int yy = div_small(r, inv_cols);
        const long long pos = plane + (long long)(y0 + yy) * g.w + wrap_w(g, c0 + r - yy * ncols);
        const bool ok = c < g.ch;
        cp_async16(ks_ + r * LD + c, ok ? p.k + pos * g.k_ps + col + c : p.k, ok);
        cp_async16(vs_ + r * LD + c, ok ? p.v + pos * g.v_ps + col + c : p.v, ok);
      }
    } else {
      for (int i = tid; i < nrows * CP; i += threads) {
        const int r = i / CP, c = i - r * CP;
        const int yy = div_small(r, inv_cols);
        const long long pos = plane + (long long)(y0 + yy) * g.w + wrap_w(g, c0 + r - yy * ncols);
        const bool ok = c < g.ch;
        cp_async4(ks_ + r * LD + c, ok ? p.k + pos * g.k_ps + col + c : p.k, ok);
        cp_async4(vs_ + r * LD + c, ok ? p.v + pos * g.v_ps + col + c : p.v, ok);
      }
    }
  };

  const int nrh = 2 * g.kh - 1, nrw = 2 * g.kw - 1;
  const T* rpb_head = p.rpb ? p.rpb + (long long)head * (2 * g.kd - 1) * nrh * nrw : nullptr;
  float m = NEG_MAX, lsum = 0.f;  // query my_j's running max and (this lane's part of) its sum

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
    const int ncols = c1 - c0;
    const T* rpb_d =
        rpb_head ? rpb_head + (long long)(sd + x - qd + g.kd - 1) * nrh * nrw : nullptr;
    const int ya = max(y0, sh), yb = min(y1, sh + g.kh);  // the same for the whole warp
    for (int y = ya; y < yb; ++y) {
      const float* k_row = ks_ + (y - y0) * ncols * LD;
      const float* v_row = vs_ + (y - y0) * ncols * LD;
      for (int chunk = 0; chunk < n_chunks; ++chunk) {
        const int cs = sw[0] + NC * chunk;  // the chunk's first unreduced column
        // Partial logits of the four queries against the chunk's columns
        // (a column outside the item reads a staged one, and is masked).
        float s[NQ][NC];
#pragma unroll
        for (int u = 0; u < NC; ++u) {
          const int cu = min(max(cs + u - c0, 0), ncols - 1);
          float kv[CL];
          load_slice<CL, LANES>(kv, k_row + cu * LD, l);
#pragma unroll
          for (int j = 0; j < NQ; ++j) {
            float a = 0.f, b = 0.f;  // two chains for the FMA pipes' latency
#pragma unroll
            for (int c = 0; c < CL; c += 2) {
              a = fmaf(qr[j][c], kv[c], a);
              b = fmaf(qr[j][c + 1], kv[c + 1], b);
            }
            s[j][u] = a + b;
          }
        }
        // Reduce-scatter over the group: keep two queries, then one, then
        // half of the columns; at 16 lanes the last pair sums in full.
        float s2[2][NC];
        const bool hi2 = (l / (LANES / 2)) & 1;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int u = 0; u < NC; ++u) {
            const float send = hi2 ? s[jj][u] : s[2 + jj][u];
            const float keep = hi2 ? s[2 + jj][u] : s[jj][u];
            s2[jj][u] = keep + __shfl_xor_sync(0xffffffffu, send, LANES / 2);
          }
        float s1[NC];
        const bool hi1 = (l / (LANES / 4)) & 1;
#pragma unroll
        for (int u = 0; u < NC; ++u) {
          const float send = hi1 ? s2[0][u] : s2[1][u];
          const float keep = hi1 ? s2[1][u] : s2[0][u];
          s1[u] = keep + __shfl_xor_sync(0xffffffffu, send, LANES / 4);
        }
        float x5[NC / 2];
        const bool hi0 = (l / HALF) & 1;
#pragma unroll
        for (int u = 0; u < NC / 2; ++u) {
          const float send = hi0 ? s1[u] : s1[NC / 2 + u];
          const float keep = hi0 ? s1[NC / 2 + u] : s1[u];
          x5[u] = keep + __shfl_xor_sync(0xffffffffu, send, HALF);
          if constexpr (LANES == 16) x5[u] += __shfl_xor_sync(0xffffffffu, x5[u], 1);
        }
        // Query my_j's window and rpb, and its online softmax step.
        float cmax = NEG_MAX;
        unsigned valid = 0;
#pragma unroll
        for (int u = 0; u < NC / 2; ++u) {
          const int cu = cs + my_u0 + u;
          const bool in = cu >= c0 && cu < c1 && cu >= my_sw && cu < my_sw + g.kw;
          float xv = x5[u];
          if (in && rpb_d != nullptr)
            xv += nelem::to_f(__ldg(rpb_d + (y - qh + g.kh - 1) * nrw + (cu - my_qw + g.kw - 1)));
          x5[u] = xv;
          if (in) {
            valid |= 1u << u;
            cmax = fmaxf(cmax, xv);
          }
        }
        cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, HALF));
        const float m_new = fmaxf(m, cmax);
        const float alpha = exp_diff(m, m_new);
        m = m_new;
        lsum *= alpha;
#pragma unroll
        for (int u = 0; u < NC / 2; ++u) {
          x5[u] = (valid >> u) & 1u ? exp_diff(x5[u], m) : 0.f;
          lsum += x5[u];
        }
        // o[j] = alpha_j o[j] + sum_u p[j][u] v[u], p and alpha broadcast
        // from the lanes that hold them.
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const int src = base + (j >> 1) * (LANES / 2) + (j & 1) * (LANES / 4);
          const float a = __shfl_sync(0xffffffffu, alpha, src);
#pragma unroll
          for (int c = 0; c < CL; ++c) o[j][c] *= a;
        }
#pragma unroll
        for (int u = 0; u < NC; ++u) {
          const int cu = min(max(cs + u - c0, 0), ncols - 1);
          float vv[CL];
          load_slice<CL, LANES>(vv, v_row + cu * LD, l);
#pragma unroll
          for (int j = 0; j < NQ; ++j) {
            const int src = base + (j >> 1) * (LANES / 2) + (j & 1) * (LANES / 4) +
                            (u / (NC / 2)) * HALF;
            const float pj = __shfl_sync(0xffffffffu, x5[u % (NC / 2)], src);
#pragma unroll
            for (int c = 0; c < CL; ++c) o[j][c] = fmaf(pj, vv[c], o[j][c]);
          }
        }
      }
    }
    __syncthreads();  // the stage is free for the copy two items on
  }
  cp_async_wait<0>();

  // out = o / l for the group's queries inside the volume, and lse = m +
  // log l from the first lane that holds each query's m and l.
  lsum += __shfl_xor_sync(0xffffffffu, lsum, HALF);
  if (!row_live) return;
  if (p.lse != nullptr && (l & (2 * HALF - 1)) == 0 && qw0 + my_j < g.w)
    p.lse[(b_pos + ((long long)qd * g.h + qh) * g.w + qw0 + my_j) * g.heads + head] =
        m + logf(lsum);
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    const int src = base + (j >> 1) * (LANES / 2) + (j & 1) * (LANES / 4);
    const float lj = __shfl_sync(0xffffffffu, lsum, src);
    if (qw0 + j >= g.w) continue;
    const long long pos = b_pos + ((long long)qd * g.h + qh) * g.w + qw0 + j;
    T* dst = p.out + pos * ((long long)g.heads * g.ch) + col;
    float* dst32 = p.out32 != nullptr ? p.out32 + pos * ((long long)g.heads * g.ch) + col : nullptr;
    const float inv = 1.f / lj;
#pragma unroll
    for (int i = 0; i < CL / 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * l + 4 * LANES * i + e;
        if constexpr (nelem::is_bf16<T>) {
          nelem::store1(dst, c, g.ch, o[j][4 * i + e] * inv);
          if (dst32 != nullptr && c < g.ch) dst32[c] = o[j][4 * i + e] * inv;
        } else {
          if (c < g.ch) dst[c] = o[j][4 * i + e] * inv;
        }
      }
  }
}

template <int CL, int LANES, class T>
int launch(const Params<T>& p, cudaStream_t stream) {
  const Geometry& g = p.g;
  constexpr int LD = CL * LANES + 4;
  const size_t smem = sizeof(float) * (size_t)2 * 2 * p.ry * p.rx * LD;
  cudaError_t err = cudaFuncSetAttribute(natten3d_forward_kernel<CL, LANES, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int TW = NQ * 32 / LANES;
  const long long tiles = (long long)g.d * ((g.h + p.rows - 1) / p.rows) * ((g.w + TW - 1) / TW);
  const dim3 grid((unsigned)tiles, g.heads, g.batch);
  natten3d_forward_kernel<CL, LANES, T><<<grid, 32 * p.rows, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <class T>
int dispatch(const Params<T>& p, int cp, int lanes, cudaStream_t s) {
  if (p.rows < 1 || p.rows > 8 || p.ry < 1 || p.rx < 1 || p.g.ch > cp)
    return (int)cudaErrorInvalidValue;
  switch (cp * 32 + lanes) {
    case 32 * 32 + 8: return launch<4, 8>(p, s);
    case 64 * 32 + 8: return launch<8, 8>(p, s);
    case 96 * 32 + 8: return launch<12, 8>(p, s);
    case 128 * 32 + 16: return launch<8, 16>(p, s);
    case 256 * 32 + 16: return launch<16, 16>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing; returns a cudaError_t (0 on success), or
// cudaErrorInvalidValue for a (cp, lanes) that no instantiation has or a plan
// out of range. rpb and lse may be null. The host checked the kernel against the
// volume and batch and heads against the grid's limits (ops/natten3d.py,
// `takes`), and chose cp (the padded head width: 32, 64, 96, 128 or 256),
// the lanes of a query group (8, or 16 above 96 channels), the CTA's query
// rows (at most 8) and the item strip ry x rx so that two stages of K and V
// fit in shared memory (`plan`).
extern "C" int gwt_natten3d_forward(const float* q, const float* k, const float* v,
                                    const float* rpb, float* out, float* lse, int batch, int d,
                                    int h, int w, int heads, int ch, long long q_ps,
                                    long long k_ps, long long v_ps, int kd, int kh, int kw,
                                    int circular_w, int vec4, float scale, int cp, int lanes,
                                    int rows, int ry, int rx, void* stream) {
  const Params<float> p{q, k, v, rpb, out, lse, nullptr,
                        Geometry{batch, d, h, w, heads, ch, q_ps, k_ps, v_ps, kd, kh, kw,
                                 circular_w, scale},
                        rows, ry, rx, vec4};
  return dispatch(p, cp, lanes, static_cast<cudaStream_t>(stream));
}

// The bf16 mode: q, k, v, rpb and out bf16 (q_ps .. in elements), lse and
// out32 f32 or null; scale is the bf16 scale. vec: ch, the strides and the
// pointers allow 16-byte copies of eight channels. The plan is the f32
// kernel's for the same shape (`plan`).
extern "C" int gwt_natten3d_forward_bf16(const void* q, const void* k, const void* v,
                                         const void* rpb, void* out, float* lse, float* out32,
                                         int batch, int d, int h, int w, int heads, int ch,
                                         long long q_ps, long long k_ps, long long v_ps, int kd,
                                         int kh, int kw, int circular_w, int vec, float scale,
                                         int cp, int lanes, int rows, int ry, int rx,
                                         void* stream) {
  const Params<bf16> p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                       static_cast<const bf16*>(v), static_cast<const bf16*>(rpb),
                       static_cast<bf16*>(out), lse, out32,
                       Geometry{batch, d, h, w, heads, ch, q_ps, k_ps, v_ps, kd, kh, kw,
                                circular_w, scale},
                       rows, ry, rx, vec};
  return dispatch(p, cp, lanes, static_cast<cudaStream_t>(stream));
}
