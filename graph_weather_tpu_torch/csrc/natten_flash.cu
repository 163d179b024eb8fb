// 3D neighborhood attention (NATTEN) forward for Hopper (sm_90a), FP32 on the
// CUDA cores: lane groups of W-neighbouring queries over D-plane slabs of K
// and V staged in shared memory in two cp.async stages, and the lse.
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
// ~35 us at 3.35 TB/s) for 2.2 GFLOP (~33 us on the FP32 pipes). The design
// before this one gave each query four lanes of its own, walked its keys one
// at a time (a chain of loads, two shuffles, rpb and two exponentials per
// key, every staged row feeding one query) and staged the tile's whole 3D
// halo of K and V at once, so shared memory set the tile: one CTA of 16
// warps an SM at (3, 5, 5), one of 4 warps at (5, 7, 7), where it lost to
// SDPA on its own tiles. Here:
//
//   * a CTA owns td x th query rows (one warp each) of TW = NQ * 32 / LANES
//     W-columns, of one (batch, head); a group of LANES lanes owns NQ
//     W-neighbouring queries, each lane CL = CP / LANES of their channels
//     (float4 i of lane l: channels 4 l + 4 LANES i ..), so every k or v
//     float4 read from shared memory feeds NQ queries' FMAs;
//   * the key planes of the tile's D windows are walked one at a time: a
//     slab is the union of the tile's windows in one key plane, at most
//     (th + kh - 1) x (TW + kw - 1) positions (fewer at a clamped edge,
//     unwrapped on a circular W axis), K and V, copied into shared memory
//     with cp.async; an item is a strip of ry of the slab's rows by rx of
//     its columns (the whole slab where it fits), and the next item's copies
//     are in flight in a second stage while the current one is computed. A
//     warp computes the items of the planes in its query plane's window;
//   * per key row of its query row's window, a group walks its queries'
//     union of columns (NQ - 1 + kw of them) in chunks of NC: the lanes form
//     the NQ x NC partial logits, sum them across the group by a
//     reduce-scatter (shuffles: one halving of the queries per lane bit,
//     then one of the columns, wider groups then sum in full), and each lane
//     masks its query's logits by its window, adds rpb (staged in shared
//     memory) and runs the query's online-softmax step once per chunk; p is
//     then broadcast back and every lane accumulates p . v for its channels
//     of all NQ queries. Every group of a warp walks the same number of rows
//     and columns (its row's), so the shuffles stay convergent;
//   * logits are kept in log2 units (log2(e) folded into the scale and into
//     the staged rpb), so that p = exp2(x - m): a subtraction and the MUFU's
//     exp2, never a multiply-add of x and m; the running max starts at
//     -1e30 (exp2 of -1e30 - x is exactly 0), lse = (m + log2(l)) ln 2;
//   * no atomics and no sums across CTAs: the same inputs give the same bits.
// The host (ops/natten_flash.py, `_fwd_plan`) picks the lane group, the
// tile's td x th rows and the item strip from the shape, before any launch,
// within 227 KB: at (3, 5, 5) and (5, 7, 7) with 32 channels whole slabs, two
// CTAs (16 warps) an SM at 128 registers.
//
// What holds it now (scripts/k5a_variants.py, PERF.md §6): not the FMAs
// (without both products a case-a layer takes ~77% of its time, without the
// copies too ~64%), but each row chunk's chain of shared-memory loads,
// shuffles (the reduce-scatter's 5-7%, the broadcasts' 3-8% in cases a and
// c), masks and exponentials, at 16 warps an SM of which the D-plane split
// idles some (a warp walks kd of its tile's td + kd - 1 key planes). Groups
// of one or two queries, chunks of 4 or 6 columns, a rescale per key, one or
// three CTAs an SM, other splits of the CTA's rows and K6 on the same shapes
// were all slower or no faster; groups of four lanes at 32 channels (spilling
// at 128 registers) were 2% faster at (5, 7, 7) and 16% slower at (3, 5, 5).
//
// bf16 (gwt_natten_flash_forward_bf16): the TPU kernel's bf16 roundings.
// q-hat = bf16(q x the bf16 scale); f32 logits plus the bf16 bias; the TPU
// kernel then rounds the normalised p to bf16 before p . v, which needs each
// query's max m and sum l first: the same kernel on the element type walks
// its items twice, the first pass forming m and l (no V, no products with
// it), the second recomputing the logits and accumulating bf16(exp2(x - m)
// / l) . v in f32, rounded to bf16 once at the end. Slabs are staged as f32,
// converted on the copy (plain loads), so the plan is the f32 kernel's.
//
// Not yet here: tensor cores (K6's split-TF32 design of the same function
// lost to FP32 FMAs, scripts/natten3d_mma.cu).

#include "clustered_tile.cuh"
#include "natten_elem.cuh"

namespace {

using ctile::cp_async16;
using ctile::cp_async4;
using ctile::cp_async_commit;
using ctile::cp_async_wait;

constexpr float NEG_MAX = -1e30f;  // running-max start
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int NQ = 4;         // W-neighbouring queries of a lane group
constexpr int NC_SHORT = 8;   // columns of a chunk up to kw = 5 (NQ - 1 + kw)
constexpr int NC_LONG = 10;   // and above (the union of four windows at kw = 7)
constexpr int THREADS = 256;  // eight query rows (warps) a CTA
constexpr int COPY_F4 = 2;    // 16-byte copies of a staged row a thread issues

struct Geometry {
  int batch, d, h, w, heads, ch;
  long long q_ps, k_ps, v_ps;  // floats between consecutive positions
  int kd, kh, kw, circular_w;
  float scale;  // ch^-0.5 * log2(e); bf16: the bf16 ch^-0.5
};

template <class T>
struct Params {
  const T* __restrict__ q;
  const T* __restrict__ k;
  const T* __restrict__ v;
  const T* __restrict__ rpb;  // or null
  T* __restrict__ out;        // [B, D, H, W, heads, ch], dense
  float* __restrict__ lse;    // [B, D, H, W, heads], or null: not written
  Geometry g;
  int td, th;  // query planes and rows of a CTA (td * th warps)
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

// The CL channels a lane holds of a staged row: float4 i at channels
// 4 l + 4 LANES i .. + 3, so that the lanes of a group read one row's
// consecutive 16-byte words.
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

// CP: padded head width; CL: channels of a lane (LANES = CP / CL lanes a
// group); NC: columns of a chunk; MINB: CTAs an SM the registers allow; T:
// the element type (bf16: two passes over the items).
template <int CP, int CL, int NC, int MINB, class T>
__global__ void __launch_bounds__(THREADS, MINB) natten_forward_kernel(const Params<T> p) {
  constexpr bool BF = nelem::is_bf16<T>;
  constexpr int PASSES = BF ? 2 : 1;
  constexpr int LANES = CP / CL;
  constexpr int LD = CP + 4;  // floats per staged row
  constexpr int TW = NQ * 32 / LANES;  // query columns of a CTA
  constexpr int QL = LANES / NQ;       // lanes that share a query's sums
  constexpr bool HALVE = QL >= 2;      // the reduce-scatter halves the columns once
  constexpr int NCL = HALVE ? NC / 2 : NC;  // columns a lane holds
  static_assert(QL >= 1 && (!HALVE || NC % 2 == 0), "lane group layout");
  const Geometry& g = p.g;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int l = lane % LANES;
  const int tiles_w = (g.w + TW - 1) / TW, tiles_h = (g.h + p.th - 1) / p.th;
  const int d0 = blockIdx.x / (tiles_w * tiles_h) * p.td;
  const int h0 = blockIdx.x / tiles_w % tiles_h * p.th;
  const int w0 = blockIdx.x % tiles_w * TW;
  const int head = blockIdx.y;
  const long long b_pos = (long long)blockIdx.z * g.d * g.h * g.w;
  // The tile's union of windows: key planes [u0d, u1d), rows [u0h, u1h),
  // unreduced columns [u0w, u1w).
  const int dl = min(d0 + p.td, g.d) - 1, hl = min(h0 + p.th, g.h) - 1;
  const int wl = min(w0 + TW, g.w) - 1;
  const int u0d = window_start(d0, g.d, g.kd), u1d = window_start(dl, g.d, g.kd) + g.kd;
  const int u0h = window_start(h0, g.h, g.kh), u1h = window_start(hl, g.h, g.kh) + g.kh;
  const int u0w = start_w(g, w0), u1w = start_w(g, wl) + g.kw;
  const int strips_h = (u1h - u0h + p.ry - 1) / p.ry, strips_w = (u1w - u0w + p.rx - 1) / p.rx;
  const int n_items = (u1d - u0d) * strips_h * strips_w;
  const int item_floats = p.ry * p.rx * LD;
  const int nrh = 2 * g.kh - 1, nrw = 2 * g.kw - 1;
  const int n_rel = (2 * g.kd - 1) * nrh * nrw;

  extern __shared__ float4 smem4[];
  float* Rs = reinterpret_cast<float*>(smem4);  // [n_rel] rpb of this head, times log2(e)
  float* stage_base = Rs + (p.rpb != nullptr ? (n_rel + 3) & ~3 : 0);  // [2][K, V][ry * rx][LD]
  if (p.rpb != nullptr)
    for (int i = tid; i < n_rel; i += THREADS)
      Rs[i] = nelem::to_f(__ldg(p.rpb + (long long)head * n_rel + i)) * LOG2E;

  // This warp's query row and this group's queries (repeating the last
  // query of the volume past it: computed, never stored; a row past the
  // volume computes nothing).
  const bool row_live = d0 + warp / p.th < g.d && h0 + warp % p.th < g.h;
  const int qd = min(d0 + warp / p.th, g.d - 1), qh = min(h0 + warp % p.th, g.h - 1);
  const int sd = window_start(qd, g.d, g.kd), sh = window_start(qh, g.h, g.kh);
  const int qw0 = w0 + NQ * (lane / LANES);
  const int sw0 = start_w(g, min(qw0, g.w - 1));  // the group's first key column
  // The group's windows' columns: [sw0, start_w(last) + kw), in chunks of NC
  // (as many for every group of the warp: NQ - 1 + kw columns at most).
  const int n_chunks = (NQ - 1 + g.kw + NC - 1) / NC;
  // After the reduce-scatter this lane holds query my_j (the top lane bits
  // of the group spell it: lanes my_j * QL ..), columns my_u0 .. . Slot j of
  // its registers (qr, o, the partial logits) holds query j ^ my_j, so that
  // every lane of the reduce-scatter keeps the low slots and sends the high
  // ones, without a select; the lane holding query j ^ my_j's sums of
  // column half h is then (j * QL ^ qbits) + h * QL / 2 of the group.
  const int qbits = l & (LANES - QL);
  const int my_j = qbits / QL;
  const int my_u0 = HALVE && (l & (QL / 2)) ? NCL : 0;
  const int my_qw = min(qw0 + my_j, g.w - 1);
  const int my_sw = start_w(g, my_qw);
  const int col = head * g.ch;

  float qr[NQ][CL], o[NQ][CL];
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    const T* row =
        p.q + (b_pos + ((long long)qd * g.h + qh) * g.w + min(qw0 + (j ^ my_j), g.w - 1)) * g.q_ps +
        col;
#pragma unroll
    for (int i = 0; i < CL / 4; ++i) {
      const int c = 4 * l + 4 * LANES * i;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (BF) {
        x = nelem::load4(row, c, g.ch, p.vec4);
        // q-hat = bf16(q x scale), in log2 units
        x = make_float4(nelem::round_bf16(x.x * g.scale) * LOG2E,
                        nelem::round_bf16(x.y * g.scale) * LOG2E,
                        nelem::round_bf16(x.z * g.scale) * LOG2E,
                        nelem::round_bf16(x.w * g.scale) * LOG2E);
        qr[j][4 * i] = x.x;
        qr[j][4 * i + 1] = x.y;
        qr[j][4 * i + 2] = x.z;
        qr[j][4 * i + 3] = x.w;
      } else {
        if (p.vec4) {
          if (c < g.ch) x = __ldg(reinterpret_cast<const float4*>(row + c));
        } else {
          x = make_float4(c < g.ch ? __ldg(row + c) : 0.f, c + 1 < g.ch ? __ldg(row + c + 1) : 0.f,
                          c + 2 < g.ch ? __ldg(row + c + 2) : 0.f,
                          c + 3 < g.ch ? __ldg(row + c + 3) : 0.f);
        }
        qr[j][4 * i] = x.x * g.scale;
        qr[j][4 * i + 1] = x.y * g.scale;
        qr[j][4 * i + 2] = x.z * g.scale;
        qr[j][4 * i + 3] = x.w * g.scale;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][4 * i + e] = 0.f;
    }
  }

  // Item `it`: key plane kp, union rows [y0, y1), unreduced columns [c0, c1).
  auto item_of = [&](int it, int& kp, int& y0, int& y1, int& c0, int& c1) {
    const int sw_i = it % strips_w, rest = it / strips_w;
    const int sh_i = rest % strips_h;
    kp = u0d + rest / strips_h;
    y0 = u0h + sh_i * p.ry;
    y1 = min(y0 + p.ry, u1h);
    c0 = u0w + sw_i * p.rx;
    c1 = min(c0 + p.rx, u1w);
  };
  // Item `it` of the walk (of pass it / n_items in bf16: V from the second).
  auto copy_item = [&](int it, int stage) {
    const bool with_v = !BF || it >= n_items;
    if constexpr (BF) it %= n_items;
    int kp, y0, y1, c0, c1;
    item_of(it, kp, y0, y1, c0, c1);
    const int ncols = c1 - c0, nrows = (y1 - y0) * ncols;
    const float inv_cols = 1.f / ncols;
    float* ks_ = stage_base + stage * 2 * item_floats;
    float* vs_ = ks_ + item_floats;
    const long long plane = b_pos + (long long)kp * g.h * g.w;
    if constexpr (BF) {
      constexpr int per_row = CP / 8;  // eight channels a thread, converted to f32
      for (int i = tid; i < nrows * per_row; i += THREADS) {
        const int r = i / per_row, c = (i - r * per_row) * 8;
        const int yy = div_small(r, inv_cols);
        const long long pos = plane + (long long)(y0 + yy) * g.w + wrap_w(g, c0 + r - yy * ncols);
        nelem::convert8(ks_ + r * LD, p.k + pos * g.k_ps + col, c, g.ch, p.vec4, true);
        if (with_v) nelem::convert8(vs_ + r * LD, p.v + pos * g.v_ps + col, c, g.ch, p.vec4, true);
      }
    } else if (p.vec4) {
      constexpr int parts = CP / 4 / COPY_F4;  // threads that copy a row
      for (int i = tid; i < nrows * parts; i += THREADS) {
        const int r = i / parts, c = (i - r * parts) * 4 * COPY_F4;
        const int yy = div_small(r, inv_cols);
        const long long pos = plane + (long long)(y0 + yy) * g.w + wrap_w(g, c0 + r - yy * ncols);
        const T* k_src = p.k + pos * g.k_ps + col;
        const T* v_src = p.v + pos * g.v_ps + col;
#pragma unroll
        for (int f = 0; f < COPY_F4; ++f) {
          const int cf = c + 4 * f;
          const bool ok = cf < g.ch;
          cp_async16(ks_ + r * LD + cf, ok ? k_src + cf : p.k, ok);
          cp_async16(vs_ + r * LD + cf, ok ? v_src + cf : p.v, ok);
        }
      }
    } else {
      for (int i = tid; i < nrows * CP; i += THREADS) {
        const int r = i / CP, c = i - r * CP;
        const int yy = div_small(r, inv_cols);
        const long long pos = plane + (long long)(y0 + yy) * g.w + wrap_w(g, c0 + r - yy * ncols);
        const bool ok = c < g.ch;
        cp_async4(ks_ + r * LD + c, ok ? p.k + pos * g.k_ps + col + c : p.k, ok);
        cp_async4(vs_ + r * LD + c, ok ? p.v + pos * g.v_ps + col + c : p.v, ok);
      }
    }
  };

  float m = NEG_MAX, lsum = 0.f;  // query my_j's running max and (this lane's part of) its sum
  float inv_l = 0.f;              // bf16, second pass: 1 / l of query my_j

  copy_item(0, 0);
  cp_async_commit();
  for (int walk = 0; walk < PASSES * n_items; ++walk) {
    if (walk + 1 < PASSES * n_items) copy_item(walk + 1, (walk + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    if constexpr (BF) {
      if (walk == n_items) {  // the first pass is done: l of query my_j, whole
        if constexpr (HALVE) lsum += __shfl_xor_sync(0xffffffffu, lsum, QL / 2);
        inv_l = 1.f / lsum;
      }
    }
    const bool second = BF && walk >= n_items;
    const int it = BF ? walk % n_items : walk;
    __syncthreads();
    int kp, y0, y1, c0, c1;
    item_of(it, kp, y0, y1, c0, c1);
    // The same for the whole warp: its plane's window and its row's rows.
    const int ya = max(y0, sh), yb = min(y1, sh + g.kh);
    if (row_live && kp >= sd && kp < sd + g.kd && ya < yb) {
      const float* ks_ = stage_base + (walk & 1) * 2 * item_floats;
      const float* vs_ = ks_ + item_floats;
      const int ncols = c1 - c0;
      const float* rpb_d = p.rpb != nullptr ? Rs + (kp - qd + g.kd - 1) * nrh * nrw : nullptr;
      for (int y = ya; y < yb; ++y) {
        const float* k_row = ks_ + (y - y0) * ncols * LD;
        const float* v_row = vs_ + (y - y0) * ncols * LD;
        const float* rpb_h = rpb_d != nullptr ? rpb_d + (y - qh + g.kh - 1) * nrw : nullptr;
        for (int chunk = 0; chunk < n_chunks; ++chunk) {
          const int cs = sw0 + NC * chunk;  // the chunk's first unreduced column
          // Partial logits of the NQ queries against the chunk's columns (a
          // column outside the item reads a staged one, and is masked).
          float s[NQ][NC];
#pragma unroll
          for (int u = 0; u < NC; ++u) {
            const int cu = min(max(cs + u - c0, 0), ncols - 1);
            float kv[CL];
            load_slice<CL, LANES>(kv, k_row + cu * LD, l);
#pragma unroll
            for (int j = 0; j < NQ; ++j) {
              float a = 0.f;
#pragma unroll
              for (int c = 0; c < CL; ++c) a = fmaf(qr[j][c], kv[c], a);
              s[j][u] = a;
            }
          }
          // Reduce-scatter over the group: keep half of the queries per lane
          // bit from the top (the low slots), then half of the columns; lower
          // bits sum in full.
#pragma unroll
          for (int half = NQ / 2, bit = LANES / 2; half > 0; half >>= 1, bit >>= 1)
#pragma unroll
            for (int jj = 0; jj < half; ++jj)
#pragma unroll
              for (int u = 0; u < NC; ++u)
                s[jj][u] += __shfl_xor_sync(0xffffffffu, s[jj + half][u], bit);
          float x[NCL];
          if constexpr (HALVE) {
            const bool hi = l & (QL / 2);
#pragma unroll
            for (int u = 0; u < NCL; ++u) {
              const float send = hi ? s[0][u] : s[0][NCL + u];
              const float keep = hi ? s[0][NCL + u] : s[0][u];
              x[u] = keep + __shfl_xor_sync(0xffffffffu, send, QL / 2);
            }
#pragma unroll
            for (int bit = QL / 4; bit > 0; bit >>= 1)
#pragma unroll
              for (int u = 0; u < NCL; ++u) x[u] += __shfl_xor_sync(0xffffffffu, x[u], bit);
          } else {
#pragma unroll
            for (int u = 0; u < NCL; ++u) x[u] = s[0][u];
          }
          // Query my_j's window and rpb, and its online softmax step.
          float cmax = NEG_MAX;
          unsigned valid = 0;
#pragma unroll
          for (int u = 0; u < NCL; ++u) {
            const int cu = cs + my_u0 + u;
            const bool in = cu >= c0 && cu < c1 && cu >= my_sw && cu < my_sw + g.kw;
            if (in && rpb_h != nullptr) x[u] += rpb_h[cu - my_qw + g.kw - 1];
            if (in) {
              valid |= 1u << u;
              cmax = fmaxf(cmax, x[u]);
            }
          }
          if constexpr (BF) {
            if (second) {
              // p-hat = bf16(exp2(x - m) / l), the TPU kernel's normalised p
#pragma unroll
              for (int u = 0; u < NCL; ++u)
                x[u] = (valid >> u) & 1u ? nelem::round_bf16(exp2f(x[u] - m) * inv_l) : 0.f;
#pragma unroll
              for (int u = 0; u < NC; ++u) {
                const int cu = min(max(cs + u - c0, 0), ncols - 1);
                float vv[CL];
                load_slice<CL, LANES>(vv, v_row + cu * LD, l);
#pragma unroll
                for (int j = 0; j < NQ; ++j) {
                  const float pj = __shfl_sync(0xffffffffu, x[u % NCL],
                                               (j * QL ^ qbits) + u / NCL * (QL / 2), LANES);
#pragma unroll
                  for (int c = 0; c < CL; ++c) o[j][c] = fmaf(pj, vv[c], o[j][c]);
                }
              }
              continue;
            }
          }
          if constexpr (HALVE) cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, QL / 2));
          const float m_new = fmaxf(m, cmax);
          const float alpha = exp2f(m - m_new);
          m = m_new;
          lsum *= alpha;
#pragma unroll
          for (int u = 0; u < NCL; ++u) {
            x[u] = (valid >> u) & 1u ? exp2f(x[u] - m) : 0.f;
            lsum += x[u];
          }
          if constexpr (!BF) {  // (bf16: the first pass forms m and l only)
            // o[j] = alpha_j o[j] + sum_u p[j][u] v[u], p and alpha broadcast
            // from the lanes that hold them.
#pragma unroll
            for (int j = 0; j < NQ; ++j) {
              const float a = __shfl_sync(0xffffffffu, alpha, j * QL ^ qbits, LANES);
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
                const float pj = __shfl_sync(0xffffffffu, x[u % NCL],
                                             (j * QL ^ qbits) + u / NCL * (QL / 2), LANES);
#pragma unroll
                for (int c = 0; c < CL; ++c) o[j][c] = fmaf(pj, vv[c], o[j][c]);
              }
            }
          }
        }
      }
    }
    __syncthreads();  // the stage is free for the copy two items on
  }
  cp_async_wait<0>();
  if (!row_live) return;  // a whole warp

  // out = o / l and lse for the group's queries inside the volume (bf16: o,
  // already normalised; lsum whole since the first pass).
  if constexpr (HALVE && !BF) lsum += __shfl_xor_sync(0xffffffffu, lsum, QL / 2);
  const long long row_pos = b_pos + ((long long)qd * g.h + qh) * g.w;
  if (p.lse != nullptr && l == qbits && qw0 + my_j < g.w)
    p.lse[(row_pos + qw0 + my_j) * g.heads + head] = (m + log2f(lsum)) * LN2;
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    const float lj = __shfl_sync(0xffffffffu, lsum, j * QL ^ qbits, LANES);
    if (qw0 + (j ^ my_j) >= g.w) continue;
    T* dst = p.out + (row_pos + qw0 + (j ^ my_j)) * ((long long)g.heads * g.ch) + col;
    if constexpr (BF) {
#pragma unroll
      for (int i = 0; i < CL / 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) nelem::store1(dst, 4 * l + 4 * LANES * i + e, g.ch, o[j][4 * i + e]);
    } else {
      const float inv = 1.f / lj;
#pragma unroll
      for (int i = 0; i < CL / 4; ++i) {
        const int c = 4 * l + 4 * LANES * i;
        const float4 x = make_float4(o[j][4 * i] * inv, o[j][4 * i + 1] * inv,
                                     o[j][4 * i + 2] * inv, o[j][4 * i + 3] * inv);
        if (p.vec4) {
          if (c < g.ch) *reinterpret_cast<float4*>(dst + c) = x;
        } else {
          if (c < g.ch) dst[c] = x.x;
          if (c + 1 < g.ch) dst[c + 1] = x.y;
          if (c + 2 < g.ch) dst[c + 2] = x.z;
          if (c + 3 < g.ch) dst[c + 3] = x.w;
        }
      }
    }
  }
}

template <int CP, int CL, int NC, int MINB, class T>
int launch(const Params<T>& p, cudaStream_t stream) {
  const Geometry& g = p.g;
  constexpr int LD = CP + 4;
  constexpr int TW = NQ * 32 / (CP / CL);
  const int n_rel = (2 * g.kd - 1) * (2 * g.kh - 1) * (2 * g.kw - 1);
  const size_t smem = sizeof(float) * ((p.rpb != nullptr ? (size_t)(n_rel + 3) / 4 * 4 : 0) +
                                       (size_t)2 * 2 * p.ry * p.rx * LD);
  cudaError_t err = cudaFuncSetAttribute(natten_forward_kernel<CP, CL, NC, MINB, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)((g.d + p.td - 1) / p.td) * ((g.h + p.th - 1) / p.th) *
                          ((g.w + TW - 1) / TW);
  const dim3 grid((unsigned)tiles, g.heads, g.batch);
  natten_forward_kernel<CP, CL, NC, MINB, T><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <class T>
int dispatch(const Params<T>& p, int cp, int lanes, int nc, cudaStream_t s) {
  if (p.td < 1 || p.th < 1 || p.td * p.th * 32 != THREADS || p.ry < 1 || p.rx < 1 || p.g.ch > cp)
    return (int)cudaErrorInvalidValue;
  switch ((cp * 32 + lanes) * 16 + nc) {
    case (16 * 32 + 4) * 16 + NC_SHORT: return launch<16, 4, NC_SHORT, 2>(p, s);
    case (16 * 32 + 4) * 16 + NC_LONG: return launch<16, 4, NC_LONG, 2>(p, s);
    case (32 * 32 + 8) * 16 + NC_SHORT: return launch<32, 4, NC_SHORT, 2>(p, s);
    case (32 * 32 + 8) * 16 + NC_LONG: return launch<32, 4, NC_LONG, 2>(p, s);
    case (64 * 32 + 8) * 16 + NC_SHORT: return launch<64, 8, NC_SHORT, 1>(p, s);
    case (64 * 32 + 8) * 16 + NC_LONG: return launch<64, 8, NC_LONG, 1>(p, s);
    case (128 * 32 + 16) * 16 + NC_SHORT: return launch<128, 8, NC_SHORT, 1>(p, s);
    case (128 * 32 + 16) * 16 + NC_LONG: return launch<128, 8, NC_LONG, 1>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing; returns a cudaError_t (0 on success), or
// cudaErrorInvalidValue for a (cp, lanes, nc) that no instantiation has or a
// plan out of range. rpb and lse may be null. The host checked the shape
// (`takes`) and chose, before any launch (`_fwd_plan`): cp (the padded head
// width: 16, 32, 64 or 128), the lanes of a query group, the columns of a
// chunk, the CTA's td x th query rows (td * th = 8) and the item strip
// ry x rx, so that rpb and two stages of K and V fit in shared memory.
extern "C" int gwt_natten_flash_forward(const float* q, const float* k, const float* v,
                                        const float* rpb, float* out, float* lse, int batch,
                                        int d, int h, int w, int heads, int ch, long long q_ps,
                                        long long k_ps, long long v_ps, int kd, int kh, int kw,
                                        int circular_w, int vec4, float scale, int cp, int lanes,
                                        int nc, int td, int th, int ry, int rx, void* stream) {
  const Params<float> p{q, k, v, rpb, out, lse,
                        Geometry{batch, d, h, w, heads, ch, q_ps, k_ps, v_ps, kd, kh, kw,
                                 circular_w, scale * LOG2E},
                        td, th, ry, rx, vec4};
  return dispatch(p, cp, lanes, nc, static_cast<cudaStream_t>(stream));
}

// The bf16 mode: q, k, v, rpb and out bf16 (strides in elements), lse f32 or
// null, scale the bf16 scale; vec: ch, the strides and the pointers allow
// 16-byte copies of eight channels. The plan is the f32 kernel's (`_fwd_plan`).
extern "C" int gwt_natten_flash_forward_bf16(const void* q, const void* k, const void* v,
                                             const void* rpb, void* out, float* lse, int batch,
                                             int d, int h, int w, int heads, int ch,
                                             long long q_ps, long long k_ps, long long v_ps,
                                             int kd, int kh, int kw, int circular_w, int vec,
                                             float scale, int cp, int lanes, int nc, int td,
                                             int th, int ry, int rx, void* stream) {
  using nelem::bf16;
  const Params<bf16> p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                       static_cast<const bf16*>(v), static_cast<const bf16*>(rpb),
                       static_cast<bf16*>(out), lse,
                       Geometry{batch, d, h, w, heads, ch, q_ps, k_ps, v_ps, kd, kh, kw,
                                circular_w, scale},
                       td, th, ry, rx, vec};
  return dispatch(p, cp, lanes, nc, static_cast<cudaStream_t>(stream));
}
