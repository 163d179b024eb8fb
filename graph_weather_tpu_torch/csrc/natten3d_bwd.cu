// 3D neighborhood attention (NATTEN) backward of the wide-head forward K6
// (natten3d.cu) for Hopper (sm_90a): K6b. FP32 on the CUDA cores,
// deterministic (no atomics), on K6's tiles.
//
// Replaces no Pallas kernel: the JAX package's K6 is a custom_vjp whose
// backward, _natten_bwd (graph_weather_tpu/ops/pallas/natten3d.py:455),
// differentiates the XLA slot scan (neighborhood_attention_3d_xla). This
// kernel computes that gradient for every shape K6 takes (heads up to 256
// channels, the 768-d WeatherMesh's 8 x 96 at kernel (5, 7, 7), which the
// halo tiles of K5b, natten_flash_bwd.cu, cannot hold). Layouts and
// semantics are natten3d.cu's. From K6's out and lse, and dO, with delta_i
// = dO_i . out_i and s = q_i . k_j * scale + rpb[rel(i, j)]:
//
//     p = exp(s - lse_i),  ds = p (dO_i . v_j - delta_i),
//     dq_i = scale sum_j ds k_j,  dk_j = scale sum_i ds q_i,  dv_j = sum_i p dO_i,
//     drpb[head, r] = sum of ds over every pair at relative offset r.
//
// Two kernels (`mode` of the C entry), joined by a slot table: p and ds of
// every (query, window slot, head), float2 (p, ds), query-major, [B, D, H,
// W, heads, kd, kh kw rounded up to even] (`table_at`; the pad keeps each
// key plane's slots on 16 bytes), which the host allocates for one layer's
// backward (0.91 GB at the 768-d layer) and frees after it.
//
//   * dq (mode 0): K6's forward loop with ds in place of p. A CTA owns ROWS
//     query rows (one warp each) by TW columns of one D plane, of one
//     (batch, head); a group of LANES lanes owns four W-neighbouring queries
//     (q, dO and the dq sums of its channels in registers; each query's
//     delta, dO . out, summed over the group's lanes first). For each of the
//     kd key planes of the tile's D window the CTA stages the union of its
//     windows in that plane, K and V, in items of ry union rows by rx union
//     columns, two cp.async stages (the next item in flight). Per key row of
//     its window a group takes the four windows' union of columns in chunks
//     of NC: the 4 x NC partial dots of q . k and of dO . v are summed over
//     the group by a reduce-scatter (shuffles) that leaves each lane five
//     (query, column) pairs; the lane masks them by its query's window, adds
//     rpb (through L1), forms p and ds, and stores (p, ds) of each in-window
//     pair at its slot of the table: every slot of every live query once
//     (on a clamped axis every slot of a window is in range), none for
//     out-of-window columns, 8 bytes a store, a lane's five slots
//     consecutive (the L2 merges them into whole sectors). ds is broadcast
//     back for the four queries' dq FMAs (k read from shared memory again).
//     With rpb each lane also writes its ds to a per-slab table of the
//     CTA's (query, slot) in shared memory, which the CTA sums after the
//     slab's last item, one thread per (rh, rw) offset in a fixed order,
//     from per-axis tables of each query's slot, into partial[cta, head,
//     n_rel]; one torch sum over the CTAs gives drpb.
//   * dk/dv (mode 1): a gather over the table, no dots. A CTA owns ROWS key
//     rows by TWK key columns of one D plane; a group of lanes owns NK
//     W-neighbouring keys (the dk, dv sums of its channels in registers).
//     The queries whose window holds a key are per axis a contiguous range
//     (its inverse window: at most k + k/2 positions on a clamped axis, k on
//     a circular one); the CTA walks the query planes of its plane's range
//     and stages, per plane, the union of its keys' inverse windows in items
//     of ry x rx positions, two cp.async stages: each position's q and dO
//     rows and its slots of this key plane from the table (16-byte copies).
//     Per query of its keys' union a group takes each key's (p, ds) from
//     the query's staged slots, at the key's column less the query's window
//     start, (0, 0) where that is outside the window (one compare, no
//     branch); loads the query's dO slice and adds p dO to each key's dv,
//     then its q slice and adds ds q to each dk: no dot, reduce-scatter,
//     exponential, mask from coordinates or shuffle per pair, and each
//     staged slice feeds the FMAs of all NK keys. Each key's lanes write
//     its dk and dv once.
//
// What bounds it on an H100. At the 768-d WeatherMesh's 1-degree latent
// ([1, 14, 45, 90], 8 heads x 96, kernel (5, 7, 7)) the backward's
// function is s, dp, dq, dk and dv (10 ch flops a pair) over 111.1 M
// (query, key, head) pairs: 106.7 GFLOP, 1.59 ms at the 67 TFLOP/s FP32
// peak, against ~1.4 GB of q, k, v, out, dO, dq, dk, dv and lse (0.42 ms at
// 3.35 TB/s): operations bound it. The dq kernel does 6 ch a pair (0.96
// ms) and writes the table, the dk/dv kernel 4 ch (0.64 ms) and reads it:
// 0.91 GB each way, 0.27 ms at 3.35 TB/s, under either's operations. As in
// K6 each staged row feeds a group's four queries, and the dq kernel's
// chains of loads, shuffles, masks and exponentials per key row, not its
// FMAs, hold it (PERF.md §6); its table stores add ~5% to it. The dk/dv
// kernel has none of those chains; it is held by its staging: without its
// FMAs it keeps ~70% of its time (scripts/k6b_variants.py). Each staged
// position (q and dO rows and its slots, 1.2 KB at 96 channels) feeds only
// the CTA's 8 x 8 keys: at the 768-d layer the CTAs stage 6.7 M positions,
// 8.0 GB through L2 (each query's q and dO ~15 times, its slots ~3 times).
// On an H100 at 700 W the 768-d layer takes ~7.1 ms in the dq kernel and
// ~4.3 ms in the dk/dv kernel.
//
// The host (ops/natten3d.py, `plan_backward`) picks each kernel's lanes,
// rows and item strip from the shape, before any launch, within 227 KB, and
// the table's bytes.
//
// bf16 (gwt_natten3d_backward_bf16): the gradient of the JAX package's bf16
// slot scan as XLA computes it on bf16 q, k, v, rpb and dO (ops/natten3d.py,
// `slot_backward_reference`). q-hat is q times the bf16 scale in f32,
// unrounded, and delta = dO . out32, K6's f32 result before its rounding.
//   * dq (mode 0): this file's dq kernel on bf16 loads (slabs staged as f32,
//     converted on the copy), the same table of f32 p and ds; dq =
//     bf16(bf16(sum ds k) x scale), the scan's rounding of its f32 sum and
//     its bf16 product with the scale.
//   * dk/dv (mode 1): XLA transposes the scan. Each (query, slot) pair's ds
//     q-hat and p dO is rounded to bf16, scattered back by the transposes of
//     the slot's three per-axis takes (W, then H, then D, each adding in
//     bf16 in ascending query order) and added into the key's bf16 running
//     sum in reverse slot order. A lane group per key (CL channels a lane)
//     walks its slots from the last, per slot the queries that reach it
//     through that slot (per axis one query, or a run of them at a clamped
//     edge), nested W in H in D, rounding every sum; it reads each pair's p
//     and ds from the table and the query's q and dO rows through L1. In the
//     interior this is dk = bf16(dk + bf16(ds q-hat)).
//   * drpb (modes 2 and 3): per (slot, head) a CTA takes bf16(sum over the
//     batch of ds) from the table at every query and scatters it through the
//     transposes of the slot's bias gathers (along W into its 2kw - 1
//     offsets, then H, then D; each in ascending order in bf16) into
//     work[head, slot, n_rel]; mode 3 adds each offset's sums over the slots
//     in reverse order in bf16 (a thread per (head, offset)).
// The sums run in f32 on bf16 values; the slot table stays f32.
//
// Not yet here: tensor cores; a bf16 dk/dv kernel that stages its queries.

#include "clustered_tile.cuh"
#include "natten_elem.cuh"

namespace {

using namespace ctile;
using nelem::bf16;
using nelem::round_bf16;

constexpr int DQ = 0, DKV = 1, DRPB_SLOTS = 2, DRPB = 3;
constexpr int NQ = 4;    // dq: W-neighbouring queries of a lane group
constexpr int NC = 10;   // dq: key columns of a chunk (four windows' union at kw = 7)
constexpr int NK = 2;    // dk/dv: W-neighbouring keys of a lane group
constexpr int DKV_CTAS = 2;  // dk/dv: CTAs an SM (at most 128 registers a thread)
constexpr int SPLIT = 3; // halvings of a reduce-scatter: eight parts of a chunk's pairs

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
  const T* __restrict__ rpb;        // or null
  const T* __restrict__ dout;       // [B, D, H, W, heads, ch], dense
  const float* __restrict__ lse;    // [B, D, H, W, heads] (mode 0)
  const float* __restrict__ out;    // [B, D, H, W, heads, ch], dense, f32 (mode 0; bf16: out32)
  T* __restrict__ dq;               // dense, mode 0
  T* __restrict__ dk;               // dense, mode 1
  T* __restrict__ dv;               // dense, mode 1
  float* __restrict__ partial;      // [B * n_cta, heads, n_rel] (mode 0, with rpb; f32 only)
  float2* __restrict__ table;       // (p, ds) per slot (`table_at`): written in mode 0, read in 1
  float* __restrict__ work;         // bf16 drpb: per (head, slot) sums (modes 2 and 3)
  T* __restrict__ drpb;             // bf16 drpb [heads, n_rel] (mode 3)
  Geometry g;
  int rows;    // rows of a CTA's tile, one warp each
  int ry, rx;  // union rows and columns of an item
  int vec4;    // ch, the strides and the pointers allow 16-byte copies
};

__host__ __device__ constexpr int ilog2(int n) { return n <= 1 ? 0 : 1 + ilog2(n / 2); }

__device__ __forceinline__ int window_start(int i, int size, int k) {
  const int s = i - k / 2;
  return s < 0 ? 0 : (s > size - k ? size - k : s);
}

// The window start of query i on the W axis, unreduced on a circular axis.
__device__ __forceinline__ int start_w(const Geometry& g, int i) {
  return g.circular_w ? i - g.kw / 2 : window_start(i, g.w, g.kw);
}

// The first and last query whose window holds key j on one axis (unreduced
// on a circular axis).
__device__ __forceinline__ int inverse_lo(int j, int k, bool circular) {
  return circular ? j - (k - 1 - k / 2) : (j < k ? 0 : j - (k - 1 - k / 2));
}
__device__ __forceinline__ int inverse_hi(int j, int size, int k, bool circular) {
  return circular ? j + k / 2 : (j >= size - k ? size - 1 : j + k / 2);
}

// An unreduced column, within (-W, 2W) since kw <= W, reduced.
__device__ __forceinline__ int wrap_w(const Geometry& g, int col) {
  return col < 0 ? col + g.w : (col >= g.w ? col - g.w : col);
}

// The window slot of relative offset r for query i on one axis, or -1.
__device__ __forceinline__ int slot_of(int r, int i, int size, int k, bool circular) {
  const int s = circular ? r - (k - 1) + k / 2 : i + r - (k - 1) - window_start(i, size, k);
  return s >= 0 && s < k ? s : -1;
}

// Slots of a key plane in the table: kh kw, rounded up to even so that
// each plane's slots start on 16 bytes.
__host__ __device__ __forceinline__ int slab_slots(const Geometry& g) {
  return (g.kh * g.kw + 1) & ~1;
}

// The table's entry of the query at in-batch position `pos` of batch `b`,
// head `head`, window slot (x, s): key plane x of its window, s = y kw + z
// within the plane. Query-major, [B, D, H, W, heads, kd, slab_slots]: each
// query's slots of a head contiguous, the pad after a plane's slots never
// written or read.
__device__ __forceinline__ long long table_at(const Geometry& g, int b, long long pos, int head,
                                              int x, int s) {
  return ((((long long)b * g.d * g.h * g.w + pos) * g.heads + head) * g.kd + x) * slab_slots(g) + s;
}

// n / d for 0 <= n < 2^20 and 1 <= d, as one multiply (natten3d.cu).
__device__ __forceinline__ int div_small(int n, float inv_d) {
  return __float2int_rz((static_cast<float>(n) + 0.5f) * inv_d);
}

// The CL channels a lane holds of a row: float4 i at channels 4 l + 4 LANES
// i .. + 3, so that the lanes of a group read a row's consecutive 16-byte
// words. From shared memory (zeros past ch, as staged).
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

// The same from global memory, times `mul`, zeros past ch.
template <int CL, int LANES, class T>
__device__ __forceinline__ void load_global(float (&x)[CL], const T* row, int l, int ch,
                                            float mul) {
#pragma unroll
  for (int i = 0; i < CL / 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 4 * l + 4 * LANES * i + e;
      x[4 * i + e] = c < ch ? nelem::to_f(__ldg(row + c)) * mul : 0.f;
    }
}

// x times `mul` into a global row: f32 as it is; bf16 as the slot scan's
// dq, bf16(bf16(x) mul) (mul the bf16 scale), or bf16(x) for mul 1.
template <int CL, int LANES, class T>
__device__ __forceinline__ void store_global(T* row, const float (&x)[CL], int l, int ch,
                                             float mul) {
#pragma unroll
  for (int i = 0; i < CL / 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 4 * l + 4 * LANES * i + e;
      if constexpr (nelem::is_bf16<T>) {
        nelem::store1(row, c, ch, round_bf16(x[4 * i + e]) * mul);
      } else {
        if (c < ch) row[c] = x[4 * i + e] * mul;
      }
    }
}

template <int CL>
__device__ __forceinline__ float dot(const float (&a)[CL], const float (&b)[CL]) {
  float x = 0.f, y = 0.f;  // two chains for the FMA pipes' latency
#pragma unroll
  for (int c = 0; c < CL; c += 2) {
    x = fmaf(a[c], b[c], x);
    y = fmaf(a[c + 1], b[c + 1], y);
  }
  return x + y;
}

template <int CL>
__device__ __forceinline__ void axpy(float a, const float (&x)[CL], float (&y)[CL]) {
#pragma unroll
  for (int c = 0; c < CL; ++c) y[c] = fmaf(a, x[c], y[c]);
}

// One halving of a reduce-scatter: lanes with `bit` set keep a[H:2H), the
// others a[0:H), each summed with its partner's, in a[0:H).
template <int H, int N>
__device__ __forceinline__ void halve(float (&a)[N], int bit, int l) {
  const bool hi = l & bit;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = hi ? a[i] : a[H + i];
    const float keep = hi ? a[H + i] : a[i];
    a[i] = keep + __shfl_xor_sync(0xffffffffu, send, bit);
  }
}

// Sums a[0:N) over the LANES lanes of a group (l: the lane within it) and
// scatters the sums in SPLIT = 3 halvings: afterwards a[0:N / 8) holds the
// sums of a[N / 8 * part ..) with part = l >> (log2 LANES - 3); lanes that
// differ only in the bits below it hold the same sums.
template <int N, int LANES>
__device__ __forceinline__ void reduce_scatter(float (&a)[N], int l) {
  static_assert(SPLIT == 3 && N % 8 == 0 && LANES >= 8, "lane group layout");
  halve<N / 2>(a, LANES / 2, l);
  halve<N / 4>(a, LANES / 4, l);
  halve<N / 8>(a, LANES / 8, l);
#pragma unroll
  for (int bit = LANES / 16; bit > 0; bit >>= 1)
#pragma unroll
    for (int i = 0; i < N / 8; ++i) a[i] += __shfl_xor_sync(0xffffffffu, a[i], bit);
}

// cp.async copies of `nrows` positions' CP channels (zeros past ch) into
// rows of LD floats; pos(r) gives row r's element offset in `src`. bf16:
// plain loads of eight channels, converted to f32.
template <int CP, class T, class Pos>
__device__ __forceinline__ void copy_positions(float* dst, const T* src, int nrows, int ld,
                                               const Params<T>& p, int threads, Pos pos) {
  if constexpr (nelem::is_bf16<T>) {
    constexpr int per_row = CP / 8;
    for (int i = threadIdx.x; i < nrows * per_row; i += threads) {
      const int r = i / per_row, c = (i - r * per_row) * 8;
      nelem::convert8(dst + r * ld, src + pos(r), c, p.g.ch, p.vec4, true);
    }
  } else if (p.vec4) {
    constexpr int per_row = CP / 4;
    for (int i = threadIdx.x; i < nrows * per_row; i += threads) {
      const int r = i / per_row, c = (i - r * per_row) * 4;
      const bool ok = c < p.g.ch;
      cp_async16(dst + r * ld + c, ok ? src + pos(r) + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < nrows * CP; i += threads) {
      const int r = i / CP, c = i - r * CP;
      const bool ok = c < p.g.ch;
      cp_async4(dst + r * ld + c, ok ? src + pos(r) + c : src, ok);
    }
  }
}

// CL: channels of a lane (CP = CL LANES); LANES: lanes of a query group (8,
// 16 or 32). After a reduce-scatter of a chunk's 4 x NC pairs (query-major)
// a lane holds query part / 2, columns (part % 2) NC / 2 .. + NC / 2.
template <int CL, int LANES, class T>
__global__ void __launch_bounds__(256, 1) natten3d_dq_kernel(const Params<T> p) {
  constexpr int CP = CL * LANES;
  constexpr int LD = CP + 4;  // floats per staged row
  constexpr int TW = NQ * 32 / LANES;  // query columns of a CTA
  constexpr int M = NQ * NC >> SPLIT;  // pairs a lane holds after a reduce-scatter
  constexpr int SHIFT = ilog2(LANES) - SPLIT;
  const Geometry& g = p.g;
  const int threads = 32 * p.rows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int l = lane % LANES, base = lane - l;
  const int tiles_w = (g.w + TW - 1) / TW, tiles_h = (g.h + p.rows - 1) / p.rows;
  const int h0 = blockIdx.x / tiles_w % tiles_h * p.rows, w0 = blockIdx.x % tiles_w * TW;
  const int qd = blockIdx.x / (tiles_w * tiles_h);
  const int head = blockIdx.y;
  const long long b_pos = (long long)blockIdx.z * g.d * g.h * g.w;
  const int hl = min(h0 + p.rows, g.h) - 1, wl = min(w0 + TW, g.w) - 1;  // last queries
  // The tile's union of windows: rows [u0h, u1h), unreduced columns [u0w, u1w).
  const int u0h = window_start(h0, g.h, g.kh), u1h = window_start(hl, g.h, g.kh) + g.kh;
  const int u0w = start_w(g, w0), u1w = start_w(g, wl) + g.kw;
  const int sd = window_start(qd, g.d, g.kd);
  const int strips_h = (u1h - u0h + p.ry - 1) / p.ry, strips_w = (u1w - u0w + p.rx - 1) / p.rx;
  const int slab_items = strips_h * strips_w;
  const int n_items = g.kd * slab_items;
  const int item_floats = p.ry * p.rx * LD;
  const int nrh = 2 * g.kh - 1, nrw = 2 * g.kw - 1;
  const int n_rel = (2 * g.kd - 1) * nrh * nrw;
  const int n_hw = g.kh * g.kw;  // window slots of a slab
  const bool drpb = p.rpb != nullptr && p.partial != nullptr;

  extern __shared__ float4 smem4[];
  float* stage_base = reinterpret_cast<float*>(smem4);  // [2][K, V][ry * rx][LD]
  float* ds_tab = stage_base + 4 * item_floats;         // [rows * TW][kh * kw] (drpb)
  signed char* t_h = reinterpret_cast<signed char*>(ds_tab + (drpb ? p.rows * TW * n_hw : 0));
  signed char* t_w = t_h + nrh * p.rows;  // per axis, each tile query's slot at an offset

  float* part_cta = drpb ? p.partial + (((long long)blockIdx.z * gridDim.x + blockIdx.x) *
                                            g.heads + head) * n_rel
                         : nullptr;
  const int rd0 = sd - qd + g.kd - 1;  // the D offset of key plane sd
  if (drpb) {
    for (int i = tid; i < nrh * p.rows; i += threads) {
      const int r = i / p.rows, qi = h0 + i % p.rows;
      t_h[i] = qi < g.h ? slot_of(r, qi, g.h, g.kh, false) : -1;
    }
    for (int i = tid; i < nrw * TW; i += threads) {
      const int r = i / TW, qi = w0 + i % TW;
      t_w[i] = qi < g.w ? slot_of(r, qi, g.w, g.kw, g.circular_w) : -1;
    }
    for (int i = tid; i < n_rel; i += threads) {  // D offsets that no key plane reaches
      const int rd = i / (nrh * nrw);
      if (rd < rd0 || rd >= rd0 + g.kd) part_cta[i] = 0.f;
    }
  }

  // This warp's query row and this group's four queries (repeating the last
  // query of the volume past it: computed, never stored).
  const bool row_live = h0 + warp < g.h;
  const int qh = min(h0 + warp, g.h - 1);
  const int sh = window_start(qh, g.h, g.kh);
  const int qw0 = w0 + NQ * (lane / LANES);
  const int sw0 = start_w(g, min(qw0, g.w - 1));  // the four windows' first column
  const int n_chunks = (NQ - 1 + g.kw + NC - 1) / NC;
  // After a reduce-scatter this lane holds query my_j, columns my_u0 .. + M.
  const int part = l >> SHIFT;
  const int my_j = part >> 1, my_u0 = M * (part & 1);
  const int my_qw = min(qw0 + my_j, g.w - 1);
  const int my_sw = start_w(g, my_qw);
  const long long my_in = ((long long)qd * g.h + qh) * g.w + my_qw;  // in the batch entry
  const long long my_pos = b_pos + my_in;
  const float my_lse = __ldg(p.lse + my_pos * g.heads + head);
  // One lane of those holding the same sums writes them, for a live query.
  const bool writes = row_live && qw0 + my_j < g.w && (l & ((1 << SHIFT) - 1)) == 0;
  const bool writes_ds = drpb && writes;
  float* my_ds = ds_tab + (warp * TW + qw0 - w0 + my_j) * n_hw;
  const int col = head * g.ch;
  const long long hc = (long long)g.heads * g.ch;

  float qr[NQ][CL], dor[NQ][CL], acc[NQ][CL];
  float my_delta = 0.f;  // delta of query my_j
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    const long long pos = b_pos + ((long long)qd * g.h + qh) * g.w + min(qw0 + j, g.w - 1);
    load_global<CL, LANES>(qr[j], p.q + pos * g.q_ps + col, l, g.ch, g.scale);
    load_global<CL, LANES>(dor[j], p.dout + pos * hc + col, l, g.ch, 1.f);
    // delta = dO . out of query j, its channels summed over the group in a
    // fixed order.
    float ov[CL];
    load_global<CL, LANES>(ov, p.out + pos * hc + col, l, g.ch, 1.f);
    float dj = dot<CL>(dor[j], ov);
#pragma unroll
    for (int bit = LANES / 2; bit > 0; bit >>= 1) dj += __shfl_xor_sync(0xffffffffu, dj, bit);
    if (my_j == j) my_delta = dj;
#pragma unroll
    for (int c = 0; c < CL; ++c) acc[j][c] = 0.f;
  }

  // Item `it`: slab x, union rows [y0, y1), unreduced columns [c0, c1).
  auto item_of = [&](int it, int& x, int& y0, int& y1, int& c0, int& c1) {
    const int sw_i = it % strips_w, rest = it / strips_w;
    x = rest / strips_h;
    y0 = u0h + rest % strips_h * p.ry;
    y1 = min(y0 + p.ry, u1h);
    c0 = u0w + sw_i * p.rx;
    c1 = min(c0 + p.rx, u1w);
  };
  auto copy_item = [&](int it, int stage) {
    int x, y0, y1, c0, c1;
    item_of(it, x, y0, y1, c0, c1);
    const int ncols = c1 - c0;
    const float inv_cols = 1.f / ncols;
    float* ks_ = stage_base + stage * 2 * item_floats;
    const long long plane = b_pos + (long long)(sd + x) * g.h * g.w;
    auto pos = [&](int r) {
      const int yy = div_small(r, inv_cols);
      return plane + (long long)(y0 + yy) * g.w + wrap_w(g, c0 + r - yy * ncols);
    };
    copy_positions<CP>(ks_, p.k + col, (y1 - y0) * ncols, LD, p, threads,
                       [&](int r) { return pos(r) * g.k_ps; });
    copy_positions<CP>(ks_ + item_floats, p.v + col, (y1 - y0) * ncols, LD, p, threads,
                       [&](int r) { return pos(r) * g.v_ps; });
  };

  const T* rpb_head =
      p.rpb ? p.rpb + (long long)head * (2 * g.kd - 1) * nrh * nrw : nullptr;

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
    const T* rpb_d = rpb_head ? rpb_head + (long long)(rd0 + x) * nrh * nrw : nullptr;
    const int ya = max(y0, sh), yb = min(y1, sh + g.kh);  // the same for the whole warp
    for (int y = ya; y < yb; ++y) {
      const float* k_row = ks_ + (y - y0) * ncols * LD;
      const float* v_row = vs_ + (y - y0) * ncols * LD;
      for (int chunk = 0; chunk < n_chunks; ++chunk) {
        const int cs = sw0 + NC * chunk;  // the chunk's first unreduced column
        // s and dp of the four queries against the chunk's columns (a column
        // outside the item reads a staged one, and is masked).
        float s[NQ * NC], dp[NQ * NC];
#pragma unroll
        for (int u = 0; u < NC; ++u) {
          float kv[CL];
          load_slice<CL, LANES>(kv, k_row + min(max(cs + u - c0, 0), ncols - 1) * LD, l);
#pragma unroll
          for (int j = 0; j < NQ; ++j) s[j * NC + u] = dot<CL>(qr[j], kv);
        }
        reduce_scatter<NQ * NC, LANES>(s, l);
#pragma unroll
        for (int u = 0; u < NC; ++u) {
          float vv[CL];
          load_slice<CL, LANES>(vv, v_row + min(max(cs + u - c0, 0), ncols - 1) * LD, l);
#pragma unroll
          for (int j = 0; j < NQ; ++j) dp[j * NC + u] = dot<CL>(dor[j], vv);
        }
        reduce_scatter<NQ * NC, LANES>(dp, l);
        // Query my_j's pairs: its window, rpb, p and ds, stored at their
        // slots of the table.
        const int slot_row = (y - sh) * g.kw - my_sw;  // + cu: the slot in plane x
        float ds[M];
#pragma unroll
        for (int u = 0; u < M; ++u) {
          const int cu = cs + my_u0 + u;
          const bool in = cu >= c0 && cu < c1 && cu >= my_sw && cu < my_sw + g.kw;
          float xv = s[u];
          if (in && rpb_d != nullptr)
            xv += nelem::to_f(__ldg(rpb_d + (y - qh + g.kh - 1) * nrw + (cu - my_qw + g.kw - 1)));
          const float pr = exp_diff(xv, my_lse);
          ds[u] = in ? pr * (dp[u] - my_delta) : 0.f;
          if (writes && in)
            p.table[table_at(g, blockIdx.z, my_in, head, x, slot_row + cu)] =
                make_float2(pr, ds[u]);
          if (writes_ds && in) my_ds[(y - sh) * g.kw + cu - my_sw] = ds[u];
        }
        // dq[j] += sum_u ds[j][u] k[u], ds broadcast from the lanes that hold it.
#pragma unroll
        for (int u = 0; u < NC; ++u) {
          float kv[CL];
          load_slice<CL, LANES>(kv, k_row + min(max(cs + u - c0, 0), ncols - 1) * LD, l);
#pragma unroll
          for (int j = 0; j < NQ; ++j) {
            const int src = base + ((2 * j + u / M) << SHIFT);
            axpy<CL>(__shfl_sync(0xffffffffu, ds[u % M], src), kv, acc[j]);
          }
        }
      }
    }
    __syncthreads();  // the stage is free for the copy two items on
    if (drpb && (it + 1) % slab_items == 0) {
      // Slab x is done: drpb partials at D offset rd0 + x, summed per (rh,
      // rw) over the tile's queries in query order.
      float* part_d = part_cta + (long long)(rd0 + x) * nrh * nrw;
      for (int r = tid; r < nrh * nrw; r += threads) {
        const int rh = r / nrw, rw = r - rh * nrw;
        float sum = 0.f;
        for (int qr_ = 0; qr_ < p.rows; ++qr_) {
          const int sy = t_h[rh * p.rows + qr_];
          if (sy < 0) continue;
          const float* row = ds_tab + qr_ * TW * n_hw + sy * g.kw;
          for (int qc = 0; qc < TW; ++qc) {
            const int sz = t_w[rw * TW + qc];
            if (sz >= 0) sum += row[qc * n_hw + sz];
          }
        }
        part_d[r] = sum;
      }
      // The next item's __syncthreads orders these reads before its writes.
    }
  }
  cp_async_wait<0>();

  if (!row_live) return;
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    if (qw0 + j >= g.w) continue;
    const long long pos = b_pos + ((long long)qd * g.h + qh) * g.w + qw0 + j;
    store_global<CL, LANES>(p.dq + pos * hc + col, acc[j], l, g.ch, g.scale);
  }
}

// The dk/dv kernel: a gather over the table, lanes owning channels.
template <int CL, int LANES>
__global__ void __launch_bounds__(256, DKV_CTAS) natten3d_dkv_kernel(const Params<float> p) {
  constexpr int CP = CL * LANES;
  constexpr int LD = CP + 4;  // floats per staged q or dO row
  constexpr int TWK = NK * 32 / LANES;  // key columns of a CTA
  const Geometry& g = p.g;
  const int threads = 32 * p.rows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int l = lane % LANES;
  const int tiles_w = (g.w + TWK - 1) / TWK, tiles_h = (g.h + p.rows - 1) / p.rows;
  const int h0 = blockIdx.x / tiles_w % tiles_h * p.rows, w0 = blockIdx.x % tiles_w * TWK;
  const int jd = blockIdx.x / (tiles_w * tiles_h);
  const int head = blockIdx.y;
  const long long b_pos = (long long)blockIdx.z * g.d * g.h * g.w;
  const int hl = min(h0 + p.rows, g.h) - 1, wl = min(w0 + TWK, g.w) - 1;  // last keys
  // The tile's inverse window: query planes [pd0, pd0 + n_planes), rows
  // [u0h, u1h), unreduced columns [u0w, u1w).
  const int pd0 = inverse_lo(jd, g.kd, false);
  const int n_planes = inverse_hi(jd, g.d, g.kd, false) - pd0 + 1;
  const int u0h = inverse_lo(h0, g.kh, false), u1h = inverse_hi(hl, g.h, g.kh, false) + 1;
  const int u0w = inverse_lo(w0, g.kw, g.circular_w);
  const int u1w = inverse_hi(wl, g.w, g.kw, g.circular_w) + 1;
  const int strips_h = (u1h - u0h + p.ry - 1) / p.ry, strips_w = (u1w - u0w + p.rx - 1) / p.rx;
  const int n_items = n_planes * strips_h * strips_w;
  const int item_pos = p.ry * p.rx;
  const int sp = slab_slots(g);
  // A stage: q rows, dO rows, and each position's (p, ds) of this key plane
  // (sp float2).
  const int stage_floats = item_pos * (2 * LD + 2 * sp);
  const long long hc = (long long)g.heads * g.ch;
  const int col = head * g.ch;

  extern __shared__ float4 smem4[];
  float* stage_base = reinterpret_cast<float*>(smem4);  // [2][stage_floats]

  // This warp's key row and this group's NK keys (repeating the last key of
  // the volume past it: computed, never stored).
  const bool row_live = h0 + warp < g.h;
  const int jh = min(h0 + warp, g.h - 1);
  const int qh_lo = inverse_lo(jh, g.kh, false);
  const int qh_hi = row_live ? inverse_hi(jh, g.h, g.kh, false) : qh_lo - 1;  // none: no work
  const int kw0 = w0 + NK * (lane / LANES);
  int kw_[NK];
#pragma unroll
  for (int j = 0; j < NK; ++j) kw_[j] = min(kw0 + j, g.w - 1);
  // The group's query columns: its keys' union of inverse windows.
  const int qc_lo = inverse_lo(kw_[0], g.kw, g.circular_w);
  const int qc_hi = inverse_hi(kw_[NK - 1], g.w, g.kw, g.circular_w);

  float dk[NK][CL], dv[NK][CL];
#pragma unroll
  for (int j = 0; j < NK; ++j)
#pragma unroll
    for (int c = 0; c < CL; ++c) dk[j][c] = dv[j][c] = 0.f;

  // Item `it`: query plane pd0 + x, union rows [y0, y1), unreduced columns [c0, c1).
  auto item_of = [&](int it, int& x, int& y0, int& y1, int& c0, int& c1) {
    const int sw_i = it % strips_w, rest = it / strips_w;
    x = rest / strips_h;
    y0 = u0h + rest % strips_h * p.ry;
    y1 = min(y0 + p.ry, u1h);
    c0 = u0w + sw_i * p.rx;
    c1 = min(c0 + p.rx, u1w);
  };
  auto copy_item = [&](int it, int stage) {
    int x, y0, y1, c0, c1;
    item_of(it, x, y0, y1, c0, c1);
    const int ncols = c1 - c0, n_pos = (y1 - y0) * ncols;
    const float inv_cols = 1.f / ncols;
    float* qs = stage_base + stage * stage_floats;
    const long long plane = (long long)(pd0 + x) * g.h * g.w;  // in the batch entry
    auto pos = [&](int r) {
      const int yy = div_small(r, inv_cols);
      return plane + (long long)(y0 + yy) * g.w + wrap_w(g, c0 + r - yy * ncols);
    };
    copy_positions<CP>(qs, p.q + col, n_pos, LD, p, threads,
                       [&](int r) { return (b_pos + pos(r)) * g.q_ps; });
    copy_positions<CP>(qs + item_pos * LD, p.dout + col, n_pos, LD, p, threads,
                       [&](int r) { return (b_pos + pos(r)) * hc; });
    // Each position's slots of this key plane in its window, 16 bytes a copy.
    float* ts = qs + 2 * item_pos * LD;
    const int slab = jd - window_start(pd0 + x, g.d, g.kd);
    const int per_pos = sp / 2;
    const float inv_per = 1.f / per_pos;
    for (int i = tid; i < n_pos * per_pos; i += threads) {
      const int r = div_small(i, inv_per), c = i - r * per_pos;
      cp_async16(ts + 2 * (r * sp + 2 * c),
                 reinterpret_cast<const float*>(p.table + table_at(g, blockIdx.z, pos(r), head,
                                                                   slab, 2 * c)),
                 true);
    }
  };

  copy_item(0, 0);
  cp_async_commit();
  for (int it = 0; it < n_items; ++it) {
    if (it + 1 < n_items) copy_item(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    int x, y0, y1, c0, c1;
    item_of(it, x, y0, y1, c0, c1);
    const float* qs = stage_base + (it & 1) * stage_floats;
    const float* dos = qs + item_pos * LD;
    const float2* ts = reinterpret_cast<const float2*>(dos + item_pos * LD);
    const int ncols = c1 - c0;
    const int ya = max(y0, qh_lo), yb = min(y1, qh_hi + 1);
    const int ca = max(c0, qc_lo), cb = min(c1, qc_hi + 1);
    for (int y = ya; y < yb; ++y) {
      const int slot_row = (jh - window_start(y, g.h, g.kh)) * g.kw;  // this key row's slots
#pragma unroll 2
      for (int cu = ca; cu < cb; ++cu) {
        const int at = (y - y0) * ncols + cu - c0;
        const float2* tq = ts + at * sp + slot_row;  // the query's slots of this key row
        const int sw = start_w(g, cu);
        // (p, ds) of each key, (0, 0) for a key outside the query's window
        // (its column less the window start: the key's slot, no other mask).
        float2 pds[NK];
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          const int z = kw_[j] - sw;
          pds[j] = z >= 0 && z < g.kw ? tq[z] : make_float2(0.f, 0.f);
        }
        float xv[CL];
        load_slice<CL, LANES>(xv, dos + at * LD, l);
#pragma unroll
        for (int j = 0; j < NK; ++j) axpy<CL>(pds[j].x, xv, dv[j]);
        load_slice<CL, LANES>(xv, qs + at * LD, l);
#pragma unroll
        for (int j = 0; j < NK; ++j) axpy<CL>(pds[j].y, xv, dk[j]);
      }
    }
    __syncthreads();  // the stage is free for the copy two items on
  }
  cp_async_wait<0>();

  if (!row_live) return;
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    if (kw0 + j >= g.w) continue;
    const long long pos = b_pos + ((long long)jd * g.h + jh) * g.w + kw0 + j;
    store_global<CL, LANES>(p.dk + pos * hc + col, dk[j], l, g.ch, g.scale);
    store_global<CL, LANES>(p.dv + pos * hc + col, dv[j], l, g.ch, 1.f);
  }
}

// The queries of one clamped axis of `size` that reach position j through
// window slot `slot`: [lo, hi] (empty when lo > hi). Their window starts at
// j - slot: one query in the interior, a run at an edge (the windows there
// all start at 0, or at size - k).
__device__ __forceinline__ void slot_queries(int j, int slot, int size, int k, int& lo, int& hi) {
  const int st = j - slot;
  if (st < 0 || st > size - k) {
    lo = 1;
    hi = 0;
    return;
  }
  lo = st == 0 ? 0 : st + k / 2;
  hi = st == size - k ? size - 1 : st + k / 2;
}

// One (query, slot) pair's bf16 contributions to a key, channels 4 i ..
// 4 i + 3 of lane l: bf16(ds q-hat) and bf16(p dO).
__device__ __forceinline__ void pair_terms(const Params<bf16>& p, float2 pds, const bf16* q_row,
                                           const bf16* o_row, int c, float4& tk, float4& tv) {
  const float4 qv = nelem::load4(q_row, c, p.g.ch, p.vec4);
  const float4 ov = nelem::load4(o_row, c, p.g.ch, p.vec4);
  const float s = p.g.scale;
  tk = make_float4(round_bf16(pds.y * (qv.x * s)), round_bf16(pds.y * (qv.y * s)),
                   round_bf16(pds.y * (qv.z * s)), round_bf16(pds.y * (qv.w * s)));
  tv = make_float4(round_bf16(pds.x * ov.x), round_bf16(pds.x * ov.y), round_bf16(pds.x * ov.z),
                   round_bf16(pds.x * ov.w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(round_bf16(a.x + b.x), round_bf16(a.y + b.y), round_bf16(a.z + b.z),
                     round_bf16(a.w + b.w));
}

// The bf16 dk/dv kernel (mode 1): see the file's head. A group of LANES
// lanes per key, CL channels a lane (float4 i of lane l at channels 4 l +
// 4 LANES i ..), keys over the grid's x (all batch entries), heads on y.
// A slot that one query reaches (the interior) adds its pair's rounded
// terms to the key's sums; a slot that a run of queries reaches (a clamped
// edge) sums their terms first, W inside H inside D, four channels at a
// time (the rare path, kept out of the registers of the common one).
template <int CL, int LANES>
__global__ void __launch_bounds__(256, 2) natten3d_dkv_bf16_kernel(const Params<bf16> p) {
  const Geometry& g = p.g;
  const int l = threadIdx.x % LANES;
  const long long n_pos = (long long)g.batch * g.d * g.h * g.w;
  const long long key = (long long)blockIdx.x * (blockDim.x / LANES) + threadIdx.x / LANES;
  if (key >= n_pos) return;  // a whole group: no shuffles here
  const int head = blockIdx.y;
  const int jw = key % g.w, jh = key / g.w % g.h, jd = key / ((long long)g.w * g.h) % g.d;
  const int b = key / ((long long)g.w * g.h * g.d);
  const long long b_pos = (long long)b * g.d * g.h * g.w;
  const long long hc = (long long)g.heads * g.ch;
  const int col = head * g.ch;
  float4 dk[CL / 4], dv[CL / 4];
#pragma unroll
  for (int i = 0; i < CL / 4; ++i) dk[i] = dv[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int x = g.kd - 1; x >= 0; --x) {
    int d_lo, d_hi;
    slot_queries(jd, x, g.d, g.kd, d_lo, d_hi);
    for (int y = g.kh - 1; y >= 0; --y) {
      int h_lo, h_hi;
      slot_queries(jh, y, g.h, g.kh, h_lo, h_hi);
      if (d_lo > d_hi || h_lo > h_hi) continue;
      const bool one_dh = d_lo == d_hi && h_lo == h_hi;
      for (int z = g.kw - 1; z >= 0; --z) {
        int w_lo, w_hi;
        if (g.circular_w) {
          w_lo = w_hi = wrap_w(g, jw - z + g.kw / 2);
        } else {
          slot_queries(jw, z, g.w, g.kw, w_lo, w_hi);
        }
        if (w_lo > w_hi) continue;
        const int slot = y * g.kw + z;
        if (one_dh && w_lo == w_hi) {  // one query: its terms, added to the sums
          const long long in = ((long long)d_lo * g.h + h_lo) * g.w + w_lo;
          const float2 pds = p.table[table_at(g, b, in, head, x, slot)];
          const bf16* q_row = p.q + (b_pos + in) * g.q_ps + col;
          const bf16* o_row = p.dout + (b_pos + in) * hc + col;
#pragma unroll
          for (int i = 0; i < CL / 4; ++i) {
            float4 tk, tv;
            pair_terms(p, pds, q_row, o_row, 4 * l + 4 * LANES * i, tk, tv);
            dk[i] = add4(dk[i], tk);
            dv[i] = add4(dv[i], tv);
          }
          continue;
        }
#pragma unroll 1
        for (int i = 0; i < CL / 4; ++i) {  // a run of queries, four channels at a time
          const int c = 4 * l + 4 * LANES * i;
          float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;  // D of H of W, each rounded
          for (int qd = d_lo; qd <= d_hi; ++qd) {
            float4 uk = make_float4(0.f, 0.f, 0.f, 0.f), uv = uk;
            for (int qh = h_lo; qh <= h_hi; ++qh) {
              float4 wk = make_float4(0.f, 0.f, 0.f, 0.f), wv = wk;
              for (int qw = w_lo; qw <= w_hi; ++qw) {
                const long long in = ((long long)qd * g.h + qh) * g.w + qw;
                float4 tk, tv;
                pair_terms(p, p.table[table_at(g, b, in, head, x, slot)],
                           p.q + (b_pos + in) * g.q_ps + col, p.dout + (b_pos + in) * hc + col, c,
                           tk, tv);
                wk = add4(wk, tk);
                wv = add4(wv, tv);
              }
              uk = add4(uk, wk);
              uv = add4(uv, wv);
            }
            sk = add4(sk, uk);
            sv = add4(sv, uv);
          }
          // i is not unrolled here: select dk[i] by a loop the compiler can keep in registers
#pragma unroll
          for (int ii = 0; ii < CL / 4; ++ii)
            if (ii == i) {
              dk[ii] = add4(dk[ii], sk);
              dv[ii] = add4(dv[ii], sv);
            }
        }
      }
    }
  }
  const long long pos = b_pos + ((long long)jd * g.h + jh) * g.w + jw;
  bf16* dk_row = p.dk + pos * hc + col;
  bf16* dv_row = p.dv + pos * hc + col;
#pragma unroll
  for (int i = 0; i < CL / 4; ++i) {
    const int c = 4 * l + 4 * LANES * i;
    const float ka[4] = {dk[i].x, dk[i].y, dk[i].z, dk[i].w};
    const float va[4] = {dv[i].x, dv[i].y, dv[i].z, dv[i].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      nelem::store1(dk_row, c + e, g.ch, ka[e]);
      nelem::store1(dv_row, c + e, g.ch, va[e]);
    }
  }
}

// The relative offset (0 .. 2k - 2) of the key that query i of an axis
// reaches through window slot `slot`.
__device__ __forceinline__ int rel_of(int i, int slot, int size, int k, bool circular) {
  return circular ? slot - k / 2 + k - 1 : window_start(i, size, k) + slot - i + k - 1;
}

// One pass of an ordered bf16 scatter along an axis: the values src(i), i
// = 0 .. n - 1, into bins rel(i), each bin their bf16 sum in ascending i. A
// bin's values are consecutive in i (the interior's, or one edge query's),
// so a run is summed in a register and written once; bins no value reaches
// are 0.
template <class Src, class Rel, class Dst>
__device__ __forceinline__ void scatter_run(int n, int n_bins, Src src, Rel rel, Dst dst) {
  for (int r = 0; r < n_bins; ++r) dst(r) = 0.f;
  int bin = rel(0);
  float acc = src(0);
  for (int i = 1; i < n; ++i) {
    const int r = rel(i);
    const float v = src(i);
    if (r == bin) {
      acc = round_bf16(acc + v);
    } else {
      dst(bin) = acc;
      bin = r;
      acc = v;
    }
  }
  dst(bin) = acc;
}

// The bf16 drpb, mode 2: CTA (slot, head) scatters bf16(sum over the batch
// of ds) of every query at its slot through the transposes of the bias
// gathers: along W into [D, H, 2kw-1], then H into [D, 2kh-1, 2kw-1], then D
// into [2kd-1, 2kh-1, 2kw-1] (its slice of work: head, slot).
__global__ void __launch_bounds__(256) natten3d_drpb_slots_kernel(const Params<bf16> p) {
  const Geometry& g = p.g;
  const int slot = blockIdx.x, head = blockIdx.y;
  const int n_hw = g.kh * g.kw, n_slots = g.kd * n_hw;
  const int x = slot / n_hw, y = slot / g.kw % g.kh, z = slot % g.kw;
  const int nrd = 2 * g.kd - 1, nrh = 2 * g.kh - 1, nrw = 2 * g.kw - 1;
  const long long per_slot = (long long)g.d * g.h * nrw + (long long)g.d * nrh * nrw + nrd * nrh * nrw;
  float* t1 = p.work + ((long long)head * n_slots + slot) * per_slot;  // [D, H, nrw]
  float* t2 = t1 + (long long)g.d * g.h * nrw;                          // [D, nrh, nrw]
  float* t3 = t2 + (long long)g.d * nrh * nrw;                          // [nrd, nrh, nrw]
  for (int i = threadIdx.x; i < g.d * g.h; i += blockDim.x) {
    const long long row = (long long)i * g.w;  // query (i / H, i % H, 0)
    scatter_run(
        g.w, nrw,
        [&](int qw) {
          float sum = 0.f;
          for (int b = 0; b < g.batch; ++b) sum += p.table[table_at(g, b, row + qw, head, x, y * g.kw + z)].y;
          return round_bf16(sum);
        },
        [&](int qw) { return rel_of(qw, z, g.w, g.kw, g.circular_w); },
        [&](int r) -> float& { return t1[(long long)i * nrw + r]; });
  }
  __syncthreads();
  for (int i = threadIdx.x; i < g.d * nrw; i += blockDim.x) {
    const int qd = i / nrw, rw = i % nrw;
    scatter_run(
        g.h, nrh, [&](int qh) { return t1[((long long)qd * g.h + qh) * nrw + rw]; },
        [&](int qh) { return rel_of(qh, y, g.h, g.kh, false); },
        [&](int r) -> float& { return t2[((long long)qd * nrh + r) * nrw + rw]; });
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nrh * nrw; i += blockDim.x) {
    scatter_run(
        g.d, nrd, [&](int qd) { return t2[(long long)qd * nrh * nrw + i]; },
        [&](int qd) { return rel_of(qd, x, g.d, g.kd, false); },
        [&](int r) -> float& { return t3[(long long)r * nrh * nrw + i]; });
  }
}

// The bf16 drpb, mode 3: each (head, offset) adds its slots' sums in
// reverse slot order in bf16 (the scan's transposed carry).
__global__ void __launch_bounds__(256) natten3d_drpb_kernel(const Params<bf16> p) {
  const Geometry& g = p.g;
  const int nrd = 2 * g.kd - 1, nrh = 2 * g.kh - 1, nrw = 2 * g.kw - 1;
  const int n_rel = nrd * nrh * nrw, n_slots = g.kd * g.kh * g.kw;
  const long long per_slot = (long long)g.d * g.h * nrw + (long long)g.d * nrh * nrw + n_rel;
  const long long t3 = (long long)g.d * g.h * nrw + (long long)g.d * nrh * nrw;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= g.heads * n_rel) return;
  const int head = i / n_rel, r = i % n_rel;
  float acc = 0.f;
  for (int s = n_slots - 1; s >= 0; --s)
    acc = round_bf16(acc + p.work[((long long)head * n_slots + s) * per_slot + t3 + r]);
  p.drpb[i] = __float2bfloat16_rn(acc);
}

// Bytes of shared memory of a launch (ops/natten3d.py: `plan_backward`).
template <class T>
size_t dq_smem(const Params<T>& p, int cp, int tw) {
  const Geometry& g = p.g;
  size_t bytes = sizeof(float) * (size_t)4 * p.ry * p.rx * (cp + 4);
  if (p.rpb != nullptr && p.partial != nullptr)
    bytes += sizeof(float) * (size_t)p.rows * tw * g.kh * g.kw +
             (size_t)(2 * g.kh - 1) * p.rows + (size_t)(2 * g.kw - 1) * tw;
  return bytes;
}

size_t dkv_smem(const Params<float>& p, int cp) {
  return sizeof(float) * 2 * (size_t)p.ry * p.rx * (2 * (cp + 4) + 2 * slab_slots(p.g));
}

template <int CL, int LANES, class T>
int launch_dq(const Params<T>& p, cudaStream_t stream) {
  const Geometry& g = p.g;
  constexpr int CP = CL * LANES;
  constexpr int tw = NQ * 32 / LANES;
  const long long tiles = (long long)g.d * ((g.h + p.rows - 1) / p.rows) * ((g.w + tw - 1) / tw);
  const dim3 grid((unsigned)tiles, g.heads, g.batch);
  const size_t smem = dq_smem(p, CP, tw);
  cudaError_t err = cudaFuncSetAttribute(natten3d_dq_kernel<CL, LANES, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  natten3d_dq_kernel<CL, LANES, T><<<grid, 32 * p.rows, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int CL, int LANES>
int launch(int mode, const Params<float>& p, cudaStream_t stream) {
  const Geometry& g = p.g;
  constexpr int CP = CL * LANES;
  if (mode == DQ) return launch_dq<CL, LANES>(p, stream);
  const int tw = NK * 32 / LANES;
  const long long tiles = (long long)g.d * ((g.h + p.rows - 1) / p.rows) * ((g.w + tw - 1) / tw);
  const dim3 grid((unsigned)tiles, g.heads, g.batch);
  const size_t smem = dkv_smem(p, CP);
  cudaError_t err = cudaFuncSetAttribute(natten3d_dkv_kernel<CL, LANES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  natten3d_dkv_kernel<CL, LANES><<<grid, 32 * p.rows, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int CL, int LANES>
int launch_bf16(int mode, const Params<bf16>& p, cudaStream_t stream) {
  const Geometry& g = p.g;
  if (mode == DQ) return launch_dq<CL, LANES>(p, stream);
  if (mode == DKV) {
    const long long n_pos = (long long)g.batch * g.d * g.h * g.w;
    constexpr int per_cta = 256 / LANES;
    const dim3 grid((unsigned)((n_pos + per_cta - 1) / per_cta), g.heads);
    natten3d_dkv_bf16_kernel<CL, LANES><<<grid, 256, 0, stream>>>(p);
  } else if (mode == DRPB_SLOTS) {
    natten3d_drpb_slots_kernel<<<dim3(g.kd * g.kh * g.kw, g.heads), 256, 0, stream>>>(p);
  } else {
    const int n = g.heads * (2 * g.kd - 1) * (2 * g.kh - 1) * (2 * g.kw - 1);
    natten3d_drpb_kernel<<<(n + 255) / 256, 256, 0, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). mode 0: dq and the table, and
// the drpb partials when rpb and partial are given; mode 1: dk and dv from
// the table (q and dO; k, v, rpb, lse and out unread). Launches on `stream`,
// does not synchronise, allocates nothing; returns a cudaError_t (0 on
// success), or cudaErrorInvalidValue for an unknown mode, a (cp, lanes) that
// no instantiation has or a plan out of range. The host checked the kernel
// against the volume and batch and heads against the grid's limits, and
// chose per kernel cp (the padded head width: 32, 64, 96, 128 or 256), the
// lanes of a group (8 up to 96 channels, cp / 8 above), the CTA's rows (at
// most 8) and the item strip ry x rx within shared memory
// (ops/natten3d.py, `takes` and `plan_backward`).
extern "C" int gwt_natten3d_backward(int mode, const float* q, const float* k, const float* v,
                                     const float* rpb, const float* dout, const float* lse,
                                     const float* out, float* dq, float* dk, float* dv,
                                     float* partial, float* table, int batch, int d, int h, int w,
                                     int heads, int ch, long long q_ps, long long k_ps,
                                     long long v_ps, int kd, int kh, int kw, int circular_w,
                                     int vec4, float scale, int cp, int lanes, int rows, int ry,
                                     int rx, void* stream) {
  const Params<float> p{q, k, v, rpb, dout, lse, out, dq, dk, dv, partial,
                        reinterpret_cast<float2*>(table), nullptr, nullptr,
                        Geometry{batch, d, h, w, heads, ch, q_ps, k_ps, v_ps, kd, kh, kw,
                                 circular_w, scale},
                        rows, ry, rx, vec4};
  if ((mode != DQ && mode != DKV) || rows < 1 || rows > 8 || ry < 1 || rx < 1 || ch > cp ||
      table == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cp * 64 + lanes) {
    case 32 * 64 + 8: return launch<4, 8>(mode, p, s);
    case 64 * 64 + 8: return launch<8, 8>(mode, p, s);
    case 96 * 64 + 8: return launch<12, 8>(mode, p, s);
    case 128 * 64 + 16: return launch<8, 16>(mode, p, s);
    case 256 * 64 + 32: return launch<8, 32>(mode, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The bf16 mode: q, k, v, rpb, dout, dq, dk, dv and drpb bf16 (strides in
// elements), out the f32 out32 of K6, scale the bf16 scale; no drpb
// partials. mode 0: dq and the table (the dq plan's cp, lanes, rows, ry,
// rx); mode 1: dk and dv from the table (cp and lanes as mode 0's; rows, ry
// and rx unread); mode 2: each (head, slot)'s drpb sums into `work` ([heads,
// slots, D H (2kw-1) + D (2kh-1)(2kw-1) + n_rel] f32); mode 3: drpb from work.
// vec: ch, the strides and the pointers allow 16-byte copies.
extern "C" int gwt_natten3d_backward_bf16(int mode, const void* q, const void* k, const void* v,
                                          const void* rpb, const void* dout, const float* lse,
                                          const float* out32, void* dq, void* dk, void* dv,
                                          float* table, float* work, void* drpb, int batch, int d,
                                          int h, int w, int heads, int ch, long long q_ps,
                                          long long k_ps, long long v_ps, int kd, int kh, int kw,
                                          int circular_w, int vec, float scale, int cp, int lanes,
                                          int rows, int ry, int rx, void* stream) {
  const Params<bf16> p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                       static_cast<const bf16*>(v), static_cast<const bf16*>(rpb),
                       static_cast<const bf16*>(dout), lse, out32, static_cast<bf16*>(dq),
                       static_cast<bf16*>(dk), static_cast<bf16*>(dv), nullptr,
                       reinterpret_cast<float2*>(table), work, static_cast<bf16*>(drpb),
                       Geometry{batch, d, h, w, heads, ch, q_ps, k_ps, v_ps, kd, kh, kw,
                                circular_w, scale},
                       rows, ry, rx, vec};
  if (mode < DQ || mode > DRPB || rows < 1 || rows > 8 || ry < 1 || rx < 1 || ch > cp ||
      table == nullptr || (mode >= DRPB_SLOTS && (work == nullptr || rpb == nullptr)) ||
      (mode == DRPB && drpb == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cp * 64 + lanes) {
    case 32 * 64 + 8: return launch_bf16<4, 8>(mode, p, s);
    case 64 * 64 + 8: return launch_bf16<8, 8>(mode, p, s);
    case 96 * 64 + 8: return launch_bf16<12, 8>(mode, p, s);
    case 128 * 64 + 16: return launch_bf16<8, 16>(mode, p, s);
    case 256 * 64 + 32: return launch_bf16<8, 32>(mode, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
