// 3D neighborhood attention (NATTEN) backward for Hopper (sm_90a), FP32 on the
// CUDA cores, deterministic (no atomics), with W-neighbouring queries and keys
// register-tiled in groups (four queries, two keys).
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
//     cp.async, one copy group per D plane, and a warp's key plane x waits
//     only for the halo's first x + td planes, so the products start while
//     the last planes are in flight. It keeps ds of every (query, slot) in
//     shared memory and then sums it per relative offset in a fixed order,
//     one thread per offset, from per-axis tables of each query's slot at
//     each offset, into partial[cta, head, offset]; the host sums that over
//     the CTAs.
//   * dk/dv (mode 1), over key tiles: a key's queries (those whose window
//     holds it) are per axis one contiguous range, (0 if j < k else
//     j - (k - 1 - k/2)) .. (size - 1 if j >= size - k else j + k/2), k
//     positions modulo W on a circular axis. The CTA stages the union of its
//     keys' ranges (the inverse window) one D plane at a time, in strips of
//     ry rows where a whole plane does not fit: the q and dO rows, lse and
//     delta, with cp.async into two stages, the next strip's copies issued
//     before the current one's products (where not even one row fits, a W
//     window of ~70 and more at 128 channels, it reads them through L1). Each key's lanes hold k_j, v_j and
//     their dk, dv sums in registers and write them once: no overlap-add.
//
// In both kernels a group of lanes owns NQ W-neighbouring positions, each
// lane CH of their channels, so that one row read from shared memory serves
// all NQ: in dq four queries (CP / 4 lanes of one float4 each; at kw = 5
// four queries touch 8 W-keys for 20 pairs), in dk/dv two keys (CP / 8
// lanes of two float4s), the best of one, two and four there. For every
// row of the other side, the lanes form the NQ x 2 partial dots (q . k and
// dO . v), sum them across the group by a reduce-scatter (shuffles: one
// step per halving of the positions leaves each lane with its position's two
// sums, wider groups then sum in full), each lane masks and exponentiates
// its position's pair, and the group's p and ds are broadcast back for the
// NQ positions' FMAs. A group takes NC_DQ
// (NC_DKV) columns at once, so that their loads, shuffles and exponentials
// are independent chains. Each group walks as many rows and columns as any
// group of its warp (masked), so the shuffles stay convergent.
//
// What bounds it on an H100. At WeatherMesh's 1-degree latent ([1, 14, 45,
// 90], 4 heads x 32, kernel (3, 5, 5)) the backward must read q, k, v, out,
// dO and write dq, dk, dv (~234 MB with delta and drpb, ~70 us at 3.35
// TB/s) and compute s, dp, dq, dk and dv over 17.0 M pairs (5.44 GFLOP,
// ~81 us on the FP32 pipes): operations, by a little. Each pair is computed
// in both kernels, and the groups compute their positions' union of
// W-neighbours (8 of them at kw = 5 for four queries' 20 pairs). The design before this
// one gave each query (key) four lanes of its own, walked its 75 pairs one at
// a time through a chain of loads, four shuffles and an exponential, read
// the dk/dv kernel's q and dO rows through L1 once per pair, and summed drpb
// with one thread per offset over every query of the tile (0.61 of the dq
// kernel's 1.08 ms at this layer; the dk/dv kernel 1.46 ms). Here, on an
// H100 at 700 W (scripts/k4a_k5b_variants.py, PERF.md §6), the dk/dv kernel
// reading its queries through L1 instead of the staged planes takes about
// twice as long, the drpb loop of before would add 0.8 ms to the dq kernel,
// one column at a time instead of chunks adds ~15% to it, and a group of
// one position instead of four makes dq 35% slower; in dk/dv, groups of
// four keys are 25% slower than pairs (more shuffles per FMA). What remains
// is latency: each column's chain of loads, shuffles and an exponential at
// 8 warps an SM (the dq kernel's halo allows one CTA).
//
// bf16 (gwt_natten_flash_backward_bf16): the TPU kernel's bf16 roundings,
// with q-hat = bf16(q x the bf16 scale) and delta = dO . out of the bf16 out
// (ops/natten_flash.py, `natten_flash_backward_reference`).
//   * dq (mode 0): the dq kernel above, its halo staged as bf16 rows by
//     16-byte cp.async (so the copies overlap the products, as in f32) and
//     converted as read; ds rounded to bf16 before its products with k, dq
//     = bf16(sum x ch^-0.5); the drpb partials sum ds unrounded, as the TPU
//     kernel's f32 dbias. It forms delta itself from the forward's out (f32
//     sums over the group's lanes) and writes it for the dk/dv kernel.
//   * dk/dv (mode 1), on the tensor cores (`natten_dkv_bf16_kernel`): the
//     TPU kernel rounds each query tile's part of a key's dk (sum bf16(ds)
//     q-hat) and dv (sum bf16(p) dO) to bf16 and adds the parts in f32, so a
//     key's sums depend on the tiles (all of D by jth x jtw of H and W,
//     `tpu_backward_tile`) that cut its inverse window. A warp owns a patch
//     of 4 x 4 keys of one plane, the 16 rows of bf16 mma.sync m16n8k16
//     tiles; k and v are its A fragments, in registers. The CTA (a key tile
//     of up to 8 patches, ops/natten_flash.py `dkv_bf16_plan`) stages items
//     of its inverse window, all planes and columns by the rows of one TPU
//     tile of H, q-hat and dO as bf16 rows by 16-byte cp.async into two
//     stages (q-hat formed once per staged row, in place), the next item's
//     copies issued before the current one's products. In an item a warp
//     walks its columns one TPU tile of W at a time: each is one part's box
//     (its planes x the item's rows of its window x the tile's columns),
//     tabled in shared memory (where each query is staged, its window, its
//     lse and delta) and taken 16 queries at a time, their rows gathered
//     lane by lane by ldmatrix: s^T = K q-hat^T and dp^T = V dO^T, p and ds
//     per pair in f32 (off-window pairs 0), bf16(p) and bf16(ds) as the A
//     fragments of dv += P^T dO and dk += dS^T q-hat (the queries the
//     reduction index, the same rows by ldmatrix.trans). At the box's end
//     the part is rounded to bf16 and added to the f32 totals, in
//     `_TileParts.sums`'s order; the totals are written as bf16 once. No TPU
//     tile (jth x jtw = H x W) is one part. Where a tile of H's rows do not
//     fit in two stages, items of ry rows walk one TPU tile of W each, its
//     part open over the tile of H's items.
//     What bounds it: at the 128-d WeatherMesh's layer (TPU tile 4 x 3) a
//     patch's boxes hold 3-36 queries, so about a quarter of the (key,
//     query) products the mma compute are pairs of a window, and each
//     product's p and ds cost a dozen CUDA-core instructions; the walk is
//     ~70% of the time, the copies, q-hat and the barriers the rest
//     (scripts/k5b_bf16_variants.py; times beside the f32 kernel's on the
//     same values and the design before this one, a group of lanes a key
//     walking its window once per part through L1: PERF.md §6).
//
// Not yet here: tensor cores in the dq kernel and the f32 kernels.

#include <cuda_runtime.h>

#include <type_traits>

#include "clustered_tile.cuh"
#include "natten_elem.cuh"

namespace {

using nelem::bf16;
using nelem::round_bf16;

constexpr int DQ = 0, DKV = 1;
// Per kernel: W-neighbouring positions of a lane group, and channels of a
// lane (a group has CP / channels lanes).
constexpr int NQ_DQ = 4, CH_DQ = 4;
constexpr int NQ_DKV = 2, CH_DKV = 8;
// Columns a group takes at once (independent chains of loads, shuffles and
// exponentials for the scheduler to interleave), in dq and in dk/dv.
constexpr int NC_DQ = 4, NC_DKV = 2;
constexpr float LOG2E = 1.4426950408889634f;

struct Geometry {
  int batch, d, h, w, heads, ch;
  long long q_ps, k_ps, v_ps;  // floats between consecutive positions
  int kd, kh, kw, circular_w;
  int td, th, tw;  // positions per tile, per axis
  int ud, uh, uw;  // the most positions any tile stages, per axis
  int vec4;        // ch, strides and pointers allow 16-byte copies
  float scale;
  int ry;  // dk/dv: rows of a staged strip (mode 1)
};

template <class T>
struct Params {
  const T* q;
  const T* k;
  const T* v;
  const T* rpb;        // or null
  const T* dout;       // [B, D, H, W, heads, ch], dense
  const float* lse;    // [B, D, H, W, heads]
  const float* delta;  // [B, D, H, W, heads]
  T* dq;               // dense, mode 0
  T* dk;               // dense, mode 1
  T* dv;               // dense, mode 1
  float* partial;      // [B * n_tiles, heads, n_rel] (mode 0, with rpb)
  Geometry g;
  int jth, jtw;        // bf16 dk/dv: the TPU kernel's query tile (H, W)
  const T* out;        // bf16 dq: the forward's out, dense, to form delta from
  float* delta_out;    // where the bf16 dq kernel writes the delta it forms
};

__device__ __forceinline__ int window_start(int i, int size, int k) {
  const int s = i - k / 2;
  return s < 0 ? 0 : (s > size - k ? size - k : s);
}

// The window start of query i on the W axis, unreduced on a circular axis.
__device__ __forceinline__ int start_w(const Geometry& g, int i) {
  return g.circular_w ? i - g.kw / 2 : window_start(i, g.w, g.kw);
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

// The first and last query whose window holds key j (unreduced on a
// circular axis).
__device__ __forceinline__ int inverse_lo(int j, int size, int k, bool circular) {
  return circular ? j - (k - 1 - k / 2) : (j < k ? 0 : j - (k - 1 - k / 2));
}
__device__ __forceinline__ int inverse_hi(int j, int size, int k, bool circular) {
  return circular ? j + k / 2 : (j >= size - k ? size - 1 : j + k / 2);
}

// Keys [j0, j0 + n) of one axis -> first query and number of queries of the
// union of their inverse windows (ops/natten_flash.py: _inverse_span).
__device__ __forceinline__ void inverse_span(int j0, int n, int size, int k, bool circular,
                                             int& lo, int& span) {
  lo = inverse_lo(j0, size, k, circular);
  span = circular ? min(n + k - 1, size) : inverse_hi(j0 + n - 1, size, k, false) - lo + 1;
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

// Index of an unreduced column in a staged union [lo, lo + span): wrapped
// once where a circular union was capped at W columns, then clamped into the
// union (a column outside it is masked by its caller).
__device__ __forceinline__ int union_index(int col, int lo, int span, const Geometry& g) {
  int c = col - lo;
  if (g.circular_w && c >= span) c -= g.w;
  return min(max(c, 0), span - 1);
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

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// cp_async_wait<n> for a runtime n (past 7: waits for all but 7).
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// dst[0:CP) = src[0:ch), zeros past ch (or everywhere when !ok). f32:
// thread part `c4` of CP / 4 copies channels 4 c4 .. 4 c4 + 3; bf16 (staged
// as bf16): part `c8` of CP / 8 copies channels 8 c8 .. 8 c8 + 7, one 16-byte
// cp.async where `vec` (ch a multiple of 8), else element by element (plain
// loads and stores, visible after the caller's __syncthreads).
template <int CP>
__device__ __forceinline__ void copy_part(bf16* dst, const bf16* src, const bf16* any, int c8,
                                          bool ok, const Geometry& g) {
  const int c = 8 * c8;
  if (g.vec4) {
    const bool in = ok && c < g.ch;
    cp_async16(reinterpret_cast<float*>(dst + c), reinterpret_cast<const float*>(in ? src + c : any),
               in);
  } else {
#pragma unroll
    for (int x = 0; x < 8; ++x)
      dst[c + x] = ok && c + x < g.ch ? src[c + x] : __float2bfloat16_rn(0.f);
  }
}

template <int CP>
__device__ __forceinline__ void copy_part(float* dst, const float* src, const float* any, int c4,
                                          bool ok, const Geometry& g) {
  const int c = 4 * c4;
  if (g.vec4) {
    const bool in = ok && c < g.ch;
    cp_async16(dst + c, in ? src + c : any, in);
  } else {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const bool in = ok && c + x < g.ch;
      cp_async4(dst + c + x, in ? src + c + x : any, in);
    }
  }
}

// A lane's channels of one row: float4 i holds channels 4 l + 4 LANES i ..
// + 3 of its group lane l, so that a group reads a row's consecutive
// 16-byte words.
template <int NV>
struct Row {
  float4 x[NV];
};

template <int NV>
__device__ __forceinline__ float dot(const Row<NV>& a, const Row<NV>& b) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i)
    s = fmaf(a.x[i].x, b.x[i].x, fmaf(a.x[i].y, b.x[i].y, fmaf(a.x[i].z, b.x[i].z, fmaf(a.x[i].w, b.x[i].w, s))));
  return s;
}

template <int NV>
__device__ __forceinline__ void axpy(float a, const Row<NV>& x, Row<NV>& y) {
#pragma unroll
  for (int i = 0; i < NV; ++i)
    y.x[i] = make_float4(fmaf(a, x.x[i].x, y.x[i].x), fmaf(a, x.x[i].y, y.x[i].y),
                         fmaf(a, x.x[i].z, y.x[i].z), fmaf(a, x.x[i].w, y.x[i].w));
}

template <int NV>
__device__ __forceinline__ Row<NV> zero_row() {
  Row<NV> r;
#pragma unroll
  for (int i = 0; i < NV; ++i) r.x[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  return r;
}

// A staged row (shared memory, channels past ch are zeros).
template <int NV, int LANES>
__device__ __forceinline__ Row<NV> smem_row(const float* row, int l) {
  Row<NV> r;
#pragma unroll
  for (int i = 0; i < NV; ++i) r.x[i] = *reinterpret_cast<const float4*>(row + 4 * l + 4 * LANES * i);
  return r;
}

// Four bf16 channels (one 8-byte word of a staged row) as floats.
__device__ __forceinline__ float4 bf16x4(const bf16* at) {
  const uint2 u = *reinterpret_cast<const uint2*>(at);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

template <int NV, int LANES>
__device__ __forceinline__ Row<NV> smem_row(const bf16* row, int l) {
  Row<NV> r;
#pragma unroll
  for (int i = 0; i < NV; ++i) r.x[i] = bf16x4(row + 4 * l + 4 * LANES * i);
  return r;
}

// Rows of the dq kernel's halo in shared memory: f32 rows stay f32 (stride CP
// + 4 floats); bf16 rows are staged as bf16 by 16-byte cp.async (stride CP +
// 8, 16-byte aligned) and converted as they are read.
template <class T>
using staged_t = std::conditional_t<nelem::is_bf16<T>, bf16, float>;
template <class T>
constexpr int row_pad = nelem::is_bf16<T> ? 8 : 4;

// A global row, times `mul`, zero past ch.
template <int NV, int LANES>
__device__ __forceinline__ Row<NV> load_row(const float* row, int l, int ch, bool vec4,
                                            float mul = 1.f) {
  Row<NV> r;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = 4 * l + 4 * LANES * i;
    float4 x;
    if (vec4) {
      x = c < ch ? __ldg(reinterpret_cast<const float4*>(row + c)) : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      x = make_float4(c < ch ? __ldg(row + c) : 0.f, c + 1 < ch ? __ldg(row + c + 1) : 0.f,
                      c + 2 < ch ? __ldg(row + c + 2) : 0.f, c + 3 < ch ? __ldg(row + c + 3) : 0.f);
    }
    r.x[i] = make_float4(x.x * mul, x.y * mul, x.z * mul, x.w * mul);
  }
  return r;
}

// The same of a bf16 row; a non-unit `mul` (q's scale) is the bf16 scale of
// mul, and the products are rounded to bf16: q-hat = bf16(q x scale).
template <int NV, int LANES>
__device__ __forceinline__ Row<NV> load_row(const bf16* row, int l, int ch, bool vec4,
                                            float mul = 1.f) {
  Row<NV> r;
  const bool scaled = mul != 1.f;
  const float m16 = round_bf16(mul);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const float4 x = nelem::load4(row, 4 * l + 4 * LANES * i, ch, vec4);
    r.x[i] = scaled ? make_float4(round_bf16(x.x * m16), round_bf16(x.y * m16), round_bf16(x.z * m16),
                                  round_bf16(x.w * m16))
                    : x;
  }
  return r;
}

// r times `mul`, rounded to bf16.
template <int NV, int LANES>
__device__ __forceinline__ void store_row(bf16* row, const Row<NV>& r, float mul, int l, int ch,
                                          bool vec4) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = 4 * l + 4 * LANES * i;
    nelem::store1(row, c, ch, r.x[i].x * mul);
    nelem::store1(row, c + 1, ch, r.x[i].y * mul);
    nelem::store1(row, c + 2, ch, r.x[i].z * mul);
    nelem::store1(row, c + 3, ch, r.x[i].w * mul);
  }
}

template <int NV, int LANES>
__device__ __forceinline__ void store_row(float* row, const Row<NV>& r, float mul, int l, int ch,
                                          bool vec4) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = 4 * l + 4 * LANES * i;
    const float4 x = make_float4(r.x[i].x * mul, r.x[i].y * mul, r.x[i].z * mul, r.x[i].w * mul);
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

// The group's NQ positions' partial dots a[j] (first product) and b[j]
// (second), summed over its LANES lanes: afterwards this lane holds the sums
// of its position `position<LANES, NQ>(l)` (for four positions, the bits
// LANES / 2 and LANES / 4 of its group lane l; for two, the bit LANES / 2);
// wider groups then sum in full.
template <int LANES, int NQ>
__device__ __forceinline__ void reduce_scatter(const float (&a)[NQ], const float (&b)[NQ], int l,
                                               float& sa, float& sb) {
  static_assert(NQ == 1 || (NQ == 2 && LANES >= 2) || (NQ == 4 && LANES >= 4), "lane group layout");
  int bit = LANES / 2;
  if constexpr (NQ == 1) {
    sa = a[0];
    sb = b[0];
  } else {
    float a1[2], b1[2];
    if constexpr (NQ == 4) {
      const bool hi = l & bit;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        a1[jj] = (hi ? a[2 + jj] : a[jj]) + __shfl_xor_sync(0xffffffffu, hi ? a[jj] : a[2 + jj], bit);
        b1[jj] = (hi ? b[2 + jj] : b[jj]) + __shfl_xor_sync(0xffffffffu, hi ? b[jj] : b[2 + jj], bit);
      }
      bit >>= 1;
    } else {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        a1[jj] = a[jj];
        b1[jj] = b[jj];
      }
    }
    const bool hi = l & bit;
    sa = (hi ? a1[1] : a1[0]) + __shfl_xor_sync(0xffffffffu, hi ? a1[0] : a1[1], bit);
    sb = (hi ? b1[1] : b1[0]) + __shfl_xor_sync(0xffffffffu, hi ? b1[0] : b1[1], bit);
    bit >>= 1;
  }
#pragma unroll
  for (; bit > 0; bit >>= 1) {
    sa += __shfl_xor_sync(0xffffffffu, sa, bit);
    sb += __shfl_xor_sync(0xffffffffu, sb, bit);
  }
}

// Position j of a group lives on the lanes whose bits (from LANES / 2 down)
// spell j; `base` is the group's first lane in the warp.
template <int LANES, int NQ>
__device__ __forceinline__ int holder(int base, int j) {
  if constexpr (NQ == 4) return base + (j >> 1) * (LANES / 2) + (j & 1) * (LANES / 4);
  if constexpr (NQ == 2) return base + j * (LANES / 2);
  return base;
}

template <int LANES, int NQ>
__device__ __forceinline__ int position(int l) {
  if constexpr (NQ == 4) return 2 * ((l & (LANES / 2)) != 0) + ((l & (LANES / 4)) != 0);
  if constexpr (NQ == 2) return (l & (LANES / 2)) != 0;
  return 0;
}

// Tile blockIdx.x of the (td, th, tw) tiling -> its first position per axis.
__device__ __forceinline__ void tile_origin(const Geometry& g, int& d0, int& h0, int& w0) {
  const int ntw = (g.w + g.tw - 1) / g.tw, nth = (g.h + g.th - 1) / g.th;
  d0 = blockIdx.x / (ntw * nth) * g.td;
  h0 = blockIdx.x / ntw % nth * g.th;
  w0 = blockIdx.x % ntw * g.tw;
}

// This thread's group of NQ positions: its tile row (td_local, th_local),
// its first W position within the tile, and its lane l within the group.
// The CTA's threads fill whole warps; a group past the tile's rows is not
// `in_tile`.
template <int LANES, int NQ>
struct Group {
  int pd, ph, pw0;  // tile-local
  int l, base;      // lane within the group, the group's first lane in the warp
  bool in_tile;
  __device__ Group(const Geometry& g) {
    const int gi = threadIdx.x / LANES;
    const int per_row = g.tw / NQ;
    const int row = gi / per_row;
    in_tile = row < g.td * g.th;
    pd = in_tile ? row / g.th : 0;
    ph = in_tile ? row % g.th : 0;
    pw0 = (gi % per_row) * NQ;
    l = threadIdx.x % LANES;
    base = (threadIdx.x & 31) - l;
  }
};

template <int CP, class T>
__global__ void __launch_bounds__(256, 1) natten_dq_kernel(const Params<T> p) {
  using S = staged_t<T>;
  constexpr int NQ = NQ_DQ, LANES = CP / CH_DQ, NV = CH_DQ / 4;
  constexpr int LD = CP + row_pad<T>;
  const Geometry& g = p.g;
  extern __shared__ float4 smem4[];
  const int U = g.ud * g.uh * g.uw;
  const int n_slots = g.kd * g.kh * g.kw;
  const int nrh = 2 * g.kh - 1, nrw = 2 * g.kw - 1;
  const int n_rel = (2 * g.kd - 1) * nrh * nrw;
  S* Ks = reinterpret_cast<S*>(smem4);                 // [U][LD]
  S* Vs = Ks + U * LD;                                 // [U][LD]
  float* Rs = reinterpret_cast<float*>(Vs + U * LD);  // [n_rel] rpb of this head
  float* DSs = Rs + n_rel;                             // [tile queries][n_slots] ds (with rpb)

  int d0, h0, w0;
  tile_origin(g, d0, h0, w0);
  const int head = blockIdx.y;
  const long long b_pos = (long long)blockIdx.z * g.d * g.h * g.w;
  int lo_d, sp_d, lo_h, sp_h, lo_w, sp_w;
  window_span(d0, min(g.td, g.d - d0), g.d, g.kd, false, lo_d, sp_d);
  window_span(h0, min(g.th, g.h - h0), g.h, g.kh, false, lo_h, sp_h);
  window_span(w0, min(g.tw, g.w - w0), g.w, g.kw, g.circular_w, lo_w, sp_w);

  // The halo, K and V, one cp.async group per D plane, so that the products
  // of a warp's first key planes start before the last planes arrive.
  if (p.rpb != nullptr)
    for (int i = threadIdx.x; i < n_rel; i += blockDim.x) Rs[i] = nelem::to_f(p.rpb[head * n_rel + i]);
  constexpr int V4 = nelem::is_bf16<T> ? CP / 8 : CP / 4;  // copies a row
  for (int dd = 0; dd < sp_d; ++dd) {
    for (int i = threadIdx.x; i < sp_h * sp_w * V4; i += blockDim.x) {
      const int r = i / V4, c4 = i - r * V4;
      const int hh = r / sp_w, ww = r - hh * sp_w;
      const long long pos = b_pos + ((long long)(lo_d + dd) * g.h + lo_h + hh) * g.w + wrap(lo_w + ww, g.w);
      const int at = ((dd * g.uh + hh) * g.uw + ww) * LD;
      copy_part<CP>(Ks + at, p.k + pos * g.k_ps + head * g.ch, p.k, c4, true, g);
      copy_part<CP>(Vs + at, p.v + pos * g.v_ps + head * g.ch, p.v, c4, true, g);
    }
    cp_async_commit();
  }

  // The group's queries (past the volume: the last query again,
  // computed and not stored).
  const Group<LANES, NQ> grp(g);
  const int l = grp.l;
  const int id = min(d0 + grp.pd, g.d - 1), ih = min(h0 + grp.ph, g.h - 1);
  const bool row_live = grp.in_tile && d0 + grp.pd < g.d && h0 + grp.ph < g.h;
  const int hc = g.heads * g.ch;
  Row<NV> qr[NQ], dor[NQ], dq[NQ];
  int qw[NQ];
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    qw[j] = min(w0 + grp.pw0 + j, g.w - 1);
    const long long pos = b_pos + ((long long)id * g.h + ih) * g.w + qw[j];
    qr[j] = load_row<NV, LANES>(p.q + pos * g.q_ps + head * g.ch, l, g.ch, g.vec4, g.scale);
    dor[j] = load_row<NV, LANES>(p.dout + pos * hc + head * g.ch, l, g.ch, g.vec4);
    dq[j] = zero_row<NV>();
  }
  // This lane's query after a reduce-scatter: its lse, delta and window.
  const int mine = position<LANES, NQ>(l);
  const int my_w = qw[mine];
  const long long my_pos = b_pos + ((long long)id * g.h + ih) * g.w + my_w;
  const float my_lse = p.lse[my_pos * g.heads + head];
  float my_delta;
  if constexpr (nelem::is_bf16<T>) {
    // delta = dO . out of the bf16 out, formed here for both kernels: this
    // lane's position's sum over the group, written once a query.
    float a[NQ];
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const long long pos = b_pos + ((long long)id * g.h + ih) * g.w + qw[j];
      a[j] = dot(dor[j], load_row<NV, LANES>(p.out + pos * hc + head * g.ch, l, g.ch, g.vec4));
    }
    float unused;
    reduce_scatter<LANES, NQ>(a, a, l, my_delta, unused);
    if (row_live && w0 + grp.pw0 + mine < g.w && (l & (LANES / NQ - 1)) == 0)
      p.delta_out[my_pos * g.heads + head] = my_delta;
  } else {
    my_delta = p.delta[my_pos * g.heads + head];
  }
  const int my_sw = start_w(g, my_w);
  const bool writes_ds = p.rpb != nullptr && p.partial != nullptr && row_live &&
                         w0 + grp.pw0 + mine < g.w && (l & (LANES / NQ - 1)) == 0;
  const int my_q = ((grp.pd * g.th + grp.ph) * g.tw + grp.pw0 + mine) * n_slots;
  const int sd = window_start(id, g.d, g.kd), sh = window_start(ih, g.h, g.kh);
  const int cw0 = start_w(g, qw[0]);  // the group's first key column (unreduced)
  const int n_cols = NQ - 1 + g.kw;    // the group's windows' columns, for every group

  for (int x = 0; x < g.kd; ++x) {
    // Key plane sd + x lies at most td - 1 planes past the halo's first.
    cp_async_wait_n(max(sp_d - x - g.td, 0));
    __syncthreads();
    const int row_d = (sd + x - lo_d) * g.uh;
    const int rel_d = (sd + x - id + g.kd - 1) * nrh;
    for (int y = 0; y < g.kh; ++y) {
      const int row_h = (row_d + sh + y - lo_h) * g.uw;
      const int rel_h = (rel_d + sh + y - ih + g.kh - 1) * nrw;
      const int slot_xy = (x * g.kh + y) * g.kw;
      for (int u0 = 0; u0 < n_cols; u0 += NC_DQ) {
        Row<NV> kv[NC_DQ];
        float s[NC_DQ], dp[NC_DQ], ds[NC_DQ];
#pragma unroll
        for (int c = 0; c < NC_DQ; ++c) {
          const int r = row_h + union_index(cw0 + u0 + c, lo_w, sp_w, g);
          kv[c] = smem_row<NV, LANES>(Ks + r * LD, l);
          const Row<NV> vv = smem_row<NV, LANES>(Vs + r * LD, l);
          float a[NQ], b[NQ];
#pragma unroll
          for (int j = 0; j < NQ; ++j) {
            a[j] = dot(qr[j], kv[c]);
            b[j] = dot(dor[j], vv);
          }
          reduce_scatter<LANES, NQ>(a, b, l, s[c], dp[c]);
        }
#pragma unroll
        for (int c = 0; c < NC_DQ; ++c) {
          const int col = cw0 + u0 + c;
          const int z = col - my_sw;  // slot of the key in this lane's window
          const bool in = u0 + c < n_cols && z >= 0 && z < g.kw;
          if (p.rpb != nullptr && in) s[c] += Rs[rel_h + col - my_w + g.kw - 1];
          ds[c] = in ? exp2f((s[c] - my_lse) * LOG2E) * (dp[c] - my_delta) : 0.f;
          if (writes_ds && in) DSs[my_q + slot_xy + z] = ds[c];
        }
        if constexpr (nelem::is_bf16<T>) {  // the TPU kernel's bf16 ds, for dq's products
#pragma unroll
          for (int c = 0; c < NC_DQ; ++c) ds[c] = round_bf16(ds[c]);
        }
#pragma unroll
        for (int c = 0; c < NC_DQ; ++c)
#pragma unroll
          for (int j = 0; j < NQ; ++j)
            axpy(__shfl_sync(0xffffffffu, ds[c], holder<LANES, NQ>(grp.base, j)), kv[c], dq[j]);
      }
    }
  }
  if (row_live) {
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      if (w0 + grp.pw0 + j >= g.w) continue;
      const long long pos = b_pos + ((long long)id * g.h + ih) * g.w + qw[j];
      store_row<NV, LANES>(p.dq + pos * hc + head * g.ch, dq[j], g.scale, l, g.ch, g.vec4);
    }
  }
  if (p.rpb == nullptr || p.partial == nullptr) return;
  __syncthreads();

  // drpb partials. Per axis, the slot of each tile query at each relative
  // offset (-1: none, or a query past the volume), in the halo's place.
  signed char* t_d = reinterpret_cast<signed char*>(Ks);
  signed char* t_h = t_d + (2 * g.kd - 1) * g.td;
  signed char* t_w = t_h + nrh * g.th;
  for (int i = threadIdx.x; i < (2 * g.kd - 1) * g.td; i += blockDim.x) {
    const int r = i / g.td, qi = d0 + i % g.td;
    t_d[i] = qi < g.d ? slot_of(r, qi, g.d, g.kd, false) : -1;
  }
  for (int i = threadIdx.x; i < nrh * g.th; i += blockDim.x) {
    const int r = i / g.th, qi = h0 + i % g.th;
    t_h[i] = qi < g.h ? slot_of(r, qi, g.h, g.kh, false) : -1;
  }
  for (int i = threadIdx.x; i < nrw * g.tw; i += blockDim.x) {
    const int r = i / g.tw, qi = w0 + i % g.tw;
    t_w[i] = qi < g.w ? slot_of(r, qi, g.w, g.kw, g.circular_w) : -1;
  }
  __syncthreads();
  // Offset r sums ds over the tile's queries, in query order.
  for (int r = threadIdx.x; r < n_rel; r += blockDim.x) {
    const int rd = r / (nrh * nrw), rh = r / nrw % nrh, rw = r % nrw;
    float sum = 0.f;
    for (int qd = 0; qd < g.td; ++qd) {
      const int sx = t_d[rd * g.td + qd];
      if (sx < 0) continue;
      for (int qh = 0; qh < g.th; ++qh) {
        const int sy = t_h[rh * g.th + qh];
        if (sy < 0) continue;
        const float* ds_row = DSs + ((qd * g.th + qh) * g.tw) * n_slots + (sx * g.kh + sy) * g.kw;
        for (int qw_ = 0; qw_ < g.tw; ++qw_) {
          const int sz = t_w[rw * g.tw + qw_];
          if (sz >= 0) sum += ds_row[qw_ * n_slots + sz];
        }
      }
    }
    p.partial[(((long long)blockIdx.z * gridDim.x + blockIdx.x) * g.heads + head) * n_rel + r] =
        sum;
  }
}

// STAGED: the queries' rows come from the staged strips; otherwise (a shape
// whose inverse window cannot stage one row) through L1, once per pair.
template <int CP, bool STAGED>
__global__ void __launch_bounds__(256, 2) natten_dkv_kernel(const Params<float> p) {
  constexpr int NQ = NQ_DKV, LANES = CP / CH_DKV, NV = CH_DKV / 4;
  constexpr int LD = CP + 4;
  const Geometry& g = p.g;
  extern __shared__ float4 smem4[];
  const int nrh = 2 * g.kh - 1, nrw = 2 * g.kw - 1;
  const int n_rel = (2 * g.kd - 1) * nrh * nrw;
  const int head = blockIdx.y;
  const long long b_pos = (long long)blockIdx.z * g.d * g.h * g.w;
  const int hc = g.heads * g.ch;
  int d0, h0, w0;
  tile_origin(g, d0, h0, w0);
  // The tile's inverse window: query planes, rows and (unreduced) columns.
  int lo_d, sp_d, lo_h, sp_h, lo_w, sp_w;
  inverse_span(d0, min(g.td, g.d - d0), g.d, g.kd, false, lo_d, sp_d);
  inverse_span(h0, min(g.th, g.h - h0), g.h, g.kh, false, lo_h, sp_h);
  inverse_span(w0, min(g.tw, g.w - w0), g.w, g.kw, g.circular_w, lo_w, sp_w);
  const int ry = STAGED ? g.ry : sp_h;  // rows of an item
  const int strips = (sp_h + ry - 1) / ry;
  const int n_items = sp_d * strips;
  const int stage_pos = ry * g.uw;                    // positions of a stage
  // q and dO rows, lse, delta; 16-byte aligned
  const int stage_floats = (stage_pos * (2 * LD + 2) + 3) & ~3;

  float* Rs = reinterpret_cast<float*>(smem4);  // [n_rel] rpb of this head
  float* stages = Rs + ((n_rel + 3) & ~3);      // [2][q rows, dO rows, lse, delta]
  if (p.rpb != nullptr)
    for (int i = threadIdx.x; i < n_rel; i += blockDim.x) Rs[i] = p.rpb[head * n_rel + i];

  // Item `it`: query plane lo_d + it / strips, rows [y0, y1) of the union.
  auto item_rows = [&](int it, int& y0, int& y1) {
    y0 = lo_h + (it % strips) * ry;
    y1 = min(y0 + ry, lo_h + sp_h);
  };
  auto copy_item = [&](int it, int stage) {
    int y0, y1;
    item_rows(it, y0, y1);
    const int pd = lo_d + it / strips;
    const int n_pos = (y1 - y0) * sp_w;
    float* qs = stages + stage * stage_floats;
    float* dos = qs + stage_pos * LD;
    float* ls = dos + stage_pos * LD;
    float* des = ls + stage_pos;
    constexpr int V4 = CP / 4;
    for (int i = threadIdx.x; i < n_pos * (V4 + 1); i += blockDim.x) {
      const int r = i / (V4 + 1), c4 = i % (V4 + 1);
      const int yy = r / sp_w, cc = r - yy * sp_w;
      const long long pos = b_pos + ((long long)pd * g.h + y0 + yy) * g.w + wrap(lo_w + cc, g.w);
      if (c4 < V4) {
        copy_part<CP>(qs + r * LD, p.q + pos * g.q_ps + head * g.ch, p.q, c4, true, g);
        copy_part<CP>(dos + r * LD, p.dout + pos * hc + head * g.ch, p.q, c4, true, g);
      } else {
        cp_async4(ls + r, p.lse + pos * g.heads + head, true);
        cp_async4(des + r, p.delta + pos * g.heads + head, true);
      }
    }
  };

  // The group's keys (past the volume: the last key again, computed and
  // not stored; a group past D or H walks no query).
  const Group<LANES, NQ> grp(g);
  const int l = grp.l;
  const int jd = min(d0 + grp.pd, g.d - 1), jh = min(h0 + grp.ph, g.h - 1);
  const bool row_live = grp.in_tile && d0 + grp.pd < g.d && h0 + grp.ph < g.h;
  Row<NV> kr[NQ], vr[NQ], dk[NQ], dv[NQ];
  int kw_[NQ];
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    kw_[j] = min(w0 + grp.pw0 + j, g.w - 1);
    const long long pos = b_pos + ((long long)jd * g.h + jh) * g.w + kw_[j];
    kr[j] = load_row<NV, LANES>(p.k + pos * g.k_ps + head * g.ch, l, g.ch, g.vec4);
    vr[j] = load_row<NV, LANES>(p.v + pos * g.v_ps + head * g.ch, l, g.ch, g.vec4);
    dk[j] = dv[j] = zero_row<NV>();
  }
  const int mine = position<LANES, NQ>(l);
  const int my_j = kw_[mine];  // this lane's key column after a reduce-scatter
  // The group's query ranges: planes and rows of its keys' D and H position,
  // the columns of its keys' union.
  const int qd_lo = inverse_lo(jd, g.d, g.kd, false), qd_hi = inverse_hi(jd, g.d, g.kd, false);
  const int qh_lo = inverse_lo(jh, g.h, g.kh, false), qh_hi = inverse_hi(jh, g.h, g.kh, false);
  const int qc_lo = inverse_lo(kw_[0], g.w, g.kw, g.circular_w);
  const int my_cols = inverse_hi(kw_[NQ - 1], g.w, g.kw, g.circular_w) - qc_lo + 1;
  const int n_cols = __reduce_max_sync(0xffffffffu, my_cols);

  if (STAGED) copy_item(0, 0);
  cp_async_commit();
  for (int it = 0; it < n_items; ++it) {
    if (STAGED && it + 1 < n_items) copy_item(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* qs = stages + (it & 1) * stage_floats;
    const float* dos = qs + stage_pos * LD;
    const float* ls = dos + stage_pos * LD;
    const float* des = ls + stage_pos;
    int y0, y1;
    item_rows(it, y0, y1);
    const int pd = lo_d + it / strips;
    // This group's rows of the strip, walked as far as its warp's longest.
    const bool plane_in = row_live && pd >= qd_lo && pd <= qd_hi;
    const int ya = max(y0, qh_lo), yb = min(y1, qh_hi + 1);
    const int my_rows = plane_in && yb > ya ? yb - ya : 0;
    const int n_rows = __reduce_max_sync(0xffffffffu, my_rows);
    const int rel_d = (jd - pd + g.kd - 1) * nrh;
    for (int t = 0; t < n_rows; ++t) {
      const bool row_in = t < my_rows;
      const int ih = row_in ? ya + t : y0;
      const int row = (ih - y0) * sp_w;
      const int rel_h = (rel_d + jh - ih + g.kh - 1) * nrw;
      for (int u0 = 0; u0 < n_cols; u0 += NC_DKV) {
        Row<NV> qv[NC_DKV], dov[NC_DKV];
        float s[NC_DKV], dp[NC_DKV], pr[NC_DKV], ds[NC_DKV];
#pragma unroll
        for (int c = 0; c < NC_DKV; ++c) {
          const int col = qc_lo + u0 + c;  // the query's column (unreduced)
          const int r = row + union_index(col, lo_w, sp_w, g);
          float lse_i, delta_i;
          if constexpr (STAGED) {
            qv[c] = smem_row<NV, LANES>(qs + r * LD, l);
            dov[c] = smem_row<NV, LANES>(dos + r * LD, l);
            lse_i = ls[r];
            delta_i = des[r];
          } else {
            const long long gp = b_pos + ((long long)pd * g.h + ih) * g.w + wrap(lo_w + r - row, g.w);
            qv[c] = load_row<NV, LANES>(p.q + gp * g.q_ps + head * g.ch, l, g.ch, g.vec4);
            dov[c] = load_row<NV, LANES>(p.dout + gp * hc + head * g.ch, l, g.ch, g.vec4);
            lse_i = __ldg(p.lse + gp * g.heads + head);
            delta_i = __ldg(p.delta + gp * g.heads + head);
          }
          float a[NQ], b[NQ];
#pragma unroll
          for (int j = 0; j < NQ; ++j) {
            a[j] = dot(qv[c], kr[j]);
            b[j] = dot(dov[c], vr[j]);
          }
          reduce_scatter<LANES, NQ>(a, b, l, s[c], dp[c]);
          // Whether this lane's key lies in query col's window.
          const int z = my_j - start_w(g, col);
          const bool in = row_in && u0 + c < my_cols && z >= 0 && z < g.kw;
          s[c] *= g.scale;
          if (p.rpb != nullptr && in) s[c] += Rs[rel_h + my_j - col + g.kw - 1];
          pr[c] = in ? exp2f((s[c] - lse_i) * LOG2E) : 0.f;
          ds[c] = pr[c] * (dp[c] - delta_i);
        }
#pragma unroll
        for (int c = 0; c < NC_DKV; ++c)
#pragma unroll
          for (int j = 0; j < NQ; ++j) {
            const int src = holder<LANES, NQ>(grp.base, j);
            axpy(__shfl_sync(0xffffffffu, pr[c], src), dov[c], dv[j]);
            axpy(__shfl_sync(0xffffffffu, ds[c], src), qv[c], dk[j]);
          }
      }
    }
    __syncthreads();  // the stage is free for the copy two items on
  }
  cp_async_wait<0>();
  if (!row_live) return;
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    if (w0 + grp.pw0 + j >= g.w) continue;
    const long long pos = b_pos + ((long long)jd * g.h + jh) * g.w + kw_[j];
    store_row<NV, LANES>(p.dk + pos * hc + head * g.ch, dk[j], g.scale, l, g.ch, g.vec4);
    store_row<NV, LANES>(p.dv + pos * hc + head * g.ch, dv[j], 1.f, l, g.ch, g.vec4);
  }
}

// The bf16 dk/dv kernel (mode 1): see the file's head. A warp owns a patch
// of 16 keys, PATCH_H rows by PATCH_W columns of one plane, the rows of its
// mma tiles (m16n8k16: key m at row jh0 + m / PATCH_W, column jw0 + m %
// PATCH_W); a CTA owns td x th x tw keys, warps over (td, th / PATCH_H, tw /
// PATCH_W). k and v are the A fragments of s^T = K q-hat^T and dp^T = V
// dO^T, held in registers; the queries come from the staged items by
// ldmatrix, their rows gathered lane by lane.
constexpr int PATCH_H = 4, PATCH_W = 4;

// Four 8 x 8 b16 matrices: lanes 8i .. 8i + 7 give the row addresses of
// matrix i, and a thread gets, of matrix i, row g at columns 2t, 2t + 1 in
// r[i] (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// Elements c, c + 1 of a global bf16 row as an mma word, zeros at or past n.
__device__ __forceinline__ uint32_t pair_word(const bf16* row, int c, int n) {
  return ctile::pack_bf16(c < n ? __bfloat162float(row[c]) : 0.f,
                          c + 1 < n ? __bfloat162float(row[c + 1]) : 0.f);
}

// A warp's table of the queries of a part's box (planes x rows x columns,
// columns fastest), DKV16_SLICE at a time, in shared memory: where each is
// staged, its window's first row and column (past the box: a row and column
// that no key's window starts at), the rpb index of its pair with key (jh,
// jw) less jh nrw + jw; and its lse x log2(e) and delta.
constexpr int DKV16_SLICE = 64;
constexpr int OFF_WINDOW = 1 << 29;

// 2^x by the MUFU alone, subnormal results flushed to zero (exp2f adds the
// steps that keep them: 7% of the dk/dv kernel at case a,
// scripts/k5b_bf16_variants.py); a p below 2^-126 is far under bf16's
// resolution of the sums it enters.
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int CP, int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB) natten_dkv_bf16_kernel(const Params<bf16> p) {
  constexpr int LD = CP + 8;   // staged row (bf16): 16-byte aligned, ldmatrix rows on distinct banks
  constexpr int NKS = CP / 16;  // k steps of s and dp
  constexpr int NNT = CP / 8;   // 8-channel tiles of dk and dv
  constexpr int CB = CP / 8;    // 8-channel blocks of a staged row
  constexpr int V8 = CP / 8;    // 16-byte copies a row
  const Geometry& g = p.g;
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row and column pair
  const int nrh = 2 * g.kh - 1, nrw = 2 * g.kw - 1;
  const int n_rel = (2 * g.kd - 1) * nrh * nrw;
  const int head = blockIdx.y;
  const long long b_pos = (long long)blockIdx.z * g.d * g.h * g.w;
  const int hc = g.heads * g.ch;
  const float qscale = round_bf16(g.scale);
  int d0, h0, w0;
  tile_origin(g, d0, h0, w0);
  // The tile's inverse window: query planes, rows and (unreduced) columns.
  int lo_d, sp_d, lo_h, sp_h, lo_w, sp_w;
  inverse_span(d0, min(g.td, g.d - d0), g.d, g.kd, false, lo_d, sp_d);
  inverse_span(h0, min(g.th, g.h - h0), g.h, g.kh, false, lo_h, sp_h);
  inverse_span(w0, min(g.tw, g.w - w0), g.w, g.kw, g.circular_w, lo_w, sp_w);
  const int hi_h = lo_h + sp_h;
  const int qc_lo = inverse_lo(w0, g.w, g.kw, g.circular_w);
  const int qc_end = inverse_hi(min(w0 + g.tw, g.w) - 1, g.w, g.kw, g.circular_w) + 1;

  float* Rs = reinterpret_cast<float*>(smem4);  // [n_rel] rpb of this head
  int4* Qi = reinterpret_cast<int4*>(Rs + ((n_rel + 3) & ~3)) + warp * DKV16_SLICE;  // this warp's table
  float2* Qf = reinterpret_cast<float2*>(Qi - warp * DKV16_SLICE + (blockDim.x >> 5) * DKV16_SLICE) +
               warp * DKV16_SLICE;
  char* stages = reinterpret_cast<char*>(Rs + ((n_rel + 3) & ~3)) +
                 (size_t)(blockDim.x >> 5) * DKV16_SLICE * (sizeof(int4) + sizeof(float2));
  const int stage_pos = g.ud * g.ry * g.uw;  // positions of a stage: all planes x ry rows x all columns
  const size_t stage_bytes = ((size_t)stage_pos * (4 * LD + 8) + 15) & ~(size_t)15;
  if (p.rpb != nullptr)
    for (int i = threadIdx.x; i < n_rel; i += blockDim.x) Rs[i] = nelem::to_f(p.rpb[head * n_rel + i]);
  auto stage_of = [&](int s, bf16*& qs, bf16*& dos, float*& ls, float*& des) {
    qs = reinterpret_cast<bf16*>(stages + s * stage_bytes);
    dos = qs + stage_pos * LD;
    ls = reinterpret_cast<float*>(dos + stage_pos * LD);
    des = ls + stage_pos;
  };

  // Items: rows [y0, y1) of the inverse window with all of its planes and
  // columns, whose parts [c0, c1) (unreduced columns, whole TPU tiles of W)
  // the warps walk. `whole` (the host's ry holds a TPU tile of H): an item
  // is the window's rows in one TPU tile of H, every part of W walked in it
  // and closed at its end. Otherwise items of ry rows, one TPU tile of W at
  // a time, its part closed after the tile of H's last strip.
  const bool whole = g.ry >= min(p.jth, sp_h);
  auto tile_end = [&](int y) { return min(hi_h, (y / p.jth + 1) * p.jth); };
  auto seg_end = [&](int c) {  // the end of the TPU tile of W from unreduced column c
    if (p.jtw >= g.w) return qc_end;
    const int x = wrap(c, g.w);
    return min(qc_end, c + min((x / p.jtw + 1) * p.jtw, g.w) - x);
  };
  struct Item {
    int y0, y1, c0, c1;
  };
  auto first = [&](int y) -> Item {  // the first item of the TPU tile of H at row y
    if (whole) return Item{y, tile_end(y), qc_lo, qc_end};
    return Item{y, min(y + g.ry, tile_end(y)), qc_lo, seg_end(qc_lo)};
  };
  auto next = [&](const Item& it) -> Item {
    const int te = tile_end(it.y0);
    if (whole || (it.y1 == te && it.c1 == qc_end)) return te < hi_h ? first(te) : Item{hi_h, hi_h, 0, 0};
    if (it.y1 < te) return Item{it.y1, min(it.y1 + g.ry, te), it.c0, it.c1};
    const int ts = max(lo_h, it.y0 / p.jth * p.jth);
    return Item{ts, min(ts + g.ry, te), it.c1, seg_end(it.c1)};
  };
  auto copy_item = [&](const Item& it, int s) {
    bf16 *qs, *dos;
    float *ls, *des;
    stage_of(s, qs, dos, ls, des);
    const int plane = (it.y1 - it.y0) * sp_w, n_pos = sp_d * plane;
    // position r -> plane, row, column by float reciprocals (exact for r
    // below 2^21); the column wraps at most once.
    const float inv_plane = 1.f / plane, inv_w = 1.f / sp_w;
    for (int i = threadIdx.x; i < n_pos * (V8 + 1); i += blockDim.x) {
      const int r = i / (V8 + 1), c8 = i - r * (V8 + 1);
      const int dd = (int)(((float)r + 0.5f) * inv_plane), rem = r - dd * plane;
      const int yy = (int)(((float)rem + 0.5f) * inv_w), x = lo_w + rem - yy * sp_w;
      const long long pos = b_pos + ((long long)(lo_d + dd) * g.h + it.y0 + yy) * g.w +
                            (x < 0 ? x + g.w : x >= g.w ? x - g.w : x);
      if (c8 < V8) {
        copy_part<CP>(qs + r * LD, p.q + pos * g.q_ps + head * g.ch, p.q, c8, true, g);
        copy_part<CP>(dos + r * LD, p.dout + pos * hc + head * g.ch, p.q, c8, true, g);
      } else {
        cp_async4(ls + r, p.lse + pos * g.heads + head, true);
        cp_async4(des + r, p.delta + pos * g.heads + head, true);
      }
    }
  };
  // q-hat = bf16(q x bf16(scale)), once per staged q row, in place.
  auto scale_item = [&](const Item& it, int s) {
    bf16 *qs, *dos;
    float *ls, *des;
    stage_of(s, qs, dos, ls, des);
    const int n_pos = sp_d * (it.y1 - it.y0) * sp_w;
    for (int i = threadIdx.x; i < n_pos * V8; i += blockDim.x) {
      const int r = i / V8, c8 = i - r * V8;
      uint4* at = reinterpret_cast<uint4*>(qs + r * LD + 8 * c8);
      uint4 u = *at;
      unsigned* w = reinterpret_cast<unsigned*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const unsigned lo = __float_as_uint(round_bf16(__uint_as_float(w[e] << 16) * qscale)) >> 16;
        const unsigned hi = __float_as_uint(round_bf16(__uint_as_float(w[e] & 0xffff0000u) * qscale));
        w[e] = (hi & 0xffff0000u) | lo;
      }
      *at = u;
    }
  };

  // This warp's patch (past the volume: the last key again, computed and
  // not stored) and its queries' planes, rows and unreduced columns.
  const int pw_n = g.tw / PATCH_W, ph_n = g.th / PATCH_H;
  const int pd = warp / (ph_n * pw_n), ph = warp / pw_n % ph_n, pw = warp % pw_n;
  const int jd = min(d0 + pd, g.d - 1);
  const int jh0 = h0 + ph * PATCH_H, jw0 = w0 + pw * PATCH_W;
  const bool live = pd < g.td && d0 + pd < g.d && jh0 < g.h && jw0 < g.w;
  const int qd_lo = inverse_lo(jd, g.d, g.kd, false), qd_hi = inverse_hi(jd, g.d, g.kd, false);
  const int qh_lo = inverse_lo(min(jh0, g.h - 1), g.h, g.kh, false);
  const int qh_hi = inverse_hi(min(jh0 + PATCH_H, g.h) - 1, g.h, g.kh, false);
  const int wc_lo = inverse_lo(min(jw0, g.w - 1), g.w, g.kw, g.circular_w);
  const int wc_end = inverse_hi(min(jw0 + PATCH_W, g.w) - 1, g.w, g.kw, g.circular_w) + 1;
  // This thread's two keys: fragment rows gq and gq + 8.
  int kh_[2], kw_[2], koff[2];
  bool kst[2];
  uint32_t ka[NKS][4], va[NKS][4];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int m = gq + 8 * e;
    const int y = jh0 + m / PATCH_W, x = jw0 + m % PATCH_W;
    kst[e] = live && y < g.h && x < g.w;
    kh_[e] = min(y, g.h - 1);
    kw_[e] = min(x, g.w - 1);
    koff[e] = kh_[e] * nrw + kw_[e];
    const long long pos = b_pos + ((long long)jd * g.h + kh_[e]) * g.w + kw_[e];
    const bf16* kr = p.k + pos * g.k_ps + head * g.ch;
    const bf16* vr = p.v + pos * g.v_ps + head * g.ch;
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
      ka[ks][e] = pair_word(kr, 16 * ks + 2 * tq, g.ch);
      ka[ks][2 + e] = pair_word(kr, 16 * ks + 2 * tq + 8, g.ch);
      va[ks][e] = pair_word(vr, 16 * ks + 2 * tq, g.ch);
      va[ks][2 + e] = pair_word(vr, 16 * ks + 2 * tq + 8, g.ch);
    }
  }
  // The open part (pk, pv) and the f32 totals of the closed ones, in the
  // mma's accumulator layout: [n][e] is key row gq + 8 (e / 2), channel 8 n
  // + 2 tq + e % 2.
  float pk[NNT][4], pv[NNT][4], tk[NNT][4], tv[NNT][4];
#pragma unroll
  for (int n = 0; n < NNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) pk[n][e] = pv[n][e] = tk[n][e] = tv[n][e] = 0.f;
  auto close_part = [&]() {  // round the part to bf16, add it to the totals
#pragma unroll
    for (int n = 0; n < NNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        tk[n][e] += round_bf16(pk[n][e]);
        tv[n][e] += round_bf16(pv[n][e]);
        pk[n][e] = pv[n][e] = 0.f;
      }
  };

  // The warp's walk of one item: each TPU tile of W of its columns is one
  // part's box (its planes x the item's rows of its window x the tile's
  // columns), tabled DKV16_SLICE queries at a time and taken 16 at a time.
  auto walk = [&](const Item& it, int s) {
    bf16 *qs, *dos;
    float *ls, *des;
    stage_of(s, qs, dos, ls, des);
    const int ra = max(it.y0, qh_lo), rb = min(it.y1, qh_hi + 1);
    const bool closes = it.y1 == tile_end(it.y0);
    const int nrows = it.y1 - it.y0, P = qd_hi - qd_lo + 1, R = rb - ra;
    const int c_end = min(it.c1, wc_end);
    for (int c0 = max(it.c0, wc_lo); c0 < c_end;) {
      const int c1 = min(seg_end(c0), c_end);
      const int C = c1 - c0, n = R > 0 ? P * R * C : 0;
      const float inv_c = 1.f / C, inv_r = 1.f / max(R, 1);
      for (int s0 = 0; s0 < n; s0 += DKV16_SLICE) {
        const int ns = min(DKV16_SLICE, n - s0);
        __syncwarp();  // the last slice's reads are done
        for (int t = lane; t < ((ns + 15) & ~15); t += 32) {
          const int ii = t < ns ? s0 + t : s0;
          const int line = (int)(((float)ii + 0.5f) * inv_c), cc = ii - line * C;
          const int pl = (int)(((float)line + 0.5f) * inv_r), rr = line - pl * R;
          const int qd = qd_lo + pl, qh = ra + rr, col = c0 + cc;
          const int row = ((qd - lo_d) * nrows + qh - it.y0) * sp_w + union_index(col, lo_w, sp_w, g);
          Qi[t] = make_int4(row, t < ns ? window_start(qh, g.h, g.kh) : OFF_WINDOW,
                            t < ns ? start_w(g, col) : OFF_WINDOW,
                            ((jd - qd + g.kd - 1) * nrh - qh + g.kh - 1) * nrw - col + g.kw - 1);
          Qf[t] = make_float2(ls[row] * LOG2E, des[row]);
        }
        __syncwarp();
        for (int i0 = 0; i0 < ns; i0 += 16) {
          // s^T and dp^T over 16 queries: two n tiles of 8.
          const int ra_row = Qi[i0 + (lane & 7)].x, rb_row = Qi[i0 + 8 + (lane & 7)].x;
          uint32_t bq[2][NKS][2], bo[2][NKS][2];
#pragma unroll
          for (int x = 0; x < CP / 16; ++x) {  // matrices 4x .. 4x + 3 of (n tile, channel block)
            const int mi = 4 * x + (lane >> 3);
            const int at = (mi / CB == 0 ? ra_row : rb_row) * LD + 8 * (mi % CB);
            uint32_t rq[4], ro[4];
            ldmatrix_x4(rq, qs + at);
            ldmatrix_x4(ro, dos + at);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int m = 4 * x + j, nt = m / CB, cb = m % CB;
              bq[nt][cb / 2][cb % 2] = rq[j];
              bo[nt][cb / 2][cb % 2] = ro[j];
            }
          }
          float sc[2][4], dpc[2][4];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[nt][e] = dpc[nt][e] = 0.f;
#pragma unroll
            for (int ks = 0; ks < NKS; ++ks) {
              ctile::mma_bf16(sc[nt], ka[ks], bq[nt][ks]);
              ctile::mma_bf16(dpc[nt], va[ks], bo[nt][ks]);
            }
          }
          // p and ds of this thread's 8 pairs (keys gq, gq + 8 by queries
          // 8 nt + 2 tq + j), rounded to bf16 as the A fragments of dv and dk.
          float pr[2][4], ds[2][4];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int4 q = Qi[i0 + 8 * nt + 2 * tq + j];
              const float2 f = Qf[i0 + 8 * nt + 2 * tq + j];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const bool in = (unsigned)(kh_[e] - q.y) < (unsigned)g.kh &&
                                (unsigned)(kw_[e] - q.z) < (unsigned)g.kw;
                float sv = sc[nt][2 * e + j];
                if (p.rpb != nullptr && in) sv += Rs[q.w + koff[e]];
                const float e_ = in ? ex2_ftz(fmaf(sv, LOG2E, -f.x)) : 0.f;
                pr[nt][2 * e + j] = e_;
                ds[nt][2 * e + j] = e_ * (dpc[nt][2 * e + j] - f.y);
              }
            }
          const uint32_t ap[4] = {ctile::pack_bf16(pr[0][0], pr[0][1]), ctile::pack_bf16(pr[0][2], pr[0][3]),
                                  ctile::pack_bf16(pr[1][0], pr[1][1]), ctile::pack_bf16(pr[1][2], pr[1][3])};
          const uint32_t as[4] = {ctile::pack_bf16(ds[0][0], ds[0][1]), ctile::pack_bf16(ds[0][2], ds[0][3]),
                                  ctile::pack_bf16(ds[1][0], ds[1][1]), ctile::pack_bf16(ds[1][2], ds[1][3])};
          // dv += bf16(p)^T dO and dk += bf16(ds)^T q-hat: the queries as the
          // reduction index, from the same rows transposed.
          const int t_row = (lane >> 3) & 1 ? rb_row : ra_row;
#pragma unroll
          for (int x = 0; x < CP / 16; ++x) {
            const int at = t_row * LD + 16 * x + 8 * (lane >> 4);
            uint32_t b[4];
            ctile::ldmatrix_x4_trans(b, dos + at);
            const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
            ctile::mma_bf16(pv[2 * x], ap, b0);
            ctile::mma_bf16(pv[2 * x + 1], ap, b1);
            ctile::ldmatrix_x4_trans(b, qs + at);
            const uint32_t c0_[2] = {b[0], b[1]}, c1_[2] = {b[2], b[3]};
            ctile::mma_bf16(pk[2 * x], as, c0_);
            ctile::mma_bf16(pk[2 * x + 1], as, c1_);
          }
        }
      }
      if (closes) close_part();
      c0 = c1;
    }
  };

  Item it = first(lo_h);
  copy_item(it, 0);
  cp_async_commit();
  for (int s = 0; it.y0 < hi_h; ++s) {
    const Item nx = next(it);
    cp_async_wait<0>();
    __syncthreads();  // this item's copies landed; the other stage is free
    if (nx.y0 < hi_h) copy_item(nx, (s + 1) & 1);
    cp_async_commit();
    scale_item(it, s & 1);
    __syncthreads();
    if (live) walk(it, s & 1);
    it = nx;
  }
  cp_async_wait<0>();
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (!kst[e]) continue;
    const long long pos = b_pos + ((long long)jd * g.h + kh_[e]) * g.w + kw_[e];
    bf16* dk = p.dk + pos * hc + head * g.ch;
    bf16* dv = p.dv + pos * hc + head * g.ch;
#pragma unroll
    for (int n = 0; n < NNT; ++n) {
      const int c = 8 * n + 2 * tq;
      nelem::store1(dk, c, g.ch, tk[n][2 * e]);
      nelem::store1(dk, c + 1, g.ch, tk[n][2 * e + 1]);
      nelem::store1(dv, c, g.ch, tv[n][2 * e]);
      nelem::store1(dv, c + 1, g.ch, tv[n][2 * e + 1]);
    }
  }
}

template <int CP, class T>
int launch_dq(const Params<T>& p, cudaStream_t stream) {
  const Geometry& g = p.g;
  const int tq = g.td * g.th * g.tw;
  const int threads = (tq / NQ_DQ * (CP / CH_DQ) + 31) / 32 * 32;  // whole warps
  if (g.tw % NQ_DQ != 0 || threads > 256) return (int)cudaErrorInvalidValue;
  const int n_rel = (2 * g.kd - 1) * (2 * g.kh - 1) * (2 * g.kw - 1);
  const int n_tiles = (g.d + g.td - 1) / g.td * ((g.h + g.th - 1) / g.th) * ((g.w + g.tw - 1) / g.tw);
  const dim3 grid(n_tiles, g.heads, g.batch);
  size_t smem = sizeof(staged_t<T>) * ((size_t)2 * g.ud * g.uh * g.uw * (CP + row_pad<T>));
  if (p.rpb != nullptr) smem += sizeof(float) * ((size_t)n_rel + (size_t)tq * g.kd * g.kh * g.kw);
  cudaError_t err = cudaFuncSetAttribute(natten_dq_kernel<CP, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  natten_dq_kernel<CP, T><<<grid, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int CP>
int launch(int mode, const Params<float>& p, cudaStream_t stream) {
  const Geometry& g = p.g;
  if (mode == DQ) return launch_dq<CP>(p, stream);
  const int tq = g.td * g.th * g.tw;
  const int threads = (tq / NQ_DKV * (CP / CH_DKV) + 31) / 32 * 32;  // whole warps
  if (g.tw % NQ_DKV != 0 || threads > 256) return (int)cudaErrorInvalidValue;
  const int n_rel = (2 * g.kd - 1) * (2 * g.kh - 1) * (2 * g.kw - 1);
  const int n_tiles = (g.d + g.td - 1) / g.td * ((g.h + g.th - 1) / g.th) * ((g.w + g.tw - 1) / g.tw);
  const dim3 grid(n_tiles, g.heads, g.batch);
  if (g.ry > 0) {
    const size_t stage = ((size_t)g.ry * g.uw * (2 * (CP + 4) + 2) + 3) / 4 * 4;
    const size_t smem = sizeof(float) * (((size_t)n_rel + 3) / 4 * 4 + 2 * stage);
    cudaError_t err = cudaFuncSetAttribute(natten_dkv_kernel<CP, true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    natten_dkv_kernel<CP, true><<<grid, threads, smem, stream>>>(p);
  } else {
    const size_t smem = sizeof(float) * (((size_t)n_rel + 3) / 4 * 4);
    cudaError_t err = cudaFuncSetAttribute(natten_dkv_kernel<CP, false>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    natten_dkv_kernel<CP, false><<<grid, threads, smem, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

template <int CP>
int launch_bf16(int mode, const Params<bf16>& p, int ctas, cudaStream_t stream) {
  const Geometry& g = p.g;
  if (mode == DQ) return launch_dq<CP>(p, stream);
  const int warps = g.td * (g.th / PATCH_H) * (g.tw / PATCH_W);
  if (p.jth < 1 || p.jtw < 1 || g.ry < 1 || g.th % PATCH_H != 0 || g.tw % PATCH_W != 0 || warps < 1 ||
      warps > 8)
    return (int)cudaErrorInvalidValue;
  const int n_rel = (2 * g.kd - 1) * (2 * g.kh - 1) * (2 * g.kw - 1);
  const int n_tiles = (g.d + g.td - 1) / g.td * ((g.h + g.th - 1) / g.th) * ((g.w + g.tw - 1) / g.tw);
  const dim3 grid(n_tiles, g.heads, g.batch);
  const size_t stage = ((size_t)g.ud * g.ry * g.uw * (4 * (CP + 8) + 8) + 15) / 16 * 16;
  const size_t smem = sizeof(float) * (((size_t)n_rel + 3) / 4 * 4) +
                      (size_t)warps * DKV16_SLICE * (sizeof(int4) + sizeof(float2)) + 2 * stage;
  // compiled for one CTA of up to 8 warps an SM, or three of up to 4 (170
  // registers a thread)
  if (ctas != 1 && (ctas != 3 || warps > 4)) return (int)cudaErrorInvalidValue;
  auto kernel = ctas == 3 ? natten_dkv_bf16_kernel<CP, 128, 3> : natten_dkv_bf16_kernel<CP, 256, 1>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, 32 * warps, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). mode 0: dq, and the drpb partials
// when rpb and partial are given; mode 1: dk and dv. Launches on `stream`,
// does not synchronise, allocates nothing; returns a cudaError_t (0 on
// success), or cudaErrorInvalidValue for ch > 128, an unknown mode, or a
// tile whose W extent is not a multiple of its groups or that needs more
// than 256 threads. The tile, its staged extents (the halo in mode 0, the
// inverse window in mode 1) and the strip rows ry (mode 1; 0: the queries
// read through L1, unstaged) come from the host, which checked them against
// the volume and the shared memory.
extern "C" int gwt_natten_flash_backward(int mode, const float* q, const float* k,
                                         const float* v, const float* rpb, const float* dout,
                                         const float* lse, const float* delta, float* dq,
                                         float* dk, float* dv, float* partial, int batch, int d,
                                         int h, int w, int heads, int ch, long long q_ps,
                                         long long k_ps, long long v_ps, int kd, int kh, int kw,
                                         int circular_w, int td, int th, int tw, int ud, int uh,
                                         int uw, int vec4, float scale, int ry, void* stream) {
  if (mode != DQ && mode != DKV) return (int)cudaErrorInvalidValue;
  const Params<float> p{q, k, v, rpb, dout, lse, delta, dq, dk, dv, partial,
                        Geometry{batch, d, h, w, heads, ch, q_ps, k_ps, v_ps, kd, kh, kw,
                                 circular_w, td, th, tw, ud, uh, uw, vec4, scale, ry},
                        0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ch <= 16) return launch<16>(mode, p, s);
  if (ch <= 32) return launch<32>(mode, p, s);
  if (ch <= 64) return launch<64>(mode, p, s);
  if (ch <= 128) return launch<128>(mode, p, s);
  return (int)cudaErrorInvalidValue;
}

// The bf16 mode: q, k, v, rpb, dout, dq, dk and dv bf16 (strides in
// elements), lse and delta (= dO . out of the bf16 out) f32, partial f32 (the
// sums of ds unrounded); scale is ch^-0.5 (q-hat takes its bf16 value). vec:
// ch, the strides and the pointers allow 16-byte copies of eight channels.
// mode 0 takes the f32 dq kernel's tile; mode 1 its own key tile (whole
// 4 x 4 patches, at most 8 of them), item rows ry (ops/natten_flash.py
// `dkv_bf16_plan`), jth x jtw, the TPU kernel's query tile (H and W extents;
// the whole H and W where it has none), whose parts of dk and dv it rounds,
// and ctas, the CTAs an SM it is compiled for (1, or 3 for CTAs of at most 4
// warps: 170 registers). out (mode 0): the forward's bf16 out, dense; the dq
// kernel forms delta = dO . out itself (f32 sums) and writes it to
// delta_out for the dk/dv kernel (it reads no delta).
extern "C" int gwt_natten_flash_backward_bf16(int mode, const void* q, const void* k,
                                              const void* v, const void* rpb, const void* dout,
                                              const float* lse, const float* delta, void* dq,
                                              void* dk, void* dv, float* partial, int batch,
                                              int d, int h, int w, int heads, int ch,
                                              long long q_ps, long long k_ps, long long v_ps,
                                              int kd, int kh, int kw, int circular_w, int td,
                                              int th, int tw, int ud, int uh, int uw, int vec,
                                              float scale, int ry, int jth, int jtw,
                                              int ctas, const void* out, float* delta_out,
                                              void* stream) {
  if ((mode != DQ && mode != DKV) || (mode == DQ && (out == nullptr || delta_out == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Params<bf16> p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                       static_cast<const bf16*>(v), static_cast<const bf16*>(rpb),
                       static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq),
                       static_cast<bf16*>(dk), static_cast<bf16*>(dv), partial,
                       Geometry{batch, d, h, w, heads, ch, q_ps, k_ps, v_ps, kd, kh, kw,
                                circular_w, td, th, tw, ud, uh, uw, vec, scale, ry},
                       jth, jtw, static_cast<const bf16*>(out), delta_out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ch <= 16) return launch_bf16<16>(mode, p, ctas, s);
  if (ch <= 32) return launch_bf16<32>(mode, p, ctas, s);
  if (ch <= 64) return launch_bf16<64>(mode, p, ctas, s);
  if (ch <= 128) return launch_bf16<128>(mode, p, ctas, s);
  return (int)cudaErrorInvalidValue;
}
