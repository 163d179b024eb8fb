// Banded flash attention backward for Hopper (sm_90a), FP32 on the CUDA
// cores.
//
// Replaces the Pallas TPU kernel K4b, graph_weather_tpu/ops/pallas/
// banded_flash.py: _flash_bwd_impl (the pallas_calls of _dq_kernel and
// _dkv_kernel). The forward (banded_flash.cu) keeps, per batch entry, row
// and head, lse = m + log(max(l, 1e-30)). Receiver r of block b sees window
// slot j, key row s = b * block + j - w (a zero row outside [0, n)). With
// scale = 1 / sqrt(c):
//
//     p[r, s]  = exp(q_r . k_s * scale + bias[r, j] - lse_r)   (bias 0 / -1e30)
//     ds[r, s] = p[r, s] (dO_r . v_s - delta_r),  delta_r = dO_r . out_r
//     dq_r     = scale sum_s ds[r, s] k_s
//     dk_s     = scale sum_r ds[r, s] q_r,   dv_s = sum_r p[r, s] dO_r
//
// Masked pairs give p = 0 exactly, so rows without a neighbour and padded
// rows get exact-zero gradients.
//
// Two roles share one tile loop. A CTA owns TA rows and streams TB rows at
// a time, recomputing for each (own, streamed) pair x = a1 . b1 and
// y = a2 . b2, then p and ds, then acc1 += ds b1 (and acc2 += p b2):
//
//   DQ   own: TA receiver rows of block b (q, dO, lse, delta); streamed: the
//        block's window, TB key slots at a time (k, v). acc1 = dq.
//   DKV  own: TA key rows s0 .. s0 + TA - 1 (k, v); streamed: the receiver
//        rows of every block b whose window holds one of them,
//        b * block in (s0 - block - w, s0 + TA - 1 + w] (q, dO, lse, delta);
//        the pair (s, r) reads the mask of r's block at slot
//        s - b * block + w. acc1 = dk, acc2 = dv, written once to their
//        global rows: no atomics, no scatter, deterministic.
//
// The TPU code's dk/dv index maps were exact only for block == 512 and
// w % 512 == 0 (it fell back to an XLA VJP otherwise); DKV computes each key
// tile's receiver blocks directly, so it takes every layout. It does not
// assume a symmetric edge set.
//
// What bounds it on an H100. Per pair of a non-empty tile DQ does 3 and DKV
// 4 products of length c: 7 * 2c flops, on the FP32 FMA pipes, against
// 10 * c flops per real edge and ~180 MB of rows and masks per c = 128
// layer at splits 5. Each CTA streams its rows with cp.async, skips
// streamed tiles without an edge, register-tiles x and y (MR x MK per
// thread over a slice of c, summed through shared memory) and the
// accumulations (MR2 x MD per thread), and keeps everything in f32. Tiles
// follow c: 64 x 64 at c <= 128 (205 KB), 16 own x 32 streamed rows at
// c = 512 (222 KB), one 256-thread CTA per SM.
//
// Not yet here: tensor cores (3xTF32), bf16, a fused DQ + DKV pass.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr float NEG = -1e30f;  // additive bias off an edge

enum Role { DQ = 0, DKV = 1 };

struct Params {
  const float* q;      // [B, n, h, c]
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;    // [B, n_pad, h]
  const float* delta;  // [B, n_pad, h], zero past n
  const signed char* masks;  // [n_blocks, block, width]
  float* dq;  // [B, n, h, c]
  float* dk;
  float* dv;
  int n;
  int heads;
  int c;
  int n_blocks;
  int block;
  int w;
  int width;  // block + 2 w
  int vec4;   // c % 4 == 0 and every row 16-byte aligned
  float scale;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

// Waits for this thread's copies, then for every thread's.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
}

// dst[r][0:CP) = row_ptr(r)[0:c), zero past c or where row_ptr(r) is null.
template <int CP, int NROWS, class RowPtr>
__device__ __forceinline__ void copy_rows(float* dst, int ld, const Params& p,
                                          RowPtr row_ptr) {
  if (p.vec4) {
    constexpr int V = CP / 4;
    for (int i = threadIdx.x; i < NROWS * V; i += THREADS) {
      const int r = i / V;
      const int d = (i % V) * 4;
      const float* src = row_ptr(r);
      const bool ok = src != nullptr && d < p.c;
      cp_async16(dst + r * ld + d, ok ? src + d : p.q, ok);
    }
  } else {
    for (int i = threadIdx.x; i < NROWS * CP; i += THREADS) {
      const int r = i / CP;
      const int d = i % CP;
      const float* src = row_ptr(r);
      const bool ok = src != nullptr && d < p.c;
      cp_async4(dst + r * ld + d, ok ? src + d : p.q, ok);
    }
  }
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float get(const float4 a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

// MR2 consecutive floats of a transposed tile row (MR2 is 2 or 4).
template <int MR2>
__device__ __forceinline__ void load_col(const float* src, float* out) {
  if constexpr (MR2 == 4) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    out[0] = x.x;
    out[1] = x.y;
    out[2] = x.z;
    out[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(src);
    out[0] = x.x;
    out[1] = x.y;
  }
}

// Tile shapes. CP: padded head width; TA x TB: own rows x streamed rows per
// tile; MR x MK: x and y entries per thread; MR2 x MD: accumulator entries
// per thread.
template <int CP_, int TA_, int TB_, int MR_, int MK_, int MR2_, int MD_>
struct Cfg {
  static constexpr int CP = CP_, TA = TA_, TB = TB_;
  static constexpr int MR = MR_, MK = MK_, MR2 = MR2_, MD = MD_;
  static constexpr int GR = TA / MR;          // row groups in x, y
  static constexpr int GK = TB / MK;          // streamed groups in x, y
  static constexpr int SLICE = GR * GK;       // threads per slice of c
  static constexpr int SK = THREADS / SLICE;  // slices of c, summed in smem
  static constexpr int DS = CP / SK;          // channels per slice
  static constexpr int GD = CP / MD;          // channel groups of the accumulators
  static constexpr int E = TA * TB / THREADS;  // (own, streamed) pairs per thread
  static constexpr int LPR = TB / E;          // lanes per own row
  static constexpr int LDA = CP + 4;          // rows of a1, a2, b1, b2, padded
  static constexpr int LDS = TB + 4;          // rows of the x, y partials
  static constexpr int LDP = TA + 4;          // rows of the transposed p, ds
  static constexpr size_t smem_bytes =
      sizeof(float) * (2 * TA * LDA + 2 * TB * LDA + 2 * SK * TA * LDS +
                       2 * TB * LDP + 2 * TB);
  static_assert(SLICE * SK == THREADS && DS % 4 == 0, "x, y thread layout");
  static_assert((TA / MR2) * GD == THREADS && MD % 4 == 0, "accumulator layout");
  static_assert(MR2 == 2 || MR2 == 4, "accumulators read MR2 rows at once");
  static_assert(E * THREADS == TA * TB && LPR <= 32 && 32 % LPR == 0 && E <= 32,
                "pair layout");
};

template <class C, int ROLE>
__global__ void __launch_bounds__(THREADS)
    banded_flash_bwd_kernel(const Params p) {
  constexpr int CP = C::CP, TA = C::TA, TB = C::TB, MR = C::MR, MK = C::MK;
  constexpr int MR2 = C::MR2, MD = C::MD, GR = C::GR, GK = C::GK;
  constexpr int SLICE = C::SLICE, SK = C::SK, DS = C::DS, GD = C::GD;
  constexpr int E = C::E, LPR = C::LPR;
  constexpr int LDA = C::LDA, LDS = C::LDS, LDP = C::LDP;
  constexpr bool IS_DKV = ROLE == DKV;  // two accumulators
  constexpr int NA2 = IS_DKV ? MR2 : 1, ND2 = IS_DKV ? MD : 1;

  extern __shared__ float4 smem4[];
  float* A1 = reinterpret_cast<float*>(smem4);  // [TA][LDA] own q or k
  float* A2 = A1 + TA * LDA;                    // [TA][LDA] own dO or v
  float* B1 = A2 + TA * LDA;                    // [TB][LDA] streamed k or q
  float* B2 = B1 + TB * LDA;                    // [TB][LDA] streamed v or dO
  float* Xs = B2 + TB * LDA;                    // [SK][TA][LDS] partial x
  float* Ys = Xs + SK * TA * LDS;               // [SK][TA][LDS] partial y
  float* Pt = Ys + SK * TA * LDS;               // [TB][LDP] p, transposed
  float* Dt = Pt + TB * LDP;                    // [TB][LDP] ds, transposed
  float* s_lse = Dt + TB * LDP;                 // [TB] streamed rows' lse
  float* s_delta = s_lse + TB;                  // [TB] streamed rows' delta

  const int tid = threadIdx.x;
  const int g = blockIdx.y;
  const long long base = (long long)blockIdx.z * p.n;  // this batch entry's rows
  const long long l_base = (long long)blockIdx.z * p.n_blocks * p.block;

  // DQ: own rows a0 .. of block b, streamed window slots str0 + i (key row
  // key0 + str0 + i). DKV: own global key rows a0 .., streamed global
  // receiver rows str0 + i, i < n_str.
  int b = 0, a0, str0, n_str, key0 = 0;
  if (!IS_DKV) {
    const int a_tiles = (p.block + TA - 1) / TA;
    b = blockIdx.x / a_tiles;
    a0 = (blockIdx.x % a_tiles) * TA;
    str0 = 0;
    n_str = p.width;
    key0 = b * p.block - p.w;
  } else {
    a0 = blockIdx.x * TA;
    const int lo = a0 - p.block - p.w;  // first block: b * block > lo
    const int b_lo = lo < 0 ? 0 : lo / p.block + 1;
    const int b_hi = min(p.n_blocks - 1, (a0 + TA - 1 + p.w) / p.block);
    str0 = b_lo * p.block;
    n_str = max(0, min((b_hi + 1) * p.block, p.n) - str0);
  }

  // Row `row` of a [B, n, h, c] tensor, or null outside [0, n).
  auto row_ptr = [&](const float* t, int row) -> const float* {
    return row >= 0 && row < p.n ? t + ((base + row) * p.heads + g) * p.c : nullptr;
  };
  auto own_ptr = [&](const float* t, int r) -> const float* {
    const int lr = a0 + r;
    if (IS_DKV) return row_ptr(t, lr);
    return lr < p.block ? row_ptr(t, b * p.block + lr) : nullptr;
  };
  auto str_ptr = [&](const float* t, int s0, int r) -> const float* {
    const int i = s0 + r;
    if (i >= n_str) return nullptr;
    return row_ptr(t, IS_DKV ? str0 + i : key0 + i);
  };
  const float* own1 = IS_DKV ? p.k : p.q;
  const float* own2 = IS_DKV ? p.v : p.dout;
  const float* str1 = IS_DKV ? p.q : p.k;
  const float* str2 = IS_DKV ? p.dout : p.v;
  copy_rows<CP, TA>(A1, LDA, p, [&](int r) { return own_ptr(own1, r); });
  copy_rows<CP, TA>(A2, LDA, p, [&](int r) { return own_ptr(own2, r); });

  // x, y layout: slice `sl` of c, row group rg (rows rg + GR*i), streamed
  // group kg (rows kg + GK*j); kg is fastest, so b1/b2 reads are conflict-free.
  const int sl = tid / SLICE;
  const int rg = (tid % SLICE) / GK;
  const int kg = tid % GK;
  // Pair layout: own row sr, streamed rows sk0 .. sk0 + E - 1.
  const int sr = tid / LPR;
  const int sk0 = (tid % LPR) * E;
  const int own_l = a0 + sr;
  // Accumulator layout: own rows rg2 * MR2 .. + MR2 - 1, channels
  // 4 dg + 4 GD jj + x.
  const int rg2 = tid / GD;
  const int dg = tid % GD;

  // The DQ role's own row: its lse and delta.
  float row_lse = 0.f, row_delta = 0.f;
  if (!IS_DKV && own_l < p.block) {
    const long long i = (l_base + b * p.block + own_l) * p.heads + g;
    row_lse = p.lse[i];
    row_delta = p.delta[i];
  }

  float acc1[MR2][MD], acc2[NA2][ND2];
#pragma unroll
  for (int i = 0; i < MR2; ++i)
#pragma unroll
    for (int j = 0; j < MD; ++j) acc1[i][j] = 0.f;
#pragma unroll
  for (int i = 0; i < NA2; ++i)
#pragma unroll
    for (int j = 0; j < ND2; ++j) acc2[i][j] = 0.f;

  for (int s0 = 0; s0 < n_str; s0 += TB) {
    // This thread's mask bytes; a streamed tile without an edge is skipped.
    unsigned edges = 0;
    if (IS_DKV ? own_l < p.n : own_l < p.block) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int i = s0 + sk0 + e;
        if (i >= n_str) break;
        long long m = -1;
        if (IS_DKV) {
          const int r = str0 + i;  // receiver row; the key is own_l
          const int j = own_l - (r / p.block) * p.block + p.w;
          if (j >= 0 && j < p.width) m = (long long)r * p.width + j;
        } else {
          m = ((long long)b * p.block + own_l) * p.width + i;
        }
        if (m >= 0 && p.masks[m] != 0) edges |= 1u << e;
      }
    }
    if (!__syncthreads_or(edges != 0)) continue;

    copy_rows<CP, TB>(B1, LDA, p, [&](int r) { return str_ptr(str1, s0, r); });
    copy_rows<CP, TB>(B2, LDA, p, [&](int r) { return str_ptr(str2, s0, r); });
    if (IS_DKV && tid < TB) {
      // Streamed receivers' lse and delta; 0 for rows that are not there
      // (their dO is 0, so they add exact zeros).
      const int i = s0 + tid;
      const long long li = (l_base + str0 + i) * p.heads + g;
      s_lse[tid] = i < n_str ? p.lse[li] : 0.f;
      s_delta[tid] = i < n_str ? p.delta[li] : 0.f;
    }
    cp_async_wait_all();

    // Partial x = a1 . b1 and y = a2 . b2 over this thread's slice of c.
    {
      float ax[MR][MK], ay[MR][MK];
#pragma unroll
      for (int i = 0; i < MR; ++i)
#pragma unroll
        for (int j = 0; j < MK; ++j) ax[i][j] = ay[i][j] = 0.f;
      const float* a1 = A1 + rg * LDA + sl * DS;
      const float* a2 = A2 + rg * LDA + sl * DS;
      const float* b1 = B1 + kg * LDA + sl * DS;
      const float* b2 = B2 + kg * LDA + sl * DS;
#pragma unroll 2
      for (int d = 0; d < DS; d += 4) {
        float4 v1[MK], v2[MK];
#pragma unroll
        for (int j = 0; j < MK; ++j) {
          v1[j] = *reinterpret_cast<const float4*>(b1 + GK * j * LDA + d);
          v2[j] = *reinterpret_cast<const float4*>(b2 + GK * j * LDA + d);
        }
#pragma unroll
        for (int i = 0; i < MR; ++i) {
          const float4 u1 = *reinterpret_cast<const float4*>(a1 + GR * i * LDA + d);
          const float4 u2 = *reinterpret_cast<const float4*>(a2 + GR * i * LDA + d);
#pragma unroll
          for (int j = 0; j < MK; ++j) {
            ax[i][j] = dot4(u1, v1[j], ax[i][j]);
            ay[i][j] = dot4(u2, v2[j], ay[i][j]);
          }
        }
      }
      float* xs = Xs + sl * TA * LDS + rg * LDS + kg;
      float* ys = Ys + sl * TA * LDS + rg * LDS + kg;
#pragma unroll
      for (int i = 0; i < MR; ++i)
#pragma unroll
        for (int j = 0; j < MK; ++j) {
          xs[GR * i * LDS + GK * j] = ax[i][j];
          ys[GR * i * LDS + GK * j] = ay[i][j];
        }
    }
    __syncthreads();

    // p and ds of this thread's pairs, transposed into Pt and Dt.
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float x = 0.f, y = 0.f;
#pragma unroll
      for (int t = 0; t < SK; ++t) {
        x += Xs[t * TA * LDS + sr * LDS + sk0 + e];
        y += Ys[t * TA * LDS + sr * LDS + sk0 + e];
      }
      const float lse = IS_DKV ? s_lse[sk0 + e] : row_lse;
      const float delta = IS_DKV ? s_delta[sk0 + e] : row_delta;
      const float pr = expf(x * p.scale + ((edges >> e) & 1u ? 0.f : NEG) - lse);
      Pt[(sk0 + e) * LDP + sr] = pr;
      Dt[(sk0 + e) * LDP + sr] = pr * (y - delta);
    }
    __syncthreads();

    // acc1 += ds b1 (and acc2 += p b2) for this thread's rows and channels.
#pragma unroll 4
    for (int kk = 0; kk < TB; ++kk) {
      float ds[MR2], pr[MR2];
      load_col<MR2>(Dt + kk * LDP + rg2 * MR2, ds);
      if (IS_DKV) load_col<MR2>(Pt + kk * LDP + rg2 * MR2, pr);
      const float* b1 = B1 + kk * LDA + 4 * dg;
      const float* b2 = B2 + kk * LDA + 4 * dg;
#pragma unroll
      for (int jj = 0; jj < MD / 4; ++jj) {
        const float4 u1 = *reinterpret_cast<const float4*>(b1 + 4 * GD * jj);
#pragma unroll
        for (int i = 0; i < MR2; ++i)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            acc1[i][4 * jj + x] = fmaf(ds[i], get(u1, x), acc1[i][4 * jj + x]);
        if constexpr (IS_DKV) {
          const float4 u2 = *reinterpret_cast<const float4*>(b2 + 4 * GD * jj);
#pragma unroll
          for (int i = 0; i < MR2; ++i)
#pragma unroll
            for (int x = 0; x < 4; ++x)
              acc2[i][4 * jj + x] = fmaf(pr[i], get(u2, x), acc2[i][4 * jj + x]);
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);  // own rows, when every tile was skipped

  // Outputs: dq and dk scaled, dv as summed.
#pragma unroll
  for (int i = 0; i < MR2; ++i) {
    const int r = a0 + rg2 * MR2 + i;  // own row within the block, or key row
    float* dst1;
    float* dst2 = nullptr;
    if (IS_DKV) {
      if (r >= p.n) continue;
      dst1 = p.dk + ((base + r) * p.heads + g) * p.c;
      dst2 = p.dv + ((base + r) * p.heads + g) * p.c;
    } else {
      const int row = b * p.block + r;
      if (r >= p.block || row >= p.n) continue;
      dst1 = p.dq + ((base + row) * p.heads + g) * p.c;
    }
#pragma unroll
    for (int jj = 0; jj < MD / 4; ++jj) {
      const int d = 4 * dg + 4 * GD * jj;
      float o1[4], o2[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        o1[x] = acc1[i][4 * jj + x] * p.scale;
        o2[x] = 0.f;
        if constexpr (IS_DKV) o2[x] = acc2[i][4 * jj + x];
      }
      if (p.vec4 && d < p.c) {
        *reinterpret_cast<float4*>(dst1 + d) = make_float4(o1[0], o1[1], o1[2], o1[3]);
        if (IS_DKV)
          *reinterpret_cast<float4*>(dst2 + d) = make_float4(o2[0], o2[1], o2[2], o2[3]);
      } else {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          if (d + x >= p.c) break;
          dst1[d + x] = o1[x];
          if (IS_DKV) dst2[d + x] = o2[x];
        }
      }
    }
  }
}

template <class C, int ROLE>
int launch(const Params& p, int batch, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(banded_flash_bwd_kernel<C, ROLE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = ROLE == DQ ? p.n_blocks * ((p.block + C::TA - 1) / C::TA)
                                 : (p.n + C::TA - 1) / C::TA;
  const dim3 grid(n_tiles, p.heads, batch);
  banded_flash_bwd_kernel<C, ROLE><<<grid, THREADS, C::smem_bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

// mode 0: the dq kernel; 1: the dk/dv kernel.
template <class C>
int run(const Params& p, int mode, int batch, cudaStream_t stream) {
  if (mode == 0) return launch<C, DQ>(p, batch, stream);
  if (mode == 1) return launch<C, DKV>(p, batch, stream);
  return (int)cudaErrorInvalidValue;
}

//                        CP   TA  TB  MR  MK  MR2  MD
using Narrow = Cfg<32, 64, 64, 4, 4, 2, 4>;
using Mid = Cfg<128, 64, 64, 4, 4, 4, 8>;
using Wide = Cfg<512, 16, 32, 2, 4, 4, 8>;

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing; returns a cudaError_t (0 on success), or
// cudaErrorInvalidValue for c > 512 or an unknown mode. Pointers a mode does
// not write may be null. The masks are [n_blocks, block, block + 2w] int8;
// the batch entries share them.
extern "C" int gwt_banded_flash_backward(
    const float* q, const float* k, const float* v, const float* dout,
    const float* lse, const float* delta, const signed char* masks, float* dq,
    float* dk, float* dv, int batch, int n, int heads, int c, int n_blocks,
    int block, int w, int vec4, float scale, int mode, void* stream) {
  const Params p{q,  k,  v, dout,  lse,      delta, masks, dq, dk,
                 dv, n, heads, c, n_blocks, block, w,     block + 2 * w,
                 vec4, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c <= 32) return run<Narrow>(p, mode, batch, s);
  if (c <= 128) return run<Mid>(p, mode, batch, s);
  if (c <= 512) return run<Wide>(p, mode, batch, s);
  return (int)cudaErrorInvalidValue;
}
