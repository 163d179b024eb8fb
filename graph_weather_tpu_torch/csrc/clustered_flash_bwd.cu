// Clustered (gathered-neighbour) flash attention backward for Hopper
// (sm_90a), FP32 on the CUDA cores.
//
// Replaces the Pallas TPU kernels K3b and K3c, graph_weather_tpu/ops/pallas/
// clustered_flash.py: _clustered_bwd_impl (the general backward:
// _bwd_kernel_onepass / _bwd_kernel, dq plus block-local dk/dv, then an XLA
// segment-sum) and _bwd_symmetric (the scatter-free backward for symmetric
// graphs: _dq_kernel_onepass over receiver blocks and _dkv_kernel_onepass
// over key blocks). The forward (clustered_flash.cu) keeps, per batch entry,
// row and head, lse = m + log(max(l, 1e-30)). With scale = 1 / sqrt(c), for
// receiver row r of block b and union slot u (key row ids[b, u]):
//
//     p[r, u]  = exp(q_r . k_u * scale + bias[r, u] - lse_r)   (bias 0 / -1e30)
//     ds[r, u] = p[r, u] (dO_r . v_u - delta_r),  delta_r = dO_r . out_r
//     dq_r     = scale sum_u ds[r, u] k_u
//     dk_u     = scale sum_r ds[r, u] q_r,   dv_u = sum_r p[r, u] dO_r
//
// Masked pairs give p = 0 exactly, so rows without a neighbour, padded rows
// and padding slots (row 0, all-zero mask column) get exact-zero gradients.
//
// Three roles share one tile loop. A CTA owns TA rows and streams TB rows at
// a time, recomputing for each (own, streamed) pair x = a1 . b1 and
// y = a2 . b2, then p and ds, then acc1 += ds b1 (and acc2 += p b2):
//
//   DQ            own: TA receiver rows of block b (q, dO, lse, delta);
//                 streamed: its union's key slots (k, v gathered by id).
//                 acc1 = dq. Used by both backwards.
//   DKV_GATHERED  own: TA union slots of block b (k, v gathered by id);
//                 streamed: the block's receiver rows (q, dO, lse, delta).
//                 acc1 = dk, acc2 = dv, written block-local
//                 [B, nb, U_pad, h, c]; the caller sums them to global rows.
//   DKV_OWN       own: TA rows of key block b (k, v); streamed: its union
//                 (q, dO, lse, delta gathered by id). For a symmetric edge
//                 set the receivers that attend block b's keys are exactly
//                 block b's union, and masks[b] read as [keys, receivers] is
//                 the adjacency: dk, dv land straight on their global rows.
//
// The general backward (K3b) launches DQ and DKV_GATHERED; the symmetric one
// (K3c) launches DQ and DKV_OWN, one launch each.
//
// What bounds it on an H100. Per (row, slot) pair the DQ role does 3 and the
// dk/dv roles 4 products of length c, so 7 * 2c flops per pair of a
// non-empty tile: at GenCast's splits-5 layout ~41 GFLOP per c = 128 layer
// (72% of its 58 GFLOP of (row, slot) pairs lie in tiles with an edge),
// against 1.3 GFLOP on the real edges. The FP32 FMA pipes bound it, as they
// bound the forward. The design: each CTA gathers its
// rows itself with cp.async (the TPU code gathered the unions in XLA), skips
// streamed tiles without an edge, register-tiles x and y (MR x MK per thread
// over a slice of c, summed through shared memory) and the accumulations
// (MR2 x MD per thread), and keeps everything in f32. Tiles follow c:
// 64 x 64 at c <= 128 (205 KB), 16 own x 32 streamed rows at c = 512
// (222 KB), one 256-thread CTA per SM.
//
// Not yet here: tensor cores (3xTF32), bf16, a fused DQ + DKV pass.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr float NEG = -1e30f;  // additive bias off an edge

enum Role { DQ = 0, DKV_GATHERED = 1, DKV_OWN = 2 };

struct Params {
  const float* q;      // [B, n_q, h, c]
  const float* k;      // [B, n_kv, h, c]
  const float* v;
  const float* dout;   // [B, n_q, h, c]
  const float* lse;    // [B, n_pad, h]
  const float* delta;  // [B, n_pad, h], zero past n_q
  const int* ids;
  const signed char* masks;
  float* dq;  // [B, n_q, h, c]
  float* dk;  // DKV_GATHERED: [B, nb, u_pad, h, c]; DKV_OWN: [B, n_kv, h, c]
  float* dv;
  int n_q;
  int n_kv;
  int heads;
  int c;
  int n_blocks;
  int block;
  int u_pad;
  int vec4;  // c % 4 == 0 and every row 16-byte aligned
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
  static constexpr size_t fixed_bytes =
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
    clustered_flash_bwd_kernel(const Params p) {
  constexpr int CP = C::CP, TA = C::TA, TB = C::TB, MR = C::MR, MK = C::MK;
  constexpr int MR2 = C::MR2, MD = C::MD, GR = C::GR, GK = C::GK;
  constexpr int SLICE = C::SLICE, SK = C::SK, DS = C::DS, GD = C::GD;
  constexpr int E = C::E, LPR = C::LPR;
  constexpr int LDA = C::LDA, LDS = C::LDS, LDP = C::LDP;
  constexpr bool DKV = ROLE != DQ;             // dk/dv roles: two accumulators
  constexpr bool OWN_SLOTS = ROLE == DKV_GATHERED;  // own rows are union slots
  constexpr int NA2 = DKV ? MR2 : 1, ND2 = DKV ? MD : 1;

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
  int* s_ids = reinterpret_cast<int*>(s_delta + TB);  // [u_pad]

  const int tid = threadIdx.x;
  const int n_own = OWN_SLOTS ? p.u_pad : p.block;
  const int n_str = OWN_SLOTS ? p.block : p.u_pad;
  const int a_tiles = (n_own + TA - 1) / TA;
  const int b = blockIdx.x / a_tiles;
  const int a0 = (blockIdx.x % a_tiles) * TA;
  const int g = blockIdx.y;
  const int bz = blockIdx.z;
  const long long q_base = (long long)bz * p.n_q;
  const long long kv_base = (long long)bz * p.n_kv;
  const long long l_base = (long long)bz * p.n_blocks * p.block;

  for (int u = tid; u < p.u_pad; u += THREADS)
    s_ids[u] = p.ids[(long long)b * p.u_pad + u];
  __syncthreads();

  // Row lr of block b of a [B, N, h, c] tensor, or slot u of its union.
  auto block_row = [&](const float* t, long long base, int n_rows, int lr) -> const float* {
    const int row = b * p.block + lr;
    return lr < p.block && row < n_rows ? t + ((base + row) * p.heads + g) * p.c
                                        : nullptr;
  };
  auto slot_row = [&](const float* t, long long base, int u) -> const float* {
    return u < p.u_pad ? t + ((base + s_ids[u]) * p.heads + g) * p.c : nullptr;
  };
  const float* own1 = DKV ? p.k : p.q;
  const float* own2 = DKV ? p.v : p.dout;
  const float* str1 = DKV ? p.q : p.k;
  const float* str2 = DKV ? p.dout : p.v;
  const long long own_base = DKV ? kv_base : q_base;
  const long long str_base = DKV ? q_base : kv_base;
  const int own_n = DKV ? p.n_kv : p.n_q;
  const int str_n = DKV ? p.n_q : p.n_kv;
  auto own_ptr = [&](const float* t, int r) -> const float* {
    return OWN_SLOTS ? slot_row(t, own_base, a0 + r) : block_row(t, own_base, own_n, a0 + r);
  };
  auto str_ptr = [&](const float* t, int s0, int r) -> const float* {
    return OWN_SLOTS ? block_row(t, str_base, str_n, s0 + r) : slot_row(t, str_base, s0 + r);
  };
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
  if (!DKV && own_l < p.block) {
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
    if (own_l < n_own) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int s = s0 + sk0 + e;
        if (s >= n_str) break;
        const long long m = OWN_SLOTS
                                ? ((long long)b * p.block + s) * p.u_pad + own_l
                                : ((long long)b * p.block + own_l) * p.u_pad + s;
        if (p.masks[m] != 0) edges |= 1u << e;
      }
    }
    if (!__syncthreads_or(edges != 0)) continue;

    copy_rows<CP, TB>(B1, LDA, p, [&](int r) { return str_ptr(str1, s0, r); });
    copy_rows<CP, TB>(B2, LDA, p, [&](int r) { return str_ptr(str2, s0, r); });
    if (DKV && tid < TB) {
      // Streamed rows' lse and delta; 0 for rows that are not there (their
      // dO and delta are 0, so they add exact zeros).
      const int s = s0 + tid;
      int row = -1;
      if (OWN_SLOTS) {
        if (s < p.block && b * p.block + s < p.n_q) row = b * p.block + s;
      } else if (s < p.u_pad) {
        row = s_ids[s];
      }
      const long long i = (l_base + row) * p.heads + g;
      s_lse[tid] = row >= 0 ? p.lse[i] : 0.f;
      s_delta[tid] = row >= 0 ? p.delta[i] : 0.f;
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
      const float lse = DKV ? s_lse[sk0 + e] : row_lse;
      const float delta = DKV ? s_delta[sk0 + e] : row_delta;
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
      if (DKV) load_col<MR2>(Pt + kk * LDP + rg2 * MR2, pr);
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
        if constexpr (DKV) {
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
    const int r = a0 + rg2 * MR2 + i;  // own row within the block, or slot
    float* dst1;
    float* dst2 = nullptr;
    if (ROLE == DQ) {
      const int row = b * p.block + r;
      if (r >= p.block || row >= p.n_q) continue;
      dst1 = p.dq + ((q_base + row) * p.heads + g) * p.c;
    } else if (ROLE == DKV_OWN) {
      const int row = b * p.block + r;
      if (r >= p.block || row >= p.n_kv) continue;
      dst1 = p.dk + ((kv_base + row) * p.heads + g) * p.c;
      dst2 = p.dv + ((kv_base + row) * p.heads + g) * p.c;
    } else {
      if (r >= p.u_pad) continue;
      const long long slot = ((long long)bz * p.n_blocks + b) * p.u_pad + r;
      dst1 = p.dk + (slot * p.heads + g) * p.c;
      dst2 = p.dv + (slot * p.heads + g) * p.c;
    }
#pragma unroll
    for (int jj = 0; jj < MD / 4; ++jj) {
      const int d = 4 * dg + 4 * GD * jj;
      float o1[4], o2[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        o1[x] = acc1[i][4 * jj + x] * p.scale;
        o2[x] = 0.f;
        if constexpr (DKV) o2[x] = acc2[i][4 * jj + x];
      }
      if (p.vec4 && d < p.c) {
        *reinterpret_cast<float4*>(dst1 + d) = make_float4(o1[0], o1[1], o1[2], o1[3]);
        if (DKV)
          *reinterpret_cast<float4*>(dst2 + d) = make_float4(o2[0], o2[1], o2[2], o2[3]);
      } else {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          if (d + x >= p.c) break;
          dst1[d + x] = o1[x];
          if (DKV) dst2[d + x] = o2[x];
        }
      }
    }
  }
}

template <class C, int ROLE>
int launch(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = C::fixed_bytes + sizeof(int) * (size_t)p.u_pad;
  cudaError_t err = cudaFuncSetAttribute(clustered_flash_bwd_kernel<C, ROLE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_own = ROLE == DKV_GATHERED ? p.u_pad : p.block;
  const dim3 grid(p.n_blocks * ((n_own + C::TA - 1) / C::TA), p.heads, batch);
  clustered_flash_bwd_kernel<C, ROLE><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// mode 0: general backward (DQ, then DKV_GATHERED); 1: DQ alone; 2: DKV_OWN.
template <class C>
int run(const Params& p, int mode, int batch, cudaStream_t stream) {
  if (mode == 0) {
    const int err = launch<C, DQ>(p, batch, stream);
    return err != 0 ? err : launch<C, DKV_GATHERED>(p, batch, stream);
  }
  if (mode == 1) return launch<C, DQ>(p, batch, stream);
  if (mode == 2) return launch<C, DKV_OWN>(p, batch, stream);
  return (int)cudaErrorInvalidValue;
}

//                        CP   TA  TB  MR  MK  MR2  MD
using Narrow = Cfg<32, 64, 64, 4, 4, 2, 4>;
using Mid = Cfg<128, 64, 64, 4, 4, 4, 8>;
using Wide = Cfg<512, 16, 32, 2, 4, 4, 8>;

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing; returns a cudaError_t (0 on success), or
// cudaErrorInvalidValue for c > 512 or an unknown mode. Pointers a mode
// does not write may be null. gather_ids are trusted: they are checked on
// the host when the graph's layout is built.
extern "C" int gwt_clustered_flash_backward(
    const float* q, const float* k, const float* v, const float* dout,
    const float* lse, const float* delta, const int* gather_ids,
    const signed char* masks, float* dq, float* dk, float* dv, int batch,
    int n_q, int n_kv, int heads, int c, int n_blocks, int block, int u_pad,
    int vec4, float scale, int mode, void* stream) {
  const Params p{q,  k,  v,  dout, lse,   delta,    gather_ids, masks, dq, dk,
                 dv, n_q, n_kv, heads, c, n_blocks, block, u_pad, vec4, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c <= 32) return run<Narrow>(p, mode, batch, s);
  if (c <= 128) return run<Mid>(p, mode, batch, s);
  if (c <= 512) return run<Wide>(p, mode, batch, s);
  return (int)cudaErrorInvalidValue;
}
