// Banded flash attention forward for Hopper (sm_90a), FP32 on the CUDA cores.
//
// Replaces the Pallas TPU kernel K4a, graph_weather_tpu/ops/pallas/
// banded_flash.py: _flash_impl (the pallas_call of _kernel). The mesh nodes
// are spatially sorted, so every edge joins rows at most w apart: receiver
// block b (rows b * block .. + block - 1) attends to a window of
// block + 2w key rows, slot j being key row s = b * block + j - w (a zero
// row outside [0, n)), through the int8 adjacency masks[b, row, j]. For batch
// entry i, head g and receiver row r of block b:
//
//     out[i, r, g] = sum_j softmax_j(q.k[s] * scale + bias) v[s]
//
// with bias = 0 on an edge and -1e30 off it, the running max starting at
// -1e28 and the output divided by max(l, 1e-30), as in the TPU kernel: a
// row with no neighbour (and a padded row past n) comes out exactly 0. q, k,
// v and out are [B, n, h, c]. When the caller asks for it (training), the
// kernel also writes the log-sum-exp m + log(max(l, 1e-30)) of every row of
// every block, f32 [B, nb * block, h], which the backward
// (banded_flash_bwd.cu) reads.
//
// What bounds it on an H100. The edges of GenCast's splits-5 k-hop graph
// fill 2.2% of its [21, 512, 2560] band: the work these inputs need moves
// the q, k, v and out rows and the 27.5 MB mask (bytes, ~35 us per c = 128
// call). The kernel computes every pair of a (query tile, key tile) that
// holds at least one edge: 4 * c flops per pair, on the FP32 FMA pipes. The
// TPU code ran 512-row blocks against 512-key tiles in VMEM, heads grouped
// against a VMEM budget and c padded to 128 lanes; here:
//
//   * one CTA owns a tile of TQ receiver rows of one block, one head and one
//     batch entry, and streams its window TK key rows at a time with
//     cp.async straight from [B, n, h, c] rows into shared memory: the
//     window's rows are contiguous, so nothing is gathered or copied ahead;
//   * before any copy, the CTA reads the tile's int8 mask bytes and skips a
//     key tile with no edge (52% of 64 x 64 tiles at splits 5): an
//     all-masked tile leaves the online softmax exactly as it was;
//   * q.k and p.v are register-tiled products: each thread owns an MR x MK
//     tile of logits (over a slice of c, summed through shared memory) and
//     an MR2 x MD tile of the output, reading float4s that are broadcast or
//     conflict-free across a warp;
//   * the softmax is online over the key tiles, in f32; a row's max and sum
//     are shuffles over the LPR lanes that hold it;
//   * the tile sizes follow c: 64 x 64 at c <= 128 (155 KB), 32 x 32 at
//     c = 512 (222 KB), one 256-thread CTA per SM. The batch is the grid's
//     z axis; every batch entry reads the same mask.
//
// Not yet here: tensor cores (3xTF32 would keep f32 accuracy), TMA, bf16, a
// per-tile table of non-empty key tiles built once on the host.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr float NEG = -1e30f;   // additive bias off an edge
constexpr float SAFE = -1e28f;  // running-max start: exp(NEG - SAFE) == 0

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const signed char* masks;  // [n_blocks, block, width]
  float* out;
  float* lse;  // [B, n_blocks * block, h], or null: not written
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

// Tile shapes. CP: padded head width; TQ x TK: query rows x key slots per
// tile; MR x MK: logits per thread in q.k; MR2 x MD: outputs per thread in
// p.v.
template <int CP_, int TQ_, int TK_, int MR_, int MK_, int MR2_, int MD_>
struct Cfg {
  static constexpr int CP = CP_, TQ = TQ_, TK = TK_;
  static constexpr int MR = MR_, MK = MK_, MR2 = MR2_, MD = MD_;
  static constexpr int GR = TQ / MR;         // row groups in q.k
  static constexpr int GK = TK / MK;         // key groups in q.k
  static constexpr int SLICE = GR * GK;      // threads per slice of c
  static constexpr int SK = THREADS / SLICE; // slices of c, summed in smem
  static constexpr int DS = CP / SK;         // channels per slice
  static constexpr int GD = CP / MD;         // channel groups in p.v
  static constexpr int E = TQ * TK / THREADS;  // softmax entries per thread
  static constexpr int LPR = TK / E;         // softmax lanes per row
  static constexpr int LDQ = CP + 4;         // Q and K rows, padded
  static constexpr int LDS = TK + 4;         // logits rows
  static constexpr int LDP = TQ + 4;         // transposed probabilities
  static constexpr size_t smem_bytes =
      sizeof(float) * (TQ * LDQ + TK * LDQ + TK * CP + SK * TQ * LDS + TK * LDP +
                       2 * TQ);
  static_assert(SLICE * SK == THREADS && DS % 4 == 0, "q.k thread layout");
  static_assert((TQ / MR2) * GD == THREADS && MD % 4 == 0, "p.v thread layout");
  static_assert(MR2 == 2 || MR2 == 4, "p.v reads MR2 probabilities at once");
  static_assert(E * THREADS == TQ * TK && LPR <= 32 && 32 % LPR == 0 && E <= 32,
                "softmax layout");
};

template <class C>
__global__ void __launch_bounds__(THREADS)
    banded_flash_kernel(const Params p) {
  constexpr int CP = C::CP, TQ = C::TQ, TK = C::TK, MR = C::MR, MK = C::MK;
  constexpr int MR2 = C::MR2, MD = C::MD, GR = C::GR, GK = C::GK;
  constexpr int SLICE = C::SLICE, SK = C::SK, DS = C::DS, GD = C::GD;
  constexpr int E = C::E, LPR = C::LPR;
  constexpr int LDQ = C::LDQ, LDS = C::LDS, LDP = C::LDP;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [TQ][LDQ]
  float* Ks = Qs + TQ * LDQ;                    // [TK][LDQ]
  float* Vs = Ks + TK * LDQ;                    // [TK][CP]
  float* Ss = Vs + TK * CP;                     // [SK][TQ][LDS] partial logits
  float* Pt = Ss + SK * TQ * LDS;               // [TK][LDP] probabilities, transposed
  float* s_alpha = Pt + TK * LDP;               // [TQ] rescale of each row
  float* s_l = s_alpha + TQ;                    // [TQ] final softmax sums

  const int tid = threadIdx.x;
  const int q_tiles = (p.block + TQ - 1) / TQ;
  const int b = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * TQ;
  const int g = blockIdx.y;
  const long long base = (long long)blockIdx.z * p.n;  // this batch entry's rows
  const int key0 = b * p.block - p.w;  // key row of window slot 0

  copy_rows<CP, TQ>(Qs, LDQ, p, [&](int r) -> const float* {
    const int lr = q0 + r;
    const int row = b * p.block + lr;
    return lr < p.block && row < p.n ? p.q + ((base + row) * p.heads + g) * p.c
                                     : nullptr;
  });

  // q.k layout: slice `sl` of c, row group rg (rows rg + GR*i), key group kg
  // (keys kg + GK*j); kg is fastest, so K reads are conflict-free.
  const int sl = tid / SLICE;
  const int rg = (tid % SLICE) / GK;
  const int kg = tid % GK;
  // Softmax layout: row sr, keys sk0 .. sk0 + E - 1 (LPR lanes per row).
  const int sr = tid / LPR;
  const int sk0 = (tid % LPR) * E;
  const int s_lr = q0 + sr;  // row within the block
  const signed char* mask_row =
      p.masks + ((long long)b * p.block + s_lr) * p.width;
  // p.v layout: rows rg2 * MR2 .. + MR2 - 1, channels 4 dg + 4 GD jj + x.
  const int rg2 = tid / GD;
  const int dg = tid % GD;

  float m_i = SAFE, l_i = 0.f;  // online softmax state of row sr
  float o[MR2][MD];
#pragma unroll
  for (int i = 0; i < MR2; ++i)
#pragma unroll
    for (int j = 0; j < MD; ++j) o[i][j] = 0.f;

  for (int k0 = 0; k0 < p.width; k0 += TK) {
    // This thread's mask bytes; a key tile without an edge is skipped.
    unsigned edges = 0;
    if (s_lr < p.block) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int u = k0 + sk0 + e;
        if (u < p.width && mask_row[u] != 0) edges |= 1u << e;
      }
    }
    if (!__syncthreads_or(edges != 0)) continue;

    auto key_row = [&](const float* t, int r) -> const float* {
      const int u = k0 + r;
      const int s = key0 + u;
      return u < p.width && s >= 0 && s < p.n
                 ? t + ((base + s) * p.heads + g) * p.c
                 : nullptr;
    };
    copy_rows<CP, TK>(Ks, LDQ, p, [&](int r) { return key_row(p.k, r); });
    copy_rows<CP, TK>(Vs, CP, p, [&](int r) { return key_row(p.v, r); });
    cp_async_wait_all();

    // Partial logits over this thread's slice of c.
    {
      float acc[MR][MK];
#pragma unroll
      for (int i = 0; i < MR; ++i)
#pragma unroll
        for (int j = 0; j < MK; ++j) acc[i][j] = 0.f;
      const float* q_s = Qs + rg * LDQ + sl * DS;
      const float* k_s = Ks + kg * LDQ + sl * DS;
#pragma unroll 2
      for (int d = 0; d < DS; d += 4) {
        float4 kv[MK];
#pragma unroll
        for (int j = 0; j < MK; ++j)
          kv[j] = *reinterpret_cast<const float4*>(k_s + GK * j * LDQ + d);
#pragma unroll
        for (int i = 0; i < MR; ++i) {
          const float4 qa = *reinterpret_cast<const float4*>(q_s + GR * i * LDQ + d);
#pragma unroll
          for (int j = 0; j < MK; ++j) acc[i][j] = dot4(qa, kv[j], acc[i][j]);
        }
      }
      float* s_s = Ss + sl * TQ * LDS + rg * LDS + kg;
#pragma unroll
      for (int i = 0; i < MR; ++i)
#pragma unroll
        for (int j = 0; j < MK; ++j) s_s[GR * i * LDS + GK * j] = acc[i][j];
    }
    __syncthreads();

    // Online softmax of row sr over this tile; probabilities go to Pt.
    {
      float s[E];
      float mx = SAFE;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float dot = 0.f;
#pragma unroll
        for (int t = 0; t < SK; ++t) dot += Ss[t * TQ * LDS + sr * LDS + sk0 + e];
        s[e] = dot * p.scale + ((edges >> e) & 1u ? 0.f : NEG);
        mx = fmaxf(mx, s[e]);
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i, mx);
      const float alpha = expf(m_i - m_new);
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float pr = expf(s[e] - m_new);
        Pt[(sk0 + e) * LDP + sr] = pr;
        sum += pr;
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_i = alpha * l_i + sum;
      m_i = m_new;
      if (tid % LPR == 0) s_alpha[sr] = alpha;
    }
    __syncthreads();

    // o = alpha o + P V for this thread's rows and channels.
    {
#pragma unroll
      for (int i = 0; i < MR2; ++i) {
        const float a = s_alpha[rg2 * MR2 + i];
#pragma unroll
        for (int j = 0; j < MD; ++j) o[i][j] *= a;
      }
#pragma unroll 4
      for (int kk = 0; kk < TK; ++kk) {
        float pr[MR2];
        if constexpr (MR2 == 4) {
          const float4 x = *reinterpret_cast<const float4*>(Pt + kk * LDP + rg2 * 4);
          pr[0] = x.x;
          pr[1] = x.y;
          pr[2] = x.z;
          pr[3] = x.w;
        } else {
          const float2 x = *reinterpret_cast<const float2*>(Pt + kk * LDP + rg2 * 2);
          pr[0] = x.x;
          pr[1] = x.y;
        }
        const float* v_row = Vs + kk * CP + 4 * dg;
#pragma unroll
        for (int jj = 0; jj < MD / 4; ++jj) {
          const float4 vv = *reinterpret_cast<const float4*>(v_row + 4 * GD * jj);
#pragma unroll
          for (int i = 0; i < MR2; ++i)
#pragma unroll
            for (int x = 0; x < 4; ++x)
              o[i][4 * jj + x] = fmaf(pr[i], get(vv, x), o[i][4 * jj + x]);
        }
      }
    }
    // The next tile's copies come after its __syncthreads_or: no thread
    // overwrites Ks, Vs or Pt while another still reads them.
  }

  asm volatile("cp.async.wait_all;\n" ::);  // Q, when every tile was skipped
  if (tid % LPR == 0) s_l[sr] = l_i;
  if (p.lse != nullptr && tid % LPR == 0 && s_lr < p.block) {
    const long long n_pad = (long long)p.n_blocks * p.block;
    p.lse[((blockIdx.z * n_pad) + b * p.block + s_lr) * p.heads + g] =
        m_i + logf(fmaxf(l_i, 1e-30f));
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < MR2; ++i) {
    const int r = rg2 * MR2 + i;
    const int lr = q0 + r;
    const int row = b * p.block + lr;
    if (lr >= p.block || row >= p.n) continue;
    const float l = fmaxf(s_l[r], 1e-30f);
    float* dst = p.out + ((base + row) * p.heads + g) * p.c;
#pragma unroll
    for (int jj = 0; jj < MD / 4; ++jj) {
      const int d = 4 * dg + 4 * GD * jj;
      if (p.vec4 && d < p.c) {
        *reinterpret_cast<float4*>(dst + d) =
            make_float4(o[i][4 * jj] / l, o[i][4 * jj + 1] / l,
                        o[i][4 * jj + 2] / l, o[i][4 * jj + 3] / l);
      } else {
#pragma unroll
        for (int x = 0; x < 4; ++x)
          if (d + x < p.c) dst[d + x] = o[i][4 * jj + x] / l;
      }
    }
  }
}

template <class C>
int launch(const Params& p, int batch, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(banded_flash_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.n_blocks * ((p.block + C::TQ - 1) / C::TQ), p.heads, batch);
  banded_flash_kernel<C><<<grid, THREADS, C::smem_bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

//                        CP   TQ  TK  MR  MK  MR2  MD
using Narrow = Cfg<32, 64, 64, 4, 4, 2, 4>;
using Mid = Cfg<128, 64, 64, 8, 4, 4, 8>;
using Wide = Cfg<512, 32, 32, 4, 4, 4, 16>;

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing; returns a cudaError_t (0 on success), or
// cudaErrorInvalidValue for c > 512. `lse` may be null (serving). The masks
// are [n_blocks, block, block + 2w] int8; the batch entries share them.
extern "C" int gwt_banded_flash_forward(const float* q, const float* k,
                                        const float* v, const signed char* masks,
                                        float* out, float* lse, int batch, int n,
                                        int heads, int c, int n_blocks, int block,
                                        int w, int vec4, float scale, void* stream) {
  const Params p{q, k, v, masks, out, lse, n, heads, c, n_blocks, block, w,
                 block + 2 * w, vec4, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c <= 32) return launch<Narrow>(p, batch, s);
  if (c <= 128) return launch<Mid>(p, batch, s);
  if (c <= 512) return launch<Wide>(p, batch, s);
  return (int)cudaErrorInvalidValue;
}
