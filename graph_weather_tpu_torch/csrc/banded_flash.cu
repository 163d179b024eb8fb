// Banded flash attention forward for Hopper (sm_90a), on the tensor cores:
// split-TF32 products for f32 inputs, bf16 products for bf16 inputs.
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
// row with no neighbour (and a padded row past n) comes out exactly 0, its
// lse exactly -1e28 + log(1e-30). q, k, v and out are [B, n, h, c], f32 or
// bf16 (one kernel body, instantiated per element type). When
// the caller asks for it (training), the kernel also writes the
// log-sum-exp m + log(max(l, 1e-30)) of every row of every block, f32
// [B, nb * block, h], which the backward (banded_flash_bwd.cu) reads.
//
// What bounds it on an H100. The edges of GenCast's splits-5 k-hop graph
// fill 2.23% of its [21, 512, 2560] band: the work these inputs need moves
// the q, k, v and out rows and the 27.5 MB mask (bytes, ~35 us per c = 128
// call). But a kernel computes every pair of a tile that holds an edge, 4 c
// flops each: 47.8% of the band's pairs lie in 64 x 64 tiles with an edge,
// 44.2% in 32 x 32, 38.3% in 16 x 16, 34.3% in 16 x 8 and 27.7% in 8 x 8.
// The design before this one computed 64 x 64 tiles in FP32 on the CUDA
// cores, 26.9 GFLOP per c = 128 launch at 22.6 TFLOP/s (1.19 ms). This one
// is K3a's (clustered_flash.cu) with the band's contiguous window in place
// of the gathered union, the forward that K4b's DQ role already implies,
// on clustered_tile.cuh:
//
//   * every q . k and p . v product is three TF32 mma.sync m16n8k8
//     (big/small split by integer rounding, f32 sums: f32 accuracy);
//   * a warp owns 16 receiver rows of block b; where c > 128, CS warps share
//     a row group, each over c / CS channels, their partial logits summed
//     through shared memory in one order, so every warp of the group runs
//     the same online softmax; a CTA holds 16 RG rows, 256 threads;
//   * before any copy, one scan of the CTA's mask bytes marks, per row group,
//     the 16-key warp tiles that hold an edge (38.3% of the pairs at splits
//     5); a warp skips the others, and the CTA copies only the TK-key tiles
//     where some warp has an edge. Inside a warp tile there is no branch;
//   * the window's rows are contiguous, so a streamed tile is a run of key
//     rows, copied with cp.async into two stages: the next tile's copies are
//     issued before the current tile's products;
//   * the softmax is online over the tiles, in f32, on the accumulators'
//     registers, with exp2 of x - m; a skipped warp tile leaves its state as
//     it was. Each warp tile's p . v products go to a fresh accumulator,
//     added to the row's output in f32: the tensor cores' accumulation
//     truncates, and the band's clamped end rows (keys 0 and n - 1, in
//     hundreds of windows) would sum that bias past 1e-4 (K4b's finding).
//
// Tiles follow c: CP = 32 and 128 take 8 row groups (TQ = 128) of one warp
// each; CP = 256 4 row groups of 2 warps, CP = 512 2 row groups of 4 warps.
// The batch is the grid's z axis; every batch entry reads the same mask.
// On an H100 at 700 W this takes 0.83-0.84 ms per c = 128 launch at splits 5
// (21.6 GFLOP on the computed pairs: 26 TFLOP/s of f32 products); skipping
// 16 x 8 halves too (a branch per half) took 1.30, and K4b's c = 128 tile
// (4 row groups of 2 warps) 0.85 (PERF.md §6, scripts/k4a_k5b_variants.py).
//
// bf16 (GenCast's compute policy; the TPU kernel's bf16 mode), as K3a's
// (clustered_flash.cu): the tiles hold bf16 rows (c = 512: ~107 KB of
// shared memory where f32 takes ~206 KB), each product is one bf16 mma.sync
// m16n8k16 with f32 accumulators where f32 takes three TF32 ones, p is
// rounded to bf16 in registers before the P.V product (the TPU kernel rounds
// it to the value dtype; here against the running max of this walk's
// 16-key warp tiles, there of its 512-key tiles), V's B fragments come from
// ldmatrix.trans, each warp tile's P.V still goes to a fresh accumulator,
// and out is rounded to bf16 once; the scan, the copy plan, the softmax, m,
// l and lse are f32's.
//
// Not yet here: warps that do not wait for each other at every tile, wgmma.

#include "clustered_tile.cuh"

namespace {

using namespace ctile;

template <class T>
struct Params {
  const T* q;
  const T* k;
  const T* v;
  const signed char* masks;  // [n_blocks, block, width]
  T* out;
  float* lse;  // [B, n_blocks * block, h], or null: not written
  int n;
  int heads;
  int c;
  int n_blocks;
  int block;
  int w;
  int width;  // block + 2 w
  int vec;    // c a multiple of 16 bytes' elements, every row 16-byte aligned
  float scale;
};

// T: element of q, k, v and out; CP: widest c of the tiles (a multiple of
// 8); RG row groups of CS warps; TK keys per copied tile.
template <class T_, int CP_, int RG_, int CS_, int TK_>
struct Cfg {
  using T = T_;
  static constexpr int CP = CP_, RG = RG_, CS = CS_, TK = TK_;
  static constexpr int THREADS = 32 * RG * CS;
  static constexpr int TQ = 16 * RG;   // rows per CTA
  static constexpr int CSW = CP / CS;  // channels per warp of a row group
  static constexpr int NS = TK / SUB;  // 16-key warp tiles per copied tile
  static constexpr int NN = CSW / 8;   // 8-channel tiles of a warp's output
  static constexpr int LD = CP + row_pad<T>();  // Q, K and V rows in shared memory
  static constexpr int STAGE = 2 * TK * LD;  // elements per stage
  static constexpr size_t tile_bytes = sizeof(T) * (TQ * LD + STAGES * STAGE) +
                                       (CS > 1 ? sizeof(float4) * RG * CS * NS * 2 * 32 : 0);
  static_assert(THREADS == 256 && CSW % (sizeof(T) == 4 ? 8 : 16) == 0 && TK % SUB == 0 &&
                    NS <= 32,
                "tile layout");
};

template <class C>
__global__ void __launch_bounds__(C::THREADS, 1)
    banded_flash_kernel(const Params<typename C::T> p) {
  using T = typename C::T;
  constexpr int RG = C::RG, CS = C::CS, TK = C::TK, TQ = C::TQ, CSW = C::CSW;
  constexpr int CP = C::CP, NS = C::NS, NN = C::NN, LD = C::LD, THREADS = C::THREADS;
  constexpr int STAGE = C::STAGE;
  const int n_tiles = (p.width + TK - 1) / TK;
  const int n_sub = (p.width + SUB - 1) / SUB;

  extern __shared__ float4 smem4[];
  T* Qs = reinterpret_cast<T*>(smem4);  // [TQ][LD]
  T* KV = Qs + TQ * LD;                 // [STAGES][K, V][TK][LD]
  float4* part = reinterpret_cast<float4*>(KV + STAGES * STAGE);  // CS > 1
  int* s_tiles = reinterpret_cast<int*>(reinterpret_cast<char*>(smem4) + C::tile_bytes);  // [n_tiles]
  int* s_count = s_tiles + n_tiles;                                       // [1]
  uint16_t* bits = reinterpret_cast<uint16_t*>(s_count + 1);              // [RG][n_sub][16]
  unsigned char* flags = reinterpret_cast<unsigned char*>(bits + RG * n_sub * 16);  // [RG][n_sub]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rg = warp / CS;
  const int cs = warp - rg * CS;
  const int q_tiles = p.block / TQ;
  const int b = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * TQ;  // rows q0 .. of block b
  const int g = blockIdx.y;
  const long long base = (long long)blockIdx.z * p.n;  // this batch entry's rows
  const int key0 = b * p.block - p.w;                  // key row of window slot 0

  scan_edges<RG, THREADS>(flags, bits, p.masks + (long long)b * p.block * p.width, p.width, 1,
                          q0, p.block, p.width);
  __syncthreads();
  list_tiles<RG, TK>(s_tiles, s_count, flags, p.width);
  __syncthreads();
  const int n_list = *s_count;

  // Global row `row` of a [B, n, h, c] tensor, or null outside [0, n).
  auto row_ptr = [&](const T* t, int row) -> const T* {
    return row >= 0 && row < p.n ? t + ((base + row) * p.heads + g) * p.c : nullptr;
  };
  copy_rows<THREADS, CP>(Qs, LD, TQ, p.c, p.vec, p.q,
                         [&](int r) { return row_ptr(p.q, b * p.block + q0 + r); });
  auto copy_tile = [&](int stage, int tile) {
    T* Ks = KV + stage * STAGE;
    const int r0 = key0 + tile * TK;
    copy_rows<THREADS, CP>(Ks, LD, TK, p.c, p.vec, p.q,
                           [&](int r) { return tile * TK + r < p.width ? row_ptr(p.k, r0 + r) : nullptr; });
    copy_rows<THREADS, CP>(Ks + TK * LD, LD, TK, p.c, p.vec, p.q,
                           [&](int r) { return tile * TK + r < p.width ? row_ptr(p.v, r0 + r) : nullptr; });
  };
  // The first STAGES - 1 tiles' copies (with Q in the first group); one
  // group is committed per tile slot, empty or not, so that waiting for all
  // but the newest STAGES - 1 groups waits for the tile about to be used.
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_list) copy_tile(t, s_tiles[t]);
    cp_async_commit();
  }

  const int lr0 = q0 + 16 * rg + (lane >> 2);  // this thread's rows: lr0, lr0 + 8
  const int c_begin = cs * CSW;
  const T* q_rows = Qs + 16 * rg * LD;

  float m_i[2] = {SAFE, SAFE}, l_i[2] = {0.f, 0.f};  // l: this thread's share
  float o[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int i = 0; i < n_list; ++i) {
    const int tile = s_tiles[i];
    if (i + STAGES - 1 < n_list) copy_tile((i + STAGES - 1) % STAGES, s_tiles[i + STAGES - 1]);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    const T* Ks = KV + (i % STAGES) * STAGE;
    const T* Vs = Ks + TK * LD;
    const unsigned act = active_bits<NS>(flags, rg, tile, p.width);
    const uint16_t* tile_bits = bits + (rg * n_sub + tile * NS) * 16;

    // Logits of this warp's active 16-key warp tiles (partial over c_begin's
    // slice where CS > 1, then summed across the row group).
    float s[NS][2][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
      if ((act >> j) & 1u)
        row_products16<CSW / 8>(s[j], q_rows, Ks + SUB * j * LD, LD, c_begin, lane);
    if constexpr (CS > 1) sum_partials<NS, CS>(s, part, rg, cs, act, lane);

    if (act) {
      // Online softmax of rows g, g + 8 over this tile's active warp tiles.
      float mx[2] = {SAFE, SAFE};
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        if (!((act >> j) & 1u)) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][h][e] = s[j][h][e] * p.scale +
                         (edge_bit(tile_bits + 16 * j, h, e, lane) ? 0.f : NEG);
            mx[e >> 1] = fmaxf(mx[e >> 1], s[j][h][e]);
          }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_i[r], mx[r]);
        alpha[r] = exp_diff(m_i[r], m_new);
        m_i[r] = m_new;
        l_i[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        if (!((act >> j) & 1u)) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][h][e] = exp_diff(s[j][h][e], m_i[e >> 1]);
            l_i[e >> 1] += s[j][h][e];
          }
      }
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {  // a max moved
#pragma unroll
        for (int n = 0; n < NN; ++n) {
          o[n][0] *= alpha[0];
          o[n][1] *= alpha[0];
          o[n][2] *= alpha[1];
          o[n][3] *= alpha[1];
        }
      }
#pragma unroll
      for (int j = 0; j < NS; ++j)
        if ((act >> j) & 1u)
          add_col_products<NN>(o, s[j], Vs + SUB * j * LD, LD, c_begin, lane);
    }
    __syncthreads();  // the stage is free for the copy two tiles on
  }
  cp_async_wait<0>();  // Q, when the list was empty

  float l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = l_i[h] + __shfl_xor_sync(0xffffffffu, l_i[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  const int t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int lr = lr0 + 8 * h;
    if (p.lse != nullptr && cs == 0 && t == 0) {
      const long long n_pad = (long long)p.n_blocks * p.block;
      p.lse[((blockIdx.z * n_pad) + b * p.block + lr) * p.heads + g] =
          m_i[h] + logf(fmaxf(l[h], 1e-30f));
    }
    const int row = b * p.block + lr;
    if (row >= p.n) continue;
    const float l_safe = fmaxf(l[h], 1e-30f);
    T* dst = p.out + ((base + row) * p.heads + g) * p.c;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const int d = c_begin + 8 * n + 2 * t;
      if (d >= p.c) break;
      store2(dst, d, p.c, p.vec, o[n][2 * h] / l_safe, o[n][2 * h + 1] / l_safe);
    }
  }
}

template <class C>
int launch(const Params<typename C::T>& p, int batch, cudaStream_t stream) {
  const int n_tiles = (p.width + C::TK - 1) / C::TK;
  const size_t n_sub = (p.width + SUB - 1) / SUB;  // bits and flags per row group
  const size_t smem = C::tile_bytes + sizeof(int) * ((size_t)n_tiles + 1) +
                      C::RG * n_sub * (16 * sizeof(uint16_t) + 1);
  cudaError_t err = cudaFuncSetAttribute(banded_flash_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.n_blocks * (p.block / C::TQ), p.heads, batch);
  banded_flash_kernel<C><<<grid, C::THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The tiles of each width, for element T:
//                      CP  RG  CS  TK
template <class T> using W32 = Cfg<T, 32, 8, 1, 64>;
template <class T> using W128 = Cfg<T, 128, 8, 1, 32>;
template <class T> using W256 = Cfg<T, 256, 4, 2, 16>;
template <class T> using W512 = Cfg<T, 512, 2, 4, 16>;

template <class T>
int forward(const void* q, const void* k, const void* v, const signed char* masks, void* out,
            float* lse, int batch, int n, int heads, int c, int n_blocks, int block, int w, int vec,
            float scale, cudaStream_t s) {
  const Params<T> p{static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                    masks, static_cast<T*>(out), lse, n, heads, c, n_blocks, block, w,
                    block + 2 * w, vec, scale};
  if (c <= 32) return launch<W32<T>>(p, batch, s);
  if (c <= 128) return launch<W128<T>>(p, batch, s);
  if (c <= 256) return launch<W256<T>>(p, batch, s);
  if (c <= 512) return launch<W512<T>>(p, batch, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (bound with ctypes). q, k, v and out are f32
// (is_bf16 == 0) or bf16 (is_bf16 == 1); lse is f32. Launches on `stream`,
// does not synchronise, allocates nothing; returns a cudaError_t (0 on
// success), or cudaErrorInvalidValue for c > 512 or a block that is not a
// multiple of 128. `lse` may be null (serving). The masks are [n_blocks,
// block, block + 2w] int8 (block a multiple of 512 and w of 256, as the
// host checks); the batch entries share them.
extern "C" int gwt_banded_flash_forward(const void* q, const void* k, const void* v,
                                        const signed char* masks, void* out, float* lse,
                                        int batch, int n, int heads, int c, int n_blocks,
                                        int block, int w, int vec, float scale, int is_bf16,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block % 128 != 0) return (int)cudaErrorInvalidValue;
  return is_bf16 ? forward<ctile::bf16>(q, k, v, masks, out, lse, batch, n, heads, c, n_blocks,
                                        block, w, vec, scale, s)
                 : forward<float>(q, k, v, masks, out, lse, batch, n, heads, c, n_blocks, block, w,
                                  vec, scale, s);
}
