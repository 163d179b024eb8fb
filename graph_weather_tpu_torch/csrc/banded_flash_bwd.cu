// Banded flash attention backward for Hopper (sm_90a), on the tensor cores:
// split-TF32 products for f32 inputs, bf16 products for bf16 inputs.
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
// rows get exact-zero gradients; a skipped warp tile adds nothing.
//
// Three roles share one tile loop. A CTA owns TA = 16 RG rows of block b
// and streams TB rows at a time, and for each (own, streamed) pair computes
// x = a1 . b1 and y = a2 . b2, then p and ds, then acc1 += ds b1 (and
// acc2 += p b2):
//
//   DQ       own: receiver rows of block b (q, dO, lse, delta); streamed:
//            the block's window, key rows b * block - w + j (k, v); the
//            pair's mask byte is masks[b, own, j]. acc1 = dq.
//   DKV_SYM  own: key rows of block b (k, v); streamed: the same window,
//            now as receiver rows (q, dO, lse, delta). For a symmetric edge
//            set the receivers that attend key b * block + o are exactly
//            the senders of receiver b * block + o, all inside its window,
//            so masks[b, o, j] is also the bit of (key o, receiver j): the
//            same tiles and bits as DQ. acc1 = dk, acc2 = dv.
//   DKV_GEN  the same own rows for any edge set: streamed are the receiver
//            rows of every block whose window holds one of block b's keys;
//            the bit of (key s, receiver r) of block rb is masks[rb, r - rb
//            block, s - rb block + w], read once per CTA across the mask's
//            grain. No model path launches it (the k-hop graph is
//            symmetric).
//
// Each output row is written once by the CTA that owns it: two launches per
// backward (dq, dk/dv), no atomics, no sums across CTAs, deterministic.
//
// What bounds it on an H100. Per (row, slot) pair the DQ role does 3 and the
// dk/dv roles 4 products of length c: 14 c flops per pair that the design
// computes, against 6 c (dq) and 8 c (dk/dv) per real edge and head, and
// ~180 MB of rows and masks per c = 128 layer at splits 5 (bytes bound
// it: 0.7-0.8 ms per step's worth of launches). The band is sparse: at
// splits 5 only 38% of its pairs lie in 16 x 16 tiles that hold an edge, so
// the design skips the others per warp. It is K3's (clustered_tile.cuh):
// every product is three TF32 mma.sync m16n8k8 (split operands, f32 sums:
// f32 accuracy), a warp owns 16 own rows (CS warps share a row group where c
// is wide, their partial x and y summed through shared memory in one
// order), the edges of every 16 x 16 warp tile come from one scan of the
// mask into shared-memory bits (no mask byte is read inside the product
// loop), the CTA copies only the streamed tiles in which one of its warps
// has an edge, with cp.async into two stages, the next tile's issued before
// the current tile's products; the window's rows are contiguous, so a tile
// is a run of rows. Channels past c are zeros up to the tile's CP. Tiles
// follow c: CP = 32: 8 row groups of one warp, 32 streamed rows; CP = 128:
// 4 groups of 2 warps, 32 rows; CP = 256: 2 groups of 4 warps, 16 rows;
// CP = 512: one group of 8 warps, 16 rows (~218 KB of shared memory at
// splits 5). 256 threads, one CTA per SM.
//
// bf16 (the TPU kernels' bf16 mode), as K3b/K3c's (clustered_flash_bwd.cu):
// q, k, v and dO are staged as bf16 rows (c = 512: ~116 KB of shared
// memory), each product is one bf16 mma.sync m16n8k16 with f32
// accumulators, p and ds are computed in f32 and rounded to bf16 in
// registers before the column products (as the TPU kernels round them to
// the input dtype), each warp tile's column products still go to a fresh
// accumulator, lse and delta are read in f32, and dq, dk and dv are rounded
// to bf16 once, when written (dq and dk after the scale).
//
// Not yet here: one pass for dq and dk/dv (it would need sums across CTAs).

#include "clustered_tile.cuh"

namespace {

using namespace ctile;

enum Role { DQ = 0, DKV_SYM = 1, DKV_GEN = 2 };

template <class T>
struct Params {
  const T* q;          // [B, n, h, c]
  const T* k;
  const T* v;
  const T* dout;
  const float* lse;    // [B, n_pad, h]
  const float* delta;  // [B, n_pad, h], zero past n
  const signed char* masks;  // [n_blocks, block, width]
  T* dq;  // [B, n, h, c]
  T* dk;
  T* dv;
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

// T: element of q, k, v, dO and the gradients; CP: widest c of the tiles (a
// multiple of 8); RG row groups of CS warps; TB streamed rows per copied
// tile.
template <class T_, int CP_, int RG_, int CS_, int TB_>
struct Cfg {
  using T = T_;
  static constexpr int CP = CP_, RG = RG_, CS = CS_, TB = TB_;
  static constexpr int THREADS = 32 * RG * CS;
  static constexpr int TA = 16 * RG;   // own rows per CTA
  static constexpr int CSW = CP / CS;  // channels per warp of a row group
  static constexpr int NS = TB / SUB;  // 16-row warp tiles per streamed tile
  static constexpr int NN = CSW / 8;   // 8-channel tiles of a warp's outputs
  static constexpr int LD = CP + row_pad<T>();  // rows in shared memory
  static constexpr int STAGE = 2 * TB * LD;  // elements per stage
  static constexpr size_t tile_bytes = sizeof(T) * (2 * TA * LD + STAGES * STAGE) +
                                       sizeof(float) * STAGES * 2 * TB +
                                       (CS > 1 ? sizeof(float4) * 2 * RG * CS * NS * 2 * 32 : 0);
  static_assert(THREADS == 256 && CSW % (sizeof(T) == 4 ? 8 : 16) == 0 && TB % SUB == 0 &&
                    NS <= 32,
                "tile layout");
};

// The general role's streamed receivers for key block b: the rows of blocks
// rb_lo .. rb_hi, those whose window [rb block - w, rb block + block + w)
// meets [b block, b block + block).
template <class T>
__host__ __device__ inline void general_range(const Params<T>& p, int b, int& str0, int& n_str) {
  const int lo = b * p.block - p.block - p.w;  // first block: rb * block > lo
  const int rb_lo = lo < 0 ? 0 : lo / p.block + 1;
  const int hi = (b + 1) * p.block + p.w - 1;  // last block: rb * block <= hi
  const int rb_hi = hi / p.block < p.n_blocks - 1 ? hi / p.block : p.n_blocks - 1;
  str0 = rb_lo * p.block;
  n_str = (rb_hi + 1) * p.block - str0;
}

// scan_edges (clustered_tile.cuh) for the general role: the bits of (own key
// a0 + 16 rg + r of block b, streamed receiver str0 + 16 s + c). A warp
// tile's 16 receivers share one block rb, and its keys' window slots
// b block - rb block + w + o are 16 consecutive bytes of each receiver's
// mask row, all inside the window or all outside (block and w are
// multiples of 256).
template <int RG, int THREADS, class T>
__device__ __forceinline__ void scan_general(unsigned char* flags, uint16_t* bits, const Params<T>& p,
                                             int b, int a0, int str0, int n_str) {
  const int n_sub = (n_str + SUB - 1) / SUB;
  for (int i = threadIdx.x; i < RG * n_sub; i += THREADS) {
    const int rg = i / n_sub;
    const int s = i - rg * n_sub;
    const int r0 = str0 + SUB * s;  // first receiver of the warp tile
    const int rb = r0 / p.block;
    const int j0 = (b - rb) * p.block + p.w + a0 + 16 * rg;  // slot of the first key
    uint32_t row[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) row[r] = 0;
    if (j0 >= 0 && j0 + 16 <= p.width) {
      const signed char* m = p.masks + (long long)r0 * p.width + j0;
      const bool aligned = ((reinterpret_cast<uintptr_t>(m) | p.width) & 15) == 0;
      for (int c = 0; c < SUB; ++c) {
        uint32_t col = 0;
        if (aligned) {
          const uint4 x = __ldg(reinterpret_cast<const uint4*>(m + (long long)c * p.width));
          col = nonzero_bytes(x.x) | nonzero_bytes(x.y) << 4 | nonzero_bytes(x.z) << 8 |
                nonzero_bytes(x.w) << 12;
        } else {
          for (int r = 0; r < 16; ++r) col |= (m[(long long)c * p.width + r] != 0 ? 1u : 0u) << r;
        }
#pragma unroll
        for (int r = 0; r < 16; ++r) row[r] |= ((col >> r) & 1u) << c;
      }
    }
    uint32_t any = 0;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      bits[i * 16 + r] = static_cast<uint16_t>(row[r]);
      any |= row[r];
    }
    flags[i] = any != 0;
  }
}

template <class C, int ROLE>
__global__ void __launch_bounds__(C::THREADS, 1)
    banded_flash_bwd_kernel(const Params<typename C::T> p) {
  using T = typename C::T;
  constexpr int RG = C::RG, CS = C::CS, TB = C::TB, TA = C::TA, CSW = C::CSW;
  constexpr int CP = C::CP, NS = C::NS, NN = C::NN, LD = C::LD, THREADS = C::THREADS;
  constexpr int STAGE = C::STAGE;
  constexpr bool DKV = ROLE != DQ;  // two accumulators
  constexpr int NN2 = DKV ? NN : 1;

  const int a_tiles = p.block / TA;
  const int b = blockIdx.x / a_tiles;
  const int a0 = (blockIdx.x % a_tiles) * TA;  // own rows a0 .. of block b
  const int g = blockIdx.y;
  const int bz = blockIdx.z;
  // Streamed index i is global row str0 + i (a zero row outside [0, n)).
  int str0 = b * p.block - p.w, n_str = p.width;
  if (ROLE == DKV_GEN) general_range(p, b, str0, n_str);
  const int n_tiles = (n_str + TB - 1) / TB;
  const int n_sub = (n_str + SUB - 1) / SUB;

  extern __shared__ float4 smem4[];
  T* A1 = reinterpret_cast<T*>(smem4);  // [TA][LD] own q or k
  T* A2 = A1 + TA * LD;                 // [TA][LD] own dO or v
  T* Bst = A2 + TA * LD;                // [STAGES][b1, b2][TB][LD]
  float* s_lse = reinterpret_cast<float*>(Bst + STAGES * STAGE);  // [STAGES][TB] streamed lse
  float* s_delta = s_lse + STAGES * TB;  // [STAGES][TB] streamed delta
  float4* xpart = reinterpret_cast<float4*>(s_delta + STAGES * TB);  // CS > 1
  float4* ypart = xpart + RG * CS * NS * 2 * 32;
  int* s_tiles = reinterpret_cast<int*>(reinterpret_cast<char*>(smem4) + C::tile_bytes);  // [n_tiles]
  int* s_count = s_tiles + n_tiles;                                   // [1]
  uint16_t* bits = reinterpret_cast<uint16_t*>(s_count + 1);          // [RG][n_sub][16]
  unsigned char* flags = reinterpret_cast<unsigned char*>(bits + RG * n_sub * 16);  // [RG][n_sub]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rg = warp / CS;
  const int cs = warp - rg * CS;
  const long long base = (long long)bz * p.n;  // this batch entry's rows
  const long long l_base = (long long)bz * p.n_blocks * p.block;

  if (ROLE == DKV_GEN) {
    scan_general<RG, THREADS>(flags, bits, p, b, a0, str0, n_str);
  } else {
    scan_edges<RG, THREADS>(flags, bits, p.masks + (long long)b * p.block * p.width, p.width, 1,
                            a0, p.block, p.width);
  }
  __syncthreads();
  list_tiles<RG, TB>(s_tiles, s_count, flags, n_str);
  __syncthreads();
  const int n_list = *s_count;

  // Global row `row` of a [B, n, h, c] tensor, or null outside [0, n).
  auto row_ptr = [&](const T* t, int row) -> const T* {
    return row >= 0 && row < p.n ? t + ((base + row) * p.heads + g) * p.c : nullptr;
  };
  const T* own1 = DKV ? p.k : p.q;
  const T* own2 = DKV ? p.v : p.dout;
  const T* str1 = DKV ? p.q : p.k;
  const T* str2 = DKV ? p.dout : p.v;
  const int own_row0 = b * p.block + a0;
  copy_rows<THREADS, CP>(A1, LD, TA, p.c, p.vec, p.q,
                         [&](int r) { return row_ptr(own1, own_row0 + r); });
  copy_rows<THREADS, CP>(A2, LD, TA, p.c, p.vec, p.q,
                         [&](int r) { return row_ptr(own2, own_row0 + r); });

  auto copy_tile = [&](int stage, int tile) {
    T* B1 = Bst + stage * STAGE;
    const int r0 = str0 + tile * TB;
    copy_rows<THREADS, CP>(B1, LD, TB, p.c, p.vec, p.q,
                           [&](int r) { return row_ptr(str1, r0 + r); });
    copy_rows<THREADS, CP>(B1 + TB * LD, LD, TB, p.c, p.vec, p.q,
                           [&](int r) { return row_ptr(str2, r0 + r); });
    if (DKV && tid < TB) {
      // Streamed receivers' lse and delta; 0 for rows that are not there
      // (their q and dO are zero rows: they add exact zeros).
      const int row = r0 + tid;
      const bool there = row >= 0 && row < p.n;
      const long long i = (l_base + row) * p.heads + g;
      s_lse[stage * TB + tid] = there ? p.lse[i] : 0.f;
      s_delta[stage * TB + tid] = there ? p.delta[i] : 0.f;
    }
  };
  // The first STAGES - 1 tiles' copies (with the own rows in the first
  // group); one group is committed per tile slot, empty or not, so that
  // waiting for all but the newest STAGES - 1 groups waits for the tile
  // about to be used.
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_list) copy_tile(t, s_tiles[t]);
    cp_async_commit();
  }

  // This thread's own rows (g, g + 8 of its row group), local to block b.
  const int o0 = a0 + 16 * rg + (lane >> 2);
  const int t4 = lane & 3;
  // The DQ role's own rows: their lse and delta (lse covers every row of
  // the padded blocks; delta is zero past n).
  float row_lse[2] = {0.f, 0.f}, row_delta[2] = {0.f, 0.f};
  if (!DKV) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long i = (l_base + b * p.block + o0 + 8 * h) * p.heads + g;
      row_lse[h] = p.lse[i];
      row_delta[h] = p.delta[i];
    }
  }
  const int c_begin = cs * CSW;
  const T* a1_rows = A1 + 16 * rg * LD;
  const T* a2_rows = A2 + 16 * rg * LD;

  float acc1[NN][4], acc2[NN2][4];
#pragma unroll
  for (int n = 0; n < NN; ++n) acc1[n][0] = acc1[n][1] = acc1[n][2] = acc1[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < NN2; ++n) acc2[n][0] = acc2[n][1] = acc2[n][2] = acc2[n][3] = 0.f;

  for (int i = 0; i < n_list; ++i) {
    const int tile = s_tiles[i];
    const int stage = i % STAGES;
    if (i + STAGES - 1 < n_list) copy_tile((i + STAGES - 1) % STAGES, s_tiles[i + STAGES - 1]);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    const T* B1 = Bst + stage * STAGE;
    const T* B2 = B1 + TB * LD;
    const unsigned act = active_bits<NS>(flags, rg, tile, n_str);
    const uint16_t* tile_bits = bits + (rg * n_sub + tile * NS) * 16;

    // x and y of this warp's active 16-row warp tiles (partial over c_begin's
    // slice where CS > 1, then summed across the row group).
    float x[NS][2][4], y[NS][2][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      if (!((act >> j) & 1u)) continue;
      row_products16<CSW / 8>(x[j], a1_rows, B1 + SUB * j * LD, LD, c_begin, lane);
      row_products16<CSW / 8>(y[j], a2_rows, B2 + SUB * j * LD, LD, c_begin, lane);
    }
    if constexpr (CS > 1) {
      sum_partials<NS, CS>(x, xpart, rg, cs, act, lane);
      sum_partials<NS, CS>(y, ypart, rg, cs, act, lane);
    }

#pragma unroll
    for (int j = 0; j < NS; ++j) {
      if (!((act >> j) & 1u)) continue;
      // p into y, ds into x, for this thread's pairs.
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int sl = SUB * j + 8 * h + 2 * t4 + (e & 1);  // streamed row within the tile
          const float lse = DKV ? s_lse[stage * TB + sl] : row_lse[e >> 1];
          const float delta = DKV ? s_delta[stage * TB + sl] : row_delta[e >> 1];
          const bool edge = edge_bit(tile_bits + 16 * j, h, e, lane);
          const float pr = exp_diff(x[j][h][e] * p.scale + (edge ? 0.f : NEG), lse);
          x[j][h][e] = pr * (y[j][h][e] - delta);
          y[j][h][e] = pr;
        }
      add_col_products<NN>(acc1, x[j], B1 + SUB * j * LD, LD, c_begin, lane);
      if constexpr (DKV)
        add_col_products<NN>(acc2, y[j], B2 + SUB * j * LD, LD, c_begin, lane);
    }
    __syncthreads();  // the stage is free for the copy two tiles on
  }
  cp_async_wait<0>();  // the own rows, when the list was empty

  // Outputs: dq and dk scaled, dv as summed.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = b * p.block + o0 + 8 * h;
    if (row >= p.n) continue;
    T* dst1 = (DKV ? p.dk : p.dq) + ((base + row) * p.heads + g) * p.c;
    T* dst2 = DKV ? p.dv + ((base + row) * p.heads + g) * p.c : nullptr;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const int d = c_begin + 8 * n + 2 * t4;
      if (d >= p.c) break;
      store2(dst1, d, p.c, p.vec, acc1[n][2 * h] * p.scale, acc1[n][2 * h + 1] * p.scale);
      if constexpr (DKV) store2(dst2, d, p.c, p.vec, acc2[n][2 * h], acc2[n][2 * h + 1]);
    }
  }
}

template <class C, int ROLE>
int launch(const Params<typename C::T>& p, int batch, cudaStream_t stream) {
  int n_str = p.width;  // the most streamed rows of any CTA
  if (ROLE == DKV_GEN) {
    n_str = 0;
    for (int b = 0; b < p.n_blocks; ++b) {
      int str0, n;
      general_range(p, b, str0, n);
      n_str = n > n_str ? n : n_str;
    }
  }
  const int n_tiles = (n_str + C::TB - 1) / C::TB;
  const size_t n_sub = (n_str + SUB - 1) / SUB;  // bits and flags per row group
  const size_t smem = C::tile_bytes + sizeof(int) * ((size_t)n_tiles + 1) +
                      C::RG * n_sub * (16 * sizeof(uint16_t) + 1);
  cudaError_t err = cudaFuncSetAttribute(banded_flash_bwd_kernel<C, ROLE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.n_blocks * (p.block / C::TA), p.heads, batch);
  banded_flash_bwd_kernel<C, ROLE><<<grid, C::THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// mode 0: the dq kernel; 1: the dk/dv kernel, in the symmetric role when
// `symmetric`, else the general one.
template <class C>
int run(const Params<typename C::T>& p, int mode, int symmetric, int batch, cudaStream_t stream) {
  if (mode == 0) return launch<C, DQ>(p, batch, stream);
  if (mode == 1) return symmetric ? launch<C, DKV_SYM>(p, batch, stream)
                                  : launch<C, DKV_GEN>(p, batch, stream);
  return (int)cudaErrorInvalidValue;
}

// The tiles of each width, for element T:
//                      CP  RG  CS  TB
template <class T> using W32 = Cfg<T, 32, 8, 1, 32>;
template <class T> using W128 = Cfg<T, 128, 4, 2, 32>;
template <class T> using W256 = Cfg<T, 256, 2, 4, 16>;
template <class T> using W512 = Cfg<T, 512, 1, 8, 16>;

template <class T>
int backward(const void* q, const void* k, const void* v, const void* dout, const float* lse,
             const float* delta, const signed char* masks, void* dq, void* dk, void* dv, int batch,
             int n, int heads, int c, int n_blocks, int block, int w, int vec, float scale, int mode,
             int symmetric, cudaStream_t s) {
  const Params<T> p{static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                    static_cast<const T*>(dout), lse, delta, masks, static_cast<T*>(dq),
                    static_cast<T*>(dk), static_cast<T*>(dv), n, heads, c, n_blocks, block, w,
                    block + 2 * w, vec, scale};
  if (c <= 32) return run<W32<T>>(p, mode, symmetric, batch, s);
  if (c <= 128) return run<W128<T>>(p, mode, symmetric, batch, s);
  if (c <= 256) return run<W256<T>>(p, mode, symmetric, batch, s);
  if (c <= 512) return run<W512<T>>(p, mode, symmetric, batch, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (bound with ctypes). q, k, v, dout, dq, dk and dv are
// f32 (is_bf16 == 0) or bf16 (is_bf16 == 1); lse and delta are f32.
// Launches on `stream`, does not synchronise, allocates nothing; returns a
// cudaError_t (0 on success), or cudaErrorInvalidValue for c > 512, an
// unknown mode or a block that is not a multiple of 128. Pointers a mode
// does not write may be null. The masks are [n_blocks, block, block + 2w]
// int8 (block a multiple of 512 and w of 256, as the host checks); the
// batch entries share them. `symmetric`: the edge set is symmetric (the
// dk/dv kernel then reads the masks as dq does).
extern "C" int gwt_banded_flash_backward(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const signed char* masks, void* dq,
    void* dk, void* dv, int batch, int n, int heads, int c, int n_blocks,
    int block, int w, int vec, float scale, int mode, int symmetric, int is_bf16,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block % 128 != 0) return (int)cudaErrorInvalidValue;
  return is_bf16 ? backward<ctile::bf16>(q, k, v, dout, lse, delta, masks, dq, dk, dv, batch, n,
                                         heads, c, n_blocks, block, w, vec, scale, mode, symmetric,
                                         s)
                 : backward<float>(q, k, v, dout, lse, delta, masks, dq, dk, dv, batch, n, heads,
                                   c, n_blocks, block, w, vec, scale, mode, symmetric, s);
}
