// Clustered (gathered-neighbour) flash attention backward for Hopper
// (sm_90a), on the tensor cores: split-TF32 products for f32 inputs, bf16
// products for bf16 inputs.
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
// and padding slots (row 0, all-zero mask column) get exact-zero gradients;
// a skipped warp tile adds nothing.
//
// Three roles share one tile loop. A CTA owns TA = 16 RG rows and streams TB
// rows at a time, and for each (own, streamed) pair computes x = a1 . b1 and
// y = a2 . b2, then p and ds, then acc1 += ds b1 (and acc2 += p b2):
//
//   DQ            own: receiver rows of block b (q, dO, lse, delta);
//                 streamed: its union's key slots (k, v gathered by id).
//                 acc1 = dq. Used by both backwards.
//   DKV_GATHERED  own: union slots of block b (k, v gathered by id);
//                 streamed: the block's receiver rows (q, dO, lse, delta).
//                 acc1 = dk, acc2 = dv, written block-local
//                 [B, nb, U_pad, h, c]; the caller sums them to global rows.
//   DKV_OWN       own: rows of key block b (k, v); streamed: its union
//                 (q, dO, lse, delta gathered by id). For a symmetric edge
//                 set the receivers that attend block b's keys are exactly
//                 block b's union, and masks[b] read as [keys, receivers] is
//                 the adjacency: dk, dv land straight on their global rows.
//
// The general backward (K3b) launches DQ and DKV_GATHERED; the symmetric one
// (K3c) launches DQ and DKV_OWN, one launch each: fusing them would need sums
// across CTAs, which would not be deterministic.
//
// What bounds it on an H100. Per (row, slot) pair the DQ role does 3 and the
// dk/dv roles 4 products of length c: 7 * 2c flops per pair that the design
// computes, against 1.3 GFLOP per c = 128 layer on the real edges. Every
// product runs on the tensor cores as three TF32 mma.sync
// (clustered_tile.cuh); as in the forward, the fragment loads and splits,
// the elementwise work between the products and the waits at each tile's
// __syncthreads hold the mma pipes well below their peak. The design is the
// forward's: a warp owns 16 own rows (CS warps share a row group where c is
// wide, their partial x and y summed through shared memory in one order),
// skips the 16-row streamed warp tiles that hold none of its edges (from
// one scan of the mask bytes) and runs the others without a branch, the CTA
// copies only the streamed tiles with an edge, gathering the rows itself
// with cp.async into two stages, the next tile's issued before the current
// tile's products, and channels past c are zeros up to the tile's CP.
// Tiles follow c: CP = 32: 8 row groups of one warp, 32 streamed rows;
// CP = 128: 4 row groups of 2 warps, 32 rows; CP = 256: 2 groups of 4 warps,
// 16 rows; CP = 512: one group of 8 warps, 16 rows; CP = 768 (K3c only):
// one group of 8 warps, 16 rows, one copy stage in f32. 256 threads.
//
// bf16 (the TPU kernels' bf16 mode): q, k, v and dO are staged as bf16 rows,
// each product is one bf16 mma.sync m16n8k16 with f32 accumulators, p and
// ds are computed in f32 and rounded to bf16 in registers before the column
// products (as the TPU kernels round them to the input dtype), lse and delta
// are read in f32, and dq, dk and dv are rounded to bf16 once, when written
// (K3b's block-local dk/dv too; the caller sums those in f32).
//
// Not yet here: one pass for dq and dk/dv (it would need sums across CTAs,
// or recomputing p twice as now).

#include "clustered_tile.cuh"

namespace {

using namespace ctile;

enum Role { DQ = 0, DKV_GATHERED = 1, DKV_OWN = 2 };

template <class T>
struct Params {
  const T* q;          // [B, n_q, h, c]
  const T* k;          // [B, n_kv, h, c]
  const T* v;
  const T* dout;       // [B, n_q, h, c]
  const float* lse;    // [B, n_pad, h]
  const float* delta;  // [B, n_pad, h], zero past n_q
  const int* ids;
  const signed char* masks;
  T* dq;  // [B, n_q, h, c]
  T* dk;  // DKV_GATHERED: [B, nb, u_pad, h, c]; DKV_OWN: [B, n_kv, h, c]
  T* dv;
  int n_q;
  int n_kv;
  int heads;
  int c;
  int n_blocks;
  int block;
  int u_pad;
  int vec;  // c a multiple of 16 bytes' elements, every row 16-byte aligned
  float scale;
};

// T: element of q, k, v, dO and the gradients; CP: widest c of the tiles (a
// multiple of 8); RG row groups of CS warps; TB streamed rows per copied
// tile; ST shared-memory stages of the streamed tiles (1 where two do not
// fit).
template <class T_, int CP_, int RG_, int CS_, int TB_, int ST_ = STAGES>
struct Cfg {
  using T = T_;
  static constexpr int CP = CP_, RG = RG_, CS = CS_, TB = TB_, ST = ST_;
  static constexpr int THREADS = 32 * RG * CS;
  static constexpr int TA = 16 * RG;   // own rows per CTA
  static constexpr int CSW = CP / CS;  // channels per warp of a row group
  static constexpr int NS = TB / SUB;  // 16-row warp tiles per streamed tile
  static constexpr int NN = CSW / 8;   // 8-channel tiles of a warp's outputs
  static constexpr int LD = CP + row_pad<T>();  // rows in shared memory
  static constexpr int STAGE = 2 * TB * LD;  // elements per stage
  static constexpr size_t tile_bytes = sizeof(T) * (2 * TA * LD + ST * STAGE) +
                                       sizeof(float) * ST * 2 * TB +
                                       (CS > 1 ? sizeof(float4) * 2 * RG * CS * NS * 2 * 32 : 0);
  static_assert(THREADS == 256 && CSW % (sizeof(T) == 4 ? 8 : 16) == 0 && TB % SUB == 0 &&
                    NS <= 32 && (ST == 1 || ST == 2),
                "tile layout");
};

template <class C, int ROLE>
__global__ void __launch_bounds__(C::THREADS, 1)
    clustered_flash_bwd_kernel(const Params<typename C::T> p) {
  using T = typename C::T;
  constexpr int RG = C::RG, CS = C::CS, TB = C::TB, TA = C::TA, CSW = C::CSW;
  constexpr int CP = C::CP, NS = C::NS, NN = C::NN, LD = C::LD, THREADS = C::THREADS;
  constexpr int STAGE = C::STAGE, ST = C::ST;
  constexpr bool DKV = ROLE != DQ;                  // two accumulators
  constexpr bool OWN_SLOTS = ROLE == DKV_GATHERED;  // own rows are union slots
  constexpr int NN2 = DKV ? NN : 1;

  extern __shared__ float4 smem4[];
  T* A1 = reinterpret_cast<T*>(smem4);  // [TA][LD] own q or k
  T* A2 = A1 + TA * LD;                 // [TA][LD] own dO or v
  T* Bst = A2 + TA * LD;                // [ST][b1, b2][TB][LD]
  float* s_lse = reinterpret_cast<float*>(Bst + ST * STAGE);  // [ST][TB] streamed lse
  float* s_delta = s_lse + ST * TB;  // [ST][TB] streamed delta
  float4* xpart = reinterpret_cast<float4*>(s_delta + ST * TB);  // CS > 1
  float4* ypart = xpart + RG * CS * NS * 2 * 32;
  int* s_ids = reinterpret_cast<int*>(reinterpret_cast<char*>(smem4) + C::tile_bytes);  // [u_pad]
  const int n_own = OWN_SLOTS ? p.u_pad : p.block;
  const int n_str = OWN_SLOTS ? p.block : p.u_pad;
  const int n_tiles = (n_str + TB - 1) / TB;
  int* s_tiles = s_ids + p.u_pad;    // [n_tiles]
  int* s_count = s_tiles + n_tiles;  // [1]
  const int n_sub = (n_str + SUB - 1) / SUB;
  uint16_t* bits = reinterpret_cast<uint16_t*>(s_count + 1);  // [RG][n_sub][16]
  unsigned char* flags = reinterpret_cast<unsigned char*>(bits + RG * n_sub * 16);  // [RG][n_sub]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rg = warp / CS;
  const int cs = warp - rg * CS;
  const int a_tiles = (n_own + TA - 1) / TA;
  const int b = blockIdx.x / a_tiles;
  const int a0 = (blockIdx.x % a_tiles) * TA;
  const int g = blockIdx.y;
  const int bz = blockIdx.z;
  const long long q_base = (long long)bz * p.n_q;
  const long long kv_base = (long long)bz * p.n_kv;
  const long long l_base = (long long)bz * p.n_blocks * p.block;
  const signed char* mblock = p.masks + (long long)b * p.block * p.u_pad;
  // The mask byte of (own o, streamed s) is mblock[o * own_stride + s * str_stride].
  const long long own_stride = OWN_SLOTS ? 1 : p.u_pad;
  const long long str_stride = OWN_SLOTS ? p.u_pad : 1;

  for (int u = tid; u < p.u_pad; u += THREADS) s_ids[u] = p.ids[(long long)b * p.u_pad + u];
  scan_edges<RG, THREADS>(flags, bits, mblock, own_stride, str_stride, a0, n_own, n_str);
  __syncthreads();
  list_tiles<RG, TB>(s_tiles, s_count, flags, n_str);
  __syncthreads();
  const int n_list = *s_count;

  // Row lr of block b of a [B, N, h, c] tensor, or slot u of its union.
  auto block_row = [&](const T* t, long long base, int n_rows, int lr) -> const T* {
    const int row = b * p.block + lr;
    return lr < p.block && row < n_rows ? t + ((base + row) * p.heads + g) * p.c : nullptr;
  };
  auto slot_row = [&](const T* t, long long base, int u) -> const T* {
    return u < p.u_pad ? t + ((base + s_ids[u]) * p.heads + g) * p.c : nullptr;
  };
  const T* own1 = DKV ? p.k : p.q;
  const T* own2 = DKV ? p.v : p.dout;
  const T* str1 = DKV ? p.q : p.k;
  const T* str2 = DKV ? p.dout : p.v;
  const long long own_base = DKV ? kv_base : q_base;
  const long long str_base = DKV ? q_base : kv_base;
  const int own_n = DKV ? p.n_kv : p.n_q;
  const int str_n = DKV ? p.n_q : p.n_kv;
  auto own_ptr = [&](const T* t, int r) -> const T* {
    return OWN_SLOTS ? slot_row(t, own_base, a0 + r) : block_row(t, own_base, own_n, a0 + r);
  };
  copy_rows<THREADS, CP>(A1, LD, TA, p.c, p.vec, p.q, [&](int r) { return own_ptr(own1, r); });
  copy_rows<THREADS, CP>(A2, LD, TA, p.c, p.vec, p.q, [&](int r) { return own_ptr(own2, r); });

  auto copy_tile = [&](int stage, int tile) {
    T* B1 = Bst + stage * STAGE;
    const int s0 = tile * TB;
    auto str_ptr = [&](const T* t, int r) -> const T* {
      return OWN_SLOTS ? block_row(t, str_base, str_n, s0 + r) : slot_row(t, str_base, s0 + r);
    };
    copy_rows<THREADS, CP>(B1, LD, TB, p.c, p.vec, p.q, [&](int r) { return str_ptr(str1, r); });
    copy_rows<THREADS, CP>(B1 + TB * LD, LD, TB, p.c, p.vec, p.q,
                           [&](int r) { return str_ptr(str2, r); });
    if (DKV && tid < TB) {
      // Streamed rows' lse and delta; 0 for rows that are not there (their
      // dO and delta are 0 and their mask bytes too: they add exact zeros).
      const int s = s0 + tid;
      int row = -1;
      if (OWN_SLOTS) {
        if (s < p.block && b * p.block + s < p.n_q) row = b * p.block + s;
      } else if (s < p.u_pad) {
        row = s_ids[s];
      }
      const long long i = (l_base + row) * p.heads + g;
      s_lse[stage * TB + tid] = row >= 0 ? p.lse[i] : 0.f;
      s_delta[stage * TB + tid] = row >= 0 ? p.delta[i] : 0.f;
    }
  };
  // The first ST - 1 tiles' copies (with the own rows in the first group);
  // one group is committed per tile slot, empty or not, so that waiting for
  // all but the newest ST - 1 groups waits for the tile about to be used.
#pragma unroll
  for (int t = 0; t < ST - 1; ++t) {
    if (t < n_list) copy_tile(t, s_tiles[t]);
    cp_async_commit();
  }

  // This thread's own rows (g, g + 8 of its row group), local to the CTA's
  // block (DQ, DKV_OWN) or union (DKV_GATHERED).
  const int o0 = a0 + 16 * rg + (lane >> 2);
  const int t4 = lane & 3;
  // The DQ role's own rows: their lse and delta.
  float row_lse[2] = {0.f, 0.f}, row_delta[2] = {0.f, 0.f};
  if (!DKV) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (o0 + 8 * h < p.block) {
        const long long i = (l_base + b * p.block + o0 + 8 * h) * p.heads + g;
        row_lse[h] = p.lse[i];
        row_delta[h] = p.delta[i];
      }
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
    const int stage = i % ST;
    if (i + ST - 1 < n_list) copy_tile((i + ST - 1) % ST, s_tiles[i + ST - 1]);
    cp_async_commit();
    cp_async_wait<ST - 1>();
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
      col_products16<NN>(acc1, x[j], B1 + SUB * j * LD, LD, c_begin, lane);
      if constexpr (DKV)
        col_products16<NN>(acc2, y[j], B2 + SUB * j * LD, LD, c_begin, lane);
    }
    __syncthreads();  // the stage is free for the copy ST tiles on
  }
  cp_async_commit();
  cp_async_wait<0>();  // the own rows, when the list was empty

  // Outputs: dq and dk scaled, dv as summed.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = o0 + 8 * h;  // own row within the block, or slot
    T* dst1;
    T* dst2 = nullptr;
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
    for (int n = 0; n < NN; ++n) {
      const int d = c_begin + 8 * n + 2 * t4;
      if (d >= p.c) break;
      store2(dst1, d, p.c, p.vec, acc1[n][2 * h] * p.scale, acc1[n][2 * h + 1] * p.scale);
      if constexpr (DKV) store2(dst2, d, p.c, p.vec, acc2[n][2 * h], acc2[n][2 * h + 1]);
    }
  }
}

template <class C, int ROLE>
size_t smem_bytes(const Params<typename C::T>& p) {
  const int n_str = ROLE == DKV_GATHERED ? p.block : p.u_pad;
  const int n_tiles = (n_str + C::TB - 1) / C::TB;
  const size_t n_sub = (n_str + SUB - 1) / SUB;  // bits and flags per row group
  return C::tile_bytes + sizeof(int) * ((size_t)p.u_pad + n_tiles + 1) +
         C::RG * n_sub * (16 * sizeof(uint16_t) + 1);
}

template <class C, int ROLE>
int launch(const Params<typename C::T>& p, int batch, cudaStream_t stream) {
  const int n_own = ROLE == DKV_GATHERED ? p.u_pad : p.block;
  const size_t smem = smem_bytes<C, ROLE>(p);
  cudaError_t err = cudaFuncSetAttribute(clustered_flash_bwd_kernel<C, ROLE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.n_blocks * ((n_own + C::TA - 1) / C::TA), p.heads, batch);
  clustered_flash_bwd_kernel<C, ROLE><<<grid, C::THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// CTAs of a role's kernel that fit on one SM (registers and shared memory).
template <class C, int ROLE>
int ctas_per_sm(const Params<typename C::T>& p) {
  const size_t smem = smem_bytes<C, ROLE>(p);
  if (cudaFuncSetAttribute(clustered_flash_bwd_kernel<C, ROLE>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) != cudaSuccess)
    return -1;
  int n = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, clustered_flash_bwd_kernel<C, ROLE>,
                                                       C::THREADS, smem) == cudaSuccess
             ? n
             : -1;
}

// mode 0: general backward (DQ, then DKV_GATHERED); 1: DQ alone; 2: DKV_OWN.
// With `ctas`, launch nothing and return the mode's last kernel's CTAs an SM.
template <class C>
int run(const Params<typename C::T>& p, int mode, int batch, cudaStream_t stream, bool ctas) {
  if (ctas) {
    if (mode == 0) return ctas_per_sm<C, DKV_GATHERED>(p);
    if (mode == 1) return ctas_per_sm<C, DQ>(p);
    if (mode == 2) return ctas_per_sm<C, DKV_OWN>(p);
    return -1;
  }
  if (mode == 0) {
    const int err = launch<C, DQ>(p, batch, stream);
    return err != 0 ? err : launch<C, DKV_GATHERED>(p, batch, stream);
  }
  if (mode == 1) return launch<C, DQ>(p, batch, stream);
  if (mode == 2) return launch<C, DKV_OWN>(p, batch, stream);
  return (int)cudaErrorInvalidValue;
}

// The tiles of each width, for element T:
//                      CP  RG  CS  TB
template <class T> using W32 = Cfg<T, 32, 8, 1, 32>;
template <class T> using W128 = Cfg<T, 128, 4, 2, 32>;
template <class T> using W256 = Cfg<T, 256, 2, 4, 16>;
template <class T> using W512 = Cfg<T, 512, 1, 8, 16>;
// c up to 768, for K3c (the dq and symmetric dk/dv kernels): one row group
// of 8 warps, 96 channels each. In f32 the own rows (2 x 16 x 772 floats)
// and one stage of streamed rows take ~221 KB at U_pad 1,024 with the
// partial sums, so the f32 tile copies into one stage; bf16 keeps two
// (~171 KB). K3b's general dk/dv kernel stops at 512.
template <class T> using W768 = Cfg<T, 768, 1, 8, 16, sizeof(T) == 4 ? 1 : 2>;

template <class T>
int backward(const Params<T>& p, int mode, int batch, cudaStream_t s, bool ctas) {
  if (p.c <= 32) return run<W32<T>>(p, mode, batch, s, ctas);
  if (p.c <= 128) return run<W128<T>>(p, mode, batch, s, ctas);
  if (p.c <= 256) return run<W256<T>>(p, mode, batch, s, ctas);
  if (p.c <= 512) return run<W512<T>>(p, mode, batch, s, ctas);
  if (p.c <= 768 && mode != 0) return run<W768<T>>(p, mode, batch, s, ctas);
  return ctas ? -1 : (int)cudaErrorInvalidValue;
}

template <class T>
Params<T> params(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                 const float* delta, const int* gather_ids, const signed char* masks, void* dq,
                 void* dk, void* dv, int n_q, int n_kv, int heads, int c, int n_blocks, int block,
                 int u_pad, int vec, float scale) {
  return Params<T>{static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                   static_cast<const T*>(dout), lse, delta, gather_ids, masks,
                   static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), n_q, n_kv,
                   heads, c, n_blocks, block, u_pad, vec, scale};
}

}  // namespace

// Plain C entry point (bound with ctypes). q, k, v, dout, dq, dk and dv are
// f32 (is_bf16 == 0) or bf16 (is_bf16 == 1); lse and delta are f32.
// Launches on `stream`, does not synchronise, allocates nothing; returns a
// cudaError_t (0 on success), or cudaErrorInvalidValue for c > 768 (mode 0:
// c > 512) or an unknown mode. Pointers a mode does not write may be null. gather_ids are
// trusted: they are checked on the host when the graph's layout is built.
extern "C" int gwt_clustered_flash_backward(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const int* gather_ids,
    const signed char* masks, void* dq, void* dk, void* dv, int batch,
    int n_q, int n_kv, int heads, int c, int n_blocks, int block, int u_pad,
    int vec, float scale, int mode, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return backward(params<ctile::bf16>(q, k, v, dout, lse, delta, gather_ids, masks, dq, dk, dv,
                                        n_q, n_kv, heads, c, n_blocks, block, u_pad, vec, scale),
                    mode, batch, s, false);
  return backward(params<float>(q, k, v, dout, lse, delta, gather_ids, masks, dq, dk, dv, n_q,
                                n_kv, heads, c, n_blocks, block, u_pad, vec, scale),
                  mode, batch, s, false);
}

// CTAs an SM of a mode's dk/dv kernel (mode 0: K3b's, 2: K3c's) or dq kernel
// (mode 1) for head width c, this block and u_pad (f32: is_bf16 == 0, bf16:
// 1), or -1.
extern "C" int gwt_clustered_flash_backward_ctas(int c, int block, int u_pad, int mode,
                                                 int is_bf16) {
  if (is_bf16)
    return backward(params<ctile::bf16>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                        nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0, 1, c,
                                        1, block, u_pad, 0, 1.f),
                    mode, 1, nullptr, true);
  return backward(params<float>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                nullptr, nullptr, nullptr, nullptr, 0, 0, 1, c, 1, block, u_pad, 0,
                                1.f),
                  mode, 1, nullptr, true);
}
