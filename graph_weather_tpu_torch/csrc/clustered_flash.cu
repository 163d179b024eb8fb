// Clustered (gathered-neighbour) flash attention forward for Hopper (sm_90a),
// on the tensor cores: split-TF32 products for f32 inputs, bf16 products for
// bf16 inputs.
//
// Replaces the Pallas TPU kernel K3a, graph_weather_tpu/ops/pallas/
// clustered_flash.py: _clustered_impl (pallas_calls of _fwd_kernel_onepass
// and _fwd_kernel). Receivers come in blocks of `block` rows (RCB-ordered so
// a block is a compact patch of the sphere); block b attends to the union of
// its rows' senders, gather_ids[b, 0:U_pad], through the int8 adjacency
// masks[b, row, slot]. For batch entry i, head g and receiver row r of
// block b:
//
//     out[i, r, g] = sum_u softmax_u(q.k[ids[b, u]] * scale + bias) v[ids[b, u]]
//
// with bias = 0 on an edge and -1e30 off it, the running max starting at
// -1e28 and the output divided by max(l, 1e-30), as in the TPU kernel: a
// row with no neighbour (and a padded row past the last receiver) comes out
// exactly 0. q is [B, N_q, h, c]; k and v are [B, N_kv, h, c]; out is like q,
// f32 or bf16 (one kernel body, instantiated per element type).
// When the caller asks for it (training), the kernel also writes the
// log-sum-exp m + log(max(l, 1e-30)) of every row of every block, f32
// [B, nb * block, h], which the backward (clustered_flash_bwd.cu) reads.
//
// What bounds it on an H100. Only 7.6% of the (row, slot) pairs of
// GenCast's splits-5 layout are edges, so the work these inputs need moves
// ~90 MB per c = 128 call (bytes, ~27 us); but the pairs around the edges are
// computed too, 4 c flops each. The CUDA-core design before this one ran
// them on the FP32 pipes at a third of their 67 TFLOP/s. Here every product
// runs on the tensor cores as three TF32 mma.sync (clustered_tile.cuh), whose
// peak on this card is ~315 TFLOP/s of TF32 (~105 of f32 products); the
// fragment loads and splits, the softmax between the two products and the
// warps' wait at each tile's __syncthreads hold it well below that
// (PERF.md §6). The design:
//
//   * a CTA owns TQ = 16 RG receiver rows of one block, one head and one
//     batch entry; a warp owns 16 of them (a row group) and, where one warp
//     cannot hold 16 rows x c accumulators (c > 128), CS warps share a row
//     group, each over c / CS channels: their partial logits are summed
//     through shared memory in one order, every warp of the group runs the
//     same online softmax, and each accumulates its own channels of p.v;
//   * before any copy, the CTA reads its rows' mask bytes once and marks,
//     per row group, the 16-key warp tiles that hold an edge. A warp skips
//     the others (at splits 5, 16 x 16 tiles with an edge hold 53% of the
//     (row, slot) pairs, against 72% for the 64 x 64 tiles of the design
//     before), and the CTA copies only the TK-key tiles where some row group
//     has an edge. Inside a warp tile there is no branch: its four mma
//     chains (two 8-key halves, big . big apart from the cross terms) and
//     its fragment loads interleave;
//   * the CTA gathers its union's K and V rows itself (the TPU code gathered
//     them in XLA: Mosaic could not gather inside a kernel; TMA copies tiles,
//     not rows), with cp.async into two shared-memory stages: the next
//     tile's copies are issued before the current tile's products;
//   * the softmax is online over the tiles, in f32, on the accumulators'
//     registers; a skipped warp tile leaves its state unchanged. Channels
//     past c are zeros in shared memory, up to the tile's CP.
//
// Tiles follow c: CP = 32 and 128 take 8 row groups (TQ = 128) of one warp
// each; CP = 256 takes 4 row groups of 2 warps, CP = 512 2 row groups of 4
// warps, CP = 768 one row group of 8 (in f32 with one copy stage: two do
// not fit); 256 threads, one CTA per SM at CP >= 128. A narrower c runs its
// tile's full CP (zeros past c: FGN's c = 192 runs CP = 256).
//
// bf16 (GenCast's compute policy; the TPU kernel's bf16 mode). The tiles
// hold bf16 rows (c = 512: 108 KB of shared memory where f32 takes 215 KB),
// each product is one bf16 mma.sync m16n8k16 with f32 accumulators where
// f32 takes three TF32 ones, p is rounded to bf16 in registers before the
// P.V product (as the TPU kernel rounds it to the value dtype), V's B
// fragments come from ldmatrix.trans, and out is rounded to bf16 once; the
// softmax, m, l and lse stay f32 (clustered_tile.cuh).
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
  const int* ids;
  const signed char* masks;
  T* out;
  float* lse;  // [B, nb * block, h], or null: not written
  int n_q;
  int n_kv;
  int heads;
  int c;
  int block;
  int u_pad;
  int vec;  // c a multiple of 16 bytes' elements, every row 16-byte aligned
  float scale;
};

// T: element of q, k, v and out; CP: widest c of the tiles (a multiple of
// 8); RG row groups of CS warps; TK keys per copied tile; ST shared-memory
// stages of the copied tiles (2: the next tile's copies overlap the current
// tile's products; 1 where two do not fit).
template <class T_, int CP_, int RG_, int CS_, int TK_, int ST_ = STAGES>
struct Cfg {
  using T = T_;
  static constexpr int CP = CP_, RG = RG_, CS = CS_, TK = TK_, ST = ST_;
  static constexpr int THREADS = 32 * RG * CS;
  static constexpr int TQ = 16 * RG;  // rows per CTA
  static constexpr int CSW = CP / CS;  // channels per warp of a row group
  static constexpr int NS = TK / SUB;  // 16-key warp tiles per copied tile
  static constexpr int NN = CSW / 8;   // 8-channel tiles of a warp's output
  static constexpr int LD = CP + row_pad<T>();  // Q, K and V rows in shared memory
  static constexpr int STAGE = 2 * TK * LD;  // elements per stage
  static constexpr size_t tile_bytes = sizeof(T) * (TQ * LD + ST * STAGE) +
                                       (CS > 1 ? sizeof(float4) * RG * CS * NS * 2 * 32 : 0);
  static_assert(THREADS == 256 && CSW % (sizeof(T) == 4 ? 8 : 16) == 0 && TK % SUB == 0 &&
                    NS <= 32 && (ST == 1 || ST == 2),
                "tile layout");
};

template <class C>
__global__ void __launch_bounds__(C::THREADS, 1)
    clustered_flash_kernel(const Params<typename C::T> p) {
  using T = typename C::T;
  constexpr int RG = C::RG, CS = C::CS, TK = C::TK, TQ = C::TQ, CSW = C::CSW;
  constexpr int CP = C::CP, NS = C::NS, NN = C::NN, LD = C::LD, THREADS = C::THREADS;
  constexpr int STAGE = C::STAGE, ST = C::ST;
  extern __shared__ float4 smem4[];
  T* Qs = reinterpret_cast<T*>(smem4);  // [TQ][LD]
  T* KV = Qs + TQ * LD;  // [ST][K, V][TK][LD]
  float4* part = reinterpret_cast<float4*>(KV + ST * STAGE);  // CS > 1
  int* s_ids = reinterpret_cast<int*>(reinterpret_cast<char*>(smem4) + C::tile_bytes);  // [u_pad]
  const int n_tiles = (p.u_pad + TK - 1) / TK;
  int* s_tiles = s_ids + p.u_pad;       // [n_tiles]
  int* s_count = s_tiles + n_tiles;     // [1]
  const int n_sub = (p.u_pad + SUB - 1) / SUB;
  uint16_t* bits = reinterpret_cast<uint16_t*>(s_count + 1);  // [RG][n_sub][16]
  unsigned char* flags = reinterpret_cast<unsigned char*>(bits + RG * n_sub * 16);  // [RG][n_sub]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rg = warp / CS;
  const int cs = warp - rg * CS;
  const int q_tiles = (p.block + TQ - 1) / TQ;
  const int b = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * TQ;
  const int g = blockIdx.y;
  const long long q_base = (long long)blockIdx.z * p.n_q;
  const long long kv_base = (long long)blockIdx.z * p.n_kv;
  const signed char* mblock = p.masks + (long long)b * p.block * p.u_pad;
  for (int u = tid; u < p.u_pad; u += THREADS) s_ids[u] = p.ids[(long long)b * p.u_pad + u];
  scan_edges<RG, THREADS>(flags, bits, mblock, p.u_pad, 1, q0, p.block, p.u_pad);
  __syncthreads();
  list_tiles<RG, TK>(s_tiles, s_count, flags, p.u_pad);
  __syncthreads();
  const int n_list = *s_count;

  copy_rows<THREADS, CP>(Qs, LD, TQ, p.c, p.vec, p.q, [&](int r) -> const T* {
    const int lr = q0 + r;
    const int row = b * p.block + lr;
    return lr < p.block && row < p.n_q ? p.q + ((q_base + row) * p.heads + g) * p.c : nullptr;
  });
  auto copy_tile = [&](int stage, int tile) {
    T* Ks = KV + stage * STAGE;
    const int u0 = tile * TK;
    auto slot = [&](const T* t, int r) -> const T* {
      const int u = u0 + r;
      return u < p.u_pad ? t + ((kv_base + s_ids[u]) * p.heads + g) * p.c : nullptr;
    };
    copy_rows<THREADS, CP>(Ks, LD, TK, p.c, p.vec, p.q, [&](int r) { return slot(p.k, r); });
    copy_rows<THREADS, CP>(Ks + TK * LD, LD, TK, p.c, p.vec, p.q,
                           [&](int r) { return slot(p.v, r); });
  };
  // The first ST - 1 tiles' copies (with Q in the first group); one group
  // is committed per tile slot, empty or not, so that waiting for all but
  // the newest ST - 1 groups waits for the tile about to be used.
#pragma unroll
  for (int t = 0; t < ST - 1; ++t) {
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
    if (i + ST - 1 < n_list) copy_tile((i + ST - 1) % ST, s_tiles[i + ST - 1]);
    cp_async_commit();
    cp_async_wait<ST - 1>();
    __syncthreads();
    const T* Ks = KV + (i % ST) * STAGE;
    const T* Vs = Ks + TK * LD;
    const unsigned act = active_bits<NS>(flags, rg, tile, p.u_pad);
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
          col_products16<NN>(o, s[j], Vs + SUB * j * LD, LD, c_begin, lane);
    }
    __syncthreads();  // the stage is free for the copy ST tiles on
  }
  cp_async_commit();
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
    if (lr >= p.block) continue;
    if (p.lse != nullptr && cs == 0 && t == 0) {
      const long long n_pad = (long long)(gridDim.x / q_tiles) * p.block;
      p.lse[((blockIdx.z * n_pad) + b * p.block + lr) * p.heads + g] =
          m_i[h] + logf(fmaxf(l[h], 1e-30f));
    }
    const int row = b * p.block + lr;
    if (row >= p.n_q) continue;
    const float l_safe = fmaxf(l[h], 1e-30f);
    T* dst = p.out + ((q_base + row) * p.heads + g) * p.c;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const int d = c_begin + 8 * n + 2 * t;
      if (d >= p.c) break;
      store2(dst, d, p.c, p.vec, o[n][2 * h] / l_safe, o[n][2 * h + 1] / l_safe);
    }
  }
}

template <class C>
size_t smem_bytes(int u_pad) {
  const int n_tiles = (u_pad + C::TK - 1) / C::TK;
  const size_t n_sub = (u_pad + SUB - 1) / SUB;  // bits and flags per row group
  return C::tile_bytes + sizeof(int) * ((size_t)u_pad + n_tiles + 1) +
         C::RG * n_sub * (16 * sizeof(uint16_t) + 1);
}

template <class C>
int launch(const Params<typename C::T>& p, int n_blocks, int batch, cudaStream_t stream) {
  const size_t smem = smem_bytes<C>(p.u_pad);
  cudaError_t err = cudaFuncSetAttribute(clustered_flash_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_blocks * ((p.block + C::TQ - 1) / C::TQ), p.heads, batch);
  clustered_flash_kernel<C><<<grid, C::THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// CTAs of the kernel that fit on one SM at this u_pad (registers and shared
// memory), or -1 on an error.
template <class C>
int ctas_per_sm(int u_pad) {
  const size_t smem = smem_bytes<C>(u_pad);
  if (cudaFuncSetAttribute(clustered_flash_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return -1;
  int n = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, clustered_flash_kernel<C>, C::THREADS,
                                                       smem) == cudaSuccess
             ? n
             : -1;
}

// The tiles of each width, for element T:
//                      CP  RG  CS  TK
template <class T> using W32 = Cfg<T, 32, 8, 1, 64>;
template <class T> using W128 = Cfg<T, 128, 8, 1, 32>;
template <class T> using W256 = Cfg<T, 256, 4, 2, 16>;
template <class T> using W512 = Cfg<T, 512, 2, 4, 16>;
// c up to 768: one row group of 8 warps, 96 channels each. In f32 two
// stages of K and V (2 x 2 x 16 x 772 floats) and Q take ~250 KB, past the
// 227 KB a CTA may use, so the f32 tile copies into one stage (Q 49 KB +
// K, V 99 KB + the partial logits 8 KB: ~163 KB at U_pad 1,024) and waits
// for each tile's copies; bf16 keeps two (~139 KB).
template <class T> using W768 = Cfg<T, 768, 1, 8, 16, sizeof(T) == 4 ? 1 : 2>;

template <class T>
int forward(const void* q, const void* k, const void* v, const int* gather_ids,
            const signed char* masks, void* out, float* lse, int batch, int n_q, int n_kv,
            int heads, int c, int n_blocks, int block, int u_pad, int vec, float scale,
            cudaStream_t s) {
  const Params<T> p{static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                    gather_ids, masks, static_cast<T*>(out), lse, n_q, n_kv, heads, c, block,
                    u_pad, vec, scale};
  if (c <= 32) return launch<W32<T>>(p, n_blocks, batch, s);
  if (c <= 128) return launch<W128<T>>(p, n_blocks, batch, s);
  if (c <= 256) return launch<W256<T>>(p, n_blocks, batch, s);
  if (c <= 512) return launch<W512<T>>(p, n_blocks, batch, s);
  if (c <= 768) return launch<W768<T>>(p, n_blocks, batch, s);
  return (int)cudaErrorInvalidValue;
}

template <class T>
int occupancy(int c, int u_pad) {
  if (c <= 32) return ctas_per_sm<W32<T>>(u_pad);
  if (c <= 128) return ctas_per_sm<W128<T>>(u_pad);
  if (c <= 256) return ctas_per_sm<W256<T>>(u_pad);
  if (c <= 512) return ctas_per_sm<W512<T>>(u_pad);
  if (c <= 768) return ctas_per_sm<W768<T>>(u_pad);
  return -1;
}

}  // namespace

// Plain C entry point (bound with ctypes). q, k, v and out are f32
// (is_bf16 == 0) or bf16 (is_bf16 == 1); lse is f32. Launches on `stream`, does
// not synchronise, allocates nothing; returns a cudaError_t (0 on success),
// or cudaErrorInvalidValue for c > 768. `lse` may be null (serving).
// gather_ids are trusted: they are checked on the host when the graph's
// layout is built.
extern "C" int gwt_clustered_flash_forward(
    const void* q, const void* k, const void* v, const int* gather_ids,
    const signed char* masks, void* out, float* lse, int batch, int n_q,
    int n_kv, int heads, int c, int n_blocks, int block, int u_pad, int vec,
    float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? forward<ctile::bf16>(q, k, v, gather_ids, masks, out, lse, batch, n_q, n_kv,
                                        heads, c, n_blocks, block, u_pad, vec, scale, s)
                 : forward<float>(q, k, v, gather_ids, masks, out, lse, batch, n_q, n_kv, heads,
                                  c, n_blocks, block, u_pad, vec, scale, s);
}

// CTAs an SM of the forward's kernel for head width c at this u_pad
// (f32: is_bf16 == 0, bf16: 1), or -1.
extern "C" int gwt_clustered_flash_forward_ctas(int c, int u_pad, int is_bf16) {
  return is_bf16 ? occupancy<ctile::bf16>(c, u_pad) : occupancy<float>(c, u_pad);
}
