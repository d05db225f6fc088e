// Chunk-append attention over a block-paged KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py:169
// (_chunk_kernel) behind kernel.py:264 (paged_chunk_attention), with its
// f32/bf16 and int8 pool modes and its fused logit_index epilogue
// (kernel.py:238-250).
//
// Contract (the plain version is ref.py::paged_chunk_attention_ref):
//   q           [B, C, H, D]        f32 or bf16, right-padded chunks
//   k/v_pages   [P, psize, KH, D]   q's dtype, or int8 with k/v_scale; the
//                                   chunk's own K/V is already appended
//   k/v_scale   [P, KH] f32         int8 pools only: element x of page p,
//                                   kv head h is x * scale[p, h]
//   block_tables[B, maxp] int32     only entries of live pages are read
//   starts, chunk_lens [B] int32    token j of slot b sits at start + j
//   out         [B, C, H, D]        q's dtype; padding rows and idle slots 0
//   logit_index [B, S_w] int32      optional (S_w > 0): out_win [B, S_w, H,
//                                   D] gets row logit_index[b, s] of out[b]
//                                   (the fused verify window); an index
//                                   outside [0, C) leaves its rows as the
//                                   caller allocated them (zeros)
// Query row r of a (slot, kv head) pair is chunk token r / G, query head
// kh * G + r % G (G = H / KH), so the G heads sharing a kv head read each
// K/V element once, without repeating K/V.
//
// What bounds it on an H100: the bytes of the live K/V pages at a decode
// tick (~4 flops per K/V element read, far below the card's ~295 flops/byte
// balance point), and at a long prompt chunk the products: 4 * D flops per
// (row, visible key).  Two kernels, chosen by the wrapper
// (kernel.py::chunk_route):
//
// tensor cores (bf16 q; bf16 or int8 pools; D 32/64/96/128; psize
//   8/16/32/64; G dividing 64): paged_chunk_tc_kernel, after the flash
//   forward (flash_attention.cu).  One block per (slot, kv head, 64-row q
//   tile), one consumer warpgroup and one producer warp.  The producer
//   copies the q tile once by TMA (a 5-d map (d, g, kv head, token, slot)
//   lands the tile's 64 / G tokens x G heads as its 64 rows) and then, for
//   each 64-key tile, reads the block-table entries of its 64 / psize pages
//   (one lane each, live pages only) and copies each page's psize rows of
//   K and V by TMA through a 3-d map of the pool (d, kv head, page row)
//   into a four-stage mbarrier ring.  TMA rather than cp.async: one lane
//   per page issues whole-page boxes that land already swizzled for wgmma,
//   the consumers spend no instructions on copies, and a page past the
//   tile's live keys is a box outside the pool, which TMA fills with zeros
//   without reading memory (so masked keys multiply finite zeros and no
//   dead entry is read).  A page of psize rows is psize * SW bytes, a
//   whole number of swizzle atoms for psize >= 8, so pages tile the
//   swizzled layout exactly.  The consumer runs S = Q K^T (wgmma, both
//   operands K-major in shared memory, f32 accumulators), the mask (causal
//   within the chunk, window, padding rows) and the online softmax in f32
//   registers, and O += P V with P as the register A operand and V read
//   transposed.  Key tiles above the causal diagonal of the q tile's last
//   valid token, or below its first token's window, are never loaded;
//   a q tile of an idle slot or of padding rows only writes zeros.  Decode
//   slots of a mixed tick have G live rows of the 64: their cost is their
//   K/V bytes, read once per (slot, kv head).
//   int8 pools (the same kernel, QUANT): the page boxes are int8 and
//   unswizzled (a page is psize rows of D bytes), and the producer lane of
//   a page also writes the page's K and V scale into the stage's scale
//   slots before it arrives on the stage's barrier.  A converter
//   warpgroup turns each int8 tile into bf16 (exact: integers up to |127|)
//   in the swizzled layout the wgmma descriptors read, in a second,
//   two-stage ring, copies the scales along, and fences its writes to the
//   async proxy before it releases the tile to the consumers.  The scales
//   stay out of the tiles, in f32 registers: S's column j is multiplied by
//   k_scale[page(j)] before the softcap and the mask, and only the copy of
//   P that meets V by v_scale[page(j)]; the row sum l adds the unscaled P.
//   The int8 bytes are half the bf16 ones; the conversion runs beside the
//   copies and the products.
//
// CUDA cores (f32 q, and the shapes above it does not take):
//   paged_chunk_attention_kernel.  One block owns one (slot, kv head, group
//   of 16 query rows); it walks the slot's live keys in tiles of 32, copies
//   each tile of K and V into shared memory once (16-byte cp.async copies,
//   two stages), and every query row of the block reads it from there.
//   Scores are computed one key per lane.  int8 pools: a tile row of D int8
//   is D / 16 copies of 16 bytes; each lane loads the K and V scale of its
//   key's page when it issues the tile, and every K/V element is
//   multiplied by its scale in f32 right after it is read from shared
//   memory.  Launch: grid (ceil(C * G / ROWS), KH, B), NWARPS warps; a warp
//   owns ROWS / NWARPS rows (interleaved); a lane holds D / 32 elements of
//   each row's accumulator.
//
// Both: key kpos is visible to a row at position qpos when kpos < start +
// clen, kpos <= qpos and, with a window, kpos > qpos - window.  Masked keys
// get probability 0 and no max update, so a row whose first tiles are all
// masked (a sliding window shorter than the context) never computes
// exp(-inf - -inf).  Pages past the live length are never read, and the
// block table entry of a page is read only when the page is live: a stale
// or garbage entry there is never dereferenced.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int KT = 32;        // keys per shared-memory tile (one per lane)
constexpr int NWARPS = 4;
constexpr int RPW = 4;        // query rows per warp
constexpr int ROWS = NWARPS * RPW;
constexpr int NT = NWARPS * 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// cp.async: 16-byte global -> shared copies that bypass registers; with
// src_bytes == 0 the destination is zero-filled and nothing is read
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A K or V tile row holds D elements plus 16 bytes of padding, so the 16-byte
// reads of 8 lanes on 8 different rows fall on 32 different banks.
template <typename T, int D>
__host__ __device__ constexpr int row_stride() {
  return D + 16 / (int)sizeof(T);
}

template <typename KV, int D>
constexpr size_t smem_bytes() {
  // two stages of K and V tiles in the pool's type, the block's query rows
  // in f32
  return sizeof(KV) * 2 * 2 * KT * row_stride<KV, D>() +
         sizeof(float) * ROWS * D;
}

template <typename T, typename KV, int D>
__global__ void __launch_bounds__(NT)
paged_chunk_attention_kernel(const T* __restrict__ q,
                             const KV* __restrict__ k_pages,
                             const KV* __restrict__ v_pages,
                             const float* __restrict__ k_scale,
                             const float* __restrict__ v_scale,
                             const int* __restrict__ block_tables,
                             const int* __restrict__ starts,
                             const int* __restrict__ chunk_lens,
                             const int* __restrict__ widx,
                             T* __restrict__ out, T* __restrict__ out_win,
                             int C, int H, int KH, int psize, int maxp,
                             int S_w, float scale, int window,
                             float softcap) {
  constexpr bool QUANT = std::is_same<KV, int8_t>::value;
  constexpr int NE = D / 32;                 // accumulator elements a lane
  constexpr int VEC = 16 / sizeof(KV);       // elements a 16-byte copy
  constexpr int RS = row_stride<KV, D>();
  constexpr int CPR = D / VEC;               // 16-byte chunks a key row
  constexpr int CHUNKS = KT * CPR;           // 16-byte chunks a tile
  constexpr int COPIES = (CHUNKS + NT - 1) / NT;  // a thread, a tensor
  extern __shared__ __align__(16) unsigned char smem_raw[];
  KV* tiles = reinterpret_cast<KV*>(smem_raw);  // [stage][K|V][KT][RS]
  float* Qs = reinterpret_cast<float*>(tiles + 2 * 2 * KT * RS);  // [ROWS][D]

  const int b = blockIdx.z, kh = blockIdx.y;
  const int G = H / KH;
  const int CG = C * G;
  const int row0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int start = starts[b], clen = chunk_lens[b];

  // this warp's rows: row0 + i * NWARPS + warp
  int tok[RPW];
  bool active[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = row0 + i * NWARPS + warp;
    tok[i] = r / G;
    active[i] = r < CG && tok[i] < clen;
    float* qs = Qs + (warp * RPW + i) * D;
    if (active[i]) {
      const T* qr = q + ((size_t)(b * C + tok[i]) * H + kh * G + r % G) * D;
#pragma unroll
      for (int e = 0; e < NE; ++e) qs[lane + 32 * e] = to_f32(qr[lane + 32 * e]);
    } else {
#pragma unroll
      for (int e = 0; e < NE; ++e) qs[lane + 32 * e] = 0.f;
    }
  }

  // key range any row of the block can see (block-uniform)
  const int r_last = min(row0 + ROWS, CG) - 1;
  const int t_first = row0 / G, t_last = min(r_last / G, clen - 1);
  const bool block_live = t_first < clen;
  const int k_hi = start + t_last;                 // causal, < start + clen
  const int k_lo = window > 0 ? max(0, start + t_first - window + 1) : 0;

  // copy the K/V rows of keys [k0, k0 + KT) into stage st; keys past k_hi
  // are zero-filled, and only live pages' block-table entries are read.
  // int8: lane j also loads the scales of key k0 + j into nks / nvs
  float nks = 0.f, nvs = 0.f;
  auto issue_tile = [&](int k0, int st) {
    KV* Kt = tiles + (st * 2) * KT * RS;
    KV* Vt = Kt + KT * RS;
#pragma unroll
    for (int i = 0; i < COPIES; ++i) {
      const int c = threadIdx.x + i * NT;
      if (CHUNKS % NT != 0 && c >= CHUNKS) break;
      const int j = c / CPR, dv = (c % CPR) * VEC;
      const int kpos = k0 + j;
      const KV* ks = k_pages;
      const KV* vs = v_pages;
      int nbytes = 0;
      if (kpos <= k_hi) {
        const int pg = kpos / psize;
        const long long page = block_tables[(size_t)b * maxp + pg];
        const long long off =
            ((page * psize + (kpos - pg * psize)) * KH + kh) * D + dv;
        ks += off;
        vs += off;
        nbytes = 16;
      }
      cp_async16(Kt + j * RS + dv, ks, nbytes);
      cp_async16(Vt + j * RS + dv, vs, nbytes);
    }
    cp_async_commit();
    if constexpr (QUANT) {
      const int kpos = k0 + lane;
      nks = nvs = 0.f;
      if (kpos <= k_hi) {
        const int pg = kpos / psize;
        const long long si =
            (long long)block_tables[(size_t)b * maxp + pg] * KH + kh;
        nks = k_scale[si];
        nvs = v_scale[si];
      }
    }
  };

  float m[RPW], l[RPW], acc[RPW][NE];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[i][e] = 0.f;
  }

  if (block_live) issue_tile(k_lo, 0);
  __syncthreads();                                 // Qs written
  int st = 0;
  for (int k0 = k_lo; block_live && k0 <= k_hi; k0 += KT, st ^= 1) {
    const float cks = nks, cvs = nvs;              // this tile's scales
    // the next tile's copies fly while this one is consumed
    if (k0 + KT <= k_hi) {
      issue_tile(k0 + KT, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const KV* Kt = tiles + (st * 2) * KT * RS;
    const KV* Vt = Kt + KT * RS;

    // scores: lane j holds key k0 + j for each of the warp's rows
    float s[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) s[i] = 0.f;
    const KV* kr = Kt + lane * RS;
    const float* qw = Qs + warp * RPW * D;
#pragma unroll 2
    for (int d = 0; d < D; d += VEC) {
      const uint4 raw = *reinterpret_cast<const uint4*>(kr + d);
      const KV* kv = reinterpret_cast<const KV*>(&raw);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float kx = to_f32(kv[e]);
        if constexpr (QUANT) kx *= cks;
#pragma unroll
        for (int i = 0; i < RPW; ++i)
          s[i] = fmaf(qw[i * D + d + e], kx, s[i]);
      }
    }
    const int kpos = k0 + lane;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      if (!active[i]) continue;                    // warp-uniform
      const int qpos = start + tok[i];
      float sc = s[i] * scale;
      if (softcap > 0.f) sc = tanhf(sc / softcap) * softcap;
      const bool ok = kpos <= k_hi && kpos <= qpos &&
                      (window <= 0 || kpos > qpos - window);
      const float tile_max = warp_max(ok ? sc : -INFINITY);
      if (tile_max == -INFINITY) continue;         // no visible key here
      const float m_new = fmaxf(m[i], tile_max);
      const float corr = expf(m[i] - m_new);
      const float p = ok ? expf(sc - m_new) : 0.f;
      l[i] = l[i] * corr + warp_sum(p);
#pragma unroll
      for (int e = 0; e < NE; ++e) acc[i][e] *= corr;
#pragma unroll 8
      for (int j = 0; j < KT; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        float vsj = 1.f;
        if constexpr (QUANT) vsj = __shfl_sync(0xffffffffu, cvs, j);
#pragma unroll
        for (int e = 0; e < NE; ++e) {
          float vx = to_f32(Vt[j * RS + lane + 32 * e]);
          if constexpr (QUANT) vx *= vsj;
          acc[i][e] = fmaf(pj, vx, acc[i][e]);
        }
      }
      m[i] = m_new;
    }
    __syncthreads();                   // stage st is refilled next turn
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = row0 + i * NWARPS + warp;
    if (r >= CG) continue;
    const int head = kh * G + r % G;
    T* o = out + ((size_t)(b * C + tok[i]) * H + head) * D;
    const float inv = active[i] ? 1.f / fmaxf(l[i], 1e-30f) : 0.f;
#pragma unroll
    for (int e = 0; e < NE; ++e)
      o[lane + 32 * e] = from_f32<T>(active[i] ? acc[i][e] * inv : 0.f);
    // the fused verify window: this row again for each window slot naming
    // its token
    for (int sw = 0; sw < S_w; ++sw) {
      if (widx[(size_t)b * S_w + sw] != tok[i]) continue;
      T* ow = out_win + ((size_t)(b * S_w + sw) * H + head) * D;
#pragma unroll
      for (int e = 0; e < NE; ++e)
        ow[lane + 32 * e] = from_f32<T>(active[i] ? acc[i][e] * inv : 0.f);
    }
  }
}

// The operands of one launch, as the C entry point receives them.
struct Args {
  const void *q, *k, *v;
  const float *ks, *vs;
  const int *bt, *starts, *clens, *widx;
  void *out, *out_win;
  int B, C, H, KH, D, psize, maxp, P, S_w;
  float scale;
  int window;
  float softcap;
};

template <typename T, typename KV, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<KV, D>();
  auto kernel = paged_chunk_attention_kernel<T, KV, D>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int G = a.H / a.KH;
  dim3 grid((a.C * G + ROWS - 1) / ROWS, a.KH, a.B);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), a.ks, a.vs, a.bt, a.starts, a.clens,
      a.widx, static_cast<T*>(a.out), static_cast<T*>(a.out_win), a.C, a.H,
      a.KH, a.psize, a.maxp, a.S_w, a.scale, a.window, a.softcap);
  return cudaGetLastError();
}

template <typename T, typename KV>
cudaError_t dispatch_d(const Args& a, cudaStream_t s) {
#define CASE(DD)   \
  case DD:         \
    return launch<T, KV, DD>(a, s);
  switch (a.D) {
    CASE(32) CASE(64) CASE(96) CASE(128) CASE(160) CASE(192) CASE(224)
    CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef CASE
}

// ---------------------------------------------------------------------------
// bf16 q: the tensor-core kernel (wgmma fed by TMA), on bf16 or int8 pools
// ---------------------------------------------------------------------------
constexpr int TQ = 64;          // query rows of a tile: one warpgroup
constexpr int TK = 64;          // keys of a K/V tile
constexpr int TC_STAGES = 4;    // the TMA ring (bf16 tiles, or int8 tiles)
constexpr int TC_BSTAGES = 2;   // int8: the converted bf16 tiles
constexpr int MAX_PPT = TK / 8; // pages a key tile (psize >= 8)
constexpr float LOG2E = 1.4426950408889634f;

template <int D, bool QUANT>
struct TcLayout {
  static constexpr int Q_BYTES = TQ * D * 2;
  static constexpr int TILE = TK * D * 2;     // a bf16 K or V tile
  static constexpr int TILE8 = TK * D;        // an int8 K or V tile
  // the wgmma tiles: the TMA ring, or (int8) the converter's output ring
  static constexpr int BSTAGES = QUANT ? TC_BSTAGES : TC_STAGES;
  // the consumer warpgroup, (int8) the converter warpgroup, the producer
  static constexpr int THREADS = QUANT ? 288 : 160;
  static constexpr int PRODUCER = QUANT ? 8 : 4;   // the producer warp
  static constexpr size_t SMEM = 1024 + (size_t)Q_BYTES +
                                 2 * (size_t)BSTAGES * TILE +
                                 (QUANT ? 2 * (size_t)TC_STAGES * TILE8 : 0);
};

// The swizzled position of the 16-byte unit u (8 bf16 columns) of row r in
// a chunk of SW-byte rows, as TMA's CU_TENSOR_MAP_SWIZZLE_{SW}B lays it out
// (Swizzle<3,4,3> at 128 bytes, Swizzle<2,4,3> at 64) on a 1024-byte-
// aligned chunk.
template <int SW>
__device__ __forceinline__ int swizzled_unit(int r, int u) {
  return SW == 128 ? u ^ (r & 7) : u ^ ((r >> 1) & 3);
}

// Two int8 (bytes k and k + 1 of a word) to a bf16x2, exactly, in four
// instructions: the low 7 bits of x become the mantissa of 128.0 (bf16
// 0x4300, whose mantissa step is 1), and 128.0 or 256.0 (0x4380), as x's
// sign bit says, is subtracted: 128 + x - 128 for x >= 0, 128 + (x + 128)
// - 256 for x < 0.
__device__ __forceinline__ uint32_t int8x2_to_bf16x2(uint32_t w, int k) {
  const uint32_t p = __byte_perm(w, 0u, k == 0 ? 0x4140 : 0x4342);
  const uint32_t v = (p & 0x007F007Fu) | 0x43004300u;
  const uint32_t s = (p & 0x00800080u) | 0x43004300u;
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                             *reinterpret_cast<const __nv_bfloat162*>(&s));
  return *reinterpret_cast<uint32_t*>(&r);
}

// int8 -> bf16 of a [TK][D] int8 tile (row-major, as the unswizzled page
// boxes land) into the swizzled bf16 tile the wgmma descriptors read;
// 128 threads, ct their index, 16 elements (two 16-byte bf16 units of one
// chunk row) a thread at a time.  Integers up to |127| are exact in bf16.
template <int D>
__device__ __forceinline__ void convert_tile(const uint8_t* src, uint8_t* dst,
                                             int ct) {
  using TL = hopper::Tiles<D>;
  constexpr int GPR = D / 16;                  // 16-element groups a row
#pragma unroll 2
  for (int i = ct; i < TK * GPR; i += 128) {
    const int r = i / GPR, d0 = (i % GPR) * 16;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + r * D + d0);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    uint4 o[2];
    uint32_t* ow = reinterpret_cast<uint32_t*>(o);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      ow[k] = int8x2_to_bf16x2(w[k / 2], 2 * (k % 2));
    const int c = d0 / TL::CW, u = (d0 % TL::CW) / 8;
    uint8_t* row = dst + c * TK * TL::SW + r * TL::SW;
    *reinterpret_cast<uint4*>(row + swizzled_unit<TL::SW>(r, u) * 16) = o[0];
    *reinterpret_cast<uint4*>(row + swizzled_unit<TL::SW>(r, u + 1) * 16) =
        o[1];
  }
}

template <int D, bool QUANT>
__global__ void __launch_bounds__(TcLayout<D, QUANT>::THREADS, 1)
paged_chunk_tc_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const float* __restrict__ k_scale,
                      const float* __restrict__ v_scale,
                      const int* __restrict__ block_tables,
                      const int* __restrict__ starts,
                      const int* __restrict__ chunk_lens,
                      const int* __restrict__ widx,
                      __nv_bfloat16* __restrict__ out,
                      __nv_bfloat16* __restrict__ out_win, int C, int H,
                      int KH, int psize, int maxp, int P, int S_w,
                      float scale, int window, float softcap) {
  using TL = hopper::Tiles<D>;
  using L = TcLayout<D, QUANT>;
  constexpr int BST = L::BSTAGES;
  extern __shared__ unsigned char smem_raw[];
  // full/empty: the TMA ring; int8: bfull/bempty, the converted tiles
  __shared__ uint64_t full[TC_STAGES], empty[TC_STAGES], qbar;
  __shared__ uint64_t bfull[TC_BSTAGES], bempty[TC_BSTAGES];
  // int8: each TMA stage's page scales, and each converted tile's
  __shared__ float sk8[TC_STAGES][MAX_PPT], sv8[TC_STAGES][MAX_PPT];
  __shared__ float skb[TC_BSTAGES][MAX_PPT], svb[TC_BSTAGES][MAX_PPT];
  uint8_t* Qs = hopper::align1024(smem_raw);
  uint8_t* Ks = Qs + L::Q_BYTES;               // stage s at Ks + s * TILE
  uint8_t* Vs = Ks + BST * L::TILE;
  uint8_t* K8 = Vs + BST * L::TILE;            // int8: stage s at + s * TILE8
  uint8_t* V8 = K8 + TC_STAGES * L::TILE8;

  const int b = blockIdx.z, kh = blockIdx.y, row0 = blockIdx.x * TQ;
  const int G = H / KH, CG = C * G;
  const int start = starts[b], clen = chunk_lens[b];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // keys [k_lo, k_hi] that some valid row of the tile can see, in n tiles
  // from kb0 (k_lo rounded down to a tile)
  const int t_first = row0 / G;
  int n = 0, kb0 = 0, k_lo = 0, k_hi = -1;
  if (t_first < clen) {
    const int t_last = min((min(row0 + TQ, CG) - 1) / G, clen - 1);
    k_hi = start + t_last;
    k_lo = window > 0 ? max(0, start + t_first - window + 1) : 0;
    kb0 = k_lo / TK * TK;
    n = (k_hi - kb0) / TK + 1;
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 128);  // the consumers, or converters
    }
    for (int s = 0; s < TC_BSTAGES; ++s) {
      hopper::mbar_init(&bfull[s], 128);  // the converters
      hopper::mbar_init(&bempty[s], 128); // the consumers
    }
    hopper::mbar_init(&qbar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == L::PRODUCER) {
    // producer: the q tile, then each key tile page by page, one lane a
    // page (int8: the lane also fetches the page's two scales)
    if (n == 0) return;
    if (lane == 0) {
      hopper::mbar_expect_tx(&qbar, L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < TL::NCH; ++c)
        hopper::tma_load_5d(Qs + c * TQ * TL::SW, &tq, &qbar, c * TL::CW, 0,
                            kh, t_first, b);
    }
    // The block-table entries come a round ahead: lane l fetches page
    // l % ppt of tile l / ppt of a round of 32 / ppt tiles, and the lanes
    // that issue a tile's copies take them by shuffles, so no block-table
    // load (or int8 scale load) sits between one tile's copies and the
    // next's.  Only pages holding a key of [k_lo, k_hi] are fetched: a
    // window's pages wholly before k_lo load as zeros, like pages past
    // k_hi, and their entries are never read.
    const int ppt = TK / psize, tpr = 32 / ppt;  // pages a tile, tiles a round
    auto fetch_round = [&](int r) {
      const int t = r * tpr + lane / ppt;
      const int pg = (kb0 + t * TK) / psize + lane % ppt;
      return t < n && pg * psize <= k_hi && (pg + 1) * psize > k_lo
                 ? block_tables[(size_t)b * maxp + pg] : -1;
    };
    int cur = fetch_round(0), nxt = fetch_round(1);
    float cur_ks = 0.f, cur_vs = 0.f;
    auto round_scales = [&]() {
      if constexpr (QUANT) {
        cur_ks = cur >= 0 ? k_scale[(long long)cur * KH + kh] : 0.f;
        cur_vs = cur >= 0 ? v_scale[(long long)cur * KH + kh] : 0.f;
      }
    };
    round_scales();
    for (int it = 0; it < n; ++it) {
      const int s = it % TC_STAGES;
      if (it > 0 && it % tpr == 0) {
        cur = nxt;
        nxt = fetch_round(it / tpr + 1);
        round_scales();
      }
      const int src = (it % tpr) * ppt + lane % ppt;
      const int page = __shfl_sync(0xffffffffu, cur, src);
      float ks = 0.f, vs = 0.f;
      if constexpr (QUANT) {
        ks = __shfl_sync(0xffffffffu, cur_ks, src);
        vs = __shfl_sync(0xffffffffu, cur_vs, src);
      }
      const bool live = lane < ppt && page >= 0;
      const int row = live ? page * psize : P * psize;  // outside: zeros
      if (it >= TC_STAGES)
        hopper::mbar_wait(&empty[s], (it / TC_STAGES - 1) & 1);
      if constexpr (QUANT) {
        // the bytes first, the copies, then the scales; the arrival comes
        // after the scales are written, so a waiter sees both
        if (lane == 0) hopper::mbar_expect_tx_only(&full[s], 2 * L::TILE8);
        __syncwarp();
        if (lane < ppt) {
          hopper::tma_load_3d(K8 + s * L::TILE8 + lane * psize * D, &tk,
                              &full[s], 0, kh, row);
          hopper::tma_load_3d(V8 + s * L::TILE8 + lane * psize * D, &tv,
                              &full[s], 0, kh, row);
          sk8[s][lane] = ks;
          sv8[s][lane] = vs;
        }
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&full[s]);
      } else {
        if (lane == 0) hopper::mbar_expect_tx(&full[s], 2 * L::TILE);
        __syncwarp();
        if (lane < ppt) {
          uint8_t* kt = Ks + s * L::TILE + lane * psize * TL::SW;
          uint8_t* vt = Vs + s * L::TILE + lane * psize * TL::SW;
#pragma unroll
          for (int c = 0; c < TL::NCH; ++c) {
            hopper::tma_load_3d(kt + c * TK * TL::SW, &tk, &full[s],
                                c * TL::CW, kh, row);
            hopper::tma_load_3d(vt + c * TK * TL::SW, &tv, &full[s],
                                c * TL::CW, kh, row);
          }
        }
      }
    }
    return;
  }

  if constexpr (QUANT) {
    if (warp >= 4) {
      // converter warpgroup: each int8 tile into the bf16 ring, with its
      // scales; the generic writes are fenced to the async proxy before
      // the consumers' wgmma may read them
      const int ct = threadIdx.x - 128;
      for (int it = 0; it < n; ++it) {
        const int s = it % TC_STAGES, t = it % TC_BSTAGES;
        hopper::mbar_wait(&full[s], (it / TC_STAGES) & 1);
        if (it >= TC_BSTAGES)
          hopper::mbar_wait(&bempty[t], (it / TC_BSTAGES - 1) & 1);
        convert_tile<D>(K8 + s * L::TILE8, Ks + t * L::TILE, ct);
        convert_tile<D>(V8 + s * L::TILE8, Vs + t * L::TILE, ct);
        if (ct < MAX_PPT) {
          skb[t][ct] = sk8[s][ct];
          svb[t][ct] = sv8[s][ct];
        }
        hopper::fence_proxy_async();
        hopper::mbar_arrive(&empty[s]);
        hopper::mbar_arrive(&bfull[t]);
      }
      return;
    }
  }

  // consumer warpgroup: this thread's two rows, h = 0 and h = 1 (8 below)
  int tok[2], qpos[2];
  bool valid[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 16 * warp + lane / 4 + 8 * h;
    tok[h] = r / G;
    valid[h] = r < CG && tok[h] < clen;
    qpos[h] = start + tok[h];
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  if (n > 0) hopper::mbar_wait(&qbar, 0);

  for (int it = 0; it < n; ++it) {
    const int s = it % BST, k0 = kb0 + it * TK;
    uint64_t* ready = QUANT ? &bfull[s] : &full[s];
    hopper::mbar_wait(ready, (it / BST) & 1);
    if constexpr (QUANT) hopper::fence_proxy_async();
    const uint8_t* Kt = Ks + s * L::TILE;
    const uint8_t* Vt = Vs + s * L::TILE;

    // S = Q K^T
    float sc[TK / 2];
#pragma unroll
    for (int i = 0; i < TK / 2; ++i) sc[i] = 0.f;
    hopper::pin(sc);
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_ss<0>(sc, hopper::kmajor<D>(Qs, TQ, 0, kk),
                          hopper::kmajor<D>(Kt, TK, 0, kk), kk > 0);
    hopper::wg_commit();
    hopper::wg_wait<0>();
    hopper::pin(sc);

    // int8: the K and V scale of each 8-column group's page (psize >= 8,
    // so a group lies in one page)
    float kcol[TK / 8], vcol[TK / 8];
#pragma unroll
    for (int g = 0; g < TK / 8; ++g) {
      kcol[g] = 1.f;
      vcol[g] = 1.f;
      if constexpr (QUANT) {
        kcol[g] = skb[s][8 * g / psize];
        vcol[g] = svb[s][8 * g / psize];
      }
    }

    // mask and online softmax in f32, in the log2 domain (int8: S's
    // columns times their K scale first)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < TK / 2; ++e) {
      const int h = (e >> 1) & 1;
      const int kj = k0 + 8 * (e >> 2) + 2 * (lane % 4) + (e & 1);
      float x = sc[e] * (kcol[e >> 2] * scale);
      if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
      x *= LOG2E;
      if (!(valid[h] && kj <= qpos[h] &&
            (window <= 0 || kj > qpos[h] - window)))
        x = -INFINITY;
      sc[e] = x;
      mx[h] = fmaxf(mx[h], x);
    }
    float corr[2], base[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], hopper::quad_max(mx[h]));
      // m_new == -inf: no key of this row visible yet; P is 0, keep state
      corr[h] = m_new == -INFINITY ? 1.f : exp2f(m[h] - m_new);
      base[h] = m_new == -INFINITY ? 0.f : m_new;
      m[h] = m_new;
      l[h] *= corr[h];
    }
    // l sums P; the copy of P that meets V carries V's column scales
#pragma unroll
    for (int e = 0; e < TK / 2; ++e) {
      sc[e] = exp2f(sc[e] - base[(e >> 1) & 1]);
      l[(e >> 1) & 1] += sc[e];                 // this thread's columns
      if constexpr (QUANT) sc[e] *= vcol[e >> 2];
    }
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] *= corr[(e >> 1) & 1];
    uint32_t pa[TK / 16][4];
    hopper::to_a_frags<TK>(sc, pa);

    // O += P V, P from registers, V transposed
    hopper::pin(acc);
    hopper::pin(pa);
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
      hopper::wgmma_rs(acc, pa[kk], hopper::mnmajor<D>(Vt, TK, kk), 1);
    hopper::wg_commit();
    hopper::wg_wait<0>();
    hopper::pin(acc);
    hopper::mbar_arrive(QUANT ? &bempty[s] : &empty[s]);
  }

  // epilogue: normalise; padding rows and idle slots write zeros; each
  // window slot naming a row's token gets the row again
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 16 * warp + lane / 4 + 8 * h;
    const float lsum = hopper::quad_sum(l[h]);
    if (r >= CG) continue;
    const float inv = valid[h] && lsum > 0.f ? 1.f / lsum : 0.f;
    const int head = kh * G + r % G;
    __nv_bfloat162 v[D / 8];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      v[j] = __floats2bfloat162_rn(acc[4 * j + 2 * h] * inv,
                                   acc[4 * j + 2 * h + 1] * inv);
    __nv_bfloat16* orow = out + ((size_t)(b * C + tok[h]) * H + head) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * (lane % 4)) =
          v[j];
    for (int sw = 0; sw < S_w; ++sw) {
      if (widx[(size_t)b * S_w + sw] != tok[h]) continue;
      __nv_bfloat16* wrow =
          out_win + ((size_t)(b * S_w + sw) * H + head) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(wrow + 8 * j + 2 * (lane % 4)) =
            v[j];
    }
  }
}

// Tensor maps: q as (d, g, kv head, token, slot), the pools as (d, kv head,
// page row).  bf16 pools: boxes of CW columns, swizzled as the kernel's
// tiles are; int8 pools: unswizzled boxes of a whole page row (the
// converter writes the swizzled bf16 tiles).
template <int D, bool QUANT>
cudaError_t launch_tc(const Args& a, cudaStream_t stream) {
  using TL = hopper::Tiles<D>;
  const int G = a.H / a.KH;
  CUtensorMap tq, tk, tv;
  const cuuint64_t qd[5] = {(cuuint64_t)D, (cuuint64_t)G, (cuuint64_t)a.KH,
                            (cuuint64_t)a.C, (cuuint64_t)a.B};
  const cuuint64_t qs[4] = {(cuuint64_t)D * 2, (cuuint64_t)G * D * 2,
                            (cuuint64_t)a.H * D * 2,
                            (cuuint64_t)a.C * a.H * D * 2};
  const cuuint32_t qb[5] = {(cuuint32_t)TL::CW, (cuuint32_t)G, 1,
                            (cuuint32_t)(TQ / G), 1};
  constexpr int EB = QUANT ? 1 : 2;            // bytes a pool element
  const cuuint64_t pd[3] = {(cuuint64_t)D, (cuuint64_t)a.KH,
                            (cuuint64_t)a.P * a.psize};
  const cuuint64_t ps[2] = {(cuuint64_t)D * EB, (cuuint64_t)a.KH * D * EB};
  const cuuint32_t pb[3] = {(cuuint32_t)(QUANT ? D : TL::CW), 1,
                            (cuuint32_t)a.psize};
  const CUtensorMapDataType pt = QUANT ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const int psw = QUANT ? 0 : TL::SW;
  if (!hopper::make_map(&tq, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, a.q, qd,
                        qs, qb, TL::SW) ||
      !hopper::make_map(&tk, pt, 3, a.k, pd, ps, pb, psw) ||
      !hopper::make_map(&tv, pt, 3, a.v, pd, ps, pb, psw))
    return cudaErrorInvalidValue;
  auto kernel = paged_chunk_tc_kernel<D, QUANT>;
  constexpr size_t smem = TcLayout<D, QUANT>::SMEM;
  cudaError_t err = hopper::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.C * G + TQ - 1) / TQ, a.KH, a.B);
  kernel<<<grid, TcLayout<D, QUANT>::THREADS, smem, stream>>>(
      tq, tk, tv, a.ks, a.vs, a.bt, a.starts, a.clens, a.widx,
      static_cast<__nv_bfloat16*>(a.out),
      static_cast<__nv_bfloat16*>(a.out_win), a.C, a.H, a.KH, a.psize,
      a.maxp, a.P, a.S_w, a.scale, a.window, a.softcap);
  return cudaGetLastError();
}

template <bool QUANT>
cudaError_t dispatch_tc(const Args& a, cudaStream_t s) {
  switch (a.D) {
    case 32: return launch_tc<32, QUANT>(a, s);
    case 64: return launch_tc<64, QUANT>(a, s);
    case 96: return launch_tc<96, QUANT>(a, s);
    default: return launch_tc<128, QUANT>(a, s);
  }
}

// the shapes the tensor-core kernel takes (kernel.py::chunk_route)
bool tc_takes(const Args& a) {
  const int G = a.H / a.KH;
  return (a.D == 32 || a.D == 64 || a.D == 96 || a.D == 128) &&
         (a.psize == 8 || a.psize == 16 || a.psize == 32 || a.psize == 64) &&
         G >= 1 && TQ % G == 0 && a.P > 0;
}

}  // namespace

// dtype (q and out): 0 = float32, 1 = bfloat16.  kv_int8: 0 = pools of
// q's dtype (scales unused, may be null), 1 = int8 pools with [P, KH] f32
// scales.  route (kernel.py::CHUNK_ROUTES): 0 = the CUDA-core kernel, 1 =
// the tensor-core kernel on bf16 pools, 2 = the tensor-core kernel on int8
// pools (both bf16 q, the shapes tc_takes accepts).  window <= 0: none; softcap
// <= 0: none; S_w == 0: no window output (logit_index, out_win may be
// null).  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int paged_chunk_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* starts, const void* chunk_lens, void* out,
    const void* logit_index, void* out_win, int B, int C, int H, int KH,
    int D, int psize, int maxp, int P, int S_w, int route, float scale,
    int window, float softcap, int dtype, int kv_int8, void* stream) {
  const Args a{q, k_pages, v_pages,
               static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(block_tables),
               static_cast<const int*>(starts),
               static_cast<const int*>(chunk_lens),
               static_cast<const int*>(logit_index), out, out_win,
               B, C, H, KH, D, psize, maxp, P, S_w, scale, window, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || C == 0) return 0;
  cudaError_t err;
  if (route == 1 || route == 2) {
    if (dtype != 1 || kv_int8 != (route == 2) || !tc_takes(a))
      return static_cast<int>(cudaErrorInvalidValue);
    err = route == 2 ? dispatch_tc<true>(a, s) : dispatch_tc<false>(a, s);
  } else if (route != 0) {
    err = cudaErrorInvalidValue;
  } else if (dtype == 0 && !kv_int8) {
    err = dispatch_d<float, float>(a, s);
  } else if (dtype == 1 && !kv_int8) {
    err = dispatch_d<__nv_bfloat16, __nv_bfloat16>(a, s);
  } else if (dtype == 0) {
    err = dispatch_d<float, int8_t>(a, s);
  } else if (dtype == 1) {
    err = dispatch_d<__nv_bfloat16, int8_t>(a, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
