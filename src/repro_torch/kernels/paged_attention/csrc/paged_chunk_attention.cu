// Chunk-append attention over a block-paged KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py:169
// (_chunk_kernel) behind kernel.py:264 (paged_chunk_attention), with its
// f32/bf16 and int8 pool modes.  The fused logit_index epilogue of the TPU
// kernel is not ported (no caller passes it).
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
// Query row r of a (slot, kv head) pair is chunk token r / G, query head
// kh * G + r % G (G = H / KH), so the G heads sharing a kv head read each
// K/V element once, without repeating K/V.
//
// What bounds it on an H100: the bytes of the live K/V pages.  A decode tick
// does ~4 flops per K/V element read, far below the card's ~295 flops/byte
// balance point, so the floor is live K/V bytes / 3.35 TB/s.  What the
// design does about it: one block owns one (slot, kv head, group of query
// rows); it walks the slot's live keys in tiles of 32, copies each tile of
// K and V into shared memory once (16-byte cp.async copies, two stages, so
// the next tile is in flight while this one is consumed), and every query
// row of the block (all G grouped heads, up to ROWS chunk rows) reads it
// from there.  So each page is read once per (slot, kv head) block at
// decode, and once per row group of a prompt chunk.  Pages past the live
// length are never read, and the block table entry of a page is read only
// when the page is live: a stale or garbage entry there is never
// dereferenced.
//
// int8 pools: a tile row of D int8 is D / 16 copies of 16 bytes (not D / 8
// as for bf16), and the row stride pads 16 bytes as for the other types.
// Each lane loads the K and V scale of its key's page when it issues the
// tile, into registers; every K/V element is multiplied by its scale in f32
// right after it is read from shared memory.  The f32/bf16 instantiations
// compile without any of it.
//
// Masks: key kpos is visible to a row at position qpos when
// kpos < start + clen, kpos <= qpos and, with a window, kpos > qpos - window.
// Masked keys are skipped explicitly (probability 0, no max update), so a
// row whose first tiles are all masked (a sliding window shorter than the
// context) never computes exp(-inf - -inf).  Online softmax in f32.
//
// Launch: grid (ceil(C * G / ROWS), KH, B), NWARPS warps.  A warp owns
// ROWS / NWARPS rows (interleaved); a lane holds D / 32 elements of each
// row's accumulator.  Scores are computed one key per lane.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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
                             T* __restrict__ out, int C, int H, int KH,
                             int psize, int maxp, float scale, int window,
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
    T* o = out + ((size_t)(b * C + tok[i]) * H + kh * G + r % G) * D;
    const float inv = active[i] ? 1.f / fmaxf(l[i], 1e-30f) : 0.f;
#pragma unroll
    for (int e = 0; e < NE; ++e)
      o[lane + 32 * e] = from_f32<T>(active[i] ? acc[i][e] * inv : 0.f);
  }
}

template <typename T, typename KV, int D>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const float* k_scale, const float* v_scale,
                   const int* block_tables, const int* starts,
                   const int* chunk_lens, void* out, int B, int C, int H,
                   int KH, int psize, int maxp, float scale, int window,
                   float softcap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<KV, D>();
  auto kernel = paged_chunk_attention_kernel<T, KV, D>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int G = H / KH;
  dim3 grid((C * G + ROWS - 1) / ROWS, KH, B);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k_pages),
      static_cast<const KV*>(v_pages), k_scale, v_scale, block_tables,
      starts, chunk_lens, static_cast<T*>(out), C, H, KH, psize, maxp, scale,
      window, softcap);
  return cudaGetLastError();
}

template <typename T, typename KV>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const float* ks, const float* vs, const int* bt,
                       const int* st, const int* cl, void* o, int B, int C,
                       int H, int KH, int psize, int maxp, float scale,
                       int window, float softcap, cudaStream_t s) {
#define CASE(DD)                                                         \
  case DD:                                                               \
    return launch<T, KV, DD>(q, k, v, ks, vs, bt, st, cl, o, B, C, H, KH, \
                             psize, maxp, scale, window, softcap, s);
  switch (D) {
    CASE(32) CASE(64) CASE(96) CASE(128) CASE(160) CASE(192) CASE(224)
    CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef CASE
}

}  // namespace

// dtype (q and out): 0 = float32, 1 = bfloat16.  kv_int8: 0 = pools of
// q's dtype (scales unused, may be null), 1 = int8 pools with [P, KH] f32
// scales.  window <= 0: none; softcap <= 0: none.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int paged_chunk_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* starts, const void* chunk_lens, void* out, int B, int C,
    int H, int KH, int D, int psize, int maxp, float scale, int window,
    float softcap, int dtype, int kv_int8, void* stream) {
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* bt = static_cast<const int*>(block_tables);
  const int* st = static_cast<const int*>(starts);
  const int* cl = static_cast<const int*>(chunk_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || C == 0) return 0;
  cudaError_t err;
  if (dtype == 0 && !kv_int8)
    err = dispatch_d<float, float>(D, q, k_pages, v_pages, ks, vs, bt, st, cl,
                                   out, B, C, H, KH, psize, maxp, scale,
                                   window, softcap, s);
  else if (dtype == 1 && !kv_int8)
    err = dispatch_d<__nv_bfloat16, __nv_bfloat16>(
        D, q, k_pages, v_pages, ks, vs, bt, st, cl, out, B, C, H, KH, psize,
        maxp, scale, window, softcap, s);
  else if (dtype == 0)
    err = dispatch_d<float, int8_t>(D, q, k_pages, v_pages, ks, vs, bt, st,
                                    cl, out, B, C, H, KH, psize, maxp, scale,
                                    window, softcap, s);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16, int8_t>(
        D, q, k_pages, v_pages, ks, vs, bt, st, cl, out, B, C, H, KH, psize,
        maxp, scale, window, softcap, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
