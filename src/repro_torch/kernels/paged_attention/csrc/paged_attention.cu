// Decode attention over a block-paged KV pool, for Hopper (sm_90a): one
// query token per slot.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py:117
// (_kernel) behind kernel.py:349 (paged_attention), with its f32/bf16 and
// int8 pool modes.  The serving engine runs it on every tick whose chunk
// bucket is 1 (decode-only ticks); wider ticks run paged_chunk_attention.cu.
//
// Contract (the plain version is ref.py::paged_attention_ref):
//   q           [B, H, D]           f32 or bf16, one token per slot
//   k/v_pages   [P, psize, KH, D]   q's dtype, or int8 with k/v_scale
//   k/v_scale   [P, KH] f32         int8 pools only: element x of page p,
//                                   kv head h is x * scale[p, h]
//   block_tables[B, maxp] int32     only entries of live pages are read
//   lengths     [B] int32           valid KV tokens of each slot
//   out         [B, H, D]           q's dtype; a slot of length 0 gets 0
// Key kpos is visible when kpos < length and, with a window,
// kpos > length - 1 - window.  Optional tanh softcap.  Online softmax in
// f32.  G = H / KH query heads share each kv head, without repeating K/V.
//
// What bounds it on an H100: the bytes of the live K/V pages (~4 flops per
// element read; the card balances at ~295 flops a byte), so the floor is
// live K/V bytes / 3.35 TB/s.  What the design does about it: one block per
// (slot, kv head, R grouped query heads; R the largest of 8, 4, 2, 1 that
// divides G, a compile-time count), so each live K/V element is read from
// device memory once for R heads (once for all of them when G <= 8), and
// read from shared memory and converted once for all R rows.  The block's warps split
// the keys: warp w walks 32-key tiles w, w + NW, w + 2 NW, ... of the
// visible range with its own two-stage ring in shared memory (16-byte
// cp.async copies; the next tile flies while this one is consumed, and only
// __syncwarp orders a warp's ring), each lane scoring one key against every
// query row.  The NW partial softmax states (max, sum, accumulator) are
// merged through shared memory at the end.  NW is the most warps (up to 4)
// whose rings fit ~140 KB: 4 for bf16 and int8 at D 128, 2 for f32.  A split
// of one slot's pages over several blocks (flash-decoding), for the card's
// under-fill at small B * KH, is later work.
//
// int8 pools: a D = 128 row is 8 copies of 16 bytes (16 for bf16), and the
// row stride pads 16 bytes whatever the type.  Lane j loads the K and V
// scales of its key's page when it issues the tile; every K/V element is
// multiplied by its scale in f32 right after it is read from shared memory.
//
// Pages at or past ceil(length / psize) are never read, and their
// block-table entries are never dereferenced.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int KW = 32;        // keys per warp tile (one per lane)
constexpr int MAXG = 8;       // query rows (grouped heads) per block
constexpr int RING_BUDGET = 140 * 1024;   // shared bytes for the warps' rings

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
template <typename KV, int D>
__host__ __device__ constexpr int row_stride() {
  return D + 16 / (int)sizeof(KV);
}

// one warp's ring: two stages of a K and a V tile of KW keys
template <typename KV, int D>
__host__ __device__ constexpr int ring_bytes() {
  return (int)sizeof(KV) * 2 * 2 * KW * row_stride<KV, D>();
}

template <typename KV, int D>
__host__ __device__ constexpr int num_warps() {
  return RING_BUDGET / ring_bytes<KV, D>() < 1   ? 1
         : RING_BUDGET / ring_bytes<KV, D>() > 4 ? 4
                                                 : RING_BUDGET / ring_bytes<KV, D>();
}

template <typename KV, int D>
__host__ __device__ constexpr int smem_bytes() {
  // the rings, then the block's query rows in f32 (at most MAXG)
  return num_warps<KV, D>() * ring_bytes<KV, D>() + 4 * MAXG * D;
}

// N consecutive elements at p, as f32: one 4-, 8- or 16-byte shared load
// where the width allows it (p is then aligned to it), else one by one
template <typename KV, int N>
__device__ __forceinline__ void load_f32(const KV* p, float (&x)[N]) {
  constexpr int BYTES = N * (int)sizeof(KV);
  if constexpr (BYTES == 16 || BYTES == 8 || BYTES == 4) {
    using W = typename std::conditional<
        BYTES == 16, uint4,
        typename std::conditional<BYTES == 8, uint2, uint32_t>::type>::type;
    const W raw = *reinterpret_cast<const W*>(p);
    const KV* v = reinterpret_cast<const KV*>(&raw);
#pragma unroll
    for (int e = 0; e < N; ++e) x[e] = to_f32(v[e]);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) x[e] = to_f32(p[e]);
  }
}

// R: query rows (grouped heads) per block, a compile-time count that
// divides G, so no row of a block is ever padding
template <typename T, typename KV, int D, int R>
__global__ void __launch_bounds__(32 * num_warps<KV, D>())
paged_attention_kernel(const T* __restrict__ q,
                       const KV* __restrict__ k_pages,
                       const KV* __restrict__ v_pages,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       int H, int KH, int psize, int maxp, float scale,
                       int window, float softcap) {
  constexpr bool QUANT = std::is_same<KV, int8_t>::value;
  constexpr int NW = num_warps<KV, D>();
  constexpr int NT = 32 * NW;
  constexpr int NE = D / 32;                 // dims a lane owns in P V
  constexpr int VEC = 16 / sizeof(KV);       // elements a 16-byte copy
  constexpr int RS = row_stride<KV, D>();
  constexpr int CPR = D / VEC;               // 16-byte chunks a key row,
                                             // so CPR copies a lane a tile
  // the merge reuses the rings: [NW][R] max and sum, [NW][R][D] acc
  static_assert(4 * NW * MAXG * (D + 2) <= NW * ring_bytes<KV, D>(),
                "merge buffers must fit in the rings");
  static_assert(R <= MAXG, "too many rows a block");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw + NW * ring_bytes<KV, D>());

  const int b = blockIdx.z, kh = blockIdx.y;
  const int G = H / KH;
  const int h0 = kh * G + blockIdx.x * R;    // the block's first query head
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int length = lengths[b];

  for (int i = threadIdx.x; i < R * D; i += NT)
    Qs[i] = to_f32(q[((size_t)b * H + h0) * D + i]);

  // visible keys [k_lo, k_hi] (empty when length == 0), in 32-key tiles
  const int k_hi = length - 1;
  const int k_lo = window > 0 ? max(0, length - window) : 0;
  const int ntiles = length > 0 ? (k_hi - k_lo) / KW + 1 : 0;

  KV* ring = reinterpret_cast<KV*>(smem_raw) + warp * (2 * 2 * KW * RS);
  // copy the K/V rows of tile t into stage st of this warp's ring; keys past
  // k_hi are zero-filled and only live pages' table entries are read.
  // int8: lane j also loads the scales of the tile's key j into nks / nvs
  float nks = 0.f, nvs = 0.f;
  auto issue_tile = [&](int t, int st) {
    const int k0 = k_lo + t * KW;
    KV* Kt = ring + st * 2 * KW * RS;
    KV* Vt = Kt + KW * RS;
#pragma unroll
    for (int i = 0; i < CPR; ++i) {
      const int c = lane + 32 * i;
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

  float m[R], l[R], acc[R][NE];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[i][e] = 0.f;
  }

  if (warp < ntiles) issue_tile(warp, 0);
  __syncthreads();                                 // Qs written
  int st = 0;
  for (int t = warp; t < ntiles; t += NW, st ^= 1) {
    const float cks = nks, cvs = nvs;              // this tile's scales
    if (t + NW < ntiles) {
      issue_tile(t + NW, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const KV* Kt = ring + st * 2 * KW * RS;
    const KV* Vt = Kt + KW * RS;

    // scores: lane j holds key k_lo + t * KW + j for every query row; each
    // K element is read and converted once for all R rows
    float s[R];
#pragma unroll
    for (int i = 0; i < R; ++i) s[i] = 0.f;
    const KV* kr = Kt + lane * RS;
#pragma unroll 2
    for (int d = 0; d < D; d += VEC) {
      float kx[VEC];
      load_f32<KV, VEC>(kr + d, kx);
#pragma unroll
      for (int e4 = 0; e4 < VEC; e4 += 4) {
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(
              Qs + i * D + d + e4);
          float k0 = kx[e4], k1 = kx[e4 + 1], k2 = kx[e4 + 2],
                k3 = kx[e4 + 3];
          if constexpr (QUANT) {
            k0 *= cks;
            k1 *= cks;
            k2 *= cks;
            k3 *= cks;
          }
          s[i] = fmaf(qv.x, k0, s[i]);
          s[i] = fmaf(qv.y, k1, s[i]);
          s[i] = fmaf(qv.z, k2, s[i]);
          s[i] = fmaf(qv.w, k3, s[i]);
        }
      }
    }
    // the tile's first key is visible (t < ntiles), so every row has a
    // finite maximum; keys past k_hi get probability 0
    const bool ok = k_lo + t * KW + lane <= k_hi;
    float p[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float sc = s[i] * scale;
      if (softcap > 0.f) sc = tanhf(sc / softcap) * softcap;
      const float m_new = fmaxf(m[i], warp_max(ok ? sc : -INFINITY));
      const float corr = expf(m[i] - m_new);
      p[i] = ok ? expf(sc - m_new) : 0.f;
      l[i] = l[i] * corr + warp_sum(p[i]);
#pragma unroll
      for (int e = 0; e < NE; ++e) acc[i][e] *= corr;
      m[i] = m_new;
    }
    // P V: lane owns dims [lane * NE, lane * NE + NE); each V row is read
    // once for all R rows
#pragma unroll 4
    for (int j = 0; j < KW; ++j) {
      float vx[NE];
      load_f32<KV, NE>(Vt + j * RS + lane * NE, vx);
      if constexpr (QUANT) {
        const float vsj = __shfl_sync(0xffffffffu, cvs, j);
#pragma unroll
        for (int e = 0; e < NE; ++e) vx[e] *= vsj;
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float pj = __shfl_sync(0xffffffffu, p[i], j);
#pragma unroll
        for (int e = 0; e < NE; ++e) acc[i][e] = fmaf(pj, vx[e], acc[i][e]);
      }
    }
    __syncwarp();                      // stage st is refilled next turn
  }

  // merge the warps' partial states through shared memory (the rings are
  // free once every warp has left its loop)
  __syncthreads();
  float* Ms = reinterpret_cast<float*>(smem_raw);  // [NW][R]
  float* Ls = Ms + NW * R;                         // [NW][R]
  float* As = Ls + NW * R;                         // [NW][R][D]
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (lane == 0) {
      Ms[warp * R + i] = m[i];
      Ls[warp * R + i] = l[i];
    }
#pragma unroll
    for (int e = 0; e < NE; ++e)
      As[(warp * R + i) * D + lane * NE + e] = acc[i][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * D; idx += NT) {
    const int i = idx / D, d = idx % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, Ms[w * R + i]);
    float lsum = 0.f, a = 0.f;
    if (mx != -INFINITY) {                 // length 0: every warp is empty
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float f = expf(Ms[w * R + i] - mx);
        lsum += Ls[w * R + i] * f;
        a += As[(w * R + i) * D + d] * f;
      }
    }
    out[((size_t)b * H + h0 + i) * D + d] =
        from_f32<T>(mx != -INFINITY ? a / fmaxf(lsum, 1e-30f) : 0.f);
  }
}

template <typename T, typename KV, int D, int R>
cudaError_t launch_rows(const void* q, const void* k_pages,
                        const void* v_pages, const float* k_scale,
                        const float* v_scale, const int* block_tables,
                        const int* lengths, void* out, int B, int H, int KH,
                        int psize, int maxp, float scale, int window,
                        float softcap, cudaStream_t stream) {
  constexpr int smem = smem_bytes<KV, D>();
  constexpr int nt = 32 * num_warps<KV, D>();
  auto kernel = paged_attention_kernel<T, KV, D, R>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(H / KH / R, KH, B);
  kernel<<<grid, nt, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k_pages),
      static_cast<const KV*>(v_pages), k_scale, v_scale, block_tables,
      lengths, static_cast<T*>(out), H, KH, psize, maxp, scale, window,
      softcap);
  return cudaGetLastError();
}

// rows a block: the largest of 8, 4, 2, 1 that divides G
template <typename T, typename KV, int D>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const float* k_scale, const float* v_scale,
                   const int* block_tables, const int* lengths, void* out,
                   int B, int H, int KH, int psize, int maxp, float scale,
                   int window, float softcap, cudaStream_t stream) {
  const int G = H / KH;
#define ROWS(RR)                                                            \
  return launch_rows<T, KV, D, RR>(q, k_pages, v_pages, k_scale, v_scale,   \
                                   block_tables, lengths, out, B, H, KH,    \
                                   psize, maxp, scale, window, softcap,     \
                                   stream);
  if (G % 8 == 0) ROWS(8)
  if (G % 4 == 0) ROWS(4)
  if (G % 2 == 0) ROWS(2)
  ROWS(1)
#undef ROWS
}

template <typename T, typename KV>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const float* ks, const float* vs, const int* bt,
                       const int* len, void* o, int B, int H, int KH,
                       int psize, int maxp, float scale, int window,
                       float softcap, cudaStream_t s) {
#define CASE(DD)                                                        \
  case DD:                                                              \
    return launch<T, KV, DD>(q, k, v, ks, vs, bt, len, o, B, H, KH,      \
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
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* lengths, void* out, int B, int H, int KH, int D, int psize,
    int maxp, float scale, int window, float softcap, int dtype, int kv_int8,
    void* stream) {
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* bt = static_cast<const int*>(block_tables);
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  cudaError_t err;
  if (dtype == 0 && !kv_int8)
    err = dispatch_d<float, float>(D, q, k_pages, v_pages, ks, vs, bt, len,
                                   out, B, H, KH, psize, maxp, scale, window,
                                   softcap, s);
  else if (dtype == 1 && !kv_int8)
    err = dispatch_d<__nv_bfloat16, __nv_bfloat16>(
        D, q, k_pages, v_pages, ks, vs, bt, len, out, B, H, KH, psize, maxp,
        scale, window, softcap, s);
  else if (dtype == 0)
    err = dispatch_d<float, int8_t>(D, q, k_pages, v_pages, ks, vs, bt, len,
                                    out, B, H, KH, psize, maxp, scale, window,
                                    softcap, s);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16, int8_t>(
        D, q, k_pages, v_pages, ks, vs, bt, len, out, B, H, KH, psize, maxp,
        scale, window, softcap, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
