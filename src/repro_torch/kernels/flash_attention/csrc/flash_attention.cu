// Blocked attention with an f32 online softmax, forward and backward, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:85
// (flash_attention; body _kernel at :30).  The TPU kernel has no backward;
// training needs one, so the FlashAttention-2 backward is written here too.
//
// Contract (the plain version is ref.py::attention_ref, whose autograd is the
// backward's reference):
//   q [B, H, Sq, D]; k, v [B, KH, Skv, D]; H = KH * G, q head h reads kv head
//   h / G.  f32 or bf16, all of one type, contiguous.
//   Key j is visible to query row i when j < Skv, and j <= i if causal, and
//   j > i - window if a window is given.  Scores are q.k * scale, then
//   tanh(s / softcap) * softcap if a softcap is given.
//   Forward:  o [B, H, Sq, D] in q's type, and the row log-sum-exp
//             lse [B, H, Sq] in f32 (natural log, of the capped scores).
//   Backward: from q, k, v, o, lse and dO, writes dq, dk, dv in q's type.
//             Di = rowsum(dO * O); P = exp(s - lse) recomputed;
//             dV = P^T dO; dS = P * (dP - Di) * (1 - tanh^2 if softcapped);
//             dQ = dS K * scale; dK = dS^T Q * scale.  Masked entries have
//             P = 0 and so contribute exactly 0.
//   Every query row must see at least one key (the wrapper refuses shapes
//   where a window leaves a row without any).
//
// What bounds it on an H100: at the training shape (B 8, S 1024, H 16, D
// 128, causal) the work is operations: 4 * D flops per (row, visible key)
// forward (34.4 GFLOP against 1.6e8 bytes), five products of that size
// backward.  Only the tensor cores reach the card's bf16 rate (989 TFLOP/s,
// against 67 TFLOP/s of f32 FMAs), and only through wgmma.  So:
//
// bf16 (every head dim): tensor-core kernels, all products wgmma.
//   forward  grid (ceil(Sq / 128), H, B), 256 threads: one block per (b, q
//            head, 128-row q tile), two warpgroups of 64 rows.  Thread 0
//            copies Q once and 128-key (64-key at D 256) K/V tiles by TMA
//            (3-d tensor maps,
//            128-byte swizzle where D is a multiple of 64, else 64-byte)
//            into a two-stage ring ordered by mbarriers: tile j + 1 is in
//            flight while tile j is computed, and a stage is refilled only
//            after all 256 threads released it.  S = Q K^T is a wgmma with
//            both operands in shared memory and f32 accumulators; the online
//            softmax (scale, softcap, mask, row max and sum, in the log2
//            domain) runs on those registers; P is rounded to bf16 in
//            registers, whose layout is the A-fragment layout of the next
//            wgmma, O += P V, with V read transposed from shared memory.
//            Only tiles that cross the diagonal, a window edge or a ragged
//            end apply the mask (a branch uniform across the block); tiles
//            that the mask hides entirely are never loaded.
//   backward three kernels on the stream, deterministic (no atomics):
//            1. Di = rowsum(dO * O), one warp per row (the CUDA cores: it
//               is a reduction, not a product);
//            2. dK, dV: grid (ceil(Skv / 64), KH, B), one warpgroup per
//               (b, kv head, 64-key tile) holding K and V, with Q and dO
//               tiles of the G query heads streamed through the TMA ring:
//               S^T = K Q^T and dP^T = V dO^T (wgmma, shared-memory
//               operands), P^T and dS^T formed in f32 registers and rounded
//               once to bf16, then dV += P^T dO and dK += dS^T Q with them
//               as register A operands; the group sums in registers;
//            3. dQ: grid (ceil(Sq / 64), H, B), one warpgroup per (b, q
//               head, 64-row q tile) holding Q and dO, K and V streamed:
//               S and dP again, then dQ += dS K.
//            The recompute of S and dP in the dQ pass is the price of no
//            atomics: 7 products of 2 * D flops per visible (row, key) pair
//            where 5 would do, 1.4x the backward's minimum.
//   D 256    the same algorithm in tiles that fit a block's 227 KB of
//            shared memory and 255 registers a thread: the forward's K/V
//            tiles hold 64 keys (Q 64 KB + two stages of K and V, 4 x 32
//            KB), and its P V product runs as two of 128 columns.  In the
//            backward one warpgroup would need 256 registers a thread for
//            dK and dV alone, so two warpgroups split D (128 columns of
//            dK/dV, or of dQ, each) and share the score products through
//            shared memory (flash_bwd_*_split_kernel).
//   Tensor maps are built on the host per launch (see make_map); rows past
//   a head's end read as zeros and the mask hides keys at or past Skv.
//
// f32: the CUDA-core kernels (no tensor-core path computes f32 products in
//   full f32).  Each block stages 64-row tiles in shared memory (32-row
//   tiles in the backward at D 256, where four 64-row ones take 266 KB)
//   and every thread computes a 4 x 8 (2 x 4) register tile of scores
//   (rows ty + 16 i, columns tx + 8 j), so each shared-memory read feeds
//   several FMAs; tile rows are padded so those reads are free of bank
//   conflicts; whole tiles that the causal mask or the window hide are
//   never loaded.
//   forward  grid (ceil(Sq / 64), H, B): one block per (b, q head, q tile),
//            walking the visible K/V tiles with an online softmax.  A row
//            whose visible keys all lie in later tiles keeps m = -inf and
//            skips the rescale, so exp(-inf - -inf) never happens.
//   backward Di as above; dK, dV one block per (b, kv head, key tile)
//            looping over the G query heads; dQ a second pass that
//            recomputes P and dS per (b, q head, q tile).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// the Hopper building blocks (mbarriers, TMA, wgmma descriptors and
// products, tensor maps) shared with the other tensor-core kernels
using namespace hopper;

constexpr int TILE = 64;        // rows (queries or keys) of a tile
constexpr int NT = 128;         // threads a block: 16 row groups x 8 lanes
constexpr int R = TILE / 16;    // tile rows a thread owns: ty + 16 i
constexpr int C = TILE / 8;     // tile columns a thread owns: tx + 8 j
constexpr int PS = TILE + 1;    // row stride of an f32 score tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

// reductions over the 8 lanes (tx = 0..7) that share a row group
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// A tile row holds D elements plus 16 bytes of padding: the rows that the 8
// (or 4) distinct addresses of a warp's read fall on map to distinct banks.
template <typename T, int D>
__host__ __device__ constexpr int row_stride() {
  return D + 16 / (int)sizeof(T);
}

// Issue the copies of rows [r0, r0 + TL) of a [rows, D] matrix into a
// [TL][row_stride] tile; rows past ``rows`` are zero-filled, not read.
template <typename T, int D, int TL = TILE>
__device__ __forceinline__ void load_tile(T* tile, const T* src, int r0,
                                          int rows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = D / VEC;                 // 16-byte chunks a row
  constexpr int RS = row_stride<T, D>();
  for (int c = threadIdx.x; c < TL * CPR; c += NT) {
    const int r = c / CPR, d = (c % CPR) * VEC;
    const bool ok = r0 + r < rows;
    cp_async16(tile + r * RS + d, ok ? src + (size_t)(r0 + r) * D + d : src,
               ok ? 16 : 0);
  }
}

__device__ __forceinline__ bool visible(int qi, int kj, int Sq, int Skv,
                                        int causal, int window) {
  return qi < Sq && kj < Skv && (!causal || kj <= qi) &&
         (window <= 0 || kj > qi - window);
}

// capped score of a raw dot product; *dcap gets d(capped)/d(scaled)
__device__ __forceinline__ float cap_score(float dot, float scale,
                                           float softcap, float* dcap) {
  const float x = dot * scale;
  if (softcap > 0.f) {
    const float t = tanhf(x / softcap);
    *dcap = 1.f - t * t;
    return t * softcap;
  }
  *dcap = 1.f;
  return x;
}

template <typename T, int D>
constexpr size_t fwd_smem() {
  // K and V tiles in T, the query tile in f32 (rows of D + 1), P in f32
  return sizeof(T) * 2 * TILE * row_stride<T, D>() +
         sizeof(float) * (TILE * (D + 1) + TILE * PS);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int KH, int Sq, int Skv,
                 float scale, int causal, int window, float softcap) {
  constexpr int RS = row_stride<T, D>();
  constexpr int QS = D + 1;
  constexpr int NE = D / 8;                    // output columns tx + 8 e
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + TILE * RS;
  float* Qs = reinterpret_cast<float*>(Vs + TILE * RS);
  float* Ps = Qs + TILE * QS;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * TILE;
  const int kh = h / (H / KH);
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  const size_t bh = (size_t)b * H + h;
  const T* kb = k + ((size_t)b * KH + kh) * Skv * D;
  const T* vb = v + ((size_t)b * KH + kh) * Skv * D;

  for (int i = threadIdx.x; i < TILE * D; i += NT) {
    const int r = i / D, d = i % D;
    Qs[r * QS + d] =
        q0 + r < Sq ? to_f32(q[(bh * Sq + q0 + r) * D + d]) : 0.f;
  }

  // keys any row of this tile can see
  const int q_last = min(q0 + TILE, Sq) - 1;
  const int k_end = causal ? min(Skv, q_last + 1) : Skv;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;

  float m[R], l[R], acc[R][NE];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[i][e] = 0.f;
  }

  for (int k0 = k_begin / TILE * TILE; k0 < k_end; k0 += TILE) {
    __syncthreads();                 // the last tile's K, V and P are read
    load_tile<T, D>(Ks, kb, k0, Skv);
    load_tile<T, D>(Vs, vb, k0, Skv);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    float s[R][C];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[R], kv[C];
#pragma unroll
      for (int i = 0; i < R; ++i) qv[i] = Qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < C; ++j) kv[j] = to_f32(Ks[(tx + 8 * j) * RS + d]);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qi = q0 + ty + 16 * i;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        float dcap;
        const float x = cap_score(s[i][j], scale, softcap, &dcap);
        s[i][j] = visible(qi, k0 + tx + 8 * j, Sq, Skv, causal, window)
                      ? x : -INFINITY;
        tmax = fmaxf(tmax, s[i][j]);
      }
      tmax = group_max(tmax);
      const float m_new = fmaxf(m[i], tmax);
      // m_new == -inf: no key of this row visible yet; P is 0, keep state
      const float corr = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * PS + tx + 8 * j] = p;
        psum += p;
      }
      l[i] = l[i] * corr + group_sum(psum);
#pragma unroll
      for (int e = 0; e < NE; ++e) acc[i][e] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < TILE; ++j) {
      float pv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) pv[i] = Ps[(ty + 16 * i) * PS + j];
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const float vv = to_f32(Vs[j * RS + tx + 8 * e]);
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][e] = fmaf(pv[i], vv, acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* orow = o + (bh * Sq + qi) * D;
#pragma unroll
    for (int e = 0; e < NE; ++e) orow[tx + 8 * e] = from_f32<T>(acc[i][e] * inv);
    if (tx == 0) lse[bh * Sq + qi] = l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
  }
}

// Di = rowsum(dO * O) in f32, one warp per row of [rows, D]
template <typename T>
__global__ void __launch_bounds__(NT)
flash_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                     float* __restrict__ di, int rows, int D) {
  const int row = blockIdx.x * (NT / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;                     // the whole warp
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(to_f32(o[(size_t)row * D + d]),
               to_f32(dout[(size_t)row * D + d]), acc);
  acc = warp_sum(acc);
  if (lane == 0) di[row] = acc;
}

// Rows of the backward's f32 tiles: 64, or 32 at D 256, where four 64-row
// tiles of D + 4 floats (266 KB) would not fit the 227 KB of a block.
template <int D>
__host__ __device__ constexpr int bwd_rows() {
  return D > 128 ? 32 : TILE;
}

template <typename T, int D>
constexpr size_t dkdv_smem() {
  // K, V, Q, dO tiles in T; P and dS tiles in f32; lse and Di of the q tile
  constexpr int TL = bwd_rows<D>(), TPS = TL + 1;
  return sizeof(T) * 4 * TL * row_stride<T, D>() +
         sizeof(float) * (2 * TL * TPS + 2 * TL);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ di, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int KH, int Sq, int Skv,
                      float scale, int causal, int window, float softcap) {
  constexpr int TL = bwd_rows<D>();            // rows of a tile
  constexpr int TR = TL / 16, TC = TL / 8, TPS = TL + 1;
  constexpr int RS = row_stride<T, D>();
  constexpr int NE = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + TL * RS;
  T* Qs = Vs + TL * RS;
  T* dOs = Qs + TL * RS;
  float* Pt = reinterpret_cast<float*>(dOs + TL * RS);     // [key][query]
  float* dSt = Pt + TL * TPS;
  float* Ls = dSt + TL * TPS;
  float* Ds = Ls + TL;

  const int b = blockIdx.z, kh = blockIdx.y, k0 = blockIdx.x * TL;
  const int G = H / KH;
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  const size_t bkh = (size_t)b * KH + kh;
  load_tile<T, D, TL>(Ks, k + bkh * Skv * D, k0, Skv);
  load_tile<T, D, TL>(Vs, v + bkh * Skv * D, k0, Skv);
  cp_async_commit();

  // query rows that can see any key of this tile
  const int k_last = min(k0 + TL, Skv) - 1;
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(Sq, k_last + window) : Sq;

  float dk_acc[TR][NE], dv_acc[TR][NE];        // key rows ty + 16 i
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int e = 0; e < NE; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  for (int g = 0; g < G; ++g) {
    const size_t bh = (size_t)b * H + kh * G + g;
    for (int q0 = q_begin / TL * TL; q0 < q_end; q0 += TL) {
      __syncthreads();               // the last q tile's Q, dO, P, dS read
      load_tile<T, D, TL>(Qs, q + bh * Sq * D, q0, Sq);
      load_tile<T, D, TL>(dOs, dout + bh * Sq * D, q0, Sq);
      cp_async_commit();
      for (int r = threadIdx.x; r < TL; r += NT) {
        Ls[r] = q0 + r < Sq ? lse[bh * Sq + q0 + r] : 0.f;
        Ds[r] = q0 + r < Sq ? di[bh * Sq + q0 + r] : 0.f;
      }
      cp_async_wait_all();
      __syncthreads();

      // S^T and dP^T: rows are keys ty + 16 i, columns queries tx + 8 j
      float s[TR][TC], dp[TR][TC];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < D; ++d) {
        float kr[TR], vr[TR], qc[TC], oc[TC];
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          kr[i] = to_f32(Ks[(ty + 16 * i) * RS + d]);
          vr[i] = to_f32(Vs[(ty + 16 * i) * RS + d]);
        }
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          qc[j] = to_f32(Qs[(tx + 8 * j) * RS + d]);
          oc[j] = to_f32(dOs[(tx + 8 * j) * RS + d]);
        }
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int j = 0; j < TC; ++j) {
            s[i][j] = fmaf(kr[i], qc[j], s[i][j]);
            dp[i][j] = fmaf(vr[i], oc[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          const int qj = tx + 8 * j;
          float dcap;
          const float x = cap_score(s[i][j], scale, softcap, &dcap);
          const float p = visible(q0 + qj, k0 + ty + 16 * i, Sq, Skv, causal,
                                  window) ? expf(x - Ls[qj]) : 0.f;
          Pt[(ty + 16 * i) * TPS + qj] = p;
          dSt[(ty + 16 * i) * TPS + qj] = p * (dp[i][j] - Ds[qj]) * dcap;
        }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q over this tile's queries
#pragma unroll 2
      for (int j = 0; j < TL; ++j) {
        float pr[TR], sr[TR];
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          pr[i] = Pt[(ty + 16 * i) * TPS + j];
          sr[i] = dSt[(ty + 16 * i) * TPS + j];
        }
#pragma unroll
        for (int e = 0; e < NE; ++e) {
          const float oo = to_f32(dOs[j * RS + tx + 8 * e]);
          const float qq = to_f32(Qs[j * RS + tx + 8 * e]);
#pragma unroll
          for (int i = 0; i < TR; ++i) {
            dv_acc[i][e] = fmaf(pr[i], oo, dv_acc[i][e]);
            dk_acc[i][e] = fmaf(sr[i], qq, dk_acc[i][e]);
          }
        }
      }
    }
  }
  cp_async_wait_all();               // no copy outlives the block

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= Skv) continue;
    T* dkrow = dk + (bkh * Skv + kj) * D;
    T* dvrow = dv + (bkh * Skv + kj) * D;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      dkrow[tx + 8 * e] = from_f32<T>(dk_acc[i][e] * scale);
      dvrow[tx + 8 * e] = from_f32<T>(dv_acc[i][e]);
    }
  }
}

template <typename T, int D>
constexpr size_t dq_smem() {
  // Q, dO, K, V tiles in T; the dS tile in f32
  constexpr int TL = bwd_rows<D>(), TPS = TL + 1;
  return sizeof(T) * 4 * TL * row_stride<T, D>() +
         sizeof(float) * TL * TPS;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ di, T* __restrict__ dq, int H,
                    int KH, int Sq, int Skv, float scale, int causal,
                    int window, float softcap) {
  constexpr int TL = bwd_rows<D>();            // rows of a tile
  constexpr int TR = TL / 16, TC = TL / 8, TPS = TL + 1;
  constexpr int RS = row_stride<T, D>();
  constexpr int NE = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + TL * RS;
  T* Ks = dOs + TL * RS;
  T* Vs = Ks + TL * RS;
  float* dSs = reinterpret_cast<float*>(Vs + TL * RS);     // [query][key]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * TL;
  const int kh = h / (H / KH);
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  const size_t bh = (size_t)b * H + h;
  const T* kb = k + ((size_t)b * KH + kh) * Skv * D;
  const T* vb = v + ((size_t)b * KH + kh) * Skv * D;
  load_tile<T, D, TL>(Qs, q + bh * Sq * D, q0, Sq);
  load_tile<T, D, TL>(dOs, dout + bh * Sq * D, q0, Sq);
  cp_async_commit();

  float lr[TR], dr[TR];                        // query rows ty + 16 i
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int qi = q0 + ty + 16 * i;
    lr[i] = qi < Sq ? lse[bh * Sq + qi] : 0.f;
    dr[i] = qi < Sq ? di[bh * Sq + qi] : 0.f;
  }
  const int q_last = min(q0 + TL, Sq) - 1;
  const int k_end = causal ? min(Skv, q_last + 1) : Skv;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;

  float dq_acc[TR][NE];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int e = 0; e < NE; ++e) dq_acc[i][e] = 0.f;

  for (int k0 = k_begin / TL * TL; k0 < k_end; k0 += TL) {
    __syncthreads();                 // the last tile's K and dS are read
    load_tile<T, D, TL>(Ks, kb, k0, Skv);
    load_tile<T, D, TL>(Vs, vb, k0, Skv);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    // S and dP: rows are queries ty + 16 i, columns keys tx + 8 j
    float s[TR][TC], dp[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qr[TR], orr[TR], kc[TC], vc[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        qr[i] = to_f32(Qs[(ty + 16 * i) * RS + d]);
        orr[i] = to_f32(dOs[(ty + 16 * i) * RS + d]);
      }
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        kc[j] = to_f32(Ks[(tx + 8 * j) * RS + d]);
        vc[j] = to_f32(Vs[(tx + 8 * j) * RS + d]);
      }
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          s[i][j] = fmaf(qr[i], kc[j], s[i][j]);
          dp[i][j] = fmaf(orr[i], vc[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        float dcap;
        const float x = cap_score(s[i][j], scale, softcap, &dcap);
        const float p = visible(q0 + ty + 16 * i, k0 + tx + 8 * j, Sq, Skv,
                                causal, window) ? expf(x - lr[i]) : 0.f;
        dSs[(ty + 16 * i) * TPS + tx + 8 * j] = p * (dp[i][j] - dr[i]) * dcap;
      }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < TL; ++j) {
      float sr[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i) sr[i] = dSs[(ty + 16 * i) * TPS + j];
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const float kk = to_f32(Ks[j * RS + tx + 8 * e]);
#pragma unroll
        for (int i = 0; i < TR; ++i)
          dq_acc[i][e] = fmaf(sr[i], kk, dq_acc[i][e]);
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
    T* dqrow = dq + (bh * Sq + qi) * D;
#pragma unroll
    for (int e = 0; e < NE; ++e) dqrow[tx + 8 * e] = from_f32<T>(dq_acc[i][e] * scale);
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels (wgmma fed by TMA)
// ---------------------------------------------------------------------------

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// The rows [row0, row0 + rows) of head ``head`` of a map, all chunks of a
// [rows][D] tile (hopper.cuh's Tiles: D / CW chunks of [rows][CW]).
template <int D>
__device__ __forceinline__ void tma_tile(uint8_t* tile, const CUtensorMap* map,
                                         uint64_t* bar, int rows, int row0,
                                         int head) {
#pragma unroll
  for (int c = 0; c < Tiles<D>::NCH; ++c)
    tma_load_3d(tile + c * rows * Tiles<D>::SW, map, bar, c * Tiles<D>::CW,
                row0, head);
}

// Can any (row, key) pair of the tile be hidden?  Uniform across the
// block: only such tiles (the diagonal, a window edge, ragged ends) pay
// for the mask.
__device__ __forceinline__ bool tile_masked(int q0, int bq, int k0, int bk,
                                            int Sq, int Skv, int causal,
                                            int window) {
  return k0 + bk > Skv || q0 + bq > Sq || (causal && k0 + bk - 1 > q0) ||
         (window > 0 && k0 <= q0 + bq - 1 - window);
}

// A two-stage ring of TMA tiles ordered by mbarriers: thread 0 issues the
// copies, every thread of the block releases a stage it has used.
struct Ring {
  uint64_t full[2], empty[2];
  __device__ void init(int consumers) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumers);
    }
  }
  // thread 0: claim the stage of the n-th tile (waiting until the tile two
  // before it is released) and announce ``bytes`` of copies into it
  __device__ uint64_t* produce(int n, uint32_t bytes) {
    const int s = n & 1;
    if (n >= 2) mbar_wait(&empty[s], ((n - 2) >> 1) & 1);
    mbar_expect_tx(&full[s], bytes);
    return &full[s];
  }
  __device__ void consume(int n) { mbar_wait(&full[n & 1], (n >> 1) & 1); }
  __device__ void release(int n) { mbar_arrive(&empty[n & 1]); }
};

// Forward: one block per (b, q head, 128-row q tile), two warpgroups of 64
// rows; K/V tiles of fwd_keys<D>() keys through the ring.
constexpr int FBM = 128, FNT = 256;

// Keys of a forward K/V tile: 128, or 64 at D 256, where the 64 KB q tile
// and two stages of 128-key K and V tiles (256 KB) would not fit the 227 KB
// of a block.  The O accumulator (D / 2 f32 a thread) then takes 128
// registers and the 64 x 64 score tile 32.
template <int D>
__host__ __device__ constexpr int fwd_keys() {
  return D > 128 ? 64 : 128;
}

template <int D>
constexpr size_t fwd_tc_smem() {
  return 1024 + 2 * (size_t)FBM * D + 4 * 2 * (size_t)fwd_keys<D>() * D;
}

// O[64 x D] += P[64 x 16] V[16 x D] at depth step kk, P in registers, V
// transposed in a shared-memory tile of ``rows`` rows.  Above 128 columns
// (one wgmma's widest n here) as products of 128 columns, two chunks of
// the tile each; a half's accumulator entries are the whole's in order.
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&acc)[D / 2],
                                         const uint32_t (&a)[4],
                                         const uint8_t* tile, int rows,
                                         int kk) {
  if constexpr (D <= 128) {
    wgmma_rs(acc, a, mnmajor<D>(tile, rows, kk), 1);
  } else {
#pragma unroll
    for (int c = 0; c < D / 128; ++c)
      wgmma_rs(*reinterpret_cast<float(*)[64]>(acc + 64 * c), a,
               mnmajor<D>(tile + 2 * c * rows * Tiles<D>::SW, rows, kk), 1);
  }
}

template <int D>
__global__ void __launch_bounds__(FNT, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int H, int KH, int Sq, int Skv, float scale, int causal,
                    int window, float softcap) {
  constexpr int FBN = fwd_keys<D>();
  constexpr int KV = 2 * FBN * D;              // bytes of a K or V tile
  extern __shared__ unsigned char smem_raw[];
  __shared__ Ring ring;
  __shared__ uint64_t qbar;
  uint8_t* Qs = align1024(smem_raw);
  uint8_t* Ks = Qs + 2 * FBM * D;              // stages at Ks + s * KV
  uint8_t* Vs = Ks + 2 * KV;

  const int tid = threadIdx.x, wg = tid / 128, warp = tid % 128 / 32;
  const int lane = tid % 32;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * FBM;
  const int bh = b * H + h, bkh = b * KH + h / (H / KH);
  const int q_last = min(q0 + FBM, Sq) - 1;
  const int k_end = causal ? min(Skv, q_last + 1) : Skv;
  const int kb0 = (window > 0 ? max(0, q0 - window + 1) : 0) / FBN * FBN;
  const int n = (k_end - kb0 + FBN - 1) / FBN;

  if (tid == 0) {
    ring.init(FNT);
    mbar_init(&qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&qbar, 2 * FBM * D);
    tma_tile<D>(Qs, &tq, &qbar, FBM, q0, bh);
    if (n > 0) {
      uint64_t* bar = ring.produce(0, 2 * KV);
      tma_tile<D>(Ks, &tk, bar, FBN, kb0, bkh);
      tma_tile<D>(Vs, &tv, bar, FBN, kb0, bkh);
    }
  }

  // this thread's two rows: r = 0 at ``row``, r = 1 at row + 8
  const int row = q0 + 64 * wg + 16 * warp + lane / 4;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  mbar_wait(&qbar, 0);

  for (int it = 0; it < n; ++it) {
    const int k0 = kb0 + it * FBN, s = it & 1;
    if (tid == 0 && it + 1 < n) {              // copy tile it + 1 meanwhile
      uint64_t* bar = ring.produce(it + 1, 2 * KV);
      tma_tile<D>(Ks + (s ^ 1) * KV, &tk, bar, FBN, k0 + FBN, bkh);
      tma_tile<D>(Vs + (s ^ 1) * KV, &tv, bar, FBN, k0 + FBN, bkh);
    }
    ring.consume(it);
    const uint8_t* Kt = Ks + s * KV;
    const uint8_t* Vt = Vs + s * KV;

    // S = Q K^T for this warpgroup's 64 rows; a score tile is live for
    // one key tile only, so it never shares registers with the next
    float sc[FBN / 2];
#pragma unroll
    for (int i = 0; i < FBN / 2; ++i) sc[i] = 0.f;
    pin(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(sc, kmajor<D>(Qs, FBM, 64 * wg, kk),
               kmajor<D>(Kt, FBN, 0, kk), kk > 0);
    wg_commit();
    wg_wait<0>();
    pin(sc);

    // online softmax in f32, in the log2 domain
    const bool masked =
        tile_masked(q0, FBM, k0, FBN, Sq, Skv, causal, window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < FBN / 2; ++e) {
      float x = sc[e] * scale;
      if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
      x *= LOG2E;
      if (masked) {
        const int qi = row + 8 * ((e >> 1) & 1);
        const int kj = k0 + 8 * (e >> 2) + 2 * (lane % 4) + (e & 1);
        if (!visible(qi, kj, Sq, Skv, causal, window)) x = -INFINITY;
      }
      sc[e] = x;
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], x);
    }
    float corr[2], base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      // m_new == -inf: no key of this row visible yet; P is 0, keep state
      corr[r] = m_new == -INFINITY ? 1.f : exp2f(m[r] - m_new);
      base[r] = m_new == -INFINITY ? 0.f : m_new;
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int e = 0; e < FBN / 2; ++e) {
      sc[e] = exp2f(sc[e] - base[(e >> 1) & 1]);
      l[(e >> 1) & 1] += sc[e];                // this thread's columns
    }
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] *= corr[(e >> 1) & 1];
    uint32_t pa[FBN / 16][4];
    to_a_frags<FBN>(sc, pa);

    // O += P V, P from registers
    pin(acc);
    pin(pa);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < FBN / 16; ++kk)
      wgmma_pv<D>(acc, pa[kk], Vt, FBN, kk);
    wg_commit();
    wg_wait<0>();
    pin(acc);
    ring.release(it);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row + 8 * r;
    const float lsum = quad_sum(l[r]);
    if (qi >= Sq) continue;
    const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
    __nv_bfloat16* orow = o + ((size_t)bh * Sq + qi) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * (lane % 4)) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv,
                                acc[4 * j + 2 * r + 1] * inv);
    if (lane % 4 == 0)
      lse[(size_t)bh * Sq + qi] =
          lsum > 0.f ? (m[r] + log2f(lsum)) * LN2 : -INFINITY;
  }
}

// Backward: 64-row tiles (keys or queries), one warpgroup a block.
constexpr int BB = 64, BNT = 128;

template <int D>
constexpr size_t bwd_tc_smem() {
  // two tiles held for the whole block, and two stages of two tiles
  return 1024 + 6 * 2 * (size_t)BB * D;
}

// dK and dV of one 64-key tile: S^T = K Q^T and dP^T = V dO^T (K and V
// held, Q and dO streamed through the ring) for every visible q tile of
// each of the G query heads of this kv head, then dV += P^T dO and
// dK += dS^T Q with P^T and dS^T as register A operands.
template <int D>
__global__ void __launch_bounds__(BNT)
flash_bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse,
                         const float* __restrict__ di,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int H, int KH,
                         int Sq, int Skv, float scale, int causal, int window,
                         float softcap) {
  constexpr int T = 2 * BB * D;                // bytes of a tile
  extern __shared__ unsigned char smem_raw[];
  __shared__ Ring ring;
  __shared__ uint64_t kvbar;
  __shared__ float Ls[2][BB], Ds[2][BB];       // lse * log2(e) and Di
  uint8_t* Ks = align1024(smem_raw);
  uint8_t* Vs = Ks + T;
  uint8_t* Qs = Vs + T;                        // stages at Qs + s * T
  uint8_t* dOs = Qs + 2 * T;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.z, kh = blockIdx.y, k0 = blockIdx.x * BB;
  const int G = H / KH, bkh = b * KH + kh;
  const int k_last = min(k0 + BB, Skv) - 1;
  const int qb0 = (causal ? k0 : 0) / BB * BB;
  const int q_end = window > 0 ? min(Sq, k_last + window) : Sq;
  const int nq = max(0, (q_end - qb0 + BB - 1) / BB);
  const int n = G * nq;                        // (head, q tile) pairs

  if (tid == 0) {
    ring.init(BNT);
    mbar_init(&kvbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&kvbar, 2 * T);
    tma_tile<D>(Ks, &tk, &kvbar, BB, k0, bkh);
    tma_tile<D>(Vs, &tv, &kvbar, BB, k0, bkh);
    if (n > 0) {
      uint64_t* bar = ring.produce(0, 2 * T);
      tma_tile<D>(Qs, &tq, bar, BB, qb0, b * H + kh * G);
      tma_tile<D>(dOs, &tdo, bar, BB, qb0, b * H + kh * G);
    }
  }

  const int key = k0 + 16 * warp + lane / 4;   // rows key and key + 8
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  mbar_wait(&kvbar, 0);

  for (int it = 0; it < n; ++it) {
    const int q0 = qb0 + it % nq * BB, bh = b * H + kh * G + it / nq;
    const int s = it & 1;
    const int c = tid % BB, qc = q0 + c;
    const float stat = qc >= Sq ? 0.f
                       : tid < BB ? lse[(size_t)bh * Sq + qc] * LOG2E
                                  : di[(size_t)bh * Sq + qc];
    if (tid == 0 && it + 1 < n) {
      const int nq0 = qb0 + (it + 1) % nq * BB;
      const int nbh = b * H + kh * G + (it + 1) / nq;
      uint64_t* bar = ring.produce(it + 1, 2 * T);
      tma_tile<D>(Qs + (s ^ 1) * T, &tq, bar, BB, nq0, nbh);
      tma_tile<D>(dOs + (s ^ 1) * T, &tdo, bar, BB, nq0, nbh);
    }
    ring.consume(it);
    const uint8_t* Qt = Qs + s * T;
    const uint8_t* dOt = dOs + s * T;

    float st[BB / 2], dpt[BB / 2];
#pragma unroll
    for (int i = 0; i < BB / 2; ++i) st[i] = dpt[i] = 0.f;
    pin(st);
    pin(dpt);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(st, kmajor<D>(Ks, BB, 0, kk), kmajor<D>(Qt, BB, 0, kk),
               kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dpt, kmajor<D>(Vs, BB, 0, kk), kmajor<D>(dOt, BB, 0, kk),
               kk > 0);
    wg_commit();
    // the stage's Ls / Ds were last read two tiles ago, before every
    // thread reached the previous tile's barrier
    (tid < BB ? Ls : Ds)[s][c] = stat;
    __syncthreads();
    wg_wait<0>();
    pin(st);
    pin(dpt);

    const bool masked = tile_masked(q0, BB, k0, BB, Sq, Skv, causal, window);
#pragma unroll
    for (int e = 0; e < BB / 2; ++e) {
      const int qcol = 8 * (e >> 2) + 2 * (lane % 4) + (e & 1);
      float dcap;
      const float x = cap_score(st[e], scale, softcap, &dcap);
      float p = exp2f(x * LOG2E - Ls[s][qcol]);
      if (masked && !visible(q0 + qcol, key + 8 * ((e >> 1) & 1), Sq, Skv,
                             causal, window))
        p = 0.f;
      st[e] = p;
      dpt[e] = p * (dpt[e] - Ds[s][qcol]) * dcap;
    }
    uint32_t pa[BB / 16][4], da[BB / 16][4];
    to_a_frags<BB>(st, pa);
    to_a_frags<BB>(dpt, da);

    pin(dva);
    pin(dka);
    pin(pa);
    pin(da);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BB / 16; ++kk)
      wgmma_rs(dva, pa[kk], mnmajor<D>(dOt, BB, kk), 1);
#pragma unroll
    for (int kk = 0; kk < BB / 16; ++kk)
      wgmma_rs(dka, da[kk], mnmajor<D>(Qt, BB, kk), 1);
    wg_commit();
    wg_wait<0>();
    pin(dva);
    pin(dka);
    ring.release(it);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = key + 8 * r;
    if (kj >= Skv) continue;
    const size_t off = ((size_t)bkh * Skv + kj) * D + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j) =
          __floats2bfloat162_rn(dka[4 * j + 2 * r] * scale,
                                dka[4 * j + 2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j) =
          __floats2bfloat162_rn(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
    }
  }
}

// dQ of one 64-row q tile: S = Q K^T and dP = dO V^T again (Q and dO held,
// K and V streamed through the ring), then dQ += dS K with dS as the
// register A operand.
template <int D>
__global__ void __launch_bounds__(BNT)
flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const float* __restrict__ lse,
                       const float* __restrict__ di,
                       __nv_bfloat16* __restrict__ dq, int H, int KH, int Sq,
                       int Skv, float scale, int causal, int window,
                       float softcap) {
  constexpr int T = 2 * BB * D;
  extern __shared__ unsigned char smem_raw[];
  __shared__ Ring ring;
  __shared__ uint64_t qbar;
  uint8_t* Qs = align1024(smem_raw);
  uint8_t* dOs = Qs + T;
  uint8_t* Ks = dOs + T;                       // stages at Ks + s * T
  uint8_t* Vs = Ks + 2 * T;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BB;
  const int bh = b * H + h, bkh = b * KH + h / (H / KH);
  const int q_last = min(q0 + BB, Sq) - 1;
  const int k_end = causal ? min(Skv, q_last + 1) : Skv;
  const int kb0 = (window > 0 ? max(0, q0 - window + 1) : 0) / BB * BB;
  const int n = (k_end - kb0 + BB - 1) / BB;

  if (tid == 0) {
    ring.init(BNT);
    mbar_init(&qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&qbar, 2 * T);
    tma_tile<D>(Qs, &tq, &qbar, BB, q0, bh);
    tma_tile<D>(dOs, &tdo, &qbar, BB, q0, bh);
    if (n > 0) {
      uint64_t* bar = ring.produce(0, 2 * T);
      tma_tile<D>(Ks, &tk, bar, BB, kb0, bkh);
      tma_tile<D>(Vs, &tv, bar, BB, kb0, bkh);
    }
  }

  const int row = q0 + 16 * warp + lane / 4;   // rows row and row + 8
  float l2[2], d2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row + 8 * r;
    l2[r] = qi < Sq ? lse[(size_t)bh * Sq + qi] * LOG2E : 0.f;
    d2[r] = qi < Sq ? di[(size_t)bh * Sq + qi] : 0.f;
  }
  float dqa[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
  mbar_wait(&qbar, 0);

  for (int it = 0; it < n; ++it) {
    const int k0 = kb0 + it * BB, s = it & 1;
    if (tid == 0 && it + 1 < n) {
      uint64_t* bar = ring.produce(it + 1, 2 * T);
      tma_tile<D>(Ks + (s ^ 1) * T, &tk, bar, BB, k0 + BB, bkh);
      tma_tile<D>(Vs + (s ^ 1) * T, &tv, bar, BB, k0 + BB, bkh);
    }
    ring.consume(it);
    const uint8_t* Kt = Ks + s * T;
    const uint8_t* Vt = Vs + s * T;

    float sa[BB / 2], dpa[BB / 2];
#pragma unroll
    for (int i = 0; i < BB / 2; ++i) sa[i] = dpa[i] = 0.f;
    pin(sa);
    pin(dpa);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(sa, kmajor<D>(Qs, BB, 0, kk), kmajor<D>(Kt, BB, 0, kk),
               kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dpa, kmajor<D>(dOs, BB, 0, kk), kmajor<D>(Vt, BB, 0, kk),
               kk > 0);
    wg_commit();
    wg_wait<0>();
    pin(sa);
    pin(dpa);

    const bool masked = tile_masked(q0, BB, k0, BB, Sq, Skv, causal, window);
#pragma unroll
    for (int e = 0; e < BB / 2; ++e) {
      const int r = (e >> 1) & 1;
      float dcap;
      const float x = cap_score(sa[e], scale, softcap, &dcap);
      float p = exp2f(x * LOG2E - l2[r]);
      if (masked && !visible(row + 8 * r,
                             k0 + 8 * (e >> 2) + 2 * (lane % 4) + (e & 1),
                             Sq, Skv, causal, window))
        p = 0.f;
      dpa[e] = p * (dpa[e] - d2[r]) * dcap;
    }
    uint32_t da[BB / 16][4];
    to_a_frags<BB>(dpa, da);

    pin(dqa);
    pin(da);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BB / 16; ++kk)
      wgmma_rs(dqa, da[kk], mnmajor<D>(Kt, BB, kk), 1);
    wg_commit();
    wg_wait<0>();
    pin(dqa);
    ring.release(it);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row + 8 * r;
    if (qi >= Sq) continue;
    __nv_bfloat16* drow = dq + ((size_t)bh * Sq + qi) * D + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(drow + 8 * j) =
          __floats2bfloat162_rn(dqa[4 * j + 2 * r] * scale,
                                dqa[4 * j + 2 * r + 1] * scale);
  }
}

// Backward above D 128: the dK and dV of a 64-key tile (2 x 64 x D f32)
// would take 256 registers a thread of one warpgroup at D 256, and dQ 128
// beside the score tiles.  So two warpgroups split D: warpgroup w holds
// columns [w D / 2, (w + 1) D / 2) of dK and dV (or of dQ).  The score
// products are shared, not repeated: warpgroup 0 computes S (or S^T),
// warpgroup 1 dP (or dP^T), each over the whole depth D.  They meet in
// shared memory, X [32][128] words: warpgroup 1 writes its dP, warpgroup 0
// forms P and dS from both and writes them back as the bf16 A fragments of
// the next products, which both warpgroups then read.  Each thread touches
// only column t (its own index in its warpgroup) of X, and the two
// warpgroups' fragments have one layout, so thread t of warpgroup 0 pairs
// with thread t of warpgroup 1.
constexpr int SNT = 256;

template <int D>
constexpr size_t bwd_split_smem() {
  return bwd_tc_smem<D>() + 32 * 128 * sizeof(uint32_t);
}

template <int D>
__global__ void __launch_bounds__(SNT, 1)
flash_bwd_dkdv_split_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const float* __restrict__ lse,
                            const float* __restrict__ di,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, int H, int KH,
                            int Sq, int Skv, float scale, int causal,
                            int window, float softcap) {
  constexpr int T = 2 * BB * D;                // bytes of a tile
  // bytes from a tile's start to its column D / 2
  constexpr int HALF = BB * Tiles<D>::SW * (Tiles<D>::NCH / 2);
  extern __shared__ unsigned char smem_raw[];
  __shared__ Ring ring;
  __shared__ uint64_t kvbar;
  __shared__ float Ls[BB], Ds[BB];             // lse * log2(e) and Di
  uint8_t* Ks = align1024(smem_raw);
  uint8_t* Vs = Ks + T;
  uint8_t* Qs = Vs + T;                        // stages at Qs + s * T
  uint8_t* dOs = Qs + 2 * T;
  uint32_t* X = reinterpret_cast<uint32_t*>(dOs + 2 * T);

  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int warp = t / 32, lane = tid % 32;
  const int b = blockIdx.z, kh = blockIdx.y, k0 = blockIdx.x * BB;
  const int G = H / KH, bkh = b * KH + kh;
  const int k_last = min(k0 + BB, Skv) - 1;
  const int qb0 = (causal ? k0 : 0) / BB * BB;
  const int q_end = window > 0 ? min(Sq, k_last + window) : Sq;
  const int nq = max(0, (q_end - qb0 + BB - 1) / BB);
  const int n = G * nq;                        // (head, q tile) pairs

  if (tid == 0) {
    ring.init(SNT);
    mbar_init(&kvbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&kvbar, 2 * T);
    tma_tile<D>(Ks, &tk, &kvbar, BB, k0, bkh);
    tma_tile<D>(Vs, &tv, &kvbar, BB, k0, bkh);
    if (n > 0) {
      uint64_t* bar = ring.produce(0, 2 * T);
      tma_tile<D>(Qs, &tq, bar, BB, qb0, b * H + kh * G);
      tma_tile<D>(dOs, &tdo, bar, BB, qb0, b * H + kh * G);
    }
  }

  const int key = k0 + 16 * warp + lane / 4;   // rows key and key + 8
  float dka[D / 4], dva[D / 4];                // this warpgroup's columns
#pragma unroll
  for (int i = 0; i < D / 4; ++i) dka[i] = dva[i] = 0.f;
  mbar_wait(&kvbar, 0);

  for (int it = 0; it < n; ++it) {
    const int q0 = qb0 + it % nq * BB, bh = b * H + kh * G + it / nq;
    const int s = it & 1;
    const int c = tid % BB, qc = q0 + c;
    const float stat = qc >= Sq || tid >= 2 * BB ? 0.f
                       : tid < BB ? lse[(size_t)bh * Sq + qc] * LOG2E
                                  : di[(size_t)bh * Sq + qc];
    if (tid == 0 && it + 1 < n) {
      const int nq0 = qb0 + (it + 1) % nq * BB;
      const int nbh = b * H + kh * G + (it + 1) / nq;
      uint64_t* bar = ring.produce(it + 1, 2 * T);
      tma_tile<D>(Qs + (s ^ 1) * T, &tq, bar, BB, nq0, nbh);
      tma_tile<D>(dOs + (s ^ 1) * T, &tdo, bar, BB, nq0, nbh);
    }
    ring.consume(it);
    const uint8_t* Qt = Qs + s * T;
    const uint8_t* dOt = dOs + s * T;

    // S^T = K Q^T in warpgroup 0, dP^T = V dO^T in warpgroup 1
    const uint8_t* A = wg == 0 ? Ks : Vs;
    const uint8_t* Bt = wg == 0 ? Qt : dOt;
    float sc[BB / 2];
#pragma unroll
    for (int i = 0; i < BB / 2; ++i) sc[i] = 0.f;
    pin(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(sc, kmajor<D>(A, BB, 0, kk), kmajor<D>(Bt, BB, 0, kk),
               kk > 0);
    wg_commit();
    // Ls / Ds were last read before the previous tile's second barrier,
    // which every thread has passed
    if (tid < 2 * BB) (tid < BB ? Ls : Ds)[c] = stat;
    wg_wait<0>();
    pin(sc);
    if (wg == 1) {
#pragma unroll
      for (int e = 0; e < BB / 2; ++e) X[e * 128 + t] = __float_as_uint(sc[e]);
    }
    __syncthreads();

    uint32_t pa[BB / 16][4], da[BB / 16][4];
    if (wg == 0) {
      const bool masked =
          tile_masked(q0, BB, k0, BB, Sq, Skv, causal, window);
      float dpt[BB / 2];
#pragma unroll
      for (int e = 0; e < BB / 2; ++e) {
        const int qcol = 8 * (e >> 2) + 2 * (lane % 4) + (e & 1);
        float dcap;
        const float x = cap_score(sc[e], scale, softcap, &dcap);
        float p = exp2f(x * LOG2E - Ls[qcol]);
        if (masked && !visible(q0 + qcol, key + 8 * ((e >> 1) & 1), Sq, Skv,
                               causal, window))
          p = 0.f;
        sc[e] = p;
        dpt[e] = p * (__uint_as_float(X[e * 128 + t]) - Ds[qcol]) * dcap;
      }
      to_a_frags<BB>(sc, pa);
      to_a_frags<BB>(dpt, da);
#pragma unroll
      for (int kk = 0; kk < BB / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          X[(4 * kk + i) * 128 + t] = pa[kk][i];
          X[(16 + 4 * kk + i) * 128 + t] = da[kk][i];
        }
    }
    __syncthreads();
    if (wg == 1) {
#pragma unroll
      for (int kk = 0; kk < BB / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pa[kk][i] = X[(4 * kk + i) * 128 + t];
          da[kk][i] = X[(16 + 4 * kk + i) * 128 + t];
        }
    }

    // dV += P^T dO and dK += dS^T Q over this warpgroup's columns
    pin(dva);
    pin(dka);
    pin(pa);
    pin(da);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BB / 16; ++kk)
      wgmma_rs(dva, pa[kk], mnmajor<D>(dOt + wg * HALF, BB, kk), 1);
#pragma unroll
    for (int kk = 0; kk < BB / 16; ++kk)
      wgmma_rs(dka, da[kk], mnmajor<D>(Qt + wg * HALF, BB, kk), 1);
    wg_commit();
    wg_wait<0>();
    pin(dva);
    pin(dka);
    ring.release(it);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = key + 8 * r;
    if (kj >= Skv) continue;
    const size_t off =
        ((size_t)bkh * Skv + kj) * D + wg * (D / 2) + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j) =
          __floats2bfloat162_rn(dka[4 * j + 2 * r] * scale,
                                dka[4 * j + 2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j) =
          __floats2bfloat162_rn(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(SNT, 1)
flash_bwd_dq_split_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ di,
                          __nv_bfloat16* __restrict__ dq, int H, int KH,
                          int Sq, int Skv, float scale, int causal,
                          int window, float softcap) {
  constexpr int T = 2 * BB * D;
  // bytes from a tile's start to its column D / 2
  constexpr int HALF = BB * Tiles<D>::SW * (Tiles<D>::NCH / 2);
  extern __shared__ unsigned char smem_raw[];
  __shared__ Ring ring;
  __shared__ uint64_t qbar;
  uint8_t* Qs = align1024(smem_raw);
  uint8_t* dOs = Qs + T;
  uint8_t* Ks = dOs + T;                       // stages at Ks + s * T
  uint8_t* Vs = Ks + 2 * T;
  uint32_t* X = reinterpret_cast<uint32_t*>(Vs + 2 * T);

  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int warp = t / 32, lane = tid % 32;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BB;
  const int bh = b * H + h, bkh = b * KH + h / (H / KH);
  const int q_last = min(q0 + BB, Sq) - 1;
  const int k_end = causal ? min(Skv, q_last + 1) : Skv;
  const int kb0 = (window > 0 ? max(0, q0 - window + 1) : 0) / BB * BB;
  const int n = (k_end - kb0 + BB - 1) / BB;

  if (tid == 0) {
    ring.init(SNT);
    mbar_init(&qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&qbar, 2 * T);
    tma_tile<D>(Qs, &tq, &qbar, BB, q0, bh);
    tma_tile<D>(dOs, &tdo, &qbar, BB, q0, bh);
    if (n > 0) {
      uint64_t* bar = ring.produce(0, 2 * T);
      tma_tile<D>(Ks, &tk, bar, BB, kb0, bkh);
      tma_tile<D>(Vs, &tv, bar, BB, kb0, bkh);
    }
  }

  const int row = q0 + 16 * warp + lane / 4;   // rows row and row + 8
  float l2[2], d2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row + 8 * r;
    l2[r] = qi < Sq ? lse[(size_t)bh * Sq + qi] * LOG2E : 0.f;
    d2[r] = qi < Sq ? di[(size_t)bh * Sq + qi] : 0.f;
  }
  float dqa[D / 4];                            // this warpgroup's columns
#pragma unroll
  for (int i = 0; i < D / 4; ++i) dqa[i] = 0.f;
  mbar_wait(&qbar, 0);

  for (int it = 0; it < n; ++it) {
    const int k0 = kb0 + it * BB, s = it & 1;
    if (tid == 0 && it + 1 < n) {
      uint64_t* bar = ring.produce(it + 1, 2 * T);
      tma_tile<D>(Ks + (s ^ 1) * T, &tk, bar, BB, k0 + BB, bkh);
      tma_tile<D>(Vs + (s ^ 1) * T, &tv, bar, BB, k0 + BB, bkh);
    }
    ring.consume(it);
    const uint8_t* Kt = Ks + s * T;
    const uint8_t* Vt = Vs + s * T;

    // S = Q K^T in warpgroup 0, dP = dO V^T in warpgroup 1
    float sc[BB / 2];
#pragma unroll
    for (int i = 0; i < BB / 2; ++i) sc[i] = 0.f;
    pin(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(sc, kmajor<D>(wg == 0 ? Qs : dOs, BB, 0, kk),
               kmajor<D>(wg == 0 ? Kt : Vt, BB, 0, kk), kk > 0);
    wg_commit();
    wg_wait<0>();
    pin(sc);
    if (wg == 1) {
#pragma unroll
      for (int e = 0; e < BB / 2; ++e) X[e * 128 + t] = __float_as_uint(sc[e]);
    }
    __syncthreads();

    uint32_t da[BB / 16][4];
    if (wg == 0) {
      const bool masked =
          tile_masked(q0, BB, k0, BB, Sq, Skv, causal, window);
#pragma unroll
      for (int e = 0; e < BB / 2; ++e) {
        const int r = (e >> 1) & 1;
        float dcap;
        const float x = cap_score(sc[e], scale, softcap, &dcap);
        float p = exp2f(x * LOG2E - l2[r]);
        if (masked && !visible(row + 8 * r,
                               k0 + 8 * (e >> 2) + 2 * (lane % 4) + (e & 1),
                               Sq, Skv, causal, window))
          p = 0.f;
        sc[e] = p * (__uint_as_float(X[e * 128 + t]) - d2[r]) * dcap;
      }
      to_a_frags<BB>(sc, da);
#pragma unroll
      for (int kk = 0; kk < BB / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) X[(4 * kk + i) * 128 + t] = da[kk][i];
    }
    __syncthreads();
    if (wg == 1) {
#pragma unroll
      for (int kk = 0; kk < BB / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) da[kk][i] = X[(4 * kk + i) * 128 + t];
    }

    // dQ += dS K over this warpgroup's columns
    pin(dqa);
    pin(da);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BB / 16; ++kk)
      wgmma_rs(dqa, da[kk], mnmajor<D>(Kt + wg * HALF, BB, kk), 1);
    wg_commit();
    wg_wait<0>();
    pin(dqa);
    ring.release(it);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row + 8 * r;
    if (qi >= Sq) continue;
    __nv_bfloat16* drow =
        dq + ((size_t)bh * Sq + qi) * D + wg * (D / 2) + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      *reinterpret_cast<__nv_bfloat162*>(drow + 8 * j) =
          __floats2bfloat162_rn(dqa[4 * j + 2 * r] * scale,
                                dqa[4 * j + 2 * r + 1] * scale);
  }
}

// Host side: launch configuration and the C entry points.

struct Shape {
  int B, H, KH, Sq, Skv;
  float scale;
  int causal, window;
  float softcap;
};

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       float* lse, const Shape& s, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D>;
  constexpr size_t smem = fwd_smem<T, D>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((s.Sq + TILE - 1) / TILE, s.H, s.B);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, s.H, s.KH, s.Sq,
      s.Skv, s.scale, s.causal, s.window, s.softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dot(const void* o, const void* dout, float* di,
                       const Shape& s, int D, cudaStream_t stream) {
  const int rows = s.B * s.H * s.Sq;
  flash_bwd_dot_kernel<T><<<(rows + NT / 32 - 1) / (NT / 32), NT, 0,
                            stream>>>(static_cast<const T*>(o),
                                      static_cast<const T*>(dout), di, rows,
                                      D);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const float* lse, const void* dout,
                       float* di, void* dq, void* dk, void* dv,
                       const Shape& s, cudaStream_t stream) {
  cudaError_t err = launch_dot<T>(o, dout, di, s, D, stream);
  if (err != cudaSuccess) return err;

  auto dkdv = flash_bwd_dkdv_kernel<T, D>;
  constexpr size_t smem_kv = dkdv_smem<T, D>();
  err = allow_smem(dkdv, smem_kv);
  if (err != cudaSuccess) return err;
  constexpr int TL = bwd_rows<D>();
  dkdv<<<dim3((s.Skv + TL - 1) / TL, s.KH, s.B), NT, smem_kv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, di,
      static_cast<T*>(dk), static_cast<T*>(dv), s.H, s.KH, s.Sq, s.Skv,
      s.scale, s.causal, s.window, s.softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dqk = flash_bwd_dq_kernel<T, D>;
  constexpr size_t smem_q = dq_smem<T, D>();
  err = allow_smem(dqk, smem_q);
  if (err != cudaSuccess) return err;
  dqk<<<dim3((s.Sq + TL - 1) / TL, s.H, s.B), NT, smem_q, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, di,
      static_cast<T*>(dq), s.H, s.KH, s.Sq, s.Skv, s.scale, s.causal,
      s.window, s.softcap);
  return cudaGetLastError();
}

// Host side of the bf16 kernels: a contiguous [heads][rows][D] bf16
// tensor as a 3-d map of [box_rows][CW] boxes, swizzled as the kernels'
// tiles are; rows past ``rows`` read as zeros, so a ragged last tile never
// reads the next head.  A map is built on the host for every launch and
// passed by value (__grid_constant__).
template <int D>
bool make_map(CUtensorMap* map, const void* ptr, int rows, int heads,
              int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)Tiles<D>::CW, (cuuint32_t)box_rows,
                             1};
  return hopper::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, ptr, dims,
                          strides, box, Tiles<D>::SW);
}

// A map that cannot be encoded is reported as cudaErrorInvalidValue.
template <int D>
cudaError_t launch_fwd_tc(const void* q, const void* k, const void* v,
                          void* o, float* lse, const Shape& s,
                          cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map<D>(&tq, q, s.Sq, s.B * s.H, FBM) ||
      !make_map<D>(&tk, k, s.Skv, s.B * s.KH, fwd_keys<D>()) ||
      !make_map<D>(&tv, v, s.Skv, s.B * s.KH, fwd_keys<D>()))
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_tc_kernel<D>;
  constexpr size_t smem = fwd_tc_smem<D>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((s.Sq + FBM - 1) / FBM, s.H, s.B), FNT, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, s.H, s.KH, s.Sq,
      s.Skv, s.scale, s.causal, s.window, s.softcap);
  return cudaGetLastError();
}

// The dK/dV kernel, then the dQ kernel, of ``threads`` threads and
// ``smem`` bytes of dynamic shared memory a block.
template <typename DKDV, typename DQ>
cudaError_t launch_bwd_pair(DKDV dkdv, DQ dqk, int threads, size_t smem,
                            const CUtensorMap& tq, const CUtensorMap& tk,
                            const CUtensorMap& tv, const CUtensorMap& tdo,
                            const float* lse, const float* di, void* dq,
                            void* dk, void* dv, const Shape& s,
                            cudaStream_t stream) {
  cudaError_t err = allow_smem(dkdv, smem);
  if (err != cudaSuccess) return err;
  dkdv<<<dim3((s.Skv + BB - 1) / BB, s.KH, s.B), threads, smem, stream>>>(
      tq, tk, tv, tdo, lse, di, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), s.H, s.KH, s.Sq, s.Skv, s.scale,
      s.causal, s.window, s.softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = allow_smem(dqk, smem);
  if (err != cudaSuccess) return err;
  dqk<<<dim3((s.Sq + BB - 1) / BB, s.H, s.B), threads, smem, stream>>>(
      tq, tk, tv, tdo, lse, di, static_cast<__nv_bfloat16*>(dq), s.H, s.KH,
      s.Sq, s.Skv, s.scale, s.causal, s.window, s.softcap);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_tc(const void* q, const void* k, const void* v,
                          const void* o, const float* lse, const void* dout,
                          float* di, void* dq, void* dk, void* dv,
                          const Shape& s, cudaStream_t stream) {
  cudaError_t err = launch_dot<__nv_bfloat16>(o, dout, di, s, D, stream);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map<D>(&tq, q, s.Sq, s.B * s.H, BB) ||
      !make_map<D>(&tk, k, s.Skv, s.B * s.KH, BB) ||
      !make_map<D>(&tv, v, s.Skv, s.B * s.KH, BB) ||
      !make_map<D>(&tdo, dout, s.Sq, s.B * s.H, BB))
    return cudaErrorInvalidValue;
  // up to D 128 one warpgroup a block; above, two that split D
  if constexpr (D > 128)
    return launch_bwd_pair(flash_bwd_dkdv_split_kernel<D>,
                           flash_bwd_dq_split_kernel<D>, SNT,
                           bwd_split_smem<D>(), tq, tk, tv, tdo, lse, di, dq,
                           dk, dv, s, stream);
  else
    return launch_bwd_pair(flash_bwd_dkdv_tc_kernel<D>,
                           flash_bwd_dq_tc_kernel<D>, BNT, bwd_tc_smem<D>(),
                           tq, tk, tv, tdo, lse, di, dq, dk, dv, s, stream);
}

}  // namespace

#define FLASH_DISPATCH(CALL)                                     \
  switch (D) {                                                   \
    case 32: err = CALL(32); break;                              \
    case 64: err = CALL(64); break;                              \
    case 96: err = CALL(96); break;                              \
    case 128: err = CALL(128); break;                            \
    case 256: err = CALL(256); break;                            \
    default: err = cudaErrorInvalidValue;                        \
  }

// dtype: 0 = float32, 1 = bfloat16.  causal: 0/1; window <= 0: none;
// softcap <= 0: none.  Returns cudaGetLastError() after the launches.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int B,
                                   int H, int KH, int Sq, int Skv, int D,
                                   float scale, int causal, int window,
                                   float softcap, int dtype, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  const Shape s{B, H, KH, Sq, Skv, scale, causal, window, softcap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  cudaError_t err;
  if (dtype == 0) {
#define CALL(DD) launch_fwd<float, DD>(q, k, v, o, l, s, st)
    FLASH_DISPATCH(CALL)
#undef CALL
  } else if (dtype == 1) {
#define CALL(DD) launch_fwd_tc<DD>(q, k, v, o, l, s, st)
    FLASH_DISPATCH(CALL)
#undef CALL
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// di: f32 scratch of [B, H, Sq].  Returns cudaGetLastError().
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* lse, const void* dout,
                                   void* di, void* dq, void* dk, void* dv,
                                   int B, int H, int KH, int Sq, int Skv,
                                   int D, float scale, int causal, int window,
                                   float softcap, int dtype, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  const Shape s{B, H, KH, Sq, Skv, scale, causal, window, softcap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dd = static_cast<float*>(di);
  cudaError_t err;
  if (dtype == 0) {
#define CALL(DD) \
  launch_bwd<float, DD>(q, k, v, o, l, dout, dd, dq, dk, dv, s, st)
    FLASH_DISPATCH(CALL)
#undef CALL
  } else if (dtype == 1) {
#define CALL(DD) \
  launch_bwd_tc<DD>(q, k, v, o, l, dout, dd, dq, dk, dv, s, st)
    FLASH_DISPATCH(CALL)
#undef CALL
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
