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
// What bounds it on an H100: at the training shape (S 1024, D 128) the work
// is operations: 4 * D flops per (row, visible key) forward, five products of
// that size backward, against ~2 bytes of traffic per element of q/k/v/o.
// This first version does its products with f32 FMAs on the CUDA cores (no
// tensor cores), so it sits far above the bf16 tensor-core bound; making it
// fast (mma.sync / wgmma, TMA) is later work.  What the design does about
// the bound it has: each block stages 64-row tiles in shared memory and every
// thread computes a 4 x 8 register tile of scores (rows ty + 16 i, columns
// tx + 8 j), so each shared-memory read feeds several FMAs; tile rows are
// padded so those reads are free of bank conflicts; whole tiles that the
// causal mask or the window hide are never loaded.
//
// Launches:
//   forward  grid (ceil(Sq / 64), H, B): one block per (b, q head, q tile),
//            walking the visible K/V tiles with an online softmax.  A row
//            whose visible keys all lie in later tiles keeps m = -inf and
//            skips the rescale, so exp(-inf - -inf) never happens.
//   backward three kernels on the stream:
//            1. Di = rowsum(dO * O), one warp per row;
//            2. dK, dV: grid (ceil(Skv / 64), KH, B), one block per
//               (b, kv head, key tile) looping over the G query heads of its
//               kv head and their visible q tiles, so dK and dV sum over the
//               group in registers, with no atomics;
//            3. dQ: grid (ceil(Sq / 64), H, B), a second pass that recomputes
//               P and dS per (b, q head, q tile).  No atomics anywhere: the
//               backward is deterministic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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

// Issue the copies of rows [r0, r0 + TILE) of a [rows, D] matrix into a
// [TILE][row_stride] tile; rows past ``rows`` are zero-filled, not read.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* tile, const T* src, int r0,
                                          int rows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = D / VEC;                 // 16-byte chunks a row
  constexpr int RS = row_stride<T, D>();
  for (int c = threadIdx.x; c < TILE * CPR; c += NT) {
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

template <typename T, int D>
constexpr size_t dkdv_smem() {
  // K, V, Q, dO tiles in T; P and dS tiles in f32; lse and Di of the q tile
  return sizeof(T) * 4 * TILE * row_stride<T, D>() +
         sizeof(float) * (2 * TILE * PS + 2 * TILE);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ di, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int KH, int Sq, int Skv,
                      float scale, int causal, int window, float softcap) {
  constexpr int RS = row_stride<T, D>();
  constexpr int NE = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + TILE * RS;
  T* Qs = Vs + TILE * RS;
  T* dOs = Qs + TILE * RS;
  float* Pt = reinterpret_cast<float*>(dOs + TILE * RS);   // [key][query]
  float* dSt = Pt + TILE * PS;
  float* Ls = dSt + TILE * PS;
  float* Ds = Ls + TILE;

  const int b = blockIdx.z, kh = blockIdx.y, k0 = blockIdx.x * TILE;
  const int G = H / KH;
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  const size_t bkh = (size_t)b * KH + kh;
  load_tile<T, D>(Ks, k + bkh * Skv * D, k0, Skv);
  load_tile<T, D>(Vs, v + bkh * Skv * D, k0, Skv);
  cp_async_commit();

  // query rows that can see any key of this tile
  const int k_last = min(k0 + TILE, Skv) - 1;
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(Sq, k_last + window) : Sq;

  float dk_acc[R][NE], dv_acc[R][NE];              // key rows ty + 16 i
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < NE; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  for (int g = 0; g < G; ++g) {
    const size_t bh = (size_t)b * H + kh * G + g;
    for (int q0 = q_begin / TILE * TILE; q0 < q_end; q0 += TILE) {
      __syncthreads();               // the last q tile's Q, dO, P, dS read
      load_tile<T, D>(Qs, q + bh * Sq * D, q0, Sq);
      load_tile<T, D>(dOs, dout + bh * Sq * D, q0, Sq);
      cp_async_commit();
      for (int r = threadIdx.x; r < TILE; r += NT) {
        Ls[r] = q0 + r < Sq ? lse[bh * Sq + q0 + r] : 0.f;
        Ds[r] = q0 + r < Sq ? di[bh * Sq + q0 + r] : 0.f;
      }
      cp_async_wait_all();
      __syncthreads();

      // S^T and dP^T: rows are keys ty + 16 i, columns queries tx + 8 j
      float s[R][C], dp[R][C];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < D; ++d) {
        float kr[R], vr[R], qc[C], oc[C];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          kr[i] = to_f32(Ks[(ty + 16 * i) * RS + d]);
          vr[i] = to_f32(Vs[(ty + 16 * i) * RS + d]);
        }
#pragma unroll
        for (int j = 0; j < C; ++j) {
          qc[j] = to_f32(Qs[(tx + 8 * j) * RS + d]);
          oc[j] = to_f32(dOs[(tx + 8 * j) * RS + d]);
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < C; ++j) {
            s[i][j] = fmaf(kr[i], qc[j], s[i][j]);
            dp[i][j] = fmaf(vr[i], oc[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const int qj = tx + 8 * j;
          float dcap;
          const float x = cap_score(s[i][j], scale, softcap, &dcap);
          const float p = visible(q0 + qj, k0 + ty + 16 * i, Sq, Skv, causal,
                                  window) ? expf(x - Ls[qj]) : 0.f;
          Pt[(ty + 16 * i) * PS + qj] = p;
          dSt[(ty + 16 * i) * PS + qj] = p * (dp[i][j] - Ds[qj]) * dcap;
        }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q over this tile's queries
#pragma unroll 2
      for (int j = 0; j < TILE; ++j) {
        float pr[R], sr[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          pr[i] = Pt[(ty + 16 * i) * PS + j];
          sr[i] = dSt[(ty + 16 * i) * PS + j];
        }
#pragma unroll
        for (int e = 0; e < NE; ++e) {
          const float oo = to_f32(dOs[j * RS + tx + 8 * e]);
          const float qq = to_f32(Qs[j * RS + tx + 8 * e]);
#pragma unroll
          for (int i = 0; i < R; ++i) {
            dv_acc[i][e] = fmaf(pr[i], oo, dv_acc[i][e]);
            dk_acc[i][e] = fmaf(sr[i], qq, dk_acc[i][e]);
          }
        }
      }
    }
  }
  cp_async_wait_all();               // no copy outlives the block

#pragma unroll
  for (int i = 0; i < R; ++i) {
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
  return sizeof(T) * 4 * TILE * row_stride<T, D>() +
         sizeof(float) * TILE * PS;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ di, T* __restrict__ dq, int H,
                    int KH, int Sq, int Skv, float scale, int causal,
                    int window, float softcap) {
  constexpr int RS = row_stride<T, D>();
  constexpr int NE = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + TILE * RS;
  T* Ks = dOs + TILE * RS;
  T* Vs = Ks + TILE * RS;
  float* dSs = reinterpret_cast<float*>(Vs + TILE * RS);    // [query][key]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * TILE;
  const int kh = h / (H / KH);
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  const size_t bh = (size_t)b * H + h;
  const T* kb = k + ((size_t)b * KH + kh) * Skv * D;
  const T* vb = v + ((size_t)b * KH + kh) * Skv * D;
  load_tile<T, D>(Qs, q + bh * Sq * D, q0, Sq);
  load_tile<T, D>(dOs, dout + bh * Sq * D, q0, Sq);
  cp_async_commit();

  float lr[R], dr[R];                              // query rows ty + 16 i
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty + 16 * i;
    lr[i] = qi < Sq ? lse[bh * Sq + qi] : 0.f;
    dr[i] = qi < Sq ? di[bh * Sq + qi] : 0.f;
  }
  const int q_last = min(q0 + TILE, Sq) - 1;
  const int k_end = causal ? min(Skv, q_last + 1) : Skv;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;

  float dq_acc[R][NE];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < NE; ++e) dq_acc[i][e] = 0.f;

  for (int k0 = k_begin / TILE * TILE; k0 < k_end; k0 += TILE) {
    __syncthreads();                 // the last tile's K and dS are read
    load_tile<T, D>(Ks, kb, k0, Skv);
    load_tile<T, D>(Vs, vb, k0, Skv);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    // S and dP: rows are queries ty + 16 i, columns keys tx + 8 j
    float s[R][C], dp[R][C];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qr[R], orr[R], kc[C], vc[C];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        qr[i] = to_f32(Qs[(ty + 16 * i) * RS + d]);
        orr[i] = to_f32(dOs[(ty + 16 * i) * RS + d]);
      }
#pragma unroll
      for (int j = 0; j < C; ++j) {
        kc[j] = to_f32(Ks[(tx + 8 * j) * RS + d]);
        vc[j] = to_f32(Vs[(tx + 8 * j) * RS + d]);
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) {
          s[i][j] = fmaf(qr[i], kc[j], s[i][j]);
          dp[i][j] = fmaf(orr[i], vc[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) {
        float dcap;
        const float x = cap_score(s[i][j], scale, softcap, &dcap);
        const float p = visible(q0 + ty + 16 * i, k0 + tx + 8 * j, Sq, Skv,
                                causal, window) ? expf(x - lr[i]) : 0.f;
        dSs[(ty + 16 * i) * PS + tx + 8 * j] = p * (dp[i][j] - dr[i]) * dcap;
      }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < TILE; ++j) {
      float sr[R];
#pragma unroll
      for (int i = 0; i < R; ++i) sr[i] = dSs[(ty + 16 * i) * PS + j];
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const float kk = to_f32(Ks[j * RS + tx + 8 * e]);
#pragma unroll
        for (int i = 0; i < R; ++i) dq_acc[i][e] = fmaf(sr[i], kk, dq_acc[i][e]);
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
    T* dqrow = dq + (bh * Sq + qi) * D;
#pragma unroll
    for (int e = 0; e < NE; ++e) dqrow[tx + 8 * e] = from_f32<T>(dq_acc[i][e] * scale);
  }
}

// Host side: launch configuration and the C entry points.

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

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

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const float* lse, const void* dout,
                       float* di, void* dq, void* dk, void* dv,
                       const Shape& s, cudaStream_t stream) {
  const int rows = s.B * s.H * s.Sq;
  flash_bwd_dot_kernel<T><<<(rows + NT / 32 - 1) / (NT / 32), NT, 0,
                            stream>>>(static_cast<const T*>(o),
                                      static_cast<const T*>(dout), di, rows,
                                      D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dkdv = flash_bwd_dkdv_kernel<T, D>;
  constexpr size_t smem_kv = dkdv_smem<T, D>();
  err = allow_smem(dkdv, smem_kv);
  if (err != cudaSuccess) return err;
  dkdv<<<dim3((s.Skv + TILE - 1) / TILE, s.KH, s.B), NT, smem_kv, stream>>>(
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
  dqk<<<dim3((s.Sq + TILE - 1) / TILE, s.H, s.B), NT, smem_q, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, di,
      static_cast<T*>(dq), s.H, s.KH, s.Sq, s.Skv, s.scale, s.causal,
      s.window, s.softcap);
  return cudaGetLastError();
}

}  // namespace

#define FLASH_DISPATCH(CALL)                                     \
  switch (D) {                                                   \
    case 32: err = CALL(32); break;                              \
    case 64: err = CALL(64); break;                              \
    case 96: err = CALL(96); break;                              \
    case 128: err = CALL(128); break;                            \
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
#define CALL(DD) launch_fwd<__nv_bfloat16, DD>(q, k, v, o, l, s, st)
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
  launch_bwd<__nv_bfloat16, DD>(q, k, v, o, l, dout, dd, dq, dk, dv, s, st)
    FLASH_DISPATCH(CALL)
#undef CALL
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
