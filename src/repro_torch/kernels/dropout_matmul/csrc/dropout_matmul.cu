// Horn's block-sparse dropout matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/dropout_matmul/kernel.py:48
// (dropout_matmul; body _kernel at :27).
//
// Contract (the plain version is ref.py::dropout_matmul_ref):
//   x [G, M, K] and w [K, N], f32 or bf16, both of one type, contiguous;
//   mask [G, N / block_n] f32 with values in {0, 1/keep};
//   y [G, M, N] f32, y[g, m, n] = mask[g, n / block_n] * sum_k x[g, m, k] *
//   w[k, n], the sum taken in f32 (bf16 products are exact in f32; f32 runs
//   in f32 on the CUDA cores, never TF32).  Any M and K; N and block_n are
//   multiples of 64 and block_n divides N.
//
// The point of the kernel is the skip.  Each block owns one output tile of
// one group, 64 columns wide, so the tile lies inside one mask block.  It
// reads that block's mask value first; when the value is exactly 0 the
// block writes zeros and returns without entering its K loop, so it loads
// no x and no w.  The work done scales with the keep rate, as the TPU
// kernel's pl.when does.
//
// What bounds it on an H100: at Horn's MLP shapes (M = K = 2048, N = 6144)
// the work is operations, 2 * M * K flops per kept output column, against a
// few bytes per element of x, w and y.  The bf16 kernel runs those products
// on the tensor cores with mma.sync.m16n8k16 (f32 accumulators): 128 x 64
// output tiles, 4 warps each owning 64 x 32, x and w tiles of depth 32
// copied into two shared stages with 16-byte cp.async so the next tile's
// copy overlaps this tile's products.  Shared rows are padded by 16 bytes,
// so each warp's fragment reads fall on distinct banks.  wgmma and TMA are
// later work.  The f32 kernel is a plain CUDA-core tiled product (64 x 64
// tiles, 4 x 4 outputs a thread); f32 is not Horn's training dtype.
//
// Launches: grid (N / 64, ceil(M / BM), G), one block per output tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 64;   // output columns of a tile (divides every block_n)

// ---------------------------------------------------------------------------
// shared helpers
// ---------------------------------------------------------------------------
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
// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// D += A B for one warp: A 16 x 16 bf16 (row), B 16 x 8 bf16 (col), D f32.
// Lane l holds, with r = l / 4 and c = 2 * (l % 4):
//   a[0] = A[r][c, c+1]      a[1] = A[r+8][c, c+1]
//   a[2] = A[r][c+8, c+9]    a[3] = A[r+8][c+8, c+9]
//   b[0] = B[c, c+1][r]      b[1] = B[c+8, c+9][r]
//   d[0..1] = D[r][c, c+1]   d[2..3] = D[r+8][c, c+1]
// each 32-bit register holding the lower-indexed element in its low half.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// Zero rows [m0, min(m0 + rows, M)) x columns [n0, n0 + BN) of y[g]: the
// whole work of a tile whose mask block is dropped.
__device__ __forceinline__ void zero_tile(float* yg, int m0, int rows, int M,
                                          int N, int n0) {
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int e = threadIdx.x; e < rows * (BN / 4); e += blockDim.x) {
    const int r = m0 + e / (BN / 4), c = n0 + (e % (BN / 4)) * 4;
    if (r < M) *reinterpret_cast<float4*>(yg + (size_t)r * N + c) = z;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
constexpr int TC_BM = 128, TC_BK = 32, TC_THREADS = 128;
constexpr int TC_AS = TC_BK + 8;   // row stride (elements) of an x tile
constexpr int TC_BS = BN + 8;      // row stride (elements) of a w tile

// Copy x rows [m0, m0 + 128) x columns [k0, k0 + 32) and w rows
// [k0, k0 + 32) x columns [n0, n0 + 64) into one stage.  Whole 16-byte
// pieces inside the matrix go by cp.async (zero-fill for pieces wholly
// outside); a piece that straddles the edge, or any piece when rows of x
// are not 16-byte aligned (K % 8 != 0), is copied element by element.
__device__ __forceinline__ void tc_load(__nv_bfloat16* As, __nv_bfloat16* Bs,
                                        const __nv_bfloat16* xg,
                                        const __nv_bfloat16* w, int m0,
                                        int k0, int n0, int M, int K, int N) {
  const bool vec = (K % 8) == 0;
  for (int c = threadIdx.x; c < TC_BM * (TC_BK / 8); c += TC_THREADS) {
    const int r = c / (TC_BK / 8), kc = (c % (TC_BK / 8)) * 8;
    const int gm = m0 + r, gk = k0 + kc;
    __nv_bfloat16* dst = As + r * TC_AS + kc;
    const __nv_bfloat16* src = xg + (size_t)gm * K + gk;
    if (gm >= M || gk >= K) {
      cp_async16(dst, xg, 0);
    } else if (vec && gk + 8 <= K) {
      cp_async16(dst, src, 16);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = gk + e < K ? src[e] : __float2bfloat16(0.f);
    }
  }
  for (int c = threadIdx.x; c < TC_BK * (BN / 8); c += TC_THREADS) {
    const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
    const int gk = k0 + r;
    const bool ok = gk < K;
    cp_async16(Bs + r * TC_BS + nc, ok ? w + (size_t)gk * N + n0 + nc : w,
               ok ? 16 : 0);
  }
}

__global__ void __launch_bounds__(TC_THREADS)
    dropout_matmul_bf16(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ w,
                        const float* __restrict__ mask, float* __restrict__ y,
                        int M, int K, int N, int block_n) {
  __shared__ __align__(16) __nv_bfloat16 As[2][TC_BM * TC_AS];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][TC_BK * TC_BS];

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * TC_BM, g = blockIdx.z;
  float* yg = y + (size_t)g * M * N;
  const float mval = mask[(size_t)g * (N / block_n) + n0 / block_n];
  if (mval == 0.0f) {             // dropped block: no K loop, no loads
    zero_tile(yg, m0, TC_BM, M, N, n0);
    return;
  }
  const __nv_bfloat16* xg = x + (size_t)g * M * K;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 64, wn = (warp % 2) * 32;   // warp's sub-tile
  const int fr = lane / 4, fc = 2 * (lane % 4);          // fragment row/col

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (K + TC_BK - 1) / TC_BK;
  if (nk > 0) tc_load(As[0], Bs[0], xg, w, m0, 0, n0, M, K, N);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < nk)
      tc_load(As[s ^ 1], Bs[s ^ 1], xg, w, m0, (kt + 1) * TC_BK, n0, M, K,
              N);
    cp_async_commit();
    cp_async_wait_one();          // stage s has landed
    __syncthreads();
    const __nv_bfloat16* A = As[s];
    const __nv_bfloat16* B = Bs[s];
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat16* p = A + (wm + i * 16 + fr) * TC_AS + kk + fc;
        a[i][0] = *reinterpret_cast<const uint32_t*>(p);
        a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * TC_AS);
        a[i][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * TC_AS + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat16* p = B + (kk + fc) * TC_BS + wn + j * 8 + fr;
        b[j][0] = pack_bf16(p[0], p[TC_BS]);
        b[j][1] = pack_bf16(p[8 * TC_BS], p[9 * TC_BS]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16_16816(acc[i][j], a[i], b[j]);
    }
    __syncthreads();              // stage s is free for tile kt + 2
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + wm + i * 16 + fr;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + wn + j * 8 + fc;
      if (r < M)
        *reinterpret_cast<float2*>(yg + (size_t)r * N + c) =
            make_float2(acc[i][j][0] * mval, acc[i][j][1] * mval);
      if (r + 8 < M)
        *reinterpret_cast<float2*>(yg + (size_t)(r + 8) * N + c) =
            make_float2(acc[i][j][2] * mval, acc[i][j][3] * mval);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------
constexpr int F_BM = 64, F_BK = 16, F_THREADS = 256;

__global__ void __launch_bounds__(F_THREADS)
    dropout_matmul_f32(const float* __restrict__ x,
                       const float* __restrict__ w,
                       const float* __restrict__ mask, float* __restrict__ y,
                       int M, int K, int N, int block_n) {
  __shared__ float At[F_BK][F_BM + 1];   // x tile, transposed
  __shared__ float Bt[F_BK][BN];

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * F_BM, g = blockIdx.z;
  float* yg = y + (size_t)g * M * N;
  const float mval = mask[(size_t)g * (N / block_n) + n0 / block_n];
  if (mval == 0.0f) {             // dropped block: no K loop, no loads
    zero_tile(yg, m0, F_BM, M, N, n0);
    return;
  }
  const float* xg = x + (size_t)g * M * K;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;  // cols tx + 16 j

  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += F_BK) {
    for (int e = threadIdx.x; e < F_BM * F_BK; e += F_THREADS) {
      const int r = e / F_BK, k = e % F_BK;
      At[k][r] = (m0 + r < M && k0 + k < K)
                     ? xg[(size_t)(m0 + r) * K + k0 + k] : 0.f;
    }
    for (int e = threadIdx.x; e < F_BK * BN; e += F_THREADS) {
      const int k = e / BN, c = e % BN;
      Bt[k][c] = k0 + k < K ? w[(size_t)(k0 + k) * N + n0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < F_BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = At[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bt[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      yg[(size_t)r * N + n0 + tx + 16 * j] = acc[i][j] * mval;
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int dropout_matmul(const void* x, const void* w, const void* mask,
                              void* y, int G, int M, int K, int N,
                              int block_n, int dtype, void* stream) {
  if (N % BN || block_n % BN || block_n <= 0 || N % block_n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (G == 0 || M == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  float* out = static_cast<float*>(y);
  if (dtype == 0) {
    const dim3 grid(N / BN, (M + F_BM - 1) / F_BM, G);
    dropout_matmul_f32<<<grid, F_THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), m, out, M,
        K, N, block_n);
  } else if (dtype == 1) {
    const dim3 grid(N / BN, (M + TC_BM - 1) / TC_BM, G);
    dropout_matmul_bf16<<<grid, TC_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), m, out, M, K, N, block_n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
