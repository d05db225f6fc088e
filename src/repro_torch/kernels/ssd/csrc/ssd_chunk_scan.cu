// Mamba2 SSD chunk scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd/kernel.py:65
// (ssd_chunk_scan; body _kernel at :25).
//
// Contract (the plain version is ref.py::ssd_chunk_scan_ref):
//   x [B, S, H, P], Bm and Cm [B, S, N]: f32 or bf16, all three of one type;
//   dt [B, S, H] and A [H] f32; all contiguous.  P <= 64, N <= 128.
//   y [B, S, H, P] f32, and the [B, H, P, N] f32 state carried after the
//   last chunk (ssd_chunked's second output).
//   For each (b, h) the chunks of Q tokens (Q divides S) run in order, the
//   state starting at zero:
//     cum_i   = sum_{t <= i} dt_t A            (in-chunk cumsum)
//     y_i     = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//             + exp(cum_i) C_i . state
//     state  <- state exp(cum_last) + sum_j x_j^T (w_j B_j),
//               w_j = exp(cum_last - cum_j) dt_j
//   All arithmetic in f32 on the CUDA cores (no TF32).
//
// Design.  One block per (b, h), 256 threads, walks the chunks in order;
// the [P, N] state stays in shared memory from chunk to chunk, as the TPU
// kernel keeps it in VMEM scratch across its sequential grid axis.  The
// [Q, Q] product C.B^T does not fit at Q = 256 (256 KB of f32), so the
// chunk is cut into 64-row query tiles, and each query tile walks the
// 64-row key tiles at or below it: C_i.B_j^T, weighted and masked, goes
// through a [64, 64] shared tile into the [64, P] output held in
// registers (4 x 4 values a thread).  Then the state update walks the key
// tiles once more with B pre-scaled by w_j.  Shared rows of N values are
// padded to 129 floats so the 16 rows a warp reads at one n fall on
// distinct banks.
//
// Overflow: exp(cum_i - cum_j) is formed from the difference, never as
// exp(cum_i) exp(-cum_j) (-cum grows without bound over a chunk), and
// entries with j > i are selected away before the exponent is taken:
// there the exponent is positive and can overflow, and inf * 0 is NaN.
//
// What bounds it on an H100: at mamba2-2.7b's prefill (B 4, S 2048, H 80,
// P 64, N 128, Q 256) the work is ~33 GFLOP of f32 products against
// ~270 MB of traffic, so operations bound it (~0.5 ms at 67 TFLOP/s).
// This first version recomputes C.B^T for each of the 80 heads (ngroups
// = 1 makes it the same for all of them) and reads every operand from
// shared memory in the inner loops; sharing C.B^T across heads, tensor
// cores and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TQ = 64;          // rows of a query or key tile
constexpr int PMAX = 64;        // largest head_dim P
constexpr int NMAX = 128;       // largest state N
constexpr int LDN = NMAX + 1;   // row stride of the [*, N] tiles
constexpr int LDT = TQ + 1;     // row stride of the T tile
constexpr int THREADS = 256;    // 16 x 16 threads: (ty, tx)
constexpr int QMAX = 8192;      // largest chunk (dt, cum, w live in shared)

__host__ __device__ constexpr size_t smem_bytes(int Q) {
  return sizeof(float) * (static_cast<size_t>(PMAX) * LDN + 2 * TQ * LDN +
                          TQ * PMAX + TQ * LDT + 3 * static_cast<size_t>(Q));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// the first ``rows`` rows of a [*, N] matrix (row stride N) into a
// [TQ][LDN] tile, row r scaled by scale[r] when given; zeros past rows and N
template <typename T>
__device__ __forceinline__ void load_rows_n(float* tile, const T* src,
                                            int rows, int N,
                                            const float* scale) {
  for (int e = threadIdx.x; e < TQ * NMAX; e += THREADS) {
    const int r = e / NMAX, n = e % NMAX;
    float v = 0.f;
    if (r < rows && n < N) {
      v = to_f32(src[static_cast<size_t>(r) * N + n]);
      if (scale) v *= scale[r];
    }
    tile[r * LDN + n] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    ssd_chunk_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                          const float* __restrict__ A,
                          const T* __restrict__ Bm, const T* __restrict__ Cm,
                          float* __restrict__ y, float* __restrict__ state_out,
                          int S, int H, int P, int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  float* st = smem;                  // [PMAX][LDN] the carried state
  float* Cs = st + PMAX * LDN;       // [TQ][LDN] C rows of the query tile
  float* Bs = Cs + TQ * LDN;         // [TQ][LDN] B rows of the key tile
  float* Xs = Bs + TQ * LDN;         // [TQ][PMAX] x rows of the key tile
  float* Ts = Xs + TQ * PMAX;        // [TQ][LDT] masked, weighted C.B^T
  float* cum = Ts + TQ * LDT;        // [Q] in-chunk cumsum of dt * A
  float* dts = cum + Q;              // [Q] dt of the chunk
  float* wts = dts + Q;              // [Q] w_j of the state update

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int lane = tid % 32, warp = tid / 32;
  const float a_h = A[h];
  const size_t HP = static_cast<size_t>(H) * P;
  const size_t row0 = static_cast<size_t>(b) * S;   // token (b, 0)

  for (int e = tid; e < PMAX * LDN; e += THREADS) st[e] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    // dt of the chunk, then the cumsum of dt * A: warp 0, a serial run of
    // ceil(Q / 32) steps per lane, then a shuffle scan over the lanes
    for (int t = tid; t < Q; t += THREADS)
      dts[t] = dt[(row0 + c0 + t) * H + h];
    __syncthreads();
    if (warp == 0) {
      const int per = (Q + 31) / 32, t0 = min(lane * per, Q),
                t1 = min(t0 + per, Q);
      float run = 0.f;
      for (int t = t0; t < t1; ++t) {
        run += __fmul_rn(dts[t], a_h);   // dA rounded first, as dt * A
        cum[t] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      float before = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) before = 0.f;
      for (int t = t0; t < t1; ++t) cum[t] += before;
    }
    __syncthreads();
    const float cum_last = cum[Q - 1];

    // ---- outputs, one 64-row query tile at a time ----
    for (int i0 = 0; i0 < Q; i0 += TQ) {
      const int ni = min(TQ, Q - i0);
      load_rows_n(Cs, Cm + (row0 + c0 + i0) * N, ni, N,
                  static_cast<const float*>(nullptr));
      __syncthreads();

      // the carried state: exp(cum_i) C_i . state[p]
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = Cs[(ty + 16 * a) * LDN + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) sv[c] = st[(tx + 16 * c) * LDN + n];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(cv[a], sv[c], acc[a][c]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ty + 16 * a;
        const float e = i < ni ? expf(cum[i0 + i]) : 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] *= e;
      }

      // the intra-chunk dual form, key tiles j0 <= i0
      for (int j0 = 0; j0 <= i0; j0 += TQ) {
        const int nj = min(TQ, Q - j0);
        __syncthreads();               // the last tile's readers are done
        load_rows_n(Bs, Bm + (row0 + c0 + j0) * N, nj, N,
                    static_cast<const float*>(nullptr));
        for (int e = tid; e < TQ * PMAX; e += THREADS) {
          const int r = e / PMAX, p = e % PMAX;
          Xs[e] = (r < nj && p < P)
                      ? to_f32(x[(row0 + c0 + j0 + r) * HP + h * P + p])
                      : 0.f;
        }
        __syncthreads();

        float t[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) t[a][c] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) cv[a] = Cs[(ty + 16 * a) * LDN + n];
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[c] = Bs[(tx + 16 * c) * LDN + n];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c) t[a][c] = fmaf(cv[a], bv[c], t[a][c]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = ty + 16 * a, gi = i0 + i;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = tx + 16 * c, gj = j0 + j;
            // select, never multiply by a 0 mask: above the diagonal the
            // exponent is positive and may be inf
            Ts[i * LDT + j] = (i < ni && j < nj && gj <= gi)
                                  ? t[a][c] * expf(cum[gi] - cum[gj]) * dts[gj]
                                  : 0.f;
          }
        }
        __syncthreads();

        for (int j = 0; j < nj; ++j) {
          float tv[4], xv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) tv[a] = Ts[(ty + 16 * a) * LDT + j];
#pragma unroll
          for (int c = 0; c < 4; ++c) xv[c] = Xs[j * PMAX + tx + 16 * c];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(tv[a], xv[c], acc[a][c]);
        }
      }

#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ty + 16 * a;
        if (i >= ni) continue;
        float* yrow = y + (row0 + c0 + i0 + i) * HP + h * P;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = tx + 16 * c;
          if (p < P) yrow[p] = acc[a][c];
        }
      }
      __syncthreads();                 // Cs and the tiles are free again
    }

    // ---- the state update: state exp(cum_last) + sum_j x_j^T (w_j B_j) ----
    // thread (ty, tx) owns state rows p = ty + 16a, columns n = tx + 16c
    float sacc[4][8];
    const float keep = expf(cum_last);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        sacc[a][c] = st[(ty + 16 * a) * LDN + tx + 16 * c] * keep;
    for (int t = tid; t < Q; t += THREADS)
      wts[t] = expf(cum_last - cum[t]) * dts[t];
    for (int j0 = 0; j0 < Q; j0 += TQ) {
      const int nj = min(TQ, Q - j0);
      __syncthreads();                 // wts written; last tile read
      load_rows_n(Bs, Bm + (row0 + c0 + j0) * N, nj, N, wts + j0);
      for (int e = tid; e < TQ * PMAX; e += THREADS) {
        const int r = e / PMAX, p = e % PMAX;
        Xs[e] = (r < nj && p < P)
                    ? to_f32(x[(row0 + c0 + j0 + r) * HP + h * P + p])
                    : 0.f;
      }
      __syncthreads();
      for (int j = 0; j < nj; ++j) {
        float xv[4], bv[8];
#pragma unroll
        for (int a = 0; a < 4; ++a) xv[a] = Xs[j * PMAX + ty + 16 * a];
#pragma unroll
        for (int c = 0; c < 8; ++c) bv[c] = Bs[j * LDN + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 8; ++c) sacc[a][c] = fmaf(xv[a], bv[c], sacc[a][c]);
      }
    }
    // every read of st happened before the loop's first barrier
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        st[(ty + 16 * a) * LDN + tx + 16 * c] = sacc[a][c];
    __syncthreads();                   // the next chunk reads st, dts, cum
  }

  float* out = state_out + (static_cast<size_t>(b) * H + h) * P * N;
  for (int e = tid; e < P * N; e += THREADS)
    out[e] = st[(e / N) * LDN + e % N];
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* state, int Bsz, int S, int H, int P,
           int N, int Q, cudaStream_t stream) {
  const size_t smem = smem_bytes(Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_scan_kernel<T><<<dim3(H, Bsz), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<float*>(y),
      static_cast<float*>(state), S, H, P, N, Q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype (of x, Bm and Cm): 0 = f32, 1 = bf16.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int ssd_chunk_scan(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, void* y,
                              void* state, int Bsz, int S, int H, int P,
                              int N, int Q, int dtype, void* stream) {
  if (P < 1 || P > PMAX || N < 1 || N > NMAX || Q < 1 || Q > QMAX || S % Q)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Bsz == 0 || H == 0) return 0;
  if (S == 0)                          // no tokens: y is empty, state zero
    return static_cast<int>(cudaMemsetAsync(
        state, 0, sizeof(float) * Bsz * H * P * N,
        static_cast<cudaStream_t>(stream)));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, A, Bm, Cm, y, state, Bsz, S, H, P, N, Q, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state, Bsz, S, H, P, N,
                                 Q, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
