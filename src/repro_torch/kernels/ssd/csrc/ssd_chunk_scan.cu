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
//
// Two kernels, chosen by a rule of the shapes (kernel.py::route):
//
// wgmma (bf16 x, B, C; Q % 64 == 0; P % 16 == 0, P <= 64; N % 16 == 0,
//   N <= 128): ssd_chunk_scan_wgmma_kernel, every product on the tensor
//   cores.  What bounds it: at mamba2-2.7b's prefill (B 4, S 2048, H 80,
//   P 64, N 128, Q 256) the function moves ~269 MB (y in f32 is 168 MB of
//   it) against ~33 GFLOP, so bytes bound it: 0.080 ms at 3.35 TB/s,
//   against 0.033 ms of bf16 tensor-core time.  The design keeps every
//   operand of the products and the state on chip, so the bytes moved are
//   the function's own (x, B, C, dt in; y and the final state out):
//   - One CTA walks one (b, h) through the sequence in order, the [P, N]
//     state in f32 registers (the TPU kernel's idea; mamba_ssm's
//     chunk-parallel split would write and read ~84 MB of f32 chunk
//     states a pass).  320 CTAs at the prefill shape, one an SM (its
//     shared memory): three waves on 132 SMs, the last 42 % full.
//   - The walk goes in blocks of L = 64 tokens, whatever Q is.  The
//     function does not depend on the chunk length (it is the recurrence
//     of ref.py::ssd_ref; Q only orders the f32 sums), and 64-token blocks
//     make the quadratic part 4x smaller than at Q 256 and let a block's
//     tiles fit in shared memory.  The tests hold this against the plain
//     version at the caller's Q, at its tolerance (ref.py::ssd_split_ref
//     is this arithmetic written plainly; test_torch_ssd_split.py).
//   - Warp specialization: a producer warp copies each block's C, B and x
//     tiles by TMA into a three-stage ring (zeros past N and P) and
//     turns its dt into per-token (cum log2 e, dt); an "intra"
//     warpgroup computes what does not depend on the state, S = C B^T
//     (wgmma, both K-major), T and w x, into shared memory; a "state"
//     warpgroup runs the serial chain, all on wgmma:
//       y^T = state C^T        the state's registers as the A operand
//                              (hi, lo), C a K-major B;
//       y^T = y^T exp(cum_i) + x^T T^T
//                              x an MN-major A, T a K-major B (hi, lo);
//       state = state exp(cum_last) + (w x)^T B
//                              w x an MN-major A (hi, lo), B an MN-major
//                              B of 128 columns;
//     and stores y by TMA from a staging tile.  Computing y transposed
//     lets the state serve as a register operand, so it never goes
//     through shared memory.
//   - T's mask and decay are one exponent, 2^(c2_i - c2_j) dt_j with
//     c2 = cum log2 e, -inf above the diagonal; dt multiplies after the
//     exponent, so any finite dt (0 or negative too) gives what the plain
//     version gives.  C's rows
//     come in 8-row TMA boxes in an order that gives every warp one early
//     and one late slice of the block, so each computes 9 of T's 16
//     column-group halves and skips the rest (zeros written once).
//   - Exactness at the CUDA-core kernel's tolerance: x, B and C are exact
//     in bf16.  T, the state and w x are f32 values; each goes to its
//     product as two bf16 terms, hi = bf16(v) and lo = bf16(v - hi), two
//     wgmmas summed in the f32 accumulator (about 2^-16 relative).  The
//     state itself stays f32; only its operand copy is split.  (T in one
//     bf16 term misses the tolerance ~100x at the prefill shape, by
//     ssd_split_ref on the CPU.)
//   - What limits it now: each role's chain of dependent instructions
//     (one warp of each role on a scheduler) and the partly empty third
//     wave, not the tensor cores or the bytes; see PERF.md.
//
// cuda_core (everything else: f32 inputs, Q % 64 != 0, ragged P or N):
//   ssd_chunk_scan_kernel, all arithmetic in f32 on the CUDA cores (no
//   TF32).  One block per (b, h), 256 threads, walks the chunks in order;
//   the [P, N] state stays in shared memory from chunk to chunk, as the
//   TPU kernel keeps it in VMEM scratch across its sequential grid axis.
//   The [Q, Q] product C.B^T does not fit at Q = 256 (256 KB of f32), so
//   the chunk is cut into 64-row query tiles, and each query tile walks
//   the 64-row key tiles at or below it: C_i.B_j^T, weighted and masked,
//   goes through a [64, 64] shared tile into the [64, P] output held in
//   registers (4 x 4 values a thread).  Then the state update walks the
//   key tiles once more with B pre-scaled by w_j.  Shared rows of N values
//   are padded to 129 floats so the 16 rows a warp reads at one n fall on
//   distinct banks.  It is bound by f32 operations (~0.5 ms at 67
//   TFLOP/s at the prefill shape) and recomputes C.B^T for each head.
//
// Overflow (both kernels): exp(cum_i - cum_j) is formed from the
// difference, never as exp(cum_i) exp(-cum_j) (-cum grows without bound
// over a chunk), and entries with j > i are selected away before the
// exponent is used: there the exponent is positive and can overflow, and
// inf * 0 is NaN.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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


// ---------------------------------------------------------------------------
// The tensor-core kernel (see the note at the top)
// ---------------------------------------------------------------------------
namespace tc {

// the Hopper building blocks (mbarriers, TMA, wgmma descriptors and
// products, tensor maps) shared with the other tensor-core kernels
using namespace hopper;

constexpr int L = 64;             // tokens of a block: the wgmma's 64 rows
constexpr int PW = 64;            // columns of P (zero past P)
constexpr int WG = 128;           // threads of a warpgroup
constexpr int NTHREADS = 2 * WG + 32;   // state, intra, producer warp
constexpr int NS = 3;             // stages of the TMA ring
constexpr int NQ = 2;             // buffers of T and w x

// Shared memory, every tile on a 1024-byte boundary with 128-byte rows in
// the 128-byte swizzle.  NP is N rounded up to 64.
//   ring, NS stages: C and B [64][NP] bf16 (NP / 64 chunks of 64 columns;
//     columns past N zero-filled by TMA), x [64][64] bf16;
//   T hi and lo [64 i][64 j] bf16 (K-major B of y^T += x^T T^T), NQ
//     buffers;
//   w x hi and lo [64 j][64 p] bf16 (MN-major A of the update), NQ
//     buffers;
//   y [64 tokens][64 p] f32 as two [64][32] boxes, the staging tile of
//     the TMA store, two buffers (a store frees its buffer only as its
//     writes drain).
template <int NP> struct Smem {
  static constexpr int C = L * NP * 2;
  static constexpr int B = C;
  static constexpr int X = L * PW * 2;
  static constexpr int STAGE = C + B + X;
  static constexpr int T = L * L * 2;             // hi or lo
  static constexpr int WX = L * PW * 2;           // hi or lo
  static constexpr int Y = L * PW * 4;
  static constexpr size_t BYTES =
      1024 + NS * STAGE + NQ * 2 * T + NQ * 2 * WX + 2 * Y;
};

// The C tile's rows are the block's tokens in the order that balances the
// causal triangle over the warps: accumulator rows 16 w .. 16 w + 7 hold
// tokens 8 w .. 8 w + 7 and rows 16 w + 8 .. 16 w + 15 tokens 56 - 8 w ..
// 63 - 8 w, so every warp's two row halves together see 9 of the 16
// column-group halves of T, and the rest are 0 in every block.
__host__ __device__ constexpr int c_token(int m) {   // 8-row group m
  return m & 1 ? 56 - 4 * (m - 1) : 4 * m;
}

// byte offset of element (r, c) in a [rows][64] bf16 tile of 128-byte
// rows, 128-byte swizzle: the 16-byte unit c / 8 of row r sits at unit
// (c / 8) ^ (r % 8)
__device__ __forceinline__ int swz128(int r, int c) {
  return r * 128 + (((c >> 3) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// Descriptors are built once a block and stepped by constant byte offsets
// (their start-address field counts 16-byte units, and no tile crosses
// 256 KB): kmajor / mnmajor at depth step kk are the step-0 descriptor
// plus kstep / mnstep bytes.
__device__ __forceinline__ uint64_t desc_add(uint64_t d, int bytes) {
  return d + static_cast<uint64_t>(bytes >> 4);
}
template <int COLS>
__host__ __device__ constexpr int kstep(int rows, int kk) {
  return (16 * kk / Tiles<COLS>::CW) * rows * Tiles<COLS>::SW +
         (16 * kk % Tiles<COLS>::CW) * 2;
}
template <int COLS>
__host__ __device__ constexpr int mnstep(int kk) {
  return kk * 16 * Tiles<COLS>::SW;
}

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {   // 2^x; ex2(-inf) = 0
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}
// shared-memory accesses by 32-bit shared address
__device__ __forceinline__ void sts32(uint32_t a, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a), "r"(v));
}
__device__ __forceinline__ void sts128(uint32_t a, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w));
}
__device__ __forceinline__ uint4 lds128(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(a));
  return v;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
// (a, b) as hi = bf16(v) and lo = bf16(v - hi), packed in pairs
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// One CTA of ``NTHREADS`` per (b, h).  Warpgroup 0 ("state") holds the
// f32 state [64 p, NP n] in registers and runs the serial chain of each
// 64-token block (y^T = state C^T, y^T = y^T exp(cum_i) + x^T T^T, state =
// state exp(cum_last) + (w x)^T B, the y store).  Warpgroup 1 ("intra")
// runs ahead on what does not depend on the state: S = C B^T, T and w x,
// split into hi and lo in shared memory.  Warp 8 copies each block's
// tiles by TMA, loads its dt and scans dt A.  Barriers: full / empty
// order the ring (the producer against both warpgroups), tready / tfree
// the T and w x buffers (intra against state).  An m64nX accumulator
// holds, in a thread, rows rq and rq + 8 and, in each group of 8 columns,
// columns cq and cq + 1.
template <int NP>
__global__ void __launch_bounds__(NTHREADS, 1)
    ssd_chunk_scan_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                                const __grid_constant__ CUtensorMap tb,
                                const __grid_constant__ CUtensorMap tcm,
                                const __grid_constant__ CUtensorMap ty,
                                const float* __restrict__ dt,
                                const float* __restrict__ A,
                                float* __restrict__ state_out, int S, int H,
                                int P, int N) {
  using M = Smem<NP>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[NS], empty[NS], tready[NQ], tfree[NQ];
  // per token of a stage: (cum log2 e, dt), cum the in-block cumsum of
  // dt A; exp(cum_i - cum_j) dt_j = 2^(c2_i - c2_j) dt_j
  __shared__ __align__(16) float2 colv[NS][L];
  uint8_t* ring = align1024(smem_raw);      // stage s at ring + s * STAGE
  uint8_t* tbuf = ring + NS * M::STAGE;     // T[q]: hi, lo at + 2 q T
  uint8_t* wxbuf = tbuf + NQ * 2 * M::T;    // w x[q]: hi, lo at + 2 q WX
  uint8_t* ystage = wxbuf + NQ * 2 * M::WX;

  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const int nblk = S / L;
  const int row0 = b * S;                   // token (b, 0) of the maps

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * WG);
    }
    for (int q = 0; q < NQ; ++q) {
      mbar_init(&tready[q], WG);
      mbar_init(&tfree[q], WG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 2 * WG) {
    // producer warp: lane 0 issues the block's copies; every lane holds
    // the dt of two tokens, 2 l and 2 l + 1 (loaded a block ahead), and
    // the warp scans dt A
    const int lane = tid - 2 * WG;
    const float a_h = A[h];
    const float* dtp = dt + static_cast<size_t>(row0 + 2 * lane) * H + h;
    float d0 = dtp[0], d1 = dtp[H];
    for (int c = 0; c < nblk; ++c) {
      const int s = c % NS;
      if (c >= NS) mbar_wait(&empty[s], (c / NS - 1) & 1);
      const int r = row0 + c * L;
      if (lane == 0) {
        uint8_t* stage = ring + s * M::STAGE;
        mbar_expect_tx_only(&full[s], M::STAGE);
#pragma unroll
        for (int k = 0; k < NP / 64; ++k) {
#pragma unroll
          for (int m = 0; m < L / 8; ++m)      // C in 8-row boxes
            tma_load_2d(stage + k * L * 128 + m * 8 * 128, &tcm, &full[s],
                        64 * k, r + c_token(m));
          tma_load_2d(stage + M::C + k * L * 128, &tb, &full[s], 64 * k, r);
        }
        tma_load_3d(stage + M::C + M::B, &tx, &full[s], 0, h, r);
      }
      const float a0 = __fmul_rn(d0, a_h), a1 = __fmul_rn(d1, a_h);
      float incl = a0 + a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      float before = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) before = 0.f;
      const float c0 = before + a0;
      colv[s][2 * lane] = make_float2(c0 * LOG2E, d0);
      colv[s][2 * lane + 1] = make_float2((c0 + a1) * LOG2E, d1);
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[s]);   // after the warp's writes
      if (c + 1 < nblk) {
        dtp += static_cast<size_t>(L) * H;
        d0 = dtp[0];
        d1 = dtp[H];
      }
    }
    return;
  }

  const int wt = tid % WG;                  // thread in its warpgroup
  const int w = wt / 32;                    // warp in its warpgroup
  const int rq = 16 * w + (wt % 32) / 4, cq = 2 * (wt % 4);
  // tokens of accumulator rows rq and rq + 8
  const int tok[2] = {8 * w + (wt % 32) / 4, 56 - 8 * w + (wt % 32) / 4};

  if (tid >= WG) {
    // intra warpgroup.  The column-group halves of T that the causal mask
    // hides for this warp (g > w for rows rq, g > 7 - w for rows rq + 8)
    // are written as zeros once, in both buffers
    for (int q = 0; q < NQ; ++q)
      for (int g = 0; g < 8; ++g)
        for (int hf = 0; hf < 2; ++hf)
          if (g > (hf ? 7 - w : w)) {
            const uint32_t t = smem_u32(tbuf + 2 * q * M::T);
            sts32(t + swz128(rq + 8 * hf, 8 * g + cq), 0u);
            sts32(t + M::T + swz128(rq + 8 * hf, 8 * g + cq), 0u);
          }
    for (int c = 0; c < nblk; ++c) {
      const int s = c % NS, q = c % NQ;
      mbar_wait(&full[s], (c / NS) & 1);
      if (c >= NQ) mbar_wait(&tfree[q], (c / NQ - 1) & 1);
      const uint8_t* Cs = ring + s * M::STAGE;
      const uint8_t* Bs = Cs + M::C;
      const uint32_t xs = smem_u32(Bs + M::B);
      const float2* cv = colv[s];

      float sc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = 0.f;
      pin(sc);
      const uint64_t dc = kmajor<NP>(Cs, L, 0, 0), db = kmajor<NP>(Bs, L, 0, 0);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < NP / 16; ++kk)
        wgmma_ss(sc, desc_add(dc, kstep<NP>(L, kk)),
                 desc_add(db, kstep<NP>(L, kk)), kk > 0);
      wg_commit();

      // w x = exp(cum_last - cum_j) dt_j x_j while S runs: the x tile and
      // w x share one layout, and a 16-byte unit never leaves its row
      const uint32_t wx_hi = smem_u32(wxbuf + 2 * q * M::WX);
      const uint32_t wx_lo = wx_hi + M::WX;
      const float last = cv[L - 1].x;
#pragma unroll
      for (int k = 0; k < L * PW / 8 / WG; ++k) {
        const int u = wt + k * WG;           // 16-byte unit of the tile
        const float2 cj = cv[u / (PW / 8)];
        const float w = ex2(last - cj.x) * cj.y;
        const uint4 raw = lds128(xs + 16 * u);
        const uint32_t* xv = &raw.x;
        uint4 hi, lo;
        uint32_t* hp = &hi.x;
        uint32_t* lp = &lo.x;
#pragma unroll
        for (int v = 0; v < 4; ++v)
          split2(__uint_as_float(xv[v] << 16) * w,
                 __uint_as_float(xv[v] & 0xffff0000u) * w, hp[v], lp[v]);
        sts128(wx_hi + 16 * u, hi);
        sts128(wx_lo + 16 * u, lo);
      }
      wg_wait<0>();
      pin(sc);

      // T = S exp(cum_i - cum_j) dt_j on j <= i, hi and lo into the K-major
      // tiles; above the diagonal the exponent is -inf (never a 0 multiply
      // of an overflowing exponent, and no branch)
      const uint32_t t_hi = smem_u32(tbuf + 2 * q * M::T);
      const uint32_t t_lo = t_hi + M::T;
      const float ci[2] = {cv[tok[0]].x, cv[tok[1]].x};
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int j = 8 * g + cq;
        const float4 cj = *reinterpret_cast<const float4*>(&cv[j]);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          if (g > (hf ? 7 - w : w)) continue;    // zeros, written once
          const int i = tok[hf], e = 4 * g + 2 * hf;
          const float d0 = j <= i ? ci[hf] - cj.x : -INFINITY;
          const float d1 = j + 1 <= i ? ci[hf] - cj.z : -INFINITY;
          uint32_t hi, lo;
          split2(sc[e] * (ex2(d0) * cj.y), sc[e + 1] * (ex2(d1) * cj.w), hi,
                 lo);
          const int off = swz128(rq + 8 * hf, j);
          sts32(t_hi + off, hi);
          sts32(t_lo + off, lo);
        }
      }
      fence_proxy_async();             // T and w x, for the state's wgmma
      mbar_arrive(&tready[q]);
      mbar_arrive(&empty[s]);          // done with the stage
    }
    return;
  }

  // state warpgroup: the state [64 p, NP n] in f32 registers, an m64nNP
  // accumulator (rows p = rq (+ 8), columns n = 8 (e / 4) + cq (+ 1)).
  // Per block it computes y transposed, y^T [64 p, 64 i] over the C tile's
  // rows i: y^T = state C^T (the state's hi and lo as register A
  // operands), scaled by exp(cum_i), + x^T T^T; then state = state
  // exp(cum_last) + (w x)^T B.  y^T's column i holds token c_token(i / 8)
  // + i % 8.
  float st[NP / 2];
#pragma unroll
  for (int e = 0; e < NP / 2; ++e) st[e] = 0.f;
  const uint32_t ys = smem_u32(ystage);

  for (int c = 0; c < nblk; ++c) {
    const int s = c % NS, q = c % NQ;
    mbar_wait(&full[s], (c / NS) & 1);
    const uint8_t* Cs = ring + s * M::STAGE;
    const uint8_t* Bs = Cs + M::C;
    const uint8_t* Xs = Bs + M::B;
    const float2* cv = colv[s];

    // y^T = state C^T: the C tile is a K-major B operand (rows i, depth
    // n); the state's columns go in two halves of 64, each as hi and lo
    // A fragments, so only one half's fragments are live at a time
    float yt[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) yt[e] = 0.f;
    const uint64_t dc = kmajor<NP>(Cs, L, 0, 0);
#pragma unroll
    for (int half = 0; half < NP / 64; ++half) {
      uint32_t ahi[4][4], alo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int e = 8 * (4 * half + kk) + 2 * r;
          split2(st[e], st[e + 1], ahi[kk][r], alo[kk][r]);
        }
      pin(yt);
      pin(ahi);
      pin(alo);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<0>(yt, ahi[kk], desc_add(dc, kstep<NP>(L, 4 * half + kk)),
                    half > 0 || kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<0>(yt, alo[kk], desc_add(dc, kstep<NP>(L, 4 * half + kk)),
                    1);
      wg_commit();
      wg_wait<0>();
      pin(yt);
      pin(ahi);
      pin(alo);
    }
    const float keep = ex2(cv[L - 1].x);
#pragma unroll
    for (int e = 0; e < NP / 2; ++e) st[e] *= keep;
    mbar_wait(&tready[q], (c / NQ) & 1);
#pragma unroll
    for (int g = 0; g < 8; ++g) {           // columns 8 g + cq (+ 1)
      const int t = c_token(g) + cq;
      const float e0 = ex2(cv[t].x), e1 = ex2(cv[t + 1].x);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        yt[4 * g + 2 * r] *= e0;
        yt[4 * g + 2 * r + 1] *= e1;
      }
    }

    // y^T += x^T T^T (T hi, lo as K-major B tiles [i][j]; x^T the x tile
    // as an MN-major A); state += (w x)^T B (w x hi, lo as MN-major A; the
    // B tile an MN-major B [j][n]); two groups
    const uint64_t dthi = kmajor<64>(tbuf + 2 * q * M::T, L, 0, 0);
    const uint64_t dtlo = desc_add(dthi, M::T);
    const uint64_t dx = mnmajor<64>(Xs, L, 0);
    const uint64_t dwhi = mnmajor<64>(wxbuf + 2 * q * M::WX, L, 0);
    const uint64_t dwlo = desc_add(dwhi, M::WX);
    const uint64_t dbn = mnmajor<NP>(Bs, L, 0);
    pin(yt);
    pin(st);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < L / 16; ++kk)
      wgmma_ss<0, 1>(yt, desc_add(dx, mnstep<64>(kk)),
                     desc_add(dthi, kstep<64>(L, kk)), 1);
#pragma unroll
    for (int kk = 0; kk < L / 16; ++kk)
      wgmma_ss<0, 1>(yt, desc_add(dx, mnstep<64>(kk)),
                     desc_add(dtlo, kstep<64>(L, kk)), 1);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < L / 16; ++kk)
      wgmma_ss<1, 1>(st, desc_add(dwhi, mnstep<64>(kk)),
                     desc_add(dbn, mnstep<NP>(kk)), 1);
#pragma unroll
    for (int kk = 0; kk < L / 16; ++kk)
      wgmma_ss<1, 1>(st, desc_add(dwlo, mnstep<64>(kk)),
                     desc_add(dbn, mnstep<NP>(kk)), 1);
    wg_commit();
    wg_wait<0>();
    pin(yt);
    pin(st);
    mbar_arrive(&tfree[q]);            // T and w x of this block are read
    mbar_arrive(&empty[s]);            // so is the stage

    // y^T into the staging tile by token row (two [64][32] f32 boxes of
    // 128-byte rows, 128-byte swizzle), then one thread stores it by TMA
    // (asynchronous: no later fence waits for it)
    if (wt == 0) bulk_wait_read<1>();  // block c - 2's store has read it
    named_sync(1, WG);
    const uint32_t yb = ys + (c & 1) * M::Y;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int pp = rq + 8 * ((e >> 1) & 1);
      const int t = c_token(e >> 2) + cq + (e & 1);
      sts32(yb + (pp >> 5) * (M::Y / 2) + t * 128 +
                ((((pp & 31) >> 2) ^ (t & 7)) << 4) + (pp & 3) * 4,
            __float_as_uint(yt[e]));
    }
    fence_proxy_async();
    named_sync(1, WG);
    if (wt == 0) {
      const uint8_t* tile = ystage + (c & 1) * M::Y;
      tma_store_3d(&ty, tile, 0, h, row0 + c * L);
      if (P > 32) tma_store_3d(&ty, tile + M::Y / 2, 32, h, row0 + c * L);
      bulk_commit();
    }
  }
  if (wt == 0) bulk_wait();            // the tile lives until y is stored

  // the final state [P, N]
  float* out = state_out + (static_cast<size_t>(b) * H + h) * P * N;
#pragma unroll
  for (int e = 0; e < NP / 2; ++e) {
    const int p = rq + 8 * ((e >> 1) & 1);
    const int n = 8 * (e >> 2) + cq + (e & 1);
    if (n < N && p < P) out[static_cast<size_t>(p) * N + n] = st[e];
  }
}

// Tensor maps: x as [B S][H][P] in boxes of 64 tokens x 1 head x 64
// columns, Bm as [B S][N] in boxes of 64 tokens x 64 columns, Cm the same
// in boxes of 8 tokens, y (f32) as [B S][H][P] in boxes of 64 tokens x 1
// head x 32 columns, all in the 128-byte swizzle; reads past P or N give
// zeros, and stores past P are dropped.
template <int NP>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, void* y, void* state,
                   int Bsz, int S, int H, int P, int N, cudaStream_t stream) {
  CUtensorMap tx, tb, tcm, ty;
  const cuuint64_t rows = static_cast<cuuint64_t>(Bsz) * S;
  const cuuint64_t xdims[3] = {(cuuint64_t)P, (cuuint64_t)H, rows};
  const cuuint64_t xstrides[2] = {(cuuint64_t)P * 2, (cuuint64_t)H * P * 2};
  const cuuint32_t xbox[3] = {PW, 1, L};
  const cuuint64_t ndims[2] = {(cuuint64_t)N, rows};
  const cuuint64_t nstrides[1] = {(cuuint64_t)N * 2};
  const cuuint32_t bbox[2] = {64, L}, cbox[2] = {64, 8};
  const cuuint64_t ystrides[2] = {(cuuint64_t)P * 4, (cuuint64_t)H * P * 4};
  const cuuint32_t ybox[3] = {32, 1, L};
  if (!make_map(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, x, xdims, xstrides,
                xbox, 128) ||
      !make_map(&tb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, Bm, ndims,
                nstrides, bbox, 128) ||
      !make_map(&tcm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, Cm, ndims,
                nstrides, cbox, 128) ||
      !make_map(&ty, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, y, xdims, ystrides,
                ybox, 128))
    return cudaErrorInvalidValue;
  auto kernel = ssd_chunk_scan_wgmma_kernel<NP>;
  constexpr size_t smem = Smem<NP>::BYTES;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, Bsz), NTHREADS, smem, stream>>>(
      tx, tb, tcm, ty, static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<float*>(state), S, H, P, N);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// dtype (of x, Bm and Cm): 0 = f32, 1 = bf16.  route: 0 = the CUDA-core
// kernel, 1 = the wgmma kernel (bf16, Q % 64 == 0, P % 16 == 0, N % 16 ==
// 0; x, Bm and Cm on 16-byte boundaries).  Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a shape the kernel does not
// take.
extern "C" int ssd_chunk_scan(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, void* y,
                              void* state, int Bsz, int S, int H, int P,
                              int N, int Q, int dtype, int route,
                              void* stream) {
  if (P < 1 || P > PMAX || N < 1 || N > NMAX || Q < 1 || Q > QMAX || S % Q)
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == 1 && (dtype != 1 || Q % tc::L || P % 16 || N % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (Bsz == 0 || H == 0) return 0;
  if (S == 0)                          // no tokens: y is empty, state zero
    return static_cast<int>(cudaMemsetAsync(
        state, 0, sizeof(float) * Bsz * H * P * N,
        static_cast<cudaStream_t>(stream)));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1)
    return static_cast<int>(
        N <= 64 ? tc::launch<64>(x, dt, A, Bm, Cm, y, state, Bsz, S, H, P, N,
                                 st)
                : tc::launch<128>(x, dt, A, Bm, Cm, y, state, Bsz, S, H, P,
                                  N, st));
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(x, dt, A, Bm, Cm, y, state, Bsz, S, H, P, N, Q, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state, Bsz, S, H, P, N,
                                 Q, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
