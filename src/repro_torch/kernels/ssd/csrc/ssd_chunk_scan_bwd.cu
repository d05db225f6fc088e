// The backward of the Mamba2 SSD chunk scan for Hopper (sm_90a).
//
// Replaces no TPU kernel: the TPU kernel src/repro/kernels/ssd/kernel.py:65
// has no backward, and the JAX package trains mamba layers by jax.grad
// through the plain chunked form (repro/models/ssm.py:80, ssd_chunked).  On
// the card the forward is ssd_chunk_scan.cu, so its gradient needs a kernel
// of its own (as flash_attention.cu's backward, which the TPU lacks too).
//
// Contract (the plain version is ref.py::ssd_chunk_scan_bwd_ref, and both
// equal autograd through ref.py::ssd_chunk_scan_ref at any chunk: the
// function does not depend on it):
//   x [B, S, H, P], Bm and Cm [B, S, N]: f32 or bf16, all three of one type;
//   dt [B, S, H] and A [H] f32; dy [B, S, H, P] f32, the cotangent of y;
//   dstate [B, H, P, N] f32, the cotangent of the final state, or null for
//   zero; all contiguous.  P <= 64, N <= 128, any S.
//   Out: dx [B, S, H, P], dBm and dCm [B, S, N] in x's type; ddt [B, S, H]
//   and dA [H] f32.
//   Per (b, h) the blocks of L = 64 tokens (the last may be short) are
//   walked last to first.  In a block, with cum the in-block cumsum of
//   a_t = dt_t A, s the state entering it, G the cotangent of the state
//   leaving it, decay_ij = exp(cum_i - cum_j) on j <= i (else 0), w_j =
//   exp(cum_L - cum_j) dt_j, e_ij = dy_i . x_j, M_ij = (C_i . B_j) decay_ij
//   dt_j and D_ij = decay_ij dt_j e_ij:
//     dx_j  = sum_i M_ij dy_i + w_j G B_j
//     dC_i  = sum_j D_ij B_j + exp(cum_i) s^T dy_i
//     dB_j  = sum_i D_ij C_i + w_j G^T x_j
//     ddt_j = sum_i (C_i . B_j) decay_ij e_ij
//             + exp(cum_L - cum_j) x_j^T G B_j + A da_j
//     G    <- exp(cum_L) G + sum_i exp(cum_i) dy_i C_i^T
//   with da_k = sum_{i >= k} dcum_i and dcum_k = sum_j M_kj e_kj
//   - sum_i M_ik e_ik + exp(cum_k) dy_k^T s C_k - h_k (+ exp(cum_L) <G, s>
//   + sum_j h_j at the last token), h_j = w_j x_j^T G B_j; dA sums
//   dt_k da_k.  dBm and dCm sum over heads (ngroups = 1), dA over batch
//   rows.
//
// What bounds it: at mamba2-2.7b's train shape (B 4, S 2048, H 80, P 64,
// N 128, bf16 x/B/C, f32 dy) the function moves 349.2 MB (x, B, C, dt, dy
// in; dx, dB, dC, ddt out): 0.104 ms at 3.35 TB/s.  Its products, 70.1
// GFLOP counted once, take 0.071 ms at the bf16 tensor-core rate and 1.05
// ms on the f32 CUDA cores.  Two routes, chosen by a rule of the shapes
// (kernel.py::route_bwd).
//
// wgmma (bf16 x, B, C; P and N multiples of 16): two sweeps and the head
// reduction, every product on the tensor cores.
//   - Sweep F (ssd_bwd_fwd_kernel) walks the blocks first to last with the
//     carried state s in f32 registers and computes everything that does
//     not depend on G: dC = D B + E s (E = exp(cum) dy) and carrE_i =
//     exp(cum_i) dy_i . (s C^T)_i, written per (b, h, token).  Sweep R
//     (ssd_bwd_rev_kernel) walks last to first with G in f32 registers and
//     computes dx, dB, ddt and dA.  The states never go to device memory
//     whole: the state-out term of dcum at a block's last token,
//     exp(cum_L) <G, s> + sum_j h_j, is delta_k = <G_k, state leaving
//     block k>, and delta_{k-1} = delta_k - sum_j h_j + sum_i carrE_i
//     from delta = <dstate, final state> (sweep F's last act).  In f32
//     that recurrence over a whole row loses dA's cancellation, so sweep F
//     keeps the state entering every 4th block (73.4 MB at the train
//     shape) and sweep R restarts delta from it there.
//   - Each sweep is warp-specialized: the intra warpgroup's first warp
//     keeps a two-stage TMA ring of C, B and x tiles (64 tokens; zeros
//     past S, N and P, so the last block may be short) and scans dt A,
//     one block ahead, when the state's handshake shows the other stage
//     free (a producer warp of its own made the launch 288 or 384 threads,
//     and ptxas then gave every thread 168 registers, spilled and
//     serialized the wgmmas, setmaxnreg or not; 256 threads get 255); an
//     "intra" warpgroup
//     runs the products of the 64 x 64 quadratic form (C B^T and dy x^T)
//     and what follows from them; a "state" warpgroup runs the serial
//     chain (s in F, G in R) with the chain's f32 values as register A
//     operands, as the forward kernel holds its state.  They trade tiles
//     through shared memory under mbarriers (s_hi / G_hi: state -> intra;
//     in R dy, E and M: intra -> state).
//   - Exactness: x, B and C are exact in bf16; each f32 operand goes to
//     the tensor cores as one, two or three bf16 terms (hi, mid, lo), the
//     products of the terms summed in the f32 accumulator.  Three where
//     dA's cancellation needs f32's own precision (s and w x in F's chain
//     and in s C^T, G in G B^T, E in G's update), two where ddt or a bf16
//     output needs 2^-16 (dy in dy x^T and in M^T dy; M; D), one where only
//     a bf16 output is reached (E s in dC, (w x) G_hi in dB).  The table
//     and the reason for each are ref.py::BWD_TERMS, decided on the CPU by
//     ref.py::ssd_chunk_scan_bwd_split_ref, which is this route written
//     plainly.
//   - Heads: dB and dC sum over heads (ngroups = 1).  The H heads of a
//     batch row run as clusters of CL blocks (CL the largest of 8, 4, 2, 1
//     dividing H: kernel.py::cluster_bwd); each block writes its [64, N]
//     f32 tile into its shared memory and sums 64 / CL of the rows over
//     the CL tiles in rank order through distributed shared memory, so the
//     partials are [B, H / CL, S, N] (41.9 MB each at the train shape,
//     against 335.5 MB a head) and the reduction kernel sums H / CL of
//     them in order.  No atomics: two calls give the same bits.
//   - Scratch at the train shape: the kept states 73.4 MB, carrE 2.6 MB,
//     the dB and dC partials 41.9 MB each, dA's and delta's [B, H].
//
// cuda_core (f32 inputs, ragged P or N): the simple first kernel, every
// product in f32 on the CUDA cores (ssd_bwd_kernel, ssd_bwd_reduce_kernel).
//   - One CTA walks one (b, h), 256 threads as 16 x 16, each holding 4 x 4
//     (or 4 x 8) outputs of a tile in registers, as the forward's CUDA-core
//     kernel does.  G, the [P, N] cotangent, lives in shared memory for the
//     whole walk.
//   - Block-start states: recomputed by the same CTA in a first, forward
//     sweep and written to a scratch of [B, H, nblk, P, N] f32 (335.5 MB
//     at the train shape), which the reverse walk reads back.
//   - dB and dC across heads, deterministic: the walk writes per-head
//     partials [B, H, S, N] f32 (335.5 MB each at the train shape), and
//     ssd_bwd_reduce_kernel sums them over h in order (dA's per-(b, h)
//     partials over b).
//   Shared rows of N values are padded to 129 floats and rows of P or L
//   values to 65, so a warp's 16 rows at one column fall on distinct
//   banks.
//
// Overflow (both routes): exp(cum_i - cum_j) is formed from the difference
// and only for j <= i (a select, never a 0/1 multiply), as in the forward,
// so dt of 0, tiny or negative gives what the plain version gives.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int L = 64;            // tokens of a block
constexpr int PMAX = 64;         // largest head_dim P
constexpr int NMAX = 128;        // largest state N
constexpr int LDN = NMAX + 1;    // row stride of the [*, N] tiles
constexpr int LDP = PMAX + 1;    // row stride of the [L, P] tiles
constexpr int LDT = L + 1;       // row stride of the [L, L] tiles
constexpr int THREADS = 256;     // 16 x 16 threads: (ty, tx)
constexpr int RTHREADS = 256;    // threads of the reduction kernel
constexpr int NVEC = 8;          // [L] vectors of a block, below

// dynamic shared memory of ssd_bwd_kernel, in floats: G and s [PMAX][LDN];
// B and C [L][LDN]; x and dy [L][LDP]; M and D [L][LDT]; column partials of
// Z = M e and K e [16][L] each; NVEC [L] vectors; 8 floats of warp sums
constexpr int SMEM_FLOATS = (2 * PMAX * LDN + 2 * L * LDN + 2 * L * LDP +
                             2 * L * LDT + 2 * 16 * L + NVEC * L + 8);
constexpr size_t SMEM_BYTES = sizeof(float) * SMEM_FLOATS;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// rows [0, rows) of a matrix with row stride ``stride`` (``cols`` values
// used) into a [L][ld] tile; zeros past rows and cols
template <typename T>
__device__ __forceinline__ void load_tile(float* tile, int ld, const T* src,
                                          size_t stride, int rows, int cols,
                                          int maxcols) {
  for (int e = threadIdx.x; e < L * maxcols; e += THREADS) {
    const int r = e / maxcols, c = e % maxcols;
    tile[r * ld + c] =
        (r < rows && c < cols) ? to_f32(src[r * stride + c]) : 0.f;
  }
}

// the in-block cumsum of dt * A into cum[0, L) (warp 0: two tokens a lane,
// then a shuffle scan); tokens past n have dt 0
__device__ __forceinline__ void block_cumsum(const float* dts, float* cum,
                                             float a_h) {
  const int lane = threadIdx.x % 32;
  if (threadIdx.x < 32) {
    const float v0 = __fmul_rn(dts[2 * lane], a_h);
    const float v1 = __fmul_rn(dts[2 * lane + 1], a_h);
    float incl = v0 + v1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += u;
    }
    float before = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) before = 0.f;
    cum[2 * lane] = before + v0;
    cum[2 * lane + 1] = before + v0 + v1;
  }
}

// sum over the 16 threads of a half-warp that share ty
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    ssd_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const T* __restrict__ Bm,
                   const T* __restrict__ Cm, const float* __restrict__ dy,
                   const float* __restrict__ dstate, T* __restrict__ dx,
                   float* __restrict__ ddt, float* __restrict__ states,
                   float* __restrict__ dBp, float* __restrict__ dCp,
                   float* __restrict__ dAp, int S, int H, int P, int N) {
  extern __shared__ __align__(16) float smem[];
  float* Gs = smem;                  // [PMAX][LDN] cotangent of the state
  float* Ss = Gs + PMAX * LDN;       // [PMAX][LDN] state entering the block
  float* Bs = Ss + PMAX * LDN;       // [L][LDN]
  float* Cs = Bs + L * LDN;          // [L][LDN]
  float* Xs = Cs + L * LDN;          // [L][LDP]
  float* Ys = Xs + L * LDP;          // [L][LDP] dy
  float* Ms = Ys + L * LDP;          // [L][LDT] M_ij
  float* Ds = Ms + L * LDT;          // [L][LDT] D_ij
  float* colZ = Ds + L * LDT;        // [16][L] column partials of M e
  float* colK = colZ + 16 * L;       // [16][L] column partials of K e
  float* dts = colK + 16 * L;        // [L] dt (0 past the block)
  float* cum = dts + L;              // [L]
  float* ecum = cum + L;             // [L] exp(cum_i)
  float* keep = ecum + L;            // [L] exp(cum_L - cum_j)
  float* wv = keep + L;              // [L] w_j
  float* rowZ = wv + L;              // [L] row sums of M e
  float* gbx = rowZ + L;             // [L] x_j^T G B_j
  float* carr = gbx + L;             // [L] C_i . s^T dy_i
  float* v8 = carr + L;              // 8 warp sums

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int lane = tid % 32, warp = tid / 32;
  const float a_h = A[h];
  const size_t HP = static_cast<size_t>(H) * P;
  const size_t row0 = static_cast<size_t>(b) * S;
  const int nblk = (S + L - 1) / L;
  const size_t PN = static_cast<size_t>(P) * N;
  float* my_states = states + (static_cast<size_t>(b) * H + h) * nblk * PN;

  // the token window [c0, c0 + n) of block k: dt, cum, exp vectors
  auto block_vectors = [&](int c0, int n) {
    for (int t = tid; t < L; t += THREADS)
      dts[t] = t < n ? dt[(row0 + c0 + t) * H + h] : 0.f;
    __syncthreads();
    block_cumsum(dts, cum, a_h);
    __syncthreads();
    const float cl = cum[n - 1];
    for (int t = tid; t < L; t += THREADS) {
      const bool in = t < n;
      ecum[t] = in ? expf(cum[t]) : 0.f;
      keep[t] = in ? expf(cl - cum[t]) : 0.f;
      wv[t] = in ? keep[t] * dts[t] : 0.f;
    }
  };

  // ---- sweep 1: the state entering each block, into the scratch ----
  // thread (ty, tx) owns state rows p = ty + 16a, columns n = tx + 16c
  {
    float sacc[4][8];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 8; ++c) sacc[a][c] = 0.f;
    for (int k = 0; k + 1 < nblk; ++k) {
      const int c0 = k * L, n = min(L, S - c0);
      block_vectors(c0, n);
      __syncthreads();
      load_tile(Xs, LDP, x + (row0 + c0) * HP + h * P, HP, n, P, PMAX);
      for (int e = tid; e < L * NMAX; e += THREADS) {
        const int r = e / NMAX, c = e % NMAX;
        Bs[r * LDN + c] =
            (r < n && c < N) ? to_f32(Bm[(row0 + c0 + r) * N + c]) * wv[r]
                             : 0.f;
      }
      __syncthreads();
      const float kl = expf(cum[n - 1]);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 8; ++c) sacc[a][c] *= kl;
      for (int j = 0; j < n; ++j) {
        float xv[4], bv[8];
#pragma unroll
        for (int a = 0; a < 4; ++a) xv[a] = Xs[j * LDP + ty + 16 * a];
#pragma unroll
        for (int c = 0; c < 8; ++c) bv[c] = Bs[j * LDN + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 8; ++c)
            sacc[a][c] = fmaf(xv[a], bv[c], sacc[a][c]);
      }
      float* out = my_states + (k + 1) * PN;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int p = ty + 16 * a;
        if (p >= P) continue;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int nn = tx + 16 * c;
          if (nn < N) out[p * N + nn] = sacc[a][c];
        }
      }
      __syncthreads();               // Xs, Bs and the vectors are reused
    }
  }

  // ---- the reverse walk ----
  for (int e = tid; e < PMAX * LDN; e += THREADS) {
    const int p = e / LDN, nn = e % LDN;
    Gs[e] = (dstate && p < P && nn < N)
                ? dstate[(static_cast<size_t>(b) * H + h) * PN + p * N + nn]
                : 0.f;
  }
  float dA_acc = 0.f;                // thread 0's running sum of dt da
  for (int k = nblk - 1; k >= 0; --k) {
    const int c0 = k * L, n = min(L, S - c0);
    block_vectors(c0, n);
    load_tile(Xs, LDP, x + (row0 + c0) * HP + h * P, HP, n, P, PMAX);
    load_tile(Ys, LDP, dy + (row0 + c0) * HP + h * P, HP, n, P, PMAX);
    load_tile(Bs, LDN, Bm + (row0 + c0) * N, N, n, N, NMAX);
    load_tile(Cs, LDN, Cm + (row0 + c0) * N, N, n, N, NMAX);
    const float* sk = my_states + k * PN;
    for (int e = tid; e < PMAX * LDN; e += THREADS) {
      const int p = e / LDN, nn = e % LDN;
      Ss[e] = (k > 0 && p < P && nn < N) ? sk[p * N + nn] : 0.f;
    }
    __syncthreads();

    // (1) C B^T and dy x^T, 4 x 4 of [i][j] a thread (i = ty + 16a, j =
    // tx + 16c): M and D into shared memory, the row sums of Z = M e, the
    // column partials of Z and of K e = (C . B) decay e
    {
      float cb[4][4], ee[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) cb[a][c] = ee[a][c] = 0.f;
      for (int nn = 0; nn < N; ++nn) {
        float cv[4], bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = Cs[(ty + 16 * a) * LDN + nn];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = Bs[(tx + 16 * c) * LDN + nn];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) cb[a][c] = fmaf(cv[a], bv[c], cb[a][c]);
      }
      for (int p = 0; p < P; ++p) {
        float yv[4], xv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) yv[a] = Ys[(ty + 16 * a) * LDP + p];
#pragma unroll
        for (int c = 0; c < 4; ++c) xv[c] = Xs[(tx + 16 * c) * LDP + p];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) ee[a][c] = fmaf(yv[a], xv[c], ee[a][c]);
      }
      float zc[4] = {0.f, 0.f, 0.f, 0.f}, kc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ty + 16 * a;
        float zr = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tx + 16 * c;
          // select, never multiply by a 0 mask: above the diagonal the
          // exponent is positive and may be inf
          const float decay =
              (i < n && j <= i) ? expf(cum[i] - cum[j]) : 0.f;
          const float kk = cb[a][c] * decay;
          const float m = kk * dts[j];
          const float z = m * ee[a][c];
          Ms[i * LDT + j] = m;
          Ds[i * LDT + j] = decay * dts[j] * ee[a][c];
          zr += z;
          zc[c] += z;
          kc[c] += kk * ee[a][c];
        }
        zr = half_warp_sum(zr);
        if (tx == 0) rowZ[i] = zr;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        colZ[ty * L + tx + 16 * c] = zc[c];
        colK[ty * L + tx + 16 * c] = kc[c];
      }
    }
    __syncthreads();

    // (2a) dx [j][p] (j = ty + 16a, p = tx + 16c) = M^T dy + w_j G B_j, and
    // x_j^T G B_j
    {
      float acc[4][4], gb[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = gb[a][c] = 0.f;
      for (int i = 0; i < n; ++i) {
        float mv[4], yv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) mv[a] = Ms[i * LDT + ty + 16 * a];
#pragma unroll
        for (int c = 0; c < 4; ++c) yv[c] = Ys[i * LDP + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(mv[a], yv[c], acc[a][c]);
      }
      for (int nn = 0; nn < N; ++nn) {
        float bv[4], gv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) bv[a] = Bs[(ty + 16 * a) * LDN + nn];
#pragma unroll
        for (int c = 0; c < 4; ++c) gv[c] = Gs[(tx + 16 * c) * LDN + nn];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) gb[a][c] = fmaf(bv[a], gv[c], gb[a][c]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int j = ty + 16 * a;
        float part = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = tx + 16 * c;
          part += Xs[j * LDP + p] * gb[a][c];
          if (j < n && p < P)
            dx[(row0 + c0 + j) * HP + h * P + p] =
                from_f32<T>(fmaf(wv[j], gb[a][c], acc[a][c]));
        }
        part = half_warp_sum(part);
        if (tx == 0) gbx[j] = part;
      }
    }

    // (2b) dC [i][n] (i = ty + 16a, n = tx + 16c) = D B + exp(cum_i) s^T
    // dy_i, and C_i . s^T dy_i; per-head partials
    {
      float acc[4][8], sd[4][8];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[a][c] = sd[a][c] = 0.f;
      for (int j = 0; j < n; ++j) {
        float dv[4], bv[8];
#pragma unroll
        for (int a = 0; a < 4; ++a) dv[a] = Ds[(ty + 16 * a) * LDT + j];
#pragma unroll
        for (int c = 0; c < 8; ++c) bv[c] = Bs[j * LDN + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[a][c] = fmaf(dv[a], bv[c], acc[a][c]);
      }
      if (k > 0) {                     // s is zero in the first block
        for (int p = 0; p < P; ++p) {
          float yv[4], sv[8];
#pragma unroll
          for (int a = 0; a < 4; ++a) yv[a] = Ys[(ty + 16 * a) * LDP + p];
#pragma unroll
          for (int c = 0; c < 8; ++c) sv[c] = Ss[p * LDN + tx + 16 * c];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 8; ++c) sd[a][c] = fmaf(yv[a], sv[c], sd[a][c]);
        }
      }
      float* out = dCp + ((static_cast<size_t>(b) * H + h) * S + c0) * N;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ty + 16 * a;
        float part = 0.f;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int nn = tx + 16 * c;
          part += Cs[i * LDN + nn] * sd[a][c];
          if (i < n && nn < N)
            out[i * N + nn] = fmaf(ecum[i], sd[a][c], acc[a][c]);
        }
        part = half_warp_sum(part);
        if (tx == 0) carr[i] = part;
      }
    }

    // (2c) dB [j][n] (j = ty + 16a, n = tx + 16c) = D^T C + w_j G^T x_j;
    // per-head partials
    {
      float acc[4][8], gx[4][8];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[a][c] = gx[a][c] = 0.f;
      for (int i = 0; i < n; ++i) {
        float dv[4], cv[8];
#pragma unroll
        for (int a = 0; a < 4; ++a) dv[a] = Ds[i * LDT + ty + 16 * a];
#pragma unroll
        for (int c = 0; c < 8; ++c) cv[c] = Cs[i * LDN + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[a][c] = fmaf(dv[a], cv[c], acc[a][c]);
      }
      for (int p = 0; p < P; ++p) {
        float xv[4], gv[8];
#pragma unroll
        for (int a = 0; a < 4; ++a) xv[a] = Xs[(ty + 16 * a) * LDP + p];
#pragma unroll
        for (int c = 0; c < 8; ++c) gv[c] = Gs[p * LDN + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 8; ++c) gx[a][c] = fmaf(xv[a], gv[c], gx[a][c]);
      }
      float* out = dBp + ((static_cast<size_t>(b) * H + h) * S + c0) * N;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int j = ty + 16 * a;
        if (j >= n) continue;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int nn = tx + 16 * c;
          if (nn < N) out[j * N + nn] = fmaf(wv[j], gx[a][c], acc[a][c]);
        }
      }
    }

    // (2d) the next G [p][n] (p = ty + 16a, n = tx + 16c) = exp(cum_L) G +
    // sum_i exp(cum_i) dy_i C_i^T, held until every read of G is done;
    // <G, s> summed over the block
    float gnew[4][8];
    {
      const float kl = expf(cum[n - 1]);
      float gs = 0.f;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float g = Gs[(ty + 16 * a) * LDN + tx + 16 * c];
          gs = fmaf(g, Ss[(ty + 16 * a) * LDN + tx + 16 * c], gs);
          gnew[a][c] = g * kl;
        }
      for (int i = 0; i < n; ++i) {
        float yv[4], cv[8];
        const float ec = ecum[i];
#pragma unroll
        for (int a = 0; a < 4; ++a) yv[a] = Ys[i * LDP + ty + 16 * a] * ec;
#pragma unroll
        for (int c = 0; c < 8; ++c) cv[c] = Cs[i * LDN + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 8; ++c)
            gnew[a][c] = fmaf(yv[a], cv[c], gnew[a][c]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        gs += __shfl_xor_sync(0xffffffffu, gs, off);
      if (lane == 0) v8[warp] = gs;
    }
    __syncthreads();                   // every read of G, x, dy, B, C done

#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        Gs[(ty + 16 * a) * LDN + tx + 16 * c] = gnew[a][c];

    // (3) dcum, its reverse cumsum da, ddt and dA: warp 0, tokens 2 lane
    // and 2 lane + 1
    if (warp == 0) {
      float gs = 0.f;
#pragma unroll
      for (int w = 0; w < THREADS / 32; ++w) gs += v8[w];
      float dc[2], hv[2];
      float hsum = 0.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int t = 2 * lane + u;
        float cz = 0.f;
        for (int r = 0; r < 16; ++r) cz += colZ[r * L + t];
        hv[u] = wv[t] * gbx[t];
        hsum += hv[u];
        dc[u] = t < n ? rowZ[t] - cz - hv[u] + ecum[t] * carr[t] : 0.f;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        hsum += __shfl_xor_sync(0xffffffffu, hsum, off);
#pragma unroll
      for (int u = 0; u < 2; ++u)
        if (2 * lane + u == n - 1) dc[u] += expf(cum[n - 1]) * gs + hsum;
      // suffix sums: da_t = sum_{i >= t} dcum_i
      const float pair = dc[0] + dc[1];
      float incl = pair;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_down_sync(0xffffffffu, incl, off);
        if (lane + off < 32) incl += u;
      }
      float after = __shfl_down_sync(0xffffffffu, incl, 1);  // lanes above
      if (lane == 31) after = 0.f;
      const float da[2] = {after + dc[0] + dc[1], after + dc[1]};
      float dsum = 0.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int t = 2 * lane + u;
        if (t >= n) continue;
        float ck = 0.f;
        for (int r = 0; r < 16; ++r) ck += colK[r * L + t];
        ddt[(row0 + c0 + t) * H + h] =
            ck + keep[t] * gbx[t] + a_h * da[u];
        dsum = fmaf(dts[t], da[u], dsum);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dsum += __shfl_xor_sync(0xffffffffu, dsum, off);
      dA_acc += dsum;
    }
    __syncthreads();                   // G written; the vectors are free
  }
  if (tid == 0) dAp[static_cast<size_t>(b) * H + h] = dA_acc;
}

// dBm, dCm [b, t, n] = sum over the HP partials of row b, in order (one
// a head on the CUDA-core route, one a cluster of heads on the wgmma
// route); dA [h] = sum over b, in order
template <typename T>
__global__ void __launch_bounds__(RTHREADS)
    ssd_bwd_reduce_kernel(const float* __restrict__ dBp,
                          const float* __restrict__ dCp,
                          const float* __restrict__ dAp, T* __restrict__ dB,
                          T* __restrict__ dC, float* __restrict__ dA,
                          int Bsz, int S, int HP, int H, int N) {
  const size_t SN = static_cast<size_t>(S) * N;
  const size_t total = static_cast<size_t>(Bsz) * SN;
  for (size_t e = static_cast<size_t>(blockIdx.x) * RTHREADS + threadIdx.x;
       e < total; e += static_cast<size_t>(gridDim.x) * RTHREADS) {
    const size_t b = e / SN, r = e % SN;
    const float* pb = dBp + b * HP * SN + r;
    const float* pc = dCp + b * HP * SN + r;
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < HP; ++h) {
      sb += pb[h * SN];
      sc += pc[h * SN];
    }
    dB[e] = from_f32<T>(sb);
    dC[e] = from_f32<T>(sc);
  }
  if (blockIdx.x == 0)
    for (int h = threadIdx.x; h < H; h += RTHREADS) {
      float s = 0.f;
      for (int b = 0; b < Bsz; ++b) s += dAp[static_cast<size_t>(b) * H + h];
      dA[h] = s;
    }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* dy, const void* dstate, void* dx,
           void* ddt, void* dA, void* dB, void* dC, void* states, void* dBp,
           void* dCp, void* dAp, int Bsz, int S, int H, int P, int N,
           int reduce_blocks, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_kernel<T><<<dim3(H, Bsz), THREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(dy),
      static_cast<const float*>(dstate), static_cast<T*>(dx),
      static_cast<float*>(ddt), static_cast<float*>(states),
      static_cast<float*>(dBp), static_cast<float*>(dCp),
      static_cast<float*>(dAp), S, H, P, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_reduce_kernel<T><<<reduce_blocks, RTHREADS, 0, stream>>>(
      static_cast<const float*>(dBp), static_cast<const float*>(dCp),
      static_cast<const float*>(dAp), static_cast<T*>(dB),
      static_cast<T*>(dC), static_cast<float*>(dA), Bsz, S, H, H, N);
  return static_cast<int>(cudaGetLastError());
}



// ---------------------------------------------------------------------------
// The tensor-core route (see the note at the top)
// ---------------------------------------------------------------------------
namespace tcb {

// mbarriers, TMA, descriptors and wgmma (kernels/csrc/hopper.cuh)
using namespace hopper;

constexpr int L = 64;             // tokens of a block: the wgmma's 64 rows
constexpr int WG = 128;           // threads of a warpgroup
constexpr int NTHREADS = 2 * WG;  // the state and intra warpgroups
constexpr int NS = 2;             // stages of the TMA ring
constexpr int CKPT = 4;           // ref.py::BWD_CKPT
constexpr int TILE = L * 64 * 2;  // a [64][64] bf16 tile, 128-byte rows

// Shared memory, every tile on a 1024-byte boundary in the 128-byte
// swizzle, a [64][NP] tile as NP / 64 chunks of [64][64].  NP is N rounded
// up to 64; P is padded to 64 columns (zeros from TMA past P).
//   ring, NS stages: C and B [64 t][NP], x [64 t][64 p] (TMA);
//   sweep F: s_hi [64 p][NP] twice (the state's operand copy, state ->
//     intra), w x [64 j][64 p] in three terms (the state's own), the
//     exchange tile;
//   sweep R: dy hi, lo [64 i][64 p], E = exp(cum) dy in three terms, M hi,
//     lo [64 j][64 i] (intra -> state), G_hi [64 p][NP] twice (state ->
//     intra), the exchange tile, the dx staging tile [64 j][64 p].
// The exchange tile is the head sum's receive tile: CL slots of 64 / CL
// rows, [64][NP] f32 in all, rows of NP + 8 floats (a warp's float2
// stores of 8 rows fall on distinct banks).
template <int NP> struct Geo {
  static constexpr int C = L * NP * 2;
  static constexpr int B = C;
  static constexpr int STAGE = C + B + TILE;
  static constexpr int ST = 64 * NP * 2;          // a [64][NP] bf16 tile
  static constexpr int LDX = NP + 8;
  static constexpr int XCH = L * LDX * 4;
  static constexpr size_t F_BYTES =
      1024 + NS * STAGE + 2 * ST + 3 * TILE + XCH;
  static constexpr size_t R_BYTES =
      1024 + NS * STAGE + 2 * TILE + 3 * TILE + 2 * TILE + 2 * ST + XCH +
      TILE;
};

// byte offset of element (r, c) of a [rows][64] bf16 tile of 128-byte
// rows, 128-byte swizzle; of element (r, c) of a chunked [64][NP] tile
__device__ __forceinline__ int swz128(int r, int c) {
  return r * 128 + (((c >> 3) ^ (r & 7)) << 4) + (c & 7) * 2;
}
__device__ __forceinline__ int swzc(int r, int c) {
  return (c >> 6) * TILE + swz128(r, c & 63);
}
// descriptors are built once a block and stepped by byte offsets (their
// start-address field counts 16-byte units)
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
// shared-memory accesses at byte offset ``off`` of a tile, as plain C++
// so the compiler can schedule them (inline asm would pin their order)
__device__ __forceinline__ void sts32(uint8_t* t, int off, uint32_t v) {
  *reinterpret_cast<uint32_t*>(t + off) = v;
}
__device__ __forceinline__ uint32_t lds32(const uint8_t* t, int off) {
  return *reinterpret_cast<const uint32_t*>(t + off);
}
__device__ __forceinline__ void sts128(uint8_t* t, int off, uint4 v) {
  *reinterpret_cast<uint4*>(t + off) = v;
}
__device__ __forceinline__ uint4 lds128(const uint8_t* t, int off) {
  return *reinterpret_cast<const uint4*>(t + off);
}

// Sum v[0..15] over the 8 lanes that share lane % 4 (lane bits 2-4), by
// halving: 14 shuffles.  Lane l ends with the sums of v[k], k = 8 (l >> 4
// & 1) + 4 (l >> 3 & 1) + 2 (l >> 2 & 1) + i, in out[i], i = 0, 1.
__device__ __forceinline__ void sum8_transposed(float (&v)[16],
                                                float (&out)[2]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int m = 16, half = 8; m >= 4; m >>= 1, half >>= 1) {
    const bool up = lane & m;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = up ? v[i] : v[i + half];
      const float keep = up ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
    }
  }
  out[0] = v[0];
  out[1] = v[1];
}
// the index k of out[i] of sum8_transposed for this lane
__device__ __forceinline__ int sum8_index(int i) {
  const int lane = threadIdx.x % 32;
  return 8 * ((lane >> 4) & 1) + 4 * ((lane >> 3) & 1) +
         2 * ((lane >> 2) & 1) + i;
}
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float lo_f(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi_f(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}
// (a, b) as bf16 terms packed in pairs: hi = bf16(v), then bf16 of what is
// left (ref.py::bf16_terms)
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const float ra = a - hf.x, rb = b - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(ra, rb);
  const float2 mf = __bfloat1622float2(m);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(ra - mf.x, rb - mf.y));
}

// A thread's place in an m64nX accumulator: entry 4 g + r at row rq + 8 (r
// / 2), column 8 g + cq + r % 2.  Entries 8 kk .. 8 kk + 7 (columns 16 kk
// .. 16 kk + 15), paired, are the register A fragment of depth step kk.
struct Lane {
  int w, lane, rq, cq;
  __device__ explicit Lane(int wt)
      : w(wt / 32), lane(wt % 32), rq(16 * (wt / 32) + (wt % 32) / 4),
        cq(2 * (wt % 4)) {}
  __device__ int row(int e) const { return rq + 8 * ((e >> 1) & 1); }
  __device__ int col(int e) const { return 8 * (e >> 2) + cq + (e & 1); }
};

// The sweeps' static shared memory: the mbarriers; per token of a stage,
// (cum log2 e, dt, exp(cum), exp(cum_L - cum)), cum the in-block cumsum
// of dt A; the quadratic form's exp(cum_i - cum_j) = 2^(c2_i - c2_j), c2 =
// cum log2 e, rounded as expf of the difference is
// (dt 0 past the sequence's end, where cum stays flat), written by the
// intra warpgroup's first warp, so no other thread forms a per-token
// exponential; and the warps' partial sums.  7,280 bytes
// (geometry.py::TC_STATIC_SMEM).
struct Shared {
  uint64_t full[NS];
  uint64_t pready[2], pfree[2];     // the state's tile: state -> intra
  uint64_t tready, tfree;           // sweep R's intra tiles: intra -> state
  uint64_t xready, xfree;           // the exchange, across the cluster
  float4 tok[NS][L];
  float red[2][4][L];               // per-warp partial sums over rows
  float vec[2][2][L];               // sweep R: colZ, colK
  float rowz[2][4][L];              // sweep R: rowZ by warp
  float wsum[2][4];                 // per-warp sums
};

// D[64 x NP] += A[64 x 16] (registers) B[16 x NP] (MN-major)
template <int NP>
__device__ __forceinline__ void wgmma_rs_n(float (&d)[NP / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  if constexpr (NP == 128)
    wgmma_rs(d, a, db, 1);
  else
    wgmma_rs<1>(d, a, db, 1);
}

// Block n of a sweep (blocks in order for sweep F, last to first for R)
// into stage n % NS, by the intra warpgroup's first warp: lane 0 copies
// its C, B and x tiles by TMA (C and B boxes of 64 tokens x 64 columns, x
// one of 64 tokens x 1 head x 64 columns; zeros past S, N and P), every
// lane takes the dt of two tokens (``block_dt``), and the warp scans dt A
// and writes the tokens' exponentials.  The caller knows the stage is
// free: both warpgroups are done with block n - NS.
template <int NP>
__device__ __forceinline__ void load_block(Shared& sh, uint8_t* ring,
                                           const CUtensorMap* tx,
                                           const CUtensorMap* tb,
                                           const CUtensorMap* tcm,
                                           float2 d, float a_h, int b,
                                           int h, int nblk, int n,
                                           bool reverse) {
  using G = Geo<NP>;
  const int lane = threadIdx.x % 32;
  const int c = reverse ? nblk - 1 - n : n, s = n % NS, t0 = c * L;
  if (lane == 0) {
    uint8_t* st = ring + s * G::STAGE;
    mbar_expect_tx_only(&sh.full[s], G::STAGE);
#pragma unroll
    for (int k = 0; k < NP / 64; ++k) {
      tma_load_3d(st + k * TILE, tcm, &sh.full[s], 64 * k, t0, b);
      tma_load_3d(st + G::C + k * TILE, tb, &sh.full[s], 64 * k, t0, b);
    }
    tma_load_4d(st + G::C + G::B, tx, &sh.full[s], 0, h, t0, b);
  }
  const float a0 = __fmul_rn(d.x, a_h), a1 = __fmul_rn(d.y, a_h);
  float incl = a0 + a1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  float before = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) before = 0.f;
  const float c0 = before + a0, c1 = before + a0 + a1;
  const float cl = __shfl_sync(0xffffffffu, c1, 31);
  sh.tok[s][2 * lane] =
      make_float4(c0 * LOG2E, d.x, expf(c0), expf(cl - c0));
  sh.tok[s][2 * lane + 1] =
      make_float4(c1 * LOG2E, d.y, expf(c1), expf(cl - c1));
  __syncwarp();
  if (lane == 0) mbar_arrive(&sh.full[s]);   // after the warp's writes
}

// the dt of tokens 2 lane and 2 lane + 1 of block n (0 past S), loaded a
// block before load_block takes them
__device__ __forceinline__ float2 block_dt(const float* dt, int b, int h,
                                           int S, int H, int nblk, int n,
                                           bool reverse) {
  const int c = reverse ? nblk - 1 - n : n;
  const int u = c * L + 2 * (threadIdx.x % 32);
  const float* dp = dt + (static_cast<size_t>(b) * S + u) * H + h;
  return make_float2(u < S ? dp[0] : 0.f, u + 1 < S ? dp[H] : 0.f);
}

// The head sum of a [64 tokens][NP] f32 tile across the cluster's CL
// blocks (ranks = heads h0 .. h0 + CL - 1), in two halves.  Rank r owns
// rows [r R, r R + R) (R = 64 / CL) of the tile and holds CL slots of
// them, one a source rank, in its receive tile X ([CL][R][NP + 8] f32).
// ``push``: a block stores its rows into their owners' slots through
// distributed shared memory (stores, which do not wait) and arrives on
// each owner's xready.  ``reduce``: an owner waits for its CL arrivals,
// sums its slots in rank order from its own shared memory into ``out``
// (the cluster's partial, rows of N floats, the block's first token at
// row 0; rows at or past ``rows`` dropped) and arrives on each source's
// xfree, which a block waits for before it pushes again.  One lane an
// arrival, all at once.  The intra warpgroup runs both, one after the
// other, each block; ``n`` counts the blocks.  (Reducing block k after
// the products of block k + 1 measured slower: the next push waits for
// every peer's reduce all the same.)
template <int NP>
__device__ __forceinline__ void push(const float (&acc)[NP / 2], Shared& sh,
                                     float* X, int n, int CL, int rank,
                                     const Lane& ln, int wt) {
  constexpr int LDX = Geo<NP>::LDX;
  const int R = L / CL;
  if (n >= 1) mbar_wait_cluster(&sh.xfree, (n - 1) & 1);
#pragma unroll
  for (int e = 0; e < NP / 2; e += 2) {
    const int r = ln.row(e);
    float* dst = &X[((rank * R) + r % R) * LDX + ln.col(e)];
    st_peer_f2(dst, r / R, acc[e], acc[e + 1]);
  }
  named_sync(2, WG);
  if (wt < CL) {
    asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
    mbar_arrive_peer(&sh.xready, wt);
  }
}
template <int NP>
__device__ __forceinline__ void reduce(Shared& sh, const float* X, int n,
                                       int CL, int rank, float* out,
                                       int rows, int N, int wt) {
  constexpr int LDX = Geo<NP>::LDX;
  const int R = L / CL, U = R * NP / 4;
  mbar_wait_cluster(&sh.xready, n & 1);
  for (int u = wt; u < U; u += WG) {
    const int r = u / (NP / 4), col = 4 * (u % (NP / 4));
    float4 sum = *reinterpret_cast<const float4*>(&X[r * LDX + col]);
    for (int q = 1; q < CL; ++q) {
      const float4 v =
          *reinterpret_cast<const float4*>(&X[(q * R + r) * LDX + col]);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    const int row = rank * R + r;
    if (row < rows && col < N)
      *reinterpret_cast<float4*>(out + static_cast<size_t>(row) * N + col) =
          sum;
  }
  named_sync(2, WG);
  if (wt < CL) mbar_arrive_peer(&sh.xfree, wt);
}

// dy [B, S, H, P] f32 of block t0 at a register A fragment's places (rows
// i = rq, rq + 8; columns p = 16 kk + cq + 8 (r / 2) and the next): v[8 kk
// + 2 r], v[8 kk + 2 r + 1]; zeros past S and P
__device__ __forceinline__ void load_dy(float (&v)[32], const float* dy,
                                        size_t row0, int t0, int S, int H,
                                        int h, int P, const Lane& ln) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ln.rq + 8 * (r & 1), p = 16 * kk + 8 * (r >> 1) + ln.cq;
      float2 d = make_float2(0.f, 0.f);
      if (t0 + i < S && p < P)
        d = *reinterpret_cast<const float2*>(
            dy + ((row0 + t0 + i) * H + h) * P + p);
      v[8 * kk + 2 * r] = d.x;
      v[8 * kk + 2 * r + 1] = d.y;
    }
}

// ---------------------------------------------------------------------------
// Sweep F: blocks first to last.  The state warpgroup holds s [64 p, NP n]
// in f32 registers (an m64nNP accumulator) and per block: keeps it every
// CKPT-th block, publishes its bf16 copy s_hi, computes s C^T [p, i] (s as
// a register A operand in three terms, C K-major) and carrE_i = exp(cum_i)
// sum_p dy_i[p] (s C^T)[p, i] into ``carrE``, makes w x in three terms and
// updates s = s exp(cum_L) + (w x)^T B (w x an MN-major A, B an MN-major
// B).  The intra warpgroup computes C B^T (both K-major) and e = dy x^T
// (dy as a register A operand in two terms, x K-major), D = decay dt_j e,
// then dC = E s_hi + D B (E = exp(cum) dy and D as register A operands,
// s_hi and B MN-major) and sums it over the cluster's heads.  After the
// last block the state writes delta = <dstate, s>.
// ---------------------------------------------------------------------------
template <int NP>
__global__ void __launch_bounds__(NTHREADS, 1)
    ssd_bwd_fwd_kernel(const __grid_constant__ CUtensorMap tx,
                       const __grid_constant__ CUtensorMap tb,
                       const __grid_constant__ CUtensorMap tcm,
                       const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const float* __restrict__ dy,
                       const float* __restrict__ dstate,
                       float* __restrict__ ckpt, float* __restrict__ carrE,
                       float* __restrict__ delta, float* __restrict__ dCp,
                       int S, int H, int P, int N, int CL) {
  using G = Geo<NP>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ Shared sh;
  uint8_t* ring = align1024(smem_raw);
  uint8_t* sbuf = ring + NS * G::STAGE;           // s_hi [q] at + q ST
  uint8_t* wxbuf = sbuf + 2 * G::ST;              // w x, 3 terms
  float* X = reinterpret_cast<float*>(wxbuf + 3 * TILE);

  const int tid = threadIdx.x, h = blockIdx.x, b = blockIdx.y;
  const int nblk = (S + L - 1) / L;
  const int nck = nblk >= 2 ? (nblk - 2) / CKPT : 0;
  const size_t row0 = static_cast<size_t>(b) * S;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int rank = cluster_rank();

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) mbar_init(&sh.full[s], 1);
    for (int q = 0; q < 2; ++q) {
      mbar_init(&sh.pready[q], WG);
      mbar_init(&sh.pfree[q], WG);
    }
    mbar_init(&sh.xready, CL);
    mbar_init(&sh.xfree, CL);
    mbar_fence_init();
  }
  cluster_sync();                  // every block's barriers are ready

  if (tid < WG) {
    // ---- state warpgroup ----
    const int wt = tid;
    const Lane ln(wt);
    float st[NP / 2];
#pragma unroll
    for (int e = 0; e < NP / 2; ++e) st[e] = 0.f;
    for (int c = 0; c < nblk; ++c) {
      const int s = c % NS, q = c & 1, t0 = c * L;
      mbar_wait(&sh.full[s], (c / NS) & 1);
      const uint8_t* Cs = ring + s * G::STAGE;
      const uint8_t* Bs = Cs + G::C;
      const uint8_t* Xs = Bs + G::B;
      const float4* tk = sh.tok[s];
      // dy at s C^T's places (rows p, columns i), for carr
      float dyv[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int p = ln.row(e), i = ln.col(e);
        dyv[e] = (t0 + i < S && p < P)
                     ? dy[((row0 + t0 + i) * H + h) * P + p] : 0.f;
      }
      // the state entering every CKPT-th block, in the threads' order
      if (c % CKPT == 0 && c >= CKPT && c + 1 < nblk) {
        float4* out = reinterpret_cast<float4*>(ckpt) +
                      ((bh * nck + c / CKPT - 1) * (NP / 8)) * WG + wt;
#pragma unroll
        for (int e4 = 0; e4 < NP / 8; ++e4)
          out[e4 * WG] = make_float4(st[4 * e4], st[4 * e4 + 1],
                                     st[4 * e4 + 2], st[4 * e4 + 3]);
      }
      // s_hi for the intra warpgroup's E s
      if (c >= 2) mbar_wait(&sh.pfree[q], ((c - 2) >> 1) & 1);
      uint8_t* sb = sbuf + q * G::ST;
#pragma unroll
      for (int e = 0; e < NP / 2; e += 2)
        sts32(sb, swzc(ln.row(e), ln.col(e)), pack_bf16(st[e], st[e + 1]));
      fence_proxy_async();
      mbar_arrive(&sh.pready[q]);

      // s C^T [p, i], s in three terms; 64 columns of n at a time
      float sc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = 0.f;
      const uint64_t dc = kmajor<NP>(Cs, L, 0, 0);
#pragma unroll
      for (int half = 0; half < NP / 64; ++half) {
        uint32_t a0[4][4], a1[4][4], a2[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int e = 8 * (4 * half + kk) + 2 * r;
            split3(st[e], st[e + 1], a0[kk][r], a1[kk][r], a2[kk][r]);
          }
        pin(sc);
        pin(a0);
        pin(a1);
        pin(a2);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t d = desc_add(dc, kstep<NP>(L, 4 * half + kk));
          wgmma_rs<0>(sc, a0[kk], d, 1);
          wgmma_rs<0>(sc, a1[kk], d, 1);
          wgmma_rs<0>(sc, a2[kk], d, 1);
        }
        wg_commit();
        wg_wait<0>();
        pin(sc);
        pin(a0);
        pin(a1);
        pin(a2);
      }
      // carr: sum over p (rows) of dy_i[p] (s C^T)[p, i], then the warps
      float part[16], tot[2];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int e0 = 4 * (k >> 1) + (k & 1);     // rows rq and rq + 8
        part[k] = dyv[e0] * sc[e0] + dyv[e0 + 2] * sc[e0 + 2];
      }
      sum8_transposed(part, tot);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int k = sum8_index(i);
        sh.red[0][ln.w][8 * (k >> 1) + ln.cq + (k & 1)] = tot[i];
      }
      named_sync(1, WG);
      if (wt < L && t0 + wt < S) {
        const float* rd = &sh.red[0][0][wt];
        carrE[bh * S + t0 + wt] =
            tk[wt].z * (((rd[0] + rd[L]) + rd[2 * L]) + rd[3 * L]);
      }

      // w x = exp(cum_L - cum_j) dt_j x_j in three terms: the x tile and w
      // x share one layout, and a 16-byte unit never leaves its row
#pragma unroll
      for (int k = 0; k < L * 8 / WG; ++k) {
        const int u = wt + k * WG;                 // 16-byte unit
        const float4 tj = tk[u / 8];
        const float w = tj.w * tj.y;
        const uint4 raw = lds128(Xs, 16 * u);
        const uint32_t* xv = &raw.x;
        uint4 o0, o1, o2;
        uint32_t* p0 = &o0.x;
        uint32_t* p1 = &o1.x;
        uint32_t* p2 = &o2.x;
#pragma unroll
        for (int v = 0; v < 4; ++v)
          split3(lo_f(xv[v]) * w, hi_f(xv[v]) * w, p0[v], p1[v], p2[v]);
        sts128(wxbuf, 16 * u, o0);
        sts128(wxbuf, TILE + 16 * u, o1);
        sts128(wxbuf, 2 * TILE + 16 * u, o2);
      }
      fence_proxy_async();
      named_sync(1, WG);

      // s = s exp(cum_L) + (w x)^T B, three terms
      const float keep = tk[L - 1].z;
#pragma unroll
      for (int e = 0; e < NP / 2; ++e) st[e] *= keep;
      const uint64_t dw = mnmajor<64>(wxbuf, L, 0);
      const uint64_t dbn = mnmajor<NP>(Bs, L, 0);
      pin(st);
      wg_fence();
#pragma unroll
      for (int t = 0; t < 3; ++t)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<1, 1>(st, desc_add(dw, t * TILE + mnstep<64>(kk)),
                         desc_add(dbn, mnstep<NP>(kk)), 1);
      wg_commit();
      wg_wait<0>();
      pin(st);
    }
    // delta = <dstate, final state>
    float ds = 0.f;
    if (dstate != nullptr) {
      const float* dsp = dstate + bh * P * N;
#pragma unroll
      for (int e = 0; e < NP / 2; ++e) {
        const int p = ln.row(e), n = ln.col(e);
        if (p < P && n < N) ds = fmaf(st[e], dsp[p * N + n], ds);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ds += __shfl_xor_sync(0xffffffffu, ds, off);
    if (ln.lane == 0) sh.wsum[0][ln.w] = ds;
    named_sync(1, WG);
    if (wt == 0)
      delta[bh] = ((sh.wsum[0][0] + sh.wsum[0][1]) + sh.wsum[0][2]) +
                  sh.wsum[0][3];
  } else {
    // ---- intra warpgroup ----
    const int wt = tid - WG;
    const Lane ln(wt);
    // this cluster's partial of dCm, row b
    float* dCp_bh =
        dCp + (static_cast<size_t>(b) * (H / CL) + h / CL) * S * N;
    float dyv[32];
    load_dy(dyv, dy, row0, 0, S, H, h, P, ln);
    const float a_h = A[h];
    float2 dtn = make_float2(0.f, 0.f);   // warp 0: dt of the next load
    if (wt < 32) {
      load_block<NP>(sh, ring, &tx, &tb, &tcm,
                     block_dt(dt, b, h, S, H, nblk, 0, false), a_h, b, h,
                     nblk, 0, false);
      if (nblk > 1) dtn = block_dt(dt, b, h, S, H, nblk, 1, false);
    }
    for (int c = 0; c < nblk; ++c) {
      const int s = c % NS, q = c & 1, t0 = c * L;
      mbar_wait(&sh.full[s], (c / NS) & 1);
      const uint8_t* Cs = ring + s * G::STAGE;
      const uint8_t* Bs = Cs + G::C;
      const uint8_t* Xs = Bs + G::B;
      const float4* tk = sh.tok[s];

      // C B^T [i, j] and e = dy x^T [i, j] (dy hi, lo)
      float cb[32], ee[32];
      uint32_t dh[4][4], dl[4][4];
#pragma unroll
      for (int e = 0; e < 32; ++e) cb[e] = ee[e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split2(dyv[8 * kk + 2 * r], dyv[8 * kk + 2 * r + 1], dh[kk][r],
                 dl[kk][r]);
      const uint64_t dcm = kmajor<NP>(Cs, L, 0, 0);
      const uint64_t dbm = kmajor<NP>(Bs, L, 0, 0);
      const uint64_t dxm = kmajor<64>(Xs, L, 0, 0);
      pin(cb);
      pin(ee);
      pin(dh);
      pin(dl);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < NP / 16; ++kk)
        wgmma_ss(cb, desc_add(dcm, kstep<NP>(L, kk)),
                 desc_add(dbm, kstep<NP>(L, kk)), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs<0>(ee, dh[kk], desc_add(dxm, kstep<64>(L, kk)), 1);
        wgmma_rs<0>(ee, dl[kk], desc_add(dxm, kstep<64>(L, kk)), 1);
      }
      wg_commit();
      // E = exp(cum_i) dy_i, one term, while the products run
      const float ec[2] = {tk[ln.rq].z, tk[ln.rq + 8].z};
      uint32_t ef[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          ef[kk][r] = pack_bf16(dyv[8 * kk + 2 * r] * ec[r & 1],
                                dyv[8 * kk + 2 * r + 1] * ec[r & 1]);
      wg_wait<0>();
      pin(cb);
      pin(ee);
      pin(dh);
      pin(dl);

      // D = decay dt_j e on j <= i (a select: above the diagonal the
      // exponent may overflow), as register A fragments in two terms
      // (a warp's rows are 16 w .. 16 w + 15: its column groups of 8 past
      // them are all zero, with no exponent formed)
      uint32_t Dh[4][4], Dl[4][4];
      const float ci[2] = {tk[ln.rq].x, tk[ln.rq + 8].x};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int e = 8 * kk + 2 * r;
          const int i = ln.row(e), j = ln.col(e);
          if (8 * (e >> 2) > 16 * ln.w + 15) {
            Dh[kk][r] = Dl[kk][r] = 0u;
            continue;
          }
          const float4 t0j = tk[j], t1j = tk[j + 1];
          const float ci_ = ci[r & 1];
          const float d0 = j <= i ? ex2(ci_ - t0j.x) * t0j.y : 0.f;
          const float d1 = j + 1 <= i ? ex2(ci_ - t1j.x) * t1j.y : 0.f;
          split2(d0 * ee[e], d1 * ee[e + 1], Dh[kk][r], Dl[kk][r]);
        }

      // dC = E s_hi + D B (hi, lo), [i, NP].  s_hi of this block means
      // the state warpgroup is done with block c - 1: its stage takes
      // block c + 1
      mbar_wait(&sh.pready[q], (c >> 1) & 1);
      if (wt < 32 && c + 1 < nblk) {
        load_block<NP>(sh, ring, &tx, &tb, &tcm, dtn, a_h, b, h, nblk, c + 1,
                       false);
        if (c + 2 < nblk) dtn = block_dt(dt, b, h, S, H, nblk, c + 2, false);
      }
      float dc[NP / 2];
#pragma unroll
      for (int e = 0; e < NP / 2; ++e) dc[e] = 0.f;
      const uint64_t dsb = mnmajor<NP>(sbuf + q * G::ST, 64, 0);
      const uint64_t dbn = mnmajor<NP>(Bs, L, 0);
      pin(dc);
      pin(ef);
      pin(Dh);
      pin(Dl);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_n<NP>(dc, ef[kk], desc_add(dsb, mnstep<NP>(kk)));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs_n<NP>(dc, Dh[kk], desc_add(dbn, mnstep<NP>(kk)));
        wgmma_rs_n<NP>(dc, Dl[kk], desc_add(dbn, mnstep<NP>(kk)));
      }
      wg_commit();
      if (c + 1 < nblk) load_dy(dyv, dy, row0, t0 + L, S, H, h, P, ln);
      wg_wait<0>();
      pin(dc);
      pin(ef);
      pin(Dh);
      pin(Dl);
      mbar_arrive(&sh.pfree[q]);

      push<NP>(dc, sh, X, c, CL, rank, ln, wt);
      reduce<NP>(sh, X, c, CL, rank, dCp_bh + t0 * N, S - t0, N, wt);
    }
  }
  cluster_sync();                  // no block leaves while peers read it
}

// ---------------------------------------------------------------------------
// Sweep R: blocks last to first.  The intra warpgroup writes dy (hi, lo)
// and E = exp(cum) dy (three terms) as tiles, computes C B^T transposed
// (B C^T [j, i], both K-major) and e^T = x dy^T (x K-major A, dy K-major
// B), then M^T, D^T and the sums of Z = M e (rows and columns) and of K e,
// writes M (hi, lo) as [j][i] tiles, and dB = D^T C + (w x) G_hi (D^T and
// w x register A operands, C and G_hi MN-major) summed over the cluster's
// heads.  The state warpgroup holds G [64 p, NP n] in f32 registers and
// per block computes G B^T [p, j] (G as a register A operand in three
// terms, B K-major) and x^T G B, dx^T = dy^T M + w G B^T (dy an MN-major
// A, M a K-major B), stores dx by TMA, updates G = G exp(cum_L) + E^T C (E
// an MN-major A in three terms, C an MN-major B), publishes G_hi, and
// warp 0 turns the block's sums into dcum, its reverse cumsum da, ddt and
// dA.  The state-out term of dcum at the block's last token is delta
// (ref.py::ssd_chunk_scan_bwd_split_ref): from <dstate, s> at the last
// block, from the kept state at block 0 and every CKPT-th, else by its
// recurrence.
// ---------------------------------------------------------------------------
template <int NP>
__global__ void __launch_bounds__(NTHREADS, 1)
    ssd_bwd_rev_kernel(const __grid_constant__ CUtensorMap tx,
                       const __grid_constant__ CUtensorMap tb,
                       const __grid_constant__ CUtensorMap tcm,
                       const __grid_constant__ CUtensorMap tdx,
                       const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const float* __restrict__ dy,
                       const float* __restrict__ dstate,
                       const float* __restrict__ ckpt,
                       const float* __restrict__ carrE,
                       const float* __restrict__ delta,
                       float* __restrict__ ddt, float* __restrict__ dBp,
                       float* __restrict__ dAp, int S, int H, int P, int N,
                       int CL) {
  using G = Geo<NP>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ Shared sh;
  uint8_t* ring = align1024(smem_raw);
  uint8_t* dyt = ring + NS * G::STAGE;            // dy hi, lo [i][p]
  uint8_t* et = dyt + 2 * TILE;                   // E hi, mid, lo [i][p]
  uint8_t* mt = et + 3 * TILE;                    // M hi, lo [j][i]
  uint8_t* gbuf = mt + 2 * TILE;                  // G_hi [q] at + q ST
  float* X = reinterpret_cast<float*>(gbuf + 2 * G::ST);
  uint8_t* dxs = gbuf + 2 * G::ST + G::XCH;       // dx [j][p] bf16

  const int tid = threadIdx.x, h = blockIdx.x, b = blockIdx.y;
  const int nblk = (S + L - 1) / L;
  const int nck = nblk >= 2 ? (nblk - 2) / CKPT : 0;
  const size_t row0 = static_cast<size_t>(b) * S;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int rank = cluster_rank();
  const float a_h = A[h];

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) mbar_init(&sh.full[s], 1);
    for (int q = 0; q < 2; ++q) {
      mbar_init(&sh.pready[q], WG);
      mbar_init(&sh.pfree[q], WG);
    }
    mbar_init(&sh.tready, WG);
    mbar_init(&sh.tfree, WG);
    mbar_init(&sh.xready, CL);
    mbar_init(&sh.xfree, CL);
    mbar_fence_init();
  }
  cluster_sync();

  if (tid < WG) {
    // ---- state warpgroup ----
    const int wt = tid;
    const Lane ln(wt);
    float g[NP / 2];
    const float* dsp = dstate ? dstate + bh * P * N : nullptr;
#pragma unroll
    for (int e = 0; e < NP / 2; ++e) {
      const int p = ln.row(e), n = ln.col(e);
      g[e] = (dsp && p < P && n < N) ? dsp[p * N + n] : 0.f;
    }
    // G_hi of walk step n goes to buffer n & 1
    auto publish = [&](int n) {
      const int q = n & 1;
      if (n >= 2) mbar_wait(&sh.pfree[q], ((n - 2) >> 1) & 1);
      uint8_t* gb = gbuf + q * G::ST;
#pragma unroll
      for (int e = 0; e < NP / 2; e += 2)
        sts32(gb, swzc(ln.row(e), ln.col(e)), pack_bf16(g[e], g[e + 1]));
      fence_proxy_async();
      mbar_arrive(&sh.pready[q]);
    };
    publish(0);
    float dl = delta[bh];            // warp 0's running delta
    float dA_acc = 0.f;
    for (int n = 0; n < nblk; ++n) {
      const int c = nblk - 1 - n, s = n % NS, t0 = c * L, v = n & 1;
      mbar_wait(&sh.full[s], (n / NS) & 1);
      const uint8_t* Cs = ring + s * G::STAGE;
      const uint8_t* Bs = Cs + G::C;
      const uint8_t* Xs = Bs + G::B;
      const float4* tk = sh.tok[s];
      const bool kept = c % CKPT == 0 && c >= CKPT && c + 1 < nblk;
      // loads that the block's end needs, issued before its products:
      // warp 0's carrE of tokens 2 l, 2 l + 1 and <G, s>'s kept state
      float ce[2] = {0.f, 0.f};
      if (ln.w == 0)
#pragma unroll
        for (int u = 0; u < 2; ++u)
          if (t0 + 2 * ln.lane + u < S)
            ce[u] = carrE[bh * S + t0 + 2 * ln.lane + u];
      float4 k4[NP / 8];
      if (kept) {
        const float4* in = reinterpret_cast<const float4*>(ckpt) +
                           ((bh * nck + c / CKPT - 1) * (NP / 8)) * WG + wt;
#pragma unroll
        for (int e4 = 0; e4 < NP / 8; ++e4) k4[e4] = in[e4 * WG];
      }

      // G B^T [p, j], G in three terms; 64 columns of n at a time
      float gbt[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) gbt[e] = 0.f;
      const uint64_t dbk = kmajor<NP>(Bs, L, 0, 0);
#pragma unroll
      for (int half = 0; half < NP / 64; ++half) {
        uint32_t a0[4][4], a1[4][4], a2[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int e = 8 * (4 * half + kk) + 2 * r;
            split3(g[e], g[e + 1], a0[kk][r], a1[kk][r], a2[kk][r]);
          }
        pin(gbt);
        pin(a0);
        pin(a1);
        pin(a2);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t d = desc_add(dbk, kstep<NP>(L, 4 * half + kk));
          wgmma_rs<0>(gbt, a0[kk], d, 1);
          wgmma_rs<0>(gbt, a1[kk], d, 1);
          wgmma_rs<0>(gbt, a2[kk], d, 1);
        }
        wg_commit();
        wg_wait<0>();
        pin(gbt);
        pin(a0);
        pin(a1);
        pin(a2);
      }
      // <G, s> with the kept state entering this block
      float gs = 0.f;
      if (kept)
#pragma unroll
        for (int e4 = 0; e4 < NP / 8; ++e4) {
          gs = fmaf(g[4 * e4], k4[e4].x, gs);
          gs = fmaf(g[4 * e4 + 1], k4[e4].y, gs);
          gs = fmaf(g[4 * e4 + 2], k4[e4].z, gs);
          gs = fmaf(g[4 * e4 + 3], k4[e4].w, gs);
        }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        gs += __shfl_xor_sync(0xffffffffu, gs, off);
      // x_j^T G B_j: sum over p (rows) of x_j[p] (G B^T)[p, j]
      float part[16], tot[2];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int e0 = 4 * (k >> 1) + (k & 1);
        const int j = ln.col(e0), p0 = ln.row(e0), p1 = p0 + 8;
        const uint32_t w0 = lds32(Xs, swz128(j, p0) & ~3);
        const uint32_t w1 = lds32(Xs, swz128(j, p1) & ~3);
        const float x0 = (p0 & 1) ? hi_f(w0) : lo_f(w0);
        const float x1 = (p1 & 1) ? hi_f(w1) : lo_f(w1);
        part[k] = x0 * gbt[e0] + x1 * gbt[e0 + 2];
      }
      sum8_transposed(part, tot);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int k = sum8_index(i);
        sh.red[v][ln.w][8 * (k >> 1) + ln.cq + (k & 1)] = tot[i];
      }
      if (ln.lane == 0) sh.wsum[v][ln.w] = gs;

      // dx^T [p, j] = dy^T M (dy hi M hi, lo hi, hi lo); then G's update
      mbar_wait(&sh.tready, n & 1);
      float dxt[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) dxt[e] = 0.f;
      const uint64_t ddy = mnmajor<64>(dyt, L, 0);
      const uint64_t dm = kmajor<64>(mt, L, 0, 0);
      pin(dxt);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t a = desc_add(ddy, mnstep<64>(kk));
        const uint64_t m = desc_add(dm, kstep<64>(L, kk));
        wgmma_ss<0, 1>(dxt, a, m, 1);
        wgmma_ss<0, 1>(dxt, desc_add(a, TILE), m, 1);
        wgmma_ss<0, 1>(dxt, a, desc_add(m, TILE), 1);
      }
      wg_commit();
      const float keep = tk[L - 1].z;
#pragma unroll
      for (int e = 0; e < NP / 2; ++e) g[e] *= keep;
      const uint64_t de = mnmajor<64>(et, L, 0);
      const uint64_t dcn = mnmajor<NP>(Cs, L, 0);
      pin(g);
      wg_fence();
#pragma unroll
      for (int t = 0; t < 3; ++t)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<1, 1>(g, desc_add(de, t * TILE + mnstep<64>(kk)),
                         desc_add(dcn, mnstep<NP>(kk)), 1);
      wg_commit();
      wg_wait<0>();
      pin(dxt);
      pin(g);
      mbar_arrive(&sh.tfree);          // dy, E and M of this block are read

      // dx = dx^T + w_j G B^T, into the staging tile by token row, then
      // one thread stores it by TMA (rows past S and columns past P are
      // dropped)
      float wc[16];                    // w_j of this thread's columns
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const float4 tj = tk[8 * (k >> 1) + ln.cq + (k & 1)];
        wc[k] = tj.w * tj.y;
      }
      if (wt == 0 && n >= 1) bulk_wait_read<0>();
      named_sync(1, WG);
#pragma unroll
      for (int e = 0; e < 32; ++e)
        *reinterpret_cast<__nv_bfloat16*>(dxs +
                                          swz128(ln.col(e), ln.row(e))) =
            __float2bfloat16(fmaf(wc[2 * (e >> 2) + (e & 1)], gbt[e],
                                  dxt[e]));
      fence_proxy_async();
      named_sync(1, WG);
      if (wt == 0) {
        tma_store_4d(&tdx, dxs, 0, h, t0, b);
        bulk_commit();
      }
      // the stage is the next step's once G_hi is out: keep what the end
      // of the block reads of it
      const float4 tv[2] = {tk[2 * ln.lane], tk[2 * ln.lane + 1]};
      if (n + 1 < nblk) publish(n + 1);

      // warp 0: dcum, da, ddt, dA and the next delta; tokens 2 l, 2 l + 1
      if (ln.w == 0) {
        const int l = ln.lane;
        const float* vz = sh.vec[v][0];
        const float* vk = sh.vec[v][1];
        float dc[2], hv[2], gb[2], kp[2];
        float hsum = 0.f, esum = 0.f;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int t = 2 * l + u;
          gb[u] = ((sh.red[v][0][t] + sh.red[v][1][t]) + sh.red[v][2][t]) +
                  sh.red[v][3][t];
          const float rz = ((sh.rowz[v][0][t] + sh.rowz[v][1][t]) +
                            sh.rowz[v][2][t]) + sh.rowz[v][3][t];
          kp[u] = tv[u].w;
          hv[u] = kp[u] * tv[u].y * gb[u];
          dc[u] = rz - vz[t] - hv[u] + ce[u];
          hsum += hv[u];
          esum += ce[u];
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          hsum += __shfl_xor_sync(0xffffffffu, hsum, off);
          esum += __shfl_xor_sync(0xffffffffu, esum, off);
        }
        if (c % CKPT == 0 && c + 1 < nblk) {
          const float gsum = kept ? ((sh.wsum[v][0] + sh.wsum[v][1]) +
                                     sh.wsum[v][2]) + sh.wsum[v][3]
                                  : 0.f;
          dl = keep * gsum + hsum;
        }
        if (l == 31) dc[1] += dl;
        // suffix sums: da_t = sum_{i >= t} dcum_i
        float incl = dc[0] + dc[1];
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float u = __shfl_down_sync(0xffffffffu, incl, off);
          if (l + off < 32) incl += u;
        }
        float after = __shfl_down_sync(0xffffffffu, incl, 1);
        if (l == 31) after = 0.f;
        const float da[2] = {after + dc[0] + dc[1], after + dc[1]};
        float dsum = 0.f;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int t = 2 * l + u;
          if (t0 + t >= S) continue;
          ddt[(row0 + t0 + t) * H + h] = vk[t] + kp[u] * gb[u] + a_h * da[u];
          dsum = fmaf(tv[u].y, da[u], dsum);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          dsum += __shfl_xor_sync(0xffffffffu, dsum, off);
        dA_acc += dsum;
        dl = dl - hsum + esum;
      }
    }
    if (wt == 0) {
      dAp[bh] = dA_acc;
      bulk_wait();                     // dx is stored before the block ends
    }
  } else {
    // ---- intra warpgroup ----
    const int wt = tid - WG;
    const Lane ln(wt);
    // this cluster's partial of dBm, row b
    float* dBp_bh =
        dBp + (static_cast<size_t>(b) * (H / CL) + h / CL) * S * N;
    float dyv[32];
    load_dy(dyv, dy, row0, (nblk - 1) * L, S, H, h, P, ln);
    float2 dtn = make_float2(0.f, 0.f);   // warp 0: dt of the next load
    if (wt < 32) {
      load_block<NP>(sh, ring, &tx, &tb, &tcm,
                     block_dt(dt, b, h, S, H, nblk, 0, true), a_h, b, h,
                     nblk, 0, true);
      if (nblk > 1) dtn = block_dt(dt, b, h, S, H, nblk, 1, true);
    }
    for (int n = 0; n < nblk; ++n) {
      const int c = nblk - 1 - n, s = n % NS, t0 = c * L, v = n & 1;
      mbar_wait(&sh.full[s], (n / NS) & 1);
      const uint8_t* Cs = ring + s * G::STAGE;
      const uint8_t* Bs = Cs + G::C;
      const uint8_t* Xs = Bs + G::B;
      const float4* tk = sh.tok[s];

      // dy (hi, lo) and E = exp(cum_i) dy_i (three terms) as [i][p] tiles
      if (n >= 1) mbar_wait(&sh.tfree, (n - 1) & 1);
      const float ec[2] = {tk[ln.rq].z, tk[ln.rq + 8].z};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = ln.rq + 8 * (r & 1);
          const int p = 16 * kk + 8 * (r >> 1) + ln.cq;
          const float y0 = dyv[8 * kk + 2 * r], y1 = dyv[8 * kk + 2 * r + 1];
          const int off = swz128(i, p);
          uint32_t hi, lo, m0, m1, m2;
          split2(y0, y1, hi, lo);
          sts32(dyt, off, hi);
          sts32(dyt, TILE + off, lo);
          split3(y0 * ec[r & 1], y1 * ec[r & 1], m0, m1, m2);
          sts32(et, off, m0);
          sts32(et, TILE + off, m1);
          sts32(et, 2 * TILE + off, m2);
        }
      fence_proxy_async();
      named_sync(2, WG);

      // B C^T [j, i] and e^T = x dy^T [j, i] (dy hi, lo)
      float cbt[32], ett[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) cbt[e] = ett[e] = 0.f;
      const uint64_t dbm = kmajor<NP>(Bs, L, 0, 0);
      const uint64_t dcm = kmajor<NP>(Cs, L, 0, 0);
      const uint64_t dxm = kmajor<64>(Xs, L, 0, 0);
      const uint64_t dym = kmajor<64>(dyt, L, 0, 0);
      pin(cbt);
      pin(ett);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < NP / 16; ++kk)
        wgmma_ss(cbt, desc_add(dbm, kstep<NP>(L, kk)),
                 desc_add(dcm, kstep<NP>(L, kk)), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_ss(ett, desc_add(dxm, kstep<64>(L, kk)),
                 desc_add(dym, kstep<64>(L, kk)), 1);
        wgmma_ss(ett, desc_add(dxm, kstep<64>(L, kk)),
                 desc_add(dym, TILE + kstep<64>(L, kk)), 1);
      }
      wg_commit();
      wg_wait<0>();
      pin(cbt);
      pin(ett);

      // rows j, columns i: decay on j <= i (a select), K^T, M^T, D^T and
      // Z = M e; the row sums (over i) of Z and K e, the column sums (over
      // j) of Z by warp; M (hi, lo) as [j][i] tiles; D^T as register A
      // fragments (hi, lo)
      uint32_t Dh[4][4], Dl[4][4];
      float zr[2] = {0.f, 0.f}, kr[2] = {0.f, 0.f}, zc[16];
      const float cj[2] = {tk[ln.rq].x, tk[ln.rq + 8].x};
      const float dj[2] = {tk[ln.rq].y, tk[ln.rq + 8].y};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int e = 8 * kk + 2 * r, u = r & 1;
          const int j = ln.row(e), i = ln.col(e);
          // a warp's column groups of 8 before its rows 16 w .. 16 w + 15
          // are all zero, with no exponent formed
          const bool live = 8 * (e >> 2) + 7 >= 16 * ln.w;
          const float d0 = live && j <= i ? ex2(tk[i].x - cj[u]) : 0.f;
          const float d1 =
              live && j <= i + 1 ? ex2(tk[i + 1].x - cj[u]) : 0.f;
          const float k0 = cbt[e] * d0, k1 = cbt[e + 1] * d1;
          const float m0 = k0 * dj[u], m1 = k1 * dj[u];
          const float z0 = m0 * ett[e], z1 = m1 * ett[e + 1];
          zr[u] += z0 + z1;
          kr[u] += k0 * ett[e] + k1 * ett[e + 1];
          zc[2 * (e >> 2) + 0] = (u == 0 ? 0.f : zc[2 * (e >> 2)]) + z0;
          zc[2 * (e >> 2) + 1] = (u == 0 ? 0.f : zc[2 * (e >> 2) + 1]) + z1;
          uint32_t mh, ml;
          split2(m0, m1, mh, ml);
          const int off = swz128(j, i);
          sts32(mt, off, mh);
          sts32(mt, TILE + off, ml);
          split2(d0 * dj[u] * ett[e], d1 * dj[u] * ett[e + 1], Dh[kk][r],
                 Dl[kk][r]);
        }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        zr[u] = quad_sum(zr[u]);
        kr[u] = quad_sum(kr[u]);
      }
      if ((ln.lane & 3) == 0)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          sh.vec[v][0][ln.rq + 8 * u] = zr[u];
          sh.vec[v][1][ln.rq + 8 * u] = kr[u];
        }
      float ztot[2];
      sum8_transposed(zc, ztot);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int k = sum8_index(i);
        sh.rowz[v][ln.w][8 * (k >> 1) + ln.cq + (k & 1)] = ztot[i];
      }
      fence_proxy_async();
      mbar_arrive(&sh.tready);

      // dB = D^T C (hi, lo) + (w x) G_hi, [j, NP]; w x from the x tile
      uint32_t wf[4][4];
      const float wj[2] = {tk[ln.rq].w * dj[0], tk[ln.rq + 8].w * dj[1]};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = ln.rq + 8 * (r & 1);
          const int p = 16 * kk + 8 * (r >> 1) + ln.cq;
          const uint32_t xv = lds32(Xs, swz128(j, p));
          wf[kk][r] = pack_bf16(lo_f(xv) * wj[r & 1], hi_f(xv) * wj[r & 1]);
        }
      // G_hi of this step means the state warpgroup is done with step n -
      // 1: its stage takes step n + 1
      const int q = n & 1;
      mbar_wait(&sh.pready[q], (n >> 1) & 1);
      if (wt < 32 && n + 1 < nblk) {
        load_block<NP>(sh, ring, &tx, &tb, &tcm, dtn, a_h, b, h, nblk, n + 1,
                       true);
        if (n + 2 < nblk) dtn = block_dt(dt, b, h, S, H, nblk, n + 2, true);
      }
      float db[NP / 2];
#pragma unroll
      for (int e = 0; e < NP / 2; ++e) db[e] = 0.f;
      const uint64_t dcn = mnmajor<NP>(Cs, L, 0);
      const uint64_t dgn = mnmajor<NP>(gbuf + q * G::ST, 64, 0);
      pin(db);
      pin(Dh);
      pin(Dl);
      pin(wf);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs_n<NP>(db, Dh[kk], desc_add(dcn, mnstep<NP>(kk)));
        wgmma_rs_n<NP>(db, Dl[kk], desc_add(dcn, mnstep<NP>(kk)));
        wgmma_rs_n<NP>(db, wf[kk], desc_add(dgn, mnstep<NP>(kk)));
      }
      wg_commit();
      if (n + 1 < nblk) load_dy(dyv, dy, row0, t0 - L, S, H, h, P, ln);
      wg_wait<0>();
      pin(db);
      pin(Dh);
      pin(Dl);
      pin(wf);
      mbar_arrive(&sh.pfree[q]);

      push<NP>(db, sh, X, n, CL, rank, ln, wt);
      reduce<NP>(sh, X, n, CL, rank, dBp_bh + t0 * N, S - t0, N, wt);
    }
  }
  cluster_sync();
}

// Tensor maps, all bf16 in the 128-byte swizzle: x (and dx) as [B][S][H][P]
// in boxes of 64 columns x 1 head x 64 tokens x 1 row, Bm and Cm as
// [B][S][N] in boxes of 64 columns x 64 tokens x 1 row; reads past P, N or
// S give zeros, stores past P or S are dropped.
inline bool maps(CUtensorMap* tx, CUtensorMap* tb, CUtensorMap* tcm,
                 CUtensorMap* tdx, const void* x, const void* Bm,
                 const void* Cm, void* dx, int Bsz, int S, int H, int P,
                 int N) {
  const cuuint64_t xdims[4] = {(cuuint64_t)P, (cuuint64_t)H, (cuuint64_t)S,
                               (cuuint64_t)Bsz};
  const cuuint64_t xstr[3] = {(cuuint64_t)P * 2, (cuuint64_t)H * P * 2,
                              (cuuint64_t)S * H * P * 2};
  const cuuint32_t xbox[4] = {64, 1, L, 1};
  const cuuint64_t ndims[3] = {(cuuint64_t)N, (cuuint64_t)S,
                               (cuuint64_t)Bsz};
  const cuuint64_t nstr[2] = {(cuuint64_t)N * 2, (cuuint64_t)S * N * 2};
  const cuuint32_t nbox[3] = {64, L, 1};
  return make_map(tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, x, xdims, xstr,
                  xbox, 128) &&
         make_map(tdx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, dx, xdims, xstr,
                  xbox, 128) &&
         make_map(tb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, Bm, ndims, nstr,
                  nbox, 128) &&
         make_map(tcm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, Cm, ndims, nstr,
                  nbox, 128);
}

// one cluster of CL heads along x
template <typename K, typename... Args>
cudaError_t launch_clustered(K kernel, size_t smem, int H, int Bsz, int CL,
                             cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H, Bsz);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <int NP>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* dy,
                   const void* dstate, void* dx, void* ddt, void* ckpt,
                   void* dBp, void* dCp, void* dAp, void* carrE,
                   void* delta, int Bsz, int S, int H, int P, int N, int CL,
                   cudaStream_t stream) {
  CUtensorMap tx, tb, tcm, tdx;
  if (!maps(&tx, &tb, &tcm, &tdx, x, Bm, Cm, dx, Bsz, S, H, P, N))
    return cudaErrorInvalidValue;
  const float* f_dt = static_cast<const float*>(dt);
  const float* f_A = static_cast<const float*>(A);
  const float* f_dy = static_cast<const float*>(dy);
  const float* f_ds = static_cast<const float*>(dstate);
  cudaError_t err = launch_clustered(
      ssd_bwd_fwd_kernel<NP>, Geo<NP>::F_BYTES, H, Bsz, CL, stream, tx, tb,
      tcm, f_dt, f_A, f_dy, f_ds, static_cast<float*>(ckpt),
      static_cast<float*>(carrE), static_cast<float*>(delta),
      static_cast<float*>(dCp), S, H, P, N, CL);
  if (err != cudaSuccess) return err;
  return launch_clustered(
      ssd_bwd_rev_kernel<NP>, Geo<NP>::R_BYTES, H, Bsz, CL, stream, tx, tb,
      tcm, tdx, f_dt, f_A, f_dy, f_ds,
      static_cast<const float*>(ckpt), static_cast<const float*>(carrE),
      static_cast<const float*>(delta), static_cast<float*>(ddt),
      static_cast<float*>(dBp), static_cast<float*>(dAp), S, H, P, N, CL);
}

}  // namespace tcb

}  // namespace

// dtype (of x, Bm, Cm, dx, dBm and dCm): 0 = f32, 1 = bf16.  route: 0 =
// the CUDA-core kernels, 1 = the wgmma kernels (bf16, P and N multiples of
// 16; x, Bm and Cm on 16-byte boundaries), whose heads are summed in
// clusters of ``cluster`` (1, 2, 4 or 8, dividing H).  dstate may be null
// (a zero cotangent of the final state).  Scratch from the caller, all
// f32:
//   route 0: states [B, H, ceil(S / 64), P, N]; dBp and dCp [B, H, S, N];
//     dAp [B, H]; carrE and delta unused;
//   route 1: states = the kept states [B, H, (nblk - 2) / 4, 64 NP]
//     (nblk = ceil(S / 64), NP = N rounded up to 64); dBp and dCp
//     [B, H / cluster, S, N]; dAp, delta [B, H]; carrE [B, H, S].
// reduce_blocks: the head reduction's grid.  Returns cudaGetLastError()
// after the launches, or cudaErrorInvalidValue for a shape the route does
// not take.
extern "C" int ssd_chunk_scan_bwd(const void* x, const void* dt,
                                  const void* A, const void* Bm,
                                  const void* Cm, const void* dy,
                                  const void* dstate, void* dx, void* ddt,
                                  void* dA, void* dB, void* dC, void* states,
                                  void* dBp, void* dCp, void* dAp,
                                  void* carrE, void* delta, int Bsz, int S,
                                  int H, int P, int N, int dtype, int route,
                                  int cluster, int reduce_blocks,
                                  void* stream) {
  if (P < 1 || P > PMAX || N < 1 || N > NMAX || S < 0 || reduce_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == 1 && (dtype != 1 || P % 16 || N % 16 || cluster < 1 ||
                     cluster > 8 || (cluster & (cluster - 1)) ||
                     H % cluster))
    return static_cast<int>(cudaErrorInvalidValue);
  if (route != 0 && route != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Bsz == 0 || S == 0)              // no tokens: dA is zero
    return static_cast<int>(
        cudaMemsetAsync(dA, 0, sizeof(float) * H, st));
  if (route == 1) {
    const cudaError_t err =
        N <= 64 ? tcb::launch<64>(x, dt, A, Bm, Cm, dy, dstate, dx, ddt,
                                  states, dBp, dCp, dAp, carrE, delta, Bsz,
                                  S, H, P, N, cluster, st)
                : tcb::launch<128>(x, dt, A, Bm, Cm, dy, dstate, dx, ddt,
                                   states, dBp, dCp, dAp, carrE, delta, Bsz,
                                   S, H, P, N, cluster, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_bwd_reduce_kernel<__nv_bfloat16><<<reduce_blocks, RTHREADS, 0, st>>>(
        static_cast<const float*>(dBp), static_cast<const float*>(dCp),
        static_cast<const float*>(dAp), static_cast<__nv_bfloat16*>(dB),
        static_cast<__nv_bfloat16*>(dC), static_cast<float*>(dA), Bsz, S,
        H / cluster, H, N);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == 0)
    return launch<float>(x, dt, A, Bm, Cm, dy, dstate, dx, ddt, dA, dB, dC,
                         states, dBp, dCp, dAp, Bsz, S, H, P, N,
                         reduce_blocks, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, dy, dstate, dx, ddt, dA,
                                 dB, dC, states, dBp, dCp, dAp, Bsz, S, H, P,
                                 N, reduce_blocks, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
