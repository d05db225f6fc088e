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
// N 128, bf16 x/B/C, f32 dy) the function moves ~353 MB (x, B, C, dt, dy
// in; dx, dB, dC, ddt out) and this algorithm does ~1e11 FLOP, so f32
// operations bound it on the CUDA cores (~1.5 ms at 67 TFLOP/s; ~0.1 ms at
// the bf16 tensor-core rate that a later design would reach for).  This is
// the simple first kernel: every product in f32 on the CUDA cores.
//
// Design:
//   - ssd_bwd_kernel: one CTA walks one (b, h), 256 threads as 16 x 16,
//     each holding 4 x 4 (or 4 x 8) outputs of a tile in registers, as the
//     forward's CUDA-core kernel does.  G, the [P, N] cotangent, lives in
//     shared memory for the whole walk.
//   - Block-start states: recomputed by the same CTA in a first, forward
//     sweep (the state update alone, a [P, L] x [L, N] product a block)
//     and written to a scratch of [B, H, nblk, P, N] f32 (84 MB at the
//     train shape), which the reverse walk reads back.  The forward
//     kernels stay as they are (the wgmma kernel keeps its state in
//     registers and never stores it), and nothing is held from the forward
//     to the backward: under remat the forward runs twice a step and the
//     backward once, so writing the states in the forward would store them
//     twice.
//   - dB and dC across heads, deterministic: the walk writes per-head
//     partials [B, H, S, N] f32, and ssd_bwd_reduce_kernel sums them over
//     h in order (dA's per-(b, h) partials over b), so two calls on the
//     same inputs give the same bits.  No atomics.
//   - Overflow: exp(cum_i - cum_j) is formed from the difference and only
//     for j <= i (a select, never a 0/1 multiply), as in the forward, so
//     dt of 0, tiny or negative gives what the plain version gives.
//   Shared rows of N values are padded to 129 floats and rows of P or L
//   values to 65, so a warp's 16 rows at one column fall on distinct
//   banks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// dBm, dCm [b, t, n] = sum over h, in order, of the per-head partials;
// dA [h] = sum over b, in order
template <typename T>
__global__ void __launch_bounds__(RTHREADS)
    ssd_bwd_reduce_kernel(const float* __restrict__ dBp,
                          const float* __restrict__ dCp,
                          const float* __restrict__ dAp, T* __restrict__ dB,
                          T* __restrict__ dC, float* __restrict__ dA,
                          int Bsz, int S, int H, int N) {
  const size_t SN = static_cast<size_t>(S) * N;
  const size_t total = static_cast<size_t>(Bsz) * SN;
  for (size_t e = static_cast<size_t>(blockIdx.x) * RTHREADS + threadIdx.x;
       e < total; e += static_cast<size_t>(gridDim.x) * RTHREADS) {
    const size_t b = e / SN, r = e % SN;
    const float* pb = dBp + b * H * SN + r;
    const float* pc = dCp + b * H * SN + r;
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < H; ++h) {
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
      static_cast<T*>(dC), static_cast<float*>(dA), Bsz, S, H, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype (of x, Bm, Cm, dx, dBm and dCm): 0 = f32, 1 = bf16.  dstate may be
// null (a zero cotangent of the final state).  Scratch from the caller:
// states [B, H, ceil(S / 64), P, N], dBp and dCp [B, H, S, N], dAp [B, H],
// all f32.  reduce_blocks: the reduction kernel's grid.  Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for a
// shape the kernel does not take.
extern "C" int ssd_chunk_scan_bwd(const void* x, const void* dt,
                                  const void* A, const void* Bm,
                                  const void* Cm, const void* dy,
                                  const void* dstate, void* dx, void* ddt,
                                  void* dA, void* dB, void* dC, void* states,
                                  void* dBp, void* dCp, void* dAp, int Bsz,
                                  int S, int H, int P, int N, int dtype,
                                  int reduce_blocks, void* stream) {
  if (P < 1 || P > PMAX || N < 1 || N > NMAX || S < 0 || reduce_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Bsz == 0 || S == 0)              // no tokens: dA is zero
    return static_cast<int>(
        cudaMemsetAsync(dA, 0, sizeof(float) * H, st));
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
