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
// The point of the kernel is the skip: an output tile lies inside one mask
// block, and a tile whose mask value is exactly 0 writes zeros without
// entering its K loop, so it loads no x and no w.  The work done scales
// with the keep rate, as the TPU kernel's pl.when does.
//
// What bounds it on an H100: at Horn's MLP shapes (M = K = 2048, N = 6144)
// the work is operations, 2 * M * K flops per kept output column, against a
// few bytes per element of x, w and y; only wgmma reaches the card's bf16
// rate.  Three kernels, chosen by the wrapper (kernel.py::route):
//
// wgmma (bf16, K % 8 == 0: TMA needs 16-byte row strides)
//   A persistent grid of one block per SM.  Every block reads the mask and
//   numbers the tiles (256 x BN, BN = 128 where block_n allows, else 64)
//   in one order, mask entry by entry, and takes every gridDim-th kept
//   tile and every gridDim-th dropped one: the kept work is spread evenly
//   whatever the mask, with no host sync and no index list.  Three
//   warpgroups with setmaxnreg.  Warp 0 of the producer warpgroup copies x
//   tiles [256, 32] (K-major, 64-byte swizzle) and w tiles [32, BN] (read
//   as the transposed B operand, as flash attention reads V; 128-byte
//   swizzle) by TMA into a six-stage mbarrier ring; between those copies
//   it writes the dropped tiles as TMA stores of a zero box, so their
//   zeros drain to memory under the kept tiles' products.  Two consumer
//   warpgroups each own 128 rows as two m64nBNk16 wgmma products sharing
//   every B operand, f32 accumulators, one group of products in flight
//   while the previous stage is released.  Epilogue, 64 rows at a time:
//   the mask value times the accumulator into a swizzled f32 staging tile,
//   then TMA stores (rows past M dropped), which drain while the next
//   tile's loop runs.  Shallow stages in a deep ring keep more bytes in
//   flight per byte of shared memory held by the products (BK 32 x 6
//   stages beat BK 64 x 3, and 128-row tiles, side by side on the card).
// mma_sync (bf16, any K)
//   The first bf16 design: mma.sync.m16n8k16, 128 x 64 tiles, 4 warps each
//   owning 64 x 32, depth-32 stages in two cp.async buffers; rows whose K
//   is not a multiple of 8 are copied element by element.  One block per
//   output tile, grid (N / 64, ceil(M / 128), G).
// f32
//   A CUDA-core tiled product (64 x 64 tiles, 4 x 4 outputs a thread); f32
//   is not Horn's training dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BN = 64;   // output columns of an mma_sync / f32 tile

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
// bf16: tensor cores, mma.sync (the shapes the wgmma kernel cannot take)
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

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA, persistent
// ---------------------------------------------------------------------------
constexpr int WG_BM = 256;      // output rows of a tile: two warpgroups of
                                // 128, each two m64 products sharing B
constexpr int WG_BK = 32;       // depth of a stage: a 64-byte swizzle row
constexpr int WG_ST = 6;        // stages in the ring
constexpr int WG_THREADS = 384; // producer warpgroup + two consumers

template <int TBN>
struct WgLayout {
  static constexpr int X_BYTES = WG_BM * WG_BK * 2;  // x tile [256][32]
  static constexpr int W_BYTES = WG_BK * TBN * 2;    // w tile [32][TBN]
  static constexpr int STAGE = X_BYTES + W_BYTES;
  static constexpr int OUT_BYTES = 64 * TBN * 4;     // 64 f32 rows
  static constexpr int ZERO_BYTES = 64 * 32 * 4;     // one [64][32] box
  static constexpr size_t SMEM = 1024 + (size_t)WG_ST * STAGE +
                                 2 * (size_t)OUT_BYTES + ZERO_BYTES;
};

// The j-th mask entry that is kept (value != 0) or dropped (== 0), for j
// that never decreases: one warp walks the mask 32 entries at a time with
// a ballot, so a block reads the whole mask at most once per walk.
struct MaskWalk {
  const float* mask;
  int E, base, before;
  unsigned bits;
  bool kept;
  __device__ MaskWalk(const float* m, int e, bool k)
      : mask(m), E(e), base(0), before(0), kept(k) {
    load();
  }
  __device__ void load() {
    const int e = base + static_cast<int>(threadIdx.x % 32);
    const bool in = e < E;
    const float v = in ? mask[e] : 0.f;
    bits = __ballot_sync(0xffffffffu, in && ((v != 0.f) == kept));
  }
  // entry index, or -1 past the last one (warp-uniform)
  __device__ int find(int j) {
    for (;;) {
      const int c = __popc(bits);
      if (j < before + c) {
        unsigned b = bits;
        for (int i = before; i < j; ++i) b &= b - 1;   // drop lower set bits
        return base + __ffs(b) - 1;
      }
      before += c;
      base += 32;
      if (base >= E) return -1;
      load();
    }
  }
};

// Tile t of a mask entry's T = mtiles * (block_n / TBN) tiles: column
// sub-block t / mtiles, row tile t % mtiles.
struct TileAt {
  int g, m0, n0;
};
template <int TBN>
__device__ __forceinline__ TileAt tile_at(int entry, int t, int nb,
                                          int mtiles, int block_n) {
  TileAt a;
  a.g = entry / nb;
  a.n0 = (entry % nb) * block_n + (t / mtiles) * TBN;
  a.m0 = (t % mtiles) * WG_BM;
  return a;
}

// The dropped tiles of this block, as TMA stores of a zero box: the
// producer warp issues them a few at a time between its loads, so the
// zeros drain to memory under the kept tiles' products.
template <int TBN>
struct ZeroFeed {
  static constexpr int BOXES = (WG_BM / 64) * (TBN / 32);      // a tile
  MaskWalk walk;
  int k, box, T, nb, mtiles, block_n;
  TileAt a;
  bool done;
  __device__ ZeroFeed(const float* mask, int E, int T_, int nb_, int mt,
                      int bn)
      : walk(mask, E, false), k(blockIdx.x), box(0), T(T_), nb(nb_),
        mtiles(mt), block_n(bn), done(false) {
    next();
  }
  __device__ void next() {
    const int e = walk.find(k / T);
    done = e < 0;
    if (!done) a = tile_at<TBN>(e, k % T, nb, mtiles, block_n);
  }
  // issue up to n more boxes (warp-uniform; lane 0 issues)
  __device__ void feed(const CUtensorMap* ty, const uint8_t* zero, int n) {
    for (; n > 0 && !done; --n) {
      if (threadIdx.x % 32 == 0)
        hopper::tma_store_3d(ty, zero, a.n0 + 32 * (box % (TBN / 32)),
                             a.m0 + 64 * (box / (TBN / 32)), a.g);
      if (++box == BOXES) {
        box = 0;
        k += gridDim.x;
        next();
      }
    }
  }
};

template <int TBN>
__global__ void __launch_bounds__(WG_THREADS, 1)
dropout_matmul_wgmma(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tw,
                     const __grid_constant__ CUtensorMap ty,
                     const float* __restrict__ mask, int G, int M, int K,
                     int N, int block_n) {
  using L = WgLayout<TBN>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[WG_ST], empty[WG_ST];
  uint8_t* base = hopper::align1024(smem_raw);
  uint8_t* zero = base + WG_ST * L::STAGE + 2 * L::OUT_BYTES;

  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int nb = N / block_n, E = G * nb;
  const int mtiles = (M + WG_BM - 1) / WG_BM;
  const int T = mtiles * (block_n / TBN);        // tiles of a mask entry
  const int nk = (K + WG_BK - 1) / WG_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_ST; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 256);          // every consumer thread
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: warp 0 walks the kept tiles, lane 0 issues the copies;
    // between them it feeds the dropped tiles' zero stores
    hopper::regs_dec<40>();
    if (threadIdx.x < 32) {
      const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int i = lane; i < L::ZERO_BYTES / 16; i += 32)
        reinterpret_cast<float4*>(zero)[i] = z4;
      hopper::fence_proxy_async();
      __syncwarp();
      ZeroFeed<TBN> zeros(mask, E, T, nb, mtiles, block_n);
      MaskWalk walk(mask, E, true);
      int n = 0;                                  // stages filled so far
      for (int k = blockIdx.x;; k += gridDim.x) {
        const int e = walk.find(k / T);
        if (e < 0) break;
        const TileAt a = tile_at<TBN>(e, k % T, nb, mtiles, block_n);
        for (int kt = 0; kt < nk; ++kt, ++n) {
          const int s = n % WG_ST;
          if (n >= WG_ST) hopper::mbar_wait(&empty[s], (n / WG_ST - 1) & 1);
          if (lane == 0) {
            uint8_t* xs = base + s * L::STAGE;
            uint8_t* ws = xs + L::X_BYTES;
            hopper::mbar_expect_tx(&full[s], L::STAGE);
            hopper::tma_load_3d(xs, &tx, &full[s], kt * WG_BK, a.m0, a.g);
#pragma unroll
            for (int c = 0; c < TBN / 64; ++c)
              hopper::tma_load_2d(ws + c * WG_BK * 128, &tw, &full[s],
                                  a.n0 + 64 * c, kt * WG_BK);
          }
          zeros.feed(&ty, zero, 2);
          __syncwarp();
        }
      }
      zeros.feed(&ty, zero, 1 << 30);
      if (lane == 0) {
        hopper::bulk_commit();
        hopper::bulk_wait();
      }
    }
  } else {
    // consumers: warpgroup cw owns rows [128 cw, 128 cw + 128) of each
    // tile, as two m64 halves sharing each B operand
    hopper::regs_inc<232>();
    const int cw = wg - 1, t = threadIdx.x % 128, warp = t / 32;
    const int r0 = 128 * cw;
    uint8_t* out = base + WG_ST * L::STAGE + cw * L::OUT_BYTES;
    MaskWalk walk(mask, E, true);
    int n = 0;                                    // stages consumed so far
    for (int k = blockIdx.x;; k += gridDim.x) {
      const int e = walk.find(k / T);
      if (e < 0) break;
      const TileAt a = tile_at<TBN>(e, k % T, nb, mtiles, block_n);
      const float mval = mask[e];

      float acc[2][TBN / 2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int i = 0; i < TBN / 2; ++i) acc[hh][i] = 0.f;
      for (int kt = 0; kt < nk; ++kt, ++n) {
        const int s = n % WG_ST;
        hopper::mbar_wait(&full[s], (n / WG_ST) & 1);
        const uint8_t* xs = base + s * L::STAGE;
        const uint8_t* ws = xs + L::X_BYTES;
        hopper::pin(acc[0]);
        hopper::pin(acc[1]);
        hopper::wg_fence();
#pragma unroll
        for (int kk = 0; kk < WG_BK / 16; ++kk) {
          const uint64_t db = hopper::mnmajor<TBN>(ws, WG_BK, kk);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            hopper::wgmma_ss<1>(
                acc[hh], hopper::kmajor<WG_BK>(xs, WG_BM, r0 + 64 * hh, kk),
                db, 1);
        }
        hopper::wg_commit();
        hopper::wg_wait<1>();           // the previous stage's products
        hopper::pin(acc[0]);
        hopper::pin(acc[1]);
        if (kt > 0) hopper::mbar_arrive(&empty[(n - 1) % WG_ST]);
      }
      hopper::wg_wait<0>();
      hopper::pin(acc[0]);
      hopper::pin(acc[1]);
      hopper::mbar_arrive(&empty[(n - 1) % WG_ST]);

      // epilogue, one 64-row half at a time: the staging tile is free once
      // this warpgroup's previous stores have read it.  [64][TBN] f32 as
      // TBN / 32 boxes of [64][32], 128-byte swizzle: the 16-byte unit u of
      // row r sits at unit u ^ (r % 8)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (t == 0) hopper::bulk_wait_read();
        hopper::named_sync(1 + cw, 128);
#pragma unroll
        for (int j = 0; j < TBN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * warp + lane / 4 + 8 * h;
            const int c = 8 * j + 2 * (lane % 4);
            const int cc = c % 32;
            float* dst = reinterpret_cast<float*>(
                out + (c / 32) * 64 * 128 + r * 128 +
                (((cc / 4) ^ (r % 8)) * 16) + (cc % 4) * 4);
            *reinterpret_cast<float2*>(dst) =
                make_float2(acc[hh][4 * j + 2 * h] * mval,
                            acc[hh][4 * j + 2 * h + 1] * mval);
          }
        hopper::fence_proxy_async();
        hopper::named_sync(1 + cw, 128);
        if (t == 0) {
#pragma unroll
          for (int b = 0; b < TBN / 32; ++b)
            hopper::tma_store_3d(&ty, out + b * 64 * 128, a.n0 + 32 * b,
                                 a.m0 + r0 + 64 * hh, a.g);
          hopper::bulk_commit();
        }
      }
    }
    if (t == 0) hopper::bulk_wait();
  }
}

template <int TBN>
cudaError_t launch_wgmma(const void* x, const void* w, const float* mask,
                         float* y, int G, int M, int K, int N, int block_n,
                         cudaStream_t st) {
  CUtensorMap tx, tw, ty;
  const cuuint64_t xd[3] = {(cuuint64_t)K, (cuuint64_t)M, (cuuint64_t)G};
  const cuuint64_t xs[2] = {(cuuint64_t)K * 2, (cuuint64_t)M * K * 2};
  const cuuint32_t xb[3] = {WG_BK, WG_BM, 1};
  const cuuint64_t wd[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t ws[1] = {(cuuint64_t)N * 2};
  const cuuint32_t wb[2] = {64, WG_BK};
  const cuuint64_t yd[3] = {(cuuint64_t)N, (cuuint64_t)M, (cuuint64_t)G};
  const cuuint64_t ys[2] = {(cuuint64_t)N * 4, (cuuint64_t)M * N * 4};
  const cuuint32_t yb[3] = {32, 64, 1};
  if (!hopper::make_map(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, x, xd, xs,
                        xb, hopper::Tiles<WG_BK>::SW) ||
      !hopper::make_map(&tw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, wd, ws,
                        wb, 128) ||
      !hopper::make_map(&ty, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, y, yd, ys,
                        yb, 128))
    return cudaErrorInvalidValue;
  auto kernel = dropout_matmul_wgmma<TBN>;
  constexpr size_t smem = WgLayout<TBN>::SMEM;
  cudaError_t err = hopper::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)G * (N / TBN) * ((M + WG_BM - 1) / WG_BM);
  const int sms = hopper::sm_count();
  const int grid = (int)(tiles < sms ? tiles : (sms > 0 ? sms : 1));
  kernel<<<grid, WG_THREADS, smem, st>>>(tx, tw, ty, mask, G, M, K, N,
                                         block_n);
  return cudaGetLastError();
}

}  // namespace

// route (kernel.py::ROUTES): 0 = f32 (CUDA cores), 1 = bf16 mma.sync, 2 =
// bf16 wgmma (K % 8 == 0, K > 0).  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a shape the route does not take.
extern "C" int dropout_matmul(const void* x, const void* w, const void* mask,
                              void* y, int G, int M, int K, int N,
                              int block_n, int route, void* stream) {
  if (N % BN || block_n % BN || block_n <= 0 || N % block_n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (G == 0 || M == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  float* out = static_cast<float*>(y);
  if (route == 0) {
    const dim3 grid(N / BN, (M + F_BM - 1) / F_BM, G);
    dropout_matmul_f32<<<grid, F_THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), m, out, M,
        K, N, block_n);
  } else if (route == 1) {
    const dim3 grid(N / BN, (M + TC_BM - 1) / TC_BM, G);
    dropout_matmul_bf16<<<grid, TC_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), m, out, M, K, N, block_n);
  } else if (route == 2) {
    if (K <= 0 || K % 8) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        block_n % 128 == 0
            ? launch_wgmma<128>(x, w, m, out, G, M, K, N, block_n, st)
            : launch_wgmma<64>(x, w, m, out, G, M, K, N, block_n, st));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
