// Decode attention over a block-paged KV pool, for Hopper (sm_90a): one
// query token per slot, each slot's pages split over several blocks
// (flash-decoding).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py:117
// (_kernel) behind kernel.py:349 (paged_attention), with its f32/bf16 and
// int8 pool modes.  The serving engine runs it on every tick whose chunk
// bucket is 1 (decode-only ticks); wider ticks run paged_chunk_attention.cu.
//
// Contract (the plain version is ref.py::paged_attention_ref; the split and
// merge below is ref.py::paged_attention_split_ref):
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
// What bounds it on an H100: the bytes of the live K/V pages.  At G = 2 it
// does about 4 flops per K/V byte (bf16), far below the ~295 flops a byte
// where the tensor cores would become the limit, so it runs on the CUDA
// cores and its floor is the live K/V bytes / 3.35 TB/s.  Reaching it
// takes many bytes in flight on every SM, and a decode tick has few
// (slot, kv head) pairs: 64 at 8 slots of qwen3-1.7b, against 132 SMs.
// What the design does about it:
//   - A unit of work is a (slot, kv head, R grouped query heads) triple (R
//     the largest of 8, 4, 2, 1 that divides G, a compile-time count), so
//     each K/V element is read from device memory once for R heads.  Each
//     unit is split into NS blocks, one thread-block cluster (grid (NS,
//     KH * G / R, B), clusters (NS, 1, 1)); NS comes from a pure host rule
//     of the shapes (kernel.py::decode_splits), never from the lengths, so
//     the wrapper makes no host sync.  Each block reads lengths[b], cuts
//     the live pages [first visible page, ceil(length / psize)) into NS
//     equal page ranges and takes one; a block whose range is empty (a
//     short or empty slot) does no loads.  A wide block table costs
//     nothing.
//   - A block's 4 warps walk its range in stages of TS keys through a ring
//     of NSTAGE stages in shared memory (16-byte cp.async copies issued by
//     all 128 threads, NSTAGE - 1 stages in flight while one is consumed).
//     The ring is kept to ~40 KB, so four blocks share an SM and their
//     warps hide each other's latencies.  In a stage, warp w scores keys
//     [w KPW, w KPW + KPW): LPK lanes a key, each summing every LPK-th
//     16-byte chunk of the row against the R query rows (f32, in registers
//     where R D / LPK <= 64, else in shared memory), then a shuffle sum;
//     the key row stride is padded so the lanes of one load hit distinct
//     banks.  Each warp keeps its own online-softmax state, reduced over
//     its KPW distinct keys only; P V has lane l own dims [l D/32,
//     (l+1) D/32).  Page indices are shifts when psize is a power of two.
//   - int8 pools: the K and V scale of each page of a stage are copied by
//     cp.async with the stage (one thread a page, after the block-table
//     entry the copies need anyway), so no lane waits on a scale load.  S
//     is multiplied by the page's K scale and P by its V scale, in f32.
//   - The splits are merged by log-sum-exp in the same launch, through the
//     cluster's distributed shared memory: each block merges its warps'
//     states in shared memory into one partial state (max, sum and the f32
//     accumulator of each row) and stores it into block 0's shared memory;
//     block 0 waits on the cluster barrier, merges the NS partials and
//     writes the output.  No workspace, no atomics, no second launch.  (A
//     first design merged through a global workspace and an atomic ticket
//     taken by the last block; its fence, atomic and second read took
//     about a third of the kernel's time at the serve tick, PERF.md.)  With
//     NS == 1 the block writes the output directly.  NS is at most 8, the
//     portable cluster size: clusters of 16 were slower at every shape.
//
// Pages at or past ceil(length / psize), and pages before the window's
// first visible key, are never read, and their block-table entries are
// never dereferenced.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int NW = 4;                     // warps a block
constexpr int NT = 32 * NW;
constexpr int MAXG = 8;                   // query rows (grouped heads) a block
constexpr int RING_BUDGET = 40 * 1024;    // shared bytes for the ring
constexpr int MAX_SPLITS = 8;             // blocks a cluster, the portable
                                          // most (kernel.py::
                                          // DECODE_MAX_SPLITS)

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

// cp.async: global -> shared copies that bypass registers; with src_bytes
// == 0 the destination is zero-filled and nothing is read
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The shared-memory geometry of one (pool type, head dim) pair.
template <typename KV, int D>
struct Geo {
  static constexpr int VEC = 16 / (int)sizeof(KV);  // elements a chunk
  static constexpr int CPR = D / VEC;       // 16-byte chunks a key row
  // lanes a key: the most of 4, 2, 1 that divides the chunks of a row
  static constexpr int LPK = CPR % 4 == 0 ? 4 : CPR % 2 == 0 ? 2 : 1;
  static constexpr int KPW = 32 / LPK;      // keys a warp scores a stage
  static constexpr int TS = NW * KPW;       // keys a stage
  static constexpr int ROW = D * (int)sizeof(KV);
  // row stride = 16 LPK bytes mod 128: the 8 lanes of one 16-byte load
  // phase (8 / LPK keys, LPK chunks each) cover 32 distinct banks
  static constexpr int RSB = ROW + ((16 * LPK - ROW % 128) % 128 + 128) % 128;
  static constexpr int STAGE = 2 * TS * RSB;                  // K and V
  static constexpr int NSTAGE = RING_BUDGET / STAGE < 2   ? 2
                                : RING_BUDGET / STAGE > 4 ? 4
                                                          : RING_BUDGET / STAGE;
  static constexpr int RING = NSTAGE * STAGE;
  // the warps' merge reuses the ring: [NW][R] max and sum, [NW][R][D] acc
  static constexpr int MERGE = 4 * NW * MAXG * (D + 2);
  static constexpr int BODY = RING > MERGE ? RING : MERGE;
  static constexpr int SCALES = NSTAGE * 2 * (TS + 1);        // floats
  static constexpr int SMEM = BODY + 4 * MAXG * D + 4 * SCALES;
};

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

// Merge the NW warps' online-softmax states of a block's R rows (Ms/Ls
// [NW][R] max and sum, As [NW][R][D] accumulators) into the block's state,
// and then the NS blocks of the cluster by log-sum-exp.  NS == 1: the
// output rows ``out`` ([R][D]).  NS > 1: each block stores its partial
// (the [R][D + 2] accumulators, max and sum of each row) into slot
// ``split`` of block 0's collection area ``Coll`` ([NS][R][D + 2], a
// region no block uses for anything else) through distributed shared
// memory, and arrives on the cluster barrier; block 0 waits on it, then
// merges the NS partials from its own shared memory and writes the
// output.  Remote stores only, and only block 0
// waits at the end.  (The kernel arrived on the barrier once when it
// started: the wait here on that first phase makes sure every block of
// the cluster is running before any stores into another's memory.)
template <typename T, int D, int R>
__device__ __forceinline__ void merge_and_write(const float* Ms,
                                                const float* Ls,
                                                const float* As, int split,
                                                int NS, T* out, float* Coll) {
  constexpr int W = D + 2;                 // a partial row: acc, max, sum
  float* dst = nullptr;
  if (NS > 1) {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    dst = cg::this_cluster().map_shared_rank(Coll, 0) +
          (size_t)split * R * W;
  }
  for (int idx = threadIdx.x; idx < R * D; idx += NT) {
    const int i = idx / D, d = idx % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, Ms[w * R + i]);
    float lsum = 0.f, a = 0.f;
    if (mx != -INFINITY) {                 // else no warp saw a live key
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float f = expf(Ms[w * R + i] - mx);
        lsum += Ls[w * R + i] * f;
        a += As[(w * R + i) * D + d] * f;
      }
    }
    if (NS == 1) {
      out[idx] = from_f32<T>(mx != -INFINITY ? a / lsum : 0.f);
    } else {
      dst[i * W + d] = a;
      if (d == 0) {
        dst[i * W + D] = mx;
        dst[i * W + D + 1] = lsum;
      }
    }
  }
  if (NS == 1) return;
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  if (split != 0) return;                  // peers: their part is done
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  for (int idx = threadIdx.x; idx < R * D; idx += NT) {
    const int i = idx / D, d = idx % D;
    float mx = -INFINITY;
    for (int r = 0; r < NS; ++r)
      mx = fmaxf(mx, Coll[(r * R + i) * W + D]);
    float lsum = 0.f, a = 0.f;
    if (mx != -INFINITY) {
      for (int r = 0; r < NS; ++r) {
        const float* pr = Coll + (r * R + i) * W;
        if (pr[D] == -INFINITY) continue;  // an empty split
        const float f = expf(pr[D] - mx);
        lsum += pr[D + 1] * f;
        a += pr[d] * f;
      }
    }
    out[idx] = from_f32<T>(mx != -INFINITY ? a / lsum : 0.f);
  }
}

// Key positions to pages: shifts when psize is a power of two.
struct Paging {
  int psize, shift;
  __device__ explicit Paging(int ps) : psize(ps) {
    shift = (ps & (ps - 1)) == 0 ? __ffs(ps) - 1 : -1;
  }
  __device__ int page(int k) const {           // the page of key k
    return shift >= 0 ? k >> shift : k / psize;
  }
  __device__ int row(int k) const {            // key k's row in its page
    return shift >= 0 ? k & (psize - 1) : k % psize;
  }
};

// This split's keys [kb, ke) of a slot of ``length`` keys: its share of the
// live pages [first visible page, ceil(length / psize)), cut to the
// visible keys (empty when length == 0 or the share is empty).
struct KeyRange {
  int kb, ke;
  __device__ KeyRange(int length, int window, const Paging& pg, int split,
                      int NS) {
    const int k_lo = window > 0 ? max(0, length - window) : 0;
    const int p_lo = pg.page(k_lo);
    const int npg =
        length > 0 ? pg.page(length + pg.psize - 1) - p_lo : 0;
    const int pa = p_lo + split * npg / NS;
    const int pb = p_lo + (split + 1) * npg / NS;
    kb = max(k_lo, pa * pg.psize);
    ke = min(length, pb * pg.psize);
  }
};

// The block-table entries one thread's copies of a tile need, fetched an
// iteration before the copies are issued, so a block-table load is never
// on the path from one tile's copies to the next: ``page[i]`` is the page
// of the thread's chunk i (chunk threadIdx.x + i NT of the tile's TS keys,
// CPR chunks a key; -1 past the live keys), ``scale_page`` the page whose
// scales the thread copies (int8; thread j takes the tile's j-th page).
template <int CPT>
struct PageIds {
  int page[CPT];
  int scale_page;

  __device__ __forceinline__ void fetch(const int* bt, int k0, int ke, int TS,
                                        int CPR, const Paging& pg,
                                        bool scales) {
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = threadIdx.x + i * NT, kpos = k0 + c / CPR;
      page[i] = c < TS * CPR && kpos < ke ? bt[pg.page(kpos)] : -1;
    }
    scale_page = -1;
    if (scales && k0 < ke) {
      const int pg0 = pg.page(k0);
      if ((int)threadIdx.x < pg.page(min(k0 + TS, ke) - 1) - pg0 + 1)
        scale_page = bt[pg0 + threadIdx.x];
    }
  }
  // element offset of key kpos's row, kv head kh, in a pool, from page[i]
  __device__ __forceinline__ long long offset(int i, int kpos,
                                              const Paging& pg, int KH,
                                              int kh, int D) const {
    return (((long long)page[i] * pg.psize + pg.row(kpos)) * KH + kh) * D;
  }
};

// The operands of one launch, as the C entry point receives them.
struct Args {
  const void *q, *k, *v;
  const float *ks, *vs;
  const int *bt, *lengths;
  void* out;
  int B, H, KH, D, psize, maxp, NS;
  float scale;
  int window;
  float softcap;
};

// R: query rows (grouped heads) per block, a compile-time count that
// divides G, so no row of a block is ever padding
template <typename T, typename KV, int D, int R>
__global__ void __launch_bounds__(NT)
paged_attention_kernel(const T* __restrict__ q,
                       const KV* __restrict__ k_pages,
                       const KV* __restrict__ v_pages,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       int H, int KH, int psize, int maxp, float scale,
                       int window, float softcap) {
  using Gm = Geo<KV, D>;
  constexpr bool QUANT = std::is_same<KV, int8_t>::value;
  constexpr int NE = D / 32;                 // dims a lane owns in P V
  constexpr int VEC = Gm::VEC, CPR = Gm::CPR, LPK = Gm::LPK;
  constexpr int KPW = Gm::KPW, TS = Gm::TS, RSB = Gm::RSB;
  constexpr int NSTAGE = Gm::NSTAGE;
  constexpr int CPT = (TS * CPR + NT - 1) / NT;  // chunks a thread a tile
  constexpr int QN = D / LPK;                // q elements a lane reads, a row
  constexpr bool QREG = R * QN <= 64;        // q in registers
  static_assert(R <= MAXG, "too many rows a block");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw + Gm::BODY);  // [R][D]
  float* Sc = Qs + MAXG * D;                  // [NSTAGE][K|V][TS + 1]

  const int NS = gridDim.x, split = blockIdx.x, b = blockIdx.z;
  const int NRG = H / KH / R;                // row groups a kv head
  const int kh = blockIdx.y / NRG;
  const int h0 = kh * (H / KH) + (blockIdx.y % NRG) * R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int part = lane % LPK;
  // the first phase of the cluster barrier: this block is running
  if (NS > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" :::
                           "memory");
  const Paging pg(psize);

  for (int i = threadIdx.x; i < R * D; i += NT)
    Qs[i] = to_f32(q[((size_t)b * H + h0) * D + i]);

  const KeyRange range(lengths[b], window, pg, split, NS);
  const int kb = range.kb, ke = range.ke;
  const int ntiles = ke > kb ? (ke - kb + TS - 1) / TS : 0;

  PageIds<CPT> ids;
  auto fetch = [&](int t) {
    ids.fetch(block_tables + (size_t)b * maxp, kb + t * TS,
              t < ntiles ? ke : 0, TS, CPR, pg, QUANT);
  };
  // copy the K/V rows of tile t into stage st, from the page ids fetched
  // for it (keys past ke zero-filled); int8: one thread a page of the
  // tile also copies its K and V scale
  auto issue_tile = [&](int t, int st) {
    const int k0 = kb + t * TS;
    uint8_t* Kst = smem_raw + st * Gm::STAGE;
    uint8_t* Vst = Kst + TS * RSB;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = threadIdx.x + i * NT;
      if (c >= TS * CPR) break;
      const int j = c / CPR, u = c % CPR;
      const long long off = ids.offset(i, k0 + j, pg, KH, kh, D) + u * VEC;
      const int nbytes = ids.page[i] >= 0 ? 16 : 0;
      cp_async16(Kst + j * RSB + u * 16, k_pages + (nbytes ? off : 0),
                 nbytes);
      cp_async16(Vst + j * RSB + u * 16, v_pages + (nbytes ? off : 0),
                 nbytes);
    }
    if constexpr (QUANT) {
      if (ids.scale_page >= 0) {
        const long long si = (long long)ids.scale_page * KH + kh;
        float* sc = Sc + st * 2 * (TS + 1);
        cp_async4(sc + threadIdx.x, k_scale + si);
        cp_async4(sc + TS + 1 + threadIdx.x, v_scale + si);
      }
    }
  };

  // the ring: NSTAGE - 1 tiles in flight while one is consumed; every
  // iteration commits one group (empty past the last tile), so
  // wait_group<NSTAGE - 2> always leaves tile t landed.  The page ids of
  // the next tile to issue are fetched one iteration ahead.
  fetch(0);
#pragma unroll
  for (int st = 0; st < NSTAGE - 1; ++st) {
    if (st < ntiles) issue_tile(st, st);
    cp_async_commit();
    fetch(st + 1);
  }
  __syncthreads();                                 // Qs written

  // this lane's q elements: chunk it * LPK + part of each row
  float qr[QREG ? R : 1][QREG ? QN : 1];
  if constexpr (QREG) {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int it = 0; it < CPR / LPK; ++it)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          qr[i][it * VEC + e] = Qs[i * D + (it * LPK + part) * VEC + e];
  }

  float m[R], l[R], acc[R][NE];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[i][e] = 0.f;
  }

  // consume tile t from stage st: this warp's KPW keys
  auto consume_tile = [&](int t, int st) {
    const int k0 = kb + t * TS;
    const int wk0 = k0 + warp * KPW;        // this warp's first key
    if (wk0 >= ke) return;                  // warp-uniform: none is live
    const uint8_t* Kst = smem_raw + st * Gm::STAGE;
    const uint8_t* Vst = Kst + TS * RSB;
    const float* sc = Sc + st * 2 * (TS + 1);
    const int pg0 = pg.page(k0);
    const int jj = warp * KPW + lane / LPK;
    const int kpos = k0 + jj;
    const bool ok = kpos < ke;

    // scores: LPK lanes a key, each summing every LPK-th chunk of the row
    float s[R];
#pragma unroll
    for (int i = 0; i < R; ++i) s[i] = 0.f;
    const KV* kr = reinterpret_cast<const KV*>(Kst + jj * RSB);
#pragma unroll
    for (int it = 0; it < CPR / LPK; ++it) {
      const int u = it * LPK + part;
      float kx[VEC];
      load_f32<KV, VEC>(kr + u * VEC, kx);
#pragma unroll
      for (int e4 = 0; e4 < VEC; e4 += 4) {
#pragma unroll
        for (int i = 0; i < R; ++i) {
          float4 qv;
          if constexpr (QREG) {
            qv = make_float4(qr[i][it * VEC + e4], qr[i][it * VEC + e4 + 1],
                             qr[i][it * VEC + e4 + 2],
                             qr[i][it * VEC + e4 + 3]);
          } else {
            qv = *reinterpret_cast<const float4*>(Qs + i * D + u * VEC + e4);
          }
          s[i] = fmaf(qv.x, kx[e4], s[i]);
          s[i] = fmaf(qv.y, kx[e4 + 1], s[i]);
          s[i] = fmaf(qv.z, kx[e4 + 2], s[i]);
          s[i] = fmaf(qv.w, kx[e4 + 3], s[i]);
        }
      }
    }
#pragma unroll
    for (int o = LPK / 2; o > 0; o >>= 1)
#pragma unroll
      for (int i = 0; i < R; ++i) s[i] += __shfl_xor_sync(0xffffffffu, s[i], o);
    float kscale = 1.f;
    if constexpr (QUANT) kscale = ok ? sc[pg.page(kpos) - pg0] : 1.f;

    // the warp's first key is live, so every row has a finite maximum;
    // keys past ke get probability 0.  The LPK lanes of a key agree, so
    // the reductions run over the warp's KPW distinct keys only
    float p[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float x = s[i] * kscale * scale;
      if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
      x = ok ? x : -INFINITY;
      float mt = x;
#pragma unroll
      for (int o = 16; o >= LPK; o >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_new = fmaxf(m[i], mt);
      const float corr = expf(m[i] - m_new);
      p[i] = ok ? expf(x - m_new) : 0.f;
      float ps = p[i];
#pragma unroll
      for (int o = 16; o >= LPK; o >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l[i] = l[i] * corr + ps;
#pragma unroll
      for (int e = 0; e < NE; ++e) acc[i][e] *= corr;
      m[i] = m_new;
    }
    // P V over this warp's live keys; each V row is read once for all R
    // rows (int8: P times the page's V scale)
    const int nk = min(KPW, ke - wk0);
    for (int j = 0; j < KPW; ++j) {
      if (j >= nk) break;                   // warp-uniform
      float vx[NE];
      load_f32<KV, NE>(
          reinterpret_cast<const KV*>(Vst + (warp * KPW + j) * RSB) +
              lane * NE, vx);
      float vscale = 1.f;
      if constexpr (QUANT) vscale = sc[TS + 1 + pg.page(wk0 + j) - pg0];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float pj = __shfl_sync(0xffffffffu, p[i], j * LPK) * vscale;
#pragma unroll
        for (int e = 0; e < NE; ++e) acc[i][e] = fmaf(pj, vx[e], acc[i][e]);
      }
    }
  };

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();              // tile t visible; tile t - 1 consumed
    if (t + NSTAGE - 1 < ntiles)
      issue_tile(t + NSTAGE - 1, (t + NSTAGE - 1) % NSTAGE);
    cp_async_commit();
    fetch(t + NSTAGE);
    consume_tile(t, t % NSTAGE);
  }
  cp_async_wait<0>();

  // merge the warps' states through shared memory (the ring is free once
  // every warp has left its loop)
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
  merge_and_write<T, D, R>(Ms, Ls, As, split, NS,
                           out + ((size_t)b * H + h0) * D,
                           Sc + Gm::SCALES);
}

// One cluster of NS blocks along x a unit of work.
template <typename T, typename KV, int D, int R>
cudaError_t launch_rows(const Args& a, cudaStream_t stream) {
  auto kernel = paged_attention_kernel<T, KV, D, R>;
  // the ring, q, the scales, then (NS > 1) block 0's collection area
  const int smem = Geo<KV, D>::SMEM + (a.NS > 1 ? 4 * a.NS * R * (D + 2) : 0);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.NS, a.H / R, a.B);   // (split, kv head x row group)
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.NS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), a.ks, a.vs, a.bt, a.lengths,
      static_cast<T*>(a.out), a.H, a.KH, a.psize, a.maxp, a.scale, a.window,
      a.softcap);
}

// rows a block: the largest of 8, 4, 2, 1 that divides G
// (kernel.py::decode_rows)
template <typename T, typename KV, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int G = a.H / a.KH;
  if (G % 8 == 0) return launch_rows<T, KV, D, 8>(a, stream);
  if (G % 4 == 0) return launch_rows<T, KV, D, 4>(a, stream);
  if (G % 2 == 0) return launch_rows<T, KV, D, 2>(a, stream);
  return launch_rows<T, KV, D, 1>(a, stream);
}

template <typename T, typename KV>
cudaError_t dispatch_d(const Args& a, cudaStream_t s) {
#define CASE(DD) \
  case DD:       \
    return launch<T, KV, DD>(a, s);
  switch (a.D) {
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
// scales.  num_splits (NS, 1 to 8): blocks a (slot, kv head, row group),
// one cluster.  window <= 0: none; softcap <= 0: none.  Returns the
// launch's error, or cudaGetLastError() after it (0 on success).
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* lengths, void* out, int B, int H, int KH, int D, int psize,
    int maxp, int num_splits, float scale, int window, float softcap,
    int dtype, int kv_int8, void* stream) {
  const Args a{q, k_pages, v_pages,
               static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(block_tables),
               static_cast<const int*>(lengths), out,
               B, H, KH, D, psize, maxp, num_splits, scale, window, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (num_splits < 1 || num_splits > MAX_SPLITS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == 0 && !kv_int8)
    err = dispatch_d<float, float>(a, s);
  else if (dtype == 1 && !kv_int8)
    err = dispatch_d<__nv_bfloat16, __nv_bfloat16>(a, s);
  else if (dtype == 0)
    err = dispatch_d<float, int8_t>(a, s);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16, int8_t>(a, s);
  else
    err = cudaErrorInvalidValue;
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}
