// K4 resident_dot_segmax, for sm_90a: the "dot" mode of the isolation
// probes (scripts/exp_isolate_kernel.py:34 make, pallas_call at :89;
// scripts/exp_isolate2.py:17 make, :68). The TPU copied corpus block 0
// (blk rows) into VMEM once, kept the queries resident in VMEM too, and ran
// the product and segment max on that block for each of the N / blk chunks:
//   out[i * blk / 128 + p, q] = max over r < 128 of
//                               sum_d q[q, d] c[128 p + r, d]   (f32 sums)
// for chunk i < N / blk and segment p < blk / 128: block 0's maxima,
// repeated. The probe times the matrix unit, so this kernel issues every
// one of the N Q D multiply-adds, each chunk's maxima from its own product;
// it never copies one chunk's output to another.
//
// Bound on the H100 (989 TFLOP/s bf16 dense on the tensor cores): at
// N 1,245,184, Q 128, D 768 the products are 2 N Q D = 245 GFLOP, 0.248 ms.
// The bytes it must move (block 0 read once, [N/128, Q] f32 written) take
// 0.003 ms, so the tensor cores bound it.
//
// Design (one body; each block is one SM's, persistent):
// * What stays on chip. A block holds 64 of the queries (its "half": rows
//   64 h .. 64 h + 63, zeros past Q from the tensor map's bounds) in shared
//   memory for the whole launch, D / 64 blocks of 64 queries x 64 deep in
//   the 128-byte swizzle (96 KB at D 768): the TPU's resident queries. Block
//   0 (3-25 MB at blk 2,048-16,384) cannot sit in 227 KB; it stays in the
//   50 MB L2, and a producer warp streams its 128-row tiles, 64 deep
//   (16 KB a stage, one TMA copy), into a ring of mbarrier-guarded stages.
// * A unit is one row tile p and four chunks i0 .. i0 + 3 (the same rows,
//   the same queries, four products): consumer warpgroup w runs the
//   products of chunks i0 + 2w and i0 + 2w + 1, each into its own 64 f32
//   accumulators a thread, from the same stage. Each row tile fetched from
//   L2 thus feeds 4 x 64 query products: at Q 128 the launch moves
//   N D 2 / 4 bytes a query half, 0.96 GB in all, where one product a
//   fetch would move 1.9 GB through L2 (the old mma.sync K4 moved 3.8 GB).
//   Units are dealt round-robin over the blocks of a half; chunks past
//   N / blk in the last unit of a tile are computed and not stored.
// * The product: wgmma.m64n128k16 bf16 x bf16 -> f32 with both operands
//   in shared memory, A the 64 queries, B the tile's 128 rows (96 bytes of
//   operands a clock at the full rate, under the ~128 a clock shared
//   memory gives a wgmma). `natural` (the TPU's [blk, D] x [D, Q]
//   contraction, the block leading) makes the rows the M side: two
//   wgmma.m64n64k16 a product, A the rows' halves, B the 64 queries. The
//   sums are the same exact bf16 products in f32 either way; only the
//   order inside the tensor core differs.
// * The ring: as many 16 KB stages as fit beside the queries, at most
//   4 `slots` and 8 (7 at D 768 from slots 2 on; the TPU's dot mode kept
//   its block in one of its `slots` buffers and never streamed). Each stage
//   has a full mbarrier (the TMA's bytes) and an empty one (both consumer
//   warpgroups done with it); a consumer keeps one wgmma group in flight
//   and frees a stage when the next one's group is issued. Any wait of
//   ~2 s traps: a fault fails the launch instead of hanging the card.
// * Epilogue from the accumulators, nothing of the tile staged: natural
//   off, a thread's two queries' maxima over its 32 columns, then two
//   shuffles across the 4 lanes of a query's row; 16 lanes of a warp store
//   16 contiguous floats. Natural on, a thread's 16 queries' maxima over
//   its 4 rows, three shuffles across the 8 row groups, then the 4 warps'
//   partial maxima meet in 2 KB of shared memory. A block stores its 64
//   queries of an output row as 256 contiguous bytes.
//
// Limits: 1 <= Q <= 128, D a multiple of 64 up to MAX_D = 1,472 (the
// queries' 64-row half, D x 128 bytes, beside the smallest ring of two
// stages), blk a multiple of 128 dividing N, slots >= 1; the wrapper
// checks them and names them.
//
// C interface (bound with ctypes): returns cudaGetLastError() after the
// launch; 0 is success.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>

#include "async_copy.cuh"
#include "hopper.cuh"

namespace {

constexpr int TILE = 128;                         // rows of a tile: one output row of maxima
constexpr int BK = SW128_VALUES;                  // depth of a stage and of a query block
constexpr int ROWB = 128;                         // bytes of a staged row (64 bf16)
constexpr int QH = 64;                            // queries a block holds: a query half
constexpr int REPS = 4;                           // chunks a unit
constexpr int CONSUMERS = 256;                    // two warpgroups, two of a unit's products each
constexpr int THREADS = CONSUMERS + 32;           // and the producer warp
constexpr int STAGE = TILE * ROWB;                // 16,384 bytes: 128 rows x 64 deep
constexpr int QBLOCK = QH * ROWB;                 // 8,192 bytes: 64 queries x 64 deep
constexpr int RED = 2 * 2 * 4 * QH * 4;           // natural: the warps' partial maxima
constexpr int SMEM_MAX = 232448;                  // all the shared memory an H100 block may have
constexpr int MAX_STAGES = 8;
constexpr int MAX_D = 1472;

constexpr int smem_bytes(int kt, int stages) {
  return 1024 + kt * QBLOCK + stages * STAGE + RED + (2 * stages + 1) * 8;
}
static_assert(smem_bytes(MAX_D / BK, 2) <= SMEM_MAX, "MAX_D leaves room for two stages");
static_assert(smem_bytes(MAX_D / BK + 1, 2) > SMEM_MAX, "MAX_D is the largest depth that fits");

// d[OFF .. OFF + 31] += a[64 x 16] b[64 x 16]^T: as wgmma_m64n128k16 at
// N 64 (thread (warp w, lane 4 g + t) holds rows 16 w + g and 16 w + g + 8
// at columns 8 j + 2 t, 8 j + 2 t + 1, j < 8)
template <int OFF>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]),
        "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]), "+f"(d[OFF + 9]),
        "+f"(d[OFF + 10]), "+f"(d[OFF + 11]), "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]),
        "+f"(d[OFF + 15]), "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]),
        "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]), "+f"(d[OFF + 24]),
        "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]),
        "+f"(d[OFF + 30]), "+f"(d[OFF + 31])
      : "l"(a), "l"(b), "r"(1));
}

// the 128 threads of consumer warpgroup wg meet (named barrier 1 + wg)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// queries (qmap: [Q, D], boxes of 64 x 64) x corpus block 0 (cmap: [blk, D],
// boxes of 128 rows x 64): units u = first, first + step, ... of the
// block's query half, a unit being row tile u % P and chunks
// 4 (u / P) .. 4 (u / P) + 3
template <bool NATURAL>
__global__ void __launch_bounds__(THREADS, 1)
resident_dot_kernel(const __grid_constant__ CUtensorMap cmap, const __grid_constant__ CUtensorMap qmap,
                    float* __restrict__ out, int Q, int P, int nch, int units, int halves, int kt,
                    int stages) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t s0 = smem_addr(smem);
  const uint32_t qs = (s0 + 1023) & ~1023u;        // kt blocks of 64 queries x 64 deep
  const uint32_t ring = qs + kt * QBLOCK;          // stages x 128 rows x 64 deep
  float* red = reinterpret_cast<float*>(smem + (ring + stages * STAGE - s0));  // [wg][rep][warp][64]
  const uint32_t full = ring + stages * STAGE + RED;  // a stage's rows have landed
  const uint32_t empty = full + 8 * stages;            // both consumers are done with a stage
  const uint32_t qbar = empty + 8 * stages;            // the queries have landed

  const int tid = threadIdx.x;
  const int qhalf = blockIdx.x % halves;
  const int first = blockIdx.x / halves, step = gridDim.x / halves;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warp: one thread issues every copy
    if (tid == CONSUMERS) {
      mbar_expect_tx(qbar, kt * QBLOCK);
      for (int k = 0; k < kt; ++k) tma_load_2d(qs + k * QBLOCK, &qmap, k * BK, qhalf * QH, qbar);
      int s = 0;
      uint32_t ph = 0;
      bool lapped = false;  // every stage has been filled once
      for (int u = first; u < units; u += step) {
        const int p = u % P;
        for (int k = 0; k < kt; ++k) {
          if (lapped) mbar_wait(empty + 8 * s, ph ^ 1);
          mbar_expect_tx(full + 8 * s, STAGE);
          tma_load_2d(ring + s * STAGE, &cmap, k * BK, p * TILE, full + 8 * s);
          if (++s == stages) {
            s = 0;
            ph ^= 1;
            lapped = true;
          }
        }
      }
    }
    return;
  }

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  float acc[2][64];  // products of chunks i0 + 2 wg and i0 + 2 wg + 1
  mbar_wait(qbar, 0);
  int s = 0, held = 0;
  uint32_t ph = 0;
  for (int u = first; u < units; u += step) {
    const int p = u % P;
    const int i0 = (u / P) * REPS + 2 * wg;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int x = 0; x < 64; ++x) {
        acc[r][x] = 0.f;
        fence_operand(acc[r][x]);
      }
    for (int k = 0; k < kt; ++k) {
      mbar_wait(full + 8 * s, ph);
      const uint32_t st = ring + s * STAGE, qk = qs + k * QBLOCK;
      wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < BK / 16; ++k16) {
        if constexpr (NATURAL) {
          const uint64_t b = sw128_desc(qk + 32 * k16);
          const uint64_t a0 = sw128_desc(st + 32 * k16), a1 = sw128_desc(st + 64 * ROWB + 32 * k16);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            wgmma_m64n64k16<0>(acc[r], a0, b);
            wgmma_m64n64k16<32>(acc[r], a1, b);
          }
        } else {
          const uint64_t a = sw128_desc(qk + 32 * k16), b = sw128_desc(st + 32 * k16);
#pragma unroll
          for (int r = 0; r < 2; ++r) wgmma_m64n128k16(acc[r], a, b);
        }
      }
      wgmma_commit();
      if (k > 0) {  // the previous stage's products are done: free it
        wgmma_wait<1>();
        if ((tid & 127) == 0) mbar_arrive(empty + 8 * held);
      }
      held = s;
      if (++s == stages) {
        s = 0;
        ph ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int x = 0; x < 64; ++x) fence_operand(acc[r][x]);
    if ((tid & 127) == 0) mbar_arrive(empty + 8 * held);

    if constexpr (!NATURAL) {
      // thread: queries 16 warp + g (acc 4 j, 4 j + 1) and 16 warp + g + 8
      // (4 j + 2, 4 j + 3), rows 8 j + 2 t4 and 8 j + 2 t4 + 1 of the tile
      const int q = qhalf * QH + 16 * warp + g + 8 * t4;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (i0 + r >= nch) continue;  // uniform across the warpgroup
        float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          m0 = fmaxf(m0, fmaxf(acc[r][4 * j], acc[r][4 * j + 1]));
          m1 = fmaxf(m1, fmaxf(acc[r][4 * j + 2], acc[r][4 * j + 3]));
        }
        m0 = fmaxf(m0, __shfl_xor_sync(~0u, m0, 1));
        m0 = fmaxf(m0, __shfl_xor_sync(~0u, m0, 2));
        m1 = fmaxf(m1, __shfl_xor_sync(~0u, m1, 1));
        m1 = fmaxf(m1, __shfl_xor_sync(~0u, m1, 2));
        if (t4 < 2 && q < Q) out[((int64_t)(i0 + r) * P + p) * Q + q] = t4 ? m1 : m0;
      }
    } else {
      // thread: rows 16 warp + g (+ 8) and 64 + those, queries 8 j + 2 t4 + e
      // (acc 4 j + e, 4 j + 2 + e; 32 + the same for the second half)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v[16];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float m = fmaxf(fmaxf(acc[r][4 * j + e], acc[r][4 * j + 2 + e]),
                            fmaxf(acc[r][32 + 4 * j + e], acc[r][32 + 4 * j + 2 + e]));
            m = fmaxf(m, __shfl_xor_sync(~0u, m, 4));
            m = fmaxf(m, __shfl_xor_sync(~0u, m, 8));
            v[2 * j + e] = fmaxf(m, __shfl_xor_sync(~0u, m, 16));
          }
        if (g == 0) {
          float* w = red + ((wg * 2 + r) * 4 + warp) * QH + 2 * t4;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            w[8 * j] = v[2 * j];
            w[8 * j + 1] = v[2 * j + 1];
          }
        }
      }
      warpgroup_sync(wg);
      const int r = (tid & 127) >> 6, ql = tid & 63;
      const float* w = red + (wg * 2 + r) * 4 * QH + ql;
      const float m = fmaxf(fmaxf(w[0], w[QH]), fmaxf(w[2 * QH], w[3 * QH]));
      const int q = qhalf * QH + ql;
      if (i0 + r < nch && q < Q) out[((int64_t)(i0 + r) * P + p) * Q + q] = m;
      warpgroup_sync(wg);  // red is free for the next unit
    }
  }
}

std::atomic<int> sm_count[64];

}  // namespace

// queries [Q, D] bf16, corpus [N, D] bf16 of which the first blk rows are
// read (both contiguous, 16-byte aligned), out [N / 128, Q] f32.
extern "C" int resident_dot_segmax(const void* q, const void* c, void* out, int Q, long long N, int D,
                                   long long blk, int natural, int slots, int device, void* stream) {
  if (Q < 1 || Q > 2 * QH || D < BK || D % BK || D > MAX_D || blk < TILE || blk % TILE || N < blk ||
      N % blk || N / TILE > 0x7fffffffLL || slots < 1 || device < 0 || device >= 64 ||
      reinterpret_cast<uintptr_t>(q) % 16 || reinterpret_cast<uintptr_t>(c) % 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int sms = sm_count[device].load();
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    sm_count[device].store(sms);
  }
  const int kt = D / BK;
  const int fit = (SMEM_MAX - smem_bytes(kt, 0)) / (STAGE + 16);
  int stages = slots < MAX_STAGES / 4 ? 4 * slots : MAX_STAGES;
  if (stages > fit) stages = fit;
  const int P = static_cast<int>(blk / TILE), nch = static_cast<int>(N / blk);
  const int halves = (Q + QH - 1) / QH;
  const long long units = static_cast<long long>(P) * ((nch + REPS - 1) / REPS);
  if (units > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int per_half = sms / halves < units ? sms / halves : static_cast<int>(units);
  CUtensorMap cmap, qmap;
  if (!bf16_map(&cmap, c, D, blk, 0, TILE) || !bf16_map(&qmap, q, D, Q, 0, QH)) return (int)cudaErrorInvalidValue;
  auto fn = natural ? resident_dot_kernel<true> : resident_dot_kernel<false>;
  const int smem = smem_bytes(kt, stages);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<per_half * halves, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      cmap, qmap, static_cast<float*>(out), Q, P, nch, static_cast<int>(units), halves, kt, stages);
  return (int)cudaGetLastError();
}

extern "C" const char* resident_dot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
