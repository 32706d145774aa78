// The streaming score + segment-max kernel and its read probe, for sm_90a:
// the hand-written counterparts of the TPU kernels in the exact top-k
// experiments (scripts/exp_stream_kernel.py, exp_isolate_kernel.py,
// exp_isolate2.py, exp_dma_probe.py). The third kernel of those
// experiments, K4 (the isolation probes' "dot" mode), is resident_dot.cu.
//
// K2  stream_segmax: queries [Q, D] bf16 (Q <= 128) x corpus [N, D] bf16 ->
//       segmax[t, q] = max over segment t (seg 64 or 128 rows) of
//       scores[q, n] = sum_d q[q, d] c[n, d]   (f32 accumulation)
//     and, by layout, the scores as [Q, N] (layout 1), as [N, Q] (layout
//     2) or not at all (layout 0). Replaces make_stream
//     (exp_stream_kernel.py:27-119: [Q, N] or, transposed, [N, Q] scores
//     + segmax) and the "both" mode of make (exp_isolate_kernel.py:34-99,
//     exp_isolate2.py:17-79: segmax only, no score write).
// K3  read_probe: the "dma" modes (exp_isolate_kernel.py:76-80,
//     exp_isolate2.py:59-60) and make (exp_dma_probe.py:19-64), which
//     stream the [N, D] slab and keep only the first row of a chunk:
//       heads[i, j] = f32(c[i * blk, j]), j < width,
//       sums[i]     = sum of chunk i's bf16 bit patterns as int16 (int64).
//     The TPU's outputs are defined only there (the rest of its segmax
//     buffer is never written, and the probe returns the chunk that last
//     sat in ring slot 0: a head); the sums make every byte's read
//     observable and checkable, in any order, exactly.
//
// Bounds on the H100 (3.35 TB/s; 989 TFLOP/s bf16 dense on the tensor
// cores) at N 1,245,184, D 768, Q 128: the slab is 1.913 GB (0.571 ms);
// the [Q, N] or [N, Q] f32 scores add 0.638 GB (0.763 ms in all); the
// product is 2 Q N D = 245 GFLOP (0.247 ms). K2 and K3 are bound by
// bytes.
//
// Design of K2 (mma.sync.m16n8k16 bf16 -> f32: bf16 products are
// exact in f32, so this is the TPU's arithmetic up to summation order):
// * One block of 8 warps takes a 128-row corpus tile and all queries
//   (zero rows past Q) and walks the depth in steps of 64 through a ring
//   of STAGES shared-memory stages (2 or 4, the TPU's `slots`), filled by
//   16-byte cp.async copies into rows padded to 72 values (144 bytes) so
//   ldmatrix is free of bank conflicts. A stage is 36 KB; 2 stages let 2
//   blocks share an SM.
// * Warps are 2 x 4 over the 128 x 128 product, 64 x 32 each. The TPU's
//   `natural` (which operand leads the contraction) picks the mma's A:
//   the queries (natural off: the accumulators are [q, n]) or the corpus
//   tile (natural on: [n, q]). The result does not depend on it.
// * The epilogue puts the 128 x 128 f32 tile into shared memory as
//   [n][q] with a row step of 129 floats (no bank conflict for a warp
//   that walks q or n), then takes each query's max over the tile's
//   segments and writes the scores in rows of contiguous floats for
//   either layout.
// * The TPU's blk (rows a DMA step) has no counterpart in K2: a block's
//   step is its 128-row tile (the TPU's 2,048-16,384-row steps are 3-25
//   MB, against 227 KB of shared memory).
//
// Design of K3: block b reads its tile of 256 x 16 x U contiguous bytes
// (U = slots: 1, 2, 4, 8 or 16), one 16-byte load a thread for each of U
// steps; the TPU's `static` (an unrolled copy loop) picks U as a template
// constant with the loads issued together, against a runtime count walked
// one load at a time. Tiles never cross a chunk (the wrapper checks),
// each block adds its sum to its chunk's with one 64-bit atomic, and the
// first block of a chunk writes the chunk's head.
//
// C interface (bound with ctypes): each entry returns cudaGetLastError()
// after the launch; 0 is success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int TILE = 128;           // corpus rows a block, and the query tile
constexpr int BK = 64;              // depth a stage
constexpr int ROW = BK + 8;         // shared-memory row step in bf16 values
constexpr int THREADS = 256;
constexpr int STAGE_ELEMS = 2 * TILE * ROW;           // queries + corpus
constexpr int STAGE_BYTES = STAGE_ELEMS * 2;          // 36,864
constexpr int TS = TILE + 1;                          // epilogue row step (f32)
constexpr int EPI_BYTES = (TILE * TS + 2 * TILE) * 4; // tile + two partial rows

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// depth step k of the queries (rows >= Q zero-filled) and of the corpus
// rows row0 .. row0 + 127 into one stage: 2 x 1,024 16-byte copies
__device__ __forceinline__ void load_stage(__nv_bfloat16* st, const __nv_bfloat16* q,
                                           const __nv_bfloat16* c, int Q, int D, int64_t row0,
                                           int k, int tid) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = tid + i * THREADS;  // 0 .. 1023
    const int r = idx >> 3, col = (idx & 7) * 8;
    const bool live = r < Q;
    cp_async16(smem_addr(st + r * ROW + col), q + (live ? static_cast<int64_t>(r) * D + k + col : 0),
               live ? 16 : 0);
    cp_async16(smem_addr(st + (TILE + r) * ROW + col), c + (row0 + r) * D + k + col, 16);
  }
}

// LAYOUT: 0 no scores, 1 [Q, N], 2 [N, Q]
template <int SEG, int LAYOUT, bool NATURAL, int STAGES>
__global__ void __launch_bounds__(THREADS, 2)
    stream_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ c,
                  float* __restrict__ scores, float* __restrict__ segmax, int Q, int64_t N, int D) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* stages = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps: 64 x 32 each
  const int64_t tile = blockIdx.x;
  const int64_t row0 = tile * TILE;
  const int nk = D / BK;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(stages + s * STAGE_ELEMS, q, c, Q, D, row0, s * BK, tid);
    cp_async_commit();
  }
  // A operand rows: queries (offset 0) or the corpus tile (offset TILE)
  constexpr int A_OFF = NATURAL ? TILE : 0;
  constexpr int B_OFF = NATURAL ? 0 : TILE;
  const int a_row = wm * 64 + (lane & 15), a_col = (lane >> 4) * 8;
  const int b_row = wn * 32 + (lane & 7) + ((lane >> 4) << 3), b_col = ((lane >> 3) & 1) * 8;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed for all; stage kt - 1 is free
    const int nxt = kt + STAGES - 1;
    if (nxt < nk) load_stage(stages + (nxt % STAGES) * STAGE_ELEMS, q, c, Q, D, row0, nxt * BK, tid);
    cp_async_commit();
    const __nv_bfloat16* st = stages + (kt % STAGES) * STAGE_ELEMS;
    const uint32_t a_base = smem_addr(st + (A_OFF + a_row) * ROW + a_col);
    const uint32_t b_base = smem_addr(st + (B_OFF + b_row) * ROW + b_col);
#pragma unroll
    for (int k16 = 0; k16 < BK / 16; ++k16) {
      uint32_t b[2][4];  // n8 tiles 2j and 2j + 1 of the warp's 32 columns
#pragma unroll
      for (int j = 0; j < 2; ++j) ldsm_x4(b_base + ((j * 16) * ROW + k16 * 16) * 2, b[j]);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        uint32_t a[4];
        ldsm_x4(a_base + ((mi * 16) * ROW + k16 * 16) * 2, a);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma16816(acc[mi][2 * j], a, b[j][0], b[j][1]);
          mma16816(acc[mi][2 * j + 1], a, b[j][2], b[j][3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the stages: reuse them

  // the f32 tile as T[n][q] (n the corpus row in the tile)
  auto* T = reinterpret_cast<float*>(smem_raw);
  float* part = T + TILE * TS;  // [2][TILE] partial maxima
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = wm * 64 + mi * 16 + g + (e >> 1) * 8;
        const int n = wn * 32 + ni * 8 + t4 * 2 + (e & 1);
        if (NATURAL) T[m * TS + n] = acc[mi][ni][e];
        else T[n * TS + m] = acc[mi][ni][e];
      }
  __syncthreads();

  // segment maxima: thread (half, qi) takes rows 64 half .. 64 half + 63
  {
    const int qi = tid & (TILE - 1), half = tid >> 7;
    float m = -CUDART_INF_F;
#pragma unroll 8
    for (int r = half * 64; r < half * 64 + 64; ++r) m = fmaxf(m, T[r * TS + qi]);
    if (SEG == 64) {
      if (qi < Q) segmax[(tile * 2 + half) * Q + qi] = m;
    } else {
      part[half * TILE + qi] = m;
    }
  }
  if (SEG == 128) {
    __syncthreads();
    if (tid < TILE && tid < Q) segmax[tile * Q + tid] = fmaxf(part[tid], part[TILE + tid]);
  }
  if (LAYOUT == 1) {  // [Q, N]: query row qi, the tile's 128 contiguous columns
    for (int idx = tid; idx < Q * TILE; idx += THREADS) {
      const int qi = idx >> 7, n = idx & (TILE - 1);
      scores[static_cast<int64_t>(qi) * N + tile * TILE + n] = T[n * TS + qi];
    }
  } else if (LAYOUT == 2) {  // [N, Q]: the tile's 128 rows of Q contiguous values
    for (int idx = tid; idx < Q * TILE; idx += THREADS) {
      const int n = idx / Q, qi = idx - n * Q;
      scores[(tile * TILE + n) * Q + qi] = T[n * TS + qi];
    }
  }
}

using StreamFn = void (*)(const __nv_bfloat16*, const __nv_bfloat16*, float*, float*, int, int64_t,
                          int);

template <int SEG, int LAYOUT, bool NATURAL>
StreamFn pick_stages(int stages) {
  return stages == 2 ? stream_kernel<SEG, LAYOUT, NATURAL, 2> : stream_kernel<SEG, LAYOUT, NATURAL, 4>;
}

template <int SEG, bool NATURAL>
StreamFn pick_layout(int layout, int stages) {
  return layout == 0   ? pick_stages<SEG, 0, NATURAL>(stages)
         : layout == 1 ? pick_stages<SEG, 1, NATURAL>(stages)
                       : pick_stages<SEG, 2, NATURAL>(stages);
}

cudaError_t launch_stream(StreamFn fn, int stages, const void* q, const void* c, void* scores,
                          void* segmax, int Q, long long N, int D, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int smem = stages * STAGE_BYTES > EPI_BYTES ? stages * STAGE_BYTES : EPI_BYTES;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fn<<<static_cast<unsigned>(N / TILE), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(c),
      static_cast<float*>(scores), static_cast<float*>(segmax), Q, N, D);
  return cudaGetLastError();
}

bool stream_shape_ok(int Q, long long N, int D, int seg, int stages) {
  return Q >= 1 && Q <= TILE && N >= TILE && N % TILE == 0 && N / TILE <= 0x7fffffffLL && D >= BK &&
         D % BK == 0 && (seg == 64 || seg == 128) && (stages == 2 || stages == 4);
}

// ---- K3 -------------------------------------------------------------------

template <int U, bool STATIC>
__global__ void __launch_bounds__(THREADS)
    read_probe_kernel(const uint4* __restrict__ slab, int64_t tiles_per_chunk, int u_dyn,
                      const __nv_bfloat16* __restrict__ c, int64_t chunk_elems, int width,
                      float* __restrict__ heads, unsigned long long* __restrict__ sums) {
  __shared__ long long warp_sum[THREADS / 32];
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x;
  const int u = STATIC ? U : u_dyn;
  const uint4* p = slab + b * THREADS * u + tid;
  long long s = 0;
  if (STATIC) {
    uint4 v[U];
#pragma unroll
    for (int i = 0; i < U; ++i) v[i] = __ldcs(p + i * THREADS);
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const uint32_t w[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s += static_cast<int16_t>(w[j] & 0xffffu) + static_cast<int16_t>(w[j] >> 16);
    }
  } else {
#pragma unroll 1
    for (int i = 0; i < u; ++i) {
      const uint4 v = __ldcs(p + i * THREADS);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s += static_cast<int16_t>(w[j] & 0xffffu) + static_cast<int16_t>(w[j] >> 16);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if ((tid & 31) == 0) warp_sum[tid >> 5] = s;
  __syncthreads();
  const int64_t chunk = b / tiles_per_chunk;
  if (tid == 0) {
    long long t = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) t += warp_sum[w];
    atomicAdd(sums + chunk, static_cast<unsigned long long>(t));  // two's complement wraps alike
  }
  if (b % tiles_per_chunk == 0) {
    for (int j = tid; j < width; j += THREADS)
      heads[chunk * width + j] = __bfloat162float(c[chunk * chunk_elems + j]);
  }
}

using ProbeFn = void (*)(const uint4*, int64_t, int, const __nv_bfloat16*, int64_t, int, float*,
                         unsigned long long*);

ProbeFn pick_probe(int u, bool is_static) {
  if (!is_static) return read_probe_kernel<1, false>;  // u is a runtime count
  return u == 16 ? read_probe_kernel<16, true>
         : u == 8 ? read_probe_kernel<8, true>
         : u == 4 ? read_probe_kernel<4, true>
         : u == 2 ? read_probe_kernel<2, true>
                  : read_probe_kernel<1, true>;
}

}  // namespace

// K2. queries [Q, D] bf16, corpus [N, D] bf16 (contiguous, 16-byte
// aligned); scores [Q, N] (layout 1), [N, Q] (layout 2) or unused
// (layout 0) f32; segmax [N / seg, Q] f32. stages 2 or 4.
extern "C" int stream_segmax(const void* q, const void* c, void* scores, void* segmax, int Q,
                             long long N, int D, int seg, int layout, int natural, int stages,
                             int device, void* stream) {
  if (!stream_shape_ok(Q, N, D, seg, stages) || layout < 0 || layout > 2)
    return (int)cudaErrorInvalidValue;
  StreamFn fn = seg == 128 ? (natural ? pick_layout<128, true>(layout, stages)
                                      : pick_layout<128, false>(layout, stages))
                           : (natural ? pick_layout<64, true>(layout, stages)
                                      : pick_layout<64, false>(layout, stages));
  return (int)launch_stream(fn, stages, q, c, scores, segmax, Q, N, D, device, stream);
}

// K3. corpus [N, D] bf16 (contiguous, 16-byte aligned), chunks of blk
// rows; heads [N / blk, width] f32; sums [N / blk] int64, zeroed by the
// caller. u (1, 2, 4, 8 or 16) 16-byte loads a thread a block; blk D 2
// must be a multiple of 4,096 u bytes.
extern "C" int read_probe(const void* c, void* heads, void* sums, long long N, int D, long long blk,
                          int width, int u, int is_static, int device, void* stream) {
  const long long tile_bytes = static_cast<long long>(THREADS) * 16 * u;
  const long long chunk_bytes = blk * D * 2;
  if (N < 1 || D < 1 || blk < 1 || N % blk || width < 1 || width > D ||
      (u != 1 && u != 2 && u != 4 && u != 8 && u != 16) || chunk_bytes % tile_bytes ||
      reinterpret_cast<uintptr_t>(c) % 16)
    return (int)cudaErrorInvalidValue;
  const long long blocks = N * D * 2 / tile_bytes;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  ProbeFn fn = pick_probe(u, is_static != 0);
  fn<<<static_cast<unsigned>(blocks), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(c), chunk_bytes / tile_bytes, u, static_cast<const __nv_bfloat16*>(c),
      blk * D, width, static_cast<float*>(heads), static_cast<unsigned long long*>(sums));
  return (int)cudaGetLastError();
}

extern "C" const char* stream_probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
