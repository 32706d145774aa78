// Query x corpus scores plus the max of every 128-row segment, in one pass
// over the corpus, for sm_90a; with a validity mask or without one.
//
// Replaces two TPU kernels (rust_local_rag_tpu/ops/pallas_topk.py):
// fused_score_segmax_masked / _make_masked_kernel (:217-319), the entry
// score_segmax_masked, and fused_score_segmax / _score_segmax_kernel
// (:65-185), the entry score_segmax_unmasked. It computes the same
// functions, not the same blocking:
//   scores[q, n] = dot(queries[q, :], corpus[n, :]), and -inf where the
//                  mask is given and mask[n] is 0
//   segmax[q, s] = max(scores[q, 128 s : 128 s + 128])
// segmax is [Q, N/128] here (the TPU stored it transposed only for its
// store alignment); the selection step reads this layout. The unmasked
// entry never reads a mask. Queries are f32, or bf16 on a bf16 slab. Every
// product is exact before it is summed in f32: an f32 slab stays at full
// f32 (TF32 tensor cores would keep ~10 mantissa bits), a bf16 slab is
// widened exactly (its 16 bits are the top of an f32), and on the tensor
// cores f32 queries are split into three bf16 terms whose products with a
// bf16 value are exact in f32.
//
// Bound on the H100 (3.35 TB/s; 67 TFLOP/s f32 outside the tensor cores,
// 989 bf16 on them) at N = 65,536, D = 768: bytes N*D*s + Q*N*4 (+ N mask
// bytes) + the queries and maxima, i.e. 205 MB at Q 16 on an f32 slab (61
// us) and 105 MB on a bf16 slab (31 us); arithmetic 2*Q*N*D = 1.6 GFLOP
// at Q 16 (24 us in f32 FMA). Memory bounds every Q <= 16 on an f32 slab;
// on a bf16 slab at Q 16 the f32 FMAs come close to the bytes. At Q 128 on
// bench.py's bf16 shard (N 1,245,184) the bytes take 0.763 ms and the
// product 0.247 ms a bf16 term on the tensor cores (3.7 ms in f32 FMA).
//
// Three bodies, chosen by shape and type in launch():
//
// * f32 queries, Q <= 16 (the serving path's query counts: the
//   micro-batcher caps a batch at 16 by default and pads it to a power of
//   two), either slab: a persistent stream.
//   - One block of 8 warps per SM (SM count read once); block b owns the
//     segments b, b + grid, ..., so no segment count limits the grid.
//   - Each block streams its segments' [128 rows x 256 bytes] tiles (64
//     f32 or 128 bf16 values of each row; 256 contiguous bytes a row keep
//     the device-memory reads efficient, 64 or 128 did not) through a
//     ring of 4 tiles in dynamic shared memory, filled by 16-byte
//     cp.async.cg copies (zero-filled past D). Three tiles (96 KB) are in
//     flight while one is computed, across segment boundaries, so the
//     next segment's loads overlap this one's epilogue. One barrier a tile.
//   - The Q x D queries are loaded once per block into shared memory,
//     transposed to [D][QT] and zero-padded, where QT is Q rounded up to
//     1, 2, 4, 8 or 16 (a template argument): Q 1 does 1/16 of the FMAs
//     of a 16-query tile.
//   - The 4 warp pairs split each tile's depth (64 bytes of each row a
//     pair); lane l of a pair's warp h owns rows 64h + 2l and 64h + 2l + 1
//     and all QT queries, 2 x QT f32 accumulators. Each depth step reads
//     the two rows' values (one 16-byte load a row per 4 f32 or 8 bf16
//     values, XOR-swizzled so the 8 lanes of a load phase hit 8 distinct
//     bank groups) and the QT query values (QT/4 broadcast 16-byte
//     loads), then does 2 x QT FMAs: at QT 16, 32 FMAs per 4.25 loads (the
//     first version did 16 FMAs per 5 loads of one value each). A bf16
//     tile stays bf16 in shared memory and is widened in registers.
//   - At a segment's end the pairs' partial sums meet in shared memory and
//     are added in pair order; warp w finishes queries w and w + 8 for all
//     128 rows: -inf at freed slots (mask bytes read at the segment's
//     start), the max as a register max over 4 rows and a 5-step shuffle,
//     the scores in 16-byte stores (lane l writes rows 4l..4l+3).
//   What bounds it: at Q <= 8, and on f32 slabs at every Q <= 16, the
//   device-memory read rate, which the stream holds near that of a plain
//   read of the slab. On bf16 slabs at Q 16, feeding the FMAs from shared
//   memory: a broadcast 16-byte load still moves 512 bytes into the
//   warp's registers, so each FMA costs 4/2 + 2/16 bytes of shared-memory
//   traffic against the ~1 byte an FMA that 128 bytes a clock allow; the
//   FMA pipe runs at about half its rate there. More rows a thread would
//   cut that, at the price of the partial-sum buffer or the ring.
//
// * Every other case on a bf16 slab (Q > 16 with f32 queries, bf16
//   queries at any Q, or queries too large for the stream's shared
//   memory): a persistent stream on the tensor cores (wgmma).
//   - The product is wgmma.m64n128k16 bf16 x bf16 -> f32: A is 64 queries
//     (one term), B the 128 rows of a segment, both K-major in shared
//     memory in the 128-byte swizzle, 64 f32 accumulators a thread. bf16
//     queries are one term; f32 queries are split by split_terms (launched
//     first on the same stream, into the caller's scratch) into h, m, l,
//     whose three products go into the same accumulators: three wgmmas a
//     k-step, the function of the f32 body up to summation order.
//   - A block is three warpgroups: a producer and two consumers. A unit
//     is 128 queries x one segment, consumer w taking queries
//     64w..64w+63, or at Q <= 64 64 queries x two segments, consumer w
//     taking segment w. One block per SM owns the segment groups b,
//     b + grid, ... and runs all query tiles of a group in turn, so the
//     slab is read once from device memory at any Q (the group's rows come
//     again from L2 for the later tiles), and no segment count limits the
//     grid.
//   - Loads: a ring of as many stages as fit, at most 6 (one term: 6 of
//     32 KB or 5 of 40 KB; three terms: 3 of 64 KB or 4 of 56 KB), a stage
//     being a 64-deep slice of the unit's corpus rows and of each term's
//     query rows. One producer thread fills a stage with TMA copies (one
//     for the corpus rows, one a term; tensor maps in the 128-byte
//     swizzle, whose bounds give the zeros past D, N and Q) once both
//     consumers have released it, and it runs ahead across unit
//     boundaries, so the next unit's loads overlap this one's epilogue.
//     Each stage has a full and an empty mbarrier in place of a block
//     barrier; a wait of ~2 s traps, so a fault fails the launch instead
//     of hanging the card.
//   - Epilogue from the accumulators: -inf at freed slots (the segment's
//     mask bytes read at its first stage, turned into per-row bits by four
//     warp ballots), each query's max over the segment by two shuffles,
//     the scores as 8-byte stores (8 lanes write a query's 32 contiguous
//     bytes, whole sectors). Rows past Q are computed as zeros and not
//     stored.
//   What bounds it (H100, bench.py's shard): at Q 128 and one term the
//   traffic with device memory, 1.9 GB of slab read and 0.64 GB of scores
//   written at ~2.8 TB/s, 83% of the data sheet's rate; with three terms
//   the tensor cores, at about 60% of their rate. The first version of
//   this body filled the ring by cp.async from every thread, with a block
//   barrier a stage; the producer warpgroup measured faster at every
//   Q >= 128, most with three terms. Variants measured no faster: one
//   wgmma group kept in flight across stages (slower at three terms), two
//   segments a consumer at one term (slower at Q 512, where a unit's rows
//   are re-read from L2 for each query tile), and, on the first version,
//   units of 256 rows, stages of two 64-deep slices, the scores staged in
//   shared memory and written by bulk copies, and two blocks an SM.
//
// * f32 queries on an f32 slab past the stream (Q > 16, or queries too
//   large for its shared memory): a persistent register-tiled stream in f32
//   FMA on the CUDA cores (no TF32, no bf16 split: an f32 slab stays f32).
//   - A unit is two segments x 32 or 64 queries (Q <= 32, Q <= 64) or one
//     segment x 128 queries, chosen by Q (template arguments RG, QPT). One
//     block of 8 warps an SM owns the segment groups b, b + grid, ... and
//     runs every query tile of a group in turn, so the rows come from device
//     memory once (again from L2 for the later tiles) and no segment count
//     limits the grid.
//   - Loads: a ring in dynamic shared memory of 3 stages (2 for the 80 KB
//     stage of two segments x 64 queries), a stage being the unit's rows
//     and queries 64 deep (256 bytes a row), filled by 16-byte cp.async.cg
//     copies from every thread (zero-filled past D, Q and N), one barrier a
//     stage. The next stages are in flight while one is computed, across
//     unit boundaries, so the next unit's loads overlap this one's epilogue.
//   - Compute: lane l of warp w holds 8 rows, 4 tr .. 4 tr + 3 and 4 RG +
//     those (tr = l % RG; RG 32 with two segments, 16 with one), and the
//     QPT queries of its query group: 8 x QPT f32 accumulators, each summed
//     in depth order (the order of the library's f32 GEMM: on the H100 the
//     two agree bit for bit). Per 4-deep chunk a thread reads 8 row and
//     QPT query values as 16-byte loads (K-major, chunks XOR-permuted so
//     the row loads are conflict-free and the query loads broadcasts) and
//     does 32 QPT FMAs: 256 per 16 loads at QPT 8, against 16 per 5 in the
//     first version's body, which this replaces (one block a segment and 16
//     queries, a grid limited to 65,535 segments, no load overlapped).
//   - Epilogue from the accumulators: -inf at freed slots (4-byte mask
//     loads, read at the unit's first stage), the scores as 16-byte stores
//     (the RG lanes of a query group write 4 RG contiguous scores of a
//     query), each query's max over its rows of a segment and then by
//     shuffles across those lanes. Queries past Q are computed as zeros and
//     not stored; a group's second segment past N is neither read nor
//     stored.
//   What bounds it: the f32 FMAs (2 Q N D at 67 TFLOP/s) from Q ~ 32 on
//   (N 65,536, D 768: 0.096 ms at Q 64, 0.192 at Q 128, against 0.065 and
//   0.070 ms of bytes). On the H100 (700 W) it reaches 57-61% of that
//   rate at Q 64-128, within a few percent of the library's f32 GEMM
//   (PERF.md). Variants measured slower on the card: 32-deep stages (4 of
//   them), one segment x 4 rows a thread at Q <= 64, 4 rows x 16 queries
//   at Q 128, and the FMAs as four outer products a chunk (fewer
//   registers, the loads less far ahead).
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

constexpr int SEG = 128;  // rows of a segment

// ---------------------------------------------------------------------------
// Q <= 16: the persistent stream.

constexpr int S_WARPS = 8;                       // warps a block, one block an SM
constexpr int S_THREADS = S_WARPS * 32;
constexpr int S_STAGES = 4;                      // tiles in the ring
constexpr int S_ROW_BYTES = 256;                 // bytes of each row in one tile
constexpr int S_GROUPS = S_WARPS / 2;            // depth groups: 2 warps cover a segment
constexpr int S_CPR = S_ROW_BYTES / 16;          // 16-byte chunks of a tile row
constexpr int S_CPG = S_CPR / S_GROUPS;          // chunks of a tile row a group takes
constexpr int S_TILE = SEG * S_ROW_BYTES;        // bytes of one tile
constexpr int S_RING = S_STAGES * S_TILE;
constexpr int S_MAX_Q = 16;
static_assert(S_CPR % S_GROUPS == 0 && SEG * S_CPR % S_THREADS == 0, "even splits of a tile");

// byte offset in a tile of 16-byte chunk c of row `row`. The XOR permutes
// the chunks within each 128-byte bank line of a row: the 8 lanes of a
// load phase read rows 2i (+1) for i = 0..7, whose (row >> 1) & 7 = i
// differ, so they hit 8 distinct 16-byte bank groups.
__device__ __forceinline__ int tile_offset(int row, int c) {
  return (row * S_CPR + (c ^ ((row >> 1) & 7))) * 16;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// value e of a 16-byte chunk, as f32 (a bf16 is exactly its f32's top half)
template <typename T>
__device__ __forceinline__ float chunk_value(const uint4& v, int e);

template <>
__device__ __forceinline__ float chunk_value<float>(const uint4& v, int e) {
  return __uint_as_float(word(v, e));
}

template <>
__device__ __forceinline__ float chunk_value<__nv_bfloat16>(const uint4& v, int e) {
  const uint32_t w = word(v, e >> 1);
  return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}

// the QT query values of one depth step, from [D][QT] shared memory
template <int QT>
__device__ __forceinline__ void load_queries(const float* p, float (&v)[QT]) {
  if constexpr (QT >= 4) {
#pragma unroll
    for (int j = 0; j < QT / 4; ++j) {
      const float4 t = reinterpret_cast<const float4*>(p)[j];
      v[4 * j] = t.x;
      v[4 * j + 1] = t.y;
      v[4 * j + 2] = t.z;
      v[4 * j + 3] = t.w;
    }
  } else if constexpr (QT == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}

template <typename T, bool MASKED, int QT>
__global__ void __launch_bounds__(S_THREADS, 1)
score_segmax_stream(const float* __restrict__ queries, const T* __restrict__ corpus,
                    const uint8_t* __restrict__ mask, float* __restrict__ scores,
                    float* __restrict__ segmax, int Q, int N, int D) {
  constexpr int EPC = 16 / sizeof(T);  // values a chunk
  constexpr int BK = S_CPR * EPC;      // depth of a tile
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nseg = N / SEG;
  const int ktiles = (D + BK - 1) / BK;
  const int kpad = ktiles * BK;
  const uint32_t ring_s = smem_addr(smem);
  float* qs = reinterpret_cast<float*>(smem + S_RING);        // [kpad][QT]
  float* part = qs + kpad * QT;                                // [S_GROUPS][QT][SEG]

  // this block's segments: blockIdx.x, + gridDim.x, ...; tiles t = i * ktiles + kt
  const int total = blockIdx.x < nseg ? ((nseg - 1 - blockIdx.x) / gridDim.x + 1) * ktiles : 0;

  // producer: thread copies chunk pc of rows prow, prow + S_THREADS / S_CPR, ...
  const int pc = tid % S_CPR;
  const int prow = tid / S_CPR;
  int p_seg = blockIdx.x, p_kt = 0, issued = 0;
  auto issue = [&]() {
    if (issued < total) {
      const int k0 = p_kt * BK + pc * EPC;
      const int bytes = k0 < D ? 16 : 0;  // D % EPC == 0: a chunk is all in or out
      const T* src = corpus + ((int64_t)p_seg * SEG + prow) * D + (bytes ? k0 : 0);
      const uint32_t dst = ring_s + (issued % S_STAGES) * S_TILE;
#pragma unroll
      for (int j = 0; j < SEG * S_CPR / S_THREADS; ++j) {
        const int row = prow + j * (S_THREADS / S_CPR);
        cp_async16(dst + tile_offset(row, pc), src + (int64_t)j * (S_THREADS / S_CPR) * D, bytes);
      }
      if (++p_kt == ktiles) {
        p_kt = 0;
        p_seg += gridDim.x;
      }
    }
    ++issued;
    cp_async_commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int s = 0; s < S_STAGES - 1; ++s) issue();

  // the queries, once a block, while the first tiles are in flight; 4
  // loads a thread at a time, so their latencies overlap
  const int nq4 = QT * (kpad / 4);
  for (int i0 = tid; i0 < nq4; i0 += 4 * S_THREADS) {
    float4 v[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = i0 + b * S_THREADS;
      const int q = i % QT;
      const int k = (i / QT) * 4;
      v[b] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < nq4 && q < Q && k < D) v[b] = *reinterpret_cast<const float4*>(queries + (int64_t)q * D + k);
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = i0 + b * S_THREADS;
      const int q = i % QT;
      const int k = (i / QT) * 4;
      if (i < nq4) {
        qs[(k + 0) * QT + q] = v[b].x;
        qs[(k + 1) * QT + q] = v[b].y;
        qs[(k + 2) * QT + q] = v[b].z;
        qs[(k + 3) * QT + q] = v[b].w;
      }
    }
  }

  // compute: warp pair g takes chunks [g * S_CPG, (g + 1) * S_CPG) of every
  // tile row; lane l of warp 2g + h owns rows r0 = 64 h + 2 l and r0 + 1
  const int grp = warp >> 1;
  const int r0 = 64 * (warp & 1) + 2 * lane;
  float acc[2][QT];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int q = 0; q < QT; ++q) acc[r][q] = 0.f;

  int seg = blockIdx.x, kt = 0;
  uint32_t mword = 0;  // mask bytes of rows 4 lane .. 4 lane + 3 of the segment
  for (int t = 0; t < total; ++t) {
    if (MASKED && kt == 0)  // read early: its latency hides behind the segment
      mword = *reinterpret_cast<const uint32_t*>(mask + (int64_t)seg * SEG + 4 * lane);
    cp_async_wait<S_STAGES - 2>();  // this thread's copies of tile t are done
    __syncthreads();                // everyone's are, and tile t - 1 is free
    issue();                        // tile t + S_STAGES - 1 into tile t - 1's slot
    const unsigned char* tile = smem + (t % S_STAGES) * S_TILE;
    const float* qk = qs + (kt * BK + grp * S_CPG * EPC) * QT;
#pragma unroll
    for (int cc = 0; cc < S_CPG; ++cc) {
      const int c = grp * S_CPG + cc;
      uint4 raw[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        raw[r] = *reinterpret_cast<const uint4*>(tile + tile_offset(r0 + r, c));
#pragma unroll
      for (int e = 0; e < EPC; ++e) {
        float qv[QT];
        load_queries<QT>(qk + (cc * EPC + e) * QT, qv);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float x = chunk_value<T>(raw[r], e);
#pragma unroll
          for (int q = 0; q < QT; ++q) acc[r][q] = fmaf(qv[q], x, acc[r][q]);
        }
      }
    }
    if (++kt < ktiles) continue;

    // the segment is complete: the groups' partial sums through shared memory
#pragma unroll
    for (int q = 0; q < QT; ++q) {
      *reinterpret_cast<float2*>(part + (grp * QT + q) * SEG + r0) = make_float2(acc[0][q], acc[1][q]);
      acc[0][q] = 0.f;
      acc[1][q] = 0.f;
    }
    __syncthreads();
    // warp w finishes queries w, w + S_WARPS, ...; lane l rows 4l..4l+3:
    // the groups' sum, -inf at freed slots, 16-byte stores, the max
    const int64_t row0 = (int64_t)seg * SEG + 4 * lane;
    bool live[4] = {true, true, true, true};
    if constexpr (MASKED) {
#pragma unroll
      for (int r = 0; r < 4; ++r) live[r] = ((mword >> (8 * r)) & 0xffu) != 0;
    }
#pragma unroll
    for (int q0 = 0; q0 < QT; q0 += S_WARPS) {
      const int q = q0 + warp;
      if (q < QT) {  // uniform across the warp
        float4 v = *reinterpret_cast<const float4*>(part + q * SEG + 4 * lane);
#pragma unroll
        for (int g = 1; g < S_GROUPS; ++g) {
          const float4 p = *reinterpret_cast<const float4*>(part + (g * QT + q) * SEG + 4 * lane);
          v.x += p.x;
          v.y += p.y;
          v.z += p.z;
          v.w += p.w;
        }
        if (!live[0]) v.x = -CUDART_INF_F;
        if (!live[1]) v.y = -CUDART_INF_F;
        if (!live[2]) v.z = -CUDART_INF_F;
        if (!live[3]) v.w = -CUDART_INF_F;
        float m = fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w));
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        if (q < Q) {
          *reinterpret_cast<float4*>(scores + (int64_t)q * N + row0) = v;
          if (lane == 0) segmax[(int64_t)q * nseg + seg] = m;
        }
      }
    }
    // the next partial sums are written after the next tile's barrier
    kt = 0;
    seg += gridDim.x;
  }
}

// queries rounded up to the stream's query tile: 1, 2, 4, 8 or 16
int query_tile(int Q) {
  int qt = 1;
  while (qt < Q) qt *= 2;
  return qt;
}

int stream_smem(int qt, int D, int corpus_bytes) {
  const int bk = S_CPR * (16 / corpus_bytes);
  return S_RING + (D + bk - 1) / bk * bk * qt * 4 + S_GROUPS * qt * SEG * 4;
}

// per device: SM count and the shared memory a block may opt into, read
// once (sms is stored last and is 0 until both are known)
struct DeviceLimits {
  std::atomic<int> sms{0}, smem_optin{0};
};
DeviceLimits device_limits[64];

template <typename T, bool MASKED, int QT>
cudaError_t launch_stream(const void* queries, const void* corpus, const void* mask,
                          void* scores, void* segmax, int Q, int N, int D, int smem,
                          int sms, cudaStream_t s) {
  auto fn = score_segmax_stream<T, MASKED, QT>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nseg = N / SEG;
  const int grid = nseg < 1 ? 1 : nseg < sms ? nseg : sms;
  fn<<<grid, S_THREADS, smem, s>>>(
      static_cast<const float*>(queries), static_cast<const T*>(corpus),
      static_cast<const uint8_t*>(mask), static_cast<float*>(scores),
      static_cast<float*>(segmax), Q, N, D);
  return cudaGetLastError();
}

template <typename T, bool MASKED>
cudaError_t dispatch_stream(const void* queries, const void* corpus, const void* mask,
                            void* scores, void* segmax, int Q, int N, int D, int smem,
                            int sms, cudaStream_t s) {
  switch (query_tile(Q)) {
    case 1:
      return launch_stream<T, MASKED, 1>(queries, corpus, mask, scores, segmax, Q, N, D, smem, sms, s);
    case 2:
      return launch_stream<T, MASKED, 2>(queries, corpus, mask, scores, segmax, Q, N, D, smem, sms, s);
    case 4:
      return launch_stream<T, MASKED, 4>(queries, corpus, mask, scores, segmax, Q, N, D, smem, sms, s);
    case 8:
      return launch_stream<T, MASKED, 8>(queries, corpus, mask, scores, segmax, Q, N, D, smem, sms, s);
    default:
      return launch_stream<T, MASKED, 16>(queries, corpus, mask, scores, segmax, Q, N, D, smem, sms, s);
  }
}

// ---------------------------------------------------------------------------
// Q > 16 on a bf16 slab, and bf16 queries at any Q: the tensor-core stream.

constexpr int W_THREADS = 3 * 128;  // a producer warpgroup, two consumer warpgroups
constexpr int W_BK = 64;            // depth a stage: one 128-byte row of bf16
constexpr int W_ROW = 128;          // bytes of a staged row
constexpr int W_QROWS = 64;         // queries a consumer: the wgmma's M

// A unit is 128 QW queries x 256 / QW corpus rows: at QW = 2 one segment,
// consumer w taking queries 64 w .. 64 w + 63 of it; at QW = 1 (Q <= 64)
// two segments, consumer w taking segment w. A stage of the ring holds the
// unit's corpus rows, then each term's query rows, 64 deep.
__host__ __device__ constexpr int w_rows(int qw) { return 2 * SEG / qw; }

__host__ __device__ constexpr int w_stage(int terms, int qw) {
  return (w_rows(qw) + terms * W_QROWS * qw) * W_ROW;
}

// the stages that fit, at most 6, beside the ring's 1,024-byte alignment
// and two mbarriers a stage: 6 of 32 KB or 5 of 40 KB for one term, 3 of
// 64 KB or 4 of 56 KB for three
constexpr int SMEM_MAX = 232448;  // all the shared memory an H100 block may have
constexpr int W_RING_MAX = SMEM_MAX - 1024 - 6 * 16;

__host__ __device__ constexpr int w_stages(int terms, int qw) {
  return W_RING_MAX / w_stage(terms, qw) < 6 ? W_RING_MAX / w_stage(terms, qw) : 6;
}

__host__ __device__ constexpr int w_smem(int terms, int qw) {
  return w_stages(terms, qw) * (w_stage(terms, qw) + 16) + 1024;
}

// f32 queries as three bf16 terms: h = bf16(x), m = bf16(x - h),
// l = bf16(x - h - m); each residual is exact in f32, and h + m + l = x for
// every normal f32 x below 2^128 (1 - 2^-9), where bf16 rounding stays
// finite. out holds term t of value i at t * count + i.
__global__ void split_terms(const float* __restrict__ q, __nv_bfloat16* __restrict__ out, int count) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < count; i += gridDim.x * blockDim.x) {
    const float x = q[i];
    const __nv_bfloat16 h = __float2bfloat16_rn(x);
    const float r = x - __bfloat162float(h);
    const __nv_bfloat16 m = __float2bfloat16_rn(r);
    out[i] = h;
    out[count + i] = m;
    out[2 * count + i] = __float2bfloat16_rn(r - __bfloat162float(m));
  }
}

// the epilogue of one warpgroup's 64 queries x one segment: -inf at freed
// slots, the scores in 8-byte stores (8 lanes write a query's 32
// contiguous bytes, whole sectors), each query's max over the 128 rows by
// two shuffles across the 4 lanes that hold its row
template <bool MASKED>
__device__ __forceinline__ void wgmma_epilogue(const float (&acc)[64], uint32_t mword, int q0, int seg,
                                               int Q, int N, int nseg, float* __restrict__ scores,
                                               float* __restrict__ segmax, int t4) {
  const int64_t row0 = (int64_t)seg * SEG;
  // bit 2 j of live_e: row 8 j + 2 t4 + e of the segment is live. Row r is
  // byte r % 4 of lane r / 4's mask word: ballot b_p has bit L for row
  // 4 L + p, and r = 4 (2 j + (t4 >> 1)) + 2 (t4 & 1) + e.
  uint32_t live0 = ~0u, live1 = ~0u;
  if constexpr (MASKED) {
    const uint32_t b0 = __ballot_sync(~0u, (mword & 0xffu) != 0);
    const uint32_t b1 = __ballot_sync(~0u, (mword & 0xff00u) != 0);
    const uint32_t b2 = __ballot_sync(~0u, (mword & 0xff0000u) != 0);
    const uint32_t b3 = __ballot_sync(~0u, (mword & 0xff000000u) != 0);
    live0 = ((t4 & 1) ? b2 : b0) >> (t4 >> 1);
    live1 = ((t4 & 1) ? b3 : b1) >> (t4 >> 1);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = q0 + 8 * h;
    float* out = scores + (int64_t)q * N + row0 + 2 * t4;
    float m = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float2 v = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      if (!((live0 >> (2 * j)) & 1u)) v.x = -CUDART_INF_F;
      if (!((live1 >> (2 * j)) & 1u)) v.y = -CUDART_INF_F;
      m = fmaxf(m, fmaxf(v.x, v.y));
      if (q < Q) *reinterpret_cast<float2*>(out + 8 * j) = v;
    }
    m = fmaxf(m, __shfl_xor_sync(~0u, m, 1));
    m = fmaxf(m, __shfl_xor_sync(~0u, m, 2));
    if (t4 == 0 && q < Q) segmax[(int64_t)q * nseg + seg] = m;
  }
}

// T bf16 query terms ([T][Q][D], the tensor map tmap) x a bf16 slab (cmap),
// in the units above: warpgroup 0 fills the ring (thread 0 issues each
// stage's TMA copies once the consumers have freed it), warpgroups 1 and 2
// compute; full / empty mbarriers a stage in place of a block barrier
template <int T, int QW, bool MASKED>
__global__ void __launch_bounds__(W_THREADS, 1)
score_segmax_wgmma(const __grid_constant__ CUtensorMap cmap, const __grid_constant__ CUtensorMap tmap,
                   const uint8_t* __restrict__ mask, float* __restrict__ scores,
                   float* __restrict__ segmax, int Q, int N, int D) {
  constexpr int RC = w_rows(QW);     // corpus rows a unit
  constexpr int SU = 2 / QW;         // segments a unit
  constexpr int RQ = W_QROWS * QW;   // queries a unit
  constexpr int STAGES = w_stages(T, QW);
  constexpr int STAGE = w_stage(T, QW);
  extern __shared__ __align__(1024) unsigned char wsmem[];
  const uint32_t ring = (smem_addr(wsmem) + 1023) & ~1023u;  // the swizzle's 1,024-byte atoms
  const uint32_t full = ring + STAGES * STAGE;               // a stage's copies have landed
  const uint32_t empty = full + 8 * STAGES;                  // both consumers are done with it

  const int tid = threadIdx.x;
  const int nseg = N / SEG;
  const int groups = (nseg + SU - 1) / SU;
  const int nqt = (Q + RQ - 1) / RQ;
  const int ktiles = (D + W_BK - 1) / W_BK;
  // this block's units: segment groups blockIdx.x, + gridDim.x, ..., each
  // with its query tiles in turn (the group's rows come again from L2 for
  // the later tiles); tiles t = (unit * nqt + query tile) * ktiles + kt
  const int mine = blockIdx.x < groups ? (groups - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int total = mine * nqt * ktiles;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid < 128) {  // the producer: zeros past D, N and Q come from the maps' bounds
    if (tid == 0) {
      int g = blockIdx.x, qt = 0, kt = 0;
      for (int t = 0; t < total; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(empty + 8 * s, ((t / STAGES) - 1) & 1);
        const uint32_t dst = ring + s * STAGE, bar = full + 8 * s;
        mbar_expect_tx(bar, STAGE);
        tma_load_2d(dst, &cmap, kt * W_BK, g * RC, bar);
#pragma unroll
        for (int term = 0; term < T; ++term)
          tma_load_3d(dst + (RC + term * RQ) * W_ROW, &tmap, kt * W_BK, qt * RQ, term, bar);
        if (++kt == ktiles) {
          kt = 0;
          if (++qt == nqt) {
            qt = 0;
            g += gridDim.x;
          }
        }
      }
    }
    return;
  }

  // consumer: warpgroup wg's A (its 64 queries of term 0) and B (its 128
  // corpus rows) in a stage, 64 f32 accumulators
  const int wg = (tid >> 7) - 1;
  const uint32_t a_off = (RC + (wg % QW) * W_QROWS) * W_ROW;
  const int sub = wg / QW;  // its segment of the unit
  const uint32_t b_off = sub * SEG * W_ROW;
  const int lane = tid & 31, t4 = lane & 3;
  const int qrow = (wg % QW) * W_QROWS + 16 * ((tid >> 5) & 3) + (lane >> 2);  // its rows qrow, qrow + 8
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  int g = blockIdx.x, qt = 0, kt = 0;
  uint32_t mword = 0;  // mask bytes of rows 4 lane .. 4 lane + 3 of the segment
  for (int t = 0; t < total; ++t) {
    const int s = t % STAGES;
    const int seg = SU * g + sub;  // this warpgroup's segment (uniform across it)
    if (MASKED && kt == 0 && seg < nseg)  // read early: its latency hides behind the unit
      mword = *reinterpret_cast<const uint32_t*>(mask + (int64_t)seg * SEG + 4 * lane);
    mbar_wait(full + 8 * s, (t / STAGES) & 1);
    const uint32_t st = ring + s * STAGE;
#pragma unroll
    for (int i = 0; i < 64; ++i) fence_operand(acc[i]);  // the zeroing before the fence
    wgmma_fence();
#pragma unroll
    for (int k16 = 0; k16 < W_BK / 16; ++k16) {
      const uint64_t b = sw128_desc(st + b_off + 32 * k16);
#pragma unroll
      for (int term = 0; term < T; ++term)
        wgmma_m64n128k16(acc, sw128_desc(st + a_off + term * RQ * W_ROW + 32 * k16), b);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) fence_operand(acc[i]);
    if ((tid & 127) == 0) mbar_arrive(empty + 8 * s);  // the warpgroup's products of stage t are done
    if (++kt < ktiles) continue;

    kt = 0;
    if (seg < nseg)
      wgmma_epilogue<MASKED>(acc, mword, qt * RQ + qrow, seg, Q, N, nseg, scores, segmax, t4);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    if (++qt == nqt) {
      qt = 0;
      g += gridDim.x;
    }
  }
}

template <int T, int QW, bool MASKED>
cudaError_t launch_wgmma_body(const void* terms, const void* corpus, const void* mask, void* scores,
                              void* segmax, int Q, int N, int D, int sms, cudaStream_t s) {
  constexpr int smem = w_smem(T, QW);
  CUtensorMap cmap, tmap;
  if (!bf16_map(&cmap, corpus, D, N, 0, w_rows(QW)) || !bf16_map(&tmap, terms, D, Q, T, W_QROWS * QW))
    return cudaErrorInvalidValue;
  auto fn = score_segmax_wgmma<T, QW, MASKED>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int groups = (N / SEG + 2 / QW - 1) / (2 / QW);
  const int grid = groups < 1 ? 1 : groups < sms ? groups : sms;
  fn<<<grid, W_THREADS, smem, s>>>(cmap, tmap, static_cast<const uint8_t*>(mask), static_cast<float*>(scores),
                                 static_cast<float*>(segmax), Q, N, D);
  return cudaGetLastError();
}

// bf16 queries are the one term; f32 queries are split into scratch
// ([3][Q][D] bf16, from the caller) by split_terms on the same stream
template <bool MASKED>
cudaError_t launch_wgmma(const void* queries, int queries_bf16, void* scratch, const void* corpus,
                         const void* mask, void* scores, void* segmax, int Q, int N, int D, int sms,
                         cudaStream_t s) {
  if (queries_bf16) {
    if (Q <= W_QROWS)
      return launch_wgmma_body<1, 1, MASKED>(queries, corpus, mask, scores, segmax, Q, N, D, sms, s);
    return launch_wgmma_body<1, 2, MASKED>(queries, corpus, mask, scores, segmax, Q, N, D, sms, s);
  }
  if (scratch == nullptr) return cudaErrorInvalidValue;
  const int count = Q * D;
  const int blocks = (count + 255) / 256 < 1024 ? (count + 255) / 256 : 1024;
  split_terms<<<blocks, 256, 0, s>>>(static_cast<const float*>(queries),
                                      static_cast<__nv_bfloat16*>(scratch), count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (Q <= W_QROWS)
    return launch_wgmma_body<3, 1, MASKED>(scratch, corpus, mask, scores, segmax, Q, N, D, sms, s);
  return launch_wgmma_body<3, 2, MASKED>(scratch, corpus, mask, scores, segmax, Q, N, D, sms, s);
}

// ---------------------------------------------------------------------------
// f32 queries on an f32 slab past the stream: the register-tiled body.

constexpr int T_THREADS = 256;      // 8 warps, one block an SM
constexpr int T_BK = 64;            // depth a stage: 256 bytes of each staged row
constexpr int T_ROW = T_BK * 4;     // bytes of a staged row
constexpr int T_CPR = T_ROW / 16;   // 16-byte chunks of a staged row

// Lane l of warp w is row group tr = l % RG (RG 16 or 32) and query group
// tq = w (32 / RG) + l / RG; it holds 8 rows, 4 tr .. 4 tr + 3 and 4 RG +
// those, and QPT queries. A unit is 8 RG rows (one segment at RG 16, two at
// RG 32) x a tile of (T_THREADS / RG) QPT queries; a stage holds its rows,
// then its queries, T_BK deep, and the ring as many stages as fit, at most 3.
__host__ __device__ constexpr int t_rows(int rg) { return 8 * rg; }
__host__ __device__ constexpr int t_queries(int rg, int qpt) { return T_THREADS / rg * qpt; }
__host__ __device__ constexpr int t_stage(int rg, int qpt) { return (t_rows(rg) + t_queries(rg, qpt)) * T_ROW; }
__host__ __device__ constexpr int t_stages(int rg, int qpt) {
  return SMEM_MAX / t_stage(rg, qpt) < 3 ? SMEM_MAX / t_stage(rg, qpt) : 3;
}
__host__ __device__ constexpr int t_smem(int rg, int qpt) { return t_stages(rg, qpt) * t_stage(rg, qpt); }

// byte offset in a stage of chunk c of unit row `row`. The XOR permutes
// each 128-byte half of a row by bits 2-4 of the row: the 8 lanes of a load
// phase read rows 4 i + k (+ 4 RG) for 8 consecutive i, whose (row >> 2) & 7
// differ, so they hit 8 distinct 16-byte bank groups.
__device__ __forceinline__ int t_row_offset(int row, int c) {
  return row * T_ROW + ((c ^ ((row >> 2) & 7)) << 4);
}

// byte offset of chunk c of query j of group g of the tile (after the
// unit's UR rows): permuted by the group, so where a warp reads two groups
// (the same chunk of two rows, broadcast to 16 lanes each) they hit two
// bank groups
template <int UR, int QPT>
__device__ __forceinline__ int t_query_offset(int g, int j, int c) {
  return (UR + QPT * g + j) * T_ROW + ((c ^ (g & 7)) << 4);
}

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// f32 queries x an f32 slab in f32 FMA: block b owns the units' segment
// groups b, b + grid, ... and runs every query tile of a group in turn (its
// rows come from device memory once, again from L2 for the later tiles).
// All threads fill the ring by cp.async, one barrier a stage. 8 x QPT f32
// accumulators a thread, each summed in depth order.
template <bool MASKED, int RG, int QPT>
__global__ void __launch_bounds__(T_THREADS, 1)
score_segmax_tile(const float* __restrict__ queries, const float* __restrict__ corpus,
                  const uint8_t* __restrict__ mask, float* __restrict__ scores,
                  float* __restrict__ segmax, int Q, int N, int D) {
  constexpr int UR = t_rows(RG);              // rows of a unit
  constexpr int SU = UR / SEG;                // segments of a unit
  constexpr int QT = t_queries(RG, QPT);
  constexpr int STAGE = t_stage(RG, QPT);
  constexpr int STAGES = t_stages(RG, QPT);
  constexpr int RPJ = T_THREADS / T_CPR;      // staged rows a copy step covers: 16
  constexpr int STEPS = (UR + QT) / RPJ;      // copy steps a stage; the first UR / RPJ take corpus rows
  static_assert(RG == 16 || RG == 32, "rows 4 tr + k + 4 RG h, a thread's permutation tr & 7");
  static_assert(UR % SEG == 0 && QT % RPJ == 0 && STAGES >= 2, "whole segments, copy steps and a ring");
  extern __shared__ __align__(16) unsigned char tsmem[];
  const uint32_t ring = smem_addr(tsmem);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int nseg = N / SEG;
  const int groups = (nseg + SU - 1) / SU;
  const int nqt = (Q + QT - 1) / QT;
  const int ktiles = (D + T_BK - 1) / T_BK;
  // stages t = (i * nqt + query tile) * ktiles + kt for this block's i-th group
  const int total = blockIdx.x < groups ? ((groups - 1 - blockIdx.x) / gridDim.x + 1) * nqt * ktiles : 0;

  // copies: thread tid takes chunk pc of the staged rows prow + RPJ j
  const int pc = tid % T_CPR;
  const int prow = tid / T_CPR;
  int p_grp = blockIdx.x, p_qt = 0, p_kt = 0, issued = 0;
  auto issue = [&]() {
    if (issued < total) {
      const int k0 = p_kt * T_BK + pc * 4;
      const bool in_d = k0 < D;  // D % 4 == 0: a chunk is all in or out
      const uint32_t dst = ring + (issued % STAGES) * STAGE;
#pragma unroll
      for (int j = 0; j < STEPS; ++j) {
        if (j < UR / RPJ) {
          const int row = prow + RPJ * j;
          const int64_t n = (int64_t)p_grp * UR + row;
          const bool ok = in_d && n < N;  // zeros past D, and past N in a group's missing segment
          cp_async16(dst + t_row_offset(row, pc), ok ? corpus + n * D + k0 : corpus, ok ? 16 : 0);
        } else {
          const int i = prow + RPJ * j - UR;
          const int q = p_qt * QT + i;
          const bool ok = in_d && q < Q;  // zeros past D and Q
          cp_async16(dst + t_query_offset<UR, QPT>(i / QPT, i % QPT, pc),
                     ok ? queries + (int64_t)q * D + k0 : queries, ok ? 16 : 0);
        }
      }
      if (++p_kt == ktiles) {
        p_kt = 0;
        if (++p_qt == nqt) {
          p_qt = 0;
          p_grp += gridDim.x;
        }
      }
    }
    ++issued;
    cp_async_commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue();

  const int tr = lane % RG;
  const int tq = (tid >> 5) * (32 / RG) + lane / RG;
  float acc[8][QPT];  // acc[4 h + k][j]: unit row 4 RG h + 4 tr + k, query QPT tq + j
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < QPT; ++j) acc[r][j] = 0.f;

  int grp = blockIdx.x, qt = 0, kt = 0;
  uint32_t mw[2] = {~0u, ~0u};  // mask bytes of rows 4 tr .. 4 tr + 3 (+ 4 RG h)
  for (int t = 0; t < total; ++t) {
    if (MASKED && kt == 0) {  // read early: its latency hides behind the unit
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t n = (int64_t)grp * UR + 4 * RG * h + 4 * tr;
        if (n < N) mw[h] = *reinterpret_cast<const uint32_t*>(mask + n);
      }
    }
    cp_async_wait<STAGES - 2>();  // this thread's copies of stage t are done
    __syncthreads();              // everyone's are, and stage t - 1 is free
    issue();                      // stage t + STAGES - 1 into stage t - 1's slot
    const unsigned char* st = tsmem + (t % STAGES) * STAGE;
    // per 16-byte chunk (4 deep): QPT query loads and 8 row loads, each
    // broadcast or conflict-free, then 32 QPT FMAs, each accumulator's
    // four in a row (an order that let ptxas keep the next chunk's loads
    // in flight: faster than four outer products at Q >= 64). The offsets
    // are t_query_offset(tq, j, c) and t_row_offset(4 RG h + 4 tr + k, c),
    // whose permutations are tq & 7 and tr & 7 for every j, h and k
#pragma unroll
    for (int c = 0; c < T_CPR; ++c) {
      const unsigned char* qs = st + t_query_offset<UR, QPT>(tq, 0, c);
      const unsigned char* cs = st + t_row_offset(4 * tr, c);
      float4 qv[QPT], cv[8];
#pragma unroll
      for (int j = 0; j < QPT; ++j) qv[j] = *reinterpret_cast<const float4*>(qs + j * T_ROW);
#pragma unroll
      for (int r = 0; r < 8; ++r)
        cv[r] = *reinterpret_cast<const float4*>(cs + (4 * RG * (r >> 2) + (r & 3)) * T_ROW);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int j = 0; j < QPT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][j] = fmaf(lane_of(cv[r], e), lane_of(qv[j], e), acc[r][j]);
    }
    if (++kt < ktiles) continue;

    // the unit is complete: -inf at freed slots, the scores in 16-byte
    // stores (RG lanes write 4 RG contiguous scores of a query), and each
    // query's max over each segment: over the thread's rows in it, then
    // across the RG lanes
    kt = 0;
    bool live[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) live[r] = !MASKED || ((mw[r >> 2] >> (8 * (r & 3))) & 0xffu) != 0;
    const int64_t row0 = (int64_t)grp * UR + 4 * tr;
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const int q = qt * QT + QPT * tq + j;  // uniform across the RG lanes
#pragma unroll
      for (int su = 0; su < SU; ++su) {
        constexpr int HPS = 2 / SU;  // row quads a thread holds in one segment
        float m = -CUDART_INF_F;
#pragma unroll
        for (int h = su * HPS; h < (su + 1) * HPS; ++h) {
          float4 v;
          v.x = live[4 * h] ? acc[4 * h][j] : -CUDART_INF_F;
          v.y = live[4 * h + 1] ? acc[4 * h + 1][j] : -CUDART_INF_F;
          v.z = live[4 * h + 2] ? acc[4 * h + 2][j] : -CUDART_INF_F;
          v.w = live[4 * h + 3] ? acc[4 * h + 3][j] : -CUDART_INF_F;
          m = fmaxf(m, fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
          if (q < Q && row0 + 4 * RG * h < N)
            *reinterpret_cast<float4*>(scores + (int64_t)q * N + row0 + 4 * RG * h) = v;
        }
#pragma unroll
        for (int off = 1; off < RG; off <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        const int seg = grp * SU + su;
        if (tr == 0 && q < Q && seg < nseg) segmax[(int64_t)q * nseg + seg] = m;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[r][j] = 0.f;
    }
    if (++qt == nqt) {
      qt = 0;
      grp += gridDim.x;
    }
  }
}

template <bool MASKED, int RG, int QPT>
cudaError_t launch_tile_body(const void* queries, const void* corpus, const void* mask, void* scores,
                             void* segmax, int Q, int N, int D, int sms, cudaStream_t s) {
  constexpr int smem = t_smem(RG, QPT);
  auto fn = score_segmax_tile<MASKED, RG, QPT>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  constexpr int su = t_rows(RG) / SEG;
  const int groups = (N / SEG + su - 1) / su;
  const int grid = groups < 1 ? 1 : groups < sms ? groups : sms;
  fn<<<grid, T_THREADS, smem, s>>>(static_cast<const float*>(queries), static_cast<const float*>(corpus),
                                   static_cast<const uint8_t*>(mask), static_cast<float*>(scores),
                                   static_cast<float*>(segmax), Q, N, D);
  return cudaGetLastError();
}

// the unit by Q: two segments x 32 or 64 queries, one segment x 128
template <bool MASKED>
cudaError_t launch_tile(const void* queries, const void* corpus, const void* mask, void* scores, void* segmax,
                        int Q, int N, int D, int sms, cudaStream_t s) {
  if (Q <= t_queries(32, 4))
    return launch_tile_body<MASKED, 32, 4>(queries, corpus, mask, scores, segmax, Q, N, D, sms, s);
  if (Q <= t_queries(32, 8))
    return launch_tile_body<MASKED, 32, 8>(queries, corpus, mask, scores, segmax, Q, N, D, sms, s);
  return launch_tile_body<MASKED, 16, 8>(queries, corpus, mask, scores, segmax, Q, N, D, sms, s);
}

// ---------------------------------------------------------------------------

template <bool MASKED>
int launch(const void* queries, const void* corpus, const void* mask, void* scores, void* segmax,
           int Q, int N, int D, int corpus_bf16, int queries_bf16, void* scratch, int device,
           void* stream) {
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DeviceLimits& lim = device_limits[device];
  int sms = lim.sms.load();
  if (sms == 0) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return (int)err;
    lim.smem_optin.store(optin);
    lim.sms.store(sms);
  }
  // f32 queries at the serving path's query counts, where they fit: the stream
  const int smem = Q <= S_MAX_Q ? stream_smem(query_tile(Q), D, corpus_bf16 ? 2 : 4) : 0;
  if (!queries_bf16 && Q <= S_MAX_Q && smem <= lim.smem_optin.load()) {
    if (corpus_bf16)
      return (int)dispatch_stream<__nv_bfloat16, MASKED>(queries, corpus, mask, scores, segmax,
                                                         Q, N, D, smem, sms, s);
    return (int)dispatch_stream<float, MASKED>(queries, corpus, mask, scores, segmax, Q, N, D,
                                               smem, sms, s);
  }
  // every other case on a bf16 slab: the tensor-core stream
  if (corpus_bf16)
    return (int)launch_wgmma<MASKED>(queries, queries_bf16, scratch, corpus, mask, scores, segmax,
                                     Q, N, D, sms, s);
  // every other case on an f32 slab (f32 queries only): the register tile
  if (queries_bf16) return (int)cudaErrorInvalidValue;
  return (int)launch_tile<MASKED>(queries, corpus, mask, scores, segmax, Q, N, D, sms, s);
}

}  // namespace

// queries [Q, D] f32 (or bf16 with a bf16 slab), corpus [N, D] f32 or
// bf16, mask [N] bool, scores [Q, N] f32, segmax [Q, N / 128] f32; scratch
// holds 3 Q D bf16 for f32 queries on a bf16 slab (unused otherwise).
extern "C" int score_segmax_masked(const void* queries, const void* corpus, const void* mask,
                                   void* scores, void* segmax, int Q, int N, int D,
                                   int corpus_bf16, int queries_bf16, void* scratch, int device,
                                   void* stream) {
  return launch<true>(queries, corpus, mask, scores, segmax, Q, N, D, corpus_bf16, queries_bf16,
                      scratch, device, stream);
}

extern "C" int score_segmax_unmasked(const void* queries, const void* corpus, void* scores,
                                     void* segmax, int Q, int N, int D, int corpus_bf16,
                                     int queries_bf16, void* scratch, int device, void* stream) {
  return launch<false>(queries, corpus, nullptr, scores, segmax, Q, N, D, corpus_bf16,
                       queries_bf16, scratch, device, stream);
}

extern "C" const char* score_segmax_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
