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
// entry never reads a mask. Products are f32 FMA on the CUDA cores: an f32
// slab stays at full f32 (TF32 tensor cores would keep ~10 mantissa bits),
// and a bf16 slab is widened exactly (its 16 bits shifted into the top of
// an f32).
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s f32 outside the tensor cores)
// at N = 65,536, D = 768: bytes N*D*s + Q*N*4 (+ N mask bytes) + the
// queries and maxima, i.e. 205 MB at Q 16 on an f32 slab (61 us) and
// 105 MB on a bf16 slab (31 us); arithmetic 2*Q*N*D = 1.6 GFLOP at Q 16
// (24 us). Memory bounds every Q <= 16 on an f32 slab; on a bf16 slab at
// Q 16 the f32 FMAs come close to the bytes.
//
// Two bodies, chosen by shape in launch():
//
// * Q <= 16, the serving path's query counts (the micro-batcher caps a
//   batch at 16 and pads it to a power of two): a persistent stream.
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
// * Q > 16 (bench.py's batches; not on the serving path), or queries too
//   large for shared memory: the first version's body, unchanged. One
//   block owns one 128-row segment and a tile of 16 queries; the grid is
//   (query tiles, segments), so at most 65,535 segments. The depth loop
//   stages a [128 x 32] corpus tile and a [32 x 16] query tile in shared
//   memory per step with no overlap of loads and compute; warp w owns
//   queries 4w..4w+3 and lane l rows l, l+32, l+64, l+96, and each score
//   is summed in depth order 0..D-1.
//
// C interface (bound with ctypes): returns cudaGetLastError() after the
// launch; 0 is success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int SEG = 128;          // rows per segment == rows per block
constexpr int BQ = 16;            // queries per block
constexpr int BK = 32;            // depth per shared-memory step
constexpr int THREADS = 128;      // 4 warps
constexpr int QPT = BQ / (THREADS / 32);  // queries per warp (and thread): 4
constexpr int RPT = SEG / 32;     // rows per lane: 4

// [SEG x BK] corpus tile -> cs (f32), 8 threads per 128-byte row chunk.
__device__ __forceinline__ void load_corpus_tile(
    const float* __restrict__ corpus, int64_t row0, int k0, int D,
    float (*cs)[BK + 1], int tid) {
#pragma unroll
  for (int j = 0; j < (SEG * BK / 4) / THREADS; ++j) {
    const int f = tid + THREADS * j;
    const int r = f >> 3;
    const int c4 = f & 7;
    const int col = k0 + c4 * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (col < D)
      v = *reinterpret_cast<const float4*>(corpus + (row0 + r) * (int64_t)D + col);
    cs[r][c4 * 4 + 0] = v.x;
    cs[r][c4 * 4 + 1] = v.y;
    cs[r][c4 * 4 + 2] = v.z;
    cs[r][c4 * 4 + 3] = v.w;
  }
}

// bf16 slab: 16 bytes carry 8 values, widened exactly to f32.
__device__ __forceinline__ void load_corpus_tile(
    const __nv_bfloat16* __restrict__ corpus, int64_t row0, int k0, int D,
    float (*cs)[BK + 1], int tid) {
#pragma unroll
  for (int j = 0; j < (SEG * BK / 8) / THREADS; ++j) {
    const int f = tid + THREADS * j;
    const int r = f >> 2;
    const int c8 = f & 3;
    const int col = k0 + c8 * 8;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (col < D)
      raw = *reinterpret_cast<const uint4*>(corpus + (row0 + r) * (int64_t)D + col);
    const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) cs[r][c8 * 8 + e] = __bfloat162float(b[e]);
  }
}

template <typename T, bool MASKED>
__global__ void __launch_bounds__(THREADS)
score_segmax_kernel(const float* __restrict__ queries,
                           const T* __restrict__ corpus,
                           const uint8_t* __restrict__ mask,
                           float* __restrict__ scores,
                           float* __restrict__ segmax,
                           int Q, int N, int D) {
  __shared__ float cs[SEG][BK + 1];            // +1: conflict-free row reads
  __shared__ __align__(16) float qs[BK][BQ];   // transposed query tile

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int seg = blockIdx.y;
  const int64_t row0 = (int64_t)seg * SEG;

  float acc[QPT][RPT];
#pragma unroll
  for (int j = 0; j < QPT; ++j)
#pragma unroll
    for (int r = 0; r < RPT; ++r) acc[j][r] = 0.f;

  for (int k0 = 0; k0 < D; k0 += BK) {
    load_corpus_tile(corpus, row0, k0, D, cs, tid);
    {
      // [BQ x BK] query tile: one float4 per thread, zeros past Q or D
      const int qi = tid >> 3;
      const int c4 = tid & 7;
      const int col = k0 + c4 * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + qi < Q && col < D)
        v = *reinterpret_cast<const float4*>(queries + (int64_t)(q0 + qi) * D + col);
      qs[c4 * 4 + 0][qi] = v.x;
      qs[c4 * 4 + 1][qi] = v.y;
      qs[c4 * 4 + 2][qi] = v.z;
      qs[c4 * 4 + 3][qi] = v.w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 qv = *reinterpret_cast<const float4*>(&qs[kk][warp * QPT]);
      float c[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) c[r] = cs[lane + 32 * r][kk];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        acc[0][r] = fmaf(qv.x, c[r], acc[0][r]);
        acc[1][r] = fmaf(qv.y, c[r], acc[1][r]);
        acc[2][r] = fmaf(qv.z, c[r], acc[2][r]);
        acc[3][r] = fmaf(qv.w, c[r], acc[3][r]);
      }
    }
    __syncthreads();
  }

  bool live[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) live[r] = !MASKED || mask[row0 + lane + 32 * r] != 0;
  const int nseg = N / SEG;
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int q = q0 + warp * QPT + j;  // uniform across the warp
    float m = -CUDART_INF_F;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const float v = live[r] ? acc[j][r] : -CUDART_INF_F;
      if (q < Q) scores[(int64_t)q * N + row0 + lane + 32 * r] = v;
      m = fmaxf(m, v);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0 && q < Q) segmax[(int64_t)q * nseg + seg] = m;
  }
}

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy; src_bytes 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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

template <bool MASKED>
int launch(const void* queries, const void* corpus, const void* mask,
           void* scores, void* segmax, int Q, int N, int D, int corpus_bf16,
           int device, void* stream) {
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
  // the stream for the serving path's query counts, where its queries fit
  const int smem = Q <= S_MAX_Q ? stream_smem(query_tile(Q), D, corpus_bf16 ? 2 : 4) : 0;
  if (Q <= S_MAX_Q && smem <= lim.smem_optin.load()) {
    if (corpus_bf16)
      return (int)dispatch_stream<__nv_bfloat16, MASKED>(queries, corpus, mask, scores, segmax,
                                                         Q, N, D, smem, sms, s);
    return (int)dispatch_stream<float, MASKED>(queries, corpus, mask, scores, segmax, Q, N, D,
                                               smem, sms, s);
  }
  const dim3 grid((Q + BQ - 1) / BQ, N / SEG);
  if (corpus_bf16) {
    score_segmax_kernel<__nv_bfloat16, MASKED><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(queries),
        static_cast<const __nv_bfloat16*>(corpus),
        static_cast<const uint8_t*>(mask), static_cast<float*>(scores),
        static_cast<float*>(segmax), Q, N, D);
  } else {
    score_segmax_kernel<float, MASKED><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(queries), static_cast<const float*>(corpus),
        static_cast<const uint8_t*>(mask), static_cast<float*>(scores),
        static_cast<float*>(segmax), Q, N, D);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int score_segmax_masked(const void* queries, const void* corpus,
                                   const void* mask, void* scores,
                                   void* segmax, int Q, int N, int D,
                                   int corpus_bf16, int device, void* stream) {
  return launch<true>(queries, corpus, mask, scores, segmax, Q, N, D,
                      corpus_bf16, device, stream);
}

extern "C" int score_segmax_unmasked(const void* queries, const void* corpus,
                                     void* scores, void* segmax, int Q, int N,
                                     int D, int corpus_bf16, int device,
                                     void* stream) {
  return launch<false>(queries, corpus, nullptr, scores, segmax, Q, N, D,
                       corpus_bf16, device, stream);
}

extern "C" const char* score_segmax_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
