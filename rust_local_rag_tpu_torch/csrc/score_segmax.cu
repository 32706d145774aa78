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
// entry never reads a mask.
//
// Design. One block owns one 128-row segment and a tile of 16 queries; the
// grid is (query tiles, segments) with the query tile fastest, so the
// blocks that share a segment run close together and its rows come from
// L2 after the first read. The depth loop stages a [128 x 32] corpus tile
// and a [32 x 16] query tile in shared memory per step. Warp w owns
// queries 4w..4w+3 and lane l owns rows l, l+32, l+64, l+96, so each warp
// holds the whole segment for its queries: the segment max is a register
// max over 4 rows and a 5-step shuffle reduction, while the scores are
// still on chip. Products are f32 FMA on the CUDA cores: an f32 slab stays
// at full f32 (TF32 tensor cores would keep ~10 mantissa bits), and a bf16
// slab is widened exactly with __bfloat162float. Each score is summed in
// depth order 0..D-1.
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s f32 outside the tensor cores)
// at N = 65,536, D = 768, f32 slab: bytes N*D*4 + Q*N*4 + N + Q*N/128*4
// ~ 205 MB at Q = 16 (61 us); arithmetic 2*Q*N*D = 1.6 GFLOP at Q = 16
// (24 us). Memory bounds it at small Q, f32 FMA from Q ~ 45 up. This first
// version does not double-buffer and computes whole 16-query tiles, so
// Q < 16 pays for padded queries.
//
// C interface (bound with ctypes): returns cudaGetLastError() after the
// launch; 0 is success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

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

template <bool MASKED>
int launch(const void* queries, const void* corpus, const void* mask,
           void* scores, void* segmax, int Q, int N, int D, int corpus_bf16,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Q + BQ - 1) / BQ, N / SEG);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
