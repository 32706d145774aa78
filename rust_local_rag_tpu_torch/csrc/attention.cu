// Fused attention softmax(Q K^T * Dh^-1/2 + bias) V on [B, H, L, Dh] bf16,
// Dh = 64, L <= 512, for sm_90a.
//
// Replaces the TPU kernel fused_attention / _make_kernel
// (rust_local_rag_tpu/ops/attention.py:44-147). It computes the same
// function, not the same blocking:
//   s[i, j]  = (sum_d q[i, d] k[j, d]) * 0.125 + kbias[j] + cbias[i, j]
//   kbias[j] = 0 where mask[b, j] > 0, else the finite -1e9
//   cbias    = -1e9 where j > i when causal, else 0; a masked key above the
//              diagonal gets -2e9 in all, as the TPU kernel adds both
//   p[i, :]  = exp(s - max_j s) / sum_j exp(s - max_j s), f32, one shot
//              (normalised before the bf16 cast, so not an online softmax)
//   out[i,:] = bf16(sum_j bf16(p[i, j]) v[j, :]), f32 accumulation
// The finite bias keeps a row whose keys are all masked uniform, not NaN.
// Padded query rows are computed like any other row.
//
// Design. One block of 8 warps per (tile of 64 query rows, head, batch
// row). The block copies K and V of its (b, h) into dynamic shared memory
// (L x 64 bf16 each; rows padded to 66 values = 33 words, so lanes that
// read different rows at the same depth hit different banks) and the key
// bias. A warp takes its 8 rows 4 at a time, so every K and V word it
// reads from shared memory serves 4 rows: the 4 query rows sit in shared
// memory as f32 and are read as broadcasts; lane l owns keys l, l+32, ...
// (at most 16 scores a row in registers) and sums each score in depth
// order 0..63 with f32 FMA (bf16 x bf16 products are exact in f32, so
// this matches the TPU up to summation order); each row's max and sum are
// warp shuffles; the bf16-rounded probabilities go to shared memory,
// interleaved by row so one broadcast gives all 4; lane l then
// accumulates output columns 2l and 2l+1 of the 4 rows over the keys in
// order. Keys above the diagonal are computed, as on the TPU:
// exp(-1e9 - max) is exactly 0 in f32, so they add nothing.
//
// Bound on the H100 (989 TFLOP/s bf16 tensor cores, 3.35 TB/s): the
// larger of 4*B*H*L^2*Dh operations and 4*B*H*L*Dh*2 + B*L*4 bytes. Its
// arithmetic intensity is L/2 operations a byte, under the card's ~295, so
// memory bounds it at every L <= 512: at the reranker's B 256, H 6, L 192
// that is 151 MB (45 us) against 14.5 GFLOP (15 us). This version runs
// its products on the CUDA cores (67 TFLOP/s f32), which alone take
// ~216 us at that shape, and reads K and V once per 64-row query tile
// (from L2 after the first); mma.sync or wgmma on the tensor cores is
// later work.
//
// C interface (bound with ctypes): q, k and v are read through their
// element strides (batch, head, row; the depth stride must be 1), the
// output is contiguous [B, H, L, 64]; returns cudaGetLastError() after the
// launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int DH = 64;                 // head dim
constexpr int ROW_WORDS = DH / 2;      // bf16 pairs per row: 32
constexpr int SROW = ROW_WORDS + 1;    // shared-memory row stride in words
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int TILE = 64;               // query rows per block
constexpr int R = 4;                   // query rows a warp computes together
constexpr int MAX_L = 512;
constexpr int MAX_T = MAX_L / 32;      // keys per lane
constexpr float NEG = -1e9f;
constexpr float SCALE = 0.125f;        // 64^-1/2

__device__ __forceinline__ float2 unpack(uint32_t w) {
  __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&w);
  return __bfloat1622float2(b);
}

__global__ void __launch_bounds__(THREADS)
attention_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ k,
                 const uint32_t* __restrict__ v, const int32_t* __restrict__ mask,
                 uint32_t* __restrict__ out, int H, int L,
                 int64_t qsb, int64_t qsh, int64_t qsl,
                 int64_t ksb, int64_t ksh, int64_t ksl,
                 int64_t vsb, int64_t vsh, int64_t vsl, int causal,
                 int vec16) {
  // strides arrive in bf16 elements; every one is even (checked by the
  // wrapper), so halving them gives strides in 32-bit words
  extern __shared__ uint32_t smem[];
  const int nt = (L + 31) / 32;        // key groups: keys lane + 32 t
  const int lp = nt * 32;              // rows held, zero past L
  uint32_t* ks = smem;                 // [lp][SROW]
  uint32_t* vs = ks + lp * SROW;       // [lp][SROW]
  float* kbias = reinterpret_cast<float*>(vs + lp * SROW);  // [lp]
  float* qbuf = kbias + lp;            // [WARPS][R][DH]
  float* pbuf = qbuf + WARPS * R * DH; // [WARPS][lp][R]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.z;
  const int h = blockIdx.y;

  // K and V rows: 16-byte loads (8 per 128-byte row) when the strides
  // allow, several in flight per thread; 4-byte loads otherwise
  const uint32_t* kb = k + (b * ksb + h * ksh) / 2;
  const uint32_t* vb = v + (b * vsb + h * vsh) / 2;
  if (vec16) {
#pragma unroll 4
    for (int idx = tid; idx < lp * 8; idx += THREADS) {
      const int r = idx >> 3;
      const int c = (idx & 7) * 4;
      uint4 kw = make_uint4(0u, 0u, 0u, 0u), vw = make_uint4(0u, 0u, 0u, 0u);
      if (r < L) {
        kw = *reinterpret_cast<const uint4*>(kb + r * (ksl / 2) + c);
        vw = *reinterpret_cast<const uint4*>(vb + r * (vsl / 2) + c);
      }
      uint32_t* kd = ks + r * SROW + c;
      uint32_t* vd = vs + r * SROW + c;
      kd[0] = kw.x; kd[1] = kw.y; kd[2] = kw.z; kd[3] = kw.w;
      vd[0] = vw.x; vd[1] = vw.y; vd[2] = vw.z; vd[3] = vw.w;
    }
  } else {
    for (int idx = tid; idx < lp * ROW_WORDS; idx += THREADS) {
      const int r = idx >> 5;
      const int c = idx & 31;
      uint32_t kw = 0u, vw = 0u;
      if (r < L) {
        kw = kb[r * (ksl / 2) + c];
        vw = vb[r * (vsl / 2) + c];
      }
      ks[r * SROW + c] = kw;
      vs[r * SROW + c] = vw;
    }
  }
  for (int j = tid; j < lp; j += THREADS)
    kbias[j] = (j < L && mask[(int64_t)b * L + j] > 0) ? 0.f : NEG;
  __syncthreads();

  float* qrows = qbuf + warp * R * DH;
  float* prow = pbuf + warp * lp * R;
  // this warp's rows: 8 consecutive rows of the tile, R at a time; rows
  // past L are computed from zeros and not stored
  const int first = (int)blockIdx.x * TILE + warp * (TILE / WARPS);
  const int last = min(first + TILE / WARPS, L);
  for (int i0 = first; i0 < last; i0 += R) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float2 qv = make_float2(0.f, 0.f);
      if (i0 + r < L) qv = unpack(q[(b * qsb + h * qsh + (int64_t)(i0 + r) * qsl) / 2 + lane]);
      qrows[r * DH + 2 * lane] = qv.x;
      qrows[r * DH + 2 * lane + 1] = qv.y;
    }
    __syncwarp();

    float s[R][MAX_T];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int t = 0; t < MAX_T; ++t) s[r][t] = 0.f;
#pragma unroll 2
    for (int d4 = 0; d4 < DH / 4; ++d4) {
      float4 qd[R];
#pragma unroll
      for (int r = 0; r < R; ++r) qd[r] = reinterpret_cast<const float4*>(qrows + r * DH)[d4];
#pragma unroll
      for (int t = 0; t < MAX_T; ++t) {
        if (t < nt) {
          const uint32_t* kr = ks + (lane + 32 * t) * SROW + 2 * d4;
          const float2 k0 = unpack(kr[0]);
          const float2 k1 = unpack(kr[1]);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            s[r][t] = fmaf(qd[r].x, k0.x, s[r][t]);
            s[r][t] = fmaf(qd[r].y, k0.y, s[r][t]);
            s[r][t] = fmaf(qd[r].z, k1.x, s[r][t]);
            s[r][t] = fmaf(qd[r].w, k1.y, s[r][t]);
          }
        }
      }
    }

#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = i0 + r;
      float m = -CUDART_INF_F;
#pragma unroll
      for (int t = 0; t < MAX_T; ++t) {
        if (t < nt) {
          const int j = lane + 32 * t;
          const float bias = kbias[j] + ((causal && j > i) ? NEG : 0.f);
          s[r][t] = j < L ? s[r][t] * SCALE + bias : -CUDART_INF_F;
          m = fmaxf(m, s[r][t]);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < MAX_T; ++t) {
        if (t < nt) {
          s[r][t] = expf(s[r][t] - m);
          sum += s[r][t];
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
#pragma unroll
      for (int t = 0; t < MAX_T; ++t)
        if (t < nt)
          prow[(lane + 32 * t) * R + r] = __bfloat162float(__float2bfloat16(s[r][t] / sum));
    }
    __syncwarp();

    float acc[R][2];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = 0.f;
#pragma unroll 4
    for (int j = 0; j < L; ++j) {
      const float4 pj = reinterpret_cast<const float4*>(prow)[j];
      const float2 vd = unpack(vs[j * SROW + lane]);
      const float p[R] = {pj.x, pj.y, pj.z, pj.w};
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc[r][0] = fmaf(p[r], vd.x, acc[r][0]);
        acc[r][1] = fmaf(p[r], vd.y, acc[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (i0 + r < L) {
        __nv_bfloat162 o = __floats2bfloat162_rn(acc[r][0], acc[r][1]);
        out[(((int64_t)b * H + h) * L + i0 + r) * ROW_WORDS + lane] =
            *reinterpret_cast<uint32_t*>(&o);
      }
    }
    __syncwarp();  // qrows and prow are rewritten by the next rows
  }
}

size_t smem_bytes(int L) {
  const int lp = (L + 31) / 32 * 32;
  return (size_t)lp * SROW * 4 * 2 + (size_t)lp * 4 + (size_t)WARPS * R * DH * 4 +
         (size_t)WARPS * lp * R * 4;
}

}  // namespace

extern "C" int attention_fwd(const void* q, const void* k, const void* v,
                             const void* mask, void* out, int B, int H, int L,
                             long long qsb, long long qsh, long long qsl,
                             long long ksb, long long ksh, long long ksl,
                             long long vsb, long long vsh, long long vsl,
                             int causal, int device, void* stream) {
  if (L < 1 || L > MAX_L || B < 1 || B > 65535 || H < 1 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(L);
  err = cudaFuncSetAttribute(attention_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  // 16-byte K/V loads need 16-byte aligned bases and row steps
  const bool vec16 =
      ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16 == 0) &&
      ((ksb | ksh | ksl | vsb | vsh | vsl) % 8 == 0);
  const dim3 grid((L + TILE - 1) / TILE, H, B);
  attention_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(k),
      static_cast<const uint32_t*>(v), static_cast<const int32_t*>(mask),
      static_cast<uint32_t*>(out), H, L, qsb, qsh, qsl, ksb, ksh, ksl, vsb,
      vsh, vsl, causal, (int)vec16);
  return (int)cudaGetLastError();
}

extern "C" const char* attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
