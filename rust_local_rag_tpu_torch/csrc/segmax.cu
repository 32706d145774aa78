// Segment max of a score matrix: out[r, t] = max(scores[r, seg t : seg t + seg])
// over scores [R, C] f32 (R query rows, C corpus columns, C % seg == 0), for
// seg 64 or 128, for sm_90a.
//
// Replaces the segment-max-only TPU kernels of the split exact top-k
// experiments: make_segmax_qn (scripts/exp_split_pipeline.py:30-71) and
// make_segmax (scripts/exp_split2.py:18-55). Both stream column blocks of
// a [Q, N] f32 score matrix from device memory through a ring of VMEM
// buffers and write the max of every seg-column segment of each row.
// Max is exact in any order, so the result equals the plain amax bit for
// bit.
//
// Bound on the H100: bytes only. The scores are read once and the maxima
// written once: at Q 128, N 1,245,184, seg 128, 637.5 MB + 5.0 MB, 0.192 ms
// at 3.35 TB/s; the compares are negligible.
//
// Design. [R, C] is contiguous and no segment crosses a row, so segment g
// of the flat array is floats [g seg, (g + 1) seg) and out is flat [R C /
// seg]. A warp reduces 128 contiguous floats at a time, one 16-byte load
// a lane: seg 128 is one segment a warp step (a 5-step xor shuffle), seg
// 64 two (4 steps within each half-warp). The TPU knobs map to:
//   blkc  (columns a DMA step)  -> columns a block reduces: block b takes
//         the b-th run of blkc contiguous floats (one row's column block;
//         the TPU's step held all Q rows of it), its 8 warps striding over
//         the blkc / 128 warp steps;
//   slots (DMA ring depth)      -> 16-byte loads a lane keeps in flight
//         (1, 2, 4 or 8; a larger value takes 8): a warp issues that many
//         steps' loads before it reduces any of them. The card hides the
//         rest of the latency with the other warps of the SM.
// Neither changes the result.
//
// C interface (bound with ctypes): returns cudaGetLastError() after the
// launch; 0 is success.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;

template <int SEG, int SLOTS>
__global__ void __launch_bounds__(WARPS * 32)
    segmax_kernel(const float4* __restrict__ scores, float* __restrict__ out, int steps_per_block) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // warp step s of this block covers floats [128 (b spb + s), +128)
  const int64_t step0 = static_cast<int64_t>(blockIdx.x) * steps_per_block;
  for (int base = warp * SLOTS; base < steps_per_block; base += WARPS * SLOTS) {
    float4 v[SLOTS];
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      if (base + s < steps_per_block) v[s] = __ldcs(scores + (step0 + base + s) * 32 + lane);
    }
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      if (base + s < steps_per_block) {
        float m = fmaxf(fmaxf(v[s].x, v[s].y), fmaxf(v[s].z, v[s].w));
        // SEG / 4 lanes hold one segment: 32 lanes at seg 128, 16 at 64
#pragma unroll
        for (int off = SEG / 8; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        if ((lane & (SEG / 4 - 1)) == 0) {
          out[((step0 + base + s) * 128 + lane * 4) / SEG] = m;
        }
      }
    }
  }
}

template <int SEG>
cudaError_t launch_seg(const float* scores, float* out, int64_t blocks, int spb, int slots,
                       cudaStream_t stream) {
  const auto* s4 = reinterpret_cast<const float4*>(scores);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (slots >= 8) {
    segmax_kernel<SEG, 8><<<grid, WARPS * 32, 0, stream>>>(s4, out, spb);
  } else if (slots >= 4) {
    segmax_kernel<SEG, 4><<<grid, WARPS * 32, 0, stream>>>(s4, out, spb);
  } else if (slots >= 2) {
    segmax_kernel<SEG, 2><<<grid, WARPS * 32, 0, stream>>>(s4, out, spb);
  } else {
    segmax_kernel<SEG, 1><<<grid, WARPS * 32, 0, stream>>>(s4, out, spb);
  }
  return cudaGetLastError();
}

}  // namespace

// scores [R, C] f32, 16-byte aligned and contiguous; out [R, C / seg] f32.
// Needs seg 64 or 128, C % blkc == 0 and blkc % 128 == 0 (the wrapper
// checks); slots >= 1.
extern "C" int segmax_rows(const void* scores, void* out, long long R, long long C, int seg,
                           long long blkc, int slots, int device, void* stream) {
  if (R < 1 || C < 1 || blkc < 128 || blkc % 128 || C % blkc || slots < 1 || (seg != 64 && seg != 128))
    return (int)cudaErrorInvalidValue;
  const long long blocks = R * (C / blkc);
  if (blocks > 0x7fffffffLL || blkc / 128 > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto* st = static_cast<cudaStream_t>(stream);
  const auto* s = static_cast<const float*>(scores);
  auto* o = static_cast<float*>(out);
  const int spb = static_cast<int>(blkc / 128);
  return (int)(seg == 128 ? launch_seg<128>(s, o, blocks, spb, slots, st)
                          : launch_seg<64>(s, o, blocks, spb, slots, st));
}

extern "C" const char* segmax_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
