// Fused attention softmax(Q K^T * Dh^-1/2 + bias) V on [B, H, L, Dh] bf16,
// Dh = 64, L <= 512, for sm_90a, on the tensor cores.
//
// Replaces the TPU kernel fused_attention / _make_kernel
// (rust_local_rag_tpu/ops/attention.py:44-147). It computes the same
// function, not the same blocking:
//   s[i, j]  = (sum_d q[i, d] k[j, d]) * 0.125 + kbias[j] + cbias[i, j]
//   kbias[j] = 0 where mask[b, j] > 0, else the finite -1e9
//   cbias    = -1e9 where j > i when causal, else 0; a masked key above the
//              diagonal gets -2e9 in all, as the TPU kernel adds both
//   p[i, :]  = exp(s - max_j s) / sum_j exp(s - max_j s), f32, exact
//              (normalised by the row sum before the bf16 cast, so not an
//              online softmax that normalises at the end)
//   out[i,:] = bf16(sum_j bf16(p[i, j]) v[j, :]), f32 accumulation
// The finite bias keeps a row whose keys are all masked uniform, not NaN.
// Padded query rows are computed like any other row.
//
// What bounds it on the H100 (3.35 TB/s; 989 TFLOP/s bf16 on the tensor
// cores; the exp on the SFU at 16 a clock an SM, 132 SMs, taken at the
// 1.83 GHz of the data sheet's tensor peak: 3.87e12 exps/s). Per call:
// 4*B*H*L*Dh*2 + B*L*4 bytes, 4*B*H*L^2*Dh operations, B*H*L^2 exps.
//   query encoder, B 16, H 8, L 64:   bytes 1.25 us, operations 0.14, exps 0.14
//   judge, B 256, H 6, L 192 causal:  bytes 45 us, operations 15 us, exps 15 us
//   ingest, B 128, H 8, L 256:        bytes 40 us, operations 17 us, exps 17 us
//   ingest, B 128, H 8, L 512:        bytes 80 us, operations 69 us, exps 69 us
// Memory bounds every shape, but at L 512 the tensor cores and the SFU each
// need nearly as long: near the bound a kernel would run all three at once.
// The exact softmax needs every exp of a row before its first PV product
// (which an online softmax avoids), and the scores of a 64-row tile against
// 512 keys are 128 KB of f32, half of an SM's registers: one tile's exps
// can be in flight on an SM at a time, so the SFU phase of a tile does not
// overlap another tile's products at L 512.
//
// Two bodies; attention_body(L) names the one a length takes: the mma.sync
// body up to L 64 (the query encoder's bucket, where it is the faster), the
// wgmma body beyond (the encoder's L 128 / 256 / 512 buckets and the
// judge's L 192).
//
// The mma.sync body (L <= 192 when named).
// * Persistent blocks, each walking (batch row, head) items: K and V of an
//   item are read from device memory once, by cp.async (16-byte copies
//   where the strides allow, 4-byte otherwise) into shared-memory rows
//   padded to 72 values (144 bytes), so the 8 rows an ldmatrix reads fall
//   on distinct banks; rows past L are zero-filled. A block holds two such
//   stages and copies the next item's K, V and mask while it computes this
//   one (two blocks of 111 KB to an SM at L 192).
// * Each warp owns 16 query rows at a time (the m16 of
//   mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32); its Q fragments are
//   loaded once from device memory into registers. bf16 x bf16 products
//   are exact and accumulate in f32, so this is the TPU's arithmetic up to
//   summation order.
// * Softmax in registers, 64 keys (one chunk: 8 m16n8 score tiles, 32 f32
//   a thread) at a time. A row's scores sit across the 4 lanes of a quad,
//   so its max and sum are two xor shuffles. Where a tile's keys fit one
//   chunk the exps stay in registers: one pass. Otherwise two passes:
//   pass 1 takes the row max and sum over the chunks (the sum rescaled
//   when the max grows), pass 2 recomputes each chunk's scores from shared
//   memory, forms p and accumulates PV. Either way p = exp(s - m) * (1 / l)
//   is normalised in f32 (within one f32 ulp of the quotient) before it is
//   rounded to bf16.
// * The score accumulators of an m16n8 tile pair are laid out as the A
//   operand of the next m16k16 product, so the normalised p goes from
//   registers straight into the PV mma (V through ldmatrix .trans).
// * Causal chunks of 64 keys wholly above a tile's last row are skipped
//   only where that is exact: when key 0 of the batch row is valid, every
//   row has a valid key at or below its position, and a key above the
//   diagonal then scores <= -1e9 below the row max, whose exp is 0 in f32.
//   A batch row whose key 0 is masked computes every chunk (its masked
//   keys below the diagonal and its valid keys above it may all round to
//   -1e9, and the TPU spreads the row over both).
// Past L 64 this body loses: each 16-row tile reads all of K (and K and V
// again in pass 2) from shared memory through ldmatrix, the two passes
// compute every exp twice, and past L 192 (when it took those lengths, to
// PR 19) a block held one stage, so the next item's copy waited on this
// item's last tile: 19% of the bound at L 512 (PERF.md).
//
// The wgmma body (L > 64). One block of 384 threads an SM: two consumer
// warpgroups (232 registers a thread after setmaxnreg) and a producer
// warpgroup (40; one warp copies, one writes key biases).
// * Shared-memory reads: QK^T is wgmma.m64n128k16 with both operands in
//   128-byte-swizzled shared memory (the Q tile, a K slot's half) and PV
//   wgmma.m64n64k16 with p from registers, so a K or V row is read once
//   for 64 query rows, not once for 16, with no padded rows and no
//   ldmatrix. The m64 accumulator of a warp is the mma.sync layout, so the
//   packed scores are the PV A fragments as in the mma.sync body.
// * Each exp once: a warpgroup holds the scores of its 64 rows against 256
//   keys in registers (128 f32 a thread), as two halves of 128 keys, each
//   its own commit group. Each half is scaled, biased, exponentiated
//   against its own row max m_h and summed as soon as its products land,
//   so the first half's SFU work runs while the second half's products do.
//   Then m_w = max m_h, f_h = exp(m_h - m_w) (exactly 1 for the half that
//   holds m_w; 0 for a half wholly past L), l_w = l_A f_A + l_B f_B, and p
//   = e * (f_h / l_w) rounded to bf16. Past L 256 the warpgroups take one
//   tile together, warpgroup w keys 256 w .. 256 w + 255: they swap (m_w,
//   l_w) through shared memory (two buffers by tile parity), p = e * (f_h
//   F_w / l) with F_w = exp(m_w - m) and l = l_0 F_0 + l_1 F_1 in that
//   order in both; one warpgroup hands its partial PV sums to the other
//   (named barrier, arrive only) and goes on to its next tile while the
//   other adds them and writes the output, the two taking turns by tile. Against exp(s - m) / l
//   this is an f32 ulp or two, within the approximate exp
//   (tests/test_torch_attention.py emulates the order).
// * Copies: TMA (cp.async.bulk.tensor, 4-D maps over {64 values, row,
//   head, batch} in the order of the strides, so the models' transposed
//   views qualify) into a ring of 32 KB slots (256 keys of K or V, with
//   the K slot's key bias beside it: 0, -1e9, or -inf past L) and rings of
//   8 KB Q tiles, each slot with a full and an empty mbarrier. The
//   producer runs ahead in the order the consumers need (the item's first
//   Q tiles, its K, its V, its other Q tiles, then the next item's), so
//   the next item's K lands while this item's last tiles compute (5 slots:
//   an item's 4 and one more past L 256, two items and a half below).
//   Operands whose base or strides TMA cannot take (not 16-byte multiples)
//   are copied by the producer lanes with 4-byte loads into the same
//   swizzled layout, and give the same bits.
// * The output tile goes through its Q slot (its products are done):
//   stmatrix in the swizzled layout, then 16-byte stores of whole rows.
// * Every slot a warpgroup shares it waits on and frees in order, so a
//   wait on a barrier's phase parity never sees another phase; no causal
//   chunk is skipped (the bias alone makes causal masking exact).
// What still holds it back at L 512 (PERF.md): the two warpgroups run the
// SFU phase of a tile at the same time (the tile's scores fill the
// registers), so the tensor cores wait on the exps and the SFU on the
// products.
//
// C interface (bound with ctypes): q, k and v are read through their
// element strides (batch, head, row; the depth stride must be 1, the
// others even, the bases 4-byte aligned), the output is contiguous
// [B, H, L, 64]; returns cudaGetLastError() after the launch, 0 on success.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int DH = 64;             // head dim
constexpr int KROW = DH + 8;       // shared-memory row stride in bf16 values
constexpr int CHUNK = 64;          // keys a chunk: 8 n8 score tiles
constexpr int MAX_L = 512;
constexpr float NEG = -1e9f;
constexpr float SCALE = 0.125f;    // 64^-1/2

constexpr float LOG2E = 1.4426950408889634f;

// 2^x (ex2.approx.ftz, the quarter-rate MUFU.EX2). exp(s - m) is taken as
// ex2(fma(s, log2 e, -m log2 e)): every score of a row shifts by the same
// rounding of m log2 e, which the division by the row sum cancels; within
// ~1e-6 relative for the scores that matter, and results below 2^-126
// flush to 0, which moves no bf16 output.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

// two f32 -> bf16x2 rounded to nearest even, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// L rows of 64 bf16 from device memory (row step rs elements) into
// shared-memory rows of KROW values, as cp.async copies
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int64_t rs,
                                           int L, int vec16, int tid, int nthr) {
  if (vec16) {
    for (int idx = tid; idx < L * (DH / 8); idx += nthr) {
      const int r = idx >> 3, c = (idx & 7) * 8;
      cp_async16(smem_addr(dst + r * KROW + c), src + r * rs + c);
    }
  } else {
    for (int idx = tid; idx < L * (DH / 2); idx += nthr) {
      const int r = idx >> 5, c = (idx & 31) * 2;
      cp_async4(smem_addr(dst + r * KROW + c), src + r * rs + c);
    }
  }
}

// The scaled, biased f32 scores of this warp's 16 rows (row0..row0+15)
// against the 64 keys of chunk ch; s[nt] is the m16n8 accumulator of keys
// ch*64 + nt*8 .. +7. kbias is -inf past L, so those keys score -inf.
__device__ __forceinline__ void scores(float (&s)[8][4], const uint32_t (&qa)[4][4], int ch,
                                       uint32_t k_lane, const float* kbias, int row0,
                                       bool causal, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
  // every product of the chunk first, so their latencies overlap
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t kb[4];
      ldsm_x4(k_lane + ((ch * CHUNK + nt * 8) * KROW + half * 32) * 2, kb);
      mma16816(s[nt], qa[2 * half], kb[0], kb[1]);
      mma16816(s[nt], qa[2 * half + 1], kb[2], kb[3]);
    }
  }
  // then the biases, the causal one only where the chunk crosses the
  // diagonal of one of the rows (one branch for the chunk, not per tile)
  const float* kbc = kbias + ch * CHUNK + t4 * 2;
  if (causal && ch * CHUNK + CHUNK - 1 > row0) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 kb2 = *reinterpret_cast<const float2*>(kbc + nt * 8);
      const int j = ch * CHUNK + nt * 8 + t4 * 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = row0 + g + (e >> 1) * 8;
        const float bias = ((e & 1) ? kb2.y : kb2.x) + (j + (e & 1) > i ? NEG : 0.f);
        s[nt][e] = s[nt][e] * SCALE + bias;
      }
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 kb2 = *reinterpret_cast<const float2*>(kbc + nt * 8);
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = s[nt][e] * SCALE + ((e & 1) ? kb2.y : kb2.x);
    }
  }
}

// Fold a chunk into the running row max m and sum l of exp(s - m): the
// sum is rescaled when the max grows; s becomes exp(s - m_new).
__device__ __forceinline__ void fold_max_sum(float (&s)[8][4], float (&m)[2], float (&l)[2]) {
  // two partial maxima and sums a row, so the chains stay short
  float gm[2][2] = {{-CUDART_INF_F, -CUDART_INF_F}, {-CUDART_INF_F, -CUDART_INF_F}};
  float gs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    gm[0][nt & 1] = fmaxf(gm[0][nt & 1], fmaxf(s[nt][0], s[nt][1]));
    gm[1][nt & 1] = fmaxf(gm[1][nt & 1], fmaxf(s[nt][2], s[nt][3]));
  }
  float mn[2], ml[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mn[r] = fmaxf(m[r], quad_max(fmaxf(gm[r][0], gm[r][1])));
    ml[r] = mn[r] * LOG2E;
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nt][e] = ex2(fmaf(s[nt][e], LOG2E, -ml[e >> 1]));
      gs[e >> 1][nt & 1] += s[nt][e];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // the first chunk: m = -inf and l = 0, so l = 0 * 0 + the row sum
    l[r] = l[r] * ex2((m[r] - mn[r]) * LOG2E) + quad_sum(gs[r][0] + gs[r][1]);
    m[r] = mn[r];
  }
}

// p = e * (1 / l) rounded to bf16, packed as the A operands of the PV
// products: pa[kk] covers keys kk*16 .. +15 of the chunk (the score tiles
// 2kk and 2kk+1 of an m16n8 pair are the A layout of an m16k16 tile)
__device__ __forceinline__ void normalise(const float (&s)[8][4], const float (&inv)[2],
                                          uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int n0 = 2 * kk, n1 = 2 * kk + 1;
    pa[kk][0] = pack_bf16(s[n0][0] * inv[0], s[n0][1] * inv[0]);
    pa[kk][1] = pack_bf16(s[n0][2] * inv[1], s[n0][3] * inv[1]);
    pa[kk][2] = pack_bf16(s[n1][0] * inv[0], s[n1][1] * inv[0]);
    pa[kk][3] = pack_bf16(s[n1][2] * inv[1], s[n1][3] * inv[1]);
  }
}

// o += P V over the 64 keys of chunk ch
__device__ __forceinline__ void pv(const uint32_t (&pa)[4][4], int ch, uint32_t v_lane,
                                   float (&o)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int key0 = ch * CHUNK + kk * 16;
#pragma unroll
    for (int np = 0; np < 4; ++np) {  // pairs of 8-column output tiles
      uint32_t vb[4];
      ldsm_x4_trans(v_lane + (key0 * KROW + np * 16) * 2, vb);
      mma16816(o[2 * np], pa[kk], vb[0], vb[1]);
      mma16816(o[2 * np + 1], pa[kk], vb[2], vb[3]);
    }
  }
}

// Start the cp.async copies of one (batch row, head) item: K and V rows
// into ks / vs, the mask row into mk.
__device__ __forceinline__ void stage_item(__nv_bfloat16* ks, __nv_bfloat16* vs, int32_t* mk,
                                           const __nv_bfloat16* k, const __nv_bfloat16* v,
                                           const int32_t* mask, int b, int h, int L,
                                           int64_t ksb, int64_t ksh, int64_t ksl, int64_t vsb,
                                           int64_t vsh, int64_t vsl, int kvec, int vvec, int tid,
                                           int nthr) {
  stage_rows(ks, k + b * ksb + h * ksh, ksl, L, kvec, tid, nthr);
  stage_rows(vs, v + b * vsb + h * vsh, vsl, L, vvec, tid, nthr);
  for (int j = tid; j < L; j += nthr) cp_async4(smem_addr(mk + j), mask + (int64_t)b * L + j);
}

// The mma.sync body (L <= 192). A persistent block walks the (batch row,
// head) items blockIdx.x, blockIdx.x + gridDim.x, ...: the next item's K, V
// and mask are copied into the other of two stages while this item is
// computed. WARPS and MIN_BLOCKS bound the registers so that MIN_BLOCKS
// blocks of WARPS warps fit an SM.
template <int WARPS, int MIN_BLOCKS>
__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ mask,
                 __nv_bfloat16* __restrict__ out, int B, int H, int L,
                 int64_t qsb, int64_t qsh, int64_t qsl,
                 int64_t ksb, int64_t ksh, int64_t ksl,
                 int64_t vsb, int64_t vsh, int64_t vsl, int causal, int kvec, int vvec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nch = (L + CHUNK - 1) / CHUNK;
  const int lp = nch * CHUNK;          // rows held, zero past L
  // a stage: K [lp][KROW], V [lp][KROW] bf16, key bias [lp] f32, mask [lp]
  const int stage_bytes = lp * KROW * 2 * 2 + lp * 4 * 2;
  auto ks_of = [&](int st) { return reinterpret_cast<__nv_bfloat16*>(smem + st * stage_bytes); };
  auto vs_of = [&](int st) { return ks_of(st) + lp * KROW; };
  auto kbias_of = [&](int st) { return reinterpret_cast<float*>(vs_of(st) + lp * KROW); };
  auto mk_of = [&](int st) { return reinterpret_cast<int32_t*>(kbias_of(st) + lp); };

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int nitems = B * H;

  // K and V past L must be finite: those keys get p = 0, and 0 * NaN is
  // NaN. The copies never write there, so once is enough.
  for (int st = 0; st < 2; ++st) {
    for (int idx = tid; idx < (lp - L) * (DH / 8); idx += nthr) {
      const int r = L + (idx >> 3), c = (idx & 7) * 8;
      *reinterpret_cast<uint4*>(ks_of(st) + r * KROW + c) = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(vs_of(st) + r * KROW + c) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  int item = blockIdx.x;
  if (item < nitems)
    stage_item(ks_of(0), vs_of(0), mk_of(0), k, v, mask, item / H, item % H, L, ksb, ksh, ksl,
               vsb, vsh, vsl, kvec, vvec, tid, nthr);
  cp_async_commit();

  const int ntiles = (L + 15) / 16;
  for (int n = 0; item < nitems; ++n, item += gridDim.x) {
    const int st = n & 1;
    const int next = item + gridDim.x;
    if (next < nitems)
      stage_item(ks_of(st ^ 1), vs_of(st ^ 1), mk_of(st ^ 1), k, v, mask, next / H, next % H, L,
                 ksb, ksh, ksl, vsb, vsh, vsl, kvec, vvec, tid, nthr);
    cp_async_commit();
    cp_async_wait<1>();  // this item's copies are in (all but the newest group)
    __syncthreads();
    const int b = item / H, h = item % H;
    const int32_t* mk = mk_of(st);
    float* kbias = kbias_of(st);
    for (int j = tid; j < lp; j += nthr)
      kbias[j] = j < L ? (mk[j] > 0 ? 0.f : NEG) : -CUDART_INF_F;
    const bool skip_above = causal && mk[0] > 0;
    __syncthreads();

    // ldmatrix row addresses of this lane. K: matrix lane/8 is depth block
    // lane/8 (x 8 values) of key lane%8. V (.trans): matrix i = lane/8
    // holds keys (i & 1) * 8 + lane%8 at columns (i >> 1) * 8.
    const uint32_t k_lane = smem_addr(ks_of(st)) + ((lane & 7) * KROW + (lane >> 3) * 8) * 2;
    const uint32_t v_lane = smem_addr(vs_of(st)) +
                            (((lane & 7) + ((lane >> 3) & 1) * 8) * KROW + (lane >> 4) * 8) * 2;
    const uint32_t* qw = reinterpret_cast<const uint32_t*>(q + b * qsb + h * qsh);
    __nv_bfloat16* ob = out + ((int64_t)b * H + h) * L * DH;

    for (int tile = warp; tile < ntiles; tile += nwarps) {
      const int row0 = tile * 16;
      const int r0 = row0 + g, r1 = row0 + g + 8;
      const int climit = skip_above ? min(nch, (row0 + 15) / CHUNK + 1) : nch;
      float s[8][4];
      uint32_t qa[4][4], pa[4][4];
      float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f}, inv[2];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int w = kk * 8 + t4;
        qa[kk][0] = r0 < L ? __ldg(qw + r0 * qsl / 2 + w) : 0u;
        qa[kk][1] = r1 < L ? __ldg(qw + r1 * qsl / 2 + w) : 0u;
        qa[kk][2] = r0 < L ? __ldg(qw + r0 * qsl / 2 + w + 4) : 0u;
        qa[kk][3] = r1 < L ? __ldg(qw + r1 * qsl / 2 + w + 4) : 0u;
      }
      // pass 1: the row max and sum over the chunks
      for (int ch = 0; ch < climit; ++ch) {
        scores(s, qa, ch, k_lane, kbias, row0, causal, lane);
        fold_max_sum(s, m, l);
      }
      inv[0] = 1.f / l[0];
      inv[1] = 1.f / l[1];
      float o[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
      if (climit == 1) {  // one chunk: its exps are final
        normalise(s, inv, pa);
        pv(pa, 0, v_lane, o);
      } else {
        // pass 2: each chunk's scores again, p = exp(s - m) / l, PV
        const float ml[2] = {m[0] * LOG2E, m[1] * LOG2E};
        for (int ch = 0; ch < climit; ++ch) {
          scores(s, qa, ch, k_lane, kbias, row0, causal, lane);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[nt][e] = ex2(fmaf(s[nt][e], LOG2E, -ml[e >> 1]));
          normalise(s, inv, pa);
          pv(pa, ch, v_lane, o);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = nt * 8 + t4 * 2;
        if (r0 < L)
          *reinterpret_cast<uint32_t*>(ob + (int64_t)r0 * DH + col) = pack_bf16(o[nt][0], o[nt][1]);
        if (r1 < L)
          *reinterpret_cast<uint32_t*>(ob + (int64_t)r1 * DH + col) = pack_bf16(o[nt][2], o[nt][3]);
      }
    }
    __syncthreads();  // the stage is free for the copies of a later item
  }
  cp_async_wait<0>();
}


// ---------------------------------------------------------------------------
// The wgmma body (L > 64).

constexpr int TILE = 64;                    // query rows of a warpgroup's tile
constexpr int TILE_BYTES = TILE * DH * 2;   // 8 KB: a Q tile, 64 rows of 128 bytes
constexpr int SPAN = 256;                   // keys of a K or V slot: one warpgroup's keys
constexpr int SPAN_BYTES = SPAN * DH * 2;   // 32 KB
constexpr int WG_THREADS = 128;
constexpr int HOP_THREADS = 3 * WG_THREADS;  // two consumer warpgroups and the producer's
// registers a thread after setmaxnreg: 40 in the producer warpgroup, 232 in
// the consumers (40 * 128 + 232 * 256 <= 65,536), against the 168 that
// 384 threads would get alike
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
// Q tiles: in the split mode one ring both warpgroups read, otherwise two
// slots a warpgroup (slots 2 w, 2 w + 1)
constexpr int Q_SLOTS = 4;
constexpr int SMEM_LIMIT = 232448;          // dynamic shared memory a block may have
// the split mode's exchanges: (max, sum) of both rows a thread, two
// buffers by the tile's parity (the warpgroup that hands its output over
// may write the next tile's while the other still reads this one's), then
// the partial output sums handed over
constexpr int XML_BYTES = 2 * 2 * WG_THREADS * 16;
constexpr int XO_BYTES = 8 * WG_THREADS * 16;

// d = (acc ? d : 0) + a b^T: wgmma m64n128k16, bf16 in, f32 accumulators, A
// (64 x 16 of the Q tile) and B (128 x 16 of a K slot's half) both K-major
// from 128-byte-swizzled shared memory. Thread (warp w, lane 4 g + t) holds
// rows 16 w + g (d[4 j], d[4 j + 1]) and 16 w + g + 8 (d[4 j + 2], d[4 j +
// 3]) at columns 8 j + 2 t, 8 j + 2 t + 1, j < 16.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

// d = (acc ? d : 0) + a b: wgmma m64n64k16 for P V, A (64 x 16 of p) from
// registers in the mma.sync m16k16 A layout of each warp's 16 rows, B (16
// keys x 64 values of the V slot, MN-major) from shared memory
__device__ __forceinline__ void wgmma_rs_pv(float (&d)[32], const uint32_t (&a)[4], uint64_t desc, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

// descriptor of a 128-byte-swizzled operand whose 8-row groups lie 1,024
// bytes apart: for the K-major Q tile and K slot that is the stride byte
// offset (the leading one is unused); for the MN-major V slot, 64 values
// (one swizzle atom) wide, the stride between its 8-key groups, set in both
// fields
__device__ __forceinline__ uint64_t sw128_mn_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (64ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

// the split mode's output hand-over (named barrier 2): the warpgroup that
// hands its sums over arrives without waiting, the one that writes waits
__device__ __forceinline__ void handover_arrive() { asm volatile("bar.arrive 2, 256;\n" ::: "memory"); }
__device__ __forceinline__ void handover_sync() { asm volatile("bar.sync 2, 256;\n" ::: "memory"); }

// mbar_wait with its loop inside one asm block, so the compiler sees no
// divergent path before the wgmma that follows (which it would otherwise
// serialize); a wait of ~2 s traps, as mbar_wait does
__device__ __forceinline__ void mbar_wait_cv(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .u64 t0, t1;\n"
      "mov.u64 t0, %%clock64;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t1, %%clock64;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.gt.u64 p, t1, 4000000000;\n"
      "@p trap;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void stsm_x4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(r0), "r"(r1),
               "r"(r2), "r"(r3)
               : "memory");
}

__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// the slot and phase parity of entry i (< slots) of a ring whose entry 0
// is at (slot, parity)
struct RingPos {
  int slot, parity;
  __device__ RingPos at(int i, int slots) const {
    const int s = slot + i;
    return s >= slots ? RingPos{s - slots, parity ^ 1} : RingPos{s, parity};
  }
};

// One Q, K or V tensor as the kernel reads it: a 4-D tensor map ({64 values,
// then the row, head and batch dimensions in the order of their strides};
// perm packs which of row 0 / head 1 / batch 2 is the map's dimension 1, 2
// and 3, two bits each) where the strides allow TMA, else the pointer and
// element strides for 4-byte loads.
struct Operand {
  const __nv_bfloat16* base;
  long long sl, sh, sb;
  int perm, tma;
};

constexpr int HALF = SPAN / 2;  // keys of a half: one m64n128k16 product's columns

// S = Q K^T for one warpgroup's 256 keys as two halves of 128 (s[0..63],
// s[64..127]), each its own commit group behind its own fence
__device__ __forceinline__ void qk_halves(float (&s)[128], uint32_t qaddr, uint32_t kaddr) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_ss_n128(s, sw128_desc(qaddr + 32 * kk), sw128_desc(kaddr + 32 * kk), kk);
  wgmma_commit();
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss_n128(s + 64, sw128_desc(qaddr + 32 * kk), sw128_desc(kaddr + HALF * 128 + 32 * kk), kk);
  wgmma_commit();
}

// Half HF of a warpgroup's scores, s[64 HF + 4 j + e] for keys k0 + 128 HF
// + 8 j + 2 t + (e & 1) (j < 16) of rows r0 (e < 2) and r1: scaled, biased
// (bs: the slot's key bias; the causal bias where causal_here), then e =
// exp(s - m) in place with m its row maxima (quad-wide) and l the row sums
// of e (quad-wide). A half wholly past L (every bias -inf) gives m = -inf
// and e = 0.
template <int HF>
__device__ __forceinline__ void softmax_half(float (&s)[128], const float* bs, int k0, bool causal_here, int r0,
                                             int r1, float (&m)[2], float (&l)[2]) {
#pragma unroll
  for (int e = 0; e < 64; ++e) fence_operand(s[64 * HF + e]);
  const int t4 = threadIdx.x & 3;
  const float* hb = bs + HF * HALF + 2 * t4;
  if (causal_here) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 kb2 = *reinterpret_cast<const float2*>(hb + 8 * j);
      const int key = k0 + HF * HALF + 8 * j + 2 * t4;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = (e >> 1) ? r1 : r0;
        const float bv = ((e & 1) ? kb2.y : kb2.x) + (key + (e & 1) > i ? NEG : 0.f);
        s[64 * HF + 4 * j + e] = s[64 * HF + 4 * j + e] * SCALE + bv;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 kb2 = *reinterpret_cast<const float2*>(hb + 8 * j);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[64 * HF + 4 * j + e] = s[64 * HF + 4 * j + e] * SCALE + ((e & 1) ? kb2.y : kb2.x);
    }
  }
  float mp[2][2] = {{-CUDART_INF_F, -CUDART_INF_F}, {-CUDART_INF_F, -CUDART_INF_F}};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    mp[0][j & 1] = fmaxf(mp[0][j & 1], fmaxf(s[64 * HF + 4 * j], s[64 * HF + 4 * j + 1]));
    mp[1][j & 1] = fmaxf(mp[1][j & 1], fmaxf(s[64 * HF + 4 * j + 2], s[64 * HF + 4 * j + 3]));
  }
  float ml[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = quad_max(fmaxf(mp[r][0], mp[r][1]));
    ml[r] = m[r] == -CUDART_INF_F ? 0.f : m[r] * LOG2E;  // -inf - -inf would be NaN
  }
  float ls[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[64 * HF + 4 * j + e] = ex2(fmaf(s[64 * HF + 4 * j + e], LOG2E, -ml[e >> 1]));
      ls[e >> 1][j & 1] += s[64 * HF + 4 * j + e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = quad_sum(ls[r][0] + ls[r][1]);
}

// SPLIT (L > 256): both consumer warpgroups take every 64-row query tile of
// an item, warpgroup w keys 256 w .. 256 w + 255, and they exchange row
// maxima and sums, then halves of the output. Otherwise warpgroup w takes
// tiles w, w + 2, ... against all (<= 256) keys. The producer's first warp
// copies, per item: the first Q tile (or two), every K slot (256 keys), every
// V slot, then the remaining Q tiles, into a ring of kv_slots 32 KB slots and
// the Q rings; its second warp writes each K slot's key bias. Each slot has a
// full barrier (the copying warp's lanes with the TMA's bytes, and for K / V
// the bias warp's) and an empty one (the warps that read it). Every consumer
// warpgroup waits on and frees every use of a slot it shares, in order (in
// the split mode also the other's K and V slots), so no wait on a barrier's
// parity can see a phase other than the one it means.
template <bool SPLIT>
__global__ void __launch_bounds__(HOP_THREADS, 1)
attention_wgmma(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, const Operand qo, const Operand ko, const Operand vo,
                const int32_t* __restrict__ mask, __nv_bfloat16* __restrict__ out, int B, int H, int L,
                int causal, int kv_slots) {
  extern __shared__ __align__(1024) unsigned char smem_w[];  // aligned again below
  unsigned char* smem = smem_w;
  const uint32_t s0 = smem_addr(smem);
  const uint32_t kvring = (s0 + 1023) & ~1023u;
  const uint32_t qring = kvring + kv_slots * SPAN_BYTES;
  const uint32_t bias_s = qring + Q_SLOTS * TILE_BYTES;  // [kv_slots][256] f32: a K slot's key bias
  const uint32_t xml_s = bias_s + kv_slots * SPAN * 4;
  const uint32_t xo_s = xml_s + (SPLIT ? XML_BYTES : 0);
  const uint32_t kvfull = xo_s + (SPLIT ? XO_BYTES : 0);
  const uint32_t kvempty = kvfull + 8 * kv_slots;
  const uint32_t qfull = kvempty + 8 * kv_slots;
  const uint32_t qempty = qfull + 8 * Q_SLOTS;
  const float* bias = reinterpret_cast<const float*>(smem + (bias_s - s0));
  float4* xml = reinterpret_cast<float4*>(smem + (xml_s - s0));
  float4* xo = reinterpret_cast<float4*>(smem + (xo_s - s0));

  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = __shfl_sync(0xffffffffu, tid / WG_THREADS, 0);  // warp-uniform to the compiler
  const int nitems = B * H;
  const int ntiles = (L + TILE - 1) / TILE;
  const int nkv = SPLIT ? 2 : 1;  // K slots of an item, and as many V slots
  if (tid == 0) {
    const int readers = SPLIT ? 8 : 4 * min(2, ntiles);  // warps that free a K or V slot
    for (int s = 0; s < kv_slots; ++s) {
      mbar_init(kvfull + 8 * s, 64);  // the copying warp's and the bias warp's lanes
      mbar_init(kvempty + 8 * s, readers);
    }
    for (int s = 0; s < Q_SLOTS; ++s) {
      mbar_init(qfull + 8 * s, 32);
      mbar_init(qempty + 8 * s, SPLIT ? 8 : 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer warpgroup: warp 8 copies, warp 9 writes key biases, the others leave
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int pwarp = __shfl_sync(0xffffffffu, (tid >> 5) - 8, 0);
    if (pwarp >= 2) return;
    const int first = SPLIT ? 1 : min(2, ntiles);  // Q tiles copied before the item's K and V
    RingPos kv{0, 0};
    int qseq[2] = {0, 0};
    for (int item = blockIdx.x; item < nitems; item += gridDim.x) {
      const int b = item / H, h = item % H;
      if (pwarp == 1) {
        // the key bias of every key of the item, loaded at once: 0 for a
        // valid key, the finite -1e9 for a masked one, -inf past L
        float kb[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int j = 32 * i + lane;
          kb[i] = i < 8 * nkv && j < L ? (__ldg(mask + (int64_t)b * L + j) > 0 ? 0.f : NEG) : -CUDART_INF_F;
        }
        // each K / V slot's full barrier takes this warp's 32 arrivals too:
        // after the bias for a K slot, at once for a V slot
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (c >= 2 * nkv) break;
          const RingPos p = kv.at(c, kv_slots);
          mbar_wait(kvempty + 8 * p.slot, p.parity ^ 1);  // a fresh barrier passes parity 1
          if (c < nkv)
#pragma unroll
            for (int i = 0; i < 8; ++i)
              st_shared_u32(bias_s + (p.slot * SPAN + 32 * i + lane) * 4, __float_as_uint(kb[8 * c + i]));
          mbar_arrive(kvfull + 8 * p.slot);
        }
        kv = kv.at(2 * nkv, kv_slots);
        continue;
      }
      // copy `rows` rows from row0 of operand `which` (0 q, 1 k, 2 v) into
      // the slot at dst with barriers full / empty, once the empty one's
      // phase `parity` is done (parity 1 on a fresh barrier passes at once)
      auto load = [&](int which, int row0, int rows, uint32_t dst, uint32_t full, uint32_t empty, int parity) {
        const Operand op = which == 0 ? qo : (which == 1 ? ko : vo);
        mbar_wait(empty, parity);
        if (op.tma && row0 < L) {
          if (lane == 0) {
            const CUtensorMap* map = which == 0 ? &qmap : (which == 1 ? &kmap : &vmap);
            auto coord = [&](int d) {  // the coordinate of the map's dimension d
              const int p = (op.perm >> (2 * d - 2)) & 3;
              return p == 0 ? row0 : (p == 1 ? h : b);
            };
            mbar_expect_tx(full, rows * DH * 2);
            tma_load_4d(dst, map, 0, coord(1), coord(2), coord(3), full);
          } else {
            mbar_arrive(full);
          }
        } else {  // 4-byte loads: lane copies word `lane` of each row; zeros past L
          const uint32_t* src = reinterpret_cast<const uint32_t*>(op.base + b * op.sb + h * op.sh);
          for (int r0 = 0; r0 < rows; r0 += 16) {
            uint32_t w[16];
#pragma unroll
            for (int i = 0; i < 16; ++i) {
              const int r = row0 + r0 + i;
              w[i] = r < L ? __ldg(src + r * op.sl / 2 + lane) : 0u;
            }
#pragma unroll
            for (int i = 0; i < 16; ++i) {
              const int r = r0 + i;
              st_shared_u32(dst + r * 128 + ((((lane >> 2) ^ (r & 7)) << 4) | ((lane & 3) << 2)), w[i]);
            }
          }
          fence_proxy_async();
          mbar_arrive(full);
        }
      };
      auto load_kv = [&](int which, int c) {  // slot c (keys 256 c ..) of K or V
        const int i = (which - 1) * nkv + c;
        const RingPos p = kv.at(i, kv_slots);
        load(which, c * SPAN, SPAN, kvring + p.slot * SPAN_BYTES, kvfull + 8 * p.slot, kvempty + 8 * p.slot,
             p.parity ^ 1);
      };
      // tile t into the Q ring of each warpgroup that takes it (the split
      // mode's one shared ring is warpgroup 0's)
      auto load_q = [&](int t) {
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          if (SPLIT ? w > 0 : t % 2 != w) continue;
          const int slot = SPLIT ? qseq[0] % Q_SLOTS : 2 * w + (qseq[w] & 1);
          const int use = SPLIT ? qseq[0] / Q_SLOTS : qseq[w] >> 1;
          ++qseq[w];
          load(0, t * TILE, TILE, qring + slot * TILE_BYTES, qfull + 8 * slot, qempty + 8 * slot, (use & 1) ^ 1);
        }
      };
      for (int t = 0; t < first; ++t) load_q(t);
      for (int c = 0; c < nkv; ++c) load_kv(1, c);
      for (int c = 0; c < nkv; ++c) load_kv(2, c);
      for (int t = first; t < ntiles; ++t) load_q(t);
      kv = kv.at(2 * nkv, kv_slots);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wtid = tid & 127, warp = wtid >> 5, g = lane >> 2;
  const int tstep = SPLIT ? 1 : 2, tfirst = SPLIT ? 0 : wg;
  if (tfirst >= ntiles) return;  // the rows mode at L <= 64: warpgroup 1 has no tile
  const int tlast = tfirst + (ntiles - 1 - tfirst) / tstep * tstep;
  const int kfirst = SPLIT ? wg * SPAN : 0;  // this warpgroup's first key
  // wait on and free the item's K (which 0) or V (1) slots once this
  // warpgroup's warps are done with them
  auto free_slots = [&](RingPos item0, int which) {
    for (int c = 0; c < nkv; ++c) {
      const RingPos p = item0.at(which * nkv + c, kv_slots);
      mbar_wait_cv(kvfull + 8 * p.slot, p.parity);
      __syncwarp();
      if (lane == 0) mbar_arrive(kvempty + 8 * p.slot);
    }
  };
  auto qslot_of = [&](int use) { return SPLIT ? use % Q_SLOTS : 2 * wg + (use & 1); };
  // the Q slot of Q use `use` and the K slot of the item at kv_, once
  // both have landed: their addresses for qk_halves
  auto qk_operands = [&](int use, RingPos kv_, uint32_t& qa, uint32_t& ka) {
    const int qs = qslot_of(use);
    mbar_wait_cv(qfull + 8 * qs, (SPLIT ? use / Q_SLOTS : use >> 1) & 1);
    const RingPos ks = kv_.at(SPLIT ? wg : 0, kv_slots);
    mbar_wait_cv(kvfull + 8 * ks.slot, ks.parity);
    qa = qring + qs * TILE_BYTES;
    ka = kvring + ks.slot * SPAN_BYTES;
  };
  float s[128];
  uint32_t qa_next, ka_next;

  // this warpgroup's units (item, tile t) in order
  int item = blockIdx.x, t = tfirst, quse = 0;
  RingPos kv{0, 0};
  if (item >= nitems) return;
  qk_operands(quse, kv, qa_next, ka_next);
  qk_halves(s, qa_next, ka_next);
  for (;;) {
    const int b = item / H, h = item % H;
    const int row0 = t * TILE;
    const int r0 = row0 + 16 * warp + g, r1 = r0 + 8;  // this thread's two query rows
    const uint32_t qaddr = qring + qslot_of(quse) * TILE_BYTES;
    const RingPos ks = kv.at(SPLIT ? wg : 0, kv_slots), vs = kv.at(nkv + (SPLIT ? wg : 0), kv_slots);
    const float* bs = bias + ks.slot * SPAN;

    // each half of 128 keys as its products land: scale and bias, its row
    // maxima mh, e = exp(s - mh) once in place, its row sums lh
    float mh[2][2], lh[2][2];
    wgmma_wait<1>();
    softmax_half<0>(s, bs, kfirst, causal && kfirst + HALF - 1 > row0, r0, r1, mh[0], lh[0]);
    wgmma_wait<0>();
    softmax_half<1>(s, bs, kfirst, causal && kfirst + SPAN - 1 > row0, r0, r1, mh[1], lh[1]);
    if (t == tlast) free_slots(kv, 0);  // this warpgroup is done with the item's K

    // p = e * coef: with m_w = max of the halves' maxima, f_h = exp(mh -
    // m_w) (1 for the half that holds m_w, 0 for one wholly past L) and l_w
    // = l_A f_A + l_B f_B, coef = f_h / l_w; in the split mode the
    // warpgroups' (m_w, l_w) combine the same way, f_h F_w / l
    float coef[2][2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mw = fmaxf(mh[0][r], mh[1][r]);
      const float fa = mh[0][r] == mw ? 1.f : ex2((mh[0][r] - mw) * LOG2E);
      const float fb = mh[1][r] == mw ? 1.f : ex2((mh[1][r] - mw) * LOG2E);
      coef[0][r] = fa;
      coef[1][r] = fb;
      mh[0][r] = mw;  // from here the warpgroup's (m_w, l_w)
      lh[0][r] = __fadd_rn(__fmul_rn(lh[0][r], fa), __fmul_rn(lh[1][r], fb));
    }
    if constexpr (SPLIT) {
      float4* xb = xml + (quse & 1) * 2 * WG_THREADS;
      xb[wg * WG_THREADS + wtid] = make_float4(mh[0][0], mh[0][1], lh[0][0], lh[0][1]);
      consumers_sync();
      const float4 a = xb[wtid], z = xb[WG_THREADS + wtid];  // warpgroup 0's, 1's
      const float m0[2] = {a.x, a.y}, m1[2] = {z.x, z.y}, l0[2] = {a.z, a.w}, l1[2] = {z.z, z.w};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m = fmaxf(m0[r], m1[r]);
        const float f0 = m0[r] == m ? 1.f : ex2((m0[r] - m) * LOG2E);
        const float f1 = m1[r] == m ? 1.f : ex2((m1[r] - m) * LOG2E);
        const float inv = 1.f / __fadd_rn(__fmul_rn(l0[r], f0), __fmul_rn(l1[r], f1));
        const float fw = wg == 0 ? f0 : f1;
        coef[0][r] = __fmul_rn(__fmul_rn(coef[0][r], fw), inv);
        coef[1][r] = __fmul_rn(__fmul_rn(coef[1][r], fw), inv);
      }
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float inv = 1.f / lh[0][r];
        coef[0][r] = __fmul_rn(coef[0][r], inv);
        coef[1][r] = __fmul_rn(coef[1][r], inv);
      }
    }

    // O = P V, p rounded to bf16 from registers as the A operand, 16 keys
    // a product
    uint32_t pa[16][4];
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      const int n0 = 8 * kk, n1 = n0 + 4;  // score tiles 2 kk and 2 kk + 1
      const float c0 = coef[kk >> 3][0], c1 = coef[kk >> 3][1];
      pa[kk][0] = pack_bf16(s[n0] * c0, s[n0 + 1] * c0);
      pa[kk][1] = pack_bf16(s[n0 + 2] * c1, s[n0 + 3] * c1);
      pa[kk][2] = pack_bf16(s[n1] * c0, s[n1 + 1] * c0);
      pa[kk][3] = pack_bf16(s[n1 + 2] * c1, s[n1 + 3] * c1);
    }
    float o[32];
    mbar_wait_cv(kvfull + 8 * vs.slot, vs.parity);
    const uint32_t vaddr = kvring + vs.slot * SPAN_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) wgmma_rs_pv(o, pa[kk], sw128_mn_desc(vaddr + kk * 16 * 128), kk);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < 32; ++e) fence_operand(o[e]);
    if (t == tlast) free_slots(kv, 1);  // and with its V

    // the output tile through this unit's Q slot (free: its products are
    // done): stmatrix in the swizzled layout, then rows of 16 bytes a lane
    __nv_bfloat16* ob = out + ((int64_t)b * H + h) * L * DH;
    const uint32_t srow = qaddr + (16 * warp + ((lane >> 3) & 1) * 8 + (lane & 7)) * 128;
    // in the split mode one warpgroup (0 on even tiles, 1 on odd ones)
    // writes after adding the other's partial sums, which the other only
    // hands over before going on to its next products
    bool write = true;
    if constexpr (SPLIT) {
      if (wg != (quse & 1)) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          xo[i * WG_THREADS + wtid] = make_float4(o[4 * i], o[4 * i + 1], o[4 * i + 2], o[4 * i + 3]);
        handover_arrive();
        write = false;
      } else {
        handover_sync();
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 x = xo[i * WG_THREADS + wtid];
          o[4 * i] += x.x;
          o[4 * i + 1] += x.y;
          o[4 * i + 2] += x.z;
          o[4 * i + 3] += x.w;
        }
      }
    }
    if (write) {
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        const int unit = j + (lane >> 4);
        stsm_x4(srow + ((unit ^ (lane & 7)) << 4), pack_bf16(o[4 * j], o[4 * j + 1]),
                pack_bf16(o[4 * j + 2], o[4 * j + 3]), pack_bf16(o[4 * j + 4], o[4 * j + 5]),
                pack_bf16(o[4 * j + 6], o[4 * j + 7]));
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = 16 * warp + 4 * i + (lane >> 3), unit = lane & 7;
        const uint4 v4 = ld_shared_v4(qaddr + row * 128 + ((unit ^ (row & 7)) << 4));
        if (row0 + row < L) *reinterpret_cast<uint4*>(ob + (int64_t)(row0 + row) * DH + 8 * unit) = v4;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(qempty + 8 * qslot_of(quse));

    // the next unit
    if ((t += tstep) >= ntiles) {
      if ((item += gridDim.x) >= nitems) break;
      t = tfirst;
      kv = kv.at(2 * nkv, kv_slots);
    }
    qk_operands(++quse, kv, qa_next, ka_next);
    qk_halves(s, qa_next, ka_next);
  }
}

using KernelFn = void (*)(const __nv_bfloat16*, const __nv_bfloat16*, const __nv_bfloat16*,
                          const int32_t*, __nv_bfloat16*, int, int, int, int64_t, int64_t, int64_t,
                          int64_t, int64_t, int64_t, int64_t, int64_t, int64_t, int, int, int);
using HopperFn = decltype(&attention_wgmma<false>);

// The mma.sync body: blocks of 6 warps, 2 to an SM (at most 170 registers a
// thread, no spill; the 12 tiles of the reranker's L 192 go 2 to a warp).
constexpr int SHORT_WARPS = 6;
const KernelFn SHORT = attention_kernel<SHORT_WARPS, 2>;
// The wgmma body: the rows mode (L <= 256) and the split mode
const HopperFn HOPPER[2] = {attention_wgmma<false>, attention_wgmma<true>};

constexpr int BODY_AUTO = 0, BODY_MMA_SYNC = 1, BODY_WGMMA = 2;
constexpr int SHORT_MAX_L = 64;     // the longest L the auto choice gives the mma.sync body
constexpr int MMA_SYNC_MAX_L = 192;  // the longest it takes (two stages still fit two blocks an SM)

struct Launch {
  int smem_attr = 0, smem = 0, warps = 0, blocks = 0;
};
Launch short_cache;
int hopper_smem_attr[2] = {0, 0};
int sm_count = 0;

// the tensor map of one operand: {64 values, row, head, batch} with the
// three outer dimensions in the order of their strides (a dimension of size
// 1 last); false where TMA cannot read it (16-byte base and strides)
bool operand_map(CUtensorMap* map, Operand* op, int B, int H, int L, int box_rows) {
  op->tma = 0;
  op->perm = 0 | (1 << 2) | (2 << 4);
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(op->base) % 16) return false;
  const long long size[3] = {L, H, B};
  long long st[3] = {op->sl, op->sh, op->sb};
  long long big = 8;
  for (int i = 0; i < 3; ++i) big = st[i] > big ? st[i] : big;
  big = (big + 7) / 8 * 8;
  for (int i = 0; i < 3; ++i) {
    if (size[i] == 1) st[i] = big;
    if (st[i] % 8 || st[i] <= 0) return false;
  }
  int idx[3] = {0, 1, 2};
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && st[idx[j]] < st[idx[j - 1]]; --j) {
      const int x = idx[j];
      idx[j] = idx[j - 1];
      idx[j - 1] = x;
    }
  cuuint64_t dims[4] = {(cuuint64_t)DH, 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {(cuuint32_t)DH, 1, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = (cuuint64_t)size[idx[i]];
    strides[i] = (cuuint64_t)st[idx[i]] * 2;
    if (idx[i] == 0) box[i + 1] = box_rows;
  }
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<__nv_bfloat16*>(op->base), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  op->perm = idx[0] | (idx[1] << 2) | (idx[2] << 4);
  op->tma = 1;
  return true;
}

int launch_wgmma(const void* q, const void* k, const void* v, const void* mask, void* out, int B, int H, int L,
                 long long qsb, long long qsh, long long qsl, long long ksb, long long ksh, long long ksl,
                 long long vsb, long long vsh, long long vsl, int causal, cudaStream_t stream) {
  const int variant = L > SPAN;  // the split mode
  const HopperFn fn = HOPPER[variant];
  const int fixed = 1024 + Q_SLOTS * TILE_BYTES + (variant ? XML_BYTES + XO_BYTES : 0) + 16 * Q_SLOTS;
  const int per_slot = SPAN_BYTES + SPAN * 4 + 16;
  const int kv_slots = (SMEM_LIMIT - fixed) / per_slot;
  if (kv_slots < 2 * (variant + 1)) return (int)cudaErrorInvalidConfiguration;  // an item's K and V slots
  const int smem = fixed + kv_slots * per_slot;
  cudaError_t err;
  if (smem > hopper_smem_attr[variant]) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    hopper_smem_attr[variant] = smem;
  }
  CUtensorMap maps[3];
  Operand ops[3] = {{static_cast<const __nv_bfloat16*>(q), qsl, qsh, qsb, 0, 0},
                    {static_cast<const __nv_bfloat16*>(k), ksl, ksh, ksb, 0, 0},
                    {static_cast<const __nv_bfloat16*>(v), vsl, vsh, vsb, 0, 0}};
  for (int i = 0; i < 3; ++i) operand_map(&maps[i], &ops[i], B, H, L, i ? SPAN : TILE);  // false: 4-byte loads
  const int nitems = B * H;
  const int grid = nitems < sm_count ? nitems : sm_count;
  fn<<<grid, HOP_THREADS, smem, stream>>>(maps[0], maps[1], maps[2], ops[0], ops[1], ops[2],
                                          static_cast<const int32_t*>(mask), static_cast<__nv_bfloat16*>(out), B,
                                          H, L, causal, kv_slots);
  return (int)cudaGetLastError();
}

int launch_mma_sync(const void* q, const void* k, const void* v, const void* mask, void* out, int B, int H, int L,
                    long long qsb, long long qsh, long long qsl, long long ksb, long long ksh, long long ksl,
                    long long vsb, long long vsh, long long vsl, int causal, cudaStream_t stream) {
  const int lp = (L + CHUNK - 1) / CHUNK * CHUNK;
  const int smem = 2 * (lp * KROW * 2 * 2 + lp * 4 * 2);  // two stages
  const int ntiles = (L + 15) / 16;  // 16 query rows a warp at a time
  const int warps = ntiles < SHORT_WARPS ? ntiles : SHORT_WARPS;
  Launch& lc = short_cache;
  cudaError_t err;
  if (smem > lc.smem_attr) {
    err = cudaFuncSetAttribute(SHORT, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    lc.smem_attr = smem;
  }
  if (smem != lc.smem || warps != lc.warps) {  // blocks of this size an SM holds
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&lc.blocks, SHORT, warps * 32, smem);
    if (err != cudaSuccess) return (int)err;
    if (lc.blocks < 1) return (int)cudaErrorInvalidConfiguration;
    lc.smem = smem;
    lc.warps = warps;
  }
  const int nitems = B * H;
  const int grid = nitems < lc.blocks * sm_count ? nitems : lc.blocks * sm_count;
  // 16-byte copies need 16-byte aligned bases and row steps
  const int kvec = reinterpret_cast<uintptr_t>(k) % 16 == 0 && (ksb | ksh | ksl) % 8 == 0;
  const int vvec = reinterpret_cast<uintptr_t>(v) % 16 == 0 && (vsb | vsh | vsl) % 8 == 0;
  SHORT<<<grid, warps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int32_t*>(mask),
      static_cast<__nv_bfloat16*>(out), B, H, L, qsb, qsh, qsl, ksb, ksh, ksl, vsb, vsh, vsl,
      causal, kvec, vvec);
  return (int)cudaGetLastError();
}

}  // namespace

// the body BODY_AUTO picks at length L: 1 mma.sync, 2 wgmma
extern "C" int attention_body(int L) { return L <= SHORT_MAX_L ? BODY_MMA_SYNC : BODY_WGMMA; }

// attention_fwd with the body named (BODY_MMA_SYNC takes L <= 192 only), for
// timing one body against the other
extern "C" int attention_fwd_body(const void* q, const void* k, const void* v,
                                  const void* mask, void* out, int B, int H, int L,
                                  long long qsb, long long qsh, long long qsl,
                                  long long ksb, long long ksh, long long ksl,
                                  long long vsb, long long vsh, long long vsl,
                                  int causal, int device, void* stream, int body) {
  if (L < 1 || L > MAX_L || B < 1 || B > 65535 || H < 1 || H > 65535 || body < BODY_AUTO || body > BODY_WGMMA)
    return (int)cudaErrorInvalidValue;
  if (body == BODY_AUTO) body = attention_body(L);
  if (body == BODY_MMA_SYNC && L > MMA_SYNC_MAX_L) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (sm_count == 0) {
    err = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
  }
  const auto launch = body == BODY_WGMMA ? launch_wgmma : launch_mma_sync;
  return launch(q, k, v, mask, out, B, H, L, qsb, qsh, qsl, ksb, ksh, ksl, vsb, vsh, vsl, causal,
                static_cast<cudaStream_t>(stream));
}

extern "C" int attention_fwd(const void* q, const void* k, const void* v,
                             const void* mask, void* out, int B, int H, int L,
                             long long qsb, long long qsh, long long qsl,
                             long long ksb, long long ksh, long long ksl,
                             long long vsb, long long vsh, long long vsl,
                             int causal, int device, void* stream) {
  return attention_fwd_body(q, k, v, mask, out, B, H, L, qsb, qsh, qsl, ksb, ksh, ksl, vsb, vsh, vsl, causal,
                            device, stream, BODY_AUTO);
}

extern "C" const char* attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
