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
// Bound on the H100 (989 TFLOP/s bf16 tensor cores, 3.35 TB/s): the
// larger of 4*B*H*L^2*Dh operations and 4*B*H*L*Dh*2 + B*L*4 bytes. The
// arithmetic intensity is L/2 operations a byte (96 at L 192, 256 at
// L 512), under the card's ~295, so memory bounds it at every L <= 512:
// at the reranker's B 256, H 6, L 192 that is 151 MB (45 us) against
// 14.5 GFLOP (15 us).
//
// Design.
// * Persistent blocks, each walking (batch row, head) items: K and V of an
//   item are read from device memory once, by cp.async (16-byte copies
//   where the strides allow, 4-byte otherwise) into shared-memory rows
//   padded to 72 values (144 bytes), so the 8 rows an ldmatrix reads fall
//   on distinct banks; rows past L are zero-filled. Up to L 192 a block
//   holds two such stages and copies the next item's K, V and mask while
//   it computes this one (two blocks of 111 KB to an SM); beyond, one
//   stage, refilled after each item.
// * Each warp owns 16 query rows at a time (the m16 of
//   mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32); its Q fragments are
//   loaded once from device memory into registers. Both products run on
//   the tensor cores: bf16 x bf16 products are exact and accumulate in
//   f32, so this is the TPU's arithmetic up to summation order.
//   Not wgmma: the work is memory-bound at every shape the system gives
//   it, so wgmma's higher rate buys nothing, while mma.sync keeps one warp
//   on 16 whole rows, which is what a per-row exact softmax wants.
// * Softmax in registers, 64 keys (one chunk: 8 m16n8 score tiles, 32 f32
//   a thread) at a time. A row's scores sit across the 4 lanes of a quad,
//   so its max and sum are two xor shuffles. Where a tile's keys fit one
//   chunk the exps stay in registers: one pass. Otherwise two passes:
//   pass 1 takes the row max and sum over the chunks (the sum rescaled
//   when the max grows), pass 2 recomputes each chunk's scores from shared
//   memory, forms p and accumulates PV. Either way p = exp(s - m) * (1 / l)
//   is normalised in f32 (within one f32 ulp of the quotient) before it is
//   rounded to bf16; it is not an online softmax that normalises at the
//   end. Holding a whole row instead (96 f32 a thread at L 192) took
//   168-255 registers with spills or fewer warps an SM, and ran slower.
// * The score accumulators of an m16n8 tile pair are laid out as the A
//   operand of the next m16k16 product, so the normalised p goes from
//   registers straight into the PV mma (V through ldmatrix .trans).
// * A chunk's 32 products are all started before its bias is added, and
//   the causal bias only in chunks that cross a row's diagonal (one branch
//   a chunk), so the products' latencies overlap. What bounds the kernel
//   is instruction count and latency in the score and softmax code, and
//   at L 512 the quarter-rate exp (MUFU) of the two passes and the K/V
//   reads from shared memory, not the tensor cores or device memory.
// * Causal chunks of 64 keys wholly above a tile's last row are skipped
//   only where that is exact: when key 0 of the batch row is valid, every
//   row has a valid key at or below its position, and a key above the
//   diagonal then scores <= -1e9 below the row max, whose exp is 0 in f32.
//   A batch row whose key 0 is masked computes every chunk (its masked
//   keys below the diagonal and its valid keys above it may all round to
//   -1e9, and the TPU spreads the row over both).
//
// C interface (bound with ctypes): q, k and v are read through their
// element strides (batch, head, row; the depth stride must be 1, the
// others even, the bases 4-byte aligned), the output is contiguous
// [B, H, L, 64]; returns cudaGetLastError() after the launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

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

// A persistent block walks the (batch row, head) items blockIdx.x,
// blockIdx.x + gridDim.x, ... With nbuf = 2 the next item's K, V and mask
// are copied into the other stage while this item is computed. WARPS and
// MIN_BLOCKS bound the registers so that MIN_BLOCKS blocks of WARPS warps
// fit an SM.
template <int WARPS, int MIN_BLOCKS>
__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ mask,
                 __nv_bfloat16* __restrict__ out, int B, int H, int L,
                 int64_t qsb, int64_t qsh, int64_t qsl,
                 int64_t ksb, int64_t ksh, int64_t ksl,
                 int64_t vsb, int64_t vsh, int64_t vsl, int causal, int kvec, int vvec,
                 int nbuf) {
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
  for (int st = 0; st < nbuf; ++st) {
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
    const int st = nbuf == 2 ? (n & 1) : 0;
    const int next = item + gridDim.x;
    if (nbuf == 2 && next < nitems)
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
    if (nbuf == 1 && next < nitems) {
      stage_item(ks_of(0), vs_of(0), mk_of(0), k, v, mask, next / H, next % H, L, ksb, ksh, ksl,
                 vsb, vsh, vsl, kvec, vvec, tid, nthr);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
}

using KernelFn = void (*)(const __nv_bfloat16*, const __nv_bfloat16*, const __nv_bfloat16*,
                          const int32_t*, __nv_bfloat16*, int, int, int, int64_t, int64_t, int64_t,
                          int64_t, int64_t, int64_t, int64_t, int64_t, int64_t, int, int, int, int);

// Up to L 256: blocks of 6 warps, 2 to an SM (at most 170 registers a
// thread, no spill; the 12 tiles of the reranker's L 192 go 2 to a warp).
// Beyond (one stage of up to 148 KB, one block to an SM): 16 warps at 128
// registers.
constexpr int SHORT_WARPS = 6, LONG_WARPS = 16;
const KernelFn SHORT = attention_kernel<SHORT_WARPS, 2>;
const KernelFn LONG = attention_kernel<LONG_WARPS, 1>;
// per kernel (short, long): the dynamic shared memory it is cleared for,
// and the blocks an SM holds at the last launch's size
struct Launch {
  int smem_attr = 0, smem = 0, warps = 0, blocks = 0;
};
Launch launch_cache[2];
int sm_count = 0;

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
  if (sm_count == 0) {
    err = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
  }
  const int lp = (L + CHUNK - 1) / CHUNK * CHUNK;
  const int stage_bytes = lp * KROW * 2 * 2 + lp * 4 * 2;
  // two stages where two blocks of them still fit an SM (L <= 192)
  const int nbuf = L <= 192 ? 2 : 1;
  const int smem = nbuf * stage_bytes;
  const bool is_long = L > 256;
  const KernelFn fn = is_long ? LONG : SHORT;
  const int ntiles = (L + 15) / 16;  // 16 query rows a warp at a time
  const int max_warps = is_long ? LONG_WARPS : SHORT_WARPS;
  const int warps = ntiles < max_warps ? ntiles : max_warps;
  Launch& lc = launch_cache[is_long];
  if (smem > lc.smem_attr) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    lc.smem_attr = smem;
  }
  if (smem != lc.smem || warps != lc.warps) {  // blocks of this size an SM holds
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&lc.blocks, fn, warps * 32, smem);
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
  fn<<<grid, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int32_t*>(mask),
      static_cast<__nv_bfloat16*>(out), B, H, L, qsb, qsh, qsl, ksb, ksh, ksl, vsb, vsh, vsl,
      causal, kvec, vvec, nbuf);
  return (int)cudaGetLastError();
}

extern "C" const char* attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
