// Decode-shaped fused ITQ3_S matvec, M <= 16: out (M, N) = x (M, KB*256) @
// W_hat, W_hat decoded from the packed planes on the fly; with `rotate_x`
// the activation FWHT runs here too, on x as it is staged.
//
// Replaces: repro/kernels/itq3_matvec.py itq3_matvec_pallas
// (_itq3_matvec_kernel, with dequant_rotate_tile from itq3_matmul.py), and
// on the decode path the blocked_fwht_op launch before it.
//
// What binds. Bytes, and in practice latency: each weight's 2-bit payload
// is read once (plane1 only for the five-level itq3_x, the zero-point only
// without sub-blocks), with its block's scales, for M <= 16 multiply-adds,
// far below the f32 rate. At smollm-135m's shapes a launch reads a few
// hundred kilobytes, so its time is the number of dependent round trips to
// memory and how many SMs have work. The design (that of
// itq3_matvec_int8.cu, in f32):
//
// - Work. A block owns `features` output features (8 per warp) and cuts K
//   into `splits` runs of ceil(KB / splits) blocks, one per warp of the
//   block (kernels/itq3.py matvec_tiles). A quad of lanes owns one feature;
//   lane q of it reads plane2 bytes 16q..16q+15 of each block of its run
//   (one 16-byte load) and holds elements c*64 + 16q + j (c = 0..3,
//   j = 0..15) in wf[16c + j].
// - Loads. A lane issues the loads of up to two blocks of its run (plane1's
//   unit, the scales and zero-point too; RunPlanes in common.cuh) before
//   any math; then the warps of a run stage its blocks of x in shared
//   memory with 16-byte cp.async copies and decode the run's first block
//   while they land, so a launch pays about one round trip. x is staged
//   whole where it fits; otherwise each run in windows of `window` blocks,
//   double-buffered behind the math, so the shared memory a block takes is
//   bounded whatever KB is. A staged 256-block keeps 4 pad floats after
//   every 32, so the four 16-float runs a quad reads lie in distinct banks.
//   A run's warps wait only for each other (a warp barrier, or a named
//   one where several warps share the run); the block meets once, to add
//   the splits' sums.
// - rotate_x. After each window lands, the warps of a run rotate its
//   256-vectors in shared memory, four rows at a time, with fwht.cu's
//   butterfly (warp_fwht_strided<8>) and one multiply by 1/16: the bits
//   fwht.cu writes, so the fused call equals fwht.cu followed by this
//   kernel.
// - Weights, activations mode: the exact integer wint = q - z (the
//   sub-block formats q), decoded bytewise (common.cuh), contracted with x
//   in f32 per 16-element chunk, and the chunk's partial scaled by d (or
//   d_sub) into the row's sum: the exact-weight form of itq3_matmul. Any
//   other sub-block count than 8 puts d_sub on each weight instead. Rows
//   go in fours, each as four short FMA chains, so the chains overlap.
// - Weights mode (rotate_weights, off the serving path): the dequantized
//   block goes through the 256-point inverse FWHT across the quad (16
//   values' stages in registers, two by shuffles, two in registers again),
//   then the same contraction with unit chunk scales.
// - Sums. Each row's sum is added over the quad, each warp leaves its run's
//   sums in shared memory, and they are added in ascending split order, so
//   two calls give the same bits.
// - Experts. A stack of E matrices with their E inputs (the MoE expert
//   projections, the vmapped pallas_call's extra grid axis on a TPU) is one
//   launch: blockIdx.y picks the expert, whose operands lie at fixed
//   strides from the base pointers. Each expert's arithmetic is the one
//   matrix's, so E = 1 gives the same bits as before the axis existed.
#include "common.cuh"

constexpr int kMaxM = 16;
constexpr int kMaxWarps = 8;      // features / 8 x splits
constexpr int kXBlock = 288;      // floats of one staged block: 256 + 8 x 4 pad
constexpr int kMaxSmem = 227 * 1024;

// Shared-memory offset, in floats, of element e of a staged block.
__device__ __forceinline__ int xs_off(int e) { return e + ((e >> 5) << 2); }

// Normalized 256-point FWHT of a block held across a quad as w[16c + j] =
// element c*64 + 16q + j, stages h = 1, 2, ..., 128 in the reference's
// order: h = 1..8 in registers (j), 16 and 32 by shuffles (lane bits 0-1),
// 64 and 128 in registers (c).
__device__ __forceinline__ void quad_fwht256(float (&w)[64], int lane) {
#pragma unroll
  for (int h = 1; h < 16; h <<= 1) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      if ((i & h) == 0) {
        const float a = w[i], b = w[i + h];
        w[i] = a + b;
        w[i + h] = a - b;
      }
    }
  }
#pragma unroll
  for (int h = 1; h < 4; h <<= 1) {  // as warp_fwht_strided's lane stages
    const float sgn = (lane & h) ? -1.f : 1.f;
#pragma unroll
    for (int i = 0; i < 64; ++i)
      w[i] = __fmaf_rn(sgn, w[i], __shfl_xor_sync(FULL_MASK, w[i], h));
  }
#pragma unroll
  for (int h = 16; h < 64; h <<= 1) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      if ((i & h) == 0) {
        const float a = w[i], b = w[i + h];
        w[i] = a + b;
        w[i + h] = a - b;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) w[i] *= 0.0625f;  // 1/sqrt(256), exact
}

// The contraction of this lane's 16 weights of chunk c (w[kOff..]) with
// every row of the staged block, each row's partial scaled by seg into
// acc[m]; xr is chunk c of row 0, rows `stride` floats apart. Rows go in
// fours without a branch between them (a row past M reads row M - 1 and
// its sum is never stored), each as four 4-term chains, so 16 independent
// chains hide the latency of the shared loads and the FMAs.
template <int kOff, int kN>
__device__ __forceinline__ void chunk_rows(const float (&w)[kN], float seg,
                                           const float* __restrict__ xr,
                                           int stride, int M,
                                           float (&acc)[kMaxM]) {
#pragma unroll
  for (int m0 = 0; m0 < kMaxM; m0 += 4) {
    if (m0 >= M) break;
    float p[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* xm = xr + min(m0 + j, M - 1) * stride;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 v = *reinterpret_cast<const float4*>(xm + 4 * k);
        float t = w[kOff + 4 * k] * v.x;
        t = fmaf(w[kOff + 4 * k + 1], v.y, t);
        t = fmaf(w[kOff + 4 * k + 2], v.z, t);
        p[j][k] = fmaf(w[kOff + 4 * k + 3], v.w, t);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[m0 + j] =
          fmaf(seg, (p[j][0] + p[j][1]) + (p[j][2] + p[j][3]), acc[m0 + j]);
  }
}

// Chunk c's 16 weights of this lane as floats: wint (kBlock), q (kSub32),
// or d_sub * q (kSubAny, its scales read here; `live` is false past N).
template <int kMode>
__device__ __forceinline__ void chunk_weights(
    const unsigned (&wq)[4], const __half* __restrict__ scales,
    long long blk, bool live, int nsub, int lg, int e0, float (&w)[16]) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
    w[j] = (float)(signed char)((wq[j >> 2] >> (8 * (j & 3))) & 0xffu);
  if constexpr (kMode == kSubAny) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      w[j] *= live ? __half2float(scales[blk * nsub + ((e0 + j) >> lg)]) : 0.f;
    asm volatile("" ::: "memory");  // at most one chunk's scale loads live
  }
}

// Decode one block of the run from this lane's units (b2, b1, sc of
// RunPlanes) into its 64 weights wf[16c + j] and the scale seg[c] of each
// chunk's partial: wint and d, q and itq3_s_sub's d_sub (sub-block 2c +
// q / 2: half q / 2 of word c of its 8 scales), d_sub * q and 1; in
// weights mode the dequantized block, rotated across the quad, and 1.
template <int kMode, bool kRotW>
__device__ __forceinline__ void block_decode(
    uint4 b2, uint4 b1, uint4 sc, const __half* __restrict__ scales,
    long long blk, bool live, int nsub, int lg, int fivelevel, int lane,
    float (&wf)[64], float (&seg)[4]) {
  const int q = lane & 3;
  unsigned wq[4][4];
  itq3_decode_wint_unit(b2, b1, kMode == kBlock ? (int)half_bits(sc.y) : 0,
                        q >= 2, fivelevel, wq);
  const unsigned h[4] = {sc.x, sc.y, sc.z, sc.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    seg[c] = kMode == kBlock  ? half_bits(sc.x)
             : kMode == kSub32 ? half_bits(h[c] >> (16 * (q >> 1)))
                               : 1.f;
    float w[16];
    chunk_weights<kMode>(wq[c], scales, blk, live, nsub, lg, 64 * c + 16 * q,
                         w);
#pragma unroll
    for (int j = 0; j < 16; ++j) wf[16 * c + j] = kRotW ? w[j] * seg[c] : w[j];
  }
  if constexpr (kRotW) {
#pragma unroll
    for (int c = 0; c < 4; ++c) seg[c] = 1.f;
    quad_fwht256(wf, lane);
  }
}

// Add the contraction of a decoded block with every row of the staged
// block at xb (rows `stride` floats apart) into acc, chunk by chunk.
__device__ __forceinline__ void block_rows(const float (&wf)[64],
                                           const float (&seg)[4],
                                           const float* __restrict__ xb,
                                           int stride, int M, int q,
                                           float (&acc)[kMaxM]) {
  const float* xr = xb + 16 * q + ((q >> 1) << 2);  // xs_off(16q), chunk 0
  chunk_rows<0>(wf, seg[0], xr, stride, M, acc);
  chunk_rows<16>(wf, seg[1], xr + 72, stride, M, acc);
  chunk_rows<32>(wf, seg[2], xr + 144, stride, M, acc);
  chunk_rows<48>(wf, seg[3], xr + 216, stride, M, acc);
}

// Rotate rows m0..m0+3 (those below M) of one staged block in place: the
// butterfly and scale of fwht.cu, so the bits are the ones it writes.
__device__ __forceinline__ void rotate_rows(float* __restrict__ v, int stride,
                                           int m0, int M, int lane) {
  float r[4][8];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int vv = 0; vv < 8; ++vv)
      r[j][vv] = m0 + j < M ? v[(m0 + j) * stride + xs_off(vv * 32 + lane)]
                            : 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) warp_fwht_strided<8>(r[j], lane);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (m0 + j < M)
#pragma unroll
      for (int vv = 0; vv < 8; ++vv)
        v[(m0 + j) * stride + xs_off(vv * 32 + lane)] = r[j][vv] * 0.0625f;
}

template <int kMode, bool kRotW>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
itq3_matvec_kernel(const float* __restrict__ x,
                   const uint8_t* __restrict__ plane2,
                   const uint8_t* __restrict__ plane1,
                   const __half* __restrict__ scales,
                   const __half* __restrict__ zps, float* __restrict__ out,
                   int M, int N, int KB, int kb_per_split, int window,
                   int fivelevel, int sub_blocks, int features,
                   int rotate_x, ExpertStrides es) {
  // whole: (M, KB) staged blocks; else per split two buffers of (M,
  // window); then the splits' sums
  extern __shared__ __align__(16) float smem[];
  const long long K = (long long)KB * 256;
  const long long ex = blockIdx.y;  // the expert: 0 for one matrix
  x += ex * es.x;
  plane2 += ex * es.plane2;
  plane1 += ex * es.plane1;
  scales += ex * es.scales;
  zps += ex * es.zps;
  out += ex * es.out;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q = lane & 3;
  const int fw = features >> 3, nsplit = (int)(blockDim.x >> 5) / fw;
  const int f = (warp % fw) * 8 + (lane >> 2), s = warp / fw, ws = warp % fw;
  const int n = blockIdx.x * features + f;
  const int kb_begin = s * kb_per_split;
  const int kb_end = min(KB, kb_begin + kb_per_split);
  const int steps = (kb_per_split + window - 1) / window;
  const bool whole = steps == 1;
  const int stride = (whole ? KB : window) * kXBlock;  // between rows
  float* sums = smem + (whole ? M * KB : nsplit * 2 * M * window) * kXBlock;
  const int nsub = sub_blocks ? sub_blocks : 1;
  const int lg = 8 - (__ffs(nsub) - 1);  // log2 of the sub-block width

  RunPlanes<kMode> pl;
  pl.load(plane2, plane1, scales, zps, n, N, KB, kb_begin, kb_end, q,
          fivelevel);

  // The fw warps of split s stage, rotate and read its run and nothing
  // else, so they wait only for each other.
  auto group_sync = [&]() {
    if (fw == 1)
      __syncwarp();
    else
      asm volatile("bar.sync %0, %1;" ::"r"(1 + s), "r"(32 * fw) : "memory");
  };
  // row 0 of staged block w of window t of this run
  auto block_at = [&](int t, int w) {
    return whole ? smem + (kb_begin + w) * kXBlock
                 : smem + ((s * 2 + (t & 1)) * M * window + w) * kXBlock;
  };
  auto stage = [&](int t) {
    const int k0 = kb_begin + t * window;
    const int nw = min(window, kb_end - k0);
    for (int m = 0; m < M; ++m)
      for (int w = ws; w < nw; w += fw)
        for (int u = lane; u < 64; u += 32)
          cp_async16(block_at(t, w) + m * stride + xs_off(4 * u),
                     x + m * K + (long long)(k0 + w) * 256 + 4 * u, true);
    cp_async_commit();
  };

  float acc[kMaxM];
#pragma unroll
  for (int m = 0; m < kMaxM; ++m) acc[m] = 0.f;
  stage(0);
  // the run's first block decoded while x lands
  float wf[64], seg[4];
  block_decode<kMode, kRotW>(pl.b2[0], pl.b1[0], pl.sc[0], scales,
                             (long long)n * KB + kb_begin, n < N, nsub, lg,
                             fivelevel, lane, wf, seg);
  for (int t = 0; t < steps; ++t) {
    if (t + 1 < steps) {
      stage(t + 1);
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    group_sync();
    const int nvalid = max(0, min(window, kb_end - kb_begin - t * window));
    if (rotate_x) {  // block-uniform
      for (int w = ws; w < nvalid; w += fw)
        for (int m0 = 0; m0 < M; m0 += 4)
          rotate_rows(block_at(t, w), stride, m0, M, lane);
      group_sync();
    }
    for (int w = 0; w < nvalid; ++w) {
      block_rows(wf, seg, block_at(t, w), stride, M, q, acc);
      const int i = t * window + w + 1;  // the next block of the run
      if (kb_begin + i >= kb_end) break;
      if ((i & 1) == 0)
        pl.load(plane2, plane1, scales, zps, n, N, KB, kb_begin + i, kb_end,
                q, fivelevel);
      const bool odd = i & 1;
      block_decode<kMode, kRotW>(
          odd ? pl.b2[1] : pl.b2[0], odd ? pl.b1[1] : pl.b1[0],
          odd ? pl.sc[1] : pl.sc[0], scales, (long long)n * KB + kb_begin + i,
          n < N, nsub, lg, fivelevel, lane, wf, seg);
    }
    if (!whole) group_sync();  // window t + 2 may land in this buffer
  }

  // each row's sum over the quad; lane m % 4 stores row m
#pragma unroll
  for (int m = 0; m < kMaxM; ++m) {
    if (m >= M) break;
    float v = acc[m] + __shfl_xor_sync(FULL_MASK, acc[m], 1);
    v += __shfl_xor_sync(FULL_MASK, v, 2);
    if ((m & 3) != q) continue;
    if (nsplit > 1)
      sums[(s * features + f) * M + m] = v;
    else if (n < N)
      out[(long long)m * N + n] = v;
  }
  if (nsplit == 1) return;
  __syncthreads();
  for (int t = threadIdx.x; t < features * M; t += blockDim.x) {
    const int ff = t / M, m = t % M, nn = blockIdx.x * features + ff;
    if (nn >= N) continue;
    float sum = sums[ff * M + m];
    for (int sp = 1; sp < nsplit; ++sp)  // in split order
      sum += sums[(sp * features + ff) * M + m];
    out[(long long)m * N + nn] = sum;
  }
}

// Grid (ceil(N / features), E) blocks of features / 8 x splits warps,
// blockIdx.y the expert of a stack of E matrices (E = 1: one matrix), its
// operands at the strides `es` (in elements) from the base pointers; the KB
// blocks are cut into splits runs of ceil(KB / splits), which must leave
// none empty, and x staged in windows of `window` blocks of each run
// (clamped to the run; whole when it covers the run, else two buffers).
// sub_blocks is 0 or any divisor of 256; rotate (weights mode) and
// rotate_x exclude each other. x must be 16-byte aligned, and the staged
// windows and the splits' sums must fit the block's shared memory.
extern "C" int itq3_matvec_launch(const float* x, const uint8_t* plane2,
                                  const uint8_t* plane1, const __half* scales,
                                  const __half* zps, float* out, int M, int N,
                                  int KB, int rotate, int fivelevel,
                                  int sub_blocks, int features, int splits,
                                  int window, int rotate_x, int E,
                                  long long sx, long long splane2,
                                  long long splane1, long long sscales,
                                  long long szps, long long sout,
                                  cudaStream_t stream) {
  if (M < 1 || M > kMaxM || N < 1 || KB < 1 || splits < 1 || splits > KB ||
      (features != 8 && features != 16 && features != 32) ||
      features / 8 * splits > kMaxWarps || sub_blocks < 0 ||
      sub_blocks > 256 || (sub_blocks && 256 % sub_blocks) || window < 1 ||
      (rotate && rotate_x) || ((uintptr_t)x & 15) || E < 1 || E > 65535 ||
      (sx & 3))
    return (int)cudaErrorInvalidValue;
  const ExpertStrides es = {sx, 0, splane2, splane1, sscales, szps, sout};
  const int kbps = (KB + splits - 1) / splits;
  if ((KB + kbps - 1) / kbps != splits) return (int)cudaErrorInvalidValue;
  window = window < kbps ? window : kbps;
  const long long staged = window < kbps ? 2LL * splits * M * window
                                         : (long long)M * KB;  // blocks
  const long long smem =
      4LL * (staged * kXBlock + (splits > 1 ? splits * features * M : 0));
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + features - 1) / features, E);
  const dim3 block(32 * features / 8 * splits);
#define MATVEC_LAUNCH(MODE, ROTW)                                            \
  do {                                                                       \
    const cudaError_t err = cudaFuncSetAttribute(                            \
        itq3_matvec_kernel<MODE, ROTW>,                                      \
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);             \
    if (err != cudaSuccess) return (int)err;                                 \
    itq3_matvec_kernel<MODE, ROTW><<<grid, block, smem, stream>>>(           \
        x, plane2, plane1, scales, zps, out, M, N, KB, kbps, window,         \
        fivelevel, sub_blocks, features, rotate_x, es);                      \
  } while (0)
  const int mode = int8_scale_mode(sub_blocks);
  if (rotate) {
    switch (mode) {
      case kBlock: MATVEC_LAUNCH(kBlock, true); break;
      case kSub32: MATVEC_LAUNCH(kSub32, true); break;
      default: MATVEC_LAUNCH(kSubAny, true); break;
    }
  } else {
    switch (mode) {
      case kBlock: MATVEC_LAUNCH(kBlock, false); break;
      case kSub32: MATVEC_LAUNCH(kSub32, false); break;
      default: MATVEC_LAUNCH(kSubAny, false); break;
    }
  }
#undef MATVEC_LAUNCH
  return (int)cudaGetLastError();
}
