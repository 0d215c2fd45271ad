// Decode-shaped W3A8 matvec, M <= 16: out (M, N) = xscale * sum_b d_{n,b} *
// (xq[m, b] . wint[n, b]) with xq the int8 rotation-domain activation codes
// and wint = q - z the exact int8 weights decoded from the packed planes.
//
// Replaces: repro/kernels/itq3_matvec.py itq3_matvec_int8_pallas
// (_itq3_matvec_int8_kernel with decode_wint_tile and _accumulate_int8).
//
// What binds. Bytes, and in practice latency: each weight's 2-bit payload
// is read once (plane1 only for the five-level itq3_x; the zero-point only
// without sub-blocks), with its block's scales, for M <= 16 int8 MACs each,
// far below the __dp4a rate. At smollm-135m's shapes a launch reads a few
// hundred kilobytes, so its time is the number of dependent round trips
// to memory and how many SMs have work. The design:
//
// - Work. A block owns `features` output features (8 per warp) and cuts K
//   into `splits` runs of ceil(KB / splits) blocks, one per warp of the
//   block (kernels/itq3.py matvec_int8_tiles). A quad of lanes owns one
//   feature; lane q of it reads plane2 bytes 16q..16q+15 of each block of
//   its run (a quarter of the 64-byte row, one 16-byte load) and holds
//   elements c*64 + 16q + j (c = 0..3, j = 0..15), decoded bytewise to
//   wint (common.cuh) and packed four to a word in ascending j.
// - Loads. A lane issues the loads of up to two blocks of its run (and
//   plane1's, the zero-points and the scales) before any math, and before
//   the block stages the (M, K) codes in shared memory once per launch
//   (cp.async, 16 bytes), so a launch pays about one round trip.
// - Math. Per row, four 16-byte shared loads give the codes that match
//   the lane's four words of each chunk (the quads of a warp read the same
//   addresses: a broadcast), and __dp4a contracts them. The int32 partial
//   of a block, or of each sub-block, is exact: whole blocks and 64-, 128-
//   or 256-element sub-blocks are summed over the quad, itq3_s_sub's
//   32-element ones over lane pairs, narrower ones lie inside one lane and
//   are taken from it by a shuffle (the segmented reduction). The partials
//   are scaled by d, f32(P) * d, and added in ascending K, each product and
//   each sum rounded on its own (scaled_add).
// - Splits. Each warp leaves its run's sums in shared memory; they are
//   added in ascending split order, then multiplied by xscale: the bits of
//   kernels/itq3.py itq3_matmul_int8_split_ref at the same cut.
// - Experts. A stack of E matrices with their E inputs (the MoE expert
//   projections) is one launch: blockIdx.y picks the expert, whose
//   operands lie at fixed strides from the base pointers; E = 1 gives the
//   one matrix's bits.
#include "common.cuh"

constexpr int kMaxM = 16;
constexpr int kMaxWarps = 8;    // features / 8 x splits
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ int quad_isum(int v) {
  v += __shfl_xor_sync(FULL_MASK, v, 1);
  return v + __shfl_xor_sync(FULL_MASK, v, 2);
}

// 32-element sub-blocks: lanes 0-1 of a quad hold sub-block 2c of chunk
// c, lanes 2-3 sub-block 2c + 1.
template <typename D>
__device__ __forceinline__ float sub32_chain(float acc, const int pc[4],
                                             int q, D dsub) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int v = pc[c] + __shfl_xor_sync(FULL_MASK, pc[c], 1);
    const int o = __shfl_xor_sync(FULL_MASK, v, 2);
    acc = scaled_add(acc, q < 2 ? v : o, dsub(2 * c));
    acc = scaled_add(acc, q < 2 ? o : v, dsub(2 * c + 1));
  }
  return acc;
}

// Row m's int32 partials of one block, per chunk c: this lane's four
// words of wint against the codes at xr (its 16 elements of each chunk),
// and the codes themselves.
__device__ __forceinline__ void chunk_partials(const uint8_t* __restrict__ xr,
                                               const unsigned (&w)[4][4],
                                               unsigned (&xw)[4][4],
                                               int (&pc)[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint4 xv = *reinterpret_cast<const uint4*>(xr + 64 * c);
    xw[c][0] = xv.x;
    xw[c][1] = xv.y;
    xw[c][2] = xv.z;
    xw[c][3] = xv.w;
    int p = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) p = __dp4a((int)xw[c][k], (int)w[c][k], p);
    pc[c] = p;
  }
}

// Any other divisor of 256 (off the serving path): sub-blocks of 2^lg
// elements, in ascending K, scales read at use.
template <typename D>
__device__ __forceinline__ float sub_any_chain(float acc,
                                               const unsigned (&w)[4][4],
                                               const unsigned (&xw)[4][4],
                                               const int (&pc)[4], int lg,
                                               int lane, D dsub) {
  const int q = lane & 3, pm = (1 << lg) - 1;
  if (lg >= 6) {  // whole chunks, summed over the quad
    int v = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      v += pc[c];
      if ((((c + 1) << 6) & pm) == 0) {
        acc = scaled_add(acc, quad_isum(v), dsub((c << 6) >> lg));
        v = 0;
      }
    }
    return acc;
  }
  if (lg == 5) return sub32_chain(acc, pc, q, dsub);
  // at most 16 elements: whole sub-blocks inside each lane's 16 of a
  // chunk; the lanes' partials taken in order by shuffles
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    int own[16], p = 0;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int k = e >> 2, i = e & 3;
      if (lg >= 2) {
        if (i == 3) p = __dp4a((int)xw[c][k], (int)w[c][k], p);
      } else {
        p = __dp4a((int)xw[c][k], (int)(w[c][k] & (0xffu << (8 * i))), p);
      }
      own[e] = p;
      if (((e + 1) & pm) == 0) p = 0;
    }
    for (int qq = 0; qq < 4; ++qq)
#pragma unroll
      for (int e = 0; e < 16; ++e)
        if (((e + 1) & pm) == 0) {
          const int v = __shfl_sync(FULL_MASK, own[e], (lane & ~3) | qq);
          acc = scaled_add(acc, v, dsub((c * 64 + 16 * qq + e) >> lg));
        }
  }
  return acc;
}

template <int kMode>
__global__ void __launch_bounds__(32 * kMaxWarps, 2)
itq3_matvec_int8_kernel(const int8_t* __restrict__ xq,
                        const float* __restrict__ xscale,
                        const uint8_t* __restrict__ plane2,
                        const uint8_t* __restrict__ plane1,
                        const __half* __restrict__ scales,
                        const __half* __restrict__ zps,
                        float* __restrict__ out, int M, int N, int KB,
                        int kb_per_split, int fivelevel, int sub_blocks,
                        int features, ExpertStrides es) {
  extern __shared__ __align__(16) uint8_t smem[];  // (M, K) codes, then sums
  const long long K = (long long)KB * 256;
  // the expert (0 for one matrix): its codes staged below, its planes from
  // its first block on (every plane's stride is es.zps blocks, checked at
  // launch, so one offset serves the four and no plane pointer is held in
  // registers across the loop), its outputs and row scales at the end
  const long long ex = blockIdx.y;
  const long long blk0 = ex * es.zps;
  xq += ex * es.x;
  float* sums = reinterpret_cast<float*>(smem + M * K);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q = lane & 3;
  const int fw = features >> 3, nsplit = (int)(blockDim.x >> 5) / fw;
  const int f = (warp % fw) * 8 + (lane >> 2), s = warp / fw;
  const int n = blockIdx.x * features + f;
  const int kb_begin = s * kb_per_split;
  const int kb_end = min(KB, kb_begin + kb_per_split);

  RunPlanes<kMode> pl;
  pl.load(plane2, plane1, scales, zps, n, N, KB, kb_begin, kb_end, q,
          fivelevel, blk0);
  for (long long g = threadIdx.x; g < M * K / 16; g += blockDim.x)
    cp_async16(smem + 16 * g, xq + 16 * g, true);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // row m's sum over the run: lane m % 4 of the quad stores it
  auto emit = [&](int m, float v) {
    if ((m & 3) != q) return;
    if (nsplit > 1)
      sums[(s * features + f) * M + m] = v;
    else if (n < N)
      out[ex * es.out + (long long)m * N + n] =
          __fmul_rn(v, xscale[ex * es.xscale + m]);
  };
  if constexpr (kMode == kSubAny) {
    // rows one at a time, each block's planes (L1-resident after the
    // first row) decoded again: small code for the off-path modes
    const int nsub = sub_blocks ? sub_blocks : 1;
    const int lg = 8 - (__ffs(nsub) - 1);  // log2 of the sub-block width
    for (int m = 0; m < M; ++m) {
      float acc = 0.f;
      for (int kb = kb_begin; kb < kb_end; ++kb) {
        if (kb != kb_begin || m) pl.load(plane2, plane1, scales, zps, n, N,
                                         KB, kb, kb + 1, q, fivelevel, blk0);
        const long long blk = blk0 + (long long)n * KB + kb;
        unsigned w[4][4], xw[4][4];
        int pc[4];
        itq3_decode_wint_unit(pl.b2[0], pl.b1[0], 0, q >= 2, fivelevel, w);
        chunk_partials(smem + m * K + (long long)kb * 256 + 16 * q, w, xw,
                       pc);
        acc = sub_any_chain(acc, w, xw, pc, lg, lane, [&](int i) {
          return n < N ? __half2float(scales[blk * nsub + i]) : 0.f;
        });
      }
      emit(m, acc);
    }
  } else {
    float acc[kMaxM];
#pragma unroll
    for (int m = 0; m < kMaxM; ++m) acc[m] = 0.f;
    for (int kb = kb_begin; kb < kb_end; kb += kRunBlocks) {
      if (kb != kb_begin)
        pl.load(plane2, plane1, scales, zps, n, N, KB, kb, kb_end, q,
                fivelevel, blk0);
#pragma unroll
      for (int r = 0; r < kRunBlocks; ++r) {
        if (kb + r >= kb_end) break;  // warp-uniform
        unsigned w[4][4];
        itq3_decode_wint_unit(
            pl.b2[r], pl.b1[r],
            kMode == kBlock ? (int)half_bits(pl.sc[r].y) : 0, q >= 2,
            fivelevel, w);
        float d[8];
        const unsigned h[4] = {pl.sc[r].x, pl.sc[r].y, pl.sc[r].z,
                               pl.sc[r].w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
          d[i] = half_bits(h[i >> 1] >> (16 * (i & 1)));
        const uint8_t* xb = smem + (long long)(kb + r) * 256 + 16 * q;
#pragma unroll
        for (int m = 0; m < kMaxM; ++m) {
          if (m >= M) break;
          unsigned xw[4][4];
          int pc[4];
          chunk_partials(xb + m * K, w, xw, pc);
          if constexpr (kMode == kBlock)
            acc[m] = scaled_add(
                acc[m], quad_isum(pc[0] + pc[1] + pc[2] + pc[3]), d[0]);
          else
            acc[m] = sub32_chain(acc[m], pc, q, [&](int i) { return d[i]; });
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kMaxM; ++m)
      if (m < M) emit(m, acc[m]);
  }
  if (nsplit == 1) return;
  __syncthreads();
  for (int t = threadIdx.x; t < features * M; t += blockDim.x) {
    const int ff = t / M, m = t % M, nn = blockIdx.x * features + ff;
    if (nn >= N) continue;
    float sum = sums[ff * M + m];
    for (int sp = 1; sp < nsplit; ++sp)  // in split order
      sum += sums[(sp * features + ff) * M + m];
    out[ex * es.out + (long long)m * N + nn] =
        __fmul_rn(sum, xscale[ex * es.xscale + m]);
  }
}

// Grid (ceil(N / features), E) blocks of features / 8 x splits warps,
// blockIdx.y the expert of a stack of E matrices (E = 1: one matrix), its
// operands at the strides given (in elements) from the base pointers, the
// planes' all one stride in blocks (as contiguous stacks have them); the KB
// blocks are cut into splits runs of ceil(KB / splits), which must leave
// none empty. sub_blocks is 0 or any divisor of 256. The (M, K) codes and
// the splits' sums must fit the block's shared memory; xq must be 16-byte
// aligned.
extern "C" int itq3_matvec_int8_launch(const int8_t* xq, const float* xscale,
                                       const uint8_t* plane2,
                                       const uint8_t* plane1,
                                       const __half* scales, const __half* zps,
                                       float* out, int M, int N, int KB,
                                       int fivelevel, int sub_blocks,
                                       int features, int splits, int E,
                                       long long sx, long long sxscale,
                                       long long splane2, long long splane1,
                                       long long sscales, long long szps,
                                       long long sout, cudaStream_t stream) {
  if (M < 1 || M > kMaxM || N < 1 || KB < 1 || splits < 1 || splits > KB ||
      (features != 8 && features != 16 && features != 32) ||
      features / 8 * splits > kMaxWarps || sub_blocks < 0 ||
      sub_blocks > 256 || (sub_blocks && 256 % sub_blocks) ||
      ((uintptr_t)xq & 15) || E < 1 || E > 65535 || (sx & 15) ||
      splane2 != 64 * szps || splane1 != 32 * szps ||
      sscales != (sub_blocks ? sub_blocks : 1) * szps)
    return (int)cudaErrorInvalidValue;
  const ExpertStrides es = {sx,     sxscale, splane2, splane1,
                            sscales, szps,   sout};
  const int kbps = (KB + splits - 1) / splits;
  if ((KB + kbps - 1) / kbps != splits) return (int)cudaErrorInvalidValue;
  const long long smem = (long long)M * KB * 256 + 4LL * splits * features * M;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int mode = int8_scale_mode(sub_blocks);
  const dim3 grid((N + features - 1) / features, E);
  const dim3 block(32 * features / 8 * splits);
#define MATVEC_LAUNCH(MODE)                                                  \
  do {                                                                       \
    const cudaError_t err = cudaFuncSetAttribute(                            \
        itq3_matvec_int8_kernel<MODE>,                                       \
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);             \
    if (err != cudaSuccess) return (int)err;                                 \
    itq3_matvec_int8_kernel<MODE><<<grid, block, smem, stream>>>(            \
        xq, xscale, plane2, plane1, scales, zps, out, M, N, KB, kbps,        \
        fivelevel, sub_blocks, features, es);                                \
  } while (0)
  switch (mode) {
    case kBlock: MATVEC_LAUNCH(kBlock); break;
    case kSub32: MATVEC_LAUNCH(kSub32); break;
    default: MATVEC_LAUNCH(kSubAny); break;
  }
#undef MATVEC_LAUNCH
  return (int)cudaGetLastError();
}
