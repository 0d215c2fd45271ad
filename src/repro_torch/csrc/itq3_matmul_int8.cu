// Tiled W3A8 matmul for M > 16: out (M, N) = xscale * sum_b d_{n,b} *
// (xq[m, b] . wint[n, b]), xq the int8 rotation-domain activation codes and
// wint = q - z the exact int8 weights decoded from the packed planes.
//
// Replaces: repro/kernels/itq3_matmul.py itq3_matmul_int8_pallas
// (_itq3_matmul_int8_kernel flat / _itq3_matmul_int8_hoisted_kernel, with
// decode_wint_tile and _accumulate_int8).
// Bound on the H100: a 256-row prefill wave does 2*M int8 operations per
// weight, which the integer tensor cores take at up to 1,979 TOP/s, so
// bytes and operations are within a few times of each other; the design is
// the simple tensor-core one. Each block owns a 64 x 32 output tile and 4
// warps (16 rows x 32 columns each). Per k-block it stages the 64 x 256
// int8 activation tile (16-byte copies) and decodes the 32 x 256 int8 wint
// tile (one warp per row, common.cuh's lane layout) into shared memory with
// rows padded to 272 bytes, so the fragment loads below hit 32 distinct
// banks. The contraction is the integer MMA
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 (exact): one k32 step is
// one 32-element sub-block, so the int32 fragment is scaled by d_sub after
// each step (itq3_s_sub), or by d after all 8 steps of the block, converted
// to f32 and added in ascending K without FMA contraction; xscale
// multiplies once at the end. That is the plain version's order to the
// last bit. wgmma, TMA staging and a persistent tile order are later work.
#include "common.cuh"

constexpr int kTM = 64, kTN = 32, kLD = 272;  // 256 + 16 bytes of padding
constexpr int kThreads = 128;

__device__ __forceinline__ void mma_s8(int c[4], const int a[4], int b0,
                                       int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads)
itq3_matmul_int8_kernel(const int8_t* __restrict__ xq,
                        const float* __restrict__ xscale,
                        const uint8_t* __restrict__ plane2,
                        const uint8_t* __restrict__ plane1,
                        const __half* __restrict__ scales,
                        const __half* __restrict__ zps,
                        float* __restrict__ out, int M, int N, int KB,
                        int fivelevel, int sub_blocks) {
  __shared__ __align__(16) uint8_t xs[kTM * kLD];
  __shared__ __align__(16) uint8_t ws[kTN * kLD];
  __shared__ float sd[kTN * 8];
  const int m0 = blockIdx.y * kTM, n0 = blockIdx.x * kTN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;  // MMA group / thread in group
  const long long K = (long long)KB * 256;
  const int nsub = sub_blocks ? sub_blocks : 1;
  const int steps = 8 / nsub;  // k32 steps per scale group
  float acc[4][4];
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[t][i] = 0.f;

  for (int kb = 0; kb < KB; ++kb) {
    __syncthreads();  // previous k-block's tiles are consumed
    for (int idx = threadIdx.x; idx < kTM * 16; idx += kThreads) {
      const int r = idx >> 4, q = idx & 15, m = m0 + r;
      int4 v = make_int4(0, 0, 0, 0);
      if (m < M)
        v = reinterpret_cast<const int4*>(xq + m * K + (long long)kb * 256)[q];
      reinterpret_cast<int4*>(xs + r * kLD)[q] = v;
    }
    for (int rr = warp; rr < kTN; rr += kThreads / 32) {  // warp-uniform rows
      const int n = n0 + rr;
      const long long blk = (long long)n * KB + kb;
      int w[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      if (n < N)
        itq3_decode_wint_lane(plane2, plane1, zps, blk, sub_blocks, fivelevel,
                              lane, w);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<unsigned short*>(ws + rr * kLD + c * 64 + 2 * lane) =
            (unsigned short)((w[2 * c] & 0xff) | ((w[2 * c + 1] & 0xff) << 8));
      if (lane < nsub)
        sd[rr * 8 + lane] =
            n < N ? __half2float(scales[blk * nsub + lane]) : 0.f;
    }
    __syncthreads();
    const uint8_t* xa = xs + (warp * 16 + gid) * kLD + 4 * tig;
    for (int g = 0; g < nsub; ++g) {
      int c[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) c[t][i] = 0;
      for (int st = 0; st < steps; ++st) {
        const int k0 = (g * steps + st) * 32;
        const int a[4] = {
            *reinterpret_cast<const int*>(xa + k0),
            *reinterpret_cast<const int*>(xa + 8 * kLD + k0),
            *reinterpret_cast<const int*>(xa + k0 + 16),
            *reinterpret_cast<const int*>(xa + 8 * kLD + k0 + 16)};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const uint8_t* wb = ws + (t * 8 + gid) * kLD + 4 * tig + k0;
          mma_s8(c[t], a, *reinterpret_cast<const int*>(wb),
                 *reinterpret_cast<const int*>(wb + 16));
        }
      }
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = t * 8 + 2 * tig + (i & 1);
          acc[t][i] = scaled_add(acc[t][i], c[t][i], sd[col * 8 + g]);
        }
    }
  }
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + warp * 16 + gid + 8 * (i >> 1);
      const int n = n0 + t * 8 + 2 * tig + (i & 1);
      if (m < M && n < N)
        out[(long long)m * N + n] = __fmul_rn(acc[t][i], xscale[m]);
    }
}

extern "C" int itq3_matmul_int8_launch(const int8_t* xq, const float* xscale,
                                       const uint8_t* plane2,
                                       const uint8_t* plane1,
                                       const __half* scales, const __half* zps,
                                       float* out, int M, int N, int KB,
                                       int fivelevel, int sub_blocks,
                                       cudaStream_t stream) {
  if (M < 1 || N < 1 || KB < 1) return (int)cudaErrorInvalidValue;
  if (sub_blocks != 0 && sub_blocks != 2 && sub_blocks != 4 && sub_blocks != 8)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kTN - 1) / kTN, (M + kTM - 1) / kTM);
  itq3_matmul_int8_kernel<<<grid, kThreads, 0, stream>>>(
      xq, xscale, plane2, plane1, scales, zps, out, M, N, KB, fivelevel,
      sub_blocks);
  return (int)cudaGetLastError();
}
