// Offline ITQ3_S quantization, paper Algorithm 1, one warp per 256-block:
// rotate, mu, sigma, d = f16(alpha*sigma), z = clip(-round(mu/d), -1, 1),
// codes = clip(round(w'/d) + z, -1, 1) + 1 as uint8 {0, 1, 2}.
//
// Replaces: repro/kernels/quantize_kernel.py quantize_blocks_pallas
// (_quant_kernel), which rotates each (TM, 256) tile by a resident H on the
// MXU. Here each lane holds 8 values (element v*32 + lane, coalesced
// 128-byte rows per warp), the rotation is the register/shuffle butterfly
// of fwht.cu in the plain fwht's stage order (bit-equal to it), and the
// two statistics are warp reductions taken in two passes as the reference
// takes them: the mean, then the mean squared deviation. d rounds through
// f16 (__float2half_rn); rintf rounds half to even like jnp.round, and
// the divisions are IEEE (no fast-math), so only ties in the f32
// statistics (their summation order differs from the plain version's) can
// move a code or a scale.
// Bound on the H100: bytes. Per block it reads 1 KB and writes 260 B, and
// the ~20 operations per element stay far below the f32 rate, so the
// design streams each block through registers once and touches no shared
// memory.
#include "common.cuh"

constexpr int kWarps = 8;

__global__ void __launch_bounds__(32 * kWarps)
quantize_blocks_kernel(const float* __restrict__ wb,
                       uint8_t* __restrict__ codes, __half* __restrict__ dout,
                       __half* __restrict__ zout, long long nb, float alpha) {
  const int lane = threadIdx.x & 31;
  const long long blk =
      (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (blk >= nb) return;  // the whole warp leaves together
  const float* src = wb + blk * 256;
  float r[8];
#pragma unroll
  for (int v = 0; v < 8; ++v) r[v] = src[v * 32 + lane];
  warp_fwht_strided<8>(r, lane);
  float s = 0.f;
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    r[v] *= 0.0625f;  // 1/sqrt(256), exact
    s += r[v];
  }
  const float mu = warp_sum(s) / 256.f;
  float ss = 0.f;
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const float dv = r[v] - mu;
    ss = __fadd_rn(ss, __fmul_rn(dv, dv));  // no FMA: square, then add
  }
  const float var = warp_sum(ss) / 256.f;
  const float sigma = sqrtf(fmaxf(var, 0.f));
  const float d = __half2float(__float2half_rn(alpha * sigma));
  const float safe = d > 0.f ? d : 1.f;
  const float z = fminf(fmaxf(-rintf(mu / safe), -1.f), 1.f);
  uint8_t* dst = codes + blk * 256;
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const float q = fminf(fmaxf(rintf(r[v] / safe) + z, -1.f), 1.f);
    dst[v * 32 + lane] = (uint8_t)(int)(q + 1.f);
  }
  if (lane == 0) {
    dout[blk] = __float2half_rn(d);
    zout[blk] = __float2half_rn(z);
  }
}

extern "C" int quantize_blocks_launch(const float* wb, uint8_t* codes,
                                      __half* d, __half* z, long long nb,
                                      float alpha, cudaStream_t stream) {
  if (nb < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((nb + kWarps - 1) / kWarps));
  quantize_blocks_kernel<<<grid, 32 * kWarps, 0, stream>>>(wb, codes, d, z,
                                                           nb, alpha);
  return (int)cudaGetLastError();
}
