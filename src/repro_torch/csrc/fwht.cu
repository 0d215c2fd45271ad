// Blocked normalized Walsh-Hadamard transform: one warp per `block`-point
// vector, block a power of two from 32 to 256.
//
// Replaces: repro/kernels/fwht_kernel.py fwht_pallas (_fwht_kernel), which
// on the TPU multiplies each (TM, 256) tile by the dense H on the MXU.
// A port of that matmul form would cost 32x the FLOPs of the butterfly; here
// each lane holds V = block/32 values (element v*32 + lane), runs the 5
// lane-bit stages with __shfl_xor_sync and the log2(V) remaining stages in
// registers, in the reference's stage order (warp_fwht_strided in
// common.cuh, shared with quantize_blocks.cu), then scales once.
// Bound on the H100: bytes (read x once, write y once; log2(block) adds per
// element are far below the f32 rate), so loads and stores are coalesced
// 128-byte rows per warp and nothing touches shared memory.
#include "common.cuh"

template <int V>
__global__ void fwht_kernel(const float* __restrict__ x, float* __restrict__ y,
                            long long nvec, float scale) {
  const int lane = threadIdx.x & 31;
  const long long vec =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (vec >= nvec) return;  // the whole warp leaves together
  const float* src = x + vec * (V * 32);
  float* dst = y + vec * (V * 32);
  float r[V];
#pragma unroll
  for (int v = 0; v < V; ++v) r[v] = src[v * 32 + lane];
  warp_fwht_strided<V>(r, lane);
#pragma unroll
  for (int v = 0; v < V; ++v) dst[v * 32 + lane] = r[v] * scale;
}

extern "C" int fwht_launch(const float* x, float* y, long long nvec, int block,
                           float scale, cudaStream_t stream) {
  const int warps = 8;
  const dim3 threads(32 * warps);
  const dim3 grid((unsigned)((nvec + warps - 1) / warps));
  switch (block) {
    case 32:
      fwht_kernel<1><<<grid, threads, 0, stream>>>(x, y, nvec, scale);
      break;
    case 64:
      fwht_kernel<2><<<grid, threads, 0, stream>>>(x, y, nvec, scale);
      break;
    case 128:
      fwht_kernel<4><<<grid, threads, 0, stream>>>(x, y, nvec, scale);
      break;
    case 256:
      fwht_kernel<8><<<grid, threads, 0, stream>>>(x, y, nvec, scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
