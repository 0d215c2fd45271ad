// Blocked normalized Walsh-Hadamard transform of `block`-point vectors,
// block any power of two from 2 to 1024.
//
// Replaces: repro/kernels/fwht_kernel.py fwht_pallas (_fwht_kernel), which
// on the TPU multiplies each (TM, 256) tile by the dense H on the MXU.
// A port of that matmul form would cost 32x the FLOPs of the butterfly.
// From 32 points up, one warp takes one vector: each lane holds V =
// block/32 values (element v*32 + lane; 32 registers at 1024 points), runs
// the 5 lane-bit stages with __shfl_xor_sync and the log2(V) remaining
// stages in registers, in the reference's stage order (warp_fwht_strided
// in common.cuh, shared with quantize_blocks.cu and itq3_matvec.cu), then
// scales once. Below 32 points a warp takes 32/block whole vectors, one
// element per lane, and every stage is a shuffle within the vector's
// lanes. The serving path runs it at 256 points (the activation rotation
// of prefill and W3A8) and at head_dim points (the KV codec and the
// attention's query and output rotations).
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

// B = 2..16 points: element e of the flat array sits in lane e % 32, so
// a vector's lanes differ only in their low log2(B) bits. Lanes past the
// end still shuffle (on zeros) and store nothing.
template <int B>
__global__ void fwht_small_kernel(const float* __restrict__ x,
                                  float* __restrict__ y, long long nelem,
                                  float scale) {
  const int lane = threadIdx.x & 31;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float r = e < nelem ? x[e] : 0.f;
#pragma unroll
  for (int h = 1; h < B; h <<= 1)  // as warp_fwht_strided's lane stages
    r = __fmaf_rn((lane & h) ? -1.f : 1.f, r, __shfl_xor_sync(FULL_MASK, r, h));
  if (e < nelem) y[e] = r * scale;
}

extern "C" int fwht_launch(const float* x, float* y, long long nvec, int block,
                           float scale, cudaStream_t stream) {
  const int warps = 8;
  const dim3 threads(32 * warps);
  const dim3 grid((unsigned)((nvec + warps - 1) / warps));
  const dim3 small_grid((unsigned)((nvec * block + 32 * warps - 1) /
                                   (32 * warps)));
  switch (block) {
#define FWHT_SMALL(B)                                                       \
  case B:                                                                   \
    fwht_small_kernel<B><<<small_grid, threads, 0, stream>>>(x, y,          \
                                                             nvec * B,      \
                                                             scale);        \
    break;
    FWHT_SMALL(2) FWHT_SMALL(4) FWHT_SMALL(8) FWHT_SMALL(16)
#undef FWHT_SMALL
#define FWHT_WARP(B)                                                        \
  case B:                                                                   \
    fwht_kernel<B / 32><<<grid, threads, 0, stream>>>(x, y, nvec, scale);   \
    break;
    FWHT_WARP(32) FWHT_WARP(64) FWHT_WARP(128) FWHT_WARP(256) FWHT_WARP(512)
    FWHT_WARP(1024)
#undef FWHT_WARP
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
