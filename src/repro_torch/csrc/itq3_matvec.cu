// Decode-shaped fused ITQ3_S matvec, M <= 16: out (M, N) = x (M, KB*256) @
// W_hat, W_hat decoded from the packed planes on the fly.
//
// Replaces: repro/kernels/itq3_matvec.py itq3_matvec_pallas
// (_itq3_matvec_kernel, with dequant_rotate_tile from itq3_matmul.py).
// Bound on the H100: bytes. Each weight is touched once per call at 3.125
// bits and used for only M <= 16 multiply-adds, far below the f32 rate, so
// the design streams the planes exactly once: one warp per output feature
// n walks its KB blocks in ascending K, each lane decoding 8 weights from a
// coalesced 2-byte plane2 load (plus 2 plane1 bytes for the five-level
// escape) and reading the fp16 scale and zero-point directly. The block's
// x slice for the current k-block (at most 16 x 256 f32 = 16 KB) sits in
// shared memory for all its warps. With `rotate` (weights mode) the decoded
// block goes through the 256-point butterfly in registers before the dot:
// the paper's fused inverse FWHT. Partial sums stay per lane and are
// reduced across the warp once at the end.
#include "common.cuh"

constexpr int kMaxM = 16;
constexpr int kWarps = 8;

__global__ void __launch_bounds__(32 * kWarps)
itq3_matvec_kernel(const float* __restrict__ x,
                   const uint8_t* __restrict__ plane2,
                   const uint8_t* __restrict__ plane1,
                   const __half* __restrict__ scales,
                   const __half* __restrict__ zps, float* __restrict__ out,
                   int M, int N, int KB, int rotate, int fivelevel,
                   int sub_blocks) {
  extern __shared__ float xs[];  // M x 256
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + warp;
  const long long K = (long long)KB * 256;
  float acc[kMaxM];
#pragma unroll
  for (int m = 0; m < kMaxM; ++m) acc[m] = 0.f;

  for (int kb = 0; kb < KB; ++kb) {
    __syncthreads();  // previous k-block's reads are done
    for (int idx = threadIdx.x; idx < M * 256; idx += blockDim.x)
      xs[idx] = x[(long long)(idx >> 8) * K + (long long)kb * 256 + (idx & 255)];
    __syncthreads();
    if (n < N) {  // warp-uniform
      float w[8];
      itq3_decode_lane(plane2, plane1, scales, zps, (long long)n * KB + kb,
                       sub_blocks, fivelevel, lane, w);
      if (rotate) itq3_butterfly(w, lane);
#pragma unroll
      for (int m = 0; m < kMaxM; ++m) {
        if (m < M) {
          float s = 0.f;
#pragma unroll
          for (int r = 0; r < 8; ++r) s += w[r] * xs[m * 256 + itq3_elem(r, lane)];
          acc[m] += s;
        }
      }
    }
  }
  if (n < N) {
#pragma unroll
    for (int m = 0; m < kMaxM; ++m) {
      if (m < M) {
        const float v = warp_sum(acc[m]);
        if (lane == 0) out[(long long)m * N + n] = v;
      }
    }
  }
}

extern "C" int itq3_matvec_launch(const float* x, const uint8_t* plane2,
                                  const uint8_t* plane1, const __half* scales,
                                  const __half* zps, float* out, int M, int N,
                                  int KB, int rotate, int fivelevel,
                                  int sub_blocks, cudaStream_t stream) {
  if (M < 1 || M > kMaxM || N < 1 || KB < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kWarps - 1) / kWarps);
  const size_t smem = (size_t)M * 256 * sizeof(float);
  itq3_matvec_kernel<<<grid, 32 * kWarps, smem, stream>>>(
      x, plane2, plane1, scales, zps, out, M, N, KB, rotate, fivelevel,
      sub_blocks);
  return (int)cudaGetLastError();
}
