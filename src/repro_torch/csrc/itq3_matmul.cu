// Tiled fused ITQ3_S matmul for M > 16: out (M, N) = x (M, KB*256) @ W_hat.
//
// Replaces: repro/kernels/itq3_matmul.py itq3_matmul_pallas
// (_itq3_matmul_kernel flat / _itq3_matmul_hoisted_kernel).
// Bound on the H100: operations. A 256-row prefill wave does 2*M FLOPs per
// weight, so at f32 on the CUDA cores (67 TFLOP/s, no tensor cores here:
// TF32 would break the f32 tolerances the port is held to) the
// multiply-adds dominate the 3.125-bit weight stream. Each block owns a
// 32 x 32 output tile; per k-block it stages the 32 x 256 x tile and
// decodes (and, in weights mode, butterflies in registers) the 32 x 256
// weight tile into padded shared memory (2 x 32 x 257 f32 = 64.25 KB, hence
// the dynamic shared-memory attribute), then every thread accumulates a
// 2 x 2 register tile over K ascending, the reference's order. Simple and
// right first: wgmma, TMA staging and split-K are later work.
#include "common.cuh"

constexpr int kTM = 32, kTN = 32, kLD = 257;  // +1 pad: conflict-free columns
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
itq3_matmul_kernel(const float* __restrict__ x,
                   const uint8_t* __restrict__ plane2,
                   const uint8_t* __restrict__ plane1,
                   const __half* __restrict__ scales,
                   const __half* __restrict__ zps, float* __restrict__ out,
                   int M, int N, int KB, int rotate, int fivelevel,
                   int sub_blocks) {
  extern __shared__ float smem[];
  float* xs = smem;             // kTM x kLD
  float* ws = smem + kTM * kLD;  // kTN x kLD
  const int m0 = blockIdx.y * kTM, n0 = blockIdx.x * kTN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long K = (long long)KB * 256;
  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};

  for (int kb = 0; kb < KB; ++kb) {
    __syncthreads();  // previous k-block's tiles are consumed
    for (int idx = threadIdx.x; idx < kTM * 256; idx += kThreads) {
      const int r = idx >> 8, e = idx & 255, m = m0 + r;
      xs[r * kLD + e] = (m < M) ? x[(long long)m * K + (long long)kb * 256 + e] : 0.f;
    }
    for (int rr = warp; rr < kTN; rr += kThreads / 32) {  // warp-uniform rows
      const int n = n0 + rr;
      float w[8];
      if (n < N) {
        itq3_decode_lane(plane2, plane1, scales, zps, (long long)n * KB + kb,
                         sub_blocks, fivelevel, lane, w);
        if (rotate) itq3_butterfly(w, lane);
      } else {
#pragma unroll
        for (int r = 0; r < 8; ++r) w[r] = 0.f;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) ws[rr * kLD + itq3_elem(r, lane)] = w[r];
    }
    __syncthreads();
#pragma unroll 8
    for (int e = 0; e < 256; ++e) {
      const float a0 = xs[ty * kLD + e], a1 = xs[(ty + 16) * kLD + e];
      const float b0 = ws[tx * kLD + e], b1 = ws[(tx + 16) * kLD + e];
      acc[0][0] += a0 * b0;
      acc[0][1] += a0 * b1;
      acc[1][0] += a1 * b0;
      acc[1][1] += a1 * b1;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (m < M && n < N) out[(long long)m * N + n] = acc[i][j];
    }
  }
}

extern "C" int itq3_matmul_launch(const float* x, const uint8_t* plane2,
                                  const uint8_t* plane1, const __half* scales,
                                  const __half* zps, float* out, int M, int N,
                                  int KB, int rotate, int fivelevel,
                                  int sub_blocks, cudaStream_t stream) {
  if (M < 1 || N < 1 || KB < 1) return (int)cudaErrorInvalidValue;
  const int smem = (kTM + kTN) * kLD * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      itq3_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kTN - 1) / kTN, (M + kTM - 1) / kTM);
  itq3_matmul_kernel<<<grid, kThreads, smem, stream>>>(
      x, plane2, plane1, scales, zps, out, M, N, KB, rotate, fivelevel,
      sub_blocks);
  return (int)cudaGetLastError();
}
