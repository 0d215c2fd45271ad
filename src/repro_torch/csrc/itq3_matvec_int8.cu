// Decode-shaped W3A8 matvec, M <= 16: out (M, N) = xscale * sum_b d_{n,b} *
// (xq[m, b] . wint[n, b]) with xq the int8 rotation-domain activation codes
// and wint = q - z the exact int8 weights decoded from the packed planes.
//
// Replaces: repro/kernels/itq3_matvec.py itq3_matvec_int8_pallas
// (_itq3_matvec_int8_kernel with decode_wint_tile and _accumulate_int8).
// Bound on the H100: bytes. Each weight's 2-bit payload is read once (plane1
// only for the five-level itq3_x; the zero-point only without sub-blocks),
// with its block's scales, and used for M <= 16 int8 MACs, far below the
// int8 rate. Design: one warp per
// output feature n walks its KB blocks in ascending K; lane L owns the
// elements c*64 + 2L + j (c = 0..3, j = 0..1), so one 2-byte plane2 load
// gives all eight payloads (common.cuh), expanded in registers to wint
// and packed four to an int32 in the order (c, j) = (0,0) (0,1) (1,0)
// (1,1) and (2,0) (2,1) (3,0) (3,1). The block's k-block of xq (M x 256
// bytes) sits in shared memory in its natural order, where the same four
// elements are the two bytes at 2L and at 64 + 2L: two 2-byte loads make
// the matching int32, and __dp4a contracts them. The int32 partial of a
// block (or of each 32-, 64- or 128-element sub-block) is reduced across
// the warp exactly, converted to f32 and scaled by d, and the products
// are added in ascending K without FMA contraction; xscale multiplies
// once at the end. That is the plain version's order to the last bit.
#include "common.cuh"

constexpr int kMaxM = 16;
constexpr int kWarps = 8;

// Two bytes of shared memory at byte offsets a and b, as one int32 of four
// int8 lanes: [a, a+1, b, b+1].
__device__ __forceinline__ int pack_pairs(const uint8_t* p, int a, int b) {
  const unsigned lo = *reinterpret_cast<const unsigned short*>(p + a);
  const unsigned hi = *reinterpret_cast<const unsigned short*>(p + b);
  return (int)(lo | (hi << 16));
}

__device__ __forceinline__ int pack_int8(int a, int b, int c, int d) {
  return (int)((unsigned)(a & 0xff) | ((unsigned)(b & 0xff) << 8) |
               ((unsigned)(c & 0xff) << 16) | ((unsigned)(d & 0xff) << 24));
}

__global__ void __launch_bounds__(32 * kWarps)
itq3_matvec_int8_kernel(const int8_t* __restrict__ xq,
                        const float* __restrict__ xscale,
                        const uint8_t* __restrict__ plane2,
                        const uint8_t* __restrict__ plane1,
                        const __half* __restrict__ scales,
                        const __half* __restrict__ zps,
                        float* __restrict__ out, int M, int N, int KB,
                        int fivelevel, int sub_blocks) {
  __shared__ __align__(16) uint8_t xs[kMaxM * 256];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + warp;
  const long long K = (long long)KB * 256;
  const int hi = lane >= 16;
  float acc[kMaxM];
#pragma unroll
  for (int m = 0; m < kMaxM; ++m) acc[m] = 0.f;

  for (int kb = 0; kb < KB; ++kb) {
    __syncthreads();  // previous k-block's reads are done
    for (int idx = threadIdx.x; idx < M * 16; idx += blockDim.x) {
      const int m = idx >> 4, q = idx & 15;  // 16 x 16 bytes per row
      reinterpret_cast<int4*>(xs + m * 256)[q] =
          reinterpret_cast<const int4*>(xq + m * K + (long long)kb * 256)[q];
    }
    __syncthreads();
    if (n >= N) continue;  // warp-uniform
    const long long blk = (long long)n * KB + kb;
    int w[8];
    itq3_decode_wint_lane(plane2, plane1, zps, blk, sub_blocks, fivelevel,
                          lane, w);
    // per c, the two wint of this lane; bytes 2 and 3 zero
    int wc[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) wc[c] = pack_int8(w[2 * c], w[2 * c + 1], 0, 0);
    const int w01 = pack_int8(w[0], w[1], w[2], w[3]);
    const int w23 = pack_int8(w[4], w[5], w[6], w[7]);
    float ds[8];
    if (sub_blocks) {
#pragma unroll
      for (int s = 0; s < 8; ++s)
        ds[s] = s < sub_blocks ? __half2float(scales[blk * sub_blocks + s])
                               : 0.f;
    } else {
      ds[0] = __half2float(scales[blk]);
    }
#pragma unroll
    for (int m = 0; m < kMaxM; ++m) {
      if (m >= M) break;
      const uint8_t* xr = xs + m * 256;
      if (sub_blocks == 0) {
        int p = __dp4a(pack_pairs(xr, 2 * lane, 64 + 2 * lane), w01, 0);
        p = __dp4a(pack_pairs(xr, 128 + 2 * lane, 192 + 2 * lane), w23, p);
        acc[m] = scaled_add(acc[m], warp_isum(p), ds[0]);
        continue;
      }
      int pc[4];  // per c: this lane's two products
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const unsigned xv =
            *reinterpret_cast<const unsigned short*>(xr + c * 64 + 2 * lane);
        pc[c] = __dp4a((int)xv, wc[c], 0);
      }
      if (sub_blocks == 8) {  // 32-element sub-blocks s = 2c + hi
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          int v = pc[c];
#pragma unroll
          for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
          const int other = __shfl_xor_sync(FULL_MASK, v, 16);
          acc[m] = scaled_add(acc[m], hi ? other : v, ds[2 * c]);
          acc[m] = scaled_add(acc[m], hi ? v : other, ds[2 * c + 1]);
        }
      } else if (sub_blocks == 4) {  // 64-element sub-blocks s = c
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[m] = scaled_add(acc[m], warp_isum(pc[c]), ds[c]);
      } else {  // sub_blocks == 2: 128-element sub-blocks s = c / 2
        acc[m] = scaled_add(acc[m], warp_isum(pc[0] + pc[1]), ds[0]);
        acc[m] = scaled_add(acc[m], warp_isum(pc[2] + pc[3]), ds[1]);
      }
    }
  }
  if (n < N && lane == 0) {
#pragma unroll
    for (int m = 0; m < kMaxM; ++m)
      if (m < M) out[(long long)m * N + n] = __fmul_rn(acc[m], xscale[m]);
  }
}

extern "C" int itq3_matvec_int8_launch(const int8_t* xq, const float* xscale,
                                       const uint8_t* plane2,
                                       const uint8_t* plane1,
                                       const __half* scales, const __half* zps,
                                       float* out, int M, int N, int KB,
                                       int fivelevel, int sub_blocks,
                                       cudaStream_t stream) {
  if (M < 1 || M > kMaxM || N < 1 || KB < 1) return (int)cudaErrorInvalidValue;
  if (sub_blocks != 0 && sub_blocks != 2 && sub_blocks != 4 && sub_blocks != 8)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kWarps - 1) / kWarps);
  itq3_matvec_int8_kernel<<<grid, 32 * kWarps, 0, stream>>>(
      xq, xscale, plane2, plane1, scales, zps, out, M, N, KB, fivelevel,
      sub_blocks);
  return (int)cudaGetLastError();
}
