// Shared device helpers for the ITQ3_S kernels: warp reductions, the
// planar 3-bit decode of one 16-byte plane unit to the exact int8
// `wint = q - z`, the matvecs' plane loader (RunPlanes), cp.async copies,
// and two Walsh-Hadamard butterflies on a warp's registers: one over the
// decode layout below (itq3_matmul.cu's weights mode), one over the
// strided layout of fwht.cu, quantize_blocks.cu and itq3_matvec.cu (lane
// L holds element v*32 + L).
//
// Lane layout of one block for itq3_butterfly (32 lanes x 8 values): lane
// L holds elements e = c*64 + 2*L + j for c in 0..3, j in 0..1, in
// register r = 2*c + j. Element bits: bit 0 = j (register), bits 1..5 =
// lane bits 0..4 (shuffles), bits 6..7 = c (register).
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

// acc + d * p for an exact int32 partial p, rounded as two separate f32
// operations (no FMA contraction): the order of the W3A8 plain version,
// which the int8 kernels match to the last bit.
__device__ __forceinline__ float scaled_add(float acc, int p, float d) {
  return __fadd_rn(acc, __fmul_rn((float)p, d));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

constexpr unsigned kZeroCodes = 0x55555555u;  // every 2-bit payload 1: q = 0

// The expert axis of the contraction kernels: expert e of a stack of E
// contractions reads its operands at e times these element strides from
// the base pointers and writes its output likewise (the stacks are
// contiguous (E, M, K) / (E, N, KB, ...) / (E, M, N); itq3_matmul.cu
// addresses an expert by global rows instead and only checks the
// strides). One matrix is E = 1, where e is 0 and nothing moves. `xscale`
// is the int8 pair's row scales (0 for the float kernels).
struct ExpertStrides {
  long long x, xscale, plane2, plane1, scales, zps, out;
};

// The scale modes of the int8 kernels and the float matvec: d per block;
// itq3_s_sub's 8 sub-blocks of 32 elements (the serving one); any other
// divisor of 256, off the serving path.
enum { kBlock = 0, kSub32 = 1, kSubAny = 2 };

__host__ __device__ __forceinline__ int int8_scale_mode(int sub_blocks) {
  return !sub_blocks ? kBlock : sub_blocks == 8 ? kSub32 : kSubAny;
}

// The float value of fp16 bits held in the low half of h.
__device__ __forceinline__ float half_bits(unsigned h) {
  return __half2float(__ushort_as_half((unsigned short)h));
}

// Decode one 16-byte unit of a block into the exact integer weights
// wint = q - z: plane2 bytes i0..i0+15 (b2) hold elements c*64 + i0 + j
// (c = 0..3, j = 0..15) at bits 2c; under the five-level escape plane1
// bytes (i0 & 31).. (b1) hold their doubling bits at bit 2c + hi, hi =
// (i0 >= 32). w[c][k] packs j = 4k..4k+3 as four int8 in ascending j:
// {-2..2} for ternary formats, {-4..4} under the escape; sub-block formats
// pass z = 0. Bytewise SIMD, so no lane borrows from its neighbour.
__device__ __forceinline__ void itq3_decode_wint_unit(uint4 b2, uint4 b1,
                                                      int z, int hi,
                                                      int fivelevel,
                                                      unsigned w[4][4]) {
  const unsigned p2[4] = {b2.x, b2.y, b2.z, b2.w};
  const unsigned p1[4] = {b1.x, b1.y, b1.z, b1.w};
  const unsigned zb = ((unsigned)z & 0xffu) * 0x01010101u;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      unsigned q = __vsub4((p2[k] >> (2 * c)) & 0x03030303u, 0x01010101u);
      if (fivelevel)  // q + (q where the bit is set): each byte 0 or 0xff
        q = __vadd4(q, q & (((p1[k] >> (2 * c + hi)) & 0x01010101u) * 0xffu));
      w[c][k] = __vsub4(q, zb);
    }
  }
}

constexpr int kRunBlocks = 2;  // blocks whose planes a lane holds at once

// The matvecs' plane loader, for their quad layout (lane q of a quad reads
// plane2 bytes 16q..16q+15 of a block). One lane's planes of up to
// kRunBlocks blocks of its run: its 16-byte units, and as fp16 bits d and
// z (kBlock) or the 8 sub-block scales (kSub32). kSubAny reads its scales
// at use.
template <int kMode>
struct RunPlanes {
  uint4 b2[kRunBlocks], b1[kRunBlocks], sc[kRunBlocks];

  // blk0: the first block of this matrix in a stack of them (an expert's
  // index times the stack's stride in blocks; 0 for one matrix)
  __device__ __forceinline__ void load(
      const uint8_t* __restrict__ plane2, const uint8_t* __restrict__ plane1,
      const __half* __restrict__ scales, const __half* __restrict__ zps,
      int n, int N, int KB, int kb, int kb_end, int q, int fivelevel,
      long long blk0 = 0) {
#pragma unroll
    for (int r = 0; r < kRunBlocks; ++r) {
      b2[r] = make_uint4(kZeroCodes, kZeroCodes, kZeroCodes, kZeroCodes);
      b1[r] = sc[r] = make_uint4(0u, 0u, 0u, 0u);  // features past N: zeros
      if (n < N && kb + r < kb_end) {
        const long long blk = blk0 + (long long)n * KB + kb + r;
        b2[r] = __ldg(reinterpret_cast<const uint4*>(plane2 + blk * 64) + q);
        if (fivelevel)
          b1[r] = __ldg(reinterpret_cast<const uint4*>(plane1 + blk * 32) +
                        (q & 1));
        if (kMode == kBlock) {
          sc[r].x = __half_as_ushort(scales[blk]);
          sc[r].y = __half_as_ushort(zps[blk]);
        } else if (kMode == kSub32) {
          sc[r] = __ldg(reinterpret_cast<const uint4*>(scales + blk * 8));
        }
      }
    }
  }
};

// cp.async 16-byte copies, global -> shared, in commit groups; valid =
// false fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {  // all but the newest
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Unnormalized FWHT of a V*32-point vector held as r[v] = element v*32 +
// lane, stages h = 1, 2, 4, ... in the reference's order: lane bits by
// shuffle, then register bits. (a, b) -> (a+b, a-b) at every stage; across
// lanes as one fma with +-1 (the product is exact, so the sum rounds once,
// as a + b and a - b do).
template <int V>
__device__ __forceinline__ void warp_fwht_strided(float r[V], int lane) {
#pragma unroll
  for (int h = 1; h < 32; h <<= 1) {
    const float sgn = (lane & h) ? -1.f : 1.f;  // the upper lane holds b
#pragma unroll
    for (int v = 0; v < V; ++v)
      r[v] = __fmaf_rn(sgn, r[v], __shfl_xor_sync(FULL_MASK, r[v], h));
  }
#pragma unroll
  for (int s = 1; s < V; s <<= 1) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if ((v & s) == 0) {
        const float a = r[v], b = r[v + s];
        r[v] = a + b;
        r[v + s] = a - b;
      }
    }
  }
}

// Normalized 256-point FWHT of the block held in w[8] across the warp,
// stages h = 1, 2, ..., 128 in the reference's order: (a, b) -> (a+b, a-b).
__device__ __forceinline__ void itq3_butterfly(float w[8], int lane) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {  // h = 1: register pair j = 0/1
    const float a = w[2 * c], b = w[2 * c + 1];
    w[2 * c] = a + b;
    w[2 * c + 1] = a - b;
  }
#pragma unroll
  for (int m = 1; m < 32; m <<= 1) {  // h = 2..32: lane bit m
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float o = __shfl_xor_sync(FULL_MASK, w[r], m);
      w[r] = (lane & m) ? (o - w[r]) : (w[r] + o);
    }
  }
#pragma unroll
  for (int s = 1; s < 4; s <<= 1) {  // h = 64, 128: bits of c
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if ((c & s) == 0) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float a = w[2 * c + j], b = w[2 * (c + s) + j];
          w[2 * c + j] = a + b;
          w[2 * (c + s) + j] = a - b;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) w[r] *= 0.0625f;  // 1/sqrt(256), exact
}
