// Shared device helpers for the ITQ3_S kernels: warp reductions, the
// planar 3-bit decode (one 256-element block to floats across a warp, or
// one 16-byte plane unit to the exact int8 `wint = q - z`), cp.async
// copies, and two Walsh-Hadamard butterflies on a warp's registers: one
// over the decode layout below, one over the strided layout of fwht.cu
// and quantize_blocks.cu (lane L holds element v*32 + L).
//
// Lane layout of one decoded block (32 lanes x 8 values): lane L holds
// elements e = c*64 + 2*L + j for c in 0..3, j in 0..1, in register
// r = 2*c + j. Plane2 byte i carries elements {i, 64+i, 128+i, 192+i}, so
// lane L reads plane2 bytes 2L and 2L+1 (one coalesced 2-byte load) and
// gets all 8 of its payloads. Element bits: bit 0 = j (register), bits
// 1..5 = lane bits 0..4 (shuffles), bits 6..7 = c (register).
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

// Element index held in register r by `lane` (see the layout above).
__device__ __forceinline__ int itq3_elem(int r, int lane) {
  return (r >> 1) * 64 + 2 * lane + (r & 1);
}

// Decode block `blk` (= n*KB + kb) into w[8]: d*(q - z), or d_sub*q with
// sub-block scales, with q the ternary payload (or the five-level value
// when `fivelevel`). For plain ternary formats plane1 carries a parity bit
// and must not be read as an escape.
__device__ __forceinline__ void itq3_decode_lane(
    const uint8_t* __restrict__ plane2, const uint8_t* __restrict__ plane1,
    const __half* __restrict__ scales, const __half* __restrict__ zps,
    long long blk, int sub_blocks, int fivelevel, int lane, float w[8]) {
  const uint8_t* p2 = plane2 + blk * 64;
  const unsigned short b2 =
      *reinterpret_cast<const unsigned short*>(p2 + 2 * lane);
  const unsigned q2[2] = {b2 & 0xffu, (unsigned)(b2 >> 8)};
  unsigned q1[2] = {0u, 0u};
  if (fivelevel) {
    const uint8_t* p1 = plane1 + blk * 32;
    q1[0] = p1[(2 * lane) & 31];
    q1[1] = p1[(2 * lane + 1) & 31];
  }
  const int hi = lane >= 16;  // elements c*64 + 32..63 sit in odd plane1 bits
  float d = 0.f, z = 0.f;
  if (!sub_blocks) {
    d = __half2float(scales[blk]);
    z = __half2float(zps[blk]);
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int c = r >> 1, j = r & 1;
    int q = (int)((q2[j] >> (2 * c)) & 3u) - 1;
    if (fivelevel) q *= 1 + (int)((q1[j] >> (2 * c + hi)) & 1u);
    if (sub_blocks) {
      const int s = itq3_elem(r, lane) / (256 / sub_blocks);
      w[r] = __half2float(scales[blk * sub_blocks + s]) * (float)q;
    } else {
      w[r] = d * ((float)q - z);
    }
  }
}

constexpr unsigned kZeroCodes = 0x55555555u;  // every 2-bit payload 1: q = 0

// The int8 kernels' scale modes: d per block; itq3_s_sub's 8 sub-blocks of
// 32 elements (the serving one); any other divisor of 256, off the
// serving path.
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
// shuffle, then register bits. (a, b) -> (a+b, a-b) at every stage.
template <int V>
__device__ __forceinline__ void warp_fwht_strided(float r[V], int lane) {
#pragma unroll
  for (int h = 1; h < 32; h <<= 1) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float o = __shfl_xor_sync(FULL_MASK, r[v], h);
      r[v] = (lane & h) ? (o - r[v]) : (r[v] + o);
    }
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
