// Blocked normalized Walsh-Hadamard transform of `block`-point vectors,
// block any power of two from 2 to 1024, and the two rotate-and-encode
// forms the serving path needs from it.
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
// lanes. fwht_launch runs it alone: at 256 points before every float
// prefill projection, at head_dim points for the attention's query and
// output rotations.
//
// fwht_act_encode_launch (the W3A8 activation codec, the reference's
// core/act_quant.py act_encode after the FWHT) and fwht_kv_encode_launch
// (the KV codec, serve/kv_quant.py kv_encode, K and V of a layer in one
// grid) rotate, take each row's or vector's NaN-propagating absmax, and
// write int8 codes and the scale in the same launch: the plain version is
// a dozen elementwise kernels after the rotation. Both scales are
// amax * fl32(1/127) (the jitted reference's rounding), the codes
// rint(x / safe) clamped to +-127, each op rounded once as its plain
// counterpart is, so the bits are the plain version's.
// Bound on the H100: bytes (read x once, write y or the codes once;
// log2(block) adds per element are far below the f32 rate); at serving
// shapes every launch is a few microseconds of launch and one round trip,
// so the design keeps one launch per projection or layer and no second
// pass over device memory where the row fits in registers.
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
__device__ __forceinline__ float lane_fwht(float r, int lane) {
#pragma unroll
  for (int h = 1; h < B; h <<= 1)  // as warp_fwht_strided's lane stages
    r = __fmaf_rn((lane & h) ? -1.f : 1.f, r, __shfl_xor_sync(FULL_MASK, r, h));
  return r;
}

template <int B>
__global__ void fwht_small_kernel(const float* __restrict__ x,
                                  float* __restrict__ y, long long nelem,
                                  float scale) {
  const int lane = threadIdx.x & 31;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const float r = lane_fwht<B>(e < nelem ? x[e] : 0.f, lane);
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

// --- the codecs --------------------------------------------------------

// max as torch.amax and jnp.max take it: a NaN on either side wins
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// torch.clamp: a NaN passes through
__device__ __forceinline__ float nan_clamp(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// clamp(round(x / safe), -127, 127) as int8: a true division, rounded
// half to even as torch.round and jnp.round do
__device__ __forceinline__ int8_t int8_code(float x, float safe) {
  return (int8_t)__float2int_rn(
      nan_clamp(rintf(__fdiv_rn(x, safe)), -127.f, 127.f));
}

// The W3A8 activation codec: one block of threads per row of x (M, K),
// W = min(KB, 8) warps over the row's KB = ceil(K / 256) blocks (the tail
// past K reads as zeros, the reference's padding). Warp w rotates blocks
// w, w + W, ... in the strided layout of fwht_kernel<8> with the same
// 1/16, and keeps the first NB of them in registers; a row longer than
// NB * W blocks rotates the rest once for the max and again for the codes
// (the same bits). The row max goes through shared memory; the codes of a
// block are staged there as bytes and leave as 16 16-byte stores.
constexpr int kActBlock = 256;
constexpr int kActMaxWarps = 8;

template <bool kRotate>
__device__ __forceinline__ float act_load_block(const float* __restrict__ xr,
                                                int K, int b, int lane,
                                                float r[8]) {
  float m = 0.f;
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const int e = b * kActBlock + v * 32 + lane;
    r[v] = e < K ? __ldg(xr + e) : 0.f;
  }
  if (kRotate) {
    warp_fwht_strided<8>(r, lane);
#pragma unroll
    for (int v = 0; v < 8; ++v) r[v] *= 0.0625f;  // 1/sqrt(256), exact
  }
#pragma unroll
  for (int v = 0; v < 8; ++v) m = nan_max(m, fabsf(r[v]));
  return m;
}

__device__ __forceinline__ void act_store_block(const float r[8], float safe,
                                                int8_t* stage,
                                                int8_t* __restrict__ dst,
                                                int lane) {
#pragma unroll
  for (int v = 0; v < 8; ++v) stage[v * 32 + lane] = int8_code(r[v], safe);
  __syncwarp();
  if (lane < kActBlock / 16)
    reinterpret_cast<uint4*>(dst)[lane] =
        reinterpret_cast<const uint4*>(stage)[lane];
  __syncwarp();
}

template <int NB, bool kRotate>
__global__ void __launch_bounds__(32 * kActMaxWarps)
    fwht_act_encode_kernel(const float* __restrict__ x,
                           int8_t* __restrict__ codes,
                           float* __restrict__ scale, int K, int KB,
                           float recip) {
  __shared__ float warp_amax[kActMaxWarps];
  __shared__ __align__(16) int8_t stage[kActMaxWarps][kActBlock];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  const long long row = blockIdx.x;
  const float* xr = x + row * K;
  int8_t* cr = codes + row * KB * kActBlock;
  float r[NB][8];
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int b = warp + j * W;  // uniform across the warp
    if (b < KB) m = nan_max(m, act_load_block<kRotate>(xr, K, b, lane, r[j]));
  }
#pragma unroll 1
  for (int b = warp + NB * W; b < KB; b += W) {
    float t[8];
    m = nan_max(m, act_load_block<kRotate>(xr, K, b, lane, t));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = nan_max(m, __shfl_xor_sync(FULL_MASK, m, o));
  if (lane == 0) warp_amax[warp] = m;
  __syncthreads();
  float amax = warp_amax[0];
  for (int w = 1; w < W; ++w) amax = nan_max(amax, warp_amax[w]);
  const float step = __fmul_rn(amax, recip);
  const float safe = amax > 0.f ? step : 1.f;
  if (threadIdx.x == 0) scale[row] = amax > 0.f ? step : 0.f;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int b = warp + j * W;
    if (b < KB) act_store_block(r[j], safe, stage[warp], cr + b * kActBlock,
                                lane);
  }
#pragma unroll 1
  for (int b = warp + NB * W; b < KB; b += W) {
    float t[8];
    act_load_block<kRotate>(xr, K, b, lane, t);
    act_store_block(t, safe, stage[warp], cr + b * kActBlock, lane);
  }
}

// x (M, K) f32 -> codes (M, KB * 256) int8, scale (M,) f32.
extern "C" int fwht_act_encode_launch(const float* x, int8_t* codes,
                                      float* scale, long long M, int K,
                                      int KB, int rotate, float recip,
                                      cudaStream_t stream) {
  if (M <= 0 || KB <= 0 || K > KB * kActBlock || M > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int warps = KB < kActMaxWarps ? KB : kActMaxWarps;
  const int per_warp = (KB + warps - 1) / warps;
  const dim3 grid((unsigned)M), threads(32 * warps);
#define ACT_LAUNCH(NB)                                                      \
  (rotate ? fwht_act_encode_kernel<NB, true><<<grid, threads, 0, stream>>>( \
                x, codes, scale, K, KB, recip)                              \
          : fwht_act_encode_kernel<NB, false><<<grid, threads, 0, stream>>>( \
                x, codes, scale, K, KB, recip))
  if (per_warp <= 1)
    ACT_LAUNCH(1);
  else if (per_warp <= 2)
    ACT_LAUNCH(2);
  else
    ACT_LAUNCH(4);  // past 4 blocks a warp, the rest rotate twice
#undef ACT_LAUNCH
  return (int)cudaGetLastError();
}

// The KV codec over a layer's K and V, (B, KV, T, HD) f32 each with the
// last axis contiguous and the others at any stride (V arrives as a
// transpose), into codes (2, B, KV, T, HD) int8 and scales (2, B, KV, T)
// fp16: vector n of the 2 * nvec is K's for n < nvec, else V's. From 32
// points up one warp takes a vector as fwht_kernel does; below, 32/HD
// vectors share a warp as fwht_small_kernel's do. Per vector: the
// normalized FWHT, the NaN-propagating absmax, scale16 = f16(clamp(amax *
// recip, f16 min normal, f16 max)), codes against the stored scale.
struct KvStrides {
  long long k0, k1, k2, v0, v1, v2;
};

__device__ __forceinline__ const float* kv_vector(
    const float* __restrict__ k, const float* __restrict__ v,
    const KvStrides& s, int KV, int T, long long nvec, long long n) {
  const bool is_v = n >= nvec;
  if (is_v) n -= nvec;
  const long long t = n % T, bh = n / T;
  const long long h = bh % KV, b = bh / KV;
  return is_v ? v + b * s.v0 + h * s.v1 + t * s.v2
              : k + b * s.k0 + h * s.k1 + t * s.k2;
}

__device__ __forceinline__ void kv_scale(float amax, float recip,
                                         __half* scale16, float* safe) {
  const __half s = __float2half_rn(
      nan_clamp(__fmul_rn(amax, recip), 6.103515625e-05f, 65504.f));
  *scale16 = s;
  *safe = __half2float(s);
}

template <int V>
__global__ void fwht_kv_encode_kernel(const float* __restrict__ k,
                                      const float* __restrict__ v,
                                      KvStrides s, int KV, int T,
                                      long long nvec,
                                      int8_t* __restrict__ codes,
                                      __half* __restrict__ scales,
                                      float norm, float recip) {
  const int lane = threadIdx.x & 31;
  const long long n =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (n >= 2 * nvec) return;  // the whole warp leaves together
  const float* src = kv_vector(k, v, s, KV, T, nvec, n);
  float r[V];
#pragma unroll
  for (int i = 0; i < V; ++i) r[i] = src[i * 32 + lane];
  warp_fwht_strided<V>(r, lane);
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    r[i] *= norm;
    m = nan_max(m, fabsf(r[i]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = nan_max(m, __shfl_xor_sync(FULL_MASK, m, o));
  __half s16;
  float safe;
  kv_scale(m, recip, &s16, &safe);
  int8_t* dst = codes + n * (V * 32);
#pragma unroll
  for (int i = 0; i < V; ++i) dst[i * 32 + lane] = int8_code(r[i], safe);
  if (lane == 0) scales[n] = s16;
}

template <int HD>
__global__ void fwht_kv_encode_small_kernel(const float* __restrict__ k,
                                            const float* __restrict__ v,
                                            KvStrides s, int KV, int T,
                                            long long nvec,
                                            int8_t* __restrict__ codes,
                                            __half* __restrict__ scales,
                                            float norm, float recip) {
  const int lane = threadIdx.x & 31;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n = e / HD;
  const int i = lane & (HD - 1);
  const bool live = n < 2 * nvec;
  float r = live ? kv_vector(k, v, s, KV, T, nvec, n)[i] : 0.f;
  r = lane_fwht<HD>(r, lane) * norm;
  float m = fabsf(r);
#pragma unroll
  for (int o = 1; o < HD; o <<= 1)  // within the vector's lanes
    m = nan_max(m, __shfl_xor_sync(FULL_MASK, m, o));
  __half s16;
  float safe;
  kv_scale(m, recip, &s16, &safe);
  if (!live) return;
  codes[e] = int8_code(r, safe);
  if (i == 0) scales[n] = s16;
}

extern "C" int fwht_kv_encode_launch(
    const float* k, const float* v, long long k0, long long k1, long long k2,
    long long v0, long long v1, long long v2, int KV, int T, long long nvec,
    int hd, int8_t* codes, __half* scales, float norm, float recip,
    cudaStream_t stream) {
  if (nvec <= 0 || KV <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  const KvStrides s{k0, k1, k2, v0, v1, v2};
  const int warps = 8;
  const dim3 threads(32 * warps);
  const dim3 grid((unsigned)((2 * nvec + warps - 1) / warps));
  const dim3 small_grid(
      (unsigned)((2 * nvec * hd + 32 * warps - 1) / (32 * warps)));
  switch (hd) {
#define KV_SMALL(B)                                                          \
  case B:                                                                    \
    fwht_kv_encode_small_kernel<B><<<small_grid, threads, 0, stream>>>(      \
        k, v, s, KV, T, nvec, codes, scales, norm, recip);                   \
    break;
    KV_SMALL(2) KV_SMALL(4) KV_SMALL(8) KV_SMALL(16)
#undef KV_SMALL
#define KV_WARP(B)                                                           \
  case B:                                                                    \
    fwht_kv_encode_kernel<B / 32><<<grid, threads, 0, stream>>>(             \
        k, v, s, KV, T, nvec, codes, scales, norm, recip);                   \
    break;
    KV_WARP(32) KV_WARP(64) KV_WARP(128) KV_WARP(256) KV_WARP(512)
    KV_WARP(1024)
#undef KV_WARP
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
