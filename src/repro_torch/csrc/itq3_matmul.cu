// Tiled fused ITQ3_S matmul for M > 16: out (M, N) = x (M, KB*256) @ W_hat,
// on the tensor cores at f32 accuracy.
//
// Replaces: repro/kernels/itq3_matmul.py itq3_matmul_pallas
// (_itq3_matmul_kernel flat / _itq3_matmul_hoisted_kernel, with
// dequant_rotate_tile).
// Bound on the H100: operations. A 256-row prefill wave does 2*M FLOPs per
// weight, far more than the 3.125-bit weight stream costs in bytes, so the
// products go to the TF32 tensor cores (mma.sync m16n8k8, f32 accumulate).
// Plain TF32 keeps 11 significant bits and would miss the 1e-4 agreement
// with the plain version; a split keeps f32 accuracy:
//
// - The weight operand is exact in TF32 in activations mode (the serving
//   path). Block-scaled formats stage wint = q - z ({-2..2}, {-4..4} under
//   the five-level escape) and put d on each 256-block's partial:
//   acc += d[n, kb] * P_kb, the order of the W3A8 kernels. d*(q - z) itself
//   is not always exact (q - z = 3 needs 12 bits). Sub-block formats stage
//   d_sub*q: an fp16 times |q| <= 2, exact, with the scale in the operand.
// - Only x is split: x_hi = tf32_rna(x), x_lo = tf32_rna(x - x_hi), and
//   P += x_hi*w + x_lo*w. The dropped part is ~2^-22 of |x|. The rounding
//   is two integer operations on the f32 bits (cvt.rna.tf32.f32 runs at a
//   quarter of their rate).
// - Weights mode (rotate, off the serving path): each decoded block gets
//   the 256-point inverse FWHT in registers (common.cuh's warp butterfly)
//   on its way to the MMAs, the paper's fusion of the IFWHT into the MMQ
//   load stage. That weight is a general f32, so both operands are split
//   and three products summed: x_hi*w_hi + x_hi*w_lo + x_lo*w_hi.
//
// The sums, in order: within a 64-wide K chunk the MMAs of the x_hi
// products go to one accumulator and the others to a second, so twice as
// many independent MMA chains interleave; with d on the partial, each
// 256-block's two partials are added and acc += d * P, blocks in
// ascending K; otherwise the two accumulators run over all blocks and are
// added at the end. Split partials are added in ascending split order.
//
// Layout. A block owns BM = 16*WM rows x 64 columns of out with 2*WM
// warps: warp (wm, wn) owns rows 16wm..16wm+15 and columns 32wn..32wn+31
// (4 n8 tiles). Each thread splits its x fragment once per k16 step, so an
// x element is split by the two warps that share its rows and each split
// value feeds 4 MMAs (splitting it into shared memory instead would double
// the x ring). Per 256-block of K the block decodes the 64 x 256 weight
// tile into shared memory, one 16-byte plane load per thread (loaded a
// block ahead, under the MMAs) and no int-to-float conversions; the tile
// serves all BM rows. The x tile streams in 64-wide K chunks through a
// 3-deep ring of cp.async 16-byte copies, two chunks ahead of the math.
// Both tiles keep rows of whole 16-byte granules, granule g of row r at g
// ^ s(r) (see swz): a fragment load is one 16-byte read per thread (the
// MMA's k index is permuted within each k16 step, the same for both
// operands, so thread t of a quad reads k = 4t..4t+3), and both those
// loads (2 rows per phase) and the decode's stores (8 rows per phase) hit
// 32 distinct banks.
//
// Split-K. Where the output tiles alone leave SMs idle, the grid's z
// dimension cuts the KB blocks into `splits` runs of kb_per_split, and
// the splits of one output tile form a thread block cluster. Each split
// sums its blocks in ascending K and leaves its partial in its own shared
// memory; after a cluster barrier, block r of the cluster adds the r-th
// slice of all partials in ascending split order through distributed
// shared memory and stores it. No workspace, no atomics: the order, not
// the arrival, fixes the sums, so two calls give the same bits. The
// wrapper picks BM and splits per shape (kernels/itq3.py matmul_tiles).
//
// Experts. A stack of E matrices with their E inputs (the MoE expert
// projections, the vmapped pallas_call's extra grid axis on a TPU) is one
// launch: y walks expert 0's row tiles, then expert 1's. The stacks are
// contiguous, so an expert's rows of x, out and the planes are global
// rows past the previous experts', each bounded by its own expert's end:
// no offset pointer takes registers from the tile (with one, the 64-row
// instantiations passed 128 registers, two no longer fit an SM, and a
// 6-way split ran 1.8x slower). Each tile's arithmetic is the one
// matrix's, so E = 1 gives the same bits; the E x N/64 x M/bm tiles fill
// the card where one matrix's would not, so the cut rule counts them all.
// wgmma and TMA staging are later work.
#include <climits>
#include <cooperative_groups.h>

#include "common.cuh"

constexpr int kBN = 64;       // output columns per block
constexpr int kWN = 2;        // warps across the columns
constexpr int kNT = kBN / (8 * kWN);  // n8 tiles per warp
constexpr int kKC = 64;       // K per staged x chunk (a quarter block)
constexpr int kStages = 3;    // x chunks in the ring
constexpr int kMaxSplits = 8;  // K splits: the portable cluster size

// f32 -> TF32, nearest with ties away from zero (cvt.rna.tf32.f32's
// rounding): half a TF32 ulp added to the magnitude, the 13 low bits
// cleared. Two integer operations at full rate, where the conversion
// instruction runs at a quarter of it. Finite inputs.
__device__ __forceinline__ unsigned tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float v, unsigned& hi,
                                           unsigned& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(__fsub_rn(v, __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float c[4], const unsigned a[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Float offset of 16-byte granule g of row r in a tile of gpr granules per
// row (gpr a multiple of 8), swizzled as described above: g ^ s(r) with
// s(r) = 4*(r & 1) + ((r >> 1) & 3), distinct over 8 consecutive rows.
__device__ __forceinline__ int swz(int r, int g, int gpr) {
  return (r * gpr + (g ^ (((r & 1) << 2) | ((r >> 1) & 3)))) * 4;
}

// What the weight tile holds: kWint = wint, d on the block partial
// (block-scaled, activations mode); kScaledQ = d_sub*q (sub-block,
// activations mode); kRotated = the IFWHT'd d*(q - z) or d_sub*q.
enum { kWint = 0, kScaledQ = 1, kRotated = 2 };

// The ternary value q = code - 1 of the 2-bit code at bit `sh` of w, as an
// exact float without an int-to-float conversion: the code goes into the
// low mantissa bits of 2^23, and 2^23 + 1 comes off.
__device__ __forceinline__ float ternary(unsigned w, int sh) {
  return __uint_as_float(((w >> sh) & 3u) | 0x4b000000u) - 8388609.f;
}

// One thread's share of a block's packed weight tile. A unit is 16 plane2
// bytes of one row, i.e. 16 columns of each of the 4 chunks of 64 (plane2
// byte i holds elements i, 64+i, 128+i, 192+i; plane1 byte i bit b holds
// element b*32 + i): one 16-byte load per plane, with the row's d and z,
// or the unit's 4 sub-block scales. Unit u is row u % 64, bytes
// 16*(u / 64) on, so the 8 lanes of a store phase write 8 consecutive rows:
// 8 distinct bank groups through the swizzle. The kernel loads the next
// block's planes as soon as it has decoded this one's, so the loads run
// under the MMAs.
template <int kThreads>
struct TilePlanes {
  static constexpr int kU = kBN * 4 / kThreads;  // units per thread
  uint4 b2[kU], b1[kU];
  float d[kU], z[kU], ds[kU][4];

  __device__ __forceinline__ void load(
      const uint8_t* __restrict__ plane2, const uint8_t* __restrict__ plane1,
      const __half* __restrict__ scales, const __half* __restrict__ zps,
      int n0, int N, int KB, int kb, int fivelevel, int sub_blocks) {
    const int per = sub_blocks ? 256 / sub_blocks : 256;
#pragma unroll
    for (int k = 0; k < kU; ++k) {
      const int u = threadIdx.x + k * kThreads, n = n0 + (u & (kBN - 1));
      b2[k] = make_uint4(kZeroCodes, kZeroCodes, kZeroCodes, kZeroCodes);
      b1[k] = make_uint4(0u, 0u, 0u, 0u);
      d[k] = z[k] = 0.f;  // rows past N decode to zeros
#pragma unroll
      for (int c = 0; c < 4; ++c) ds[k][c] = 0.f;
      if (n < N) {
        const long long blk = (long long)n * KB + kb;
        b2[k] = __ldg(reinterpret_cast<const uint4*>(plane2 + blk * 64) +
                      u / kBN);
        if (fivelevel)
          b1[k] = __ldg(reinterpret_cast<const uint4*>(plane1 + blk * 32) +
                        (u / kBN & 1));
        if (!sub_blocks) {
          d[k] = __half2float(scales[blk]);
          z[k] = __half2float(zps[blk]);
        } else if (per >= 16) {  // one scale per unit and chunk
#pragma unroll
          for (int c = 0; c < 4; ++c)
            ds[k][c] = __half2float(
                scales[blk * sub_blocks + (c * 64 + 16 * (u / kBN)) / per]);
        }
      }
    }
  }
};

// Decode the kBN x 256 weight tile of block kb from pl into wsm (and d
// per column into sd for kWint); kFive: the five-level escape.
template <int kThreads, int kMode, bool kFive>
__device__ __forceinline__ void decode_units(
    const TilePlanes<kThreads>& pl, float* __restrict__ wsm,
    float* __restrict__ sd, const __half* __restrict__ scales, int n0,
    int N, int KB, int kb, int sub_blocks) {
  constexpr int kU = TilePlanes<kThreads>::kU;
  const int per = sub_blocks ? 256 / sub_blocks : 256;
#pragma unroll
  for (int k = 0; k < kU; ++k) {
    const int u = threadIdx.x + k * kThreads, rr = u & (kBN - 1);
    const int qq = u / kBN;
    const int n = n0 + rr;
    const long long sbase = ((long long)n * KB + kb) * sub_blocks;
    const unsigned w2[4] = {pl.b2[k].x, pl.b2[k].y, pl.b2[k].z, pl.b2[k].w};
    const unsigned w1[4] = {pl.b1[k].x, pl.b1[k].y, pl.b1[k].z, pl.b1[k].w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int e0 = c * 64 + 16 * qq;
      float v[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int sh = 8 * (j & 3) + 2 * c;
        float q = ternary(w2[j >> 2], sh);
        if (kFive)  // the escape doubles q where plane1's bit is set: the
          // bit goes into the exponent of 1.0f
          q *= __uint_as_float(0x3f800000u +
                               (((w1[j >> 2] >> (sh + (qq >> 1))) & 1u) << 23));
        if (kMode == kWint) {
          v[j] = q - pl.z[k];  // exact: small integers
        } else if (sub_blocks) {
          const float dj = per >= 16 || n >= N
                               ? pl.ds[k][c]
                               : __half2float(scales[sbase + (e0 + j) / per]);
          v[j] = dj * q;
        } else {
          v[j] = pl.d[k] * (q - pl.z[k]);
        }
      }
#pragma unroll
      for (int g = 0; g < 4; ++g)
        *reinterpret_cast<float4*>(wsm + swz(rr, c * 16 + 4 * qq + g, 64)) =
            make_float4(v[4 * g], v[4 * g + 1], v[4 * g + 2], v[4 * g + 3]);
    }
    if (kMode == kWint && qq == 0) sd[rr] = pl.d[k];
  }
}

// The weight tile of block kb: decoded, then in weights mode the
// butterfly on each row, one warp per row.
template <int kThreads, int kMode>
__device__ __forceinline__ void decode_tile(
    const TilePlanes<kThreads>& pl, float* __restrict__ wsm,
    float* __restrict__ sd, const __half* __restrict__ scales, int n0,
    int N, int KB, int kb, int fivelevel, int sub_blocks) {
  if (fivelevel)
    decode_units<kThreads, kMode, true>(pl, wsm, sd, scales, n0, N, KB, kb,
                                        sub_blocks);
  else
    decode_units<kThreads, kMode, false>(pl, wsm, sd, scales, n0, N, KB, kb,
                                         sub_blocks);
  if (kMode == kRotated) {
    __syncthreads();  // the rows are decoded
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int rr = warp; rr < kBN; rr += kThreads / 32) {
      float w[8];  // common.cuh's lane layout: elements q*64 + 2*lane + j
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 p = *reinterpret_cast<const float2*>(
            wsm + swz(rr, q * 16 + (lane >> 1), 64) + 2 * (lane & 1));
        w[2 * q] = p.x;
        w[2 * q + 1] = p.y;
      }
      itq3_butterfly(w, lane);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<float2*>(wsm + swz(rr, q * 16 + (lane >> 1), 64) +
                                   2 * (lane & 1)) =
            make_float2(w[2 * q], w[2 * q + 1]);
    }
  }
}

// One 64-wide K chunk of this warp's 16 rows (ra = its row gid) x kNT n8
// tiles (weight rows from wr) into c: the x_hi products into c[0], the
// others into c[1], so 2*kNT independent chains of MMAs interleave.
template <int kMode>
__device__ __forceinline__ void mma_chunk(float (&c)[2][kNT][4],
                                          const float* __restrict__ xb,
                                          const float* __restrict__ wsm,
                                          int chunk, int ra, int wr,
                                          int tig) {
#pragma unroll
  for (int j = 0; j < kKC / 16; ++j) {  // k16 steps: thread reads 4 k
    const float4 xa = *reinterpret_cast<const float4*>(
        xb + swz(ra, 4 * j + tig, kKC / 4));
    const float4 xc = *reinterpret_cast<const float4*>(
        xb + swz(ra + 8, 4 * j + tig, kKC / 4));
    // k8 step s takes elements 2s (mma k = tig) and 2s+1 (k = tig + 4)
    unsigned ah[2][4], al[2][4];
    split_tf32(xa.x, ah[0][0], al[0][0]);
    split_tf32(xc.x, ah[0][1], al[0][1]);
    split_tf32(xa.y, ah[0][2], al[0][2]);
    split_tf32(xc.y, ah[0][3], al[0][3]);
    split_tf32(xa.z, ah[1][0], al[1][0]);
    split_tf32(xc.z, ah[1][1], al[1][1]);
    split_tf32(xa.w, ah[1][2], al[1][2]);
    split_tf32(xc.w, ah[1][3], al[1][3]);
    float4 wv[kNT];
#pragma unroll
    for (int t = 0; t < kNT; ++t)
      wv[t] = *reinterpret_cast<const float4*>(
          wsm + swz(wr + t * 8, chunk * 16 + 4 * j + tig, 64));
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if constexpr (kMode == kRotated) {
#pragma unroll
        for (int t = 0; t < kNT; ++t) {
          unsigned bh0, bl0, bh1, bl1;
          split_tf32(s ? wv[t].z : wv[t].x, bh0, bl0);
          split_tf32(s ? wv[t].w : wv[t].y, bh1, bl1);
          mma_tf32(c[0][t], ah[s], bh0, bh1);
          mma_tf32(c[1][t], ah[s], bl0, bl1);
          mma_tf32(c[1][t], al[s], bh0, bh1);
        }
      } else {  // exact in TF32: no split
#pragma unroll
        for (int t = 0; t < kNT; ++t)
          mma_tf32(c[0][t], ah[s], __float_as_uint(s ? wv[t].z : wv[t].x),
                   __float_as_uint(s ? wv[t].w : wv[t].y));
#pragma unroll
        for (int t = 0; t < kNT; ++t)
          mma_tf32(c[1][t], al[s], __float_as_uint(s ? wv[t].z : wv[t].x),
                   __float_as_uint(s ? wv[t].w : wv[t].y));
      }
    }
  }
}

// One accumulator fragment of out: v.x, v.y at row m, columns n, n + 1;
// v.z, v.w at row m + 8.
__device__ __forceinline__ void store_frag(float* __restrict__ out, int M,
                                           int N, int m, int n, float4 v) {
  const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m + 8 * h;
    if (row >= M || n >= N) continue;
    float* o = out + (long long)row * N + n;
    if (n + 1 < N && !(N & 1)) {
      *reinterpret_cast<float2*>(o) = make_float2(f[2 * h], f[2 * h + 1]);
    } else {
      o[0] = f[2 * h];
      if (n + 1 < N) o[1] = f[2 * h + 1];
    }
  }
}

// Launched with clusters of gridDim.z blocks along z when gridDim.z > 1.
// Two 64-row blocks fit an SM's shared memory; at most 128 registers a
// thread lets them both be resident (a split grid then runs in one wave).
template <int kWM, int kMode>
__global__ void __launch_bounds__(kWM * kWN * 32, kWM == 4 ? 2 : 1)
itq3_matmul_kernel(const float* __restrict__ x,
                   const uint8_t* __restrict__ plane2,
                   const uint8_t* __restrict__ plane1,
                   const __half* __restrict__ scales,
                   const __half* __restrict__ zps, float* __restrict__ out,
                   int M, int N, int KB, int kb_per_split, int fivelevel,
                   int sub_blocks, int m_tiles) {
  constexpr int kBM = 16 * kWM, kThreads = 32 * kWM * kWN;
  extern __shared__ __align__(16) float smem[];
  float* wsm = smem;              // kBN x 256 weight operand
  float* xsm = smem + kBN * 256;  // the ring: kStages x kBM x kKC
  __shared__ float sd[kBN];       // d per column (kWint)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;  // MMA group / thread in group
  const int wm = warp / kWN, wn = warp % kWN;  // this warp's rows / columns
  // blockIdx.y = expert * m_tiles + row tile (expert 0 for one matrix).
  // An expert's rows of x and out follow the previous experts' M rows,
  // its planes' rows their N rows (contiguous stacks, checked at launch),
  // so the tile is addressed by global row indices, each bounded by its
  // expert's end: no pointer is offset, and none is held in registers.
  const int ex = blockIdx.y / m_tiles;
  const int n0 = blockIdx.x * kBN;
  const int m0 = (blockIdx.y - ex * m_tiles) * kBM + ex * M;
  const int m_end = ex * M + M, nrow = ex * N;
  const int kb0 = blockIdx.z * kb_per_split;
  const int nchunks = (min(KB, kb0 + kb_per_split) - kb0) * 4;
  const long long K = (long long)KB * 256;

  auto load_x = [&](int i) {  // chunk i of this split into its ring slot
    if (i < nchunks) {
      float* dst = xsm + (i % kStages) * kBM * kKC;
      const long long kofs = (long long)(kb0 + (i >> 2)) * 256 + (i & 3) * kKC;
#pragma unroll
      for (int k = 0; k < kBM * (kKC / 4) / kThreads; ++k) {
        const int idx = threadIdx.x + k * kThreads;
        const int r = idx >> 4, g = idx & 15, m = m0 + r;
        const bool ok = m < m_end;
        cp_async16(dst + swz(r, g, kKC / 4),
                   ok ? x + (long long)m * K + kofs + 4 * g : x, ok);
      }
    }
    cp_async_commit();  // empty past the end: the wait count stays uniform
  };

  // acc[0] and acc[1] take the x_hi and the other products. With kWint
  // each block's go to part first and acc[0] += d * (part[0] + part[1]).
  float acc[2][kNT][4], part[2][kMode == kWint ? kNT : 1][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int t = 0; t < kNT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][t][e] = 0.f;

  const int ra = wm * 16 + gid, wr = wn * (8 * kNT) + gid;
  TilePlanes<kThreads> pl;
  pl.load(plane2, plane1, scales, zps, nrow + n0, nrow + N, KB, kb0,
          fivelevel, sub_blocks);
  load_x(0);
  load_x(1);
  for (int i = 0; i < nchunks; ++i) {
    const int c = i & 3;
    if (c == 0) {  // a new 256-block: decode its weight tile
      const int kb = kb0 + (i >> 2);
      __syncthreads();  // the previous block's tile is consumed
      decode_tile<kThreads, kMode>(pl, wsm, sd, scales, nrow + n0, nrow + N,
                                   KB, kb, fivelevel, sub_blocks);
      if (i + 4 < nchunks)
        pl.load(plane2, plane1, scales, zps, nrow + n0, nrow + N, KB, kb + 1,
                fivelevel, sub_blocks);
      if constexpr (kMode == kWint) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int t = 0; t < kNT; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[h][t][e] = 0.f;
      }
    }
    cp_async_wait_one();  // this thread's copies of chunk i have landed
    __syncthreads();      // everyone's; chunk i-1's slot is free again
    load_x(i + 2);
    const float* xb = xsm + (i % kStages) * kBM * kKC;
    if constexpr (kMode == kWint) {
      mma_chunk<kMode>(part, xb, wsm, c, ra, wr, tig);
      if (c == 3) {  // the block is done: acc += d * P, in ascending K
#pragma unroll
        for (int t = 0; t < kNT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[0][t][e] = fmaf(sd[wr - gid + t * 8 + 2 * tig + (e & 1)],
                                part[0][t][e] + part[1][t][e], acc[0][t][e]);
      }
    } else {
      mma_chunk<kMode>(acc, xb, wsm, c, ra, wr, tig);
    }
  }

#pragma unroll
  for (int t = 0; t < kNT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][t][e] += acc[1][t][e];

  const int nsplit = gridDim.z;
  if (nsplit == 1) {
#pragma unroll
    for (int t = 0; t < kNT; ++t)
      store_frag(out, m_end, N, m0 + ra, n0 + wr - gid + t * 8 + 2 * tig,
                 make_float4(acc[0][t][0], acc[0][t][1], acc[0][t][2],
                             acc[0][t][3]));
    return;
  }
  // The splits of a tile form one cluster. Each block leaves its partial
  // in its own shared memory, fragment order; after a cluster barrier,
  // block r adds the r-th slice of every split's partial, in split order,
  // through distributed shared memory, and stores it.
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  float4* mine = reinterpret_cast<float4*>(smem);
  __syncthreads();  // every warp is done with the tiles
#pragma unroll
  for (int t = 0; t < kNT; ++t)
    mine[t * kThreads + threadIdx.x] =
        make_float4(acc[0][t][0], acc[0][t][1], acc[0][t][2], acc[0][t][3]);
  cluster.sync();
  constexpr int kFrags = kNT * kThreads;
  const int r = (int)cluster.block_rank();
  const int f1 = (r + 1) * kFrags / nsplit;
  for (int f = r * kFrags / nsplit + threadIdx.x; f < f1; f += kThreads) {
    float4 v[kMaxSplits];  // all loads first, so they overlap
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp)
      if (sp < nsplit) v[sp] = cluster.map_shared_rank(mine, sp)[f];
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp) {  // in split order
      if (sp < nsplit) {
        sum.x += v[sp].x;
        sum.y += v[sp].y;
        sum.z += v[sp].z;
        sum.w += v[sp].w;
      }
    }
    const int t = f / kThreads, th = f % kThreads, ln = th & 31;
    const int w = th >> 5;  // the fragment's warp: rows, columns as above
    store_frag(out, m_end, N, m0 + (w / kWN) * 16 + (ln >> 2),
               n0 + (w % kWN) * (8 * kNT) + t * 8 + 2 * (ln & 3), sum);
  }
  cluster.sync();  // the partials stay until every block has read them
}

template <int kWM, int kMode>
static int launch_tile(dim3 grid, cudaStream_t stream, const float* x,
                       const uint8_t* plane2, const uint8_t* plane1,
                       const __half* scales, const __half* zps, float* out,
                       int M, int N, int KB, int kb_per_split, int fivelevel,
                       int sub_blocks, int m_tiles) {
  constexpr int smem =
      (int)((kBN * 256 + kStages * 16 * kWM * kKC) * sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      itq3_matmul_kernel<kWM, kMode>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kWM * kWN * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = grid.z;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, itq3_matmul_kernel<kWM, kMode>, x,
                                 plane2, plane1, scales, zps, out, M, N, KB,
                                 kb_per_split, fivelevel, sub_blocks, m_tiles);
}

template <int kWM>
static int launch_rows(int mode, dim3 grid, cudaStream_t stream,
                       const float* x, const uint8_t* plane2,
                       const uint8_t* plane1, const __half* scales,
                       const __half* zps, float* out, int M, int N, int KB,
                       int kbps, int fivelevel, int sub_blocks, int m_tiles) {
#define MATMUL_LAUNCH(MODE)                                                 \
  launch_tile<kWM, MODE>(grid, stream, x, plane2, plane1, scales, zps, out, \
                         M, N, KB, kbps, fivelevel, sub_blocks, m_tiles)
  switch (mode) {
    case kWint: return MATMUL_LAUNCH(kWint);
    case kScaledQ: return MATMUL_LAUNCH(kScaledQ);
    default: return MATMUL_LAUNCH(kRotated);
  }
#undef MATMUL_LAUNCH
}

// Grid (ceil(N / 64), E * ceil(M / bm), splits), bm 32 or 64, in clusters
// of the splits (at most 8, the portable cluster size); y walks the row
// tiles of expert 0, then expert 1, ... of a stack of E matrices (E = 1:
// one matrix), whose per-expert strides (in elements) must be those of
// contiguous (E, M, K) / (E, N, KB, ...) / (E, M, N) stacks. The KB
// blocks are cut into splits runs of ceil(KB / splits), which must leave
// none empty. x must be 16-byte aligned.
extern "C" int itq3_matmul_launch(const float* x, const uint8_t* plane2,
                                  const uint8_t* plane1, const __half* scales,
                                  const __half* zps, float* out, int M, int N,
                                  int KB, int rotate, int fivelevel,
                                  int sub_blocks, int bm, int splits, int E,
                                  long long sx, long long splane2,
                                  long long splane1, long long sscales,
                                  long long szps, long long sout,
                                  cudaStream_t stream) {
  if (M < 1 || N < 1 || KB < 1 || splits < 1 || splits > KB ||
      splits > kMaxSplits ||
      sub_blocks < 0 || (sub_blocks && 256 % sub_blocks) ||
      ((uintptr_t)x & 15) || E < 1 || (sx & 3) || (bm != 32 && bm != 64))
    return (int)cudaErrorInvalidValue;
  const int kbps = (KB + splits - 1) / splits;
  if ((KB + kbps - 1) / kbps != splits) return (int)cudaErrorInvalidValue;
  const int m_tiles = (M + bm - 1) / bm;
  const long long nb = (long long)N * KB;
  if ((long long)E * m_tiles > 65535 ||
      (long long)E * (M > N ? M : N) > INT_MAX ||
      (E > 1 && (sx != (long long)M * KB * 256 || splane2 != nb * 64 ||
                 splane1 != nb * 32 ||
                 sscales != nb * (sub_blocks ? sub_blocks : 1) ||
                 szps != nb || sout != (long long)M * N)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kBN - 1) / kBN, E * m_tiles, splits);
  const int mode = rotate ? kRotated : sub_blocks ? kScaledQ : kWint;
  switch (bm) {
    case 32: return launch_rows<2>(mode, grid, stream, x, plane2, plane1,
                                   scales, zps, out, M, N, KB, kbps,
                                   fivelevel, sub_blocks, m_tiles);
    case 64: return launch_rows<4>(mode, grid, stream, x, plane2, plane1,
                                   scales, zps, out, M, N, KB, kbps,
                                   fivelevel, sub_blocks, m_tiles);
    default: return (int)cudaErrorInvalidValue;
  }
}
