// Tiled W3A8 matmul for M > 16: out (M, N) = xscale * sum_b d_{n,b} *
// (xq[m, b] . wint[n, b]), xq the int8 rotation-domain activation codes and
// wint = q - z the exact int8 weights decoded from the packed planes.
//
// Replaces: repro/kernels/itq3_matmul.py itq3_matmul_int8_pallas
// (_itq3_matmul_int8_kernel flat / _itq3_matmul_int8_hoisted_kernel, with
// decode_wint_tile and _accumulate_int8).
//
// What binds. A 256-row prefill wave is 2*M int8 operations per weight:
// at smollm-135m's shapes (1.7e8 operations for wq) that is a fraction of
// a microsecond on the integer tensor cores, and the planes are a few
// hundred kilobytes. What takes the time is latency: too few blocks to
// fill the 132 SMs, and in each block a chain of dependent steps per
// 256-block (copy the x tile, decode the weight tile row by row, each row
// waiting on its own load, then the MMAs) with nothing in flight under it.
// The design, after itq3_matmul.cu's:
//
// - Tiles. A block owns BM = 16*WM rows x 64 columns with 2*WM warps; warp
//   (wm, wn) owns rows 16wm..16wm+15 and columns 32wn..32wn+31, four n8
//   tiles of mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 (exact int32
//   partials). The MMA is plain asm, so independent MMAs interleave.
// - Weights. Each 256-block's 64 x 256 wint tile is decoded into shared
//   memory from 16-byte plane loads (one or two per thread, and plane1's
//   under the five-level escape), bytewise, with no conversion to float.
//   The loads of block kb+1 are issued before the MMAs of block kb, and
//   the tile is double-buffered, so one barrier per block suffices; the
//   zero-points and the (sub-)block scales come with the planes.
// - Activations. The BM x 256 xq tile of each block streams through a
//   3-deep ring of cp.async 16-byte copies, two blocks ahead of the math.
// - Banks. Both tiles keep rows of 288 bytes. A fragment load is 8 bytes
//   per thread (the MMA's k index is permuted within each k32 step, the
//   same for both operands: thread t of a quad holds k = 8t..8t+7), so a
//   half-warp reads 4 rows x 32 bytes, 32 distinct banks; a decode store
//   phase writes 4 rows x two 16-byte units, 8 distinct bank groups.
// - Scales. Block-scaled formats (kBlock) keep the int32 partial of the
//   whole 256-block and add d * P; itq3_s_sub's 32-element sub-blocks
//   (kSub32) take d_sub * P after each k32 step; any other divisor of 256
//   (kSubAny, off the serving path) groups per/32 k32 steps, or, below 32
//   elements, runs one MMA per sub-block against a weight fragment masked
//   to it. Each product is f32(P) * d and each sum rounded on its own
//   (scaled_add), in ascending K.
// - Split-K. Where the output tiles alone leave SMs idle, K is cut into
//   splits (kernels/itq3.py matmul_tiles) that form one thread block
//   cluster. Each split leaves its sum in its own shared memory; block r
//   of the cluster adds the r-th slice of all of them in ascending split
//   order through distributed shared memory, then multiplies by xscale.
//   No workspace, no atomics: two calls give the same bits, those of
//   kernels/itq3.py itq3_matmul_int8_split_ref at the same cut.
// - Experts. A stack of E matrices with their E inputs (the MoE expert
//   projections) is one launch: y walks expert 0's row tiles, then expert
//   1's, each expert's operands at fixed strides from the base pointers;
//   E = 1 gives the one matrix's bits, and the cut rule counts every
//   expert's tiles.
// wgmma and TMA would raise a rate that does not bind at these shapes.
#include <cooperative_groups.h>

#include "common.cuh"

constexpr int kBN = 64;        // output columns per block
constexpr int kWN = 2;         // warps across the columns
constexpr int kNT = 4;         // n8 tiles per warp: 32 columns
constexpr int kLD = 288;       // bytes per staged row: 256 + 32 of padding
constexpr int kStages = 3;     // xq tiles in the ring
constexpr int kMaxSplits = 8;  // K splits: the portable cluster size
constexpr int kSdLD = 9;       // staged scales per column (<= 8), padded

__device__ __forceinline__ void mma_s8(int c[4], const int a[4], unsigned b0,
                                       unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Plane unit u (16 plane2 bytes of one row) -> its row and quarter: bit 0
// and bit 3 of u are the quarter, the others the row, so the 8 threads of
// a 16-byte store phase write rows r..r+3 at two quarters.
__device__ __forceinline__ int unit_row(int u) {
  return ((u >> 1) & 3) | ((u >> 4) << 2);
}
__device__ __forceinline__ int unit_quarter(int u) {
  return (u & 1) | ((u >> 2) & 2);
}

// One thread's share of a block's planes, loaded a block ahead: kU units,
// each row's zero-point, and (threads below kBN) the scales of column
// threadIdx.x as fp16 bits.
template <int kThreads, int kMode>
struct Int8Planes {
  static constexpr int kU = kBN * 4 / kThreads;
  uint4 b2[kU], b1[kU];
  int z[kU];
  uint4 sc;

  __device__ __forceinline__ void load(
      const uint8_t* __restrict__ plane2, const uint8_t* __restrict__ plane1,
      const __half* __restrict__ scales, const __half* __restrict__ zps,
      int n0, int N, int KB, int kb, int fivelevel, int nsub) {
#pragma unroll
    for (int k = 0; k < kU; ++k) {
      const int u = threadIdx.x + k * kThreads, n = n0 + unit_row(u);
      const int qq = unit_quarter(u);
      b2[k] = make_uint4(kZeroCodes, kZeroCodes, kZeroCodes, kZeroCodes);
      b1[k] = make_uint4(0u, 0u, 0u, 0u);
      z[k] = 0;  // rows past N decode to zeros
      if (n < N) {
        const long long blk = (long long)n * KB + kb;
        b2[k] = __ldg(reinterpret_cast<const uint4*>(plane2 + blk * 64) + qq);
        if (fivelevel)
          b1[k] = __ldg(reinterpret_cast<const uint4*>(plane1 + blk * 32) +
                        (qq & 1));
        if (kMode == kBlock) z[k] = (int)__half2float(zps[blk]);
      }
    }
    sc = make_uint4(0u, 0u, 0u, 0u);
    const int n = n0 + (int)threadIdx.x;
    if (threadIdx.x < kBN && n < N) {
      const long long blk = (long long)n * KB + kb;
      if (kMode == kBlock) {
        sc.x = __half_as_ushort(scales[blk]);
      } else if (kMode == kSub32) {
        sc = __ldg(reinterpret_cast<const uint4*>(scales + blk * 8));
      } else if (nsub <= 8) {  // staged; narrower sub-blocks read at use
        unsigned h[8];
#pragma unroll
        for (int s = 0; s < 8; ++s)
          h[s] = s < nsub ? __half_as_ushort(scales[blk * nsub + s]) : 0u;
        sc = make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16),
                        h[4] | (h[5] << 16), h[6] | (h[7] << 16));
      }
    }
  }

  // The wint tile into wsm (kBN rows of kLD bytes) and the scales into sd.
  __device__ __forceinline__ void decode(uint8_t* __restrict__ wsm,
                                         float* __restrict__ sd,
                                         int fivelevel) const {
#pragma unroll
    for (int k = 0; k < kU; ++k) {
      const int u = threadIdx.x + k * kThreads, qq = unit_quarter(u);
      unsigned w[4][4];
      itq3_decode_wint_unit(b2[k], b1[k], z[k], qq >= 2, fivelevel, w);
      uint8_t* row = wsm + unit_row(u) * kLD + 16 * qq;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<uint4*>(row + 64 * c) =
            make_uint4(w[c][0], w[c][1], w[c][2], w[c][3]);
    }
    if (threadIdx.x < kBN) {
      const unsigned h[4] = {sc.x, sc.y, sc.z, sc.w};
#pragma unroll
      for (int s = 0; s < 8; ++s)
        sd[threadIdx.x * kSdLD + s] = half_bits(h[s >> 1] >> (16 * (s & 1)));
    }
  }
};

// Bytes of one b fragment register at k32 offsets base..base+3 that lie in
// sub-block j of width 2^lg (< 32): the mask that keeps them.
__device__ __forceinline__ unsigned sub_mask(int base, int lg, int j) {
  unsigned m = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (((base + i) >> lg) == j) m |= 0xffu << (8 * i);
  return m;
}

// The MMAs of one 256-block: this warp's 16 rows (xa: row gid, k offset
// 8*tig) x 4 n8 tiles (wb: column gid of the first tile), scaled by the
// block's (sub-)block scales and added to acc in ascending K.
template <int kMode>
__device__ __forceinline__ void mma_block(
    float (&acc)[kNT][4], const uint8_t* __restrict__ xa,
    const uint8_t* __restrict__ wb, const float* __restrict__ sd,
    const __half* __restrict__ scales, int ncol0, int N, int KB, int kb,
    int nsub, int tig) {
  const int lg = 8 - (__ffs(nsub) - 1);  // log2 of the sub-block width
  int cc[kMode == kBlock ? 2 : 1][kNT][4];
#pragma unroll
  for (int h = 0; h < (kMode == kBlock ? 2 : 1); ++h)
#pragma unroll
    for (int t = 0; t < kNT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) cc[h][t][e] = 0;
  auto scale_in = [&](int (&c)[kNT][4], auto dsub) {
#pragma unroll
    for (int t = 0; t < kNT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = t * 8 + 2 * tig + (e & 1);
        acc[t][e] = scaled_add(acc[t][e], c[t][e], dsub(col));
        c[t][e] = 0;
      }
  };
#pragma unroll
  for (int st = 0; st < 8; ++st) {
    const uint2 a0 = *reinterpret_cast<const uint2*>(xa + 32 * st);
    const uint2 a1 = *reinterpret_cast<const uint2*>(xa + 8 * kLD + 32 * st);
    const int a[4] = {(int)a0.x, (int)a1.x, (int)a0.y, (int)a1.y};
    uint2 b[kNT];
#pragma unroll
    for (int t = 0; t < kNT; ++t)
      b[t] = *reinterpret_cast<const uint2*>(wb + t * 8 * kLD + 32 * st);
    if constexpr (kMode == kBlock) {
#pragma unroll
      for (int t = 0; t < kNT; ++t) mma_s8(cc[st & 1][t], a, b[t].x, b[t].y);
    } else if constexpr (kMode == kSub32) {
#pragma unroll
      for (int t = 0; t < kNT; ++t) mma_s8(cc[0][t], a, b[t].x, b[t].y);
      scale_in(cc[0], [&](int col) { return sd[col * kSdLD + st]; });
    } else if (lg >= 5) {
#pragma unroll
      for (int t = 0; t < kNT; ++t) mma_s8(cc[0][t], a, b[t].x, b[t].y);
      if ((((st + 1) << 5) & ((1 << lg) - 1)) == 0) {
        const int s = (st << 5) >> lg;
        scale_in(cc[0], [&](int col) { return sd[col * kSdLD + s]; });
      }
    } else {  // one MMA per sub-block of this k32 step, from global scales
      for (int j = 0; j < 1 << (5 - lg); ++j) {
        const unsigned m0 = sub_mask(8 * tig, lg, j);
        const unsigned m1 = sub_mask(8 * tig + 4, lg, j);
#pragma unroll
        for (int t = 0; t < kNT; ++t)
          mma_s8(cc[0][t], a, b[t].x & m0, b[t].y & m1);
        const int s = (st << (5 - lg)) + j;
        scale_in(cc[0], [&](int col) {
          const int n = ncol0 + col;
          return n < N ? __half2float(
                             scales[((long long)n * KB + kb) * nsub + s])
                       : 0.f;
        });
      }
    }
  }
  if constexpr (kMode == kBlock) {
#pragma unroll
    for (int t = 0; t < kNT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) cc[0][t][e] += cc[1][t][e];
    scale_in(cc[0], [&](int col) { return sd[col * kSdLD]; });
  }
}

// One accumulator fragment times xscale: v.x, v.y at row m, columns n,
// n + 1; v.z, v.w at row m + 8.
__device__ __forceinline__ void store_frag(float* __restrict__ out,
                                           const float* __restrict__ xscale,
                                           int M, int N, int m, int n,
                                           float4 v) {
  const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m + 8 * h;
    if (row >= M || n >= N) continue;
    const float xs = xscale[row];
    const float lo = __fmul_rn(f[2 * h], xs), hi = __fmul_rn(f[2 * h + 1], xs);
    float* o = out + (long long)row * N + n;
    if (n + 1 < N && !(N & 1)) {
      *reinterpret_cast<float2*>(o) = make_float2(lo, hi);
    } else {
      o[0] = lo;
      if (n + 1 < N) o[1] = hi;
    }
  }
}

// Launched with clusters of gridDim.z blocks along z when gridDim.z > 1.
template <int kWM, int kMode>
__global__ void __launch_bounds__(kWM * kWN * 32, kWM == 4 ? 2 : 3)
itq3_matmul_int8_kernel(const int8_t* __restrict__ xq,
                        const float* __restrict__ xscale,
                        const uint8_t* __restrict__ plane2,
                        const uint8_t* __restrict__ plane1,
                        const __half* __restrict__ scales,
                        const __half* __restrict__ zps,
                        float* __restrict__ out, int M, int N, int KB,
                        int kb_per_split, int fivelevel, int sub_blocks,
                        int m_tiles, ExpertStrides es) {
  constexpr int kBM = 16 * kWM, kThreads = 32 * kWM * kWN;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* wsm = smem;                // 2 x kBN x kLD: the wint tiles
  uint8_t* xsm = smem + 2 * kBN * kLD;  // the ring: kStages x kBM x kLD
  __shared__ float sd[2][kBN * kSdLD];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;  // MMA group / thread in group
  const int wm = warp / kWN, wn = warp % kWN;  // this warp's rows / columns
  // blockIdx.y = expert * m_tiles + row tile: 0 * m_tiles + tile for one
  // matrix
  const int ex = blockIdx.y / m_tiles;
  xq += ex * es.x;
  xscale += ex * es.xscale;
  plane2 += ex * es.plane2;
  plane1 += ex * es.plane1;
  scales += ex * es.scales;
  zps += ex * es.zps;
  out += ex * es.out;
  const int n0 = blockIdx.x * kBN, m0 = (blockIdx.y - ex * m_tiles) * kBM;
  const int kb0 = blockIdx.z * kb_per_split;
  const int nblk = min(KB, kb0 + kb_per_split) - kb0;
  const int nsub = sub_blocks ? sub_blocks : 1;
  const long long K = (long long)KB * 256;

  auto load_x = [&](int i) {  // block i of this split into its ring slot
    if (i < nblk) {
      uint8_t* dst = xsm + (i % kStages) * kBM * kLD;
      const long long kofs = (long long)(kb0 + i) * 256;
#pragma unroll
      for (int k = 0; k < kBM * 16 / kThreads; ++k) {
        const int idx = threadIdx.x + k * kThreads;
        const int r = idx >> 4, g = idx & 15, m = m0 + r;
        const bool ok = m < M;
        cp_async16(dst + r * kLD + 16 * g,
                   ok ? xq + (long long)m * K + kofs + 16 * g : xq, ok);
      }
    }
    cp_async_commit();  // empty past the end: the wait count stays uniform
  };

  float acc[kNT][4];
#pragma unroll
  for (int t = 0; t < kNT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

  Int8Planes<kThreads, kMode> pl;
  pl.load(plane2, plane1, scales, zps, n0, N, KB, kb0, fivelevel, nsub);
  load_x(0);
  load_x(1);
  const int ra = wm * 16 + gid, wr = wn * (8 * kNT) + gid;
  for (int i = 0; i < nblk; ++i) {
    uint8_t* wt = wsm + (i & 1) * kBN * kLD;
    pl.decode(wt, sd[i & 1], fivelevel);
    if (i + 1 < nblk)  // the next block's planes load under these MMAs
      pl.load(plane2, plane1, scales, zps, n0, N, KB, kb0 + i + 1, fivelevel,
              nsub);
    cp_async_wait_one();  // this thread's copies of block i have landed
    __syncthreads();      // everyone's, and the tile; slot i-1 is free
    load_x(i + 2);
    const uint8_t* xt = xsm + (i % kStages) * kBM * kLD;
    mma_block<kMode>(acc, xt + ra * kLD + 8 * tig, wt + wr * kLD + 8 * tig,
                     sd[i & 1] + wn * (8 * kNT) * kSdLD, scales,
                     n0 + wn * (8 * kNT), N, KB, kb0 + i, nsub, tig);
  }

  const int nsplit = gridDim.z;
  if (nsplit == 1) {
#pragma unroll
    for (int t = 0; t < kNT; ++t)
      store_frag(out, xscale, M, N, m0 + ra, n0 + wr - gid + t * 8 + 2 * tig,
                 make_float4(acc[t][0], acc[t][1], acc[t][2], acc[t][3]));
    return;
  }
  // The splits of a tile form one cluster. Each block leaves its sum in
  // its own shared memory, fragment order; after a cluster barrier, block
  // r adds the r-th slice of every split's sum, in split order, through
  // distributed shared memory, and stores it times xscale.
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  float4* mine = reinterpret_cast<float4*>(smem);
  __syncthreads();  // every warp is done with the tiles
#pragma unroll
  for (int t = 0; t < kNT; ++t)
    mine[t * kThreads + threadIdx.x] =
        make_float4(acc[t][0], acc[t][1], acc[t][2], acc[t][3]);
  cluster.sync();
  constexpr int kFrags = kNT * kThreads;
  const int r = (int)cluster.block_rank();
  const int f1 = (r + 1) * kFrags / nsplit;
  for (int f = r * kFrags / nsplit + threadIdx.x; f < f1; f += kThreads) {
    float4 v[kMaxSplits];  // all loads first, so they overlap
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp)
      if (sp < nsplit) v[sp] = cluster.map_shared_rank(mine, sp)[f];
    float4 sum = v[0];
#pragma unroll
    for (int sp = 1; sp < kMaxSplits; ++sp) {  // in split order
      if (sp < nsplit) {
        sum.x += v[sp].x;
        sum.y += v[sp].y;
        sum.z += v[sp].z;
        sum.w += v[sp].w;
      }
    }
    const int t = f / kThreads, th = f % kThreads, ln = th & 31;
    const int w = th >> 5;  // the fragment's warp: rows, columns as above
    store_frag(out, xscale, M, N, m0 + (w / kWN) * 16 + (ln >> 2),
               n0 + (w % kWN) * (8 * kNT) + t * 8 + 2 * (ln & 3), sum);
  }
  cluster.sync();  // the sums stay until every block has read them
}

template <int kWM, int kMode>
static int launch_tile(dim3 grid, cudaStream_t stream, const int8_t* xq,
                       const float* xscale, const uint8_t* plane2,
                       const uint8_t* plane1, const __half* scales,
                       const __half* zps, float* out, int M, int N, int KB,
                       int kb_per_split, int fivelevel, int sub_blocks,
                       int m_tiles, const ExpertStrides& es) {
  constexpr int smem = (2 * kBN + kStages * 16 * kWM) * kLD;
  const cudaError_t err = cudaFuncSetAttribute(
      itq3_matmul_int8_kernel<kWM, kMode>,
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
  return (int)cudaLaunchKernelEx(&cfg, itq3_matmul_int8_kernel<kWM, kMode>,
                                 xq, xscale, plane2, plane1, scales, zps, out,
                                 M, N, KB, kb_per_split, fivelevel,
                                 sub_blocks, m_tiles, es);
}

template <int kWM>
static int launch_rows(int mode, dim3 grid, cudaStream_t stream,
                       const int8_t* xq, const float* xscale,
                       const uint8_t* plane2, const uint8_t* plane1,
                       const __half* scales, const __half* zps, float* out,
                       int M, int N, int KB, int kbps, int fivelevel,
                       int sub_blocks, int m_tiles, const ExpertStrides& es) {
#define INT8_LAUNCH(MODE)                                                   \
  launch_tile<kWM, MODE>(grid, stream, xq, xscale, plane2, plane1, scales, \
                         zps, out, M, N, KB, kbps, fivelevel, sub_blocks,  \
                         m_tiles, es)
  switch (mode) {
    case kBlock: return INT8_LAUNCH(kBlock);
    case kSub32: return INT8_LAUNCH(kSub32);
    default: return INT8_LAUNCH(kSubAny);
  }
#undef INT8_LAUNCH
}

// Grid (ceil(N / 64), E * ceil(M / bm), splits), bm 32 or 64, in clusters
// of the splits (at most 8, the portable cluster size); y walks the row
// tiles of expert 0, then expert 1, ... of a stack of E matrices (E = 1:
// one matrix), each expert's operands at the strides given (in elements)
// from the base pointers. The KB blocks are cut into splits runs of
// ceil(KB / splits), which must leave none empty. sub_blocks is 0 or any
// divisor of 256. xq must be 16-byte aligned.
extern "C" int itq3_matmul_int8_launch(const int8_t* xq, const float* xscale,
                                       const uint8_t* plane2,
                                       const uint8_t* plane1,
                                       const __half* scales, const __half* zps,
                                       float* out, int M, int N, int KB,
                                       int fivelevel, int sub_blocks, int bm,
                                       int splits, int E, long long sx,
                                       long long sxscale, long long splane2,
                                       long long splane1, long long sscales,
                                       long long szps, long long sout,
                                       cudaStream_t stream) {
  if (M < 1 || N < 1 || KB < 1 || splits < 1 || splits > KB ||
      splits > kMaxSplits || sub_blocks < 0 || sub_blocks > 256 ||
      (sub_blocks && 256 % sub_blocks) || ((uintptr_t)xq & 15) || E < 1 ||
      (sx & 15) || (bm != 32 && bm != 64))
    return (int)cudaErrorInvalidValue;
  const int kbps = (KB + splits - 1) / splits;
  if ((KB + kbps - 1) / kbps != splits) return (int)cudaErrorInvalidValue;
  const int m_tiles = (M + bm - 1) / bm;
  if ((long long)E * m_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kBN - 1) / kBN, E * m_tiles, splits);
  const ExpertStrides es = {sx,     sxscale, splane2, splane1,
                            sscales, szps,   sout};
  const int mode = int8_scale_mode(sub_blocks);
  switch (bm) {
    case 32: return launch_rows<2>(mode, grid, stream, xq, xscale, plane2,
                                   plane1, scales, zps, out, M, N, KB, kbps,
                                   fivelevel, sub_blocks, m_tiles, es);
    case 64: return launch_rows<4>(mode, grid, stream, xq, xscale, plane2,
                                   plane1, scales, zps, out, M, N, KB, kbps,
                                   fivelevel, sub_blocks, m_tiles, es);
    default: return (int)cudaErrorInvalidValue;
  }
}
