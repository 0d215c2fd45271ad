// Online-softmax attention of rotated f32 queries over the rotated-int8 KV
// cache, dense or paged layout. Returns the unnormalized (acc, m, l) triple
// with the reference kernel's conventions.
//
// Replaces: repro/kernels/attn_decode.py attn_q8_pallas (_attn_q8_kernel),
// both layouts; its TQ = 1 causal-free form attn_decode_q8_pallas is the
// decode call of this kernel.
// Bound on the H100: bytes for decode (each int8 K/V code and fp16 scale is
// read once for only G query rows), operations for a wide prefill span.
// One thread block per (row r = b*KV + kv, tile of TQB query positions).
// Keys stream in tiles of 32 through shared memory, converted from int8 to
// f32 once per tile and shared by all TQB*G query rows of the block; only
// tiles below ceil(limit/32) are visited (limit = kv_len, tightened by
// causality to the block's last query), so a short row reads a short
// prefix of its cache. Within a tile a warp takes one query row: lane j
// scores key j, (q . k_codes) * k_scale * sm_scale; the warp max and sum
// update m and l; the V scale is folded into p, and each lane accumulates
// its head_dim slice of acc. Masked keys get s = -1e30 and p = 0, so an
// empty row (kv_len = 0) ends with m = -1e30, l = 0, acc = 0, never NaN.
// Decode launches only B*KV blocks; splitting the keys across blocks
// (flash-decoding) is later work.
//
// Paged layout (kPaged): K/V live in a block pool of PR = num_blocks*KV
// rows of BS keys each, and row r's logical key t is pool row
// table[r, t / BS] at offset t % BS. The TPU kernel clamps its key tile to
// divide BS, so a tile never straddles two blocks; here a tile of 32 keys
// may span several blocks (the serving block is 16 keys), so each key is
// translated on its own: per tile, the first warp writes the 32 keys' pool
// offsets into shared memory and the K/V/scale loads index through them.
// Any BS >= 1 works. Masks and the online softmax use logical positions and
// the tile order and reductions are the dense instantiation's, so a paged
// pass gives the same bits as the dense kernel over the gathered view. A
// key at or past MAXB*BS, or behind a table entry outside [0, PR), loads
// as zero, as the dense kernel's keys past T do.
#include "common.cuh"

constexpr int kKT = 32;  // keys per tile: one per lane
constexpr float kNegInf = -1e30f;

// T is the row's key count: the dense rows' length, or MAXB*BS when paged.
template <bool kPaged>
__global__ void attn_q8_kernel(
    const float* __restrict__ q, const int8_t* __restrict__ kc,
    const __half* __restrict__ ks, const int8_t* __restrict__ vc,
    const __half* __restrict__ vs, const int* __restrict__ kv_len,
    const int* __restrict__ q_offset, const int* __restrict__ table,
    float* __restrict__ acc_out, float* __restrict__ m_out,
    float* __restrict__ l_out, int TQ, int G, int HD, int T, int TQB,
    float sm_scale, int causal, int BS, int MAXB, int PR) {
  extern __shared__ float sm[];
  const int r = blockIdx.y, qt0 = blockIdx.x * TQB;
  const int nq = min(TQB, TQ - qt0);
  const int rows = nq * G;  // flattened (query, group) rows: i = qi*G + g
  float* qs = sm;                         // TQB*G x HD rotated queries
  float* as = qs + TQB * G * HD;          // TQB*G x HD running acc
  float* ms = as + TQB * G * HD;          // TQB*G running max
  float* ls = ms + TQB * G;               // TQB*G running denominator
  float* kt = ls + TQB * G;               // kKT x (HD+1) K codes as f32
  float* vt = kt + kKT * (HD + 1);        // kKT x HD V codes as f32
  float* ksc = vt + kKT * HD;             // kKT K scales
  float* vsc = ksc + kKT;                 // kKT V scales
  int* key_row = reinterpret_cast<int*>(vsc + kKT);  // kPaged: kKT pool keys
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthr >> 5;

  const long long qbase = ((long long)r * TQ + qt0) * G;  // first row index
  for (int idx = tid; idx < rows * HD; idx += nthr) {
    qs[idx] = q[qbase * HD + idx];
    as[idx] = 0.f;
  }
  for (int i = tid; i < rows; i += nthr) {
    ms[i] = kNegInf;
    ls[i] = 0.f;
  }
  const int len = kv_len[r], off = q_offset[r];
  int limit = len;
  if (causal) limit = min(limit, off + qt0 + nq);  // last query sees <= itself
  __syncthreads();

  for (int t0 = 0; t0 < limit; t0 += kKT) {
    if constexpr (kPaged) {
      // translate the tile's keys: pool key row (pool row * BS + offset),
      // -1 where there is nothing to read
      if (tid < kKT) {
        const int t = t0 + tid;
        int row = -1;
        if (t < T) {
          const int pr = table[(long long)r * MAXB + t / BS];
          if (pr >= 0 && pr < PR) row = pr * BS + t % BS;
        }
        key_row[tid] = row;
      }
      __syncthreads();
    }
    for (int idx = tid; idx < kKT * HD; idx += nthr) {
      const int j = idx / HD, d = idx - j * HD, t = t0 + j;
      float kv = 0.f, vv = 0.f;
      if constexpr (kPaged) {
        const int row = key_row[j];
        if (row >= 0) {
          const long long src = (long long)row * HD + d;
          kv = (float)kc[src];
          vv = (float)vc[src];
        }
      } else if (t < T) {
        const long long src = ((long long)r * T + t) * HD + d;
        kv = (float)kc[src];
        vv = (float)vc[src];
      }
      kt[j * (HD + 1) + d] = kv;
      vt[j * HD + d] = vv;
    }
    for (int j = tid; j < kKT; j += nthr) {
      if constexpr (kPaged) {
        const int row = key_row[j];
        ksc[j] = row >= 0 ? __half2float(ks[row]) : 0.f;
        vsc[j] = row >= 0 ? __half2float(vs[row]) : 0.f;
      } else {
        const int t = t0 + j;
        ksc[j] = t < T ? __half2float(ks[(long long)r * T + t]) : 0.f;
        vsc[j] = t < T ? __half2float(vs[(long long)r * T + t]) : 0.f;
      }
    }
    __syncthreads();
    for (int i = warp; i < rows; i += nwarps) {
      const int t = t0 + lane;
      const int qpos = off + qt0 + i / G;
      const bool valid = t < len && (!causal || t <= qpos);
      const float* qrow = qs + i * HD;
      const float* krow = kt + lane * (HD + 1);
      float s = 0.f;
      for (int d = 0; d < HD; ++d) s += qrow[d] * krow[d];
      s = s * (ksc[lane] * sm_scale);
      if (!valid) s = kNegInf;
      const float m_old = ms[i];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float alpha = expf(m_old - m_new);
      const float p = valid ? expf(s - m_new) : 0.f;
      const float psum = warp_sum(p);
      const float pv = p * vsc[lane];
      for (int d = lane; d < HD; d += 32) {  // HD % 32 == 0: warp-uniform
        float a = 0.f;
#pragma unroll 8
        for (int j = 0; j < kKT; ++j)
          a += __shfl_sync(FULL_MASK, pv, j) * vt[j * HD + d];
        as[i * HD + d] = as[i * HD + d] * alpha + a;
      }
      __syncwarp();
      if (lane == 0) {
        ms[i] = m_new;
        ls[i] = ls[i] * alpha + psum;
      }
      __syncwarp();
    }
    __syncthreads();
  }

  for (int idx = tid; idx < rows * HD; idx += nthr)
    acc_out[qbase * HD + idx] = as[idx];
  for (int i = tid; i < rows; i += nthr) {
    m_out[qbase + i] = ms[i];
    l_out[qbase + i] = ls[i];
  }
}

template <bool kPaged>
static int launch(const float* q, const int8_t* kc, const __half* ks,
                  const int8_t* vc, const __half* vs, const int* kv_len,
                  const int* q_offset, const int* table, float* acc_out,
                  float* m_out, float* l_out, int R, int TQ, int G, int HD,
                  int T, int TQB, float sm_scale, int causal, int BS, int MAXB,
                  int PR, cudaStream_t stream) {
  if (R < 1 || TQ < 1 || G < 1 || TQB < 1 || HD < 32 || HD > 128 ||
      (HD & (HD - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(float) *
                       (2 * TQB * G * HD + 2 * TQB * G + kKT * (2 * HD + 1) +
                        2 * kKT) +
                   (kPaged ? (int)sizeof(int) * kKT : 0);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_q8_kernel<kPaged>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((TQ + TQB - 1) / TQB, R);
  attn_q8_kernel<kPaged><<<grid, 128, smem, stream>>>(
      q, kc, ks, vc, vs, kv_len, q_offset, table, acc_out, m_out, l_out, TQ,
      G, HD, T, TQB, sm_scale, causal, BS, MAXB, PR);
  return (int)cudaGetLastError();
}

extern "C" int attn_q8_launch(const float* q, const int8_t* kc,
                              const __half* ks, const int8_t* vc,
                              const __half* vs, const int* kv_len,
                              const int* q_offset, float* acc_out,
                              float* m_out, float* l_out, int R, int TQ, int G,
                              int HD, int T, int TQB, float sm_scale,
                              int causal, cudaStream_t stream) {
  return launch<false>(q, kc, ks, vc, vs, kv_len, q_offset, nullptr, acc_out,
                       m_out, l_out, R, TQ, G, HD, T, TQB, sm_scale, causal, 1,
                       1, 0, stream);
}

// Pooled planes: codes (PR, BS, HD) int8, scales (PR, BS) f16; table
// (R, MAXB) int32 pool rows (the head offset folded in by the caller).
extern "C" int attn_q8_paged_launch(
    const float* q, const int8_t* kc, const __half* ks, const int8_t* vc,
    const __half* vs, const int* kv_len, const int* q_offset,
    const int* table, float* acc_out, float* m_out, float* l_out, int R,
    int TQ, int G, int HD, int PR, int BS, int MAXB, int TQB, float sm_scale,
    int causal, cudaStream_t stream) {
  if (PR < 1 || BS < 1 || MAXB < 1 || (long long)PR * BS > 0x7fffffffLL ||
      (long long)MAXB * BS > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  return launch<true>(q, kc, ks, vc, vs, kv_len, q_offset, table, acc_out,
                      m_out, l_out, R, TQ, G, HD, MAXB * BS, TQB, sm_scale,
                      causal, BS, MAXB, PR, stream);
}
