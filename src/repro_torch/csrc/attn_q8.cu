// Online-softmax attention of rotated f32 queries over the rotated-int8 KV
// cache, dense or paged layout. Returns the unnormalized (acc, m, l) triple
// with the reference kernel's conventions.
//
// Replaces: repro/kernels/attn_decode.py attn_q8_pallas (_attn_q8_kernel),
// both layouts; its TQ = 1 causal-free form attn_decode_q8_pallas is the
// decode call of this kernel.
// Bound on the H100: bytes for decode (each int8 K/V code and fp16 scale is
// read once for only G query rows), operations for a wide prefill span.
// Neither holds it back: at the serving shapes (R = B*KV = 12 rows, T =
// 256) the work is a few microseconds of latency, so what costs time is
// too few blocks, serial dependent chains and loads that do not overlap
// the math. The design, against each:
//
// - Keys split across blocks (flash-decoding). The grid is (key splits,
//   query tiles, R). A split is a contiguous run of ST whole 32-key tiles
//   counted on logical positions, so the dense and paged instantiations cut
//   at the same keys; the wrapper sizes ST from the static shapes, one tile
//   while that gives at most 16 splits, which filled the card best of the
//   cuts timed (decode: 8 splits x 12 rows = 96 blocks; prefill TQ = 64:
//   8 x 7 query tiles x 12 = 672). limit =
//   kv_len, clamped to T and narrowed by causality to the query tile's last
//   query; only splits below it run, the others exit at once. With one such
//   split, split 0 writes the result itself (with none: the empty result
//   m = -1e30, l = 0, acc = 0). Otherwise each split writes its partial
//   (acc, m, l) to a workspace, and the last block of the (row, query tile)
//   to arrive, found through an atomicAdd ticket after a __threadfence(),
//   combines them in split order: m = max m_s, l = sum l_s*e^(m_s - m),
//   acc = sum acc_s*e^(m_s - m), and resets the ticket to 0 for the next
//   call. The order, not the arrival, fixes the sums: deterministic.
// - Registers, not shared memory, for the running state. A block holds up
//   to 32 query rows (TQB query positions x G heads). Warp w scores rows
//   w, w+8, w+16, w+24 against key = lane, with two independent partial
//   sums per row, and keeps those rows' m and l in registers; the V scale
//   folds into p, which goes to shared memory with each row's rescale
//   factor. Each thread owns 4 contiguous head_dim columns of 1-4 rows of
//   acc (HD = 32..128) in registers for the whole key loop and reads p from
//   shared memory, 4 keys per 16-byte load. The launch bounds ask for 3
//   blocks per SM (2 at HD = 128), which holds ptxas to 80 registers (128)
//   with no spill; without them the HD = 64 body spilled.
// - 16-byte loads of the codes, staged ahead. A 32-key tile of one row is
//   32*HD contiguous codes per plane (dense) or HD contiguous codes per key
//   (paged); each is copied with cp.async, 16 codes per copy, into one of
//   two shared buffers while the other tile is computed, and converted from
//   int8 to f32 when read from shared memory. The K tile's rows are padded
//   by 16 bytes so the 16-byte reads of 32 keys hit distinct banks.
//   The wrapper refuses code planes that are not 16-byte aligned.
//
// Masked keys get s = -1e30 and p = 0, so a row with no valid key in a
// split ends that split with m = -1e30, l = 0, acc = 0, and an empty row
// never yields -inf or NaN. The math stays f32 on the CUDA cores: f16 tiles
// would break the 1e-4 agreement with the plain version. Tensor-core tiles
// for the wide prefill spans, with q and p split into hi/lo f16 halves to
// keep f32 accuracy, are the next step.
//
// Paged layout (kPaged): K/V live in a block pool of PR = num_blocks*KV
// rows of BS keys each, and row r's logical key t is pool row
// table[r, t / BS] at offset t % BS. The TPU kernel clamps its key tile to
// divide BS; here a 32-key tile may span several blocks (the serving block
// is 16 keys), so each key is translated on its own: a block first writes
// its split's pool offsets into shared memory and the loads index through
// them. Any BS >= 1 works. Only the address of a key differs between the
// two instantiations, so a paged pass gives the same bits as the dense
// kernel over the gathered view. A key at or past MAXB*BS, or behind a
// table entry outside [0, PR), loads as zero, as the dense keys past T do.
#include "common.cuh"

constexpr int kKT = 32;             // keys per tile: one per lane
constexpr int kThreads = 256;       // 8 warps
constexpr int kRows = 32;           // query rows a block holds (TQB*G)
constexpr int kMaxSplitTiles = 16;  // tiles per split (the paged offsets)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void unpack4(int w, float f[4]) {
  const char4 c = *reinterpret_cast<const char4*>(&w);
  f[0] = (float)c.x;
  f[1] = (float)c.y;
  f[2] = (float)c.z;
  f[3] = (float)c.w;
}

// T is the row's key count: the dense rows' length, or MAXB*BS when paged.
// ws holds the partials of nsplit = gridDim.x splits: acc (nsplit, R*TQ*G,
// HD), then m and l (nsplit, R*TQ*G); ticket is (R, query tiles) int32,
// zero between calls.
template <bool kPaged, int HD>
__global__ void __launch_bounds__(kThreads, HD >= 128 ? 2 : 3)
    attn_q8_kernel(
    const float* __restrict__ q, const int8_t* __restrict__ kc,
    const __half* __restrict__ ks, const int8_t* __restrict__ vc,
    const __half* __restrict__ vs, const int* __restrict__ kv_len,
    const int* __restrict__ q_offset, const int* __restrict__ table,
    float* __restrict__ acc_out, float* __restrict__ m_out,
    float* __restrict__ l_out, float* __restrict__ ws,
    int* __restrict__ ticket, int TQ, int G, int T, int TQB, int ST,
    float sm_scale, int causal, int BS, int MAXB, int PR) {
  constexpr int kPitchK = HD + 16;  // bytes per key of the K tile
  constexpr int kChunks = HD / 16;  // 16-byte copies per key and plane
  constexpr int kCG = HD / 4;       // 4-column groups of acc
  constexpr int kRowStride = kThreads / kCG;
  constexpr int kAccRows = kRows / kRowStride;  // acc rows per thread
  constexpr int kScoreRows = kRows / (kThreads / 32);
  constexpr int kPitchP = kKT + 4;

  __shared__ __align__(16) float qs[kRows * HD];
  __shared__ __align__(16) int8_t kt[2][kKT * kPitchK];
  __shared__ __align__(16) int8_t vt[2][kKT * HD];
  __shared__ float sc[2][2 * kKT];  // [buffer][K scales | V scales]
  __shared__ __align__(16) float ps[kRows * kPitchP];
  __shared__ float alpha_s[kRows];
  __shared__ int key_row[kPaged ? kMaxSplitTiles * kKT : 1];
  __shared__ int is_last;

  const int s = blockIdx.x, qt = blockIdx.y, r = blockIdx.z;
  const int nsplit = gridDim.x;
  const int qt0 = qt * TQB, nq = min(TQB, TQ - qt0);
  const int rows = nq * G;  // flattened (query, group) rows: i = qi*G + g
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = min(kv_len[r], T), off = q_offset[r];
  int limit = len;
  if (causal) limit = min(limit, off + qt0 + nq);  // last query sees <= itself
  limit = max(limit, 0);
  const int sk = ST * kKT;
  const int nused = (limit + sk - 1) / sk;  // splits below the limit
  if (s >= max(nused, 1)) return;  // split 0 always runs
  const int t_begin = s * sk;
  const int ntiles = (min(t_begin + sk, limit) - t_begin + kKT - 1) / kKT;
  const long long qbase = ((long long)r * TQ + qt0) * G;  // first row index

  if constexpr (kPaged) {
    for (int j = tid; j < ntiles * kKT; j += kThreads) {
      const int t = t_begin + j;
      int row = -1;
      if (t < T) {
        const int pr = table[(long long)r * MAXB + t / BS];
        if (pr >= 0 && pr < PR) row = pr * BS + t % BS;
      }
      key_row[j] = row;
    }
    __syncthreads();
  }

  // the tile's codes into buffer buf: 2 planes x 32 keys x kChunks copies
  auto stage = [&](int it, int buf) {
    for (int idx = tid; idx < 2 * kKT * kChunks; idx += kThreads) {
      const int plane = idx / (kKT * kChunks);
      const int rem = idx - plane * (kKT * kChunks);
      const int j = rem / kChunks, c = rem - j * kChunks;
      long long key;
      bool ok;
      if constexpr (kPaged) {
        key = key_row[it * kKT + j];
        ok = key >= 0;
      } else {
        const int t = t_begin + it * kKT + j;
        key = (long long)r * T + t;
        ok = t < T;
      }
      const int8_t* base = plane ? vc : kc;
      const int8_t* src = ok ? base + key * HD + c * 16 : base;
      int8_t* dst = plane ? &vt[buf][j * HD + c * 16]
                          : &kt[buf][j * kPitchK + c * 16];
      cp_async16(dst, src, ok);
    }
    cp_async_commit();
  };
  // threads 0..63: the K (0..31) or V (32..63) scale of the tile's key
  auto scale_of = [&](int it) -> float {
    const int j = tid & 31;
    const __half* p = tid < kKT ? ks : vs;
    if constexpr (kPaged) {
      const int row = key_row[it * kKT + j];
      return row >= 0 ? __half2float(p[row]) : 0.f;
    } else {
      const int t = t_begin + it * kKT + j;
      return t < T ? __half2float(p[(long long)r * T + t]) : 0.f;
    }
  };

  if (ntiles > 0) {
    stage(0, 0);
    if (tid < 2 * kKT) sc[0][tid] = scale_of(0);
  }
  for (int idx = tid; idx < rows * HD; idx += kThreads)
    qs[idx] = q[qbase * HD + idx];

  float m_r[kScoreRows], l_r[kScoreRows];
#pragma unroll
  for (int k = 0; k < kScoreRows; ++k) {
    m_r[k] = kNegInf;
    l_r[k] = 0.f;
  }
  const int cg = tid % kCG, rb = tid / kCG;
  float acc[kAccRows][4];
#pragma unroll
  for (int a = 0; a < kAccRows; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    cp_async_wait_all();
    __syncthreads();  // tile it landed; every thread is done with tile it-1
    const bool more = it + 1 < ntiles;
    float sc_next = 0.f;
    if (more) {
      stage(it + 1, buf ^ 1);
      if (tid < 2 * kKT) sc_next = scale_of(it + 1);
    }

    // scores of rows warp + 8k against key `lane`
    const int t = t_begin + it * kKT + lane;
    float a0[kScoreRows], a1[kScoreRows];
#pragma unroll
    for (int k = 0; k < kScoreRows; ++k) a0[k] = a1[k] = 0.f;
    const int4* krow = reinterpret_cast<const int4*>(&kt[buf][lane * kPitchK]);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int4 w = krow[c];
      float kf[16];
      unpack4(w.x, kf);
      unpack4(w.y, kf + 4);
      unpack4(w.z, kf + 8);
      unpack4(w.w, kf + 12);
#pragma unroll
      for (int k = 0; k < kScoreRows; ++k) {
        const int i = warp + 8 * k;
        if (i < rows) {  // warp-uniform
          const float4* qv =
              reinterpret_cast<const float4*>(&qs[i * HD + c * 16]);
          const float4 x0 = qv[0], x1 = qv[1], x2 = qv[2], x3 = qv[3];
          a0[k] = fmaf(x0.x, kf[0], a0[k]);
          a1[k] = fmaf(x0.y, kf[1], a1[k]);
          a0[k] = fmaf(x0.z, kf[2], a0[k]);
          a1[k] = fmaf(x0.w, kf[3], a1[k]);
          a0[k] = fmaf(x1.x, kf[4], a0[k]);
          a1[k] = fmaf(x1.y, kf[5], a1[k]);
          a0[k] = fmaf(x1.z, kf[6], a0[k]);
          a1[k] = fmaf(x1.w, kf[7], a1[k]);
          a0[k] = fmaf(x2.x, kf[8], a0[k]);
          a1[k] = fmaf(x2.y, kf[9], a1[k]);
          a0[k] = fmaf(x2.z, kf[10], a0[k]);
          a1[k] = fmaf(x2.w, kf[11], a1[k]);
          a0[k] = fmaf(x3.x, kf[12], a0[k]);
          a1[k] = fmaf(x3.y, kf[13], a1[k]);
          a0[k] = fmaf(x3.z, kf[14], a0[k]);
          a1[k] = fmaf(x3.w, kf[15], a1[k]);
        }
      }
    }
    const float kscale = sc[buf][lane] * sm_scale;
    const float vscale = sc[buf][kKT + lane];
#pragma unroll
    for (int k = 0; k < kScoreRows; ++k) {
      const int i = warp + 8 * k;
      if (i < rows) {
        const int qpos = off + qt0 + i / G;
        const bool valid = t < len && (!causal || t <= qpos);
        const float sv = valid ? (a0[k] + a1[k]) * kscale : kNegInf;
        const float m_new = fmaxf(m_r[k], warp_max(sv));
        const float alpha = expf(m_r[k] - m_new);
        const float p = valid ? expf(sv - m_new) : 0.f;
        l_r[k] = l_r[k] * alpha + warp_sum(p);
        m_r[k] = m_new;
        ps[i * kPitchP + lane] = valid ? p * vscale : 0.f;
        if (lane == 0) alpha_s[i] = alpha;
      }
    }
    __syncthreads();  // p and alpha of every row

    // acc[a] (row rb + a*kRowStride, columns 4cg..4cg+3) += p . V
    // (rows past `rows` compute on stale p and are never stored)
#pragma unroll
    for (int a = 0; a < kAccRows; ++a) {
      const float al = alpha_s[rb + a * kRowStride];
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] *= al;
    }
    const int8_t* vcol = &vt[buf][4 * cg];
#pragma unroll
    for (int j = 0; j < kKT; j += 4) {
      float p4[kAccRows][4];
#pragma unroll
      for (int a = 0; a < kAccRows; ++a) {
        const float4 pv = *reinterpret_cast<const float4*>(
            &ps[(rb + a * kRowStride) * kPitchP + j]);
        p4[a][0] = pv.x;
        p4[a][1] = pv.y;
        p4[a][2] = pv.z;
        p4[a][3] = pv.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float v[4];
        unpack4(*reinterpret_cast<const int*>(vcol + (j + jj) * HD), v);
#pragma unroll
        for (int a = 0; a < kAccRows; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[a][c] = fmaf(p4[a][jj], v[c], acc[a][c]);
      }
    }
    if (more && tid < 2 * kKT) sc[buf ^ 1][tid] = sc_next;
  }

  // the split's (acc, m, l): the result itself, or a partial
  const long long nrt = (long long)gridDim.z * TQ * G;  // R*TQ*G rows
  const bool direct = nused <= 1;
  float* o_acc = direct ? acc_out : ws + (long long)s * nrt * HD;
  float* o_m = direct ? m_out : ws + nsplit * nrt * HD + s * nrt;
  float* o_l = direct ? l_out : ws + nsplit * nrt * (HD + 1) + s * nrt;
#pragma unroll
  for (int a = 0; a < kAccRows; ++a) {
    const int i = rb + a * kRowStride;
    if (i < rows)
      *reinterpret_cast<float4*>(&o_acc[(qbase + i) * HD + 4 * cg]) =
          make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
  }
#pragma unroll
  for (int k = 0; k < kScoreRows; ++k) {
    const int i = warp + 8 * k;
    if (i < rows && lane == 0) {
      o_m[qbase + i] = m_r[k];
      o_l[qbase + i] = l_r[k];
    }
  }
  if (direct) return;

  // the last of the nused blocks of this (row, query tile) combines
  __threadfence();  // partials visible before the ticket
  __syncthreads();
  if (tid == 0) {
    int* tk = ticket + (long long)r * gridDim.y + qt;
    is_last = atomicAdd(tk, 1) == nused - 1;
    if (is_last) *tk = 0;  // every block has taken its ticket: reset
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float* w_acc = ws;
  const float* w_m = ws + nsplit * nrt * HD;
  const float* w_l = w_m + nsplit * nrt;
#pragma unroll
  for (int a = 0; a < kAccRows; ++a) {
    const int i = rb + a * kRowStride;
    if (i >= rows) continue;
    const long long row = qbase + i;
    float mx = kNegInf;
    for (int sp = 0; sp < nused; ++sp)
      mx = fmaxf(mx, __ldcg(&w_m[sp * nrt + row]));
    float l = 0.f, o[4] = {0.f, 0.f, 0.f, 0.f};
    for (int sp = 0; sp < nused; ++sp) {  // in split order
      const float e = expf(__ldcg(&w_m[sp * nrt + row]) - mx);
      l = fmaf(__ldcg(&w_l[sp * nrt + row]), e, l);
      const float4 p = __ldcg(reinterpret_cast<const float4*>(
          &w_acc[(sp * nrt + row) * HD + 4 * cg]));
      o[0] = fmaf(p.x, e, o[0]);
      o[1] = fmaf(p.y, e, o[1]);
      o[2] = fmaf(p.z, e, o[2]);
      o[3] = fmaf(p.w, e, o[3]);
    }
    *reinterpret_cast<float4*>(&acc_out[row * HD + 4 * cg]) =
        make_float4(o[0], o[1], o[2], o[3]);
    if (cg == 0) {
      m_out[row] = mx;
      l_out[row] = l;
    }
  }
}

template <bool kPaged, int HD>
static int launch_hd(dim3 grid, cudaStream_t stream, const float* q,
                     const int8_t* kc, const __half* ks, const int8_t* vc,
                     const __half* vs, const int* kv_len, const int* q_offset,
                     const int* table, float* acc_out, float* m_out,
                     float* l_out, float* ws, int* ticket, int TQ, int G,
                     int T, int TQB, int ST, float sm_scale, int causal,
                     int BS, int MAXB, int PR) {
  attn_q8_kernel<kPaged, HD><<<grid, kThreads, 0, stream>>>(
      q, kc, ks, vc, vs, kv_len, q_offset, table, acc_out, m_out, l_out, ws,
      ticket, TQ, G, T, TQB, ST, sm_scale, causal, BS, MAXB, PR);
  return (int)cudaGetLastError();
}

// Grid (ceil(T / (ST*32)) splits, ceil(TQ / TQB) query tiles, R). ws must
// hold nsplit*R*TQ*G*(HD + 2) floats when there is more than one split,
// ticket R*ceil(TQ/TQB) zeroed ints.
template <bool kPaged>
static int launch(const float* q, const int8_t* kc, const __half* ks,
                  const int8_t* vc, const __half* vs, const int* kv_len,
                  const int* q_offset, const int* table, float* acc_out,
                  float* m_out, float* l_out, float* ws, int* ticket, int R,
                  int TQ, int G, int HD, int T, int TQB, int ST,
                  float sm_scale, int causal, int BS, int MAXB, int PR,
                  cudaStream_t stream) {
  if (R < 1 || R > 65535 || TQ < 1 || G < 1 || TQB < 1 || TQB * G > kRows ||
      T < 0 || ST < 1 || ST > kMaxSplitTiles)
    return (int)cudaErrorInvalidValue;
  const int nsplit = max(1, (T + ST * kKT - 1) / (ST * kKT));
  const dim3 grid(nsplit, (TQ + TQB - 1) / TQB, R);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
#define ATTN_LAUNCH(D)                                                      \
  launch_hd<kPaged, D>(grid, stream, q, kc, ks, vc, vs, kv_len, q_offset,   \
                       table, acc_out, m_out, l_out, ws, ticket, TQ, G, T,  \
                       TQB, ST, sm_scale, causal, BS, MAXB, PR)
  switch (HD) {
    case 32: return ATTN_LAUNCH(32);
    case 64: return ATTN_LAUNCH(64);
    case 128: return ATTN_LAUNCH(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ATTN_LAUNCH
}

extern "C" int attn_q8_launch(const float* q, const int8_t* kc,
                              const __half* ks, const int8_t* vc,
                              const __half* vs, const int* kv_len,
                              const int* q_offset, float* acc_out,
                              float* m_out, float* l_out, float* ws,
                              int* ticket, int R, int TQ, int G, int HD, int T,
                              int TQB, int ST, float sm_scale, int causal,
                              cudaStream_t stream) {
  return launch<false>(q, kc, ks, vc, vs, kv_len, q_offset, nullptr, acc_out,
                       m_out, l_out, ws, ticket, R, TQ, G, HD, T, TQB, ST,
                       sm_scale, causal, 1, 1, 0, stream);
}

// Pooled planes: codes (PR, BS, HD) int8, scales (PR, BS) f16; table
// (R, MAXB) int32 pool rows (the head offset folded in by the caller).
extern "C" int attn_q8_paged_launch(
    const float* q, const int8_t* kc, const __half* ks, const int8_t* vc,
    const __half* vs, const int* kv_len, const int* q_offset,
    const int* table, float* acc_out, float* m_out, float* l_out, float* ws,
    int* ticket, int R, int TQ, int G, int HD, int PR, int BS, int MAXB,
    int TQB, int ST, float sm_scale, int causal, cudaStream_t stream) {
  if (PR < 1 || BS < 1 || MAXB < 1 || (long long)PR * BS > 0x7fffffffLL ||
      (long long)MAXB * BS > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  return launch<true>(q, kc, ks, vc, vs, kv_len, q_offset, table, acc_out,
                      m_out, l_out, ws, ticket, R, TQ, G, HD, MAXB * BS, TQB,
                      ST, sm_scale, causal, BS, MAXB, PR, stream);
}
