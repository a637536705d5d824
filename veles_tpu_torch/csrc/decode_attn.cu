// Decode attention for Hopper (sm_90a), written by hand: one body, two
// entry points that differ only in where key `pos` of a row lies.
//
// `veles_decode_attn` replaces the TPU kernel veles_tpu/ops/attention.py
// `_decode_kernel`, reached through `_decode_pallas` from
// `decode_attention` (and, with row_step = 1, from `verify_attention`):
// the keys of (b, h) lie in a (b, S, h, d) cache at
// k + b*ksb + pos*kss + h*ksh.
//
// `veles_paged_decode_attn` replaces `_paged_decode_kernel`, reached
// through `_paged_decode_pallas` from `paged_decode_attention`
// (row_step = 0) and `paged_verify_attention` (row_step = 1): the keys
// lie in a shared (num_blocks, BS, h, d) page pool, found through the
// row's block table, at
// pool + tables[b, pos / BS]*block_stride + (pos % BS)*row_stride
//      + h*head_stride.
// Each key is translated on its own, so a 32-key chunk may straddle
// pages and any BS >= 1 works; a 16-byte copy stays inside one key row.
// Table entries past a row's allocation point at the trash block 0,
// whose keys lie past the row's limit and are never read.
//
// Up to 8 query rows of each (batch, head) attend to the first
// lengths[b] keys; row r may read keys < lengths[b] + row_step * r.
// Masked scores are -1e30 and the final l is clamped at 1e-30, as in the
// TPU kernels.  Both entries share the partition of the keys, the order
// of keys and the merge, so a paged read of a pool that mirrors a
// contiguous cache gives the contiguous kernel's output bit for bit.
//
// What bounds it on the H100: bytes.  A decode step reads every valid
// K and V row once and does 4 d operations per key and query row, about
// one operation per byte in bf16, far below the ~295 operations a byte
// at which the tensor cores would become the limit.  At the serving
// shape (4 slots x 16 heads, lengths up to 2048) there are only 64
// (b, h) rows for 132 SMs, and the longest rows hold most of the bytes.
//
// Design (flash-decoding over a thread block cluster):
// * Grid (b*h, split), one cluster of `split` (1..8) blocks a (b, h) row.
//   The host picks the split from b*h alone (`ops/attention.py
//   :decode_split`); it cannot see the lengths, which stay on the device.
//   Each block computes the row's key limit kend from `lengths` and takes
//   its rank's share of [0, kend) in whole 32-key chunks: chunks
//   [rank*C/split, (rank+1)*C/split) of C = ceil(kend / 32).  The
//   partition depends on (split, kend) only, never on the cache's size,
//   so the two entries split a row alike.  Short rows finish at once;
//   the longest is spread over 8 SMs.
// * Inside a block each warp takes every WARPS-th chunk of its rank's
//   share and streams it through its own ring of `STAGES` chunks in
//   shared memory, filled by `cp.async` in the storage type (16 bytes a
//   lane, zero-filled past kend and past d), so the next chunk loads
//   while one computes.  K rows are XOR-swizzled by 16-byte chunk: lane j
//   owns key j of the chunk and reads its K row from shared memory
//   without bank conflicts; q (scaled, f32) is read by every lane alike.
//   The online softmax keeps (m, acc) per warp and l per lane (summed
//   once at the end); masked keys weigh exactly 0.  For P.V each lane
//   owns d/32 neighbouring columns.  A build carries NQ = 1 query row
//   (decode, no per-row branches) or up to MAXQ (verify).
// * The warps' (m, l, acc) merge in warp order into the block's partial,
//   which each block pushes into the shared memory of the ranks that own
//   its outputs (rank x owns a slice of the nq*d outputs and receives
//   every rank's acc for it, and every rank's m and l); after one cluster
//   barrier each rank merges its slice in rank order from its own
//   memory, so no block waits for the others to leave.  An empty rank's
//   partial (m = -1e30, l = 0, acc = 0) weighs nothing.  No atomics, no
//   second kernel, no scratch tensor: one launch a call, and a relaunch
//   gives the same bits.
// * 32 KB of rings a block (two warps at D <= 64 in bf16 and D = 32 in
//   f32, one for wider rows), about 34 KB in all at D = 64 in bf16: six
//   blocks an SM, so the 512 blocks of the serving shape (split 8) are
//   resident at once and the longest rows do not wait for a second
//   wave.  A timed probe on the card (scripts/decode_probe.py) found 48
//   and 64 KB (three and four warps) slower at the serving decode, where
//   their blocks spilled into a second wave.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace cg = cooperative_groups;

// a test build may plant a fault in the cluster merge (1: the last rank's
// partial dropped; 2: the last rank's acc taken without rescaling by its
// m), which the card checks must report; 0 in every other build
#ifndef VELES_PLANTED_FAULT
#define VELES_PLANTED_FAULT 0
#endif

namespace {

constexpr int CHUNK = 32;       // keys a warp step (one a lane)
constexpr int MAXQ = 8;         // query rows (decode 1, verify <= 8)
constexpr int MAX_SPLIT = 8;    // the portable cluster size
constexpr int STAGES = 2;       // chunks in each warp's ring
constexpr int MAX_WARPS = 4;
constexpr int RING_BUDGET = 32768;   // bytes of rings a block
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// unpack one 16-byte vector of T into floats
__device__ __forceinline__ void unpack(const uint4& u, float* out, float) {
  out[0] = __uint_as_float(u.x);
  out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z);
  out[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* out,
                                       __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Where the keys of one (b, h) row lie in a contiguous (b, S, h, d) cache.
template <typename T>
struct ContiguousRow {
  const T* k;
  const T* v;
  long long kss, vss;
  __device__ __forceinline__ void at(int pos, const T*& kp,
                                     const T*& vp) const {
    kp = k + pos * kss;
    vp = v + pos * vss;
  }
};

template <typename T>
struct ContiguousKeys {
  typedef ContiguousRow<T> Row;
  const T* k;
  const T* v;
  long long ksb, kss, ksh, vsb, vss, vsh;
  __device__ __forceinline__ Row row(int b, int hh) const {
    return Row{k + b * ksb + hh * ksh, v + b * vsb + hh * vsh, kss, vss};
  }
};

// Where the keys of one (b, h) row lie in a (num_blocks, BS, h, d) page
// pool: through the row's block table.
template <typename T>
struct PagedRow {
  const T* k;
  const T* v;
  const int* table;
  int bs;
  long long kbs, krs, vbs, vrs;
  __device__ __forceinline__ void at(int pos, const T*& kp,
                                     const T*& vp) const {
    const long long page = table[pos / bs];
    const int off = pos % bs;
    kp = k + page * kbs + off * krs;
    vp = v + page * vbs + off * vrs;
  }
};

template <typename T>
struct PagedKeys {
  typedef PagedRow<T> Row;
  const T* k;
  const T* v;
  const int* tables;
  long long tsb;
  int bs;
  long long kbs, krs, khs, vbs, vrs, vhs;
  __device__ __forceinline__ Row row(int b, int hh) const {
    return Row{k + hh * khs, v + hh * vhs, tables + b * tsb, bs,
               kbs, krs, vbs, vrs};
  }
};

template <typename T> struct Bits { typedef uint32_t type; };
template <> struct Bits<__nv_bfloat16> { typedef uint16_t type; };

// A cluster barrier in two halves: every block arrives at its start and
// waits before its first write to another block's shared memory, which
// then has surely started (the write needs no other ordering).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

constexpr int clamp_warps(int w) {
  return w < 1 ? 1 : (w > MAX_WARPS ? MAX_WARPS : w);
}

// NQ: the query rows a build carries, 1 (decode) or MAXQ (verify: nq <=
// MAXQ at run time)
template <typename T, int D, int NQ>
struct Shape {
  static constexpr int VEC = 16 / sizeof(T);        // elements in 16 bytes
  static constexpr int NCH = D / VEC;               // 16-byte chunks a row
  static constexpr int CP = D / 32;                 // V columns a lane owns
  static constexpr int TILE = CHUNK * D * sizeof(T);     // one tensor
  static constexpr int STAGE = 2 * TILE;                 // K and V
  static constexpr int WARPS = clamp_warps(RING_BUDGET / (STAGES * STAGE));
  static constexpr int RING = WARPS * STAGES * STAGE;
  // after the loop the rings hold the warps' partials (m, l, acc) in f32
  static constexpr int MERGE = 4 * WARPS * NQ * (D + 2);
  static constexpr int WORK = ((RING > MERGE ? RING : MERGE) + 15) / 16 * 16;
  // f32 beside the rings: q [NQ][D], each warp's p [NQ][CHUNK], and what
  // the cluster's ranks push: their m and l [MAX_SPLIT][NQ] and their
  // acc for this rank's slice of the outputs [split][slice]
  static constexpr int RECV = NQ * D + MAX_SPLIT;
  static constexpr int FLOATS =
      NQ * D + WARPS * NQ * CHUNK + 2 * MAX_SPLIT * NQ + RECV;
  static constexpr size_t SMEM = WORK + sizeof(float) * FLOATS;
};

// Copy keys [k0, k0 + CHUNK) of one row into a ring stage: K swizzled by
// 16-byte chunk (lane j reads row j), V in rows.  Keys at or past kend
// and columns past d land as zeros.  `vec` says that rows are 16-byte
// aligned with d a multiple of the vector width (cp.async); otherwise
// ordinary loads fill the same layout.
template <typename T, int D, typename Row>
__device__ __forceinline__ void load_chunk(const Row& keys, int k0, int kend,
                                           int d, bool vec, int lane,
                                           uint32_t s_k, uint32_t s_v) {
  typedef Shape<T, D, 1> S;
#pragma unroll
  for (int i = 0; i < S::NCH; ++i) {
    const int e = lane + 32 * i;
    const int r = e / S::NCH, c = e % S::NCH;
    const int pos = k0 + r;
    const uint32_t dk = s_k + swz<S::NCH * 8>(r, c) * 16;
    const uint32_t dv = s_v + (r * S::NCH + c) * 16;
    const T *kp = keys.k, *vp = keys.v;
    if (pos < kend) keys.at(pos, kp, vp);
    if (vec) {
      const bool in = pos < kend && c * S::VEC < d;
      cp_async16(dk, in ? kp + c * S::VEC : keys.k, in ? 16 : 0);
      cp_async16(dv, in ? vp + c * S::VEC : keys.v, in ? 16 : 0);
    } else {
      // the elements' bits (all zero bits are 0.0 in both types)
      typedef typename Bits<T>::type B;
      union { uint4 u; B x[S::VEC]; } wk, wv;
      const B* kb = reinterpret_cast<const B*>(kp);
      const B* vb = reinterpret_cast<const B*>(vp);
#pragma unroll
      for (int j = 0; j < S::VEC; ++j) {
        const int col = c * S::VEC + j;
        const bool in = pos < kend && col < d;
        wk.x[j] = in ? kb[col] : B(0);
        wv.x[j] = in ? vb[col] : B(0);
      }
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                   :: "r"(dk), "r"(wk.u.x), "r"(wk.u.y), "r"(wk.u.z),
                      "r"(wk.u.w) : "memory");
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                   :: "r"(dv), "r"(wv.u.x), "r"(wv.u.y), "r"(wv.u.z),
                      "r"(wv.u.w) : "memory");
    }
  }
}

// A lane's CP neighbouring columns of one V row in shared memory, as f32.
template <int CP>
__device__ __forceinline__ void load_cols(const float* p, float (&out)[CP]) {
  if constexpr (CP == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else if constexpr (CP == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  } else {
    out[0] = p[0];
  }
}
template <int CP>
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p,
                                          float (&out)[CP]) {
  if constexpr (CP == 1) {
    out[0] = __bfloat162float(p[0]);
  } else {
#pragma unroll
    for (int w = 0; w < CP / 2; ++w) {
      const uint32_t x = reinterpret_cast<const uint32_t*>(p)[w];
      out[2 * w] = __uint_as_float(x << 16);
      out[2 * w + 1] = __uint_as_float(x & 0xffff0000u);
    }
  }
}

// kmax: the keys a row can hold (S, or max_blocks * BS for a pool).
template <typename T, int D, int NQ, typename Keys>
__global__ void __launch_bounds__(Shape<T, D, NQ>::WARPS * 32)
decode_kernel_split(const T* __restrict__ q, const Keys keys,
                    const int* __restrict__ lengths, T* __restrict__ o,
                    int h, int nq, int kmax, int d, long long qsb,
                    long long qss, long long qsh, int row_step, int vec,
                    float scale) {
  typedef Shape<T, D, NQ> S;
  constexpr int WARPS = S::WARPS;
  constexpr int THREADS = WARPS * 32;
  constexpr int CP = S::CP;
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_q = reinterpret_cast<float*>(smem + S::WORK);
  float* s_p = s_q + NQ * D;
  float* r_m = s_p + WARPS * NQ * CHUNK;
  float* r_l = r_m + MAX_SPLIT * NQ;
  float* r_acc = r_l + MAX_SPLIT * NQ;

  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x;
  const int b = bh / h, hh = bh % h;
  const int len = lengths[b];
  // no key past the longest query row's limit is read, nor past the
  // row's end (a pool's last table entry)
  const int kend = min(kmax, len + row_step * (nq - 1));
  const int chunks = (kend + CHUNK - 1) / CHUNK;
  const int c_begin = rank * chunks / split;
  const int c_end = (rank + 1) * chunks / split;
  // this warp's chunks: c_begin + warp, + WARPS, ...
  const int mine = c_end - c_begin > warp
                       ? (c_end - c_begin - warp + WARPS - 1) / WARPS : 0;

  const typename Keys::Row row = keys.row(b, hh);
  const uint32_t ring = smem_addr(smem) + warp * STAGES * S::STAGE;
  auto load = [&](int i) {
    const uint32_t st = ring + (i % STAGES) * S::STAGE;
    load_chunk<T, D>(row, (c_begin + warp + i * WARPS) * CHUNK, kend, d,
                     vec != 0, lane, st, st + S::TILE);
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < mine) load(i);
    cp_async_commit();
  }

  const T* qb = q + b * qsb + hh * qsh;
#pragma unroll
  for (int e = tid; e < NQ * D; e += THREADS) {
    const int r = e / D, c = e % D;
    float x = 0.f;
    if (r < nq && c < d) x = to_float(qb[r * qss + c]) * scale;
    s_q[r * D + c] = x;
  }
  __syncthreads();

  float m[NQ], l[NQ], acc[NQ][CP];
#pragma unroll
  for (int r = 0; r < NQ; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < CP; ++c) acc[r][c] = 0.f;
  }
  float* p_w = s_p + warp * NQ * CHUNK;

  for (int i = 0; i < mine; ++i) {
    if (i + STAGES - 1 < mine) load(i + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();          // chunk i landed (own copies)
    __syncwarp();                         // ... and the warp's
    const int k0 = (c_begin + warp + i * WARPS) * CHUNK;
    const unsigned char* st = smem + warp * STAGES * S::STAGE +
                              (i % STAGES) * S::STAGE;

    // scores: lane j owns key k0 + j and reads its K row; two partial
    // sums a row (even and odd 16-byte chunks) for independent FMAs
    float s[NQ][2];
#pragma unroll
    for (int r = 0; r < NQ; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll
    for (int c = 0; c < S::NCH; ++c) {
      const uint4 u = *reinterpret_cast<const uint4*>(
          st + swz<S::NCH * 8>(lane, c) * 16);
      float kf[S::VEC];
      unpack(u, kf, T());
#pragma unroll
      for (int r = 0; r < NQ; ++r) {
        if (NQ == 1 || r < nq) {
#pragma unroll
          for (int v = 0; v < S::VEC / 4; ++v) {
            const float4 x = *reinterpret_cast<const float4*>(
                s_q + r * D + c * S::VEC + 4 * v);
            float& sr = s[r][c & 1];
            sr = fmaf(x.x, kf[4 * v], sr);
            sr = fmaf(x.y, kf[4 * v + 1], sr);
            sr = fmaf(x.z, kf[4 * v + 2], sr);
            sr = fmaf(x.w, kf[4 * v + 3], sr);
          }
        }
      }
    }
    const int kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < NQ; ++r) {
      if (NQ > 1 && r >= nq) break;
      const bool valid = kpos < kend && kpos < len + row_step * r;
      const float sv = valid ? s[r][0] + s[r][1] : NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float p = valid ? expf(sv - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + p;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < CP; ++c) acc[r][c] *= alpha;
      p_w[r * CHUNK + lane] = p;
    }
    __syncwarp();

    // P.V: lane owns columns lane*CP ...; keys past kend weigh 0 and their
    // V rows are zeros, so whole groups of 4 keys run unmasked
    const T* vt = reinterpret_cast<const T*>(st + S::TILE) + lane * CP;
    const int jn = min(CHUNK, kend - k0);
#pragma unroll 2
    for (int j0 = 0; j0 < jn; j0 += 4) {
      float vj[4][CP];
#pragma unroll
      for (int j = 0; j < 4; ++j) load_cols<CP>(vt + (j0 + j) * D, vj[j]);
#pragma unroll
      for (int r = 0; r < NQ; ++r) {
        if (NQ > 1 && r >= nq) break;
        const float4 p4 = *reinterpret_cast<const float4*>(
            p_w + r * CHUNK + j0);
#pragma unroll
        for (int c = 0; c < CP; ++c) {
          acc[r][c] = fmaf(p4.x, vj[0][c], acc[r][c]);
          acc[r][c] = fmaf(p4.y, vj[1][c], acc[r][c]);
          acc[r][c] = fmaf(p4.z, vj[2][c], acc[r][c]);
          acc[r][c] = fmaf(p4.w, vj[3][c], acc[r][c]);
        }
      }
    }
    __syncwarp();                         // the stage may be refilled
  }
  cp_async_wait<0>();

  // the warps' partials into the (finished) rings
  __syncthreads();
  float* w_m = reinterpret_cast<float*>(smem);
  float* w_l = w_m + WARPS * NQ;
  float* w_acc = w_l + WARPS * NQ;
#pragma unroll
  for (int r = 0; r < NQ; ++r) {
    if (NQ > 1 && r >= nq) break;
    const float lw = warp_sum(l[r]);
    if (lane == 0) {
      w_m[warp * NQ + r] = m[r];
      w_l[warp * NQ + r] = lw;
    }
#pragma unroll
    for (int c = 0; c < CP; ++c)
      w_acc[(warp * NQ + r) * D + lane * CP + c] = acc[r][c];
  }
  __syncthreads();

  // merged in warp order into the block's partial, which is pushed to the
  // ranks that own its outputs: rank x owns outputs [x*cap, (x+1)*cap) of
  // the nq*d, and receives every rank's acc there and every rank's m, l
  const int total = nq * d;
  const int cap = (total + split - 1) / split;
  cluster_wait();
  for (int e = tid; e < total; e += THREADS) {
    const int r = e / d, c = e % d;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, w_m[w * NQ + r]);
    float lsum = 0.f, out = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(w_m[w * NQ + r] - mx);
      lsum += w_l[w * NQ + r] * f;
      out += w_acc[(w * NQ + r) * D + c] * f;
    }
    const int owner = e / cap;
    cluster.map_shared_rank(r_acc, owner)[rank * cap + e - owner * cap] = out;
    if (c == 0) {
      for (int x = 0; x < split; ++x) {
        cluster.map_shared_rank(r_m, x)[rank * NQ + r] = mx;
        cluster.map_shared_rank(r_l, x)[rank * NQ + r] = lsum;
      }
    }
  }
  // every push has landed; nothing reads another block's memory after
  // this barrier, so no block waits for the others before it leaves
  cluster.sync();

  // this rank's outputs: the ranks' partials merged in rank order
  for (int e = rank * cap + tid; e < min(total, (rank + 1) * cap);
       e += THREADS) {
    const int r = e / d, c = e % d;
    float mx = NEG_INF;
#pragma unroll
    for (int x = 0; x < MAX_SPLIT; ++x)
      if (x < split) mx = fmaxf(mx, r_m[x * NQ + r]);
    float lsum = 0.f, out = 0.f;
#pragma unroll
    for (int x = 0; x < MAX_SPLIT; ++x) {
      if (x >= split || (VELES_PLANTED_FAULT == 1 && x == split - 1))
        continue;
      const float f = expf(r_m[x * NQ + r] - mx);
      lsum += r_l[x * NQ + r] * f;
      out += r_acc[x * cap + e - rank * cap] *
             (VELES_PLANTED_FAULT == 2 && x == split - 1 ? 1.f : f);
    }
    store(o + (((long long)b * nq + r) * h + hh) * d + c,
          out / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int D, int NQ, typename Keys>
int launch(const void* q, const Keys& keys, const int* lengths, void* o,
           int b, int h, int nq, int kmax, int d, long long qsb,
           long long qss, long long qsh, int row_step, int vec, float scale,
           int split, cudaStream_t stream) {
  constexpr size_t smem = Shape<T, D, NQ>::SMEM;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_kernel_split<T, D, NQ, Keys>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(b * h, split, 1);
  config.blockDim = dim3(Shape<T, D, NQ>::WARPS * 32);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = split;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &config, decode_kernel_split<T, D, NQ, Keys>, (const T*)q, keys,
      lengths, (T*)o, h, nq, kmax, d, qsb, qss, qsh, row_step, vec, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, int D, typename Keys>
int launch_nq(const void* q, const Keys& keys, const int* lengths, void* o,
              int b, int h, int nq, int kmax, int d, long long qsb,
              long long qss, long long qsh, int row_step, int vec,
              float scale, int split, cudaStream_t stream) {
#define VELES_DECODE_ARGS                                                  \
  q, keys, lengths, o, b, h, nq, kmax, d, qsb, qss, qsh, row_step, vec,   \
      scale, split, stream
  if (nq == 1) return launch<T, D, 1>(VELES_DECODE_ARGS);
  return launch<T, D, MAXQ>(VELES_DECODE_ARGS);
}

template <typename T, typename Keys>
int dispatch_d(const void* q, const Keys& keys, const int* lengths,
               void* o, int b, int h, int nq, int kmax, int d,
               long long qsb, long long qss, long long qsh, int row_step,
               int vec, float scale, int split, cudaStream_t stream) {
  if (nq < 1 || nq > MAXQ) return (int)cudaErrorInvalidValue;
  if (split < 1 || split > MAX_SPLIT || (split & (split - 1)))
    return (int)cudaErrorInvalidValue;
  if (d <= 32) return launch_nq<T, 32>(VELES_DECODE_ARGS);
  if (d <= 64) return launch_nq<T, 64>(VELES_DECODE_ARGS);
  if (d <= 128) return launch_nq<T, 128>(VELES_DECODE_ARGS);
#undef VELES_DECODE_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q is (b, nq, h, d), k and v are
// (b, S, h, d), each with a unit stride on d and the given element strides
// on b, s and h; lengths is (b,) int32 on the device; o is a contiguous
// (b, nq, h, d) of q's type.  vec = 1 promises 16-byte aligned K/V rows
// and d a multiple of 16 / sizeof(T).  split (1, 2, 4 or 8): the blocks of
// the cluster that shares each (b, h) row's keys.  Launches on `stream`
// and returns the launch's CUDA error (0 on success).
extern "C" int veles_decode_attn(
    const void* q, const void* k, const void* v, const void* lengths,
    void* o, int dtype, int b, int h, int nq, int S, int d,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    int row_step, int vec, float scale, int split, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int* lens = (const int*)lengths;
  if (dtype == 0) {
    const ContiguousKeys<float> keys{(const float*)k, (const float*)v,
                                     ksb, kss, ksh, vsb, vss, vsh};
    return dispatch_d<float>(q, keys, lens, o, b, h, nq, S, d, qsb, qss,
                             qsh, row_step, vec, scale, split, st);
  }
  if (dtype == 1) {
    typedef __nv_bfloat16 bf16;
    const ContiguousKeys<bf16> keys{(const bf16*)k, (const bf16*)v,
                                    ksb, kss, ksh, vsb, vss, vsh};
    return dispatch_d<bf16>(q, keys, lens, o, b, h, nq, S, d, qsb, qss,
                            qsh, row_step, vec, scale, split, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The paged entry: k_pool and v_pool are (num_blocks, BS, h, d) with a
// unit stride on d and the given element strides on the block, the row
// in the block and the head; tables is (b, max_blocks) int32 on the
// device with a unit stride on its last axis and row stride tsb, every
// entry a block id of the pool.  A row reads no key at or past
// max_blocks * BS.  The rest as veles_decode_attn.
extern "C" int veles_paged_decode_attn(
    const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* lengths, void* o, int dtype, int b,
    int h, int nq, int max_blocks, int block_size, int d,
    long long qsb, long long qss, long long qsh,
    long long kbs, long long krs, long long khs,
    long long vbs, long long vrs, long long vhs, long long tsb,
    int row_step, int vec, float scale, int split, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int* lens = (const int*)lengths;
  const int* tabs = (const int*)tables;
  if (block_size < 1 || max_blocks < 1) return (int)cudaErrorInvalidValue;
  const int kmax = max_blocks * block_size;
  if (dtype == 0) {
    const PagedKeys<float> keys{(const float*)k_pool, (const float*)v_pool,
                                tabs, tsb, block_size, kbs, krs, khs,
                                vbs, vrs, vhs};
    return dispatch_d<float>(q, keys, lens, o, b, h, nq, kmax, d, qsb, qss,
                             qsh, row_step, vec, scale, split, st);
  }
  if (dtype == 1) {
    typedef __nv_bfloat16 bf16;
    const PagedKeys<bf16> keys{(const bf16*)k_pool, (const bf16*)v_pool,
                               tabs, tsb, block_size, kbs, krs, khs,
                               vbs, vrs, vhs};
    return dispatch_d<bf16>(q, keys, lens, o, b, h, nq, kmax, d, qsb, qss,
                            qsh, row_step, vec, scale, split, st);
  }
  return (int)cudaErrorInvalidValue;
}
