// The score core shared by the two tile-join kernels (sssj_cand.cu and
// sssj_dense.cu), the counterpart of the TPU kernels' common
// src/repro/kernels/sssj_join/kernel.py::_tile_scores.
//
// One thread block of NT threads owns one (bq query rows x bw window rows)
// tile, run in the compiled tile <BQ, BW> that holds it (each edge the
// smallest of 32, 64, 128 that is >= the runtime edge).  The callers
//   1. read the tile's pre-launch gate bit first: a gated-off tile writes
//      its empty outputs and returns, with no lanes staged and no decay;
//   2. stage the tile's lanes (timestamps, uids, stream ids and per-row
//      theta/lambda) in shared memory (stage_lanes) and kill the tile when
//      no decay exp(-lambda |dt|), with the uid-order, empty-slot and
//      stream masks folded in as zeros, reaches theta: a bound from the
//      hull of the window timestamps first (tile_may_live, no expf), then,
//      with the first sub-slabs' loads already in flight (tile_prefetch),
//      every decay, kept in shared memory (tile_decays_reach);
//   3. run tile_dot: q . w^T one chunk_d slab at a time, stopping once
//      (acc + |q^{>k}| |w^{>k}|) . decay < theta holds for the whole tile;
//   4. write the scores acc . decay, row-major, into shared memory
//      (scores_to_smem), from where they select or store them.
// Rows at or past bq and columns at or past bw are the compiled tile's
// spare slots: they read zeros, and take no part in the tile's kill, its
// bound check or the emission; a tile whose edges equal the compiled ones
// runs the FULL instance, compiled without the spare-slot checks.
//
// What bounds it on an H100, and the design.  The dot products must keep
// f32 accuracy (TF32 alone moves scores by ~1e-3 and pairs across theta),
// so each product is 3xTF32 on the tensor cores: x = hi + lo, hi =
// tf32(x) and lo = tf32(x - hi), and lo.hi + hi.lo + hi.hi by
// wgmma.m64nNk8 (two warpgroups: a 128-row tile gives each 64 rows, a
// narrower one half the columns).  The work is bound by those products,
// 3 x 2 x bq x bw x chunk_d per chunk run at 495 TFLOP/s of TF32.  A (the
// q rows) comes from registers, split as each thread loads its fragments;
// B (the w rows) from shared memory in the 128-byte swizzle, hi in place
// and lo beside it, split once per element by a pass over the sub-slab.
// Not mma.sync.m16n8k8: on the H100 its TF32 products ran well below
// wgmma's rate in trials, and its fragments split each operand two to
// four times over.  The tensor cores' f32 accumulation truncates; summed
// over d = 1024 in one accumulator that bias broke the 1e-5 score
// tolerance at scores near 1 on the card, so each 128 features are summed
// from zero and added to the accumulator with IEEE adds (tile_dot).  q and
// w stream through a ring of NSTAGE sub-slabs of KS columns in dynamic
// shared memory, filled by cp.async NSTAGE - 1 sub-slabs ahead of the
// tensor cores, and each sub-slab is split while the one before it is on
// the tensor cores (q, 128 x 1024 f32, is read by every block and stays
// in L2; each block reads its window rows once).  The two accumulator
// sets (64 + 64 floats a thread at 128 x 128) and the A fragments take
// 255 registers, and the ring, two sub-slabs' lo parts and the tile's
// decays (64 KB, computed once per live tile instead of at every bound
// check) about 200 KB of shared memory, so one block of 8 warps runs on
// each SM.  The bound check and the final score use
// __fadd_rn/__fmul_rn, so nvcc does not contract them into an fma: they
// round as the plain version's ops do.
//
// A tile with an edge above MAX_EDGE (big_tile_scores) runs on the CUDA
// cores in f32 multiply-adds.  It keeps the reference's per-tile semantics
// (one kill, one early exit, one row-major ranking over the whole tile)
// with one block, walking the tile's sub-tiles of at most MAX_EDGE x
// MAX_EDGE (run in the compiled tile <BQ, BW> with spare slots, an edge
// above 128 as 128) inside each chunk, keeping the accumulators in an f32
// workspace of the join's (Qp, Wp) shape between chunks (each thread reads
// back only what it wrote), and ORing every sub-tile's bound check into
// one block-wide flag per chunk.  Each thread holds a (BQ/16) x (BW/16)
// block of a sub-tile's accumulators and decay in registers; q and w are
// staged through shared memory in SUB-column sub-slabs, stored k-major so
// each thread reads its rows and columns as float4 (or float2) runs.  The
// decay is recomputed per sub-tile and chunk.  Speed at such edges is not
// what this path is for.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_tf32.cuh"

namespace sssj {

using namespace tf32x3;

constexpr int NT = 256;         // threads: 8 warps, or a 16 x 16 grid on the big-tile path
constexpr int SUB = 32;         // feature columns per shared-memory sub-slab (big tiles)
constexpr int KS = ATOM;        // feature columns per cp.async sub-slab (tensor-core path)
constexpr int NSTAGE = 3;       // sub-slabs in the ring: two in flight while one is used
constexpr int FLUSH = 4;        // sub-slabs (128 features) summed on the tensor cores per IEEE add
constexpr int MAX_EDGE = 128;   // the largest compiled tile edge; larger tiles run in sub-tiles

// The compiled tile <BQ, BW>: on the big-tile path thread (ty, tx) owns RM
// rows and RN columns, in runs of VM (VN) adjacent ones, the runs 16 runs
// apart.  FULL marks
// the instance for runtime edges equal to the compiled ones (bq == BQ,
// bw == BW): it has no spare slots, and compiles without their checks.
template <int BQ_, int BW_, bool FULL_>
struct Tile {
  static constexpr int BQ = BQ_, BW = BW_;
  static constexpr bool FULL = FULL_;
  static constexpr int RM = BQ / 16, RN = BW / 16;
  static constexpr int VM = RM < 4 ? RM : 4, VN = RN < 4 ? RN : 4;
  static constexpr int LDQ = BQ + 4, LDW = BW + 4;  // sub-slab strides (16-byte aligned)
  static constexpr int SLAB = SUB * (LDQ + LDW);    // floats: q | w sub-slabs
  // the tensor-core layout: each warpgroup's wgmma is NW columns wide (all
  // of a 128-row tile's, half of a narrower one's), ACC floats a thread; a
  // ring stage holds KS columns of the q and w rows
  static constexpr int NW = BQ == 128 ? BW : BW / 2, ACC = NW / 2;
  static constexpr int STAGE = (BQ + BW) * KS;
  static constexpr int LDS = BW + 4;  // row stride of the staged scores
  static_assert(RM >= 2 && RN >= 2 && RM * RN <= 64, "tile edges 32, 64 or 128");

  __device__ static __forceinline__ int row(int ty, int a) {
    return ty * VM + (a % VM) + (a / VM) * 16 * VM;
  }
  __device__ static __forceinline__ int col(int tx, int b) {
    return tx * VN + (b % VN) + (b / VN) * 16 * VN;
  }
};

template <int BQ, int BW>
struct Lanes {
  float tq[BQ], tw[BW], th[BQ], lam[BQ];
  int uq[BQ], uw[BW], sq[BQ], sw[BW];
};

// What the core reads.  The four stream lanes (sidq, sidw, thq, lmq) are
// all null or all set; gate is null or one int per tile.
struct TileIn {
  const float* q;    // (Qp, d)
  const float* w;    // (Wp, d)
  const float* tq;   // (Qp,)
  const float* tw;   // (Wp,)
  const int* uq;     // (Qp,)
  const int* uw;     // (Wp,)
  const float* sqq;  // (Qp, n_chunks) suffix norms after each chunk
  const float* sqw;  // (Wp, n_chunks)
  const int* sidq;
  const int* sidw;
  const float* thq;
  const float* lmq;
  const int* gate;   // (nq, nw)
  int d, chunk_d, n_chunks;
  float theta, lam;
  int bq, bw;        // the runtime tile edges
};

// V adjacent floats of shared memory into out[0..V)
template <int V>
__device__ __forceinline__ void lds(const float* p, float* out) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else {
    static_assert(V == 2, "runs of 2 or 4");
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x; out[1] = t.y;
  }
}

// decay(i, j) = exp(-lambda_i |t_i - t_j|), zero where the uid order, an
// empty slot or the stream mask forbids the pair
template <class L_t>
__device__ __forceinline__ float decay_at(const L_t& L, int i, int j, bool multi) {
  const bool ord = (L.uw[j] >= 0) && (L.uq[i] > L.uw[j]) &&
                   (!multi || L.sq[i] == L.sw[j]);
  const float dt = fabsf(L.tq[i] - L.tw[j]);
  const float dec = expf(__fmul_rn(-L.lam[i], dt));
  return ord ? dec : 0.0f;
}

// Which of the thread's rows (bit a) and columns (bit b) lie inside the
// runtime tile
template <class T>
__device__ __forceinline__ uint32_t rows_inside(int ty, int bq) {
  uint32_t m = 0;
#pragma unroll
  for (int a = 0; a < T::RM; ++a) m |= (uint32_t)(T::row(ty, a) < bq) << a;
  return m;
}
template <class T>
__device__ __forceinline__ uint32_t cols_inside(int tx, int bw) {
  uint32_t m = 0;
#pragma unroll
  for (int b = 0; b < T::RN; ++b) m |= (uint32_t)(T::col(tx, b) < bw) << b;
  return m;
}

// The lanes of query rows [q0, q0 + nr) and window rows [w0, w0 + nc)
// into L, then a barrier.  Spare rows and columns: no uid (so no pair),
// and a theta no score reaches.
template <class T>
__device__ __forceinline__ void stage_lanes(const TileIn& in, Lanes<T::BQ, T::BW>& L,
                                            size_t q0, int nr, size_t w0, int nc) {
  const int tid = threadIdx.x;
  const bool multi = in.sidq != nullptr;
  for (int r = tid; r < T::BQ; r += blockDim.x) {
    const bool in_r = T::FULL || r < nr;
    L.tq[r] = in_r ? in.tq[q0 + r] : 0.0f;
    L.uq[r] = in_r ? in.uq[q0 + r] : -1;
    L.th[r] = !in_r ? INFINITY : multi ? in.thq[q0 + r] : in.theta;
    L.lam[r] = in_r && multi ? in.lmq[q0 + r] : in.lam;
    L.sq[r] = in_r && multi ? in.sidq[q0 + r] : 0;
  }
  for (int j = tid; j < T::BW; j += blockDim.x) {
    const bool in_j = T::FULL || j < nc;
    L.tw[j] = in_j ? in.tw[w0 + j] : 0.0f;
    L.uw[j] = in_j ? in.uw[w0 + j] : -1;
    L.sw[j] = in_j && multi ? in.sidw[w0 + j] : 0;
  }
  __syncthreads();
}

// The thread's decay entries into dec; returns whether one of them
// (inside the runtime tile) reaches its row's theta
template <class T>
__device__ __forceinline__ bool tile_decay(const TileIn& in, const Lanes<T::BQ, T::BW>& L,
                                           uint32_t rin, uint32_t cin,
                                           float (&dec)[T::RM][T::RN]) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const bool multi = in.sidq != nullptr;
  bool any_alive = false;
#pragma unroll
  for (int a = 0; a < T::RM; ++a) {
    const int i = T::row(ty, a);
#pragma unroll
    for (int b = 0; b < T::RN; ++b) {
      dec[a][b] = decay_at(L, i, T::col(tx, b), multi);
      any_alive |= (((rin >> a) & (cin >> b) & 1u) != 0) & (dec[a][b] >= L.th[i]);
    }
  }
  return any_alive;
}

// acc += q[q0 + i, col0 : col0 + chunk_d] . w[w0 + j, same]^T for the
// thread's (i, j), over rows i < nr and j < nc (spare ones read zeros).
// Uses slab (T::SLAB floats) as scratch; every thread must call it, and
// the slab is free again on return.
template <class T>
__device__ __forceinline__ void chunk_dot(const TileIn& in, float* slab, size_t q0,
                                          int nr, size_t w0, int nc, size_t col0,
                                          float (&acc)[T::RM][T::RN]) {
  constexpr int BQ = T::BQ, BW = T::BW, RM = T::RM, RN = T::RN;
  constexpr int PQ = BQ * SUB / NT, PW = BW * SUB / NT;  // slab loads per thread
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int d = in.d, chunk_d = in.chunk_d;
  float* qs = slab;
  float* ws = slab + SUB * T::LDQ;
  for (int c0 = 0; c0 < chunk_d; c0 += SUB) {
    // thread tid stages column tid % SUB of rows tid / SUB + u * (NT / SUB);
    // every load is issued before the first store, so all are in flight
    const int c = tid % SUB, r0 = tid / SUB;
    const bool col_in = c0 + c < chunk_d;
    float lq[PQ], lw[PW];
#pragma unroll
    for (int u = 0; u < PQ; ++u) {
      const int r = r0 + u * (NT / SUB);
      lq[u] = (T::FULL || r < nr) && col_in ? __ldg(in.q + (q0 + r) * d + col0 + c0 + c) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < PW; ++u) {
      const int r = r0 + u * (NT / SUB);
      lw[u] = (T::FULL || r < nc) && col_in ? __ldg(in.w + (w0 + r) * d + col0 + c0 + c) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < PQ; ++u) qs[c * T::LDQ + r0 + u * (NT / SUB)] = lq[u];
#pragma unroll
    for (int u = 0; u < PW; ++u) ws[c * T::LDW + r0 + u * (NT / SUB)] = lw[u];
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < SUB; ++kk) {
      float av[RM], bv[RN];
#pragma unroll
      for (int g = 0; g < RM / T::VM; ++g)
        lds<T::VM>(qs + kk * T::LDQ + g * 16 * T::VM + ty * T::VM, av + g * T::VM);
#pragma unroll
      for (int g = 0; g < RN / T::VN; ++g)
        lds<T::VN>(ws + kk * T::LDW + g * 16 * T::VN + tx * T::VN, bv + g * T::VN);
#pragma unroll
      for (int a = 0; a < RM; ++a)
#pragma unroll
        for (int b = 0; b < RN; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
    __syncthreads();
  }
}

// l2 suffix bound after chunk k: the unseen remainder of each dot is at
// most |q^{>k}| |w^{>k}|; returns whether one of the thread's entries
// (inside the runtime tile) may still reach theta
template <class T>
__device__ __forceinline__ bool chunk_bound(const TileIn& in, const Lanes<T::BQ, T::BW>& L,
                                            size_t q0, size_t w0, uint32_t rin, uint32_t cin,
                                            int k, const float (&acc)[T::RM][T::RN],
                                            const float (&dec)[T::RM][T::RN]) {
  constexpr int RM = T::RM, RN = T::RN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n_chunks = in.n_chunks;
  float sa[RM], sb[RN];
#pragma unroll
  for (int a = 0; a < RM; ++a)
    sa[a] = (rin >> a) & 1u ? __ldg(in.sqq + (q0 + T::row(ty, a)) * n_chunks + k) : 0.0f;
#pragma unroll
  for (int b = 0; b < RN; ++b)
    sb[b] = (cin >> b) & 1u ? __ldg(in.sqw + (w0 + T::col(tx, b)) * n_chunks + k) : 0.0f;
  bool alive_k = false;
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int i = T::row(ty, a);
#pragma unroll
    for (int b = 0; b < RN; ++b) {
      const float ub = __fmul_rn(__fadd_rn(acc[a][b], __fmul_rn(sa[a], sb[b])),
                                 dec[a][b]);
      alive_k |= (((rin >> a) & (cin >> b) & 1u) != 0) & (ub >= L.th[i]);
    }
  }
  return alive_k;
}

// ---------------------------------------------------------------------
// The tensor-core core of tiles with both edges up to MAX_EDGE
// ---------------------------------------------------------------------

// The dynamic shared memory of the tensor-core kernels (1,024-byte
// aligned by smem_of): the ring of NSTAGE sub-slabs (q rows | w rows,
// KS floats each, in the 128-byte swizzle), reused for the row-major
// scores once the chunk loop is done; the lo parts of two sub-slabs' w
// rows, in the same layout; the decays, the lanes and the suffix norms
template <class T>
struct Smem {
  float ring[NSTAGE][T::STAGE];
  float wlo[2][T::BW * KS];    // the lo parts of two sub-slabs' w rows
  float dec[T::ACC * NT];     // each thread's decays, entry e at e * NT + thread
  Lanes<T::BQ, T::BW> L;
  float na[NSTAGE][T::BQ];     // the suffix norms after chunk k, at k % NSTAGE
  float nb[NSTAGE][T::BW];
  float red[2 * NT / 32];     // per-warp partials of a block reduction
  static_assert(T::BQ * T::LDS <= NSTAGE * T::STAGE, "the scores fit in the ring");
  static_assert(T::STAGE * 4 % 1024 == 0, "stages keep the swizzle's alignment");
};
template <class T>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(Smem<T>) + 1024;  // room to align the base
}
template <class T>
__device__ __forceinline__ Smem<T>& smem_of(unsigned char* raw) {
  // an offset into raw, not an integer cast, so nvcc still knows the
  // accesses are to shared memory
  return *reinterpret_cast<Smem<T>*>(raw + ((1024 - (smem_u32(raw) & 1023)) & 1023));
}

// Issue the loads of sub-slab c (feature columns col0 + c*KS, KS of them)
// of the tile's rows q0.. (nr inside) and w0.. (nc inside) into buf;
// spare rows and columns past the chunk read as zeros.  vec: every row
// start and chunk start 16-byte aligned.
template <class T>
__device__ __forceinline__ void load_slab(const TileIn& in, float* buf, size_t q0, int nr,
                                          size_t w0, int nc, size_t col0, int c, bool vec) {
  constexpr int BQ = T::BQ, BW = T::BW;
  const int tid = threadIdx.x, cbase = c * KS;
  if (vec) {
    constexpr int PQ = BQ * (KS / 4), PIECES = (BQ + BW) * (KS / 4);
#pragma unroll
    for (int p = tid; p < PIECES; p += NT) {
      const bool isq = p < PQ;
      const int f = isq ? p : p - PQ, r = f / (KS / 4), part = f % (KS / 4);
      const bool ok = (T::FULL || r < (isq ? nr : nc)) && cbase + part * 4 < in.chunk_d;
      const float* base = isq ? in.q : in.w;
      const float* src = ok ? base + ((isq ? q0 : w0) + r) * in.d + col0 + cbase + part * 4
                            : base;
      cp_async16(buf + (isq ? 0 : BQ * KS) + swz(r, part * 4), src, ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < (BQ + BW) * KS; e += NT) {
      const bool isq = e < BQ * KS;
      const int f = isq ? e : e - BQ * KS, r = f / KS, cc = f % KS;
      const bool ok = (T::FULL || r < (isq ? nr : nc)) && cbase + cc < in.chunk_d;
      const float* base = isq ? in.q : in.w;
      const float* src = ok ? base + ((isq ? q0 : w0) + r) * in.d + col0 + cbase + cc : base;
      cp_async4(buf + (isq ? 0 : BQ * KS) + swz(r, cc), src, ok ? 4 : 0);
    }
  }
}

// The accumulators: the 8 warps are two warpgroups of 4; a 128-row tile
// gives each warpgroup 64 rows and every column, a narrower one gives each
// the tile's rows (padded to the 64 of a wgmma) and half the columns.
// Entry e of a thread lies at row erow(e), column ecol(e) (the wgmma
// accumulator layout: warp w of the group holds rows 16 w.., in m16n8
// tiles side by side).
template <class T>
__device__ __forceinline__ int erow(int e) {
  const int wgp = threadIdx.x >> 7, w = (threadIdx.x >> 5) & 3, g = (threadIdx.x & 31) >> 2;
  return (T::BQ == 128 ? wgp * 64 : 0) + w * 16 + ((e >> 1) & 1) * 8 + g;
}
template <class T>
__device__ __forceinline__ int ecol(int e) {
  const int wgp = threadIdx.x >> 7, t = threadIdx.x & 3;
  return (T::BQ == 128 ? 0 : wgp * T::NW) + (e >> 2) * 8 + 2 * t + (e & 1);
}
template <class T>
using Acc = float[T::ACC];

// Split a landed sub-slab's w rows for the tensor cores, once per
// element: hi parts in place, lo parts into wlo (the same layout); the
// caller syncs before the products read them
template <class T>
__device__ __forceinline__ void split_slab(float* buf, float* wlo) {
  float* ws = buf + T::BQ * KS;
#pragma unroll
  for (int f = threadIdx.x * 4; f < T::BW * KS; f += NT * 4) {
    const float4 x = *reinterpret_cast<const float4*>(ws + f);
    uint32_t h[4], l[4];
    split_tf32(x.x, h[0], l[0]);
    split_tf32(x.y, h[1], l[1]);
    split_tf32(x.z, h[2], l[2]);
    split_tf32(x.w, h[3], l[3]);
    *reinterpret_cast<uint4*>(ws + f) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(wlo + f) = make_uint4(l[0], l[1], l[2], l[3]);
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to wgmma
}

// One split sub-slab on the tensor cores: p (+)= q_slab . w_slab^T, each
// product as 3xTF32 (lo.hi + hi.lo + hi.hi; the lo.lo term, about 2^-22
// of the product, is left out); q's rows are split as each thread loads
// its A fragments.  accumulate = 0 starts p afresh.  overlap() runs while
// the products do, and touches neither p nor the fragments.  Every thread
// must call it; ends with the products done.
template <class T, class F>
__device__ __forceinline__ void slab_products(const float* buf, const float* wlo, Acc<T>& p,
                                              int accumulate, F&& overlap) {
  const int tid = threadIdx.x, wgp = tid >> 7, w = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2, t = tid & 3;
  // this thread's A fragments of the slab's KS / 8 steps: rows +0, +8,
  // +0, +8 and columns +0, +0, +4, +4 of its warp's 16 rows
  uint32_t ah[KS / 8][4], al[KS / 8][4];
  const int r0 = (T::BQ == 128 ? wgp * 64 : 0) + w * 16 + g;
#pragma unroll
  for (int kk = 0; kk < KS / 8; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int r = r0 + (x & 1) * 8;
      const float v = T::BQ >= 64 || r < T::BQ ? buf[swz(r, kk * 8 + (x >> 1) * 4 + t)] : 0.0f;
      split_tf32(v, ah[kk][x], al[kk][x]);
    }
  const int c0 = T::BQ == 128 ? 0 : wgp * T::NW;  // the warpgroup's first column
  const uint32_t bh = smem_u32(buf + (T::BQ + c0) * KS), bl = smem_u32(wlo + c0 * KS);
  reg_fence(p);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < KS / 8; ++kk) {  // 8 columns = 32 bytes of each row a step
    wgmma_tf32<T::NW>(p, al[kk], desc128(bh + kk * 32), accumulate | kk);
    wgmma_tf32<T::NW>(p, ah[kk], desc128(bl + kk * 32), 1);
    wgmma_tf32<T::NW>(p, ah[kk], desc128(bh + kk * 32), 1);
  }
  wg_commit();
  overlap();
  wg_wait();
#pragma unroll
  for (int kk = 0; kk < KS / 8; ++kk)  // the fragments stay put until the products read them
#pragma unroll
    for (int x = 0; x < 4; ++x) asm volatile("" ::"r"(ah[kk][x]), "r"(al[kk][x]));
  reg_fence(p);
}

// Whether the thread's entry at (i, j) exists in the runtime tile (a row
// past BQ pads a narrow tile's rows to the 64 of a wgmma)
template <class T>
__device__ __forceinline__ bool inside(const TileIn& in, int i, int j) {
  return (T::BQ >= 64 || i < T::BQ) && (T::FULL || (i < in.bq && j < in.bw));
}

// The tile's time kill, first half (block-wide; every thread must call
// it): a bound from the timestamps.  A row's decays are at most
// expf(-lambda d), d the distance from its timestamp to the hull of the
// tile's window timestamps (rounding is monotone, expf within a few ulp,
// and the masks only zero decays), so when that bound stays below
// theta (1 - 1e-4) in every row the tile is dead without a decay
// computed; returns whether it may live.
template <class T>
__device__ __forceinline__ bool tile_may_live(const TileIn& in, Smem<T>& sm) {
  const Lanes<T::BQ, T::BW>& L = sm.L;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float lo = INFINITY, hi = -INFINITY;
  for (int j = tid; j < T::BW; j += NT)
    if (T::FULL || j < in.bw) {
      lo = fminf(lo, L.tw[j]);
      hi = fmaxf(hi, L.tw[j]);
    }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (lane == 0) {
    sm.red[warp] = lo;
    sm.red[NT / 32 + warp] = hi;
  }
  __syncthreads();
#pragma unroll
  for (int v = 0; v < NT / 32; ++v) {
    lo = fminf(lo, sm.red[v]);
    hi = fmaxf(hi, sm.red[NT / 32 + v]);
  }
  bool may = false;
  for (int i = tid; i < T::BQ; i += NT)
    if (T::FULL || i < in.bq) {
      const float t = L.tq[i], lam = L.lam[i], th = L.th[i];
      const float d = t < lo ? __fsub_rn(lo, t) : t > hi ? __fsub_rn(t, hi) : 0.0f;
      may |= !(lam >= 0.0f) || !(th > 0.0f) || expf(__fmul_rn(-lam, d)) >= th * 0.9999f;
    }
  return __syncthreads_or(may);
}

// The tile's time kill, second half (block-wide): every thread computes
// the decays of its accumulator entries into sm.dec (0 outside the
// runtime tile), which the bound checks and the scores read; returns
// whether one reaches its row's theta, so the kill is exactly the plain
// version's
template <class T>
__device__ __forceinline__ bool tile_decays_reach(const TileIn& in, Smem<T>& sm) {
  const bool multi = in.sidq != nullptr;
  bool alive = false;
  float d[T::ACC];  // all in registers first: no store orders the lane loads
#pragma unroll
  for (int e = 0; e < T::ACC; ++e) {
    const int i = erow<T>(e), j = ecol<T>(e);
    d[e] = 0.0f;
    if (inside<T>(in, i, j)) {
      d[e] = decay_at(sm.L, i, j, multi);
      alive |= d[e] >= sm.L.th[i];
    }
  }
#pragma unroll
  for (int e = 0; e < T::ACC; ++e) sm.dec[e * NT + threadIdx.x] = d[e];
  return __syncthreads_or(alive);
}

// l2 suffix bound after chunk k over the thread's entries: whether one
// inside the runtime tile may still reach theta
template <class T>
__device__ __forceinline__ bool chunk_alive(const TileIn& in, const Smem<T>& sm, int k,
                                            const Acc<T>& acc) {
  const float* na = sm.na[k % NSTAGE];
  const float* nb = sm.nb[k % NSTAGE];
  bool alive = false;
#pragma unroll
  for (int e = 0; e < T::ACC; ++e) {
    const int i = erow<T>(e), j = ecol<T>(e);
    if (!inside<T>(in, i, j)) continue;
    const float ub = __fmul_rn(__fadd_rn(acc[e], __fmul_rn(na[i], nb[j])),
                               sm.dec[e * NT + threadIdx.x]);
    alive |= ub >= sm.L.th[i];
  }
  return alive;
}

// The sub-slabs of the tile's features: spc a chunk, total in all; vec:
// every row start and chunk start 16-byte aligned
struct Slabs {
  int spc, total;
  bool vec;
};
__device__ __forceinline__ Slabs slabs_of(const TileIn& in) {
  const int spc = (in.chunk_d + KS - 1) / KS;
  return {spc, in.n_chunks * spc,
          ((in.d | in.chunk_d) & 3) == 0 && (((uintptr_t)in.q | (uintptr_t)in.w) & 15) == 0};
}

// Issue the loads of sub-slab s, if there is one, as one cp.async group
// (empty past the end, which keeps the count), with a chunk's first
// sub-slab also the suffix norms after that chunk
template <class T>
__device__ __forceinline__ void issue_slab(const TileIn& in, Smem<T>& sm, size_t q0,
                                           size_t w0, const Slabs& sl, int s) {
  if (s < sl.total) {
    const int k = s / sl.spc, c = s - k * sl.spc;
    load_slab<T>(in, sm.ring[s % NSTAGE], q0, in.bq, w0, in.bw, (size_t)k * in.chunk_d, c,
                 sl.vec);
    if (c == 0)
      for (int r = threadIdx.x; r < T::BQ + T::BW; r += NT) {
        const bool isq = r < T::BQ;
        const int x = isq ? r : r - T::BQ;
        const bool ok = T::FULL || x < (isq ? in.bq : in.bw);
        const float* src = isq ? in.sqq + (q0 + x) * in.n_chunks : in.sqw + (w0 + x) * in.n_chunks;
        cp_async4((isq ? sm.na[k % NSTAGE] : sm.nb[k % NSTAGE]) + x, ok ? src + k : in.sqq,
                  ok ? 4 : 0);
      }
  }
  cp_async_commit();
}

// The first NSTAGE - 1 sub-slabs of the tile, issued before its decays
// are computed so their loads overlap that work; a caller that then finds
// the tile dead waits for them (cp_async_wait<0>) before it returns
template <class T>
__device__ __forceinline__ void tile_prefetch(const TileIn& in, Smem<T>& sm, size_t q0,
                                              size_t w0) {
  const Slabs sl = slabs_of(in);
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) issue_slab<T>(in, sm, q0, w0, sl, s);
}

// The chunk loop of a live tile (blockIdx.y, blockIdx.x), after
// tile_prefetch: acc = q . w^T one chunk_d slab at a time, until the
// bound check kills the tile or the chunks run out; returns the chunks
// run (>= 1).  Sub-slabs stream through the ring NSTAGE - 1 ahead of the
// tensor cores, across chunk ends too (a tile that dies leaves at most
// that many loads unused), and each is split while the one before it is
// on the tensor cores.  The tensor cores' f32 accumulation truncates (see
// the header), so the products of at most FLUSH sub-slabs, and never more
// than one chunk, are summed from zero in p and added to acc with IEEE
// adds.  Every thread must call it, and the ring is free again on return.
template <class T>
__device__ __forceinline__ int tile_dot(const TileIn& in, Smem<T>& sm, size_t q0,
                                        size_t w0, Acc<T>& acc) {
  const Slabs sl = slabs_of(in);
  Acc<T> p;
#pragma unroll
  for (int e = 0; e < T::ACC; ++e) acc[e] = p[e] = 0.0f;
  cp_async_wait<NSTAGE - 2>();  // sub-slab 0 landed
  __syncthreads();
  split_slab<T>(sm.ring[0], sm.wlo[0]);
  __syncthreads();
  int k = 0, s = 0;
  bool live = true;
  while (live && k < in.n_chunks) {
    for (int c = 0; c < sl.spc; ++c, ++s) {
      slab_products<T>(sm.ring[s % NSTAGE], sm.wlo[s & 1], p, c % FLUSH != 0, [&] {
        // sub-slab s + NSTAGE - 1 into the slot of s - 1, whose products
        // are done; then s + 1, landed, split for the next products
        issue_slab<T>(in, sm, q0, w0, sl, s + NSTAGE - 1);
        cp_async_wait<NSTAGE - 2>();
        __syncthreads();
        if (s + 1 < sl.total) split_slab<T>(sm.ring[(s + 1) % NSTAGE], sm.wlo[(s + 1) & 1]);
      });
      if (c % FLUSH == FLUSH - 1 || c == sl.spc - 1) {
#pragma unroll
        for (int e = 0; e < T::ACC; ++e) acc[e] = __fadd_rn(acc[e], p[e]);
      }
      if (c < sl.spc - 1) __syncthreads();  // the split of s + 1 is everyone's
    }
    live = __syncthreads_or(chunk_alive<T>(in, sm, k, acc));  // (and published)
    ++k;
  }
  cp_async_wait<0>();
  __syncthreads();
  return k;
}

// Each score acc * decay into the row-major (BQ, LDS) matrix S where it
// emits (score >= theta_row, and score > 0 if POS) and 0 elsewhere; spare
// rows (theta +inf) and columns (decay 0) get 0.  S must be free; the
// caller syncs before reading it.
template <class T, bool POS>
__device__ __forceinline__ void scores_to_smem(const Smem<T>& sm, const Acc<T>& acc,
                                               float* S) {
  float v[T::ACC];  // all read before the first store, which could alias them
  const float th[2] = {sm.L.th[erow<T>(0) % T::BQ], sm.L.th[erow<T>(2) % T::BQ]};
#pragma unroll
  for (int e = 0; e < T::ACC; ++e) {
    const float sc = __fmul_rn(acc[e], sm.dec[e * NT + threadIdx.x]);
    v[e] = sc >= th[(e >> 1) & 1] && (!POS || sc > 0.0f) ? sc : 0.0f;
  }
#pragma unroll
  for (int e = 0; e < T::ACC; e += 2) {
    const int i = erow<T>(e), j = ecol<T>(e);
    if (T::BQ >= 64 || i < T::BQ)
      *reinterpret_cast<float2*>(S + i * T::LDS + j) = make_float2(v[e], v[e + 1]);
  }
}

// Sub-tile (sq, sw) of a big tile: its first query and window rows, and
// how many of its rows and columns lie inside the tile
struct SubTile {
  size_t q0, w0;
  int nr, nc;
};
template <class T>
__device__ __forceinline__ SubTile sub_tile(const TileIn& in, int sq, int sw) {
  const size_t q0 = (size_t)blockIdx.y * in.bq, w0 = (size_t)blockIdx.x * in.bw;
  return {q0 + (size_t)sq * T::BQ, w0 + (size_t)sw * T::BW,
          min(T::BQ, in.bq - sq * T::BQ), min(T::BW, in.bw - sw * T::BW)};
}

// The thread's entries of sub-tile s in a (rows, Wp) matrix x: each
// inside the tile read into v (spare ones 0), or v written to them
template <class T>
__device__ __forceinline__ void ws_load(const float* x, int Wp, const SubTile& s,
                                        uint32_t rin, uint32_t cin,
                                        float (&v)[T::RM][T::RN]) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int a = 0; a < T::RM; ++a)
#pragma unroll
    for (int b = 0; b < T::RN; ++b)
      v[a][b] = ((rin >> a) & (cin >> b) & 1u)
                    ? x[(s.q0 + T::row(ty, a)) * Wp + s.w0 + T::col(tx, b)] : 0.0f;
}
template <class T>
__device__ __forceinline__ void ws_store(float* x, int Wp, const SubTile& s,
                                         uint32_t rin, uint32_t cin,
                                         const float (&v)[T::RM][T::RN]) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int a = 0; a < T::RM; ++a)
#pragma unroll
    for (int b = 0; b < T::RN; ++b)
      if ((rin >> a) & (cin >> b) & 1u)
        x[(s.q0 + T::row(ty, a)) * Wp + s.w0 + T::col(tx, b)] = v[a][b];
}

// tile_scores for a tile with an edge above MAX_EDGE, run in sub-tiles of
// the compiled tile T (never FULL): the dot products end in ws (Qp, Wp),
// at the tile's entries, and are left unset for a dead tile (returns 0).
// L holds the lanes of the last sub-tile visited.
template <class T>
__device__ int big_tile_scores(const TileIn& in, Lanes<T::BQ, T::BW>& L, float* slab,
                               float* ws, int Wp) {
  static_assert(!T::FULL, "sub-tiles have spare slots");
  const size_t tile = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int nsq = (in.bq + T::BQ - 1) / T::BQ, nsw = (in.bw + T::BW - 1) / T::BW;
  float acc[T::RM][T::RN], dec[T::RM][T::RN];

  bool any_alive = false;
  for (int sq = 0; sq < nsq; ++sq)
    for (int sw = 0; sw < nsw; ++sw) {
      const SubTile s = sub_tile<T>(in, sq, sw);
      __syncthreads();  // L is free
      stage_lanes<T>(in, L, s.q0, s.nr, s.w0, s.nc);
      any_alive |= tile_decay<T>(in, L, rows_inside<T>(ty, s.nr),
                                 cols_inside<T>(tx, s.nc), dec);
    }
  int live = __syncthreads_or(any_alive);
  if (in.gate != nullptr && in.gate[tile] <= 0) live = 0;

  int k = 0;
  while (live && k < in.n_chunks) {
    bool alive_k = false;
    for (int sq = 0; sq < nsq; ++sq)
      for (int sw = 0; sw < nsw; ++sw) {
        const SubTile s = sub_tile<T>(in, sq, sw);
        const uint32_t rin = rows_inside<T>(ty, s.nr), cin = cols_inside<T>(tx, s.nc);
        __syncthreads();  // L is free
        stage_lanes<T>(in, L, s.q0, s.nr, s.w0, s.nc);
        ws_load<T>(ws, Wp, s, k > 0 ? rin : 0u, cin, acc);
        chunk_dot<T>(in, slab, s.q0, s.nr, s.w0, s.nc, (size_t)k * in.chunk_d, acc);
        tile_decay<T>(in, L, rin, cin, dec);  // after the dot: fewer live registers
        alive_k |= chunk_bound<T>(in, L, s.q0, s.w0, rin, cin, k, acc, dec);
        ws_store<T>(ws, Wp, s, rin, cin, acc);
      }
    ++k;
    live = __syncthreads_or(alive_k);
  }
  return k;
}

// Let kernel take bytes of dynamic shared memory (above 48 KB it must be
// asked for), with the SM's unified memory split toward shared memory so
// two blocks fit; returns the CUDA error
template <class K>
__host__ inline int allow_smem(K* kernel, size_t bytes) {
  cudaError_t e = cudaFuncSetAttribute((const void*)kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute((const void*)kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  return (int)e;
}

// The launchers' shape check: tile edges of at least 1, whole tiles,
// whole chunks, a grid CUDA takes
__host__ inline bool bad_shape(int Qp, int Wp, int d, int chunk_d, int bq, int bw) {
  return bq < 1 || bw < 1 || Qp <= 0 || Wp <= 0 || Qp % bq || Wp % bw ||
         chunk_d <= 0 || d % chunk_d || Qp / bq > 65535;
}

// f(Tile<BQ, BW, FULL>{}) for the compiled tile that holds (bq, bw): each
// edge the smallest of 32, 64, 128 that is >= it
template <int BQ, int BW, class F>
__host__ int with_full(int bq, int bw, F&& f) {
  if (bq == BQ && bw == BW) return f(Tile<BQ, BW, true>{});
  return f(Tile<BQ, BW, false>{});
}
template <int BQ, class F>
__host__ int with_bw(int bq, int bw, F&& f) {
  if (bw <= 32) return with_full<BQ, 32>(bq, bw, f);
  if (bw <= 64) return with_full<BQ, 64>(bq, bw, f);
  return with_full<BQ, 128>(bq, bw, f);
}
template <class F>
__host__ int with_tile(int bq, int bw, F&& f) {
  if (bq <= 32) return with_bw<32>(bq, bw, f);
  if (bq <= 64) return with_bw<64>(bq, bw, f);
  return with_bw<128>(bq, bw, f);
}

// f(Tile<BQ, BW, false>{}) for the sub-tiles of a tile with an edge above
// MAX_EDGE: that edge runs as 128, the other as with_tile picks it
template <class F>
__host__ int with_big_tile(int bq, int bw, F&& f) {
  if (bq > MAX_EDGE) {
    if (bw <= 32) return f(Tile<128, 32, false>{});
    if (bw <= 64) return f(Tile<128, 64, false>{});
    return f(Tile<128, 128, false>{});
  }
  if (bq <= 32) return f(Tile<32, 128, false>{});
  if (bq <= 64) return f(Tile<64, 128, false>{});
  return f(Tile<128, 128, false>{});
}

}  // namespace sssj
