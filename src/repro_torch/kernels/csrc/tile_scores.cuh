// The score core shared by the two tile-join kernels (sssj_cand.cu and
// sssj_dense.cu), the counterpart of the TPU kernels' common
// src/repro/kernels/sssj_join/kernel.py::_tile_scores.
//
// One thread block of NT threads owns one (bq query rows x bw window rows)
// tile, run in the compiled tile <BQ, BW> that holds it (each edge the
// smallest of 32, 64, 128 that is >= the runtime edge):
//   1. it stages the tile's lanes (timestamps, uids, stream ids and
//      per-row theta/lambda) in shared memory;
//   2. it builds the decay exp(-lambda |dt|) with the uid-order,
//      empty-slot and stream masks folded in as zeros, and kills the tile
//      when no entry reaches theta or when its pre-launch gate bit is 0;
//   3. it accumulates q . w^T one chunk_d slab at a time and stops once
//      (acc + |q^{>k}| |w^{>k}|) . decay < theta holds for the whole tile.
// Rows at or past bq and columns at or past bw are the compiled tile's
// spare slots: they read nothing, and take no part in the tile's kill,
// its bound check or (in the callers) the emission; a tile whose edges
// equal the compiled ones runs the FULL instance, compiled without the
// spare-slot checks (on an H100 they cost a 128 x 128 tile about 15 %).
// Each thread holds a (BQ/16) x (BW/16) block of the accumulators and of
// the decay in registers (the decay is computed once, not per chunk);
// q and w are staged through shared memory in 32-column sub-slabs, every
// global load of a sub-slab issued before the first store, stored k-major
// so each thread reads its rows and columns as float4 (or float2) runs
// without bank conflicts; q, w and the norms are read through the
// read-only cache (__ldg).  The bound check uses
// __fadd_rn/__fmul_rn, and callers form the final score acc * decay with
// __fmul_rn, so nvcc does not contract them into an fma: they round as
// the plain version's separate ops do.
//
// A tile with an edge above MAX_EDGE (big_tile_scores) keeps the
// reference's per-tile semantics (one kill, one early exit, one row-major
// ranking over the whole tile) with the same block: it walks the tile's
// sub-tiles of at most MAX_EDGE x MAX_EDGE (run in the compiled tile
// <BQ, BW> with spare slots, an edge above 128 as 128) inside each chunk,
// keeps the accumulators in an f32 workspace of the join's (Qp, Wp)
// shape between chunks (each thread reads back only what it wrote), and
// ORs every sub-tile's bound check into one block-wide flag per chunk.
// The decay is recomputed per sub-tile and chunk (64 expf a thread against
// 16K multiply-adds).  Speed at such edges is not what this path is for.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sssj {

constexpr int NT = 256;         // threads: a 16 x 16 grid
constexpr int SUB = 32;         // feature columns per shared-memory sub-slab
constexpr int MAX_EDGE = 128;   // the largest compiled tile edge; larger tiles run in sub-tiles

// The compiled tile <BQ, BW>: thread (ty, tx) owns RM rows and RN columns,
// in runs of VM (VN) adjacent ones, the runs 16 runs apart.  FULL marks
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
  for (int r = tid; r < T::BQ; r += NT) {
    const bool in_r = T::FULL || r < nr;
    L.tq[r] = in_r ? in.tq[q0 + r] : 0.0f;
    L.uq[r] = in_r ? in.uq[q0 + r] : -1;
    L.th[r] = !in_r ? INFINITY : multi ? in.thq[q0 + r] : in.theta;
    L.lam[r] = in_r && multi ? in.lmq[q0 + r] : in.lam;
    L.sq[r] = in_r && multi ? in.sidq[q0 + r] : 0;
  }
  for (int j = tid; j < T::BW; j += NT) {
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

// The tile (blockIdx.y, blockIdx.x)'s dot products, into acc, and its
// decay, into dec: returns the chunks run (0 for a dead tile, whose acc
// stays 0).  Fills L; uses slab (T::SLAB floats) as scratch, free again
// on return.  Every thread of the block must call it.
template <class T>
__device__ __forceinline__ int tile_scores(const TileIn& in, Lanes<T::BQ, T::BW>& L,
                                           float* slab, float (&acc)[T::RM][T::RN],
                                           float (&dec)[T::RM][T::RN]) {
  const int tj = blockIdx.x, ti = blockIdx.y, nw = gridDim.x;
  const size_t tile = (size_t)ti * nw + tj;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bq = in.bq, bw = in.bw;
  const size_t q0 = (size_t)ti * bq, w0 = (size_t)tj * bw;

  stage_lanes<T>(in, L, q0, bq, w0, bw);
  const uint32_t rin = T::FULL ? ~0u : rows_inside<T>(ty, bq);
  const uint32_t cin = T::FULL ? ~0u : cols_inside<T>(tx, bw);

  // time filter at tile granularity: dot <= 1, so decay < theta everywhere
  // means the tile cannot emit
  int live = __syncthreads_or(tile_decay<T>(in, L, rin, cin, dec));
  if (in.gate != nullptr && in.gate[tile] <= 0) live = 0;

#pragma unroll
  for (int a = 0; a < T::RM; ++a)
#pragma unroll
    for (int b = 0; b < T::RN; ++b) acc[a][b] = 0.0f;

  int k = 0;
  while (live && k < in.n_chunks) {
    chunk_dot<T>(in, slab, q0, bq, w0, bw, (size_t)k * in.chunk_d, acc);
    const bool alive_k = chunk_bound<T>(in, L, q0, w0, rin, cin, k, acc, dec);
    ++k;
    live = __syncthreads_or(alive_k);
  }
  return k;
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
