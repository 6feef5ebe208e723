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
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sssj {

constexpr int NT = 256;         // threads: a 16 x 16 grid
constexpr int SUB = 32;         // feature columns per shared-memory sub-slab
constexpr int MAX_EDGE = 128;   // the largest tile edge a kernel takes

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

// The tile (blockIdx.y, blockIdx.x)'s dot products, into acc, and its
// decay, into dec: returns the chunks run (0 for a dead tile, whose acc
// stays 0).  Fills L; uses slab (T::SLAB floats) as scratch, free again
// on return.  Every thread of the block must call it.
template <class T>
__device__ __forceinline__ int tile_scores(const TileIn& in, Lanes<T::BQ, T::BW>& L,
                                           float* slab, float (&acc)[T::RM][T::RN],
                                           float (&dec)[T::RM][T::RN]) {
  constexpr int BQ = T::BQ, BW = T::BW, RM = T::RM, RN = T::RN;
  constexpr int PQ = BQ * SUB / NT, PW = BW * SUB / NT;  // slab loads per thread
  const int tj = blockIdx.x, ti = blockIdx.y, nw = gridDim.x;
  const size_t tile = (size_t)ti * nw + tj;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const bool multi = in.sidq != nullptr;
  const int bq = in.bq, bw = in.bw;
  const size_t q0 = (size_t)ti * bq, w0 = (size_t)tj * bw;

  // spare rows and columns: no uid (so no pair), and a theta no score reaches
  for (int r = tid; r < BQ; r += NT) {
    const bool in_r = T::FULL || r < bq;
    L.tq[r] = in_r ? in.tq[q0 + r] : 0.0f;
    L.uq[r] = in_r ? in.uq[q0 + r] : -1;
    L.th[r] = !in_r ? INFINITY : multi ? in.thq[q0 + r] : in.theta;
    L.lam[r] = in_r && multi ? in.lmq[q0 + r] : in.lam;
    L.sq[r] = in_r && multi ? in.sidq[q0 + r] : 0;
  }
  for (int j = tid; j < BW; j += NT) {
    const bool in_j = T::FULL || j < bw;
    L.tw[j] = in_j ? in.tw[w0 + j] : 0.0f;
    L.uw[j] = in_j ? in.uw[w0 + j] : -1;
    L.sw[j] = in_j && multi ? in.sidw[w0 + j] : 0;
  }
  __syncthreads();

  const uint32_t rin = T::FULL ? ~0u : rows_inside<T>(ty, bq);
  const uint32_t cin = T::FULL ? ~0u : cols_inside<T>(tx, bw);

  // time filter at tile granularity: dot <= 1, so decay < theta everywhere
  // means the tile cannot emit
  bool any_alive = false;
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int i = T::row(ty, a);
#pragma unroll
    for (int b = 0; b < RN; ++b) {
      dec[a][b] = decay_at(L, i, T::col(tx, b), multi);
      any_alive |= (((rin >> a) & (cin >> b) & 1u) != 0) & (dec[a][b] >= L.th[i]);
    }
  }
  int live = __syncthreads_or(any_alive);
  if (in.gate != nullptr && in.gate[tile] <= 0) live = 0;

#pragma unroll
  for (int a = 0; a < RM; ++a)
#pragma unroll
    for (int b = 0; b < RN; ++b) acc[a][b] = 0.0f;

  const int d = in.d, chunk_d = in.chunk_d, n_chunks = in.n_chunks;
  float* qs = slab;
  float* ws = slab + SUB * T::LDQ;
  int k = 0;
  while (live && k < n_chunks) {
    const size_t col0 = (size_t)k * chunk_d;
    for (int c0 = 0; c0 < chunk_d; c0 += SUB) {
      // thread tid stages column tid % SUB of rows tid / SUB + u * (NT / SUB);
      // every load is issued before the first store, so all are in flight
      const int c = tid % SUB, r0 = tid / SUB;
      const bool col_in = c0 + c < chunk_d;
      float lq[PQ], lw[PW];
#pragma unroll
      for (int u = 0; u < PQ; ++u) {
        const int r = r0 + u * (NT / SUB);
        lq[u] = (T::FULL || r < bq) && col_in ? __ldg(in.q + (q0 + r) * d + col0 + c0 + c) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < PW; ++u) {
        const int r = r0 + u * (NT / SUB);
        lw[u] = (T::FULL || r < bw) && col_in ? __ldg(in.w + (w0 + r) * d + col0 + c0 + c) : 0.0f;
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
    // l2 suffix bound after chunk k: the unseen remainder of each dot is
    // at most |q^{>k}| |w^{>k}|
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
    ++k;
    live = __syncthreads_or(alive_k);
  }
  return k;
}

// The launchers' shape check: tile edges the kernels take, whole tiles,
// whole chunks, a grid CUDA takes
__host__ inline bool bad_shape(int Qp, int Wp, int d, int chunk_d, int bq, int bw) {
  return bq < 1 || bq > MAX_EDGE || bw < 1 || bw > MAX_EDGE || Qp <= 0 ||
         Wp <= 0 || Qp % bq || Wp % bw || chunk_d <= 0 || d % chunk_d ||
         Qp / bq > 65535;
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

}  // namespace sssj
