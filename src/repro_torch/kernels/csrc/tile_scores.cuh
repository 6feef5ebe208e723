// The score core shared by the two tile-join kernels (sssj_cand.cu and
// sssj_dense.cu), the counterpart of the TPU kernels' common
// src/repro/kernels/sssj_join/kernel.py::_tile_scores.
//
// One thread block of NT threads owns one (BQ query rows x BW window
// rows) tile:
//   1. it stages the tile's lanes (timestamps, uids, stream ids and
//      per-row theta/lambda) in shared memory;
//   2. it builds the decay exp(-lambda |dt|) with the uid-order,
//      empty-slot and stream masks folded in as zeros, and kills the tile
//      when no entry reaches theta or when its pre-launch gate bit is 0;
//   3. it accumulates q . w^T one chunk_d slab at a time and stops once
//      (acc + |q^{>k}| |w^{>k}|) . decay < theta holds for the whole tile.
// Each thread holds an 8 x 8 block of the accumulators in registers; q
// and w are staged through shared memory in 32-column sub-slabs, stored
// k-major so each thread reads its 8 rows and 8 columns as float4 pairs
// without bank conflicts; q, w and the norms are read through the
// read-only cache (__ldg).  The bound check uses __fadd_rn/__fmul_rn, and
// callers form the final score acc * decay with __fmul_rn, so nvcc does
// not contract them into an fma: they round as the plain version's
// separate ops do.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sssj {

constexpr int BQ = 128;         // query rows per tile
constexpr int BW = 128;         // window rows per tile
constexpr int NT = 256;         // threads: a 16 x 16 grid, 8 x 8 outputs each
constexpr int SUB = 32;         // feature columns per shared-memory sub-slab
constexpr int LDS = BQ + 4;     // sub-slab row stride in floats (16-byte aligned)

static_assert(BQ == BW && NT == BQ + BW, "lane loads assume one row per thread");

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
};

// thread (ty, tx) owns rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, and the
// same pattern of columns in tx
__device__ __forceinline__ int row_of(int ty, int a) {
  return ty * 4 + (a & 3) + (a >> 2) * 64;
}
__device__ __forceinline__ int col_of(int tx, int b) {
  return tx * 4 + (b & 3) + (b >> 2) * 64;
}

// decay(i, j) = exp(-lambda_i |t_i - t_j|), zero where the uid order, an
// empty slot or the stream mask forbids the pair
__device__ __forceinline__ float decay_at(const Lanes& L, int i, int j, bool multi) {
  const bool ord = (L.uw[j] >= 0) && (L.uq[i] > L.uw[j]) &&
                   (!multi || L.sq[i] == L.sw[j]);
  const float dt = fabsf(L.tq[i] - L.tw[j]);
  const float dec = expf(__fmul_rn(-L.lam[i], dt));
  return ord ? dec : 0.0f;
}

// The tile (blockIdx.y, blockIdx.x)'s dot products, into acc: returns
// the chunks run (0 for a dead tile, whose acc stays 0).  Fills L; uses
// slab (2 * SUB * LDS floats) as scratch, free again on return.  Every
// thread of the block must call it.
__device__ __forceinline__ int tile_scores(const TileIn& in, Lanes& L,
                                           float* slab, float (&acc)[8][8]) {
  const int tj = blockIdx.x, ti = blockIdx.y, nw = gridDim.x;
  const size_t tile = (size_t)ti * nw + tj;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const bool multi = in.sidq != nullptr;
  const size_t q0 = (size_t)ti * BQ, w0 = (size_t)tj * BW;

  if (tid < BQ) {
    L.tq[tid] = in.tq[q0 + tid];
    L.uq[tid] = in.uq[q0 + tid];
    L.th[tid] = multi ? in.thq[q0 + tid] : in.theta;
    L.lam[tid] = multi ? in.lmq[q0 + tid] : in.lam;
    L.sq[tid] = multi ? in.sidq[q0 + tid] : 0;
  } else {
    const int j = tid - BQ;
    L.tw[j] = in.tw[w0 + j];
    L.uw[j] = in.uw[w0 + j];
    L.sw[j] = multi ? in.sidw[w0 + j] : 0;
  }
  __syncthreads();

  // time filter at tile granularity: dot <= 1, so decay < theta everywhere
  // means the tile cannot emit
  bool any_alive = false;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int i = row_of(ty, a);
#pragma unroll
    for (int b = 0; b < 8; ++b)
      any_alive |= decay_at(L, i, col_of(tx, b), multi) >= L.th[i];
  }
  int live = __syncthreads_or(any_alive);
  if (in.gate != nullptr && in.gate[tile] <= 0) live = 0;

#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.0f;

  const int d = in.d, chunk_d = in.chunk_d, n_chunks = in.n_chunks;
  float* qs = slab;
  float* ws = slab + SUB * LDS;
  int k = 0;
  while (live && k < n_chunks) {
    const size_t col0 = (size_t)k * chunk_d;
    for (int c0 = 0; c0 < chunk_d; c0 += SUB) {
      for (int e = tid; e < BQ * SUB; e += NT) {
        const int r = e / SUB, c = e % SUB;
        const bool inside = c0 + c < chunk_d;
        qs[c * LDS + r] = inside ? __ldg(in.q + (q0 + r) * d + col0 + c0 + c) : 0.0f;
        ws[c * LDS + r] = inside ? __ldg(in.w + (w0 + r) * d + col0 + c0 + c) : 0.0f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < SUB; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(qs + kk * LDS + ty * 4);
        const float4 a1 = *reinterpret_cast<const float4*>(qs + kk * LDS + 64 + ty * 4);
        const float4 b0 = *reinterpret_cast<const float4*>(ws + kk * LDS + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(ws + kk * LDS + 64 + tx * 4);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
      }
      __syncthreads();
    }
    // l2 suffix bound after chunk k: the unseen remainder of each dot is
    // at most |q^{>k}| |w^{>k}|
    float sa[8], sb[8];
#pragma unroll
    for (int a = 0; a < 8; ++a) sa[a] = __ldg(in.sqq + (q0 + row_of(ty, a)) * n_chunks + k);
#pragma unroll
    for (int b = 0; b < 8; ++b) sb[b] = __ldg(in.sqw + (w0 + col_of(tx, b)) * n_chunks + k);
    bool alive_k = false;
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int i = row_of(ty, a);
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const float ub = __fmul_rn(__fadd_rn(acc[a][b], __fmul_rn(sa[a], sb[b])),
                                   decay_at(L, i, col_of(tx, b), multi));
        alive_k |= ub >= L.th[i];
      }
    }
    ++k;
    live = __syncthreads_or(alive_k);
  }
  return k;
}

// The launchers' shape check: whole tiles, whole chunks, a grid CUDA takes
__host__ inline bool bad_shape(int Qp, int Wp, int d, int chunk_d) {
  return Qp <= 0 || Wp <= 0 || Qp % BQ || Wp % BW || chunk_d <= 0 ||
         d % chunk_d || Qp / BQ > 65535;
}

}  // namespace sssj
