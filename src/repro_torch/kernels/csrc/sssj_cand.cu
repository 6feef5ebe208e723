// Tile join with in-kernel candidate select, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/sssj_join/kernel.py::_cand_kernel
// (score core _tile_scores), launched there by
// sssj_join_candidates_kernel_call.  One thread block owns one
// (128 query rows x 128 window rows) tile and
//   1. builds the decay matrix exp(-lambda |dt|) with the uid-order,
//      empty-slot and stream masks folded in as zeros, and kills the tile
//      when no entry reaches theta or when its pre-launch gate bit is 0;
//   2. accumulates q . w^T one chunk_d slab at a time and stops once
//      (acc + |q^{>k}| |w^{>k}|) . decay < theta holds for the whole tile;
//   3. selects the >= theta entries in in-tile row-major order into a
//      (tile_k,) buffer, with the true count and a per-row hit flag.
//
// What bounds it on an H100: the f32 multiply-adds of the live tiles
// (2 * 128 * 128 * chunk_d per chunk run), at the 67 TFLOP/s of the CUDA
// cores, since the dot products must stay in IEEE f32 (TF32 moves scores
// by ~1e-3 and pairs across theta).  Dead tiles cost their lane loads and
// a (tile_k,) fill.  Design: 256 threads, each holding an 8 x 8 block of
// accumulators in registers; q and w are staged through shared memory in
// 32-column sub-slabs, stored k-major so each thread reads its 8 rows and
// 8 columns as float4 pairs without bank conflicts.  The TPU kernel's
// cumsum + binary search becomes a block-wide exclusive scan over per-row
// 4-column group counts, which gives every hit its row-major rank.
// The bound check and the final score use __fadd_rn/__fmul_rn so nvcc
// does not contract them into an fma: they round as the plain version's
// separate ops do.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;         // query rows per tile
constexpr int BW = 128;         // window rows per tile
constexpr int NT = 256;         // threads: a 16 x 16 grid, 8 x 8 outputs each
constexpr int SUB = 32;         // feature columns per shared-memory sub-slab
constexpr int LDS = BQ + 4;     // sub-slab row stride in floats (16-byte aligned)
constexpr int NGROUP = BW / 4;  // 4-column groups per tile row: the scan's unit
constexpr int PER = BQ * NGROUP / NT;  // groups scanned per thread (half a row)

static_assert(BQ == BW && NT == BQ + BW, "lane loads assume one row per thread");
static_assert(PER * NT == BQ * NGROUP && PER == NGROUP / 2, "scan layout");
static_assert(BQ * NGROUP <= 2 * SUB * LDS, "scan buffer reuses the slabs");

struct Lanes {
  float tq[BQ], tw[BW], th[BQ], lam[BQ];
  int uq[BQ], uw[BW], sq[BQ], sw[BW];
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

__global__ void __launch_bounds__(NT) cand_kernel(
    const float* __restrict__ q, const float* __restrict__ w,
    const float* __restrict__ tq, const float* __restrict__ tw,
    const int* __restrict__ uq, const int* __restrict__ uw,
    const float* __restrict__ sqq, const float* __restrict__ sqw,
    const int* __restrict__ sidq, const int* __restrict__ sidw,
    const float* __restrict__ thq, const float* __restrict__ lmq,
    const int* __restrict__ gate,
    int* __restrict__ cand_idx, float* __restrict__ cand_score,
    int* __restrict__ emitted, int* __restrict__ row_hits,
    int* __restrict__ iters,
    int d, int chunk_d, int n_chunks, int tile_k, float theta, float lam) {
  __shared__ __align__(16) float slab[2 * SUB * LDS];  // q | w; then the scan
  __shared__ Lanes L;
  __shared__ int warp_tot[NT / 32];

  const int tj = blockIdx.x, ti = blockIdx.y, nw = gridDim.x;
  const size_t tile = (size_t)ti * nw + tj;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const bool multi = sidq != nullptr;
  const size_t q0 = (size_t)ti * BQ, w0 = (size_t)tj * BW;

  if (tid < BQ) {
    L.tq[tid] = tq[q0 + tid];
    L.uq[tid] = uq[q0 + tid];
    L.th[tid] = multi ? thq[q0 + tid] : theta;
    L.lam[tid] = multi ? lmq[q0 + tid] : lam;
    L.sq[tid] = multi ? sidq[q0 + tid] : 0;
  } else {
    const int j = tid - BQ;
    L.tw[j] = tw[w0 + j];
    L.uw[j] = uw[w0 + j];
    L.sw[j] = multi ? sidw[w0 + j] : 0;
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
  if (gate != nullptr && gate[tile] <= 0) live = 0;

  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.0f;

  float* qs = slab;
  float* ws = slab + SUB * LDS;
  int k = 0;
  while (live && k < n_chunks) {
    const size_t col0 = (size_t)k * chunk_d;
    for (int c0 = 0; c0 < chunk_d; c0 += SUB) {
      for (int e = tid; e < BQ * SUB; e += NT) {
        const int r = e / SUB, c = e % SUB;
        const bool in = c0 + c < chunk_d;
        qs[c * LDS + r] = in ? q[(q0 + r) * d + col0 + c0 + c] : 0.0f;
        ws[c * LDS + r] = in ? w[(w0 + r) * d + col0 + c0 + c] : 0.0f;
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
    for (int a = 0; a < 8; ++a) sa[a] = sqq[(q0 + row_of(ty, a)) * n_chunks + k];
#pragma unroll
    for (int b = 0; b < 8; ++b) sb[b] = sqw[(w0 + col_of(tx, b)) * n_chunks + k];
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
  if (tid == 0) iters[tile] = k;

  int* out_idx = cand_idx + tile * tile_k;
  float* out_sc = cand_score + tile * tile_k;
  if (k == 0) {  // dead before the first chunk: nothing can emit
    for (int s = tid; s < tile_k; s += NT) {
      out_idx[s] = -1;
      out_sc[s] = 0.0f;
    }
    if (tid < BQ) row_hits[tile * BQ + tid] = 0;
    if (tid == 0) emitted[tile] = 0;
    return;
  }

  // scores and hits: an entry emits when score >= theta_row and score > 0
  uint64_t hits = 0;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int i = row_of(ty, a);
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const float s = __fmul_rn(acc[a][b], decay_at(L, i, col_of(tx, b), multi));
      acc[a][b] = s;
      if (s >= L.th[i] && s > 0.0f) hits |= 1ull << (a * 8 + b);
    }
  }

  // per (row, 4-column group) hit counts; the slabs are free after the
  // chunk loop's last barrier
  int* gcount = reinterpret_cast<int*>(slab);
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      gcount[row_of(ty, a) * NGROUP + h * 16 + tx] =
          __popcll((hits >> (a * 8 + h * 4)) & 0xFull);
  __syncthreads();

  // block-wide exclusive scan over the groups in row-major order: thread t
  // owns groups [t*PER, (t+1)*PER), i.e. half of row t/2
  int loc[PER];
  int sum = 0;
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    loc[e] = gcount[tid * PER + e];
    sum += loc[e];
  }
  const int lane = tid & 31, warp = tid >> 5;
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += n;
  }
  if (lane == 31) warp_tot[warp] = incl;
  const int row_total = sum + __shfl_xor_sync(0xffffffffu, sum, 1);
  __syncthreads();
  int run = incl - sum, total = 0;
#pragma unroll
  for (int v = 0; v < NT / 32; ++v) {
    if (v < warp) run += warp_tot[v];
    total += warp_tot[v];
  }
  if ((tid & 1) == 0) row_hits[tile * BQ + tid / 2] = row_total > 0;
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    gcount[tid * PER + e] = run;
    run += loc[e];
  }
  __syncthreads();

  // every hit goes to its row-major rank; the first tile_k are kept
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int i = row_of(ty, a);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int rank = gcount[i * NGROUP + h * 16 + tx];
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int b = h * 4 + bb;
        if ((hits >> (a * 8 + b)) & 1ull) {
          if (rank < tile_k) {
            out_idx[rank] = i * BW + col_of(tx, b);
            out_sc[rank] = acc[a][b];
          }
          ++rank;
        }
      }
    }
  }
  for (int s = min(total, tile_k) + tid; s < tile_k; s += NT) {
    out_idx[s] = -1;
    out_sc[s] = 0.0f;
  }
  if (tid == 0) emitted[tile] = total;
}

}  // namespace

// Shapes: q (Qp, d), w (Wp, d) f32 row-major; tq/uq (Qp,), tw/uw (Wp,);
// sqq (Qp, n_chunks), sqw (Wp, n_chunks); the four stream lanes (sidq,
// sidw (Wp,), thq, lmq) all null or all set; gate (Qp/128, Wp/128) or null.
// Outputs: cand_idx/cand_score (nq, nw, tile_k), emitted/iters (nq, nw),
// row_hits (nq, nw, 128).  Returns cudaGetLastError() after the launch.
extern "C" int sssj_cand_launch(
    const void* q, const void* w, const void* tq, const void* tw,
    const void* uq, const void* uw, const void* sqq, const void* sqw,
    const void* sidq, const void* sidw, const void* thq, const void* lmq,
    const void* gate, void* cand_idx, void* cand_score, void* emitted,
    void* row_hits, void* iters, int Qp, int Wp, int d, int chunk_d,
    int tile_k, float theta, float lam, void* stream) {
  if (Qp <= 0 || Wp <= 0 || Qp % BQ || Wp % BW || chunk_d <= 0 ||
      d % chunk_d || tile_k <= 0 || Qp / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(Wp / BW, Qp / BQ);
  cand_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)w, (const float*)tq, (const float*)tw,
      (const int*)uq, (const int*)uw, (const float*)sqq, (const float*)sqw,
      (const int*)sidq, (const int*)sidw, (const float*)thq,
      (const float*)lmq, (const int*)gate, (int*)cand_idx,
      (float*)cand_score, (int*)emitted, (int*)row_hits, (int*)iters, d,
      chunk_d, d / chunk_d, tile_k, theta, lam);
  return (int)cudaGetLastError();
}
