// Tile join with in-kernel candidate select, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/sssj_join/kernel.py::_cand_kernel
// (score core _tile_scores), launched there by
// sssj_join_candidates_kernel_call.  One thread block owns one
// (128 query rows x 128 window rows) tile and
//   1. runs the score core of tile_scores.cuh (decay with the masks, the
//      tile's time and gate kill, the chunk loop with its l2 early exit);
//   2. selects the >= theta entries in in-tile row-major order into a
//      (tile_k,) buffer, with the true count and a per-row hit flag.
//
// What bounds it on an H100: the f32 multiply-adds of the live tiles
// (2 * 128 * 128 * chunk_d per chunk run), at the 67 TFLOP/s of the CUDA
// cores, since the dot products must stay in IEEE f32 (TF32 moves scores
// by ~1e-3 and pairs across theta).  Dead tiles cost their lane loads and
// a (tile_k,) fill.  The core's register tiling is described in
// tile_scores.cuh.  The TPU kernel's cumsum + binary search becomes a
// block-wide exclusive scan over per-row 4-column group counts, which
// gives every hit its row-major rank.
#include "tile_scores.cuh"

namespace {

using namespace sssj;

constexpr int NGROUP = BW / 4;  // 4-column groups per tile row: the scan's unit
constexpr int PER = BQ * NGROUP / NT;  // groups scanned per thread (half a row)

static_assert(PER * NT == BQ * NGROUP && PER == NGROUP / 2, "scan layout");
static_assert(BQ * NGROUP <= 2 * SUB * LDS, "scan buffer reuses the slabs");

__global__ void __launch_bounds__(NT) cand_kernel(
    const TileIn in, int* __restrict__ cand_idx, float* __restrict__ cand_score,
    int* __restrict__ emitted, int* __restrict__ row_hits,
    int* __restrict__ iters, int tile_k) {
  __shared__ __align__(16) float slab[2 * SUB * LDS];  // q | w; then the scan
  __shared__ Lanes L;
  __shared__ int warp_tot[NT / 32];

  const size_t tile = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const bool multi = in.sidq != nullptr;

  float acc[8][8];
  const int k = tile_scores(in, L, slab, acc);
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
  if (bad_shape(Qp, Wp, d, chunk_d) || tile_k <= 0)
    return (int)cudaErrorInvalidValue;
  const TileIn in{
      (const float*)q, (const float*)w, (const float*)tq, (const float*)tw,
      (const int*)uq, (const int*)uw, (const float*)sqq, (const float*)sqw,
      (const int*)sidq, (const int*)sidw, (const float*)thq,
      (const float*)lmq, (const int*)gate, d, chunk_d, d / chunk_d, theta,
      lam};
  const dim3 grid(Wp / BW, Qp / BQ);
  cand_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      in, (int*)cand_idx, (float*)cand_score, (int*)emitted, (int*)row_hits,
      (int*)iters, tile_k);
  return (int)cudaGetLastError();
}
