// Tile join with in-kernel candidate select, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/sssj_join/kernel.py::_cand_kernel
// (score core _tile_scores), launched there by
// sssj_join_candidates_kernel_call.  One thread block owns one
// (bq query rows x bw window rows) tile, any edges of 1 or more.  A tile
// with both edges up to 128 runs in the compiled tile <BQ, BW> (32, 64
// or 128 each) that holds it (cand_kernel), and
//   1. runs the score core of tile_scores.cuh (decay with the masks, the
//      tile's time and gate kill, the chunk loop with its l2 early exit);
//   2. selects the >= theta entries in in-tile row-major order into a
//      (tile_k,) buffer, with the true count and a per-row hit flag.
// A tile with an edge above 128 (cand_big_kernel) runs the same steps
// over its sub-tiles (big_tile_scores in tile_scores.cuh), its
// accumulators in an f32 workspace of the join's (Qp, Wp) shape that the
// wrapper allocates only for such tiles (64 MB at Qp 256, Wp 65,536).
// Its select keeps the row-major order over the whole tile in two passes
// per band of BQ rows: the first thresholds the band's scores in the
// workspace and counts each row's hits across all its sub-tiles, and a
// block-wide scan over the rows gives each row its first rank; the second
// ranks each sub-tile's hits within their row by a scan over column
// groups, after the row's hits in the sub-tiles to its left.
//
// What bounds it on an H100: the 3xTF32 tensor-core products of the live
// tiles (3 x 2 x bq x bw x chunk_d per chunk run, at 495 TFLOP/s of
// TF32); a gated-off tile reads its gate bit and writes a (tile_k,) fill,
// and a time-dead one also its lanes.  The score core is described in
// tile_scores.cuh.  The TPU kernel's cumsum + binary search becomes a
// block-wide exclusive scan: the scores, row-major in shared memory, are
// cut into runs of EPT adjacent entries of one row, one run a thread in
// row-major order, so a scan over the runs' hit counts gives every hit
// its row-major rank; the compiled tile's spare rows and columns hold no
// hit, so they move no rank.
#include "tile_scores.cuh"

namespace {

using namespace sssj;

// A tile's empty outputs: no candidate, no row hit, nothing emitted
__device__ __forceinline__ void empty_outputs(int* out_idx, float* out_sc, int* rows,
                                              int* emitted, int tile_k, int bq) {
  for (int s = threadIdx.x; s < tile_k; s += blockDim.x) {
    out_idx[s] = -1;
    out_sc[s] = 0.0f;
  }
  for (int r = threadIdx.x; r < bq; r += blockDim.x) rows[r] = 0;
  if (threadIdx.x == 0) *emitted = 0;
}

template <class T>
__global__ void __launch_bounds__(NT, 1) cand_kernel(
    const TileIn in, int* __restrict__ cand_idx, float* __restrict__ cand_score,
    int* __restrict__ emitted, int* __restrict__ row_hits,
    int* __restrict__ iters, int tile_k) {
  constexpr int BQ = T::BQ, BW = T::BW;
  constexpr int NS = BQ * BW / 4 < NT ? BQ * BW / 4 : NT;  // threads in the select
  constexpr int TPR = NS / BQ;   // threads per tile row in the select
  constexpr int EPT = BW / TPR;  // entries per thread: a run of one row
  static_assert(EPT % 4 == 0 && EPT <= 64 && 32 % TPR == 0,
                "runs of float4, hits in one word, a row's threads in one warp");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T>& sm = smem_of<T>(smem_raw);
  __shared__ int warp_tot[NT / 32];

  const size_t tile = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const int tid = threadIdx.x;
  const int bq = in.bq, bw = in.bw;
  const size_t q0 = (size_t)blockIdx.y * bq, w0 = (size_t)blockIdx.x * bw;
  int* out_idx = cand_idx + tile * tile_k;
  float* out_sc = cand_score + tile * tile_k;

  // dead before the first chunk (gated off, or no decay reaches theta):
  // nothing can emit, and a gated-off tile reads nothing else
  bool live = in.gate == nullptr || in.gate[tile] > 0;
  if (live) {
    stage_lanes<T>(in, sm.L, q0, bq, w0, bw);
    live = tile_may_live<T>(in, sm);
  }
  if (live) {
    tile_prefetch<T>(in, sm, q0, w0);
    live = tile_decays_reach<T>(in, sm);
  }
  if (!live) {
    cp_async_wait<0>();  // the prefetch, if any, has landed
    if (tid == 0) iters[tile] = 0;
    empty_outputs(out_idx, out_sc, row_hits + tile * bq, emitted + tile, tile_k, bq);
    return;
  }

  Acc<T> acc;
  const int k = tile_dot<T>(in, sm, q0, w0, acc);
  if (tid == 0) iters[tile] = k;
  float* S = sm.ring[0];  // the ring is free after the chunk loop
  scores_to_smem<T, true>(sm, acc, S);
  __syncthreads();

  // thread t < NS holds the EPT entries from column (t % TPR) * EPT of
  // row t / TPR: threads in order cover the tile in row-major order (the
  // rest hold none)
  const bool sel = tid < NS;
  const int i = tid / TPR, c0 = (tid % TPR) * EPT;
  const float* srow = S + i * T::LDS + c0;
  uint64_t hits = 0;
  if (sel) {
#pragma unroll
    for (int v = 0; v < EPT / 4; ++v) {
      const float4 x = *reinterpret_cast<const float4*>(srow + 4 * v);
      hits |= (uint64_t)((x.x > 0.0f) | (x.y > 0.0f) << 1 | (x.z > 0.0f) << 2 |
                         (x.w > 0.0f) << 3) << (4 * v);
    }
  }
  const int cnt = __popcll(hits);

  // block-wide exclusive scan of the counts: each run's first rank
  const int lane = tid & 31, warp = tid >> 5;
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += n;
  }
  if (lane == 31) warp_tot[warp] = incl;
  int row_total = cnt;
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) row_total += __shfl_xor_sync(0xffffffffu, row_total, o);
  __syncthreads();
  int rank = incl - cnt, total = 0;
#pragma unroll
  for (int v = 0; v < NT / 32; ++v) {
    if (v < warp) rank += warp_tot[v];
    total += warp_tot[v];
  }
  if (sel && tid % TPR == 0 && (T::FULL || i < bq)) row_hits[tile * bq + i] = row_total > 0;

  // every hit goes to its row-major rank; the first tile_k are kept
  for (uint64_t m = hits; m && rank < tile_k; m &= m - 1, ++rank) {
    const int b = __ffsll((long long)m) - 1;
    out_idx[rank] = i * bw + c0 + b;
    out_sc[rank] = srow[b];
  }
  for (int s = min(total, tile_k) + tid; s < tile_k; s += NT) {
    out_idx[s] = -1;
    out_sc[s] = 0.0f;
  }
  if (tid == 0) emitted[tile] = total;
}

// A tile with an edge above 128: the score core over sub-tiles into the
// workspace ws (Qp, Wp), then the two-pass row-major select
template <class T>
__global__ void __launch_bounds__(NT) cand_big_kernel(
    const TileIn in, float* __restrict__ ws, int Wp, int* __restrict__ cand_idx,
    float* __restrict__ cand_score, int* __restrict__ emitted,
    int* __restrict__ row_hits, int* __restrict__ iters, int tile_k) {
  constexpr int BQ = T::BQ, BW = T::BW, RM = T::RM, RN = T::RN, VN = T::VN;
  constexpr int NGROUP = BW / VN;         // column groups per sub-tile row
  constexpr int PER = BQ * NGROUP / NT;   // groups scanned per thread
  constexpr int TPR = NT / BQ;            // threads that scan one row
  static_assert(PER * NT == BQ * NGROUP && PER * TPR == NGROUP, "scan layout");
  static_assert(BQ * NGROUP <= T::SLAB, "scan buffer reuses the slabs");
  static_assert(RM * RN <= 64, "hit bits fit one word");

  __shared__ __align__(16) float slab[T::SLAB];  // q | w; then the scan
  __shared__ Lanes<BQ, BW> L;
  __shared__ int row_pos[BQ];     // the next rank of each row of the band
  __shared__ int warp_tot[NT / 32];

  const size_t tile = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int lane = tid & 31, warp = tid >> 5;
  const int bq = in.bq, bw = in.bw;
  const int nsq = (bq + BQ - 1) / BQ, nsw = (bw + BW - 1) / BW;

  const int k = big_tile_scores<T>(in, L, slab, ws, Wp);
  if (tid == 0) iters[tile] = k;

  int* out_idx = cand_idx + tile * tile_k;
  float* out_sc = cand_score + tile * tile_k;
  if (k == 0) {  // dead before the first chunk: nothing can emit
    empty_outputs(out_idx, out_sc, row_hits + tile * bq, emitted + tile, tile_k, bq);
    return;
  }

  int* gcount = reinterpret_cast<int*>(slab);
  constexpr uint64_t GROUP_BITS = (1ull << VN) - 1;
  float v[RM][RN], dec[RM][RN];
  int base = 0;  // hits in the bands above
  for (int sq = 0; sq < nsq; ++sq) {
    // pass 1: each entry's score, kept in ws where it emits (score >=
    // theta_row and score > 0) and 0 elsewhere; each row's hits
    int rc[RM];
#pragma unroll
    for (int a = 0; a < RM; ++a) rc[a] = 0;
    for (int sw = 0; sw < nsw; ++sw) {
      const SubTile s = sub_tile<T>(in, sq, sw);
      const uint32_t rin = rows_inside<T>(ty, s.nr), cin = cols_inside<T>(tx, s.nc);
      __syncthreads();  // L is free
      stage_lanes<T>(in, L, s.q0, s.nr, s.w0, s.nc);
      tile_decay<T>(in, L, rin, cin, dec);
      ws_load<T>(ws, Wp, s, rin, cin, v);
#pragma unroll
      for (int a = 0; a < RM; ++a) {
        const int i = T::row(ty, a);
#pragma unroll
        for (int b = 0; b < RN; ++b) {
          const float sc = __fmul_rn(v[a][b], dec[a][b]);
          const bool hit = sc >= L.th[i] && sc > 0.0f;  // spare: th +inf, decay 0
          v[a][b] = hit ? sc : 0.0f;
          rc[a] += hit;
        }
      }
      ws_store<T>(ws, Wp, s, rin, cin, v);
    }
    // a row's columns lie with the 16 threads tx of one half warp
#pragma unroll
    for (int a = 0; a < RM; ++a) {
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) rc[a] += __shfl_xor_sync(0xffffffffu, rc[a], o);
      if (tx == 0) row_pos[T::row(ty, a)] = rc[a];
    }
    __syncthreads();
    // exclusive scan over the band's rows: each row's first rank
    const int cnt = tid < BQ ? row_pos[tid] : 0;
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += n;
    }
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    int run = incl - cnt, band = 0;
#pragma unroll
    for (int u = 0; u < NT / 32; ++u) {
      if (u < warp) run += warp_tot[u];
      band += warp_tot[u];
    }
    if (tid < BQ) {
      row_pos[tid] = base + run;
      if (sq * BQ + tid < bq) row_hits[tile * bq + sq * BQ + tid] = cnt > 0;
    }
    base += band;

    // pass 2: each sub-tile's hits, ranked after the row's hits in the
    // sub-tiles to their left
    for (int sw = 0; sw < nsw; ++sw) {
      const SubTile s = sub_tile<T>(in, sq, sw);
      const uint32_t rin = rows_inside<T>(ty, s.nr), cin = cols_inside<T>(tx, s.nc);
      ws_load<T>(ws, Wp, s, rin, cin, v);
      uint64_t hits = 0;
#pragma unroll
      for (int a = 0; a < RM; ++a)
#pragma unroll
        for (int b = 0; b < RN; ++b)
          if (v[a][b] > 0.0f) hits |= 1ull << (a * RN + b);
      __syncthreads();  // row_pos is set; the previous ranks are read
#pragma unroll
      for (int a = 0; a < RM; ++a)
#pragma unroll
        for (int h = 0; h < RN / VN; ++h)
          gcount[T::row(ty, a) * NGROUP + h * 16 + tx] =
              __popcll((hits >> (a * RN + h * VN)) & GROUP_BITS);
      __syncthreads();
      // thread t owns groups [t*PER, (t+1)*PER), a 1/TPR share of row
      // t/TPR: an exclusive scan over the row's TPR threads
      int loc[PER];
      int sum = 0;
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        loc[e] = gcount[tid * PER + e];
        sum += loc[e];
      }
      int rincl = sum;
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1) {
        const int n = __shfl_up_sync(0xffffffffu, rincl, o, TPR);
        if (tid % TPR >= o) rincl += n;
      }
      const int row_sub = __shfl_sync(0xffffffffu, rincl, TPR - 1, TPR);
      int r = row_pos[tid / TPR] + rincl - sum;
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        gcount[tid * PER + e] = r;
        r += loc[e];
      }
      __syncthreads();
      if (tid % TPR == 0) row_pos[tid / TPR] += row_sub;
#pragma unroll
      for (int a = 0; a < RM; ++a) {
        const int i = T::row(ty, a);
#pragma unroll
        for (int h = 0; h < RN / VN; ++h) {
          int rank = gcount[i * NGROUP + h * 16 + tx];
#pragma unroll
          for (int bb = 0; bb < VN; ++bb) {
            const int b = h * VN + bb;
            if ((hits >> (a * RN + b)) & 1ull) {
              if (rank < tile_k) {
                out_idx[rank] = (sq * BQ + i) * bw + sw * BW + T::col(tx, b);
                out_sc[rank] = v[a][b];
              }
              ++rank;
            }
          }
        }
      }
    }
    __syncthreads();  // row_pos and gcount are free for the next band
  }
  for (int s = min(base, tile_k) + tid; s < tile_k; s += NT) {
    out_idx[s] = -1;
    out_sc[s] = 0.0f;
  }
  if (tid == 0) emitted[tile] = base;
}

}  // namespace

// Shapes: q (Qp, d), w (Wp, d) f32 row-major; tq/uq (Qp,), tw/uw (Wp,);
// sqq (Qp, n_chunks), sqw (Wp, n_chunks); the four stream lanes (sidq,
// sidw (Wp,), thq, lmq) all null or all set; gate (Qp/bq, Wp/bw) or null;
// bq, bw >= 1; ws an f32 (Qp, Wp) workspace when an edge is above 128,
// else unused.  Outputs: cand_idx/cand_score (nq, nw, tile_k),
// emitted/iters (nq, nw), row_hits (nq, nw, bq).  Returns
// cudaGetLastError() after the launch.
extern "C" int sssj_cand_launch(
    const void* q, const void* w, const void* tq, const void* tw,
    const void* uq, const void* uw, const void* sqq, const void* sqw,
    const void* sidq, const void* sidw, const void* thq, const void* lmq,
    const void* gate, void* ws, void* cand_idx, void* cand_score, void* emitted,
    void* row_hits, void* iters, int Qp, int Wp, int d, int chunk_d,
    int tile_k, int bq, int bw, float theta, float lam, void* stream) {
  const bool big = bq > MAX_EDGE || bw > MAX_EDGE;
  if (bad_shape(Qp, Wp, d, chunk_d, bq, bw) || tile_k <= 0 || (big && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const TileIn in{
      (const float*)q, (const float*)w, (const float*)tq, (const float*)tw,
      (const int*)uq, (const int*)uw, (const float*)sqq, (const float*)sqw,
      (const int*)sidq, (const int*)sidw, (const float*)thq,
      (const float*)lmq, (const int*)gate, d, chunk_d, d / chunk_d, theta,
      lam, bq, bw};
  const dim3 grid(Wp / bw, Qp / bq);
  const cudaStream_t st = (cudaStream_t)stream;
  if (big)
    return with_big_tile(bq, bw, [&](auto tile) {
      using T = decltype(tile);
      cand_big_kernel<T><<<grid, NT, 0, st>>>(
          in, (float*)ws, Wp, (int*)cand_idx, (float*)cand_score, (int*)emitted,
          (int*)row_hits, (int*)iters, tile_k);
      return (int)cudaGetLastError();
    });
  return with_tile(bq, bw, [&](auto tile) {
    using T = decltype(tile);
    const int err = allow_smem(cand_kernel<T>, smem_bytes<T>());
    if (err) return err;
    cand_kernel<T><<<grid, NT, smem_bytes<T>(), st>>>(
        in, (int*)cand_idx, (float*)cand_score, (int*)emitted, (int*)row_hits,
        (int*)iters, tile_k);
    return (int)cudaGetLastError();
  });
}
