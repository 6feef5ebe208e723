// Tile join with dense emission, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/sssj_join/kernel.py::_kernel
// (score core _tile_scores), launched there by sssj_join_kernel_call.
// One thread block owns one (bq query rows x bw window rows) tile, any
// edges of 1 or more; with both edges up to 128 it runs in the compiled
// tile <BQ, BW> (32, 64 or 128 each) that holds it (dense_kernel), and
//   1. runs the score core of tile_scores.cuh (decay with the masks, the
//      tile's time kill, the chunk loop with its l2 early exit), without
//      stream lanes or gate, as the TPU kernel has none;
//   2. writes the whole thresholded tile, acc * decay where it reaches
//      theta and 0 elsewhere (a time-dead tile writes zeros), the chunks
//      it ran and its count of entries > 0.
// A tile with an edge above 128 (dense_big_kernel) runs the same steps
// over its sub-tiles (big_tile_scores in tile_scores.cuh), with the
// output itself as the workspace of its accumulators, thresholded in
// place at the end.
//
// What bounds it on an H100: the (Qp, Wp) f32 output, which every call
// writes in full (128 x 262,144 x 4 B = 134 MB at the engine's window,
// 40 us at 3.35 TB/s), and the 3xTF32 tensor-core products of the live
// tiles (3 x 2 x bq x bw x chunk_d per chunk run, at 495 TFLOP/s of
// TF32).  Design: the score core is the candidate kernel's, so the two
// cannot drift; the scores pass through shared memory, from where BW / 4
// threads store each of the tile's rows as float4 runs over its
// contiguous bytes when the tile fills its compiled width (bw == BW), and
// one by one otherwise; a time-dead tile stores zeros.
#include "tile_scores.cuh"

namespace {

using namespace sssj;

template <class T>
__global__ void __launch_bounds__(NT, 1) dense_kernel(
    const TileIn in, float* __restrict__ out, int* __restrict__ iters,
    int* __restrict__ counts, int Wp) {
  constexpr int F4 = T::BW / 4;   // float4 runs per tile row
  constexpr int RPP = NT / F4;    // tile rows per pass of the block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T>& sm = smem_of<T>(smem_raw);
  __shared__ int tile_count;

  const size_t tile = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const int tid = threadIdx.x;
  const int bq = in.bq, bw = in.bw;
  const size_t q0 = (size_t)blockIdx.y * bq, w0 = (size_t)blockIdx.x * bw;
  const bool full_width = T::FULL || bw == T::BW;
  if (tid == 0) tile_count = 0;  // stage_lanes syncs before any use
  stage_lanes<T>(in, sm.L, q0, bq, w0, bw);
  bool live = tile_may_live<T>(in, sm);
  if (live) {
    tile_prefetch<T>(in, sm, q0, w0);
    live = tile_decays_reach<T>(in, sm);
    if (!live) cp_async_wait<0>();  // the prefetch has landed
  }
  const float* S = sm.ring[0];  // the ring is free after the chunk loop
  int k = 0;
  if (live) {  // a time-dead tile writes zeros
    Acc<T> acc;
    k = tile_dot<T>(in, sm, q0, w0, acc);
    scores_to_smem<T, false>(sm, acc, sm.ring[0]);
    __syncthreads();
  }

  // the tile's rows from S, F4 threads covering a row's contiguous bytes
  int count = 0;
  const int f = tid % F4;
  for (int r = tid / F4; r < T::BQ; r += RPP) {
    if (!T::FULL && r >= bq) break;
    const float4 v = live ? *reinterpret_cast<const float4*>(S + r * T::LDS + 4 * f)
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    count += (v.x > 0.0f) + (v.y > 0.0f) + (v.z > 0.0f) + (v.w > 0.0f);
    float* dst = out + (q0 + r) * Wp + w0 + 4 * f;
    if (full_width) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int x = 0; x < 4; ++x)
        if (4 * f + x < bw) dst[x] = e[x];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) count += __shfl_xor_sync(0xffffffffu, count, o);
  if ((tid & 31) == 0 && count) atomicAdd(&tile_count, count);
  __syncthreads();
  if (tid == 0) {
    iters[tile] = k;
    counts[tile] = tile_count;
  }
}

// A tile with an edge above 128: the score core over sub-tiles, its
// accumulators in out, then each sub-tile thresholded in place
template <class T>
__global__ void __launch_bounds__(NT) dense_big_kernel(
    const TileIn in, float* __restrict__ out, int* __restrict__ iters,
    int* __restrict__ counts, int Wp) {
  constexpr int RM = T::RM, RN = T::RN;
  __shared__ __align__(16) float slab[T::SLAB];
  __shared__ Lanes<T::BQ, T::BW> L;
  __shared__ int tile_count;

  const size_t tile = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int nsq = (in.bq + T::BQ - 1) / T::BQ, nsw = (in.bw + T::BW - 1) / T::BW;
  if (tid == 0) tile_count = 0;  // big_tile_scores syncs before any use

  const int k = big_tile_scores<T>(in, L, slab, out, Wp);
  float v[RM][RN], dec[RM][RN];
  int count = 0;
  for (int sq = 0; sq < nsq; ++sq)
    for (int sw = 0; sw < nsw; ++sw) {
      const SubTile s = sub_tile<T>(in, sq, sw);
      const uint32_t rin = rows_inside<T>(ty, s.nr), cin = cols_inside<T>(tx, s.nc);
      __syncthreads();  // L is free
      stage_lanes<T>(in, L, s.q0, s.nr, s.w0, s.nc);
      tile_decay<T>(in, L, rin, cin, dec);
      ws_load<T>(out, Wp, s, k > 0 ? rin : 0u, cin, v);  // a dead tile's out is unset
#pragma unroll
      for (int a = 0; a < RM; ++a) {
        const int i = T::row(ty, a);
#pragma unroll
        for (int b = 0; b < RN; ++b) {
          float sc = 0.0f;
          if (k > 0) {  // a spare column's decay is 0, so its score too
            sc = __fmul_rn(v[a][b], dec[a][b]);
            sc = sc >= L.th[i] ? sc : 0.0f;
          }
          v[a][b] = sc;
          count += sc > 0.0f;
        }
      }
      ws_store<T>(out, Wp, s, rin, cin, v);
    }
  if (count) atomicAdd(&tile_count, count);
  __syncthreads();
  if (tid == 0) {
    iters[tile] = k;
    counts[tile] = tile_count;
  }
}

}  // namespace

// Shapes: q (Qp, d), w (Wp, d) f32 row-major; tq/uq (Qp,), tw/uw (Wp,);
// sqq (Qp, n_chunks), sqw (Wp, n_chunks); bq, bw >= 1.  Outputs:
// out (Qp, Wp) f32, iters/counts (Qp/bq, Wp/bw) i32, every element
// written.  Returns cudaGetLastError() after the launch.
extern "C" int sssj_dense_launch(
    const void* q, const void* w, const void* tq, const void* tw,
    const void* uq, const void* uw, const void* sqq, const void* sqw,
    void* out, void* iters, void* counts, int Qp, int Wp, int d, int chunk_d,
    int bq, int bw, float theta, float lam, void* stream) {
  if (bad_shape(Qp, Wp, d, chunk_d, bq, bw)) return (int)cudaErrorInvalidValue;
  const TileIn in{
      (const float*)q, (const float*)w, (const float*)tq, (const float*)tw,
      (const int*)uq, (const int*)uw, (const float*)sqq, (const float*)sqw,
      nullptr, nullptr, nullptr, nullptr, nullptr, d, chunk_d, d / chunk_d,
      theta, lam, bq, bw};
  const dim3 grid(Wp / bw, Qp / bq);
  const cudaStream_t st = (cudaStream_t)stream;
  if (bq > MAX_EDGE || bw > MAX_EDGE)
    return with_big_tile(bq, bw, [&](auto tile) {
      using T = decltype(tile);
      dense_big_kernel<T><<<grid, NT, 0, st>>>(in, (float*)out, (int*)iters,
                                              (int*)counts, Wp);
      return (int)cudaGetLastError();
    });
  return with_tile(bq, bw, [&](auto tile) {
    using T = decltype(tile);
    const int err = allow_smem(dense_kernel<T>, smem_bytes<T>());
    if (err) return err;
    dense_kernel<T><<<grid, NT, smem_bytes<T>(), st>>>(in, (float*)out, (int*)iters,
                                                       (int*)counts, Wp);
    return (int)cudaGetLastError();
  });
}
