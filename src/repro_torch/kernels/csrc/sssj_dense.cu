// Tile join with dense emission, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/sssj_join/kernel.py::_kernel
// (score core _tile_scores), launched there by sssj_join_kernel_call.
// One thread block owns one (128 query rows x 128 window rows) tile and
//   1. runs the score core of tile_scores.cuh (decay with the masks, the
//      tile's time kill, the chunk loop with its l2 early exit), without
//      stream lanes or gate, as the TPU kernel has none;
//   2. writes the whole thresholded tile, acc * decay where it reaches
//      theta and 0 elsewhere (a time-dead tile writes zeros), the chunks
//      it ran and its count of entries > 0.
//
// What bounds it on an H100: the (Qp, Wp) f32 output, which every call
// writes in full (128 x 262,144 x 4 B = 134 MB at the engine's window,
// 40 us at 3.35 TB/s), and the f32 multiply-adds of the live tiles (2 *
// 128 * 128 * chunk_d per chunk run, at the 67 TFLOP/s of the CUDA
// cores).  Design: the score core is the candidate kernel's, so the two
// cannot drift; each thread stores its 8 rows as float4s, 16 threads
// covering 256 contiguous bytes of a row.
#include "tile_scores.cuh"

namespace {

using namespace sssj;

__global__ void __launch_bounds__(NT) dense_kernel(
    const TileIn in, float* __restrict__ out, int* __restrict__ iters,
    int* __restrict__ counts, int Wp) {
  __shared__ __align__(16) float slab[2 * SUB * LDS];
  __shared__ Lanes L;
  __shared__ int tile_count;

  const size_t tile = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t q0 = (size_t)blockIdx.y * BQ, w0 = (size_t)blockIdx.x * BW;
  if (tid == 0) tile_count = 0;  // tile_scores syncs before any use

  float acc[8][8];
  const int k = tile_scores(in, L, slab, acc);

  int count = 0;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int i = row_of(ty, a);
    float* row = out + (q0 + i) * Wp + w0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[4];
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int b = h * 4 + bb;
        float s = 0.0f;
        if (k > 0) {
          s = __fmul_rn(acc[a][b], decay_at(L, i, col_of(tx, b), false));
          s = s >= L.th[i] ? s : 0.0f;
        }
        v[bb] = s;
        count += s > 0.0f;
      }
      *reinterpret_cast<float4*>(row + col_of(tx, h * 4)) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
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
// sqq (Qp, n_chunks), sqw (Wp, n_chunks).  Outputs: out (Qp, Wp) f32,
// iters/counts (Qp/128, Wp/128) i32, every element written.  Returns
// cudaGetLastError() after the launch.
extern "C" int sssj_dense_launch(
    const void* q, const void* w, const void* tq, const void* tw,
    const void* uq, const void* uw, const void* sqq, const void* sqw,
    void* out, void* iters, void* counts, int Qp, int Wp, int d, int chunk_d,
    float theta, float lam, void* stream) {
  if (bad_shape(Qp, Wp, d, chunk_d)) return (int)cudaErrorInvalidValue;
  const TileIn in{
      (const float*)q, (const float*)w, (const float*)tq, (const float*)tw,
      (const int*)uq, (const int*)uw, (const float*)sqq, (const float*)sqw,
      nullptr, nullptr, nullptr, nullptr, nullptr, d, chunk_d, d / chunk_d,
      theta, lam};
  const dim3 grid(Wp / BW, Qp / BQ);
  dense_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      in, (float*)out, (int*)iters, (int*)counts, Wp);
  return (int)cudaGetLastError();
}
