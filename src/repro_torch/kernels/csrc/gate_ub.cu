// Strip-gate value bound, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/sssj_join/gate.py::_gate_ub_kernel,
// launched there by _tile_ub_pallas.  For query tile i (bq rows, any edge
// of 1 or more) and window strip s:
//   ub[i, s] = max over the tile's bq rows r of
//              min(|q_r| . vmax_s, chunk_norms(q_r) . cnorm_s)
// The TPU version staged all strips at once; at the main path's 2048
// strips x 1024 features vmax alone is 8 MB, far past shared memory, so
// here the grid runs over (blocks of 16 strips, query tiles).  A tile
// runs in the compiled tile of GQ = 32, 64 or 128 rows that holds it;
// rows past bq read nothing and take no part in the max.  A tile of more
// than 128 rows runs as bands of 128 rows, one after another in the
// block, each thread carrying its max across them: a max of maxes is the
// max, exactly.
//
// What bounds it on an H100: the f32 multiply-adds of the prefix bound,
// 2 * Qp * ns * d, at the 67 TFLOP/s of the CUDA cores; vmax (ns * d * 4
// bytes) is read once.  Design: 256 threads, each with GQ/32 rows x 2
// strips of accumulators; |q| and vmax are staged through shared memory
// in 32-feature sub-slabs; the max over rows is a shared-memory reduction.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int GS = 16;    // strips per block
constexpr int GNT = 256;  // threads: 32 row lanes x 8 strip lanes
constexpr int GSUB = 32;  // features per sub-slab

template <int GQ>
__global__ void __launch_bounds__(GNT) gate_ub_kernel(
    const float* __restrict__ qa, const float* __restrict__ qcn,
    const float* __restrict__ vmax, const float* __restrict__ cnorm,
    float* __restrict__ ub, int ns, int d, int nc, int bq) {
  constexpr int RQ = GQ / 32;  // rows per thread: ty + 32 i
  __shared__ float qs[GSUB][GQ + 1];
  __shared__ float vs[GSUB][GS + 1];
  __shared__ float red[32][GS + 1];

  const int sb = blockIdx.x, ti = blockIdx.y;
  const int tid = threadIdx.x, tx = tid % 8, ty = tid / 8;
  const int s0 = sb * GS;
  float m[2] = {-INFINITY, -INFINITY};  // the max over own rows, strips tx + 8 j

  for (int band = 0; band * GQ < bq; ++band) {
    const size_t r0 = (size_t)ti * bq + (size_t)band * GQ;
    const int nr = min(GQ, bq - band * GQ);
    float pb[RQ][2];
#pragma unroll
    for (int i = 0; i < RQ; ++i) pb[i][0] = pb[i][1] = 0.0f;

    for (int c0 = 0; c0 < d; c0 += GSUB) {
      for (int e = tid; e < GQ * GSUB; e += GNT) {
        const int r = e / GSUB, c = e % GSUB;
        qs[c][r] = (r < nr && c0 + c < d) ? qa[(r0 + r) * d + c0 + c] : 0.0f;
      }
      for (int e = tid; e < GS * GSUB; e += GNT) {
        const int s = e / GSUB, c = e % GSUB;
        vs[c][s] = (c0 + c < d && s0 + s < ns) ? vmax[(size_t)(s0 + s) * d + c0 + c]
                                               : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < GSUB; ++kk) {
        float a[RQ], b[2];
#pragma unroll
        for (int i = 0; i < RQ; ++i) a[i] = qs[kk][ty + 32 * i];
#pragma unroll
        for (int j = 0; j < 2; ++j) b[j] = vs[kk][tx + 8 * j];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) pb[i][j] = fmaf(a[i], b[j], pb[i][j]);
      }
      __syncthreads();
    }

    // chunked l2 bound, the min of the two bounds, the max over own rows
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int s = s0 + tx + 8 * j;
      if (s >= ns) continue;
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const int rr = ty + 32 * i;
        if (rr >= nr) continue;
        const size_t r = r0 + rr;
        float lb = 0.0f;
        for (int c = 0; c < nc; ++c)
          lb = fmaf(qcn[r * nc + c], cnorm[(size_t)s * nc + c], lb);
        m[j] = fmaxf(m[j], fminf(pb[i][j], lb));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) red[ty][tx + 8 * j] = m[j];
  __syncthreads();
  if (tid < GS && s0 + tid < ns) {
    float v = red[0][tid];
    for (int y = 1; y < 32; ++y) v = fmaxf(v, red[y][tid]);
    ub[(size_t)ti * ns + s0 + tid] = v;
  }
}

}  // namespace

// qa (Qp, d), qcn (Qp, nc), vmax (ns, d), cnorm (ns, nc) f32 row-major;
// bq >= 1 query rows per tile; ub (Qp/bq, ns) f32.  Returns
// cudaGetLastError() after the launch.
extern "C" int gate_ub_launch(const void* qa, const void* qcn,
                              const void* vmax, const void* cnorm, void* ub,
                              int Qp, int ns, int d, int nc, int bq,
                              void* stream) {
  if (bq < 1 || Qp <= 0 || Qp % bq || ns <= 0 || d <= 0 ||
      nc <= 0 || Qp / bq > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((ns + GS - 1) / GS, Qp / bq);
  const cudaStream_t st = (cudaStream_t)stream;
  const float *a = (const float*)qa, *c = (const float*)qcn;
  const float *v = (const float*)vmax, *n = (const float*)cnorm;
  if (bq <= 32)
    gate_ub_kernel<32><<<grid, GNT, 0, st>>>(a, c, v, n, (float*)ub, ns, d, nc, bq);
  else if (bq <= 64)
    gate_ub_kernel<64><<<grid, GNT, 0, st>>>(a, c, v, n, (float*)ub, ns, d, nc, bq);
  else
    gate_ub_kernel<128><<<grid, GNT, 0, st>>>(a, c, v, n, (float*)ub, ns, d, nc, bq);
  return (int)cudaGetLastError();
}
