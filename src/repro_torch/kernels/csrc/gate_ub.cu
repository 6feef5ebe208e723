// Strip-gate value bound, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/sssj_join/gate.py::_gate_ub_kernel,
// launched there by _tile_ub_pallas.  For query tile i (bq rows, any edge
// of 1 or more) and window strip s:
//   ub[i, s] = max over the tile's bq rows r of
//              min(|q_r| . vmax_s, chunk_norms(q_r) . cnorm_s)
// Every operand is nonnegative, so every bound is >= 0.
//
// What bounds it on an H100.  The prefix bound is an f32 matrix product,
// 2 * Qp * ns * d FLOP (541 MFLOP at the main path's Qp 128, 2,048 strips,
// d 1,024): 0.0081 ms on the CUDA cores at 67 TFLOP/s, 0.0033 ms as
// 3xTF32 on the tensor cores; its bytes (vmax, 8 MB, read once) take
// 0.0026 ms.  The output is small (Qp / bq x ns), so the product has few
// output tiles to spread over 132 SMs, and each block's share is short: a
// block's fixed costs and the bytes it must pull into its SM weigh as much
// as its products.  The PR 13 kernel gave each block 16 strips over all
// of d, so every block read the whole q block again (64 MB through L2, in
// scalar loads) and fed 8 FMAs with 6 shared-memory loads: 0.092 ms of
// device time on an H100 80GB HBM3 at 700 W (PERF.md, as every time here).
//
// Design: two kernels on one stream.
//   gate_ub_products: each product as 3xTF32 on wgmma (wgmma_tf32.cuh; the
//     slab helpers of the tile joins, tile_scores.cuh, with q as the A rows
//     and vmax as the B rows).  A block of two warpgroups takes 128 query
//     rows (64 each) against GS = 64 strips over one CK-th (a quarter) of
//     the features, streamed through a cp.async ring of 32-feature
//     sub-slabs, each split to hi and lo while the one before it is on the
//     tensor cores; so at the main path's shapes 128 blocks run, one an SM,
//     each pulling in 192 KB (25 MB in all).  The tensor cores truncate as
//     they accumulate, and this output is an upper bound, so each
//     sub-slab's products are summed from zero and added with IEEE adds.
//     Each block writes its partial sums to an f32 workspace (CK, Qp, ns).
//   gate_ub_reduce: one thread per (tile, strip) and row lane sums the CK
//     partials of its rows in a fixed order, forms the chunk-l2 bound from
//     qcn and cnorm (a few floats a row, from L1), takes the min and the
//     max over its rows; a block reduces its RL row lanes in shared memory.
// A first design split d across a cluster of four blocks that met through
// distributed shared memory, in one kernel: 0.032 ms, no faster than the
// plain version.
#include "tile_scores.cuh"

namespace {

using namespace sssj;

constexpr int GR = 128;        // query rows per products block: two warpgroups of 64
constexpr int GS = 64;         // strips per products block
constexpr int CK = 4;          // products blocks per (rows, strips) tile: d split CK ways
constexpr int GST = 8;         // sub-slabs in a products block's ring: GST - 1 in flight
constexpr int RS = 8;          // strips per reduce block
constexpr int RL = NT / RS;    // row lanes per reduce block
using T = Tile<GR, GS, false>;  // the products: 128 rows x 64 strips, 32 floats a thread

struct GateSmem {
  float ring[GST][T::STAGE];      // q rows | vmax strips, KS features each
  float wlo[2][GS * KS];          // the lo parts of two sub-slabs' vmax rows
};
constexpr size_t SMEM_BYTES = sizeof(GateSmem) + 1024;  // room to align the base

__global__ void __launch_bounds__(NT, 1) gate_ub_products(
    const float* __restrict__ qa, const float* __restrict__ vmax, float* __restrict__ ws,
    int Qp, int ns, int d) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  GateSmem& sm = *reinterpret_cast<GateSmem*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int kr = blockIdx.x % CK, s0 = (int)(blockIdx.x / CK) * GS;
  const int ns_in = min(GS, ns - s0);
  const size_t q0 = (size_t)blockIdx.y * GR;
  const int nr = (int)min((size_t)GR, (size_t)Qp - q0);
  // this block's share of the feature sub-slabs
  const int nsub = (d + KS - 1) / KS, per = (nsub + CK - 1) / CK;
  const int sb0 = kr * per, n = max(0, min(nsub, sb0 + per) - sb0);

  TileIn in{};
  in.q = qa;
  in.w = vmax;
  in.d = d;
  in.chunk_d = d;  // one chunk: load_slab masks the columns past d
  const bool vec = (d & 3) == 0 && (((uintptr_t)qa | (uintptr_t)vmax) & 15) == 0;
  const auto issue = [&](int i) {  // sub-slab i of this block's share, as one group
    if (i < n) load_slab<T>(in, sm.ring[i % GST], q0, nr, s0, ns_in, 0, sb0 + i, vec);
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < GST - 1; ++i) issue(i);

  Acc<T> acc, p;
#pragma unroll
  for (int e = 0; e < T::ACC; ++e) acc[e] = p[e] = 0.0f;
  cp_async_wait<GST - 2>();  // sub-slab 0 landed
  __syncthreads();
  if (n > 0) split_slab<T>(sm.ring[0], sm.wlo[0]);
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    slab_products<T>(sm.ring[i % GST], sm.wlo[i & 1], p, 0, [&] {
      // sub-slab i + GST - 1 into the slot of i - 1, whose products are
      // done; then i + 1, landed, split for the next products
      issue(i + GST - 1);
      cp_async_wait<GST - 2>();
      __syncthreads();
      if (i + 1 < n) split_slab<T>(sm.ring[(i + 1) % GST], sm.wlo[(i + 1) & 1]);
    });
#pragma unroll
    for (int e = 0; e < T::ACC; ++e) acc[e] = __fadd_rn(acc[e], p[e]);
    __syncthreads();  // the split of i + 1 is everyone's
  }
  cp_async_wait<0>();

  float* out = ws + (size_t)kr * Qp * ns;
#pragma unroll
  for (int e = 0; e < T::ACC; ++e) {
    const int i = erow<T>(e), j = ecol<T>(e);
    if (i < nr && j < ns_in) out[(q0 + i) * ns + s0 + j] = acc[e];
  }
}

__global__ void __launch_bounds__(NT) gate_ub_reduce(
    const float* __restrict__ ws, const float* __restrict__ qcn,
    const float* __restrict__ cnorm, float* __restrict__ ub, int Qp, int ns, int nc, int bq) {
  __shared__ float red[RL][RS + 1];
  const int c = threadIdx.x % RS, lane = threadIdx.x / RS;
  const int s = blockIdx.x * RS + c;
  const size_t tile = blockIdx.y;
  float m = -INFINITY;
  if (s < ns)
#pragma unroll 4
    for (int r = lane; r < bq; r += RL) {
      const size_t row = tile * bq + r;
      float pb = 0.0f, lb = 0.0f;
#pragma unroll
      for (int k = 0; k < CK; ++k) pb = __fadd_rn(pb, ws[((size_t)k * Qp + row) * ns + s]);
      for (int cc = 0; cc < nc; ++cc)
        lb = fmaf(__ldg(qcn + row * nc + cc), __ldg(cnorm + (size_t)s * nc + cc), lb);
      m = fmaxf(m, fminf(pb, lb));
    }
  red[lane][c] = m;
  __syncthreads();
  if (lane == 0 && s < ns) {
#pragma unroll
    for (int x = 1; x < RL; ++x) m = fmaxf(m, red[x][c]);
    ub[tile * ns + s] = m;
  }
}

}  // namespace

// qa (Qp, d), qcn (Qp, nc), vmax (ns, d), cnorm (ns, nc) f32 row-major;
// bq >= 1 query rows per tile; ws an f32 workspace of split x Qp x ns,
// split == CK (gate.py's gate_workspace), overwritten; ub (Qp/bq, ns) f32,
// every entry written.  Returns the first CUDA error of the two launches.
extern "C" int gate_ub_launch(const void* qa, const void* qcn,
                              const void* vmax, const void* cnorm, void* ws, void* ub,
                              int Qp, int ns, int d, int nc, int bq, int split, void* stream) {
  if (split != CK || bq < 1 || Qp <= 0 || Qp % bq || ns <= 0 || d <= 0 || nc <= 0 ||
      (Qp + GR - 1) / GR > 65535 || Qp / bq > 65535)
    return (int)cudaErrorInvalidValue;
  const int err = allow_smem(gate_ub_products, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = (cudaStream_t)stream;
  gate_ub_products<<<dim3((ns + GS - 1) / GS * CK, (Qp + GR - 1) / GR), NT, SMEM_BYTES, st>>>(
      (const float*)qa, (const float*)vmax, (float*)ws, Qp, ns, d);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  gate_ub_reduce<<<dim3((ns + RS - 1) / RS, Qp / bq), NT, 0, st>>>(
      (const float*)ws, (const float*)qcn, (const float*)cnorm, (float*)ub, Qp, ns, nc, bq);
  return (int)cudaGetLastError();
}
