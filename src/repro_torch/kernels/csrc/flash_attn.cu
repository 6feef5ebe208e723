// Causal GQA flash attention, forward, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::_kernel
// (launched there by flash_attention_kernel_call, pallas_call at :118).
// q (B, H, Sq, Dqk), k (B, Hkv, Sk, Dqk), v (B, Hkv, Sk, DH), f32 or bf16,
// row-major; query head h reads kv head h / (H / Hkv).  The output is
// (B, H, Sq, DH) in the inputs' dtype.  For each query row, over kv tiles
// in ascending order:
//   s = (q * scale) . k^T            (masked to -1e30 where col > row when
//                                     causal, and past Sk)
//   m' = max(m, rowmax s), a = exp(m - m'), p = exp(s - m')
//   l = l a + rowsum p, acc = acc a + p . v, m = m'
// then out = acc / l, with l == 0 taken as 1.  The running max starts at
// -1e30, as the reference's does, so exp(m - m') is never NaN; kv tile 0
// holds column 0 <= row, so every row's max is finite from the first tile
// on.  Query tiles run in reverse order, so the longest causal rows start
// first; kv tiles wholly in the causal future of a query tile are not
// visited.  The kv loop runs inside the block (the TPU's sequential
// innermost grid axis) and carries m, l and acc in registers.
//
// Head dims.  Each kernel is compiled for the width DH of v and the output
// (bf16: 32, 64, 128, 256; f32: 32, 64, 128 on the tensor cores, 256 on
// the CUDA cores), with q and k of the same width (Dqk == DH) staged
// whole.  A larger head dim runs as column slices of the output, one launch
// each (the wrapper slices v and out, 128 columns a launch): the SLABS
// instances (bf16, and f32 on the CUDA cores) take q and k of any width
// Dqk that is a multiple of DH and form q . k^T over Dqk one DH-wide slab
// at a time, so each launch recomputes the same s, the same softmax
// statistics, and its own columns of p . v.
//
// What bounds it on an H100: the multiply-adds of q.k^T and p.v, 2 * B * H
// * Sq * Sk * Dh FLOP over the causal half (68.7 GFLOP at B 1, H 16,
// S 4096, Dh 128).  The bytes of q, k, v and o (50 MB in bf16, 0.015 ms at
// 3.35 TB/s) are below that.  Three kernels, picked by the route the
// wrapper passes (kernel.py's kernel_route):
//
// f32 at head dims 32, 64 and 128 (flash_tf32_kernel): each product as
// 3xTF32 on the tensor cores (wgmma_tf32.cuh), three TF32 products per
// multiply-add: 0.416 ms at 495 TFLOP/s at the shape above, against 1.026
// ms for the same work in f32 FMAs on the CUDA cores at 67 TFLOP/s (the
// H100's published peaks).  Two warpgroups own 64 query rows each and
// share kv tiles of BN = 64:
//   s = q . k^T    wgmma m64n64k8, A = q from registers (split as each
//                  thread loads its fragments from the staged, scaled q
//                  tile, one atom of 32 columns while the last is on the
//                  tensor cores), B = the k tile's hi and lo parts;
//   pv = p . v     wgmma m64nDHk8, A = p from registers, B = v^T's hi and
//                  lo parts.  .tf32 takes both operands K-major only, so v
//                  is used transposed; a thread's accumulator holds
//                  columns 2 t, 2 t + 1 of each 8 where the A fragment
//                  wants t, t + 4, so v's kv rows are permuted the same
//                  way within each 8, and p goes to the tensor cores as it
//                  lies in registers.
// k and v are split once per call, not once per query block: a first
// kernel (flash_tf32_split_kv) writes their hi and lo parts, v's
// transposed and permuted, into a workspace tile by tile in the layout of
// shared memory, and the attention kernel fetches each part of a tile
// with one bulk copy (cp.async.bulk, completing on an mbarrier) started by
// one thread, so no thread stalls on the copy and the next tile's k
// arrives during this tile's softmax and p . v.  The tensor cores truncate
// as they accumulate, so s is summed from zero per 32 columns of the head
// dim and pv from zero per kv tile, each added in IEEE f32 (acc = acc
// alpha + pv).  At Dh 128 the q tile takes 64 KB and the k and v^T tiles'
// two parts 128 KB of shared memory, one block of two warpgroups an SM.
// What bounds it now: the two warpgroups run their products, softmax and
// barriers in step, so the tensor cores idle while both run the softmax;
// overlapping one warpgroup's softmax with the other's products is the
// next step (PERF.md).  A warpgroup skips the kv tiles wholly in its
// rows' causal future.  Designs on the way, at the shape above on an
// H100 80GB HBM3 at 700 W (PERF.md): 1.37 ms (one warpgroup a block, kv
// tiles of 32, k and v split in every block), 1.27 (q split once into
// shared memory and read from there by every product), 0.99 (k and v
// split once, kv tiles of 32).
//
// f32 at head dim 256 and the column slices of wider heads
// (flash_f32_kernel, not redesigned: at Dh 256 the 3xTF32 kernel's q tile
// and split k and v^T tiles would take 384 KB of shared memory): the CUDA
// cores' 67 TFLOP/s.  256 threads each own 4 query rows x 4 kv columns of
// s and 4 rows x Dh/16 columns of acc in registers, so every shared-memory
// float4 feeds 4 (s) or 8-16 (acc) FMAs; the q tile, the k tile and the v
// tile live in dynamic shared memory with a 4-float row pad
// (conflict-free float4 reads), and p^T reuses the k tile's space.  q is
// scaled as it is staged, as the TPU kernel scales it before the product;
// the 3xTF32 kernel scales the staged tile once.
//
// bf16 (flash_bf16_kernel): the 989 TFLOP/s of the bf16 tensor cores
// (0.069 ms at the shape above), which only Hopper's warpgroup products
// (wgmma) reach.  One warpgroup (4 warps) owns a 64-row query tile, the
// 64 rows of one wgmma, against kv tiles of 64:
//   s = q . k^T    wgmma m64n64k16, q and k from shared memory (K-major);
//   acc += p . v   wgmma m64nDHk16, p from registers (the accumulator
//                  layout of s is the A-operand layout of p), v from
//                  shared memory (MN-major, so no transpose is staged).
// The tiles sit in shared memory in the layout the wgmma descriptors
// name: 128-byte-wide atoms (64 for Dh 32) whose 16-byte chunks are
// XOR-swizzled by row, which cp.async writes directly, so the tensor
// cores read them without bank conflicts; the k and v tiles are
// double-buffered, so the next tile's copy overlaps this tile's products
// (rows past Sq or Sk are zero-filled by the copy).  At Dh 128 a block
// takes 81 KB of shared memory and about 190 registers a thread, so two
// blocks share an SM.  The arithmetic stays at f32 accuracy, as the TPU
// kernel's f32 arithmetic is: the bf16 products q . k^T are exact and
// summed in f32, and s is scaled after the product (by scale * log2 e,
// so p = exp2(s' - m'), the same softmax); p stays f32 for l, and p . v
// takes p as p_hi = bf16(p) plus p_lo = bf16(p - p_hi), two products
// against the same v tile, 16 significant bits where a plain bf16 p keeps
// 8.  So the tensor cores do 1.5 times the work of plain bf16 attention.
// The output is rounded once to bf16.  A first design on mma.sync
// (m16n8k16, ldmatrix fragments) with the same arithmetic took 1.4 times
// as long at Dh 128 (PERF.md).  Not done yet: TMA copies and
// producer/consumer warp specialization, which would overlap the softmax
// of one tile with the products of the next.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma_tf32.cuh"

namespace {

constexpr float NEG = -1e30f;   // the reference's masked score and initial max

// ------------------------------------------------------------------ f32
namespace f32 {

constexpr int BM = 64;          // query rows per block
constexpr int BN = 64;          // kv rows per tile
constexpr int NT = 256;         // threads: 16 x 16

template <int DH>
struct Geo {
  static constexpr int LD = DH + 4;    // row stride of the q, k, v tiles (floats)
  static constexpr int LDP = BM + 4;   // row stride of p^T
  static constexpr int CD = DH / 16;   // output columns per thread
  static constexpr int VW = 4;         // in runs of VW adjacent ones
  static_assert(CD % VW == 0, "the instances: Dh 256, and 128 in column slices");
  static constexpr int KREGION = BN * LD > BN * LDP ? BN * LD : BN * LDP;
  static constexpr int SMEM = (BM * LD + KREGION + BN * LD) * 4;  // bytes
};

// rows [r0, r0 + ROWS) x columns [c0, c0 + DH) of a (len, ld) matrix into
// dst [ROWS][LD], times scale when scaled; rows at or past len are zeros.
// Every load is issued before the first store, so all of a thread's are
// in flight.
template <int ROWS, int DH>
__device__ __forceinline__ void stage(float* dst, const float* src, int r0, int len,
                                      int ld, int c0, bool scaled, float scale) {
  constexpr int C4 = DH / 4, PER = ROWS * C4 / NT;
  static_assert(PER * NT == ROWS * C4, "whole float4 runs per thread");
  float4 x[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = threadIdx.x + u * NT, r = e / C4, c = (e % C4) * 4;
    x[u] = r0 + r < len
               ? __ldg(reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * ld + c0 + c))
               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = threadIdx.x + u * NT, r = e / C4, c = (e % C4) * 4;
    if (scaled) {
      x[u].x = __fmul_rn(x[u].x, scale); x[u].y = __fmul_rn(x[u].y, scale);
      x[u].z = __fmul_rn(x[u].z, scale); x[u].w = __fmul_rn(x[u].w, scale);
    }
    *reinterpret_cast<float4*>(dst + r * Geo<DH>::LD + c) = x[u];
  }
}

// s += the thread's 4 x 4 block of qs . ks^T over DH columns
template <int DH>
__device__ __forceinline__ void qk(const float* qs, const float* ks, int ty, int tx,
                                   float (&s)[4][4]) {
  constexpr int LD = Geo<DH>::LD;
#pragma unroll 4
  for (int kk = 0; kk < DH; kk += 4) {
    float4 a[4], w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(qs + (ty * 4 + i) * LD + kk);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * LD + kk);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i].x, w[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, w[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, w[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, w[j].w, s[i][j]);
      }
  }
}

template <int DH, bool SLABS>
__global__ void __launch_bounds__(NT, DH <= 128 ? 2 : 1) flash_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, int H, int Hkv, int Sq, int Sk, int dqk, int causal,
    float scale) {
  using G = Geo<DH>;
  constexpr int CD = G::CD, VW = G::VW, LD = G::LD, LDP = G::LDP;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;               // [BM][LD]: q * scale (a DH-wide slab of it)
  float* ks = qs + BM * LD;       // [BN][LD]: the k tile; then [BN][LDP]: p^T
  float* vs = ks + G::KREGION;    // [BN][LD]: the v tile

  const int iq = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hkv);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int r0 = iq * BM;
  const int ldqk = SLABS ? dqk : DH;
  const float* qh = q + ((size_t)b * H + h) * Sq * ldqk;
  const float* kh = k + ((size_t)b * Hkv + hk) * Sk * ldqk;
  const float* vh = v + ((size_t)b * Hkv + hk) * Sk * DH;
  float* oh = o + ((size_t)b * H + h) * Sq * DH;

  if constexpr (!SLABS) stage<BM, DH>(qs, qh, r0, Sq, DH, 0, true, scale);

  // thread (ty, tx) owns query rows ty*4 + i, kv columns tx + 16 j of s,
  // and output columns g*16*VW + tx*VW + e of acc
  float m[4], l[4], acc[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.0f;
  }

  const int n_kv = (Sk + BN - 1) / BN;
  const int n_run = causal ? min(n_kv, (r0 + BM - 1) / BN + 1) : n_kv;
  for (int t = 0; t < n_run; ++t) {
    const int c0 = t * BN;
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    if constexpr (!SLABS) {
      __syncthreads();  // the previous tile's p^T and v are read
      stage<BN, DH>(ks, kh, c0, Sk, DH, 0, false, 1.0f);
      stage<BN, DH>(vs, vh, c0, Sk, DH, 0, false, 1.0f);
      __syncthreads();
      qk<DH>(qs, ks, ty, tx, s);
    } else {
      // q . k^T one DH-wide slab at a time, in the same order of summation
      for (int j0 = 0; j0 < dqk; j0 += DH) {
        __syncthreads();  // the previous slab, or tile's p^T and v, are read
        stage<BM, DH>(qs, qh, r0, Sq, dqk, j0, true, scale);
        stage<BN, DH>(ks, kh, c0, Sk, dqk, j0, false, 1.0f);
        if (j0 + DH >= dqk) stage<BN, DH>(vs, vh, c0, Sk, DH, 0, false, 1.0f);
        __syncthreads();
        qk<DH>(qs, ks, ty, tx, s);
      }
    }

    // masks, then the online softmax: a row's 64 columns lie with the 16
    // threads tx of one half warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + ty * 4 + i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx + 16 * j;
        if (col >= Sk || (causal && col > row)) s[i][j] = NEG;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_cur = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_cur);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_cur);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= alpha;
      m[i] = m_cur;
    }

    __syncthreads();  // every thread is done with the k tile
    float* ps = ks;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(ps + (tx + 16 * j) * LDP + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int kv = 0; kv < BN; ++kv) {
      const float4 p = *reinterpret_cast<const float4*>(ps + kv * LDP + ty * 4);
      float vv[CD];
#pragma unroll
      for (int g = 0; g < CD / VW; ++g) {
        const float4 x = *reinterpret_cast<const float4*>(vs + kv * LD + g * 16 * VW + tx * VW);
        vv[g * 4] = x.x; vv[g * 4 + 1] = x.y; vv[g * 4 + 2] = x.z; vv[g * 4 + 3] = x.w;
      }
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        acc[0][c] = fmaf(p.x, vv[c], acc[0][c]);
        acc[1][c] = fmaf(p.y, vv[c], acc[1][c]);
        acc[2][c] = fmaf(p.z, vv[c], acc[2][c]);
        acc[3][c] = fmaf(p.w, vv[c], acc[3][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float li = l[i] == 0.0f ? 1.0f : l[i];
    float* dst = oh + (size_t)row * DH;
#pragma unroll
    for (int c = 0; c < CD; ++c) dst[(c / VW) * 16 * VW + tx * VW + c % VW] = acc[i][c] / li;
  }
}

}  // namespace f32

// ------------------------------------------------- f32 on the tensor cores
namespace x3 {

namespace t3 = tf32x3;
constexpr int BM = 128;         // query rows per block: two warpgroups of 64
constexpr int BN = 64;          // kv rows per tile
constexpr int NT = 256;         // warp w owns rows 16 w .. 16 w + 15; warpgroup w / 4
constexpr int AT = t3::ATOM;    // columns of a swizzle atom

// The block's shared memory, each region 1,024-byte aligned: the q tile,
// scaled, DH / AT atoms of [BM][AT]; the k tile's hi and lo parts, DH / AT
// atoms of [BN][AT] each; v^T's hi and lo parts, BN / AT atoms of [DH][AT]
// each.  A k or v^T part of a tile (KF floats) lies in the workspace as it
// lies here, so one bulk copy moves it.
template <int DH>
struct Geo {
  static constexpr int NA = DH / AT;     // atoms across the head dim
  static constexpr int QF = BM * DH;     // floats of the q tile
  static constexpr int KF = BN * DH;     // floats of one part of a k or v^T tile
  static constexpr int SMEM = (QF + 4 * KF) * 4 + 1024;   // 1 KB to align
  static_assert(DH % AT == 0 && BN % AT == 0, "whole atoms");
};

// float index of (row r, column c) of a tile of ROWS rows stored as atoms
// of AT columns
template <int ROWS>
__device__ __forceinline__ int at(int r, int c) {
  return (c / AT) * ROWS * AT + t3::swz(r, c % AT);
}

// k and v of one (batch, kv head) split once for every query block that
// reads them, into the workspace tile by tile in the layout the tensor
// cores read: k's hi and lo parts as atoms of [BN][AT]; v's transposed,
// atoms of [DH][AT], its kv rows permuted within each 8 (row 2 i to
// column i, row 2 i + 1 to column i + 4: the columns a thread's A
// fragment holds where its accumulator holds columns 2 t, 2 t + 1); kv
// rows from Sk on zero.  A block takes one kv tile, through shared memory
// for the transpose; every access is of 4 floats, which the swizzle keeps
// together.
template <int DH>
__global__ void __launch_bounds__(NT) flash_tf32_split_kv(
    const float* __restrict__ k, const float* __restrict__ v, float* __restrict__ khi,
    float* __restrict__ klo, float* __restrict__ vthi, float* __restrict__ vtlo, int Sk) {
  constexpr int KF = Geo<DH>::KF;
  __shared__ float tile[BN][DH + 1];
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const size_t out = (bh * gridDim.x + blockIdx.x) * KF;   // this tile's parts
  const int j0 = blockIdx.x * BN;
  const auto split4 = [](float4 x, float* hi, float* lo) {
    uint32_t h[4], l[4];
    t3::split_tf32(x.x, h[0], l[0]);
    t3::split_tf32(x.y, h[1], l[1]);
    t3::split_tf32(x.z, h[2], l[2]);
    t3::split_tf32(x.w, h[3], l[3]);
    *reinterpret_cast<uint4*>(hi) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo) = make_uint4(l[0], l[1], l[2], l[3]);
  };
  for (int e = threadIdx.x; e < BN * DH / 4; e += NT) {
    const int r = e / (DH / 4), c = (e % (DH / 4)) * 4, j = j0 + r;
    const size_t src = (bh * Sk + j) * DH + c;
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float4 x = j < Sk ? *reinterpret_cast<const float4*>(k + src) : zero;
    const float4 y = j < Sk ? *reinterpret_cast<const float4*>(v + src) : zero;
    split4(x, khi + out + at<BN>(r, c), klo + out + at<BN>(r, c));
    tile[r][c] = y.x;
    tile[r][c + 1] = y.y;
    tile[r][c + 2] = y.z;
    tile[r][c + 3] = y.w;
  }
  __syncthreads();
  // columns sc .. sc + 3 of v^T's row d: kv rows 2 i, or 2 i + 1, of their 8
  for (int e = threadIdx.x; e < DH * BN / 4; e += NT) {
    const int d = e / (BN / 4), sc = (e % (BN / 4)) * 4;
    const int r0 = (sc & ~7) + ((sc & 4) >> 2);
    const float4 x = make_float4(tile[r0][d], tile[r0 + 2][d], tile[r0 + 4][d], tile[r0 + 6][d]);
    const int o = (sc / AT) * DH * AT + t3::swz(d, sc % AT);
    split4(x, vthi + out + o, vtlo + out + o);
  }
}

// mbarriers for the bulk copies: one thread arms a barrier with the bytes
// to come and starts the copies; every thread waits for the phase
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(t3::smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(t3::smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(t3::smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// bytes (a multiple of 16) from global to shared memory by the bulk-copy
// engine, completing on bar
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(t3::smem_u32(dst)), "l"(src), "r"(bytes), "r"(t3::smem_u32(bar))
      : "memory");
}

// The thread's A fragments of q for the AT columns of atom a: per 8-column
// step, rows g, g + 8, g, g + 8 and columns t, t, t + 4, t + 4 of its
// warp's rows, split into hi and lo
__device__ __forceinline__ void q_frags(const float* qs, int a, int wrow,
                                        uint32_t (&ah)[AT / 8][4], uint32_t (&al)[AT / 8][4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* atom = qs + a * BM * AT;
#pragma unroll
  for (int kk = 0; kk < AT / 8; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      t3::split_tf32(atom[t3::swz(wrow + g + (x & 1) * 8, kk * 8 + (x >> 1) * 4 + t)],
                     ah[kk][x], al[kk][x]);
}

template <int DH>
__global__ void __launch_bounds__(NT, 1) flash_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ khi_g,
    const float* __restrict__ klo_g, const float* __restrict__ vthi_g,
    const float* __restrict__ vtlo_g, float* __restrict__ o, int H, int Hkv, int Sq, int Sk,
    int causal, float scale) {
  using G = Geo<DH>;
  constexpr uint32_t PART = G::KF * 4;   // bytes of a part of a tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ uint64_t bars[2];           // k's copies, v^T's copies
  float* qs =
      reinterpret_cast<float*>(smem_raw + ((1024 - (t3::smem_u32(smem_raw) & 1023)) & 1023));
  float* khi = qs + G::QF;
  float* klo = khi + G::KF;
  float* vhi = klo + G::KF;
  float* vlo = vhi + G::KF;
  const uint32_t khi_a = t3::smem_u32(khi), klo_a = t3::smem_u32(klo);
  const uint32_t vhi_a = t3::smem_u32(vhi), vlo_a = t3::smem_u32(vlo);

  const int iq = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hkv);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wg = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = iq * BM, wrow = warp * 16, wr0 = r0 + wrow;
  const int n_kv = (Sk + BN - 1) / BN;
  const size_t tiles = ((size_t)b * Hkv + hk) * n_kv * G::KF;   // this kv head's tiles
  const float* qh = q + ((size_t)b * H + h) * Sq * DH;
  float* oh = o + ((size_t)b * H + h) * Sq * DH;

  const int n_run = causal ? min(n_kv, (r0 + BM - 1) / BN + 1) : n_kv;
  // the warpgroup's last tile: later ones lie wholly in its rows' causal future
  const int wg_run = causal ? min(n_run, (r0 + wg * 64 + 63) / BN + 1) : n_run;
  const auto copy_k = [&](int t) {
    bar_expect(&bars[0], 2 * PART);
    bulk_copy(khi, khi_g + tiles + (size_t)t * G::KF, PART, &bars[0]);
    bulk_copy(klo, klo_g + tiles + (size_t)t * G::KF, PART, &bars[0]);
  };
  const auto copy_v = [&](int t) {
    bar_expect(&bars[1], 2 * PART);
    bulk_copy(vhi, vthi_g + tiles + (size_t)t * G::KF, PART, &bars[1]);
    bulk_copy(vlo, vtlo_g + tiles + (size_t)t * G::KF, PART, &bars[1]);
  };
  if (threadIdx.x == 0) {
    bar_init(&bars[0]);
    bar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    copy_k(0);
    copy_v(0);
  }
  // q rows r0.. by cp.async, then scaled once
  {
    constexpr int C4 = DH / 4, PER = BM * C4 / NT;
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int e = threadIdx.x + u * NT, r = e / C4, c = (e % C4) * 4;
      const bool ok = r0 + r < Sq;
      t3::cp_async16(qs + at<BM>(r, c), ok ? qh + (size_t)(r0 + r) * DH + c : qh, ok ? 16 : 0);
    }
    t3::cp_async_commit();
    t3::cp_async_wait<0>();
    __syncthreads();
    for (int i = threadIdx.x; i < G::QF; i += NT) qs[i] = __fmul_rn(qs[i], scale);
    __syncthreads();
  }

  // thread (g, t4) of warp w holds rows wr0 + g and wr0 + g + 8; of s,
  // entry e is row g + 8 ((e >> 1) & 1), column 8 (e >> 2) + 2 t4 + (e & 1)
  // of the kv tile; of acc likewise over the output columns
  float m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f};
  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.0f;

  for (int it = 0; it < n_run; ++it) {
    const int c0 = it * BN;
    const bool run = it < wg_run;
    float s[BN / 2], alpha[2];
    if (run) {
      // s = q . k^T, 3xTF32 one atom (32 columns of the head dim) at a
      // time, each atom's products summed from zero (sp) and added to s
      // with IEEE adds; the next atom's fragments are split while this
      // atom's are on the tensor cores
      float sp[BN / 2];
      uint32_t ah[2][AT / 8][4], al[2][AT / 8][4];
      q_frags(qs, 0, wrow, ah[0], al[0]);
      bar_wait(&bars[0], it & 1);
#pragma unroll
      for (int a = 0; a < G::NA; ++a) {
        const int st = a & 1;
        t3::reg_fence(sp);
        t3::wg_fence();
#pragma unroll
        for (int kk = 0; kk < AT / 8; ++kk) {
          const uint32_t off = a * BN * AT * 4 + kk * 32;
          t3::wgmma_tf32<BN>(sp, al[st][kk], t3::desc128(khi_a + off), kk);
          t3::wgmma_tf32<BN>(sp, ah[st][kk], t3::desc128(klo_a + off), 1);
          t3::wgmma_tf32<BN>(sp, ah[st][kk], t3::desc128(khi_a + off), 1);
        }
        t3::wg_commit();
        if (a + 1 < G::NA) q_frags(qs, a + 1, wrow, ah[st ^ 1], al[st ^ 1]);
        t3::wg_wait();
#pragma unroll
        for (int kk = 0; kk < AT / 8; ++kk)  // the fragments stay put until the products read them
#pragma unroll
          for (int x = 0; x < 4; ++x) asm volatile("" ::"r"(ah[st][kk][x]), "r"(al[st][kk][x]));
        t3::reg_fence(sp);
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) s[e] = a == 0 ? sp[e] : __fadd_rn(s[e], sp[e]);
      }
    }
    __syncthreads();   // every warp's products are done with the k tile
    if (threadIdx.x == 0 && it + 1 < n_run) copy_k(it + 1);

    if (run) {
      // mask, and the online softmax; a row's columns lie with the 4
      // threads t4 of one quad
      const bool masked = c0 + BN > Sk || (causal && c0 + BN - 1 > wr0);
      float mx[2] = {NEG, NEG};
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) {
        if (masked) {
          const int col = c0 + (e >> 2) * 8 + 2 * t4 + (e & 1), row = wr0 + g + ((e >> 1) & 1) * 8;
          if (col >= Sk || (causal && col > row)) s[e] = NEG;
        }
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_cur = fmaxf(m[r], mx[r]);
        alpha[r] = expf(m[r] - m_cur);
        m[r] = m_cur;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) {
        s[e] = expf(s[e] - m[(e >> 1) & 1]);
        l[(e >> 1) & 1] += s[e];
      }

      // pv = p . v from zero, 3xTF32: p's A fragment for kv step kk is
      // entries 4 kk + {0, 2, 1, 3} of s (columns 2 t4, 2 t4 + 1 of rows
      // g, g + 8), which v^T's permuted columns t4, t4 + 4 match; then acc
      // = acc alpha + pv in IEEE f32
      uint32_t ph[BN / 8][4], pl[BN / 8][4];
#pragma unroll
      for (int kk = 0; kk < BN / 8; ++kk) {
        t3::split_tf32(s[4 * kk], ph[kk][0], pl[kk][0]);
        t3::split_tf32(s[4 * kk + 2], ph[kk][1], pl[kk][1]);
        t3::split_tf32(s[4 * kk + 1], ph[kk][2], pl[kk][2]);
        t3::split_tf32(s[4 * kk + 3], ph[kk][3], pl[kk][3]);
      }
      float pv[DH / 2];
      bar_wait(&bars[1], it & 1);
      t3::reg_fence(pv);
      t3::wg_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 8; ++kk) {
        const uint32_t off = (kk / 4) * DH * AT * 4 + (kk % 4) * 32;
        t3::wgmma_tf32<DH>(pv, pl[kk], t3::desc128(vhi_a + off), kk);
        t3::wgmma_tf32<DH>(pv, ph[kk], t3::desc128(vlo_a + off), 1);
        t3::wgmma_tf32<DH>(pv, ph[kk], t3::desc128(vhi_a + off), 1);
      }
      t3::wg_commit();
      t3::wg_wait();
#pragma unroll
      for (int kk = 0; kk < BN / 8; ++kk)  // the fragments stay put until the products read them
#pragma unroll
        for (int x = 0; x < 4; ++x) asm volatile("" ::"r"(ph[kk][x]), "r"(pl[kk][x]));
      t3::reg_fence(pv);
#pragma unroll
      for (int e = 0; e < DH / 2; ++e) acc[e] = fmaf(acc[e], alpha[(e >> 1) & 1], pv[e]);
    }
    __syncthreads();   // every warp's products are done with the v^T tile
    if (threadIdx.x == 0 && it + 1 < n_run) copy_v(it + 1);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = wr0 + g + 8 * r;
    if (row >= Sq) continue;
    const float li = l[r] == 0.0f ? 1.0f : l[r];
    float* dst = oh + (size_t)row * DH + 2 * t4;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<float2*>(dst + n * 8) =
          make_float2(acc[4 * n + 2 * r] / li, acc[4 * n + 2 * r + 1] / li);
  }
}

}  // namespace x3

// ----------------------------------------------------------------- bf16
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int BM = 64;          // query rows per block: the 64 rows of one wgmma
constexpr int BN = 64;          // kv rows per tile
constexpr int NT = 128;         // one warpgroup; warp w owns rows 16 w .. 16 w + 15
constexpr float LOG2E = 1.4426950408889634f;

// A [ROWS][DH] bf16 tile in shared memory, as wgmma reads it: DH / AC
// atoms of AC columns side by side, each ROWS rows of SW bytes (SW =
// 2 AC, 128 or 64), the 16-byte chunks of row r XOR-swizzled by bits
// 7.. of r * SW (the hardware's 128- or 64-byte swizzle)
template <int DH>
struct Geo {
  static constexpr int SW = DH * 2 < 128 ? DH * 2 : 128;   // bytes of an atom's row
  static constexpr int AC = SW / 2;                          // columns of an atom
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : 2;      // the descriptor's swizzle mode
  static constexpr int QB = BM * DH * 2;                     // bytes of the q tile
  static constexpr int KVB = BN * DH * 2;                    // bytes of one k or v tile
  static constexpr int SMEM = QB + 4 * KVB + 1024;           // q, two k, two v; 1 KB to align
  static_assert(DH % 32 == 0, "head dims of whole 64-byte rows");
};

template <int ROWS, int DH>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  using G = Geo<DH>;
  const int chunk = (c % G::AC) / 8, phase = (r * G::SW >> 7) & (G::SW / 16 - 1);
  return (uint32_t)((c / G::AC) * ROWS * G::SW + r * G::SW + ((chunk ^ phase) << 4) + (c % 8) * 2);
}

// a shared-memory matrix descriptor: start address, leading and stride
// byte offsets, swizzle mode
template <int DH>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | (Geo<DH>::LAYOUT << 62);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory, asynchronously; zeros when !valid
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// this thread's copies have landed and are visible to the tensor cores'
// (async-proxy) reads; a barrier then makes every thread's so
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\nfence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\nwgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from touching accumulators while a wgmma owns them
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, f32) += a (64 x 16, smem, K-major) . b (16 x 64, smem, K-major)
__device__ __forceinline__ void wgmma_ss_64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 32, f32) += a (64 x 16, registers) . b (16 x 32, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, f32) += a (64 x 16, registers) . b (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, f32) += a (64 x 16, registers) . b (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256, f32) += a (64 x 16, registers) . b (16 x 256, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_256(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x DH) += a (64 x 16, registers) . b (16 x DH, smem, MN-major)
template <int DH>
__device__ __forceinline__ void wgmma_rs(float (&d)[DH / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (DH == 32) wgmma_rs_32(d, a, b);
  else if constexpr (DH == 64) wgmma_rs_64(d, a, b);
  else if constexpr (DH == 128) wgmma_rs_128(d, a, b);
  else wgmma_rs_256(d, a, b);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) as a bf16 pair hi and the pair lo of what hi leaves out
// (x - hi is exact in f32): hi + lo holds x to 16 significant bits
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// rows [r0, r0 + ROWS) x columns [c0, c0 + DH) of a (len, ld) bf16 matrix
// into the swizzled tile at dst by cp.async; rows at or past len are
// zero-filled
template <int ROWS, int DH>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, int r0, int len,
                                          int ld, int c0) {
  constexpr int CH = DH / 8, PER = ROWS * CH / NT;   // 16-byte chunks
  static_assert(PER * NT == ROWS * CH, "whole chunks per thread");
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = threadIdx.x + u * NT, r = e / CH, c = (e % CH) * 8;
    const bool valid = r0 + r < len;
    cp16(dst + swz<ROWS, DH>(r, c), src + (size_t)(valid ? r0 + r : 0) * ld + c0 + c, valid);
  }
}

// s (64 x 64, f32) += the q tile . the k tile^T over DH columns: both
// K-major (columns contiguous), 16 columns a wgmma
template <int DH>
__device__ __forceinline__ void qk(uint32_t qs, uint32_t kt, float (&s)[32]) {
  using G = Geo<DH>;
#pragma unroll
  for (int kk = 0; kk < DH; kk += 16) {
    const uint32_t off = (kk % G::AC) * 2;
    wgmma_ss_64(s, desc<DH>(qs + (kk / G::AC) * BM * G::SW + off, 16, 8 * G::SW),
                desc<DH>(kt + (kk / G::AC) * BN * G::SW + off, 16, 8 * G::SW));
  }
}

template <int DH, bool SLABS>
__global__ void __launch_bounds__(NT, DH <= 128 ? 2 : 1) flash_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, int H, int Hkv, int Sq, int Sk, int dqk, int causal,
    float scale_log2) {
  using G = Geo<DH>;
  constexpr int NO = DH / 8;   // output column groups of 8
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle is of address bits, so the tiles start 1024-byte aligned
  const uint32_t qs = (smem_u32(smem_raw) + 1023u) & ~1023u;   // [BM][DH]
  const uint32_t ks = qs + G::QB;                               // two [BN][DH] stages
  const uint32_t vs = ks + 2 * G::KVB;                          // two [BN][DH] stages

  const int iq = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hkv);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = iq * BM, wr0 = r0 + warp * 16;   // the block's and the warp's first row
  const int ldqk = SLABS ? dqk : DH;
  const bf16* qh = q + ((size_t)b * H + h) * Sq * ldqk;
  const bf16* kh = k + ((size_t)b * Hkv + hk) * Sk * ldqk;
  const bf16* vh = v + ((size_t)b * Hkv + hk) * Sk * DH;
  bf16* oh = o + ((size_t)b * H + h) * Sq * DH;

  // thread (g, t4) of warp w holds rows wr0 + g (i = 0) and wr0 + g + 8
  // (i = 1); of s, element 4n + e is row i = e / 2, column c0 + 8n + 2 t4
  // + e % 2; of acc likewise over the output columns
  float m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f};   // m in units of s * log2 e
  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.0f;

  const int n_kv = (Sk + BN - 1) / BN;
  const int n_run = causal ? min(n_kv, (r0 + BM - 1) / BN + 1) : n_kv;
  if constexpr (!SLABS) {
    load_tile<BM, DH>(qs, qh, r0, Sq, DH, 0);
    load_tile<BN, DH>(ks, kh, 0, Sk, DH, 0);
    load_tile<BN, DH>(vs, vh, 0, Sk, DH, 0);
    cp_commit();
  }
  for (int t = 0; t < n_run; ++t) {
    const int c0 = t * BN;
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    uint32_t vt = vs;
    if constexpr (!SLABS) {
      cp_wait_all();
      __syncthreads();   // tile t has landed for all; tile t - 1 is read by all
      if (t + 1 < n_run) {
        const uint32_t nx = ((t + 1) & 1) * G::KVB;
        load_tile<BN, DH>(ks + nx, kh, c0 + BN, Sk, DH, 0);
        load_tile<BN, DH>(vs + nx, vh, c0 + BN, Sk, DH, 0);
        cp_commit();
      }
      vt = vs + (t & 1) * G::KVB;
      reg_fence(s);
      wg_fence();
      qk<DH>(qs, ks + (t & 1) * G::KVB, s);
      wg_commit_wait();
      reg_fence(s);
    } else {
      // q . k^T one DH-wide slab at a time, the copies synchronous
      for (int j0 = 0; j0 < dqk; j0 += DH) {
        __syncthreads();   // the previous slab, or tile, is read by all
        load_tile<BM, DH>(qs, qh, r0, Sq, dqk, j0);
        load_tile<BN, DH>(ks, kh, c0, Sk, dqk, j0);
        if (j0 + DH >= dqk) load_tile<BN, DH>(vs, vh, c0, Sk, DH, 0);
        cp_commit();
        cp_wait_all();
        __syncthreads();
        reg_fence(s);
        wg_fence();
        qk<DH>(qs, ks, s);
        wg_commit_wait();
        reg_fence(s);
      }
    }

    // scale, mask, and the online softmax; a row's 64 columns lie with
    // the 4 threads t4 of one quad
    const bool masked = c0 + BN > Sk || (causal && c0 + BN - 1 > wr0);
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * scale_log2;
      if (masked) {
        const int col = c0 + (i / 4) * 8 + 2 * t4 + (i & 1), row = wr0 + g + ((i >> 1) & 1) * 8;
        if (col >= Sk || (causal && col > row)) x = NEG;
      }
      s[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_cur = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_cur);
      m[r] = m_cur;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = exp2f(s[i] - m[(i >> 1) & 1]);
      l[(i >> 1) & 1] += p;
      s[i] = p;
    }

    // acc += p . v, p as p_hi + p_lo from registers: the accumulator
    // layout of s over kv columns 16 kk .. 16 kk + 15 is the A layout of
    // p; v is the B operand MN-major (its columns contiguous), 16 kv rows
    // a wgmma, the atoms DH / AC of them BN * SW bytes apart
    uint32_t ph[BN / 16][4], pl[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1], ph[kk][j], pl[kk][j]);
    reg_fence(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint64_t dv = desc<DH>(vt + kk * 16 * G::SW, BN * G::SW, 8 * G::SW);
      wgmma_rs<DH>(acc, ph[kk], dv);
      wgmma_rs<DH>(acc, pl[kk], dv);
    }
    wg_commit_wait();
    reg_fence(acc);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = wr0 + g + 8 * r;
    if (row >= Sq) continue;
    const float li = l[r] == 0.0f ? 1.0f : l[r];
    bf16* dst = oh + (size_t)row * DH + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
          __floats2bfloat162_rn(acc[4 * n + 2 * r] / li, acc[4 * n + 2 * r + 1] / li);
  }
}

}  // namespace tc

// The opt-in to a kernel's dynamic shared memory (above 48 KB only after
// it); a refused opt-in or launch never runs, so both are checked here
template <class K>
cudaError_t allow_smem(K kernel, int bytes) {
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int DH, bool SLABS>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int H,
               int Hkv, int Sq, int Sk, int dqk, int causal, float scale, cudaStream_t st) {
  constexpr int SMEM = f32::Geo<DH>::SMEM;
  const auto kernel = f32::flash_f32_kernel<DH, SLABS>;
  const cudaError_t e = allow_smem(kernel, SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + f32::BM - 1) / f32::BM, H, B);
  kernel<<<grid, f32::NT, SMEM, st>>>((const float*)q, (const float*)k, (const float*)v,
                                      (float*)o, H, Hkv, Sq, Sk, dqk, causal, scale);
  return (int)cudaGetLastError();
}

template <int DH, bool SLABS>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int H,
                int Hkv, int Sq, int Sk, int dqk, int causal, float scale, cudaStream_t st) {
  using tc::bf16;
  constexpr int SMEM = tc::Geo<DH>::SMEM;
  const auto kernel = tc::flash_bf16_kernel<DH, SLABS>;
  const cudaError_t e = allow_smem(kernel, SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + tc::BM - 1) / tc::BM, H, B);
  kernel<<<grid, tc::NT, SMEM, st>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                     (bf16*)o, H, Hkv, Sq, Sk, dqk, causal,
                                     scale * tc::LOG2E);
  return (int)cudaGetLastError();
}

// The split of k and v into ws (kernel.py's tf32_workspace: k's hi and lo
// parts, then v^T's, each (B, Hkv, n_kv tiles, BN x dh) in the layout of
// shared memory), then the attention over them
int launch_tf32(const void* q, const void* k, const void* v, void* o, void* ws, long ws_floats,
                int B, int H, int Hkv, int Sq, int Sk, int dh, int causal, float scale,
                cudaStream_t st) {
  const int n_kv = (Sk + x3::BN - 1) / x3::BN;
  const size_t part = (size_t)B * Hkv * n_kv * x3::BN * dh;
  if (ws_floats < (long)(4 * part) || Hkv > 65535) return (int)cudaErrorInvalidValue;
  float* khi = (float*)ws;
  float *klo = khi + part, *vthi = klo + part, *vtlo = vthi + part;
  const auto run = [&](auto dh_c) {
    constexpr int DH = decltype(dh_c)::value;
    x3::flash_tf32_split_kv<DH><<<dim3(n_kv, Hkv, B), x3::NT, 0, st>>>(
        (const float*)k, (const float*)v, khi, klo, vthi, vtlo, Sk);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    constexpr int SMEM = x3::Geo<DH>::SMEM;
    const auto kernel = x3::flash_tf32_kernel<DH>;
    e = allow_smem(kernel, SMEM);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((Sq + x3::BM - 1) / x3::BM, H, B);
    kernel<<<grid, x3::NT, SMEM, st>>>((const float*)q, khi, klo, vthi, vtlo, (float*)o, H, Hkv,
                                       Sq, Sk, causal, scale);
    return (int)cudaGetLastError();
  };
  using std::integral_constant;
  switch (dh) {
    case 32: return run(integral_constant<int, 32>{});
    case 64: return run(integral_constant<int, 64>{});
    case 128: return run(integral_constant<int, 128>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// The routes, as kernel.py's kernel_route names them
enum Route { F32_CUDA_CORES = 0, BF16_WGMMA = 1, F32_3XTF32 = 2 };

// The instance for (route, Dqk, Dv): the bf16 kernel at Dqk == Dv in {32,
// 64, 128, 256}; the 3xTF32 kernel at Dqk == Dv in {32, 64, 128}; the
// CUDA-core f32 kernel at Dqk == Dv == 256; on the bf16 and CUDA-core f32
// kernels also Dv 128 with Dqk a larger multiple of it (a column slice of
// a wide head)
int launch_route(int route, const void* q, const void* k, const void* v, void* o, void* ws,
                 long ws_floats, int B, int H, int Hkv, int Sq, int Sk, int dqk, int dv,
                 int causal, float scale, cudaStream_t st) {
  using std::integral_constant;
  using whole = integral_constant<bool, false>;
  using slabs = integral_constant<bool, true>;
  const auto bf16 = [&](auto dh, auto sl) {
    constexpr int DH = decltype(dh)::value;
    return launch_bf16<DH, decltype(sl)::value>(q, k, v, o, B, H, Hkv, Sq, Sk, dqk, causal,
                                                 scale, st);
  };
  const auto f32 = [&](auto sl) {
    constexpr bool SLABS = decltype(sl)::value;
    return launch_f32<SLABS ? 128 : 256, SLABS>(q, k, v, o, B, H, Hkv, Sq, Sk, dqk, causal,
                                                scale, st);
  };
  const bool sliced = dv == 128 && dqk > dv && dqk % dv == 0;
  switch (route) {
    case F32_3XTF32:
      return dqk == dv ? launch_tf32(q, k, v, o, ws, ws_floats, B, H, Hkv, Sq, Sk, dv, causal,
                                     scale, st)
                       : (int)cudaErrorInvalidValue;
    case F32_CUDA_CORES:
      if (dqk == dv && dv == 256) return f32(whole{});
      return sliced ? f32(slabs{}) : (int)cudaErrorInvalidValue;
    case BF16_WGMMA:
      if (sliced) return bf16(integral_constant<int, 128>{}, slabs{});
      if (dqk != dv) return (int)cudaErrorInvalidValue;
      switch (dv) {
        case 32: return bf16(integral_constant<int, 32>{}, whole{});
        case 64: return bf16(integral_constant<int, 64>{}, whole{});
        case 128: return bf16(integral_constant<int, 128>{}, whole{});
        case 256: return bf16(integral_constant<int, 256>{}, whole{});
        default: return (int)cudaErrorInvalidValue;
      }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, Sq, Dqk), k (B, Hkv, Sk, Dqk), v (B, Hkv, Sk, Dv), o (B, H, Sq,
// Dv), contiguous, all f32 (routes F32_*) or all bf16 (BF16_WGMMA), the
// head dims one of launch_route's instances; H a multiple of Hkv; ws an
// f32 workspace of ws_floats, for F32_3XTF32 at least kernel.py's
// tf32_workspace (else unused, may be null).  Every element of o is
// written.  Returns the first CUDA error of the launches.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* o, void* ws, long ws_floats, int B, int H, int Hkv,
                                 int Sq, int Sk, int Dqk, int Dv, int causal, int route,
                                 float scale, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || Sq < 1 || Sk < 1 ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  return launch_route(route, q, k, v, o, ws, ws_floats, B, H, Hkv, Sq, Sk, Dqk, Dv, causal,
                      scale, (cudaStream_t)stream);
}
