// Causal GQA flash attention, forward, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::_kernel
// (launched there by flash_attention_kernel_call, pallas_call at :118).
// q (B, H, Sq, Dh), k and v (B, Hkv, Sk, Dh), f32 or bf16, row-major;
// query head h reads kv head h / (H / Hkv).  The output has q's shape and
// dtype.  For each query row, over kv tiles in ascending order:
//   s = (q * scale) . k^T            (masked to -1e30 where col > row when
//                                     causal, and past Sk)
//   m' = max(m, rowmax s), a = exp(m - m'), p = exp(s - m')
//   l = l a + rowsum p, acc = acc a + p . v, m = m'
// then out = acc / l, with l == 0 taken as 1.  All arithmetic is f32 for
// both dtypes, as the TPU kernel's is: inputs are widened as they are
// staged, q is scaled before the product, p stays f32 in p . v, and a
// bf16 output is rounded once with __float2bfloat16_rn.  The running max
// starts at -1e30, as the reference's does, so exp(m - m') is never NaN;
// kv tile 0 holds column 0 <= row, so every row's max is finite from the
// first tile on.
//
// Grid: one thread block per (query tile of 64 rows, head, batch), the
// query tiles in reverse order so the longest causal rows start first.
// The kv loop runs inside the block (the TPU's sequential innermost grid
// axis) and carries m, l and acc in registers; kv tiles wholly in the
// causal future of the query tile (c0 > r0 + 63) are not visited.
//
// What bounds it on an H100: the multiply-adds of q.k^T and p.v, 2 * B * H
// * Sq * Sk * Dh FLOP over the causal half.  In f32 that is the 67 TFLOP/s
// of the CUDA cores (1.03 ms at B 1, H 16, S 4096, Dh 128); for bf16
// inputs the least time is the same work at the 989 TFLOP/s of the bf16
// tensor cores (0.07 ms), with the bytes of q, k, v and o (50 MB in bf16,
// 0.015 ms) below it.  This first design keeps to CUDA-core f32 FMAs for both
// dtypes (the arithmetic the TPU kernel specifies), so bf16 runs at the
// f32 rate; tensor cores (mma.sync / wgmma on bf16 tiles) are later work.
// What it does about the f32 bound: 256 threads each own 4 query rows x 4
// kv columns of s and 4 rows x Dh/16 columns of acc in registers, so every
// shared-memory float4 feeds 4 (s) or 4-16 (acc) FMAs; the q tile, the
// k tile and the v tile live in dynamic shared memory with a 4-float row
// pad (conflict-free float4 reads), and p^T reuses the k tile's space, so
// Dh 128 takes 99 KB and two blocks fit on an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64;          // query rows per block
constexpr int BN = 64;          // kv rows per tile
constexpr int NT = 256;         // threads: 16 x 16
constexpr float NEG = -1e30f;   // the reference's masked score and initial max

template <int DH>
struct Geo {
  static constexpr int LD = DH + 4;    // row stride of the q, k, v tiles (floats)
  static constexpr int LDP = BM + 4;   // row stride of p^T
  static constexpr int CD = DH / 16;   // output columns per thread
  static constexpr int VW = CD < 4 ? CD : 4;  // in runs of VW adjacent ones
  static constexpr int KREGION = BN * LD > BN * LDP ? BN * LD : BN * LDP;
  static constexpr int SMEM = (BM * LD + KREGION + BN * LD) * 4;  // bytes
};

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + 2));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// rows [r0, r0 + ROWS) of a (len, DH) matrix into dst [ROWS][LD] as f32,
// times scale when scaled; rows at or past len are zeros.  Every load is
// issued before the first store, so all of a thread's are in flight.
template <int ROWS, int DH, class T>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0, int len,
                                      bool scaled, float scale) {
  constexpr int C4 = DH / 4, PER = ROWS * C4 / NT;
  static_assert(PER * NT == ROWS * C4, "whole float4 runs per thread");
  float4 x[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = threadIdx.x + u * NT, r = e / C4, c = (e % C4) * 4;
    x[u] = r0 + r < len ? load4(src + (size_t)(r0 + r) * DH + c)
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

template <int DH, class T>
__global__ void __launch_bounds__(NT, DH <= 128 ? 2 : 1) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int H, int Hkv, int Sq, int Sk, int causal, float scale) {
  using G = Geo<DH>;
  constexpr int CD = G::CD, VW = G::VW, LD = G::LD, LDP = G::LDP;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;               // [BM][LD]: q * scale
  float* ks = qs + BM * LD;       // [BN][LD]: the k tile; then [BN][LDP]: p^T
  float* vs = ks + G::KREGION;    // [BN][LD]: the v tile

  const int iq = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hkv);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int r0 = iq * BM;
  const T* qh = q + ((size_t)b * H + h) * Sq * DH;
  const T* kh = k + ((size_t)b * Hkv + hk) * Sk * DH;
  const T* vh = v + ((size_t)b * Hkv + hk) * Sk * DH;
  T* oh = o + ((size_t)b * H + h) * Sq * DH;

  stage<BM, DH>(qs, qh, r0, Sq, true, scale);

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
    __syncthreads();  // the previous tile's p^T and v are read
    stage<BN, DH>(ks, kh, c0, Sk, false, 1.0f);
    stage<BN, DH>(vs, vh, c0, Sk, false, 1.0f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
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
        const float* src = vs + kv * LD + g * 16 * VW + tx * VW;
        if constexpr (VW == 4) {
          const float4 x = *reinterpret_cast<const float4*>(src);
          vv[g * 4] = x.x; vv[g * 4 + 1] = x.y; vv[g * 4 + 2] = x.z; vv[g * 4 + 3] = x.w;
        } else {
          const float2 x = *reinterpret_cast<const float2*>(src);
          vv[g * 2] = x.x; vv[g * 2 + 1] = x.y;
        }
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
    T* dst = oh + (size_t)row * DH;
#pragma unroll
    for (int c = 0; c < CD; ++c)
      store1(dst + (c / VW) * 16 * VW + tx * VW + c % VW, acc[i][c] / li);
  }
}

template <int DH, class T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Hkv, int Sq, int Sk, int causal, float scale, cudaStream_t st) {
  using G = Geo<DH>;
  // above 48 KB only as dynamic shared memory, after this opt-in; a
  // refused launch never runs, so the caller checks cudaGetLastError()
  const cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<DH, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + BM - 1) / BM, H, B);
  flash_kernel<DH, T><<<grid, NT, G::SMEM, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H, Hkv, Sq, Sk, causal, scale);
  return (int)cudaGetLastError();
}

template <class T>
int launch_dh(const void* q, const void* k, const void* v, void* o, int B, int H,
              int Hkv, int Sq, int Sk, int Dh, int causal, float scale,
              cudaStream_t st) {
  switch (Dh) {
    case 32: return launch<32, T>(q, k, v, o, B, H, Hkv, Sq, Sk, causal, scale, st);
    case 64: return launch<64, T>(q, k, v, o, B, H, Hkv, Sq, Sk, causal, scale, st);
    case 128: return launch<128, T>(q, k, v, o, B, H, Hkv, Sq, Sk, causal, scale, st);
    case 256: return launch<256, T>(q, k, v, o, B, H, Hkv, Sq, Sk, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, Sq, Dh), k and v (B, Hkv, Sk, Dh), o (B, H, Sq, Dh), contiguous,
// all f32 (bf16 == 0) or all bf16; Dh in {32, 64, 128, 256}; H a multiple
// of Hkv.  Every element of o is written.  Returns cudaGetLastError()
// after the launch.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* o, int B, int H, int Hkv, int Sq,
                                 int Sk, int Dh, int causal, int bf16,
                                 float scale, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || Sq < 1 || Sk < 1 ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch_dh<__nv_bfloat16>(q, k, v, o, B, H, Hkv, Sq, Sk, Dh, causal, scale, st)
              : launch_dh<float>(q, k, v, o, B, H, Hkv, Sq, Sk, Dh, causal, scale, st);
}
