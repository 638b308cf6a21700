// s8 x s8 -> s32 matmul with the dequantize epilogue fused (K3), for Hopper
// (sm_90a).
//
// Replaces src/repro/kernels/int8_matmul.py:int8_matmul_pallas.
//
//   out[m, n] = ((acc[m, n] - zp * colsum[n]) * a_scale[m] * b_scale[n]
//                + bias[n])                               cast to out dtype
//
// Bound on the H100: bytes at decode (M = live rows, 16..64: the weight
// matrix is read once and each weight byte feeds only M multiply-adds) and
// operations at prefill (M = 16 x source length).  This first kernel is
// simple and exact: a shared-memory tiled GEMM on __dp4a (four s8 products
// summed into s32 per instruction).  Each block computes a 32 x 64 output
// tile; A's tile is stored with K contiguous, B's tile is transposed while
// it is stored, so both operands feed __dp4a as packed 4-byte words of
// consecutive K.  K runs innermost in one block, in order, with no split-K,
// so the s32 sums equal the reference's and the result is deterministic.
// M is not padded: a decode step with 16 rows launches 16-row work.  The
// card's int8 tensor cores (wgmma) are the later step that moves the
// prefill GEMMs off the CUDA cores.
//
// Exactness: the s32 accumulator cannot overflow (127^2 * 2048 < 2^31).  The
// epilogue keeps the reference's op order (int8_matmul.py:50-57) with
// explicitly rounded intrinsics, so nvcc cannot contract it into FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // 16 x 16 threads
constexpr int kBM = 32;            // rows of the output tile
constexpr int kBN = 64;            // columns of the output tile
constexpr int kBK = 64;            // K bytes per shared-memory step
constexpr int kTM = kBM / 16;      // rows per thread
constexpr int kTN = kBN / 16;      // columns per thread
constexpr int kWords = kBK / 4;    // packed 4-byte words per tile row
constexpr int kLd = kWords + 1;    // padded row stride (words): no bank conflicts

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                   const float* __restrict__ a_scale, float a_scale_value,
                   int a_scale_per_row, const float* __restrict__ b_scale,
                   const float* __restrict__ colsum, float zp, int has_zp,
                   const float* __restrict__ bias, OutT* __restrict__ out,
                   int M, int N, int K) {
  __shared__ int32_t As[kBM][kLd];   // A tile, K contiguous
  __shared__ int32_t Bs[kBN][kLd];   // B tile transposed, K contiguous
  int8_t* As8 = reinterpret_cast<int8_t*>(&As[0][0]);
  int8_t* Bs8 = reinterpret_cast<int8_t*>(&Bs[0][0]);

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  int32_t acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // A tile: neighbouring threads read neighbouring K bytes of one row.
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;
      const int gm = m0 + r, gk = k0 + c;
      As8[r * kLd * 4 + c] =
          (gm < M && gk < K) ? a[static_cast<long long>(gm) * K + gk] : 0;
    }
    // B tile: neighbouring threads read neighbouring N bytes of one K row,
    // and store them transposed so each column's K bytes are contiguous.
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int r = i / kBN, c = i % kBN;
      const int gk = k0 + r, gn = n0 + c;
      Bs8[c * kLd * 4 + r] =
          (gk < K && gn < N) ? b[static_cast<long long>(gk) * N + gn] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      int32_t av[kTM], bv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) av[i] = As[ty + 16 * i][w];
#pragma unroll
      for (int j = 0; j < kTN; ++j) bv[j] = Bs[tx + 16 * j][w];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
    const float as = a_scale_per_row ? a_scale[m]
                                     : (a_scale ? a_scale[0] : a_scale_value);
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      float v = __int2float_rn(acc[i][j]);
      if (has_zp) v = __fsub_rn(v, __fmul_rn(zp, colsum[n]));
      v = __fmul_rn(__fmul_rn(v, as), b_scale[n]);
      if (bias) v = __fadd_rn(v, bias[n]);
      store(out + static_cast<long long>(m) * N + n, v);
    }
  }
}

}  // namespace

// a (M,K) s8 and b (K,N) s8 row-major.  a_scale: (M,) f32 when
// a_scale_per_row, else one f32 at a_scale, or a_scale_value when a_scale is
// null.  b_scale (N,) f32; colsum (N,) f32 when has_zp; bias (N,) f32 or
// null.  out_dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int repro_int8_matmul(const void* a, const void* b,
                                 const void* a_scale, float a_scale_value,
                                 int a_scale_per_row, const void* b_scale,
                                 const void* colsum, float zp, int has_zp,
                                 const void* bias, void* out, int M, int N,
                                 int K, int out_dtype, int device,
                                 void* stream) {
  cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  const int8_t* a8 = static_cast<const int8_t*>(a);
  const int8_t* b8 = static_cast<const int8_t*>(b);
  const float* as = static_cast<const float*>(a_scale);
  const float* bs = static_cast<const float*>(b_scale);
  const float* cs = static_cast<const float*>(colsum);
  const float* bi = static_cast<const float*>(bias);
  if (out_dtype == 1) {
    int8_matmul_kernel<<<grid, kThreads, 0, s>>>(
        a8, b8, as, a_scale_value, a_scale_per_row, bs, cs, zp, has_zp, bi,
        static_cast<__nv_bfloat16*>(out), M, N, K);
  } else {
    int8_matmul_kernel<<<grid, kThreads, 0, s>>>(
        a8, b8, as, a_scale_value, a_scale_per_row, bs, cs, zp, has_zp, bi,
        static_cast<float*>(out), M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}
