// s8 x s8 -> s32 matmul with the dequantize epilogue fused (K3), and its
// per-expert grouped form (K7), for Hopper (sm_90a).
//
// K3 replaces src/repro/kernels/int8_matmul.py:int8_matmul_pallas:
//
//   out[m, n] = ((acc[m, n] - zp * colsum[n]) * a_scale[m] * b_scale[n]
//                + bias[n])                               cast to out dtype
//
// K7 replaces src/repro/kernels/int8_matmul.py:int8_matmul_batched_pallas,
// the MoE expert FFN's grouped GEMM: for every expert e,
//
//   out[e, m, n] = acc_e[m, n] * a_scale[e, m] * b_scale[e, n]
//
// with acc_e = a[e] @ b[e] (a (E,M,K), b (E,K,N)).  It runs K3's tile
// (int8_matmul_tile) as a kernel of its own with the expert as the third
// grid axis (blockIdx.z): each block offsets its expert's operands, scales
// and output, and the epilogue is K3's without the zero point and the
// bias, so it is exact in the same way.  A decode step gives every expert
// M = capacity rows (5 at 16 rows, top-8 of 32): the 32-row tile masks the
// rest, and the E x N/64 blocks (256 for N = 512) fill the card that K3's
// N/64 blocks at small M do not.
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

// One block's 32 x 64 output tile of one (M,K) x (K,N) product.
template <typename OutT>
__device__ __forceinline__ void int8_matmul_tile(
    const int8_t* __restrict__ a, const int8_t* __restrict__ b,
    const float* __restrict__ a_scale, float a_scale_value,
    int a_scale_per_row, const float* __restrict__ b_scale,
    const float* __restrict__ colsum, float zp, int has_zp,
    const float* __restrict__ bias, OutT* __restrict__ out, int M, int N,
    int K) {
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

// K3: one product, grid (N/64, M/32).
template <typename OutT>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                   const float* __restrict__ a_scale, float a_scale_value,
                   int a_scale_per_row, const float* __restrict__ b_scale,
                   const float* __restrict__ colsum, float zp, int has_zp,
                   const float* __restrict__ bias, OutT* __restrict__ out,
                   int M, int N, int K) {
  int8_matmul_tile(a, b, a_scale, a_scale_value, a_scale_per_row, b_scale,
                   colsum, zp, has_zp, bias, out, M, N, K);
}

// K7: grid (N/64, M/32, E); blockIdx.z is the expert, whose operands,
// per-row activation scales, weight scales and output follow each other in
// one tensor each.  A scalar activation scale is shared by every expert.
template <typename OutT>
__global__ void __launch_bounds__(kThreads)
int8_matmul_batched_kernel(const int8_t* __restrict__ a,
                           const int8_t* __restrict__ b,
                           const float* __restrict__ a_scale,
                           float a_scale_value, int a_scale_per_row,
                           const float* __restrict__ b_scale,
                           OutT* __restrict__ out, int M, int N, int K) {
  const long long e = blockIdx.z;
  int8_matmul_tile(a + e * M * K, b + e * K * N,
                   a_scale_per_row ? a_scale + e * M : a_scale,
                   a_scale_value, a_scale_per_row, b_scale + e * N, nullptr,
                   0.0f, 0, nullptr, out + e * M * N, M, N, K);
}

}  // namespace

namespace {

template <typename OutT>
void launch_k3(dim3 grid, cudaStream_t s, const int8_t* a, const int8_t* b,
               const float* as, float asv, int per_row, const float* bs,
               const float* cs, float zp, int has_zp, const float* bi,
               void* out, int M, int N, int K) {
  int8_matmul_kernel<<<grid, kThreads, 0, s>>>(
      a, b, as, asv, per_row, bs, cs, zp, has_zp, bi,
      static_cast<OutT*>(out), M, N, K);
}

template <typename OutT>
void launch_k7(dim3 grid, cudaStream_t s, const int8_t* a, const int8_t* b,
               const float* as, float asv, int per_row, const float* bs,
               void* out, int M, int N, int K) {
  int8_matmul_batched_kernel<<<grid, kThreads, 0, s>>>(
      a, b, as, asv, per_row, bs, static_cast<OutT*>(out), M, N, K);
}

}  // namespace

// K3.  a (M,K) s8 and b (K,N) s8 row-major.  a_scale: (M,) f32 when
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
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* a8 = static_cast<const int8_t*>(a);
  const auto* b8 = static_cast<const int8_t*>(b);
  const auto* as = static_cast<const float*>(a_scale);
  const auto* bs = static_cast<const float*>(b_scale);
  const auto* cs = static_cast<const float*>(colsum);
  const auto* bi = static_cast<const float*>(bias);
  if (out_dtype == 1) {
    launch_k3<__nv_bfloat16>(grid, s, a8, b8, as, a_scale_value,
                             a_scale_per_row, bs, cs, zp, has_zp, bi, out, M,
                             N, K);
  } else {
    launch_k3<float>(grid, s, a8, b8, as, a_scale_value, a_scale_per_row, bs,
                     cs, zp, has_zp, bi, out, M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}

// K7.  a (E,M,K) s8, b (E,K,N) s8, out (E,M,N), all row-major.  a_scale:
// (E,M) f32 when a_scale_per_row, else one f32 for every expert at a_scale,
// or a_scale_value when a_scale is null.  b_scale (E,N) f32.  E <= 65535.
// out_dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int repro_int8_matmul_batched(const void* a, const void* b,
                                         const void* a_scale,
                                         float a_scale_value,
                                         int a_scale_per_row,
                                         const void* b_scale, void* out,
                                         int E, int M, int N, int K,
                                         int out_dtype, int device,
                                         void* stream) {
  cudaSetDevice(device);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, E);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* a8 = static_cast<const int8_t*>(a);
  const auto* b8 = static_cast<const int8_t*>(b);
  const auto* as = static_cast<const float*>(a_scale);
  const auto* bs = static_cast<const float*>(b_scale);
  if (out_dtype == 1) {
    launch_k7<__nv_bfloat16>(grid, s, a8, b8, as, a_scale_value,
                             a_scale_per_row, bs, out, M, N, K);
  } else {
    launch_k7<float>(grid, s, a8, b8, as, a_scale_value, a_scale_per_row, bs,
                     out, M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}
