// s8 activations x block-wise INT4 weights (packed nibbles, per-group scale
// and min) -> f32/bf16, with the dequantize epilogue fused (K6), for Hopper
// (sm_90a).
//
// Replaces src/repro/kernels/int4_matmul.py:int4_matmul_pallas.
//
//   real(b)[k, n] = nib[k, n] * scale[g, n] + vmin[g, n]      (g = k / G)
//   out[m, n] = ((sum_g (float(d_g) * scale[g, n] + float(r_g) * vmin[g, n])
//                 - zp * colsum[n]) * a_scale[m] + bias[n])   cast to out dtype
//
// with d_g = sum_{k in g} a[m, k] * nib[k, n] and r_g = sum_{k in g} a[m, k],
// both exact in s32.  Bound on the H100: bytes at decode (M = live rows,
// 16..64: the packed weights are read once and each byte feeds 2 M
// multiply-adds) and operations at prefill.  This first kernel is K3's
// simple design (csrc/int8_matmul.cu): a shared-memory tiled GEMM on
// __dp4a, 32 x 64 output tiles, 256 threads.  The nibbles are unpacked while
// the B tile is stored to shared memory (transposed, K contiguous), so the
// unpacked weights never reach device memory.  The K loop runs group by
// group, each group in steps of at most 64 rows; a group's s32 dot and row
// sum (the row sum is one more __dp4a against 0x01010101) are flushed into
// the f32 accumulator at the group's end, in ascending groups, with the
// reference's op order in explicitly rounded intrinsics (no FMA contraction,
// no split-K, no atomics).  A step whose length is not a multiple of 4 (a
// group size of 2 mod 4) is zero-filled to the next 4-byte word in shared
// memory, so no __dp4a word straddles two groups.  Activations past K (up
// to the stored n_groups * G rows) are loaded as zero: they add nothing to
// the dot or the row sum.  The card's int8 tensor cores are the later step.
//
// Exactness: |d_g| <= 127 * 15 * G and |r_g| <= 127 * G fit s32 for any G
// below 2^20.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // 16 x 16 threads
constexpr int kBM = 32;            // rows of the output tile
constexpr int kBN = 64;            // columns of the output tile
constexpr int kBK = 64;            // K rows per shared-memory step (at most)
constexpr int kTM = kBM / 16;      // rows per thread
constexpr int kTN = kBN / 16;      // columns per thread
constexpr int kWords = kBK / 4;    // packed 4-byte words per tile row
constexpr int kLd = kWords + 1;    // padded row stride (words): no bank conflicts

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __half* p) {
  return __half2float(*p);
}

template <typename OutT, typename ScaleT>
__global__ void __launch_bounds__(kThreads)
int4_matmul_kernel(const int8_t* __restrict__ a, const uint8_t* __restrict__ b,
                   const float* __restrict__ a_scale, float a_scale_value,
                   int a_scale_per_row, const ScaleT* __restrict__ b_scale,
                   const ScaleT* __restrict__ b_min,
                   const float* __restrict__ colsum, float zp, int has_zp,
                   const float* __restrict__ bias, OutT* __restrict__ out,
                   int M, int N, int K, int n_groups, int G) {
  __shared__ int32_t As[kBM][kLd];   // A tile, K contiguous
  __shared__ int32_t Bs[kBN][kLd];   // B tile unpacked and transposed
  int8_t* As8 = reinterpret_cast<int8_t*>(&As[0][0]);
  int8_t* Bs8 = reinterpret_cast<int8_t*>(&Bs[0][0]);

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  float accf[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) accf[i][j] = 0.0f;

  for (int g = 0; g < n_groups; ++g) {
    int32_t acc[kTM][kTN];
    int32_t rs[kTM];
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      rs[i] = 0;
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0;
    }
    for (int kk = 0; kk < G; kk += kBK) {
      const int k0 = g * G + kk;               // even: G is even
      const int len = min(kBK, G - kk);        // even
      // A tile: neighbouring threads read neighbouring K bytes of one row;
      // zero past the step, past K and past M.
      for (int i = tid; i < kBM * kBK; i += kThreads) {
        const int r = i / kBK, c = i % kBK;
        const int gm = m0 + r, gk = k0 + c;
        As8[r * kLd * 4 + c] = (c < len && gm < M && gk < K)
                                   ? a[static_cast<long long>(gm) * K + gk]
                                   : 0;
      }
      // B tile: neighbouring threads read neighbouring N bytes of one packed
      // row (two K rows); the low nibble is row 2r, the high one 2r + 1.
      for (int i = tid; i < (kBK / 2) * kBN; i += kThreads) {
        const int r2 = i / kBN, c = i % kBN;
        const int gn = n0 + c;
        uint8_t byte = 0;
        if (2 * r2 < len && gn < N)
          byte = b[static_cast<long long>(k0 / 2 + r2) * N + gn];
        Bs8[c * kLd * 4 + 2 * r2] = static_cast<int8_t>(byte & 0xF);
        Bs8[c * kLd * 4 + 2 * r2 + 1] = static_cast<int8_t>(byte >> 4);
      }
      __syncthreads();
      const int words = (len + 3) / 4;
      for (int w = 0; w < words; ++w) {
        int32_t av[kTM], bv[kTN];
#pragma unroll
        for (int i = 0; i < kTM; ++i) av[i] = As[ty + 16 * i][w];
#pragma unroll
        for (int j = 0; j < kTN; ++j) bv[j] = Bs[tx + 16 * j][w];
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          rs[i] = __dp4a(av[i], 0x01010101, rs[i]);
#pragma unroll
          for (int j = 0; j < kTN; ++j)
            acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
        }
      }
      __syncthreads();
    }
    // flush the group: acc + (float(d) * scale + float(r) * vmin)
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      const float s = load(b_scale + static_cast<long long>(g) * N + n);
      const float mn = load(b_min + static_cast<long long>(g) * N + n);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const float t = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j]), s),
                                  __fmul_rn(__int2float_rn(rs[i]), mn));
        accf[i][j] = __fadd_rn(accf[i][j], t);
      }
    }
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
      float v = accf[i][j];
      if (has_zp) v = __fsub_rn(v, __fmul_rn(zp, colsum[n]));
      v = __fmul_rn(v, as);
      if (bias) v = __fadd_rn(v, bias[n]);
      store(out + static_cast<long long>(m) * N + n, v);
    }
  }
}

template <typename OutT, typename ScaleT>
void launch(dim3 grid, cudaStream_t s, const void* a, const void* b,
            const void* a_scale, float a_scale_value, int a_scale_per_row,
            const void* b_scale, const void* b_min, const void* colsum,
            float zp, int has_zp, const void* bias, void* out, int M, int N,
            int K, int n_groups, int G) {
  int4_matmul_kernel<OutT, ScaleT><<<grid, kThreads, 0, s>>>(
      static_cast<const int8_t*>(a), static_cast<const uint8_t*>(b),
      static_cast<const float*>(a_scale), a_scale_value, a_scale_per_row,
      static_cast<const ScaleT*>(b_scale), static_cast<const ScaleT*>(b_min),
      static_cast<const float*>(colsum), zp, has_zp,
      static_cast<const float*>(bias), static_cast<OutT*>(out), M, N, K,
      n_groups, G);
}

}  // namespace

// a (M,K) s8 row-major; b (n_groups*G/2, N) packed nibbles row-major;
// b_scale and b_min (n_groups, N), f32 (scale_dtype 0) or f16 (1).  K <=
// n_groups * G, G even.  a_scale: (M,) f32 when a_scale_per_row, else one
// f32 at a_scale, or a_scale_value when a_scale is null.  colsum (N,) f32
// when has_zp; bias (N,) f32 or null.  out_dtype: 0 = float32, 1 =
// bfloat16.  Returns cudaGetLastError().
extern "C" int repro_int4_matmul(const void* a, const void* b,
                                 const void* a_scale, float a_scale_value,
                                 int a_scale_per_row, const void* b_scale,
                                 const void* b_min, int scale_dtype,
                                 const void* colsum, float zp, int has_zp,
                                 const void* bias, void* out, int M, int N,
                                 int K, int n_groups, int group_size,
                                 int out_dtype, int device, void* stream) {
  cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  if (out_dtype == 1 && scale_dtype == 1) {
    launch<__nv_bfloat16, __half>(grid, s, a, b, a_scale, a_scale_value,
                                  a_scale_per_row, b_scale, b_min, colsum, zp,
                                  has_zp, bias, out, M, N, K, n_groups,
                                  group_size);
  } else if (out_dtype == 1) {
    launch<__nv_bfloat16, float>(grid, s, a, b, a_scale, a_scale_value,
                                 a_scale_per_row, b_scale, b_min, colsum, zp,
                                 has_zp, bias, out, M, N, K, n_groups,
                                 group_size);
  } else if (scale_dtype == 1) {
    launch<float, __half>(grid, s, a, b, a_scale, a_scale_value,
                          a_scale_per_row, b_scale, b_min, colsum, zp, has_zp,
                          bias, out, M, N, K, n_groups, group_size);
  } else {
    launch<float, float>(grid, s, a, b, a_scale, a_scale_value,
                         a_scale_per_row, b_scale, b_min, colsum, zp, has_zp,
                         bias, out, M, N, K, n_groups, group_size);
  }
  return static_cast<int>(cudaGetLastError());
}
