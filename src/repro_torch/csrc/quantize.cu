// Activation quantizers for Hopper (sm_90a): K1 (calibrated scale) and K2
// (dynamic per-row abs-max).
//
// K1 replaces src/repro/kernels/quantize.py:quantize_static_pallas and K2
// replaces src/repro/kernels/quantize.py:quantize_rowwise_pallas.
//
// Bound on the H100: bytes.  Each element costs one read (2 or 4 bytes) and
// one 1-byte write, and a handful of f32 operations, below the ~20 f32
// operations per byte (67 TFLOP/s over 3.35 TB/s) where the card's CUDA
// cores, not its memory, would become the limit.  Design: one
// block per row, threads striding along the row so neighbouring threads touch
// neighbouring addresses; K2 reduces the row's abs-max across the block in
// registers and shared memory, so its row is read twice from L1/L2 but
// written once, and no intermediate ever goes to device memory.
//
// Exactness: the codes and scales must equal the reference's bit for bit
// as its engine computes them, jitted (XLA folds the calibrated scale and
// rewrites a division by a constant into a multiply by its f32 reciprocal;
// counted against jax.jit of the reference's prefill and decode_step in
// tests/test_torch_jit_forms.py).  So K1 computes scale = max(amax, 1e-12)
// / 127 (quantize.py:73) and its reciprocal inv = 1 / scale in f32, both
// IEEE divisions (__fdiv_rn), and the codes rint(x * inv) (__fmul_rn); K2
// computes the row scale max(amax, 1e-12) * f32(1/127) (__fmul_rn) and the
// codes rint(x / scale) with the IEEE division (__fdiv_rn, a division by a
// tensor, which XLA keeps).  Rounding is half to even (rintf).  Build
// without fast math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kInt8Max = 127.0f;
constexpr float kInv127 = 1.0f / 127.0f;   // f32(1/127), rounded once
constexpr float kEps = 1e-12f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ int8_t clip_code(float q) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(q), -kInt8Max), kInt8Max));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_static_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                       long long K, float amax) {
  const float scale = __fdiv_rn(fmaxf(amax, kEps), kInt8Max);
  const float inv = __fdiv_rn(1.0f, scale);
  const long long row = blockIdx.x;
  const T* xr = x + row * K;
  int8_t* qr = q + row * K;
  for (long long k = threadIdx.x; k < K; k += blockDim.x) {
    qr[k] = clip_code(__fmul_rn(to_f32(xr[k]), inv));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_rowwise_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                        float* __restrict__ scale_out, long long K) {
  __shared__ float warp_max[kThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long row = blockIdx.x;
  const T* xr = x + row * K;
  int8_t* qr = q + row * K;

  float m = 0.0f;
  for (long long k = tid; k < K; k += blockDim.x) {
    m = fmaxf(m, fabsf(to_f32(xr[k])));
  }
  for (int off = 16; off > 0; off >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? warp_max[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    if (lane == 0) warp_max[0] = m;
  }
  __syncthreads();
  const float scale = __fmul_rn(fmaxf(warp_max[0], kEps), kInv127);
  if (tid == 0) scale_out[row] = scale;
  for (long long k = tid; k < K; k += blockDim.x) {
    qr[k] = clip_code(__fdiv_rn(to_f32(xr[k]), scale));
  }
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int repro_quantize_static(const void* x, void* q, long long M,
                                     long long K, float amax, int x_dtype,
                                     int device, void* stream) {
  cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1) {
    quantize_static_kernel<<<M, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q), K, amax);
  } else {
    quantize_static_kernel<<<M, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q), K, amax);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_quantize_rowwise(const void* x, void* q, void* scale,
                                      long long M, long long K, int x_dtype,
                                      int device, void* stream) {
  cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1) {
    quantize_rowwise_kernel<<<M, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scale), K);
  } else {
    quantize_rowwise_kernel<<<M, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scale), K);
  }
  return static_cast<int>(cudaGetLastError());
}
