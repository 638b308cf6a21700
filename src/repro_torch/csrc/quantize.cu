// Activation quantizers for Hopper (sm_90a): K1 (calibrated scale) and K2
// (dynamic per-row abs-max).
//
// K1 replaces src/repro/kernels/quantize.py:quantize_static_pallas and K2
// replaces src/repro/kernels/quantize.py:quantize_rowwise_pallas.
//
// Bound on the H100: bytes.  Each element costs one read (2 or 4 bytes) and
// one 1-byte write, and a handful of f32 operations, below the ~20 f32
// operations per byte (67 TFLOP/s over 3.35 TB/s) where the card's CUDA
// cores, not its memory, would become the limit.  At the decode shapes (16
// to 640 rows) the work is a few kilobytes and the time is the launch and
// one round trip to memory, so the design keeps every load of a thread in
// flight at once and the serial work after it short.
//
// K1 is elementwise over the contiguous (M, K) tensor, so it does not go by
// rows: each thread loads 8 elements with 16-byte loads (one for bf16, two
// for f32) and stores their 8 codes as one 8-byte word; a grid of at most
// one wave walks the tensor with a grid-stride loop, two vectors a thread
// in flight an iteration.  The reciprocal scale comes from the host.
//
// K2 keeps a row in registers: a block holds one row (up to 4 KB a warp,
// split over 1-8 warps), loaded once with 16-byte loads, all in flight, its
// abs-max reduced by one warp reduction instruction (and, split, one
// shared-memory exchange of the warps' maxima: a max is exact in any order,
// so every split gives the same bits), and its codes stored as 8- (bf16)
// or 4-byte (f32) words.
//
// Both have a scalar path (one element a thread a step) for a base address
// that is not 16-byte aligned or a size that the vectors do not divide; K2's
// scalar path reads its row twice.  kernels/quantize.py:plan picks the path,
// the grid and the split from the shapes alone.
//
// Exactness: the codes and scales must equal the reference's bit for bit
// as its engine computes them, jitted (XLA folds the calibrated scale and
// rewrites a division by a constant into a multiply by its f32 reciprocal;
// counted against jax.jit of the reference's prefill and decode_step in
// tests/test_torch_jit_forms.py).  So K1's codes are code(RN(x · inv))
// with inv = 1 / (max(amax, 1e-12) / 127), both IEEE f32 divisions, made
// once on the host (numpy's f32 division is IEEE); K2 computes the row
// scale s = RN(max(amax, 1e-12) · RN(1/127)) and the codes code(RN(x / s)),
// of the IEEE quotient (a division by a tensor, which XLA keeps).  Here
// code(v) = fminf(fmaxf(rint(v), -127), 127), rint rounding half to even,
// as before.
//
// Rounding.  For |v| < 2^22, t = RN(v + 1.5 · 2^23) lies in [2^23, 2^24),
// where the floats are the integers, so t = 1.5 · 2^23 + rint(v) with ties
// to even (an even t is an even integer), and the low byte of t's bits is
// rint(v) mod 256.  Both kernels clip before rounding, lowbyte(RN(min(max(
// v, -127), 127) + 1.5 · 2^23)), which equals code(v) for every v (the
// clip commutes with the monotone rounding, and max maps a NaN to -127
// either way).  tests/test_torch_quantize_plan.py checks this for every
// bf16 value; the card tests hold K1 and K2 to the plain versions bit for
// bit.  Build without fast math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInt8Max = 127.0f;
constexpr float kInv127 = 1.0f / 127.0f;   // f32(1/127), rounded once
constexpr float kEps = 1e-12f;
constexpr float kRound = 12582912.0f;      // 1.5 · 2^23: see "Rounding"
constexpr int kMaxThreads = 256;           // K1's block, K2's largest
constexpr int kMaxVecs = 8;                // K2: 16-byte vectors a lane holds
constexpr int kMaxWarpsPerRow = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// code(v) as the low byte of the result (see "Rounding")
__device__ __forceinline__ uint32_t clip_code(float v) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(v, -kInt8Max), kInt8Max), kRound));
}

// code(RN(x / s)), the IEEE quotient, in the low byte
__device__ __forceinline__ uint32_t divided_code(float x, float s) {
  return clip_code(__fdiv_rn(x, s));
}

// the low bytes of four words, in order
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// The elements of a 16-byte vector as f32: 8 bf16 or 4 f32.
template <typename T> struct Vec;
template <> struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static float at(const uint4& r, int i) {
    const uint32_t w = i < 2 ? r.x : i < 4 ? r.y : i < 6 ? r.z : r.w;
    return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};
template <> struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static float at(const uint4& r, int i) {
    return __uint_as_float(i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w);
  }
};

// ---------------------------------------------------------------------------
// K1
// ---------------------------------------------------------------------------

// 8 elements from x + 8·i: one 16-byte load (bf16) or two (f32)
template <typename T> struct Raw8;
template <> struct Raw8<__nv_bfloat16> {
  uint4 a;
  __device__ __forceinline__ void load(const __nv_bfloat16* x, long long i) {
    a = __ldg(reinterpret_cast<const uint4*>(x) + i);
  }
  __device__ __forceinline__ float at(int j) const { return Vec<__nv_bfloat16>::at(a, j); }
};
template <> struct Raw8<float> {
  uint4 a, b;
  __device__ __forceinline__ void load(const float* x, long long i) {
    const uint4* p = reinterpret_cast<const uint4*>(x) + 2 * i;
    a = __ldg(p);
    b = __ldg(p + 1);
  }
  __device__ __forceinline__ float at(int j) const {
    return j < 4 ? Vec<float>::at(a, j) : Vec<float>::at(b, j - 4);
  }
};

template <typename T>
__device__ __forceinline__ uint2 codes8(const Raw8<T>& r, float inv) {
  uint32_t c[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) c[j] = clip_code(__fmul_rn(r.at(j), inv));
  return make_uint2(pack4(c[0], c[1], c[2], c[3]), pack4(c[4], c[5], c[6], c[7]));
}

template <typename T, bool kVector>
__global__ void __launch_bounds__(kMaxThreads)
quantize_static_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                       long long n, float inv) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (kVector) {
    // vectors i and i + stride: both loads issued before either is used
    const long long nv = n >> 3;
    uint2* qv = reinterpret_cast<uint2*>(q);
    for (; i < nv; i += 2 * stride) {
      const long long j = i + stride;
      Raw8<T> r0, r1;
      r0.load(x, i);
      if (j < nv) r1.load(x, j);
      qv[i] = codes8(r0, inv);
      if (j < nv) qv[j] = codes8(r1, inv);
    }
  } else {
    for (; i < n; i += stride) {
      q[i] = static_cast<int8_t>(clip_code(__fmul_rn(to_f32(x[i]), inv)) & 0xffu);
    }
  }
}

// ---------------------------------------------------------------------------
// K2
// ---------------------------------------------------------------------------

// The row's abs-max from each lane's partial (a non-negative float and not
// a NaN, so its bits order as unsigned integers do): one warp reduction,
// then, with the row split over the block's warps, one exchange through
// shared memory.  A block holds one row; every thread reaches the barrier.
__device__ __forceinline__ float row_max(float m) {
  __shared__ uint32_t part[kMaxWarpsPerRow];
  uint32_t b = __reduce_max_sync(0xffffffffu, __float_as_uint(m));
  if (blockDim.x > 32) {
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = b;
    __syncthreads();
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) b = max(b, part[w]);
  }
  return __uint_as_float(b);
}

// Block b holds row b; thread g of the block holds the row's 16-byte
// vectors g, g + blockDim.x, ..., up to kNV of them.
template <typename T, int kNV>
__global__ void __launch_bounds__(kMaxThreads)
quantize_rowwise_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                        float* __restrict__ scale_out, int K) {
  constexpr int kE = Vec<T>::kN;
  const long long row = blockIdx.x;
  const int g = threadIdx.x, lanes = blockDim.x;
  const int nvec = K / kE;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * K);

  uint4 r[kNV];
#pragma unroll
  for (int v = 0; v < kNV; ++v) {
    const int c = g + v * lanes;
    r[v] = c < nvec ? __ldg(xr + c) : make_uint4(0u, 0u, 0u, 0u);
  }
  // the lane's abs-max, as a tree (a max is exact in any order); fmaxf
  // drops a NaN, and the last one, against 0, a lane of NaNs, so a NaN
  // never reaches the scale, as on the scalar path
  float m[kNV * kE];
#pragma unroll
  for (int v = 0; v < kNV; ++v) {
#pragma unroll
    for (int j = 0; j < kE; ++j) m[v * kE + j] = fabsf(Vec<T>::at(r[v], j));
  }
#pragma unroll
  for (int w = 1; w < kNV * kE; w *= 2) {
#pragma unroll
    for (int i = 0; i + w < kNV * kE; i += 2 * w) m[i] = fmaxf(m[i], m[i + w]);
  }
  const float amax = row_max(fmaxf(m[0], 0.0f));
  const float s = __fmul_rn(fmaxf(amax, kEps), kInv127);
  if (g == 0) scale_out[row] = s;
  int8_t* qr = q + row * K;
#pragma unroll
  for (int v = 0; v < kNV; ++v) {
    const int c = g + v * lanes;
    if (c < nvec) {
      uint32_t k[kE];
#pragma unroll
      for (int j = 0; j < kE; ++j) k[j] = divided_code(Vec<T>::at(r[v], j), s);
      if constexpr (kE == 8) {
        reinterpret_cast<uint2*>(qr)[c] = make_uint2(
            pack4(k[0], k[1], k[2], k[3]), pack4(k[4], k[5], k[6], k[7]));
      } else {
        reinterpret_cast<uint32_t*>(qr)[c] = pack4(k[0], k[1], k[2], k[3]);
      }
    }
  }
}

// The scalar path: any alignment and any K; the row is read twice.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
quantize_rowwise_scalar_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                               float* __restrict__ scale_out, int K) {
  const long long row = blockIdx.x;
  const T* xr = x + row * K;
  float m = 0.0f;
  for (int k = threadIdx.x; k < K; k += blockDim.x) m = fmaxf(m, fabsf(to_f32(xr[k])));
  m = row_max(m);
  const float s = __fmul_rn(fmaxf(m, kEps), kInv127);
  if (threadIdx.x == 0) scale_out[row] = s;
  int8_t* qr = q + row * K;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    qr[k] = static_cast<int8_t>(divided_code(to_f32(xr[k]), s) & 0xffu);
  }
}

template <typename T>
int launch_static(const void* x, void* q, long long n, float inv, int vector,
                  int blocks, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  int8_t* qt = static_cast<int8_t*>(q);
  if (vector) {
    quantize_static_kernel<T, true><<<blocks, kMaxThreads, 0, s>>>(xt, qt, n, inv);
  } else {
    quantize_static_kernel<T, false><<<blocks, kMaxThreads, 0, s>>>(xt, qt, n, inv);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rowwise(const void* x, void* q, void* scale, long long M, int K,
                   int vecs, int wpr, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  int8_t* qt = static_cast<int8_t*>(q);
  float* st = static_cast<float*>(scale);
  const unsigned blocks = static_cast<unsigned>(M);
  const int threads = 32 * wpr;
  switch (vecs) {
    case 0: quantize_rowwise_scalar_kernel<T><<<blocks, threads, 0, s>>>(xt, qt, st, K); break;
    case 1: quantize_rowwise_kernel<T, 1><<<blocks, threads, 0, s>>>(xt, qt, st, K); break;
    case 2: quantize_rowwise_kernel<T, 2><<<blocks, threads, 0, s>>>(xt, qt, st, K); break;
    case 4: quantize_rowwise_kernel<T, 4><<<blocks, threads, 0, s>>>(xt, qt, st, K); break;
    case 8: quantize_rowwise_kernel<T, 8><<<blocks, threads, 0, s>>>(xt, qt, st, K); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a plan the input does not admit.
//
// K1 over the n = M·K elements: codes rint(x · inv); vector != 0 takes the
// 16-byte path (x 16-byte aligned, n a multiple of 8); blocks of 256.
extern "C" int repro_quantize_static(const void* x, void* q, long long n,
                                     float inv, int x_dtype, int vector,
                                     int blocks, int device, void* stream) {
  if (blocks < 1 ||
      (vector && (reinterpret_cast<uintptr_t>(x) % 16 ||
                  reinterpret_cast<uintptr_t>(q) % 8 || n % 8))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_dtype == 1
             ? launch_static<__nv_bfloat16>(x, q, n, inv, vector, blocks, s)
             : launch_static<float>(x, q, n, inv, vector, blocks, s);
}

// K2 over M rows of K, one row a block: vecs 16-byte vectors a lane (1, 2,
// 4 or 8; 0 for the scalar path), wpr warps a row (1, 2, 4 or 8).
extern "C" int repro_quantize_rowwise(const void* x, void* q, void* scale,
                                      long long M, long long K, int x_dtype,
                                      int vecs, int wpr, int device,
                                      void* stream) {
  const int elem = x_dtype == 1 ? 2 : 4;
  const int per_vec = 16 / elem;
  if ((wpr != 1 && wpr != 2 && wpr != 4 && wpr != kMaxWarpsPerRow) || K < 1 ||
      K > (1LL << 30) || M < 1 || M > 0x7fffffffLL ||
      (vecs && (vecs > kMaxVecs || reinterpret_cast<uintptr_t>(x) % 16 ||
                (K * elem) % 16 ||
                static_cast<long long>(vecs) * 32 * wpr * per_vec < K))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int k = static_cast<int>(K);
  return x_dtype == 1
             ? launch_rowwise<__nv_bfloat16>(x, q, scale, M, k, vecs, wpr, s)
             : launch_rowwise<float>(x, q, scale, M, k, vecs, wpr, s);
}
