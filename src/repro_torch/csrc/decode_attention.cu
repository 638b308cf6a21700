// Flash-decode attention over a contiguous INT8 KV cache (K4), for Hopper
// (sm_90a).
//
// Replaces src/repro/kernels/decode_attention.py:decode_attention_pallas.
//
// One query token per sequence attends to its cached keys and values, which
// are int8 with one f32 scale per (token, kv head) and are dequantized in
// registers.  Positions at or past lengths[b] are masked (-1e30 scores,
// zero probabilities); G = H / HKV query heads share each kv head.
//
// Bound on the H100: bytes.  Each cached token is read once (2 * dh int8 +
// two f32 scales per kv head) and costs 4 * G * dh flops, a few flops per
// byte.  Design: one block per (sequence, kv head) walks the sequence in
// order in chunks of 64 positions with an online softmax (running max, sum
// and accumulator in shared memory), so the result is deterministic and no
// partial result goes to device memory.  A warp computes one position's G
// dot products with its lanes along dh (neighbouring lanes read
// neighbouring bytes); the value pass gives each thread one (head, dim)
// output and walks the chunk in order.  Only positions below the sequence's
// length are read, so a short sequence in a long cache costs only its
// length.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const int8_t* __restrict__ kq,
                        const float* __restrict__ ks,
                        const int8_t* __restrict__ vq,
                        const float* __restrict__ vs,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int S, int HKV, int G, int dh, float sm_scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                    // (G, dh)
  float* acc = q_s + G * dh;            // (G, dh)
  float* sc = acc + G * dh;             // (G, kChunk) scores, then probabilities
  float* m_s = sc + G * kChunk;         // (G,) running max
  float* l_s = m_s + G;                 // (G,) running sum
  float* alpha_s = l_s + G;             // (G,) rescale of this chunk

  const int b = blockIdx.x / HKV;
  const int h = blockIdx.x % HKV;
  const int H = HKV * G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long q_base = (static_cast<long long>(b) * H + h * G) * dh;

  for (int i = tid; i < G * dh; i += kThreads) {
    q_s[i] = to_f32(q[q_base + i]);
    acc[i] = 0.0f;
  }
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.0f;
  }
  __syncthreads();

  const int end = min(lengths[b], S);
  for (int s0 = 0; s0 < end; s0 += kChunk) {
    // scores: one warp per position, lanes along dh
    for (int c = warp; c < kChunk; c += kWarps) {
      const int s = s0 + c;
      if (s < end) {
        const long long row = (static_cast<long long>(b) * S + s) * HKV + h;
        const float k_scale = ks[row];
        const int8_t* kr = kq + row * dh;
        for (int g = 0; g < G; ++g) {
          float dot = 0.0f;
          for (int d = lane; d < dh; d += 32) {
            dot += q_s[g * dh + d] * (static_cast<float>(kr[d]) * k_scale);
          }
          for (int off = 16; off > 0; off >>= 1) {
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          }
          if (lane == 0) sc[g * kChunk + c] = dot * sm_scale;
        }
      } else if (lane == 0) {
        for (int g = 0; g < G; ++g) sc[g * kChunk + c] = kNegInf;
      }
    }
    __syncthreads();

    // online softmax update: one warp per query head
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int c = lane; c < kChunk; c += 32) mx = fmaxf(mx, sc[g * kChunk + c]);
      for (int off = 16; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float psum = 0.0f;
      for (int c = lane; c < kChunk; c += 32) {
        const float p = (s0 + c < end) ? expf(sc[g * kChunk + c] - m_new) : 0.0f;
        sc[g * kChunk + c] = p;
        psum += p;
      }
      for (int off = 16; off > 0; off >>= 1) {
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      }
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + psum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // value pass: one thread per (query head, dim), positions in order
    const int n = min(kChunk, end - s0);
    for (int i = tid; i < G * dh; i += kThreads) {
      const int g = i / dh;
      const int d = i % dh;
      float a = acc[i] * alpha_s[g];
      for (int c = 0; c < n; ++c) {
        const long long row = (static_cast<long long>(b) * S + s0 + c) * HKV + h;
        a += sc[g * kChunk + c] * (static_cast<float>(vq[row * dh + d]) * vs[row]);
      }
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * dh; i += kThreads) {
    store(out + q_base + i, acc[i] / fmaxf(l_s[i / dh], 1e-30f));
  }
}

}  // namespace

extern "C" int repro_decode_attention_smem_bytes(int G, int dh) {
  return static_cast<int>(sizeof(float) * (2 * G * dh + G * kChunk + 3 * G));
}

// q, out (B, H, dh); kq, vq (B, S, HKV, dh) s8; ks, vs (B, S, HKV) f32;
// lengths (B,) s32.  dtype: 0 = float32, 1 = bfloat16 (q and out).
// Returns cudaGetLastError().
extern "C" int repro_decode_attention(const void* q, const void* kq,
                                      const void* ks, const void* vq,
                                      const void* vs, const void* lengths,
                                      void* out, int B, int S, int HKV, int G,
                                      int dh, float sm_scale, int dtype,
                                      int device, void* stream) {
  cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = repro_decode_attention_smem_bytes(G, dh);
  const int8_t* k8 = static_cast<const int8_t*>(kq);
  const int8_t* v8 = static_cast<const int8_t*>(vq);
  const float* kscale = static_cast<const float*>(ks);
  const float* vscale = static_cast<const float*>(vs);
  const int* len = static_cast<const int*>(lengths);
  if (dtype == 1) {
    decode_attention_kernel<<<B * HKV, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(q), k8, kscale, v8, vscale, len,
        static_cast<__nv_bfloat16*>(out), S, HKV, G, dh, sm_scale);
  } else {
    decode_attention_kernel<<<B * HKV, kThreads, smem, s>>>(
        static_cast<const float*>(q), k8, kscale, v8, vscale, len,
        static_cast<float*>(out), S, HKV, G, dh, sm_scale);
  }
  return static_cast<int>(cudaGetLastError());
}
