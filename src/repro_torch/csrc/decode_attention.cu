// Flash-decode attention over an INT8 KV cache, contiguous (K4) and paged
// (K5), for Hopper (sm_90a).
//
// K4 replaces src/repro/kernels/decode_attention.py:decode_attention_pallas.
// K5 replaces src/repro/kernels/decode_attention.py:
// decode_attention_paged_pallas (its single-page grid and the multi-page
// variant for page_size < 8, which exists only to fill the TPU's 8-row
// sublane tile and has no counterpart here: K5 takes any page size).
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
//
// The two kernels share one body, a template on the position → cache-row
// mapping: K4 reads row b's position s at b * S + s; K5 loads its row of
// the block table into shared memory once (entries clamped into the pool,
// so a sentinel reads page P - 1 and is masked by the length) and reads
// position s at page tab[s / ps], offset s % ps.  Chunking and summation
// order are the same, so K5 on a paged cache equals K4 on the linearized
// cache bit for bit.  K5 reads exactly the pages a row's length reaches,
// in place, with no linearized copy.

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

// shared memory of the body: the chunk's cache rows (int64), then floats
__host__ __device__ constexpr int body_smem_bytes(int G, int dh) {
  return static_cast<int>(sizeof(long long) * kChunk +
                          sizeof(float) * (2 * G * dh + G * kChunk + 3 * G));
}

// position s of sequence b → index of its (token, kv head) cache row
struct ContiguousRows {
  long long base;  // b * S
  int HKV, h;
  __device__ __forceinline__ long long operator()(int s) const {
    return (base + s) * HKV + h;
  }
};

struct PagedRows {
  const int* tab;  // the row's block table in shared memory, clamped
  int ps, HKV, h;
  __device__ __forceinline__ long long operator()(int s) const {
    return (static_cast<long long>(tab[s / ps]) * ps + s % ps) * HKV + h;
  }
};

template <typename T, typename Rows>
__device__ __forceinline__ void attend(
    const T* __restrict__ q, const int8_t* __restrict__ kq,
    const float* __restrict__ ks, const int8_t* __restrict__ vq,
    const float* __restrict__ vs, T* __restrict__ out, int b, int h, int HKV,
    int G, int dh, float sm_scale, int end, Rows rows,
    unsigned char* smem) {
  long long* rows_s = reinterpret_cast<long long*>(smem);  // (kChunk,)
  float* q_s = reinterpret_cast<float*>(rows_s + kChunk);  // (G, dh)
  float* acc = q_s + G * dh;            // (G, dh)
  float* sc = acc + G * dh;             // (G, kChunk) scores, then probabilities
  float* m_s = sc + G * kChunk;         // (G,) running max
  float* l_s = m_s + G;                 // (G,) running sum
  float* alpha_s = l_s + G;             // (G,) rescale of this chunk

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

  for (int s0 = 0; s0 < end; s0 += kChunk) {
    // scores: one warp per position, lanes along dh
    for (int c = warp; c < kChunk; c += kWarps) {
      const int s = s0 + c;
      if (s < end) {
        const long long row = rows(s);
        if (lane == 0) rows_s[c] = row;
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
        const long long row = rows_s[c];
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const int8_t* __restrict__ kq,
                        const float* __restrict__ ks,
                        const int8_t* __restrict__ vq,
                        const float* __restrict__ vs,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int S, int HKV, int G, int dh, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / HKV;
  const int h = blockIdx.x % HKV;
  attend(q, kq, ks, vq, vs, out, b, h, HKV, G, dh, sm_scale,
         min(lengths[b], S),
         ContiguousRows{static_cast<long long>(b) * S, HKV, h}, smem);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_paged_kernel(const T* __restrict__ q,
                              const int8_t* __restrict__ kq,
                              const float* __restrict__ ks,
                              const int8_t* __restrict__ vq,
                              const float* __restrict__ vs,
                              const int* __restrict__ tables,
                              const int* __restrict__ lengths,
                              T* __restrict__ out, int P, int ps, int maxP,
                              int HKV, int G, int dh, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / HKV;
  const int h = blockIdx.x % HKV;
  int* tab = reinterpret_cast<int*>(smem + body_smem_bytes(G, dh));
  const int* row_tab = tables + static_cast<long long>(b) * maxP;
  for (int i = threadIdx.x; i < maxP; i += kThreads) {
    tab[i] = min(max(row_tab[i], 0), P - 1);
  }
  __syncthreads();
  attend(q, kq, ks, vq, vs, out, b, h, HKV, G, dh, sm_scale,
         min(lengths[b], maxP * ps), PagedRows{tab, ps, HKV, h}, smem);
}

}  // namespace

extern "C" int repro_decode_attention_smem_bytes(int G, int dh) {
  return body_smem_bytes(G, dh);
}

extern "C" int repro_decode_attention_paged_smem_bytes(int G, int dh,
                                                       int maxP) {
  return body_smem_bytes(G, dh) + static_cast<int>(sizeof(int)) * maxP;
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

// q, out (B, H, dh); kq, vq (P, ps, HKV, dh) s8 page pool; ks, vs
// (P, ps, HKV) f32; tables (B, maxP) s32 page ids (sentinel P = unreserved,
// clamped to P - 1); lengths (B,) s32.  dtype as above.
// Returns cudaGetLastError().
extern "C" int repro_decode_attention_paged(
    const void* q, const void* kq, const void* ks, const void* vq,
    const void* vs, const void* tables, const void* lengths, void* out, int B,
    int P, int ps, int maxP, int HKV, int G, int dh, float sm_scale,
    int dtype, int device, void* stream) {
  cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = repro_decode_attention_paged_smem_bytes(G, dh, maxP);
  const int8_t* k8 = static_cast<const int8_t*>(kq);
  const int8_t* v8 = static_cast<const int8_t*>(vq);
  const float* kscale = static_cast<const float*>(ks);
  const float* vscale = static_cast<const float*>(vs);
  const int* tab = static_cast<const int*>(tables);
  const int* len = static_cast<const int*>(lengths);
  if (dtype == 1) {
    decode_attention_paged_kernel<<<B * HKV, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(q), k8, kscale, v8, vscale, tab, len,
        static_cast<__nv_bfloat16*>(out), P, ps, maxP, HKV, G, dh, sm_scale);
  } else {
    decode_attention_paged_kernel<<<B * HKV, kThreads, smem, s>>>(
        static_cast<const float*>(q), k8, kscale, v8, vscale, tab, len,
        static_cast<float*>(out), P, ps, maxP, HKV, G, dh, sm_scale);
  }
  return static_cast<int>(cudaGetLastError());
}
