// s8 x s8 -> s32 matmul with the dequantize epilogue fused (K3), and its
// per-expert grouped form (K7), on the H100's s8 tensor cores (sm_90a).
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
// with acc_e = a[e] @ b[e] (a (E,M,K), b (E,K,N), all row-major).  Both run
// one tile (gemm_tile) under their own kernel symbols, so a profile tells
// them apart; K3 is the E = 1 case without the expert offsets.
//
// What bounds them on the H100.  At decode (K3 at M = 16 and 64 live rows,
// K7 at 5 and 20 rows an expert) the weight matrix is read once and each
// weight byte feeds at most M multiply-adds: bytes bound, 0.1-5 us of
// traffic.  At prefill (K3 at M = 736 and 2944, K7 at 230 and 960 rows an
// expert) the products dominate: operations bound.  The design:
//
// * Tensor cores.  The s32 accumulator comes from
//   mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32.  A's fragments are
//   read with ldmatrix from A's tile, which is K-major as A is.  B arrives
//   (K, N) row-major and stays so in shared memory; each lane reads four
//   4-byte words of four consecutive K rows and transposes them as a 4x4
//   byte block with __byte_perm into four K-major words, the col-B operand
//   of four n8 fragments.  The fragments' columns are permuted for that:
//   lane group g holds physical columns 4g..4g+3 of a 32-column span, so
//   n8 fragment i, logical column g, is physical column 4g + i, and each
//   lane ends up with 8 contiguous output columns of its rows.  wgmma (the
//   Hopper form) would need B K-major in shared memory behind descriptors;
//   mma.sync keeps the transpose in registers and is what this file uses.
// * 16-byte asynchronous copies.  cp.async.cg fills a 4-stage ring, so the
//   copies of the next steps are in flight while this step's mma run; the
//   ragged M, N and K edges use the zero-fill form (source size 0).  Where
//   K or N is not a multiple of 16, or an operand is not 16-byte aligned,
//   the same kernel is instantiated with 1-byte loads (template VEC).  B's
//   rows are padded by 16 bytes and its 16-byte chunks XOR-swizzled by
//   bit 3 of the row, so the transposing reads are free of bank conflicts.
// * Two tile configurations, chosen by kernels/int8_matmul.py:plan:
//   small M (decode): BM = 16..64, BN = 64, BK = 128, 4 warps, two along
//   N and two along K (each warp takes every other 32-deep slice of a
//   stage, and the two partial sums are added in shared memory at the end);
//   large M (prefill): BM = BN = 128, BK = 64, 8 warps of 64 x 32, each B
//   fragment reused over 4 M fragments.  Measured on the H100
//   (tools/int8_tile_sweep.py), the large tile wins from M = 65 rows where
//   it has at least 66 output tiles (half the SMs): at 736 x 512 -> 2048
//   (96 tiles) it took 0.0127 ms against the small tile's 0.0204, at 736 x
//   1024 -> 1024 (48 tiles) 0.0177 against 0.0136.
// * Split-K without atomics at small M, where the output tiles cannot fill
//   the card (fewer than 66 small tiles, and deep enough blocks: 16 x 2048
//   -> 512 took 0.0063 ms in 8 slices, 0.0092 unsplit): blockIdx.z also
//   runs over S slices of K, each at least two BK steps deep; slice s writes its s32 partial tile to a workspace of
//   shape (S, E, M, N) that the wrapper allocates, and a second kernel
//   (int8_matmul[_batched]_reduce_kernel) sums the partials in ascending
//   slice order and runs the epilogue.  s32 addition is exact (127^2 * K
//   < 2^31 for K < 133,000), so the result is the same bit for bit as
//   without the split, and deterministic.  The wrappers count one launch
//   per call (LAUNCHES["int8_matmul"] / ["int8_matmul_batched"]) whether
//   or not the reduction runs; the reduction is not counted on its own.
//
// The epilogue runs in registers (or in the reduction kernel) in the
// reference's op order (src/repro/kernels/int8_matmul.py:50-57) with
// explicitly rounded intrinsics, so nvcc cannot contract it into FMAs:
// __int2float_rn(acc), __fsub_rn(v, __fmul_rn(zp, colsum)),
// __fmul_rn(__fmul_rn(v, a_scale), b_scale), __fadd_rn(v, bias), then the
// cast (__float2bfloat16_rn for bf16).  K7 has no zero point and no bias.
// A K3 activation scale given by value (a calibrated constant, not a
// tensor) is folded into the weight scale first, __fmul_rn(v,
// __fmul_rn(a_scale, b_scale)): the form the reference's jitted engine
// computes, where XLA folds the constant (tests/test_torch_jit_forms.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// tile configurations
// ---------------------------------------------------------------------------

template <int MF_, int WARPS_M_, int WARPS_N_, int WARPS_K_, int BK_,
          int STAGES_>
struct Tile {
  static constexpr int MF = MF_;             // m16 fragments of a warp
  static constexpr int WARPS_M = WARPS_M_;
  static constexpr int WARPS_N = WARPS_N_;
  static constexpr int WARPS_K = WARPS_K_;   // warps splitting each stage's K
  static constexpr int WM = 16 * MF;         // warp tile rows
  static constexpr int WN = 32;              // warp tile columns (4 x n8)
  static constexpr int BM = WM * WARPS_M;
  static constexpr int BN = WN * WARPS_N;
  static constexpr int BK = BK_;
  static constexpr int STAGES = STAGES_;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N * WARPS_K;
  static constexpr int LDA = BK + 16;        // A row stride in shared memory
  static constexpr int LDB = BN + 16;        // B row stride in shared memory
  static constexpr int A_BYTES = BM * LDA;
  static constexpr int STAGE_BYTES = A_BYTES + BK * LDB;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;
  static constexpr int K32_PER_WARP = BK / 32 / WARPS_K;
  static_assert(BN >= 64, "the B swizzle needs 4 chunks a row");
  static_assert(BK % (32 * WARPS_K) == 0, "stage depth per warp");
  static_assert((BM * BK / 16) % THREADS == 0, "A chunks per thread");
  static_assert((BK * BN / 16) % THREADS == 0, "B chunks per thread");
  static_assert((WARPS_K - 1) * WARPS_M * WARPS_N * MF * 16 * 32 * 4
                    <= SMEM_BYTES, "K-warp reduction space");
};

// small M (decode): BM = 16 * MF, BN = 64, BK = 128, 4 warps (2 N x 2 K)
template <int MF>
using Small = Tile<MF, 1, 2, 2, 128, 4>;
// large M (prefill): BM = BN = 128, BK = 64, 8 warps (2 M x 4 N) of 64 x 32
using Large = Tile<4, 2, 4, 1, 64, 4>;

struct Args {
  const int8_t* a;          // (E, M, K)
  const int8_t* b;          // (E, K, N)
  const float* a_scale;     // (E, M) when a_scale_per_row, else 1 or null
  float a_scale_value;      // used when a_scale is null
  int a_scale_per_row;
  const float* b_scale;     // (E, N)
  const float* colsum;      // (N,) when has_zp (K3 only)
  float zp;
  int has_zp;
  int fold_scale;           // acc * (a_scale * b_scale) (K3, scale by value)
  const float* bias;        // (N,) or null (K3 only)
  void* out;                // (E, M, N) float32 or bfloat16
  int out_dtype;            // 0 = float32, 1 = bfloat16
  int32_t* ws;              // (S, E, M, N) s32 partials when splits > 1
  int E, M, N, K;
  int splits, slice_k;      // slice s covers [s * slice_k, ...); the last to K
  int acc_only = 0;         // out is the (E, M, N) s32 sum, no epilogue
};

// ---------------------------------------------------------------------------
// PTX
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int32_t (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// w[j] holds bytes n = 0..3 of K row j; o[i] gets bytes k = 0..3 of column i
__device__ __forceinline__ void transpose4x4(const uint32_t (&w)[4],
                                             uint32_t (&o)[4]) {
  const uint32_t x0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t x1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t y0 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t y1 = __byte_perm(w[2], w[3], 0x7362);
  o[0] = __byte_perm(x0, y0, 0x5410);
  o[1] = __byte_perm(x0, y0, 0x7632);
  o[2] = __byte_perm(x1, y1, 0x5410);
  o[3] = __byte_perm(x1, y1, 0x7632);
}

// byte offset of 16-byte chunk `chunk` of K row `row` in B's stage tile
template <class T>
__device__ __forceinline__ int b_offset(int row, int chunk) {
  return row * T::LDB + ((chunk ^ (((row >> 3) & 1) << 1)) << 4);
}

// ---------------------------------------------------------------------------
// one pipeline stage: copies in, products out
// ---------------------------------------------------------------------------

template <class T, int VEC>
__device__ __forceinline__ void load_stage(uint8_t* sA, uint8_t* sB,
                                           const int8_t* __restrict__ a,
                                           const int8_t* __restrict__ b,
                                           int M, int N, int K, int m0, int n0,
                                           int k0, int k_end, int tid) {
  if constexpr (VEC == 16) {
    constexpr int A_CPR = T::BK / 16;
#pragma unroll
    for (int i = 0; i < T::BM * A_CPR / T::THREADS; ++i) {
      const int c = tid + i * T::THREADS;
      const int r = c / A_CPR, kc = c % A_CPR;
      const int gm = m0 + r, gk = k0 + kc * 16;
      const bool ok = gm < M && gk < k_end;
      cp_async16(smem_u32(sA + r * T::LDA + kc * 16),
                 ok ? a + static_cast<long long>(gm) * K + gk : a,
                 ok ? 16 : 0);
    }
    constexpr int B_CPR = T::BN / 16;
#pragma unroll
    for (int i = 0; i < T::BK * B_CPR / T::THREADS; ++i) {
      const int c = tid + i * T::THREADS;
      const int r = c / B_CPR, nc = c % B_CPR;
      const int gk = k0 + r, gn = n0 + nc * 16;
      const bool ok = gk < k_end && gn < N;
      cp_async16(smem_u32(sB + b_offset<T>(r, nc)),
                 ok ? b + static_cast<long long>(gk) * N + gn : b,
                 ok ? 16 : 0);
    }
  } else {
    // 1-byte loads for ragged or unaligned operands, into the same layout
    for (int i = tid; i < T::BM * T::BK; i += T::THREADS) {
      const int r = i / T::BK, c = i % T::BK;
      const int gm = m0 + r, gk = k0 + c;
      sA[r * T::LDA + c] = (gm < M && gk < k_end)
          ? static_cast<uint8_t>(a[static_cast<long long>(gm) * K + gk]) : 0;
    }
    for (int i = tid; i < T::BK * T::BN; i += T::THREADS) {
      const int r = i / T::BN, c = i % T::BN;
      const int gk = k0 + r, gn = n0 + c;
      sB[b_offset<T>(r, c >> 4) + (c & 15)] = (gk < k_end && gn < N)
          ? static_cast<uint8_t>(b[static_cast<long long>(gk) * N + gn]) : 0;
    }
  }
}

template <class T>
__device__ __forceinline__ void compute_stage(const uint8_t* sA,
                                              const uint8_t* sB,
                                              int32_t (&acc)[T::MF][4][4],
                                              int lane, int wm, int wn,
                                              int wk) {
  const int g = lane >> 2, t = lane & 3;
  // ldmatrix: lanes 8j..8j+7 address the rows of 8x16-byte matrix j
  const uint32_t a_base =
      smem_u32(sA) +
      (wm * T::WM + (lane & 7) + ((lane >> 3) & 1) * 8) * T::LDA +
      (lane >> 4) * 16;
  const int chunk = ((wn * T::WN) >> 4) + (g >> 2);
  const int word = (g & 3) << 2;
#pragma unroll
  for (int q = 0; q < T::K32_PER_WARP; ++q) {
    const int kk = (wk + q * T::WARPS_K) * 32;
    uint32_t af[T::MF][4];
#pragma unroll
    for (int mf = 0; mf < T::MF; ++mf)
      ldmatrix_x4(af[mf], a_base + mf * 16 * T::LDA + kk);
    uint32_t bf[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = kk + h * 16 + 4 * t + j;
        w[j] = *reinterpret_cast<const uint32_t*>(sB + b_offset<T>(r, chunk) +
                                                  word);
      }
      transpose4x4(w, bf[h]);
    }
#pragma unroll
    for (int mf = 0; mf < T::MF; ++mf)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mma_s8(acc[mf][i], af[mf], bf[0][i], bf[1][i]);
  }
}

// ---------------------------------------------------------------------------
// epilogue
// ---------------------------------------------------------------------------

__device__ __forceinline__ float row_scale(const Args& p, int e, int m) {
  return p.a_scale_per_row
             ? p.a_scale[static_cast<long long>(e) * p.M + m]
             : (p.a_scale ? p.a_scale[0] : p.a_scale_value);
}

__device__ __forceinline__ float dequant(const Args& p, int e, int n,
                                         int32_t acc, float as) {
  float v = __int2float_rn(acc);
  if (p.has_zp) v = __fsub_rn(v, __fmul_rn(p.zp, p.colsum[n]));
  const float bs = p.b_scale[static_cast<long long>(e) * p.N + n];
  v = p.fold_scale ? __fmul_rn(v, __fmul_rn(as, bs))
                   : __fmul_rn(__fmul_rn(v, as), bs);
  if (p.bias) v = __fadd_rn(v, p.bias[n]);
  return v;
}

// 8 contiguous columns n0..n0+7 of row m of expert e (slice s when split)
__device__ __forceinline__ void store_row(const Args& p, int e, int s, int m,
                                          int n0, const int32_t (&v)[8]) {
  const int N = p.N;
  const long long row = (static_cast<long long>(e) * p.M + m) * N;
  const bool full = n0 + 8 <= N;
  if (p.splits > 1 || p.acc_only) {
    int32_t* dst = p.ws + static_cast<long long>(s) * p.E * p.M * N + row + n0;
    if (full && N % 4 == 0) {
      reinterpret_cast<int4*>(dst)[0] = make_int4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<int4*>(dst)[1] = make_int4(v[4], v[5], v[6], v[7]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (n0 + i < N) dst[i] = v[i];
    }
    return;
  }
  const float as = row_scale(p, e, m);
  float o[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    o[i] = n0 + i < N ? dequant(p, e, n0 + i, v[i], as) : 0.0f;
  if (p.out_dtype == 1) {
    __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(p.out) + row + n0;
    if (full && N % 8 == 0) {
      __align__(16) __nv_bfloat16 h[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16_rn(o[i]);
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(h);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (n0 + i < N) dst[i] = __float2bfloat16_rn(o[i]);
    }
  } else {
    float* dst = static_cast<float*>(p.out) + row + n0;
    if (full && N % 4 == 0) {
      reinterpret_cast<float4*>(dst)[0] = make_float4(o[0], o[1], o[2], o[3]);
      reinterpret_cast<float4*>(dst)[1] = make_float4(o[4], o[5], o[6], o[7]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (n0 + i < N) dst[i] = o[i];
    }
  }
}

// ---------------------------------------------------------------------------
// the tile: grid (N / BN, M / BM, E * S)
// ---------------------------------------------------------------------------

template <class T, int VEC>
__device__ __forceinline__ void gemm_tile(const Args& p) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wn = warp % T::WARPS_N;
  const int wm = (warp / T::WARPS_N) % T::WARPS_M;
  const int wk = warp / (T::WARPS_N * T::WARPS_M);
  const int e = blockIdx.z / p.splits, s = blockIdx.z % p.splits;
  const int M = p.M, N = p.N, K = p.K;
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int k_begin = s * p.slice_k;
  const int k_end = s == p.splits - 1 ? K : k_begin + p.slice_k;
  const int n_steps = (k_end - k_begin + T::BK - 1) / T::BK;
  const int8_t* a = p.a + static_cast<long long>(e) * M * K;
  const int8_t* b = p.b + static_cast<long long>(e) * K * N;

  int32_t acc[T::MF][4][4];
#pragma unroll
  for (int mf = 0; mf < T::MF; ++mf)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mf][i][c] = 0;

#pragma unroll
  for (int st = 0; st < T::STAGES - 1; ++st) {
    if (st < n_steps)
      load_stage<T, VEC>(smem + st * T::STAGE_BYTES,
                         smem + st * T::STAGE_BYTES + T::A_BYTES, a, b, M, N,
                         K, m0, n0, k_begin + st * T::BK, k_end, tid);
    cp_async_commit();
  }
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<T::STAGES - 2>();
    __syncthreads();   // stage `step` landed; stage `step - 1` is free
    const int nxt = step + T::STAGES - 1;
    if (nxt < n_steps) {
      uint8_t* st = smem + (nxt % T::STAGES) * T::STAGE_BYTES;
      load_stage<T, VEC>(st, st + T::A_BYTES, a, b, M, N, K, m0, n0,
                         k_begin + nxt * T::BK, k_end, tid);
    }
    cp_async_commit();
    const uint8_t* st = smem + (step % T::STAGES) * T::STAGE_BYTES;
    compute_stage<T>(st, st + T::A_BYTES, acc, lane, wm, wn, wk);
  }
  cp_async_wait<0>();
  __syncthreads();

  if constexpr (T::WARPS_K > 1) {
    // the K warps' partial sums meet in shared memory (exact in s32)
    constexpr int PER = T::MF * 16;
    int32_t* red = reinterpret_cast<int32_t*>(smem);
    const int slot = wm * T::WARPS_N + wn;
    if (wk > 0) {
      int32_t* dst =
          red + ((wk - 1) * T::WARPS_M * T::WARPS_N + slot) * PER * 32 + lane;
#pragma unroll
      for (int mf = 0; mf < T::MF; ++mf)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            dst[((mf * 4 + i) * 4 + c) * 32] = acc[mf][i][c];
    }
    __syncthreads();
    if (wk > 0) return;
#pragma unroll
    for (int w = 1; w < T::WARPS_K; ++w) {
      const int32_t* src =
          red + ((w - 1) * T::WARPS_M * T::WARPS_N + slot) * PER * 32 + lane;
#pragma unroll
      for (int mf = 0; mf < T::MF; ++mf)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[mf][i][c] += src[((mf * 4 + i) * 4 + c) * 32];
    }
  }

  // lane (g, t): rows g and g + 8 of each m16 fragment, physical columns
  // 8t..8t+7 of the warp's span: n8 fragment i gives column 8t + i (c0, c2)
  // and 8t + 4 + i (c1, c3)
  const int g = lane >> 2, t = lane & 3;
  const int nb = n0 + wn * T::WN + 8 * t;
  if (nb >= N) return;
#pragma unroll
  for (int mf = 0; mf < T::MF; ++mf)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * T::WM + mf * 16 + g + 8 * h;
      if (m >= M) continue;
      int32_t v[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[i] = acc[mf][i][2 * h];
        v[4 + i] = acc[mf][i][2 * h + 1];
      }
      store_row(p, e, s, m, nb, v);
    }
}

// the sum of the S partials in ascending slice order, then the epilogue
__device__ __forceinline__ void reduce_partials(const Args& p) {
  const long long total = static_cast<long long>(p.E) * p.M * p.N;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += stride) {
    int32_t acc = 0;
    for (int s = 0; s < p.splits; ++s) acc += p.ws[s * total + i];
    if (p.acc_only) {
      static_cast<int32_t*>(p.out)[i] = acc;
      continue;
    }
    const int n = static_cast<int>(i % p.N);
    const long long em = i / p.N;
    const int m = static_cast<int>(em % p.M), e = static_cast<int>(em / p.M);
    const float v = dequant(p, e, n, acc, row_scale(p, e, m));
    if (p.out_dtype == 1)
      static_cast<__nv_bfloat16*>(p.out)[i] = __float2bfloat16_rn(v);
    else
      static_cast<float*>(p.out)[i] = v;
  }
}

template <class T, int VEC>
__global__ void __launch_bounds__(T::THREADS)
int8_matmul_kernel(const __grid_constant__ Args p) {
  gemm_tile<T, VEC>(p);
}

template <class T, int VEC>
__global__ void __launch_bounds__(T::THREADS)
int8_matmul_batched_kernel(const __grid_constant__ Args p) {
  gemm_tile<T, VEC>(p);
}

__global__ void int8_matmul_reduce_kernel(const __grid_constant__ Args p) {
  reduce_partials(p);
}

__global__ void int8_matmul_batched_reduce_kernel(
    const __grid_constant__ Args p) {
  reduce_partials(p);
}

constexpr int kReduceThreads = 256;
constexpr int kMaxDevices = 64;

template <class T, int VEC, bool BATCHED>
cudaError_t launch(const Args& p, int device, cudaStream_t stream) {
  auto kernel = BATCHED ? int8_matmul_batched_kernel<T, VEC>
                        : int8_matmul_kernel<T, VEC>;
  static bool configured[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
    if (err != cudaSuccess) return err;
    configured[device] = true;
  }
  const dim3 grid((p.N + T::BN - 1) / T::BN, (p.M + T::BM - 1) / T::BM,
                  p.E * p.splits);
  kernel<<<grid, T::THREADS, T::SMEM_BYTES, stream>>>(p);
  if (p.splits > 1) {
    const long long total = static_cast<long long>(p.E) * p.M * p.N;
    const long long want = (total + kReduceThreads - 1) / kReduceThreads;
    const int blocks = static_cast<int>(want < 65535 ? want : 65535);
    if (BATCHED)
      int8_matmul_batched_reduce_kernel<<<blocks, kReduceThreads, 0,
                                          stream>>>(p);
    else
      int8_matmul_reduce_kernel<<<blocks, kReduceThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

// bm picks the configuration: 16, 32, 48, 64 small (MF = bm / 16), 128 large
template <bool BATCHED>
int run(const Args& p, int bm, int device, cudaStream_t stream) {
  const int bk = bm == 128 ? Large::BK : Small<1>::BK;
  const bool bad_split =
      p.splits > 1 &&
      (p.ws == nullptr || p.slice_k <= 0 || p.slice_k % bk != 0 ||
       static_cast<long long>(p.splits - 1) * p.slice_k >= p.K);
  if (p.splits < 1 || p.E * static_cast<long long>(p.splits) > 65535 ||
      bad_split)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaSetDevice(device);
  const bool vec16 = p.K % 16 == 0 && p.N % 16 == 0 && aligned16(p.a) &&
                     aligned16(p.b);
  cudaError_t err;
#define REPRO_INT8_LAUNCH(T) \
  (vec16 ? launch<T, 16, BATCHED>(p, device, stream) \
         : launch<T, 1, BATCHED>(p, device, stream))
  switch (bm) {
    case 16: err = REPRO_INT8_LAUNCH(Small<1>); break;
    case 32: err = REPRO_INT8_LAUNCH(Small<2>); break;
    case 48: err = REPRO_INT8_LAUNCH(Small<3>); break;
    case 64: err = REPRO_INT8_LAUNCH(Small<4>); break;
    case 128: err = REPRO_INT8_LAUNCH(Large); break;
    default: err = cudaErrorInvalidValue;
  }
#undef REPRO_INT8_LAUNCH
  return static_cast<int>(err);
}

}  // namespace

// K3.  a (M,K) s8 and b (K,N) s8 row-major.  a_scale: (M,) f32 when
// a_scale_per_row, else one f32 at a_scale, or a_scale_value when a_scale is
// null (a constant, then folded into b_scale first: see the note).  b_scale
// (N,) f32; colsum (N,) f32 when has_zp; bias (N,) f32 or null.
// out_dtype: 0 = float32, 1 = bfloat16.  bm (16, 32, 48, 64 or 128) picks
// the tile configuration; splits > 1 splits K into slices of slice_k bytes
// (the last to K) with s32 partials in workspace (splits, M, N).  Returns
// cudaGetLastError() (or cudaErrorInvalidValue).
extern "C" int repro_int8_matmul(const void* a, const void* b,
                                 const void* a_scale, float a_scale_value,
                                 int a_scale_per_row, const void* b_scale,
                                 const void* colsum, float zp, int has_zp,
                                 const void* bias, void* out, int M, int N,
                                 int K, int out_dtype, int bm, int splits,
                                 int slice_k, void* workspace, int device,
                                 void* stream) {
  Args p{static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
         static_cast<const float*>(a_scale), a_scale_value, a_scale_per_row,
         static_cast<const float*>(b_scale), static_cast<const float*>(colsum),
         zp, has_zp, a_scale == nullptr && !a_scale_per_row,
         static_cast<const float*>(bias), out, out_dtype,
         static_cast<int32_t*>(workspace), 1, M, N, K, splits, slice_k};
  return run<false>(p, bm, device, static_cast<cudaStream_t>(stream));
}

// K3's first half, for a product split on K across ranks: acc (M,N) s32 =
// a (M,K) s8 @ b (K,N) s8, the tile without the epilogue.  bm, splits,
// slice_k as for K3; unsplit, the tile writes acc itself, split, the slices'
// partials go to workspace (splits, M, N) and the reduction writes their sum
// in ascending slice order.  Returns cudaGetLastError() (or
// cudaErrorInvalidValue).
extern "C" int repro_int8_matmul_accumulate(const void* a, const void* b,
                                            void* acc, int M, int N, int K,
                                            int bm, int splits, int slice_k,
                                            void* workspace, int device,
                                            void* stream) {
  Args p{static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
         nullptr, 0.0f, 0, nullptr, nullptr, 0.0f, 0, 0, nullptr, acc, 0,
         static_cast<int32_t*>(splits > 1 ? workspace : acc), 1, M, N, K,
         splits, slice_k, 1};
  return run<false>(p, bm, device, static_cast<cudaStream_t>(stream));
}

// K3's second half: out (M,N) = the K3 epilogue of acc (M,N) s32, exactly
// as the split K3's reduction computes it (one slice).  a_scale, b_scale,
// colsum, zp, bias and out_dtype as for K3.  Returns cudaGetLastError() (or
// cudaErrorInvalidValue).
extern "C" int repro_int8_matmul_epilogue(const void* acc,
                                          const void* a_scale,
                                          float a_scale_value,
                                          int a_scale_per_row,
                                          const void* b_scale,
                                          const void* colsum, float zp,
                                          int has_zp, const void* bias,
                                          void* out, int M, int N,
                                          int out_dtype, int device,
                                          void* stream) {
  if (M < 0 || N < 0) return static_cast<int>(cudaErrorInvalidValue);
  Args p{nullptr, nullptr, static_cast<const float*>(a_scale), a_scale_value,
         a_scale_per_row, static_cast<const float*>(b_scale),
         static_cast<const float*>(colsum), zp, has_zp,
         a_scale == nullptr && !a_scale_per_row,
         static_cast<const float*>(bias), out, out_dtype,
         const_cast<int32_t*>(static_cast<const int32_t*>(acc)), 1, M, N, 0,
         1, 0};
  cudaSetDevice(device);
  const long long total = static_cast<long long>(M) * N;
  const long long want = (total + kReduceThreads - 1) / kReduceThreads;
  const int blocks = static_cast<int>(want < 65535 ? want : 65535);
  if (blocks > 0)
    int8_matmul_reduce_kernel<<<blocks, kReduceThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// K7.  a (E,M,K) s8, b (E,K,N) s8, out (E,M,N), all row-major.  a_scale:
// (E,M) f32 when a_scale_per_row, else one f32 for every expert at a_scale,
// or a_scale_value when a_scale is null.  b_scale (E,N) f32.  E * splits
// <= 65535.  out_dtype, bm, splits, slice_k and workspace (splits, E, M, N)
// as for K3.  Returns cudaGetLastError() (or cudaErrorInvalidValue).
extern "C" int repro_int8_matmul_batched(const void* a, const void* b,
                                         const void* a_scale,
                                         float a_scale_value,
                                         int a_scale_per_row,
                                         const void* b_scale, void* out,
                                         int E, int M, int N, int K,
                                         int out_dtype, int bm, int splits,
                                         int slice_k, void* workspace,
                                         int device, void* stream) {
  Args p{static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
         static_cast<const float*>(a_scale), a_scale_value, a_scale_per_row,
         static_cast<const float*>(b_scale), nullptr, 0.0f, 0, 0, nullptr, out,
         out_dtype, static_cast<int32_t*>(workspace), E, M, N, K, splits,
         slice_k};
  return run<true>(p, bm, device, static_cast<cudaStream_t>(stream));
}
