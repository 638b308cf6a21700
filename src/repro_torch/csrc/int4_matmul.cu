// s8 activations x block-wise INT4 weights (packed nibbles, per-group scale
// and min) -> f32/bf16, with the dequantize epilogue fused (K6), on the
// H100's s8 tensor cores (sm_90a).
//
// Replaces src/repro/kernels/int4_matmul.py:int4_matmul_pallas.
//
//   real(b)[k, n] = nib[k, n] * scale[g, n] + vmin[g, n]      (g = k / G)
//   out[m, n] = ((sum_g (float(d_g) * scale[g, n] + float(r_g) * vmin[g, n])
//                 - zp * colsum[n]) * a_scale[m] + bias[n])   cast to out dtype
//
// with d_g = sum_{k in g} a[m, k] * nib[k, n] and r_g = sum_{k in g} a[m, k],
// both exact in s32 (|d_g| <= 127 * 15 * G and |r_g| <= 127 * G, below 2^31
// for any G under 2^20), and the sum over g taken in f32 in ascending g.
//
// What bounds it on the H100.  The INT4 path launches K6 only at decode
// widths (M = 16 and 64 live rows; 512 -> 512, 512 -> 2048, 2048 -> 512):
// the packed weights (128-512 KB) are read once and each weight byte feeds
// 2 M multiply-adds, so the bytes bound is 0.05-0.26 us and the kernel is
// bound by latency: the serial chain of copies and products in one block,
// and the launches.  The design (the tile of csrc/int8_matmul.cu):
//
// * Tensor cores.  Each group's s32 dot comes from
//   mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32; A's fragments are read
//   with ldmatrix from A's K-major tile, as in K3.
// * The nibble transpose.  B stays packed in shared memory, (K/2, N)
//   row-major as it arrives: a stage holds BK/2 packed rows, half of K3's B
//   bytes.  For the col-B operand each lane reads two 4-byte words, packed
//   rows r and r + 1 at four columns, splits them into the four K rows
//   2r..2r+3 with w & 0x0F0F0F0F and (w >> 4) & 0x0F0F0F0F (codes 0..15 are
//   valid s8 operands), and transposes those as a 4x4 byte block with
//   __byte_perm into four K-major words, one per column.  The unpacked
//   weights exist only in registers.  The n8 fragments take K3's permuted
//   columns, so each lane ends up with 8 contiguous output columns.  With a
//   packed row stride of BN + 16 bytes the four packed rows a warp reads at
//   once (2 apart) start 8 banks apart, so the reads are free of bank
//   conflicts without K3's swizzle.
// * The row sums come from one more mma per k32 step, of the A fragments
//   against a fragment of ones: each lane then holds its own rows' sums,
//   with no shuffle at the group's end.
// * The group flush.  After each group's last k32 step a lane turns its s32
//   dots and row sums into f32 terms, t = __fadd_rn(__fmul_rn(
//   __int2float_rn(d), s), __fmul_rn(__int2float_rn(r), mn)), and adds
//   them into an f32 accumulator in ascending g: the reference's op order
//   (src/repro/kernels/int4_matmul.py:70-77), rounded op by op, so nvcc
//   cannot contract it into FMAs.  The scales and mins (f16 or f32) of the
//   groups that end in a stage travel with its operands, through the same
//   asynchronous copies into the stage's shared memory.
// * Groups of any even size.  In shared memory each group is laid out
//   zero-padded to Gp = 32 * ceil(G / 32) K rows (a "virtual" K), so no
//   m16n8k32 step straddles two groups; the padding adds nothing to the
//   dot or the row sum.  Activations past K (up to n_groups * G) load as
//   zero.
// * 16-byte asynchronous copies (cp.async.cg, zero-fill form at the edges)
//   into a 4-stage ring, so the next stages' copies are in flight while a
//   stage's products run.  At decode a block has 2 or 4 warps and one warp
//   per SM sub-partition, so every instruction of the copies' address
//   arithmetic is on the critical path: where G is a multiple of 32 virtual
//   rows are real rows, and the copies take no division (issuing a stage's
//   copies took 0.55 us on the H100 while each 16-byte chunk's row was
//   found by a runtime integer division).  Where G
//   is not a multiple of 32, K or N not of 16, or an operand is not 16-byte
//   aligned, the same kernel is instantiated with element loads (template
//   VEC = 1), which map padded rows to real ones by division.
// * One configuration, tiled over M (kernels/int4_matmul.py:plan): BM = 16,
//   32 or 64 rows, BN = 64 columns, BK = 128 virtual K rows a stage; 2
//   warps side by side on N, and for BM = 32 or 64 two warps on M (4 warps,
//   each 16 or 32 rows by 32 columns).  No warp splits a stage's K: the f32
//   group sums would have to meet at every group end.
// * A group-ordered split of K.  s32 partials add exactly, but the f32
//   combine over groups does not: a split therefore cuts only at group
//   boundaries, blockIdx.z runs over slices of whole groups, and each slice
//   writes its groups' f32 terms t_g to a workspace (n_groups, M, N) that the
//   wrapper allocates.  A second kernel (int4_matmul_reduce_kernel) sums
//   them in ascending g from 0 and runs the epilogue: exactly the serial
//   order, so the result is the same bit for bit as without the split, and
//   deterministic, with no atomics.  The wrapper counts one launch per call
//   (LAUNCHES["int4_matmul"]) whether or not the reduction runs.
//
// The epilogue (or the reduction kernel) then applies the zero point,
// a_scale (per row, one tensor, or by value) and the bias in the
// reference's op order with rounded intrinsics, and casts
// (__float2bfloat16_rn for bf16).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (tools/int4_ab.py and
// tools/int8_tile_sweep.py, bf16 out, G = 128, f16 scales, warm L2): at
// the six decode shapes 0.0062-0.0078 ms a call, one group a slice, against
// 0.0184-0.0703 ms for the earlier __dp4a tile with byte loads, and
// 0.86-1.22x K3's time at the same shape.  A block still pays about 0.8 us
// a group in series (16 x 2048 -> 512 unsplit: 0.0190 ms), twice K3's cost
// of a stage, which is why the plan splits down to one group a slice.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// the tile
// ---------------------------------------------------------------------------

template <int MF_, int WARPS_M_>
struct Tile {
  static constexpr int MF = MF_;             // m16 fragments of a warp
  static constexpr int WARPS_M = WARPS_M_;
  static constexpr int WARPS_N = 2;
  static constexpr int WM = 16 * MF;         // warp tile rows
  static constexpr int WN = 32;              // warp tile columns (4 x n8)
  static constexpr int BM = WM * WARPS_M;
  static constexpr int BN = WN * WARPS_N;
  static constexpr int BK = 128;             // virtual K rows a stage
  static constexpr int K32 = BK / 32;        // k32 steps a stage
  static constexpr int STAGES = 4;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int LDA = BK + 16;        // A row stride in shared memory
  static constexpr int LDB = BN + 16;        // packed B row stride
  static constexpr int A_BYTES = BM * LDA;
  static constexpr int B_BYTES = (BK / 2) * LDB;
  // the scales and mins of the (at most BK / 32) groups that end in a
  // stage, f32 or f16 as stored: slot j, array 0 (scale) or 1 (min)
  static constexpr int S_ROW = BN * 4;
  static constexpr int S_BYTES = (BK / 32) * 2 * S_ROW;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES + S_BYTES;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;
  static_assert((BM * BK / 16) % THREADS == 0, "A chunks per thread");
  static_assert((BK / 2 * BN / 16) % THREADS == 0, "B chunks per thread");
};

// bm = 16: 2 warps on N; 32 and 64: 2 on M x 2 on N, 16 or 32 rows each
using Tile16 = Tile<1, 1>;
using Tile32 = Tile<1, 2>;
using Tile64 = Tile<2, 2>;

struct Args {
  const int8_t* a;          // (M, K)
  const uint8_t* b;         // (n_groups * G / 2, N) packed nibbles
  const float* a_scale;     // (M,) when a_scale_per_row, else 1 or null
  float a_scale_value;      // used when a_scale is null
  int a_scale_per_row;
  const void* b_scale;      // (n_groups, N) f32 or f16
  const void* b_min;        // (n_groups, N), b_scale's type
  int scale_f16;
  const float* colsum;      // (N,) when has_zp
  float zp;
  int has_zp;
  const float* bias;        // (N,) or null
  void* out;                // (M, N) float32 or bfloat16
  int out_dtype;            // 0 = float32, 1 = bfloat16
  float* ws;                // (n_groups, M, N) f32 group terms when split
  int M, N, K, n_groups, G;
  int Gp;                   // G rounded up to a multiple of 32
  int splits, groups_per_slice;
};

// ---------------------------------------------------------------------------
// PTX (as in csrc/int8_matmul.cu)
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

// p0, p1: bytes n = 0..3 of packed rows r and r + 1 (K rows 2r..2r+3);
// o[i] gets the codes of K rows 2r..2r+3 of column i, lowest K first
__device__ __forceinline__ void unpack_transpose(uint32_t p0, uint32_t p1,
                                                 uint32_t (&o)[4]) {
  const uint32_t w0 = p0 & 0x0F0F0F0Fu;           // K row 2r
  const uint32_t w1 = (p0 >> 4) & 0x0F0F0F0Fu;    // 2r + 1
  const uint32_t w2 = p1 & 0x0F0F0F0Fu;           // 2r + 2
  const uint32_t w3 = (p1 >> 4) & 0x0F0F0F0Fu;    // 2r + 3
  const uint32_t x0 = __byte_perm(w0, w1, 0x5140);
  const uint32_t x1 = __byte_perm(w0, w1, 0x7362);
  const uint32_t y0 = __byte_perm(w2, w3, 0x5140);
  const uint32_t y1 = __byte_perm(w2, w3, 0x7362);
  o[0] = __byte_perm(x0, y0, 0x5410);
  o[1] = __byte_perm(x0, y0, 0x7632);
  o[2] = __byte_perm(x1, y1, 0x5410);
  o[3] = __byte_perm(x1, y1, 0x7632);
}

// ---------------------------------------------------------------------------
// one pipeline stage of copies: virtual K rows [v0, v0 + BK) of the slice
// that starts at group g0 and ends before group g1
// ---------------------------------------------------------------------------

// The groups that end in a stage: local groups [g, ...) whose last virtual
// row falls in it, found by walking group ends (no division: the stages are
// loaded in order).
struct GroupCursor {
  int g = 0;      // the next local group to end
  int end;        // its end (exclusive), in virtual rows of the slice
};

template <class T, int VEC>
__device__ __forceinline__ void load_stage(uint8_t* sA, uint8_t* sB,
                                           uint8_t* sS, const Args& p, int m0,
                                           int n0, int g0, int n_local,
                                           int v0, GroupCursor& cur,
                                           int tid) {
  const int M = p.M, N = p.N, K = p.K, G = p.G, Gp = p.Gp;
  const int glo = cur.g;
  while (cur.g < n_local && cur.end <= v0 + T::BK) {
    ++cur.g;
    cur.end += Gp;
  }
  const int n_end = cur.g - glo;             // groups ending in this stage
  if constexpr (VEC == 16) {
    // G % 32 == 0: virtual rows are real rows, [k0, k0 + n_local * G)
    const int k0 = g0 * G + v0;
    const int k_slice = (g0 + n_local) * G;
    constexpr int A_CPR = T::BK / 16;
#pragma unroll
    for (int i = 0; i < T::BM * A_CPR / T::THREADS; ++i) {
      const int c = tid + i * T::THREADS;
      const int r = c / A_CPR, k = k0 + (c % A_CPR) * 16;
      const int gm = m0 + r;
      const bool ok = gm < M && k < K && k < k_slice;
      cp_async16(smem_u32(sA + r * T::LDA + (c % A_CPR) * 16),
                 ok ? p.a + static_cast<long long>(gm) * K + k : p.a,
                 ok ? 16 : 0);
    }
    constexpr int B_CPR = T::BN / 16;
#pragma unroll
    for (int i = 0; i < T::BK / 2 * B_CPR / T::THREADS; ++i) {
      const int c = tid + i * T::THREADS;
      const int r = c / B_CPR, nc = c % B_CPR;
      const int k = k0 + 2 * r, gn = n0 + nc * 16;
      const bool ok = k < k_slice && gn < N;
      cp_async16(smem_u32(sB + r * T::LDB + nc * 16),
                 ok ? p.b + static_cast<long long>(k >> 1) * N + gn : p.b,
                 ok ? 16 : 0);
    }
    // scales and mins of the groups ending here: 16-byte chunks of BN
    // columns, 8 (f16) or 16 (f32) a row, two rows a group
    const int cpr_log = p.scale_f16 ? 3 : 4;
    for (int c = tid; c < n_end << (cpr_log + 1); c += T::THREADS) {
      const int row = c >> cpr_log, cc = c & ((1 << cpr_log) - 1);
      const int gn = n0 + (cc << (6 - cpr_log));      // 8 or 4 columns
      const bool ok = gn < N;
      const long long e = static_cast<long long>(g0 + glo + (row >> 1)) * N
                          + gn;
      const uint8_t* src = static_cast<const uint8_t*>(
          (row & 1) ? p.b_min : p.b_scale) + (e << (cpr_log - 2));
      cp_async16(smem_u32(sS + row * T::S_ROW + cc * 16),
                 ok ? src : static_cast<const uint8_t*>(p.b_scale),
                 ok ? 16 : 0);
    }
  } else {
    // element loads for any even G and ragged or unaligned operands: each
    // group laid out zero-padded to Gp rows
    for (int i = tid; i < T::BM * T::BK; i += T::THREADS) {
      const int r = i / T::BK, c = i % T::BK, v = v0 + c;
      const int g = v / Gp, o = v % Gp, k = (g0 + g) * G + o;
      const int gm = m0 + r;
      sA[r * T::LDA + c] = (gm < M && g < n_local && o < G && k < K)
          ? static_cast<uint8_t>(p.a[static_cast<long long>(gm) * K + k]) : 0;
    }
    for (int i = tid; i < T::BK / 2 * T::BN; i += T::THREADS) {
      const int r = i / T::BN, c = i % T::BN, v = v0 + 2 * r;
      const int g = v / Gp, o = v % Gp;
      const int gn = n0 + c;
      sB[r * T::LDB + c] = (g < n_local && o < G && gn < N)
          ? p.b[static_cast<long long>(((g0 + g) * G + o) / 2) * N + gn] : 0;
    }
    const int esz = p.scale_f16 ? 2 : 4;
    for (int i = tid; i < n_end * 2 * T::BN; i += T::THREADS) {
      const int row = i / T::BN, c = i % T::BN;
      const int gn = n0 + c;
      const long long e = static_cast<long long>(g0 + glo + (row >> 1)) * N
                          + gn;
      const void* base = (row & 1) ? p.b_min : p.b_scale;
      uint8_t* dst = sS + row * T::S_ROW + c * esz;
      if (p.scale_f16)
        *reinterpret_cast<uint16_t*>(dst) =
            gn < N ? static_cast<const uint16_t*>(base)[e] : 0;
      else
        *reinterpret_cast<uint32_t*>(dst) =
            gn < N ? static_cast<const uint32_t*>(base)[e] : 0;
    }
  }
}

// ---------------------------------------------------------------------------
// scales, epilogue, stores
// ---------------------------------------------------------------------------

// 8 consecutive values at a 16-byte aligned shared row, f16 or f32
__device__ __forceinline__ void load8(const uint8_t* src, int f16,
                                      float (&v)[8]) {
  if (f16) {
    const uint4 u = *reinterpret_cast<const uint4*>(src);
    const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
    const float4 x = reinterpret_cast<const float4*>(src)[0];
    const float4 y = reinterpret_cast<const float4*>(src)[1];
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
  }
}

__device__ __forceinline__ float row_scale(const Args& p, int m) {
  return p.a_scale_per_row ? p.a_scale[m]
                           : (p.a_scale ? p.a_scale[0] : p.a_scale_value);
}

__device__ __forceinline__ float dequant(const Args& p, int n, float v,
                                         float as) {
  if (p.has_zp) v = __fsub_rn(v, __fmul_rn(p.zp, p.colsum[n]));
  v = __fmul_rn(v, as);
  if (p.bias) v = __fadd_rn(v, p.bias[n]);
  return v;
}

// 8 contiguous f32 values at dst[0..7], the first `n` of them
__device__ __forceinline__ void store8(float* dst, const float (&v)[8],
                                       int n, bool vec) {
  if (n >= 8 && vec) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < n) dst[i] = v[i];
  }
}

// the epilogue of row m at the 8 columns nb..nb+7
__device__ __forceinline__ void store_row(const Args& p, int m, int nb,
                                          const float (&acc)[8]) {
  const int N = p.N;
  const long long row = static_cast<long long>(m) * N;
  const float as = row_scale(p, m);
  float o[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    o[i] = nb + i < N ? dequant(p, nb + i, acc[i], as) : 0.0f;
  if (p.out_dtype == 1) {
    __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(p.out) + row + nb;
    if (nb + 8 <= N && N % 8 == 0) {
      __align__(16) __nv_bfloat16 h[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16_rn(o[i]);
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(h);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (nb + i < N) dst[i] = __float2bfloat16_rn(o[i]);
    }
  } else {
    store8(static_cast<float*>(p.out) + row + nb, o, N - nb, N % 4 == 0);
  }
}

// ---------------------------------------------------------------------------
// the kernel: grid (N / BN, M / BM, splits)
// ---------------------------------------------------------------------------

template <class T, int VEC>
__global__ void __launch_bounds__(T::THREADS)
int4_matmul_kernel(const __grid_constant__ Args p) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wn = warp % T::WARPS_N, wm = warp / T::WARPS_N;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int g0 = blockIdx.z * p.groups_per_slice;
  const int n_local = min(p.n_groups - g0, p.groups_per_slice);
  const int k32_per_group = p.Gp / 32;
  const int total_k32 = n_local * k32_per_group;
  const int n_steps = (total_k32 + T::K32 - 1) / T::K32;
  const int nb = n0 + wn * T::WN + 8 * t;     // the lane's 8 columns

  // ldmatrix: lanes 8j..8j+7 address the rows of 8x16-byte matrix j
  const int a_row = wm * T::WM + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 16;
  // the lane's 4 columns of B: wn * 32 + 4g .. + 3
  const int b_col = wn * T::WN + 4 * g;

  int32_t acc[T::MF][4][4];
  int32_t rs[T::MF][4];        // A x ones: rows g (c0, c1) and g + 8 (c2, c3)
  float accf[T::MF][2][8];
#pragma unroll
  for (int mf = 0; mf < T::MF; ++mf) {
#pragma unroll
    for (int c = 0; c < 4; ++c) rs[mf][c] = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 8; ++c) accf[mf][h][c] = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mf][i][c] = 0;
  }
  const int s_col = (nb - n0) * (p.scale_f16 ? 2 : 4);

  GroupCursor cur;
  cur.end = p.Gp;
#pragma unroll
  for (int st = 0; st < T::STAGES - 1; ++st) {
    if (st < n_steps)
      load_stage<T, VEC>(smem + st * T::STAGE_BYTES,
                         smem + st * T::STAGE_BYTES + T::A_BYTES,
                         smem + st * T::STAGE_BYTES + T::A_BYTES + T::B_BYTES,
                         p, m0, n0, g0, n_local, st * T::BK, cur, tid);
    cp_async_commit();
  }
  int grp = g0, left = k32_per_group;
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<T::STAGES - 2>();
    __syncthreads();   // stage `step` landed; stage `step - 1` is free
    const int nxt = step + T::STAGES - 1;
    if (nxt < n_steps) {
      uint8_t* st = smem + (nxt % T::STAGES) * T::STAGE_BYTES;
      load_stage<T, VEC>(st, st + T::A_BYTES, st + T::A_BYTES + T::B_BYTES,
                         p, m0, n0, g0, n_local, nxt * T::BK, cur, tid);
    }
    cp_async_commit();
    const uint8_t* sA = smem + (step % T::STAGES) * T::STAGE_BYTES;
    const uint8_t* sB = sA + T::A_BYTES;
    const uint8_t* sS = sB + T::B_BYTES;
    int slot = 0;                           // groups flushed in this stage
    const uint32_t a_base = smem_u32(sA) + a_row * T::LDA + a_col;
#pragma unroll
    for (int q = 0; q < T::K32; ++q) {
      if (step * T::K32 + q >= total_k32) break;   // past the slice's end
      uint32_t af[T::MF][4];
#pragma unroll
      for (int mf = 0; mf < T::MF; ++mf) {
        ldmatrix_x4(af[mf], a_base + mf * 16 * T::LDA + q * 32);
        // the row sums: one more product, against a fragment of ones
        mma_s8(rs[mf], af[mf], 0x01010101u, 0x01010101u);
      }
      // col-B fragments: K rows 4t..4t+3 (h = 0) and 16 + 4t.. (h = 1) of
      // the step, i.e. packed rows q * 16 + 8h + 2t and the next
      uint32_t bf[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint8_t* src = sB + (q * 16 + 8 * h + 2 * t) * T::LDB + b_col;
        unpack_transpose(*reinterpret_cast<const uint32_t*>(src),
                         *reinterpret_cast<const uint32_t*>(src + T::LDB),
                         bf[h]);
      }
#pragma unroll
      for (int mf = 0; mf < T::MF; ++mf)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          mma_s8(acc[mf][i], af[mf], bf[0][i], bf[1][i]);

      if (--left > 0) continue;
      // the group's end: its f32 terms, added in ascending groups (or
      // written to the workspace when K is split)
      float sc[8], mn[8];
      const uint8_t* srow = sS + slot * 2 * T::S_ROW + s_col;
      load8(srow, p.scale_f16, sc);
      load8(srow + T::S_ROW, p.scale_f16, mn);
#pragma unroll
      for (int mf = 0; mf < T::MF; ++mf)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float rf = __int2float_rn(rs[mf][2 * h]);
          // n8 fragment i: column nb + i (c0, c2) and nb + 4 + i (c1, c3)
          float tv[8];
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int d = acc[mf][c & 3][2 * h + (c >> 2)];
            tv[c] = __fadd_rn(__fmul_rn(__int2float_rn(d), sc[c]),
                              __fmul_rn(rf, mn[c]));
          }
          if (p.splits > 1) {
            const int m = m0 + wm * T::WM + mf * 16 + g + 8 * h;
            if (m < p.M && nb < p.N)
              store8(p.ws + (static_cast<long long>(grp) * p.M + m) * p.N + nb,
                     tv, p.N - nb, p.N % 4 == 0);
          } else {
#pragma unroll
            for (int c = 0; c < 8; ++c)
              accf[mf][h][c] = __fadd_rn(accf[mf][h][c], tv[c]);
          }
        }
#pragma unroll
      for (int mf = 0; mf < T::MF; ++mf)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mf][i][c] = rs[mf][i] = 0;
      ++grp;
      ++slot;
      left = k32_per_group;
    }
  }
  cp_async_wait<0>();

  if (p.splits > 1 || nb >= p.N) return;
#pragma unroll
  for (int mf = 0; mf < T::MF; ++mf)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * T::WM + mf * 16 + g + 8 * h;
      if (m < p.M) store_row(p, m, nb, accf[mf][h]);
    }
}

// the group terms summed in ascending g from 0, then the epilogue
__global__ void int4_matmul_reduce_kernel(const __grid_constant__ Args p) {
  const long long total = static_cast<long long>(p.M) * p.N;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += stride) {
    float acc = 0.0f;
    for (int g = 0; g < p.n_groups; ++g)
      acc = __fadd_rn(acc, p.ws[g * total + i]);
    const int n = static_cast<int>(i % p.N), m = static_cast<int>(i / p.N);
    const float v = dequant(p, n, acc, row_scale(p, m));
    if (p.out_dtype == 1)
      static_cast<__nv_bfloat16*>(p.out)[i] = __float2bfloat16_rn(v);
    else
      static_cast<float*>(p.out)[i] = v;
  }
}

constexpr int kReduceThreads = 256;
constexpr int kMaxDevices = 64;

template <class T, int VEC>
cudaError_t launch(const Args& p, int device, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        int4_matmul_kernel<T, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
    if (err != cudaSuccess) return err;
    configured[device] = true;
  }
  const dim3 grid((p.N + T::BN - 1) / T::BN, (p.M + T::BM - 1) / T::BM,
                  p.splits);
  int4_matmul_kernel<T, VEC><<<grid, T::THREADS, T::SMEM_BYTES, stream>>>(p);
  if (p.splits > 1) {
    const long long total = static_cast<long long>(p.M) * p.N;
    const long long want = (total + kReduceThreads - 1) / kReduceThreads;
    const int blocks = static_cast<int>(want < 65535 ? want : 65535);
    int4_matmul_reduce_kernel<<<blocks, kReduceThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

// a (M,K) s8 row-major; b (n_groups*G/2, N) packed nibbles row-major;
// b_scale and b_min (n_groups, N), f32 (scale_dtype 0) or f16 (1).  K <=
// n_groups * G, G even.  a_scale: (M,) f32 when a_scale_per_row, else one
// f32 at a_scale, or a_scale_value when a_scale is null.  colsum (N,) f32
// when has_zp; bias (N,) f32 or null.  out_dtype: 0 = float32, 1 =
// bfloat16.  bm (16, 32 or 64) picks the tile; splits > 1 cuts the groups
// into slices of groups_per_slice (the last to n_groups), with the f32
// group terms in workspace (n_groups, M, N).  Returns cudaGetLastError()
// (or cudaErrorInvalidValue).
extern "C" int repro_int4_matmul(const void* a, const void* b,
                                 const void* a_scale, float a_scale_value,
                                 int a_scale_per_row, const void* b_scale,
                                 const void* b_min, int scale_dtype,
                                 const void* colsum, float zp, int has_zp,
                                 const void* bias, void* out, int M, int N,
                                 int K, int n_groups, int group_size,
                                 int out_dtype, int bm, int splits,
                                 int groups_per_slice, void* workspace,
                                 int device, void* stream) {
  const int G = group_size;
  const bool bad_split =
      splits < 1 || splits > 65535 || groups_per_slice < 1 ||
      static_cast<long long>(splits) * groups_per_slice < n_groups ||
      (splits > 1 &&
       (workspace == nullptr ||
        static_cast<long long>(splits - 1) * groups_per_slice >= n_groups));
  if (G < 2 || G % 2 || G >= (1 << 20) || K > n_groups * G || bad_split)
    return static_cast<int>(cudaErrorInvalidValue);
  Args p{static_cast<const int8_t*>(a), static_cast<const uint8_t*>(b),
         static_cast<const float*>(a_scale), a_scale_value, a_scale_per_row,
         b_scale, b_min, scale_dtype == 1,
         static_cast<const float*>(colsum), zp, has_zp,
         static_cast<const float*>(bias), out, out_dtype,
         static_cast<float*>(workspace), M, N, K, n_groups, G,
         32 * ((G + 31) / 32), splits, groups_per_slice};
  cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec16 = G % 32 == 0 && K % 16 == 0 && N % 16 == 0 &&
                     aligned16(a) && aligned16(b) && aligned16(b_scale) &&
                     aligned16(b_min);
  cudaError_t err;
#define REPRO_INT4_LAUNCH(T) \
  (vec16 ? launch<T, 16>(p, device, s) : launch<T, 1>(p, device, s))
  switch (bm) {
    case 16: err = REPRO_INT4_LAUNCH(Tile16); break;
    case 32: err = REPRO_INT4_LAUNCH(Tile32); break;
    case 64: err = REPRO_INT4_LAUNCH(Tile64); break;
    default: err = cudaErrorInvalidValue;
  }
#undef REPRO_INT4_LAUNCH
  return static_cast<int>(err);
}
