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
// registers.  Positions at or past lengths[b] are masked (zero
// probabilities); G = H / HKV query heads share each kv head.
//
// Bound on the H100: bytes.  Each cached token is read once (2 * dh int8 +
// two f32 scales per kv head) and costs 4 * G * dh flops, a few flops per
// byte.  At decode shapes the work is tiny (a few hundred KB), so what
// bounds a block is latency: dependent loads, serial chains, barriers.
//
// Design.  The sequence is cut into chunks of kChunk positions (32, a
// compile-time constant set once by tools/decode_attention_sweep.py), and
// a chunk is one warp's work from its copies to its partial, with no block
// barrier inside it.  A block of W warps serves one (sequence, kv head,
// tile of up to GMAX query heads); warp w takes the block's chunks w,
// w + W, ...:
//   * copies: the chunk's K rows, V rows and scales go to the warp's own
//     shared-memory ring of 2 stages by cp.async, 16 bytes a copy for the
//     rows and 4 for the scales; the warp's next chunk is in flight while
//     it computes this one (a third stage never paid in the sweep).  K5
//     reads each row in place from its page through the block table (shift
//     and mask where the page size is a power of two, a division
//     otherwise).
//   * scores: a dot product q_g · k_c is split into 4 parts of dh / 4, one
//     a lane; q's part stays in registers (a lane has one or two heads), the
//     K part is read as 16-byte words (4-byte words at dh 80, whose 20-byte
//     parts are only 4-byte aligned) and converted exactly by byte permute
//     (no I2F), once for the lane's heads; the parts are summed by two
//     shuffles, (p0 + p1) + (p2 + p3).
//   * the chunk's softmax with its own (local) max m_i: p = exp(s - m_i),
//     l_i = sum p (a fixed shuffle tree); p * v_scale goes to shared memory.
//   * values: lanes along dh (16 lanes a row, dh / 16 dims a lane; at dh 80
//     a lane's 5 bytes are read one at a time), the two half-warps over
//     alternate positions in order, summed by one shuffle: the chunk's
//     accumulator acc_i, kept as the chunk's partial.
//   * fold, in ascending chunk order from chunk 0, always with one formula:
//     M' = max(M, m_i); A = A e^(M - M') + acc_i e^(m_i - M'); likewise L.
//     Unsplit, the block folds each round of W chunks after one barrier.
// A chunk's partial depends only on its positions, and the fold's order
// only on the chunk index, so neither the split nor the warps per block
// change a bit: a row's result does not depend on its batch or on the
// plan, and K5 on a paged cache equals K4 on the linearized cache bit for
// bit.
//
// Split (the plan's choice, kernels/decode_attention.py:plan): a thread
// block cluster of `split` (1, 2, 4 or 8) blocks per (sequence, kv head,
// head tile); rank r computes chunks r, r + split, ... and keeps each
// chunk's partial in its shared memory.  After a cluster barrier each rank
// gathers every chunk's max and sum through distributed shared memory,
// computes the fold's factors once a head (a prefix-max scan: a max is
// exact in any order, so they are fold()'s own), and folds a slice of the
// (head, dim) outputs over all chunks in ascending order with fold()'s
// multiply-adds.  No atomics, no workspace, one launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#ifndef REPRO_DA_CHUNK
#define REPRO_DA_CHUNK 32
#endif

// The build compiles this file as two units in parallel, each with the
// kernels of one query dtype: REPRO_DA_UNIT 0 holds the float kernels and
// the entry points, 1 the bfloat16 kernels behind one C launcher (the
// kernels' instantiations are most of the build's time).
#if !defined(REPRO_DA_UNIT) || (REPRO_DA_UNIT != 0 && REPRO_DA_UNIT != 1)
#error "compile with -DREPRO_DA_UNIT=0 and =1 (kernels/build.py: UNITS)"
#endif

namespace {

constexpr int kChunk = REPRO_DA_CHUNK;  // positions of a chunk (a warp's)
constexpr int kMaxWarps = 8;
constexpr int kStages = 2;        // chunks of a warp's copy ring
constexpr int kMaxSplit = 8;      // portable cluster size
constexpr int kMaxSmem = 232448;  // opt-in shared memory of a block (H100)
constexpr float kNegInf = -1e30f;
static_assert(kChunk == 16 || kChunk == 32, "chunk of 16 or 32 positions");

// query heads of one block: GMAX * dh <= 512 keeps the registers in bounds
__host__ __device__ constexpr int gmax(int DH) { return DH <= 64 ? 8 : 4; }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// PTX
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// byte i of w (an int8) as an exact float: 0x4B0000uu is 2^23 + uu with
// uu = int8 + 128, so subtracting 2^23 + 128 leaves the int8
template <int I>
__device__ __forceinline__ float s8_at(uint32_t flipped) {
  return __uint_as_float(__byte_perm(flipped, 0x4B000000u, 0x7650 + I)) -
         8388736.0f;
}

// ---------------------------------------------------------------------------
// shapes and shared memory
// ---------------------------------------------------------------------------

// one chunk in a warp's ring: K rows (C, DH) s8, V rows (C, DH) s8,
// ks (C,), vs (C,) f32
__host__ __device__ constexpr int chunk_bytes(int DH) {
  return 2 * kChunk * DH + 8 * kChunk;
}

__host__ __device__ constexpr int align16(int n) { return (n + 15) & ~15; }

// floats of one chunk's partial: acc (GP, DH), m (GP), l (GP)
__host__ __device__ constexpr int slot_floats(int GP, int DH) {
  return GP * DH + 2 * GP;
}

struct Layout {
  int pv, parts, fold, tab, total;
};

// byte offsets: the warps' rings (W, kStages, chunk), the warps' p * vs
// (W, GP, C), the chunk partials (unsplit: two rounds of W; split: the
// rank's chunks), the split's fold factors and sums (3, GP, chunks), the
// block table (maxP,)
__host__ __device__ inline Layout layout(int DH, int GP, int W, int split,
                                         int slots_n, int n_chunks,
                                         int maxP) {
  Layout L;
  L.pv = W * kStages * chunk_bytes(DH);
  L.parts = L.pv + align16(4 * W * GP * kChunk);
  const int slots = split > 1 ? slots_n : 2 * W;
  L.fold = L.parts + align16(4 * slots * slot_floats(GP, DH));
  L.tab = L.fold + (split > 1 ? align16(4 * 3 * GP * n_chunks) : 0);
  L.total = L.tab + align16(4 * maxP);
  return L;
}

int chunks_of(int S) { return (S + kChunk - 1) / kChunk; }

int padded_heads(int Gt) { return Gt <= 1 ? 1 : Gt <= 2 ? 2 : Gt <= 4 ? 4 : 8; }

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
  int ps, shift, HKV, h;  // shift < 0: page size not a power of two
  __device__ __forceinline__ long long operator()(int s) const {
    int page, off;
    if (shift >= 0) {
      page = s >> shift;
      off = s & (ps - 1);
    } else {
      page = s / ps;
      off = s - page * ps;
    }
    return (static_cast<long long>(tab[page]) * ps + off) * HKV + h;
  }
};

struct Args {
  const void* q;
  const int8_t* kq;
  const float* ks;
  const int8_t* vq;
  const float* vs;
  const int* tables;  // K5 only
  const int* lengths;
  void* out;
  int S;        // K4: cache capacity; K5: maxP * ps
  int P, ps, shift, maxP;  // K5 only
  int HKV, G, gtile, n_gtiles;
  float sm_scale;
  int split, warps, slots_n;
  Layout L;
};

// one warp's copies of a chunk: rows and scales of positions [s0, s0 + n)
template <int DH, typename Rows>
__device__ __forceinline__ void copy_chunk(const Args& a, unsigned char* st,
                                            int s0, int n, int lane,
                                            const Rows& rows) {
  constexpr int WPR = DH / 16;  // 16-byte copies a row
  for (int i = lane; i < n * WPR; i += 32) {
    const int c = i / WPR;
    const int w = i % WPR;
    const long long src = rows(s0 + c) * DH + w * 16;
    cp_async16(st + c * DH + w * 16, a.kq + src);
    cp_async16(st + kChunk * DH + c * DH + w * 16, a.vq + src);
  }
  float* scales = reinterpret_cast<float*>(st + 2 * kChunk * DH);
  for (int c = lane; c < n; c += 32) {
    const long long row = rows(s0 + c);
    cp_async4(scales + c, a.ks + row);
    cp_async4(scales + kChunk + c, a.vs + row);
  }
}

// one lane's part of the dot products of GH heads: q (GH, DH / 4 floats) ·
// k (DH / 4 int8 as words, each converted once), four accumulators a head
// in a fixed order
template <int DH, int GH>
__device__ __forceinline__ void part_dots(const float (&qr)[GH][DH / 4],
                                          const unsigned char* k,
                                          float (&dot)[GH]) {
  constexpr int NW = DH / 16;  // 4-byte words of the part
  uint32_t w[NW];
  if constexpr (NW % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NW / 4; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(k)[i];
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
  } else if constexpr (NW == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(k);
    w[0] = v.x;
    w[1] = v.y;
  } else {
    // one word, or dh 80's five: a 20-byte part is 4-byte aligned only
#pragma unroll
    for (int i = 0; i < NW; ++i) w[i] = reinterpret_cast<const uint32_t*>(k)[i];
  }
  float acc[GH][4];
#pragma unroll
  for (int h = 0; h < GH; ++h)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[h][r] = 0.0f;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint32_t f = w[i] ^ 0x80808080u;
    const float k0 = s8_at<0>(f), k1 = s8_at<1>(f), k2 = s8_at<2>(f),
                k3 = s8_at<3>(f);
#pragma unroll
    for (int h = 0; h < GH; ++h) {
      acc[h][0] = fmaf(qr[h][4 * i], k0, acc[h][0]);
      acc[h][1] = fmaf(qr[h][4 * i + 1], k1, acc[h][1]);
      acc[h][2] = fmaf(qr[h][4 * i + 2], k2, acc[h][2]);
      acc[h][3] = fmaf(qr[h][4 * i + 3], k3, acc[h][3]);
    }
  }
#pragma unroll
  for (int h = 0; h < GH; ++h)
    dot[h] = (acc[h][0] + acc[h][1]) + (acc[h][2] + acc[h][3]);
}

// a lane's DPL int8 of a V row (DPL = DH / 16) as floats
template <int DPL>
__device__ __forceinline__ void load_v(const unsigned char* p,
                                       float (&v)[DPL]) {
  if constexpr (DPL % 4 == 0) {
#pragma unroll
    for (int i = 0; i < DPL / 4; ++i) {
      const uint32_t f =
          reinterpret_cast<const uint32_t*>(p)[i] ^ 0x80808080u;
      v[4 * i] = s8_at<0>(f);
      v[4 * i + 1] = s8_at<1>(f);
      v[4 * i + 2] = s8_at<2>(f);
      v[4 * i + 3] = s8_at<3>(f);
    }
  } else if constexpr (DPL == 2) {
    const uint32_t f =
        static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p)) ^ 0x8080u;
    v[0] = s8_at<0>(f);
    v[1] = s8_at<1>(f);
  } else {
    // one byte, or dh 80's five at an odd offset: a byte at a time (exact)
#pragma unroll
    for (int u = 0; u < DPL; ++u)
      v[u] = static_cast<float>(reinterpret_cast<const int8_t*>(p)[u]);
  }
}

// the fold of one chunk's partial (m, l, acc) into the running (M, L, A),
// in one fixed form (no contraction choices left to the compiler)
__device__ __forceinline__ void fold(float& M, float& L, float& A, float m,
                                     float l, float acc) {
  const float Mn = fmaxf(M, m);
  const float x = expf(M - Mn);
  const float y = expf(m - Mn);
  A = __fmaf_rn(acc, y, __fmul_rn(A, x));
  L = __fmaf_rn(l, y, __fmul_rn(L, x));
  M = Mn;
}

// ---------------------------------------------------------------------------
// one warp's chunk: positions [s0, s0 + n) from its ring stage `st` to the
// chunk's partial `slot` (acc (GP, DH), m (GP), l (GP))
// ---------------------------------------------------------------------------

// the scores' lane layout: lane (head group, position group, part j) holds
// GH heads, positions group + NCG i, and part j of dh
template <int GP>
struct ScoreLanes {
  static constexpr int GH = GP >= 2 ? 2 : 1;    // heads of a lane
  static constexpr int NCG = 8 * GH / GP;       // position groups
};

template <int DH, int GP>
__device__ __forceinline__ void chunk_partial(
    const unsigned char* st, int n,
    const float (&qr)[ScoreLanes<GP>::GH][DH / 4], float sm_scale, float* pv,
    float* slot, int lane) {
  constexpr int C = kChunk;
  constexpr int GH = ScoreLanes<GP>::GH;
  constexpr int NCG = ScoreLanes<GP>::NCG;
  constexpr int NPL = C / NCG;      // positions of a lane in the scores
  constexpr int DPL = DH / 16;      // value dims of a lane
  const unsigned char* K = st;
  const unsigned char* V = st + C * DH;
  const float* ks = reinterpret_cast<const float*>(st + 2 * C * DH);
  const float* vs = ks + C;

  // scores: lane (heads g0..g0+GH-1, position group, j) computes part j of
  // q_g · k_c for c = group + NCG i
  const int j = lane & 3;
  const int grp = (lane >> 2) % NCG;
  const int g0 = (lane >> 2) / NCG * GH;
  float s[NPL][GH];
  float mx[GH];
#pragma unroll
  for (int h = 0; h < GH; ++h) mx[h] = kNegInf;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int c = grp + NCG * i;
    // (a stale row past n gives a finite dot that the select below drops)
    float dot[GH];
    part_dots<DH, GH>(qr, K + c * DH + j * (DH / 4), dot);
#pragma unroll
    for (int h = 0; h < GH; ++h) {
      dot[h] += __shfl_xor_sync(0xffffffffu, dot[h], 1);
      dot[h] += __shfl_xor_sync(0xffffffffu, dot[h], 2);
      s[i][h] = c < n ? (dot[h] * ks[c]) * sm_scale : kNegInf;
      mx[h] = fmaxf(mx[h], s[i][h]);
    }
  }
  // the chunk's max and sum of each head: a fixed tree over the groups
#pragma unroll
  for (int h = 0; h < GH; ++h) {
#pragma unroll
    for (int off = 4; off < 4 * NCG; off <<= 1)
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], off));
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int c = grp + NCG * i;
      const float p = c < n ? expf(s[i][h] - mx[h]) : 0.0f;
      sum += p;
      if (j == 0) pv[(g0 + h) * C + c] = c < n ? p * vs[c] : 0.0f;
    }
#pragma unroll
    for (int off = 4; off < 4 * NCG; off <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (j == 0 && grp == 0) {
      slot[GP * DH + g0 + h] = mx[h];
      slot[GP * DH + GP + g0 + h] = sum;
    }
  }
  __syncwarp();

  // values: half-warp h takes positions h, h + 2, ... in order, lanes along
  // dh; the halves are summed by one shuffle
  const int half = lane >> 4;
  const int dl = lane & 15;
  float acc[GP][DPL];
#pragma unroll
  for (int gg = 0; gg < GP; ++gg)
#pragma unroll
    for (int u = 0; u < DPL; ++u) acc[gg][u] = 0.0f;
#pragma unroll
  // (no guard for positions past n: their weight is 0 and any byte is a
  // finite int8, so they add exactly nothing, and the loads can be hoisted)
  for (int i = 0; i < C / 2; ++i) {
    const int c = half + 2 * i;
    float v[DPL];
    load_v<DPL>(V + c * DH + dl * DPL, v);
#pragma unroll
    for (int gg = 0; gg < GP; ++gg) {
      const float w = pv[gg * C + c];
#pragma unroll
      for (int u = 0; u < DPL; ++u) acc[gg][u] = fmaf(w, v[u], acc[gg][u]);
    }
  }
#pragma unroll
  for (int gg = 0; gg < GP; ++gg)
#pragma unroll
    for (int u = 0; u < DPL; ++u)
      acc[gg][u] += __shfl_xor_sync(0xffffffffu, acc[gg][u], 16);
  if (half == 0) {
#pragma unroll
    for (int gg = 0; gg < GP; ++gg)
#pragma unroll
      for (int u = 0; u < DPL; ++u) slot[gg * DH + dl * DPL + u] = acc[gg][u];
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// the body shared by K4 and K5
// ---------------------------------------------------------------------------

template <typename T, int DH, int GP, typename Rows>
__device__ __forceinline__ void attend(const Args& a, int b, int h, int g0,
                                       int end, const Rows& rows, int rank,
                                       unsigned char* smem) {
  constexpr int C = kChunk;
  constexpr int E = GP * DH;                     // outputs of the block
  constexpr int EPT = (E + 63) / 64;             // of a thread (W >= 2)
  constexpr int SF = slot_floats(GP, DH);
  constexpr int CB = chunk_bytes(DH);

  const int W = a.warps;
  const int NT = 32 * W;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G = a.G;
  const int Gt = min(a.gtile, G - g0);
  const int H = a.HKV * G;
  const int split = a.split;

  unsigned char* ring = smem + warp * kStages * CB;
  float* pv = reinterpret_cast<float*>(smem + a.L.pv) + warp * GP * C;
  float* parts = reinterpret_cast<float*>(smem + a.L.parts);

  // this rank's chunks: t -> chunk rank + t * split; warp w takes t = w,
  // w + W, ...
  const int n_chunks = (end + C - 1) / C;
  const int mine = rank < n_chunks ? (n_chunks - rank + split - 1) / split : 0;
  auto start_of = [&](int t) { return (rank + t * split) * C; };

  // prologue: the warp's first chunk in flight
  if (warp < mine) {
    const int s0 = start_of(warp);
    copy_chunk<DH>(a, ring, s0, min(C, end - s0), lane, rows);
  }
  cp_async_commit();

  // q's part of this lane: heads (lane / 4) / NCG * GH + h, dims
  // [j DH/4, ...)
  constexpr int GH = ScoreLanes<GP>::GH;
  float qr[GH][DH / 4];
#pragma unroll
  for (int hh = 0; hh < GH; ++hh) {
    const int gq = (lane >> 2) / ScoreLanes<GP>::NCG * GH + hh;
    const bool real = gq < Gt;  // heads past Gt pad the tile to GP
    const T* q = static_cast<const T*>(a.q) +
                 (static_cast<long long>(b) * H + h * G + g0 +
                  (real ? gq : 0)) * DH + (lane & 3) * (DH / 4);
#pragma unroll
    for (int i = 0; i < DH / 4; ++i) qr[hh][i] = real ? to_f32(q[i]) : 0.0f;
  }

  // running state of this thread's outputs e = tid + kk * NT (unsplit)
  float Mr[EPT], Lr[EPT], Ar[EPT];
#pragma unroll
  for (int kk = 0; kk < EPT; ++kk) {
    Mr[kk] = kNegInf;
    Lr[kk] = 0.0f;
    Ar[kk] = 0.0f;
  }

  const int rounds = (mine + W - 1) / W;
  for (int k = 0; k < rounds; ++k) {
    const int t = warp + k * W;
    if (t < mine) {
      // the warp's next chunk in flight while this one computes
      const int tn = t + W;
      if (tn < mine) {
        const int s0 = start_of(tn);
        copy_chunk<DH>(a, ring + ((k + 1) % kStages) * CB, s0,
                        min(C, end - s0), lane, rows);
      }
      cp_async_commit();
      cp_async_wait<kStages - 1>();
      __syncwarp();
      const int s0 = start_of(t);
      float* slot = split > 1 ? parts + t * SF
                              : parts + ((k & 1) * W + warp) * SF;
      chunk_partial<DH, GP>(ring + (k % kStages) * CB, min(C, end - s0), qr,
                            a.sm_scale, pv, slot, lane);
    }
    if (split == 1) {
      // fold the round's chunks, W k .. W k + W - 1, in ascending order
      // (the partials alternate between two sets of W slots, so one barrier
      // a round keeps the next round's writes off the set being folded)
      __syncthreads();
      const float* round = parts + (k & 1) * W * SF;
      const int nw = min(W, mine - k * W);
      for (int w = 0; w < nw; ++w) {
        const float* sl = round + w * SF;
#pragma unroll
        for (int kk = 0; kk < EPT; ++kk) {
          const int e = tid + kk * NT;
          if (e < E) {
            const int g = e / DH;
            fold(Mr[kk], Lr[kk], Ar[kk], sl[E + g], sl[E + GP + g], sl[e]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  T* out = static_cast<T*>(a.out) +
           (static_cast<long long>(b) * H + h * G + g0) * DH;
  if (split == 1) {
#pragma unroll
    for (int kk = 0; kk < EPT; ++kk) {
      const int e = tid + kk * NT;
      if (e < Gt * DH) store(out + e, Ar[kk] / fmaxf(Lr[kk], 1e-30f));
    }
    return;
  }

  // the cluster's fold, in three steps.  1: every chunk's (m, l) of every
  // head, from the rank that made it, into local shared memory.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int ls = __ffs(split) - 1;  // split is a power of two
  auto partial = [&](int ci) {
    return cluster.map_shared_rank(parts, ci & (split - 1)) + (ci >> ls) * SF;
  };
  float* X = reinterpret_cast<float*>(smem + a.L.fold);  // (GP, n_chunks)
  float* Y = X + GP * n_chunks;                          // (GP, n_chunks)
  float* Lk = Y + GP * n_chunks;                         // (GP, n_chunks)
  // (RB remote reads in flight before their stores: the compiler cannot
  // tell a remote pointer from the local stores)
  constexpr int RB = 16;
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    for (int k0 = tid; k0 < n_chunks; k0 += RB * NT) {
      float m[RB], l[RB];
#pragma unroll
      for (int u = 0; u < RB; ++u) {
        const int k = k0 + u * NT;
        if (k < n_chunks) {
          const float* sl = partial(k) + E + g;
          m[u] = sl[0];
          l[u] = sl[GP];
        }
      }
#pragma unroll
      for (int u = 0; u < RB; ++u) {
        const int k = k0 + u * NT;
        if (k < n_chunks) {
          X[g * n_chunks + k] = m[u];
          Lk[g * n_chunks + k] = l[u];
        }
      }
    }
  }
  __syncthreads();

  // 2: fold()'s factors x_k = e^(M_{k-1} - M_k) and y_k = e^(m_k - M_k),
  // M_k the running max of the chunk maxima (a max is exact in any order),
  // once per head: warp w takes heads w, w + W, ..., its lanes contiguous
  // runs of chunks, a shuffle scan for the max before each run
  {
    const int per = (n_chunks + 31) / 32;
    const int k0 = min(n_chunks, lane * per);
    const int k1 = min(n_chunks, k0 + per);
    for (int g = warp; g < GP; g += W) {
      float* Xg = X + g * n_chunks;
      float run = kNegInf;
      for (int k = k0; k < k1; ++k) run = fmaxf(run, Xg[k]);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, run, off);
        if (lane >= off) run = fmaxf(run, t);
      }
      float M = __shfl_up_sync(0xffffffffu, run, 1);
      if (lane == 0) M = kNegInf;
      for (int k = k0; k < k1; ++k) {
        const float m = Xg[k];
        const float Mn = fmaxf(M, m);
        Xg[k] = expf(M - Mn);
        Y[g * n_chunks + k] = expf(m - Mn);
        M = Mn;
      }
    }
  }

  // 3: rank r folds a slice of the outputs, A_k = A_{k-1} x_k + acc_k y_k
  // and likewise L, in ascending k as fold() does; the slice's acc values
  // come through distributed shared memory in batches into the warps'
  // rings, free now: threads along the slice (a power of two of them) and
  // along the chunks
  const int slice = (Gt * DH + split - 1) >> ls;
  const int e0 = rank * slice;
  const int ne = max(0, min(Gt * DH, e0 + slice) - e0);
  float* abuf = reinterpret_cast<float*>(smem);
  const int bk = max(1, a.L.pv / (4 * max(ne, 1)));  // chunks a batch
  const int lj = min(ne <= 1 ? 0 : 32 - __clz(ne - 1), __ffs(NT) - 1);
  const int jt = tid & ((1 << lj) - 1);
  const int kt = tid >> lj;
  const int kstep = NT >> lj;
  for (int c0 = 0; c0 < n_chunks; c0 += bk) {
    const int nb = min(bk, n_chunks - c0);
    __syncthreads();  // the scan (first batch) or the last batch is done
    for (int j = jt; j < ne; j += 1 << lj) {
      for (int k0 = kt; k0 < nb; k0 += RB * kstep) {
        float v[RB];
#pragma unroll
        for (int u = 0; u < RB; ++u) {
          const int k = k0 + u * kstep;
          if (k < nb) v[u] = partial(c0 + k)[e0 + j];
        }
#pragma unroll
        for (int u = 0; u < RB; ++u) {
          const int k = k0 + u * kstep;
          if (k < nb) abuf[k * ne + j] = v[u];
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < EPT; ++kk) {
      const int j = tid + kk * NT;
      if (j < ne) {
        const int g = (e0 + j) / DH;
        const float* Xg = X + g * n_chunks + c0;
        const float* Yg = Y + g * n_chunks + c0;
        const float* Lg = Lk + g * n_chunks + c0;
#pragma unroll 8
        for (int k = 0; k < nb; ++k) {
          Ar[kk] = __fmaf_rn(abuf[k * ne + j], Yg[k], __fmul_rn(Ar[kk], Xg[k]));
          Lr[kk] = __fmaf_rn(Lg[k], Yg[k], __fmul_rn(Lr[kk], Xg[k]));
        }
      }
    }
  }
#pragma unroll
  for (int kk = 0; kk < EPT; ++kk) {
    const int j = tid + kk * NT;
    if (j < ne) store(out + e0 + j, Ar[kk] / fmaxf(Lr[kk], 1e-30f));
  }
  // no rank leaves (and frees its shared memory) before every read is done
  cluster.sync();
}

// the block's (sequence, kv head, head tile) and rank
struct Where {
  int b, h, g0, rank;
};

__device__ __forceinline__ Where where(const Args& a) {
  const int pair = blockIdx.x / a.split;
  const int gt = pair % a.n_gtiles;
  const int bh = pair / a.n_gtiles;
  return {bh / a.HKV, bh % a.HKV, gt * a.gtile,
          static_cast<int>(blockIdx.x % a.split)};
}

template <typename T, int DH, int GP>
__global__ void __launch_bounds__(32 * kMaxWarps)
decode_attention_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Where w = where(a);
  attend<T, DH, GP>(a, w.b, w.h, w.g0, max(0, min(a.lengths[w.b], a.S)),
                    ContiguousRows{static_cast<long long>(w.b) * a.S, a.HKV,
                                   w.h},
                    w.rank, smem);
}

template <typename T, int DH, int GP>
__global__ void __launch_bounds__(32 * kMaxWarps)
decode_attention_paged_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Where w = where(a);
  int* tab = reinterpret_cast<int*>(smem + a.L.tab);
  const int* row_tab = a.tables + static_cast<long long>(w.b) * a.maxP;
  for (int i = threadIdx.x; i < a.maxP; i += blockDim.x)
    tab[i] = min(max(row_tab[i], 0), a.P - 1);
  __syncthreads();
  attend<T, DH, GP>(a, w.b, w.h, w.g0, max(0, min(a.lengths[w.b], a.S)),
                    PagedRows{tab, a.ps, a.shift, a.HKV, w.h}, w.rank, smem);
}

constexpr int kMaxDevices = 64;

template <typename Kernel>
cudaError_t launch(Kernel kernel, bool* configured, const Args& a, int grid,
                   int device, cudaStream_t stream) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    configured[device] = true;
  }
  if (a.split == 1) {
    kernel<<<grid, 32 * a.warps, a.L.total, stream>>>(a);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid * a.split);
  cfg.blockDim = dim3(32 * a.warps);
  cfg.dynamicSmemBytes = a.L.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, int DH, int GP>
cudaError_t launch_typed(const Args& a, bool paged, int grid, int device,
                         cudaStream_t stream) {
  static bool configured[2][kMaxDevices] = {};
  if (paged)
    return launch(decode_attention_paged_kernel<T, DH, GP>, configured[1], a,
                  grid, device, stream);
  return launch(decode_attention_kernel<T, DH, GP>, configured[0], a, grid,
                device, stream);
}

template <typename T, int DH>
cudaError_t launch_gp(const Args& a, int GP, bool paged, int grid, int device,
                      cudaStream_t stream) {
  switch (GP) {
    case 1: return launch_typed<T, DH, 1>(a, paged, grid, device, stream);
    case 2: return launch_typed<T, DH, 2>(a, paged, grid, device, stream);
    case 4: return launch_typed<T, DH, 4>(a, paged, grid, device, stream);
    case 8:
      if constexpr (gmax(DH) >= 8)
        return launch_typed<T, DH, 8>(a, paged, grid, device, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_dh(const Args& a, int dh, int GP, bool paged, int grid,
                      int device, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch_gp<T, 16>(a, GP, paged, grid, device, stream);
    case 32: return launch_gp<T, 32>(a, GP, paged, grid, device, stream);
    case 64: return launch_gp<T, 64>(a, GP, paged, grid, device, stream);
    case 80: return launch_gp<T, 80>(a, GP, paged, grid, device, stream);
    case 128: return launch_gp<T, 128>(a, GP, paged, grid, device, stream);
    default: return cudaErrorInvalidValue;
  }
}

#if REPRO_DA_UNIT == 1
}  // namespace

// the bfloat16 unit's launches, for the entry points of unit 0 (``a`` is
// unit 0's Args: the same source, so the same layout)
extern "C" int repro_decode_attention_launch_bf16(const void* a, int dh,
                                                  int GP, int paged, int grid,
                                                  int device, void* stream) {
  return static_cast<int>(launch_dh<__nv_bfloat16>(
      *static_cast<const Args*>(a), dh, GP, paged != 0, grid, device,
      static_cast<cudaStream_t>(stream)));
}

#else  // unit 0: the entry points

}  // namespace
extern "C" int repro_decode_attention_launch_bf16(const void* a, int dh,
                                                  int GP, int paged, int grid,
                                                  int device, void* stream);
namespace {

cudaError_t launch_bf16(const Args& a, int dh, int GP, bool paged, int grid,
                        int device, cudaStream_t stream) {
  return static_cast<cudaError_t>(repro_decode_attention_launch_bf16(
      &a, dh, GP, paged ? 1 : 0, grid, device, stream));
}

bool supported(int dh) {
  return dh == 16 || dh == 32 || dh == 64 || dh == 80 || dh == 128;
}

// the block's head tile and its padded width
void tile_of(int G, int dh, int* gtile, int* GP) {
  *gtile = G < gmax(dh) ? G : gmax(dh);
  *GP = padded_heads(*gtile);
}

Layout layout_for(int G, int dh, int S, int maxP, int split, int warps,
                  int* slots_n) {
  int gtile, GP;
  tile_of(G, dh, &gtile, &GP);
  *slots_n = split > 1 ? (chunks_of(S) + split - 1) / split : 0;
  return layout(dh, GP, warps, split, *slots_n, chunks_of(S), maxP);
}

int run(Args& a, int B, int dh, int dtype, bool paged, int device,
        cudaStream_t stream) {
  if (!supported(dh) || a.split < 1 || a.split > kMaxSplit ||
      (a.split & (a.split - 1)) != 0 ||
      (a.warps != 2 && a.warps != 4 && a.warps != 8) || a.G < 1 ||
      a.HKV < 1 || a.S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int GP;
  tile_of(a.G, dh, &a.gtile, &GP);
  a.n_gtiles = (a.G + a.gtile - 1) / a.gtile;
  a.L = layout_for(a.G, dh, a.S, paged ? a.maxP : 0, a.split, a.warps,
                   &a.slots_n);
  if (a.L.total > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = static_cast<long long>(B) * a.HKV * a.n_gtiles;
  if (grid * a.split > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaSetDevice(device);
  const int g = static_cast<int>(grid);
  const cudaError_t err =
      dtype == 1 ? launch_bf16(a, dh, GP, paged, g, device, stream)
                 : launch_dh<float>(a, dh, GP, paged, g, device, stream);
  return static_cast<int>(err);
}

}  // namespace

// Positions of a chunk (the build's constant; kernels/decode_attention.py:
// CHUNK must equal it).
extern "C" int repro_decode_attention_chunk() { return kChunk; }

// Shared memory of one block of K4 (maxP = 0) or K5, in bytes, for the
// plan (split, warps); S is K4's capacity or K5's maxP * ps.
extern "C" int repro_decode_attention_smem_bytes(int G, int dh, int S,
                                                 int maxP, int split,
                                                 int warps) {
  int slots_n;
  return layout_for(G, dh, S, maxP, split, warps, &slots_n).total;
}

// q, out (B, H, dh); kq, vq (B, S, HKV, dh) s8; ks, vs (B, S, HKV) f32;
// lengths (B,) s32.  dtype: 0 = float32, 1 = bfloat16 (q and out).
// split: blocks of a cluster per (row, kv head, head tile), 1, 2, 4 or 8;
// warps: 2, 4 or 8 a block.  Returns cudaGetLastError().
extern "C" int repro_decode_attention(const void* q, const void* kq,
                                      const void* ks, const void* vq,
                                      const void* vs, const void* lengths,
                                      void* out, int B, int S, int HKV, int G,
                                      int dh, float sm_scale, int dtype,
                                      int split, int warps, int device,
                                      void* stream) {
  Args a = {};
  a.q = q;
  a.kq = static_cast<const int8_t*>(kq);
  a.ks = static_cast<const float*>(ks);
  a.vq = static_cast<const int8_t*>(vq);
  a.vs = static_cast<const float*>(vs);
  a.lengths = static_cast<const int*>(lengths);
  a.out = out;
  a.S = S;
  a.HKV = HKV;
  a.G = G;
  a.sm_scale = sm_scale;
  a.split = split;
  a.warps = warps;
  return run(a, B, dh, dtype, false, device,
             static_cast<cudaStream_t>(stream));
}

// q, out (B, H, dh); kq, vq (P, ps, HKV, dh) s8 page pool; ks, vs
// (P, ps, HKV) f32; tables (B, maxP) s32 page ids (sentinel P = unreserved,
// clamped to P - 1); lengths (B,) s32.  dtype, split and warps as above.
// Returns cudaGetLastError().
extern "C" int repro_decode_attention_paged(
    const void* q, const void* kq, const void* ks, const void* vq,
    const void* vs, const void* tables, const void* lengths, void* out, int B,
    int P, int ps, int maxP, int HKV, int G, int dh, float sm_scale,
    int dtype, int split, int warps, int device, void* stream) {
  if (ps < 1 || P < 1 || maxP < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.q = q;
  a.kq = static_cast<const int8_t*>(kq);
  a.ks = static_cast<const float*>(ks);
  a.vq = static_cast<const int8_t*>(vq);
  a.vs = static_cast<const float*>(vs);
  a.tables = static_cast<const int*>(tables);
  a.lengths = static_cast<const int*>(lengths);
  a.out = out;
  a.S = maxP * ps;
  a.P = P;
  a.ps = ps;
  a.shift = (ps & (ps - 1)) == 0 ? __builtin_ctz(ps) : -1;
  a.maxP = maxP;
  a.HKV = HKV;
  a.G = G;
  a.sm_scale = sm_scale;
  a.split = split;
  a.warps = warps;
  return run(a, B, dh, dtype, true, device,
             static_cast<cudaStream_t>(stream));
}

#endif  // REPRO_DA_UNIT
