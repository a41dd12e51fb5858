// Flash attention for Hopper (sm_90a): forward, dq and dk/dv kernels.
//
// Replaces the three Pallas TPU kernels of dlrover_tpu/ops/attention.py:
//   flash_fwd_kernel     <- _flash_fwd_kernel      (attention.py:96)
//   flash_bwd_dq_kernel  <- _flash_bwd_dq_kernel   (attention.py:227)
//   flash_bwd_dkv_kernel <- _flash_bwd_dkv_kernel  (attention.py:279)
//
// Layout: q/o/do are (b, sq, h, d), k/v/dk/dv are (b, sk, hkv, d), all bf16
// and contiguous; lse/delta are plain (b, h, sq) f32 vectors. GQA: query head
// hh reads kv head hh / (h / hkv). Causal masking is qpos >= kpos with both
// positions starting at 0, and masked logits are the finite -1e30 sentinel.
//
// What bounds them: at the training shapes (s = 2048, d = 128) every kernel
// does O(s^2 d) tensor-core work on O(s d) bytes, so all three are bound by
// operations. Design (the FlashAttention-2 layout on mma.sync): a block of
// 4 warps owns one 64-row tile and loops over 64-row tiles of the other
// sequence axis; each warp owns 16 of the rows, and its scores, softmax
// probabilities and output accumulator stay in registers as m16n8k16
// fragments (a score fragment is re-packed in registers as the A operand of
// the next product). Only the streamed 64 x d bf16 tiles pass through shared
// memory, double-buffered with cp.async so the next tile loads while this
// one is multiplied, and read into fragments with ldmatrix (.trans where the
// product needs the transpose). A forward or dq block owns one
// (b, h, q-tile) and stops at the causal diagonal; a dk/dv block owns one
// (b, kv-head, k-tile) and loops over group x q-tiles, so the group's query
// heads sum on chip and no block writes another block's output (no
// atomics). Not yet: wgmma, TMA, warp specialisation.
//
// Plain C interface (bound with ctypes). Each entry returns the
// cudaError_t of its launch, 0 on success.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;  // query rows per tile
constexpr int BK = 64;  // key rows per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG = -1e30f;

static_assert(BQ == 16 * NWARPS && BK == 16 * NWARPS,
              "each warp owns 16 rows of a 64-row tile");

// a 64 x D bf16 tile in shared memory, rows padded by 16 bytes so the eight
// row addresses of an ldmatrix fall in distinct banks
template <int D>
struct Tile {
  static constexpr int LD = D + 8;
  static constexpr int ELEMS = 64 * LD;
  static constexpr int BYTES = ELEMS * 2;
};

// ---- PTX wrappers -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; a false predicate zero-fills
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (16 x 8 f32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- fragment helpers ---------------------------------------------------------
//
// Lane l of a warp: g = l / 4 and t = l % 4. A 16 x 8 accumulator fragment
// c[4] holds (row g, cols 2t, 2t+1) in c[0..1] and (row g+8, same cols) in
// c[2..3]. For ldmatrix.x4, lane l addresses row l % 8 of matrix l / 8.

// A operand (16 x 16, k-step kk) from the warp's 16 rows of a row-major tile
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int ld, int row0,
                                       int kk, int lane) {
  const int m = lane / 8, r = lane % 8;
  ldmatrix_x4(a, tile + (row0 + r + 8 * (m % 2)) * ld + 16 * kk + 8 * (m / 2));
}

// B operands of n-tiles 2jp and 2jp+1 for X @ T^T, T a row-major tile whose
// rows are the n index (k-step kk over T's columns)
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4], const bf16* tile, int ld,
                                            int jp, int kk, int lane) {
  const int m = lane / 8, r = lane % 8;
  ldmatrix_x4(b, tile + (16 * jp + 8 * (m / 2) + r) * ld + 16 * kk + 8 * (m % 2));
}

// B operands of n-tiles 2np and 2np+1 for X @ T, T a row-major tile whose
// rows are the k index (k-step kk over T's rows)
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[4], const bf16* tile, int ld,
                                            int kk, int np, int lane) {
  const int m = lane / 8, r = lane % 8;
  ldmatrix_x4_trans(b, tile + (16 * kk + 8 * (m % 2) + r) * ld + 16 * np + 8 * (m / 2));
}

// s (16 x 64, as 8 n-tiles) = rows [row0, row0+16) of A @ B^T over D
template <int D>
__device__ __forceinline__ void scores(float (&s)[8][4], const bf16* A, int row0,
                                       const bf16* B, int lane) {
  constexpr int LD = Tile<D>::LD;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    load_a(a, A, LD, row0, kk, lane);
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t b[4];
      load_b_rows(b, B, LD, jp, kk, lane);
      mma(s[2 * jp], a, b[0], b[1]);
      mma(s[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x D, as D/8 n-tiles) += p (16 x 64 in registers) @ T (64 x D tile)
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4], const float (&p)[8][4],
                                           const bf16* T, int lane) {
  constexpr int LD = Tile<D>::LD;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    // the score fragments of n-tiles 2kk, 2kk+1 are the A operand of k-step kk
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b[4];
      load_b_cols(b, T, LD, kk, np, lane);
      mma(acc[2 * np], a, b[0], b[1]);
      mma(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// rows [row0, row0 + 64) of a (nrows, D) matrix, rows `stride` elements
// apart -> a shared tile, asynchronously; rows past nrows read as zeros
template <int D>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, int row0,
                                                int nrows, long stride) {
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < 64 * VPR; i += NTHREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const bool ok = row0 + r < nrows;
    cp_async16(dst + r * Tile<D>::LD + c, ok ? src + (long)(row0 + r) * stride + c : src, ok);
  }
}

// the warp's 16 x D f32 accumulator -> bf16 rows of dst (bounded by nrows)
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, long stride, const float (&acc)[D / 8][4],
                                           int row, int nrows, float scale0, float scale1,
                                           int lane) {
  const int t = lane % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int rr = row + 8 * half;
    if (rr >= nrows) continue;
    const float sc = half ? scale1 : scale0;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      __nv_bfloat162 v = __floats2bfloat162_rn(acc[n][2 * half] * sc, acc[n][2 * half + 1] * sc);
      *reinterpret_cast<__nv_bfloat162*>(dst + (long)rr * stride + 8 * n + 2 * t) = v;
    }
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int sq, int sk, int causal) {
  return qpos < sq && kpos < sk && (!causal || kpos <= qpos);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------------------
// forward: grid (q-tiles, h, b)
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int sq, int sk, int h, int hkv,
                 float scale, int causal) {
  using T = Tile<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + T::ELEMS;      // two buffers
  bf16* Vs = Ks + 2 * T::ELEMS;  // two buffers

  const int nq = (sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - blockIdx.x) * BQ;  // longest causal rows launch first
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int hk = hh / (h / hkv);
  const long qstride = (long)h * D, kstride = (long)hkv * D;
  const bf16* qh = q + (long)bb * sq * qstride + (long)hh * D;
  const bf16* kh = k + (long)bb * sk * kstride + (long)hk * D;
  const bf16* vh = v + (long)bb * sk * kstride + (long)hk * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = 16 * warp;  // the warp's rows within the tile

  const int k_lim = causal ? min(sk, min(q0 + BQ, sq)) : sk;
  const int nkt = (k_lim + BK - 1) / BK;
  load_tile_async<D>(Qs, qh, q0, sq, qstride);
  load_tile_async<D>(Ks, kh, 0, sk, kstride);
  load_tile_async<D>(Vs, vh, 0, sk, kstride);
  cp_async_commit();

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m_r[2] = {NEG, NEG}, l_r[2] = {0.0f, 0.0f};  // rows g, g+8

  for (int kt = 0; kt < nkt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nkt) {
      load_tile_async<D>(Ks + (buf ^ 1) * T::ELEMS, kh, (kt + 1) * BK, sk, kstride);
      load_tile_async<D>(Vs + (buf ^ 1) * T::ELEMS, vh, (kt + 1) * BK, sk, kstride);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and q) have landed
    __syncthreads();
    const bf16* Kb = Ks + buf * T::ELEMS;
    const bf16* Vb = Vs + buf * T::ELEMS;
    const int k0 = kt * BK;

    float s[8][4];
    scores<D>(s, Qs, row0, Kb, lane);

    // online softmax on the two rows this lane touches
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = q0 + row0 + g + 8 * (e / 2), kpos = k0 + 8 * j + 2 * t + (e % 2);
        s[j][e] = visible(qpos, kpos, sq, sk, causal) ? s[j][e] * scale : NEG;
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
    float corr[2], base[2], rowsum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m_r[i], quad_max(mx[i]));
      corr[i] = __expf(m_r[i] - m_new);
      m_r[i] = m_new;
      // a row with nothing visible yet keeps p = exp(-1e30) = 0
      base[i] = m_new == NEG ? 0.0f : m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = __expf(s[j][e] - base[e / 2]);
        rowsum[e / 2] += s[j][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * corr[i] + rowsum[i];  // lane-partial
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
    accumulate<D>(acc, s, Vb, lane);
    __syncthreads();  // the next prefetch overwrites this buffer
  }

  // an empty row (l == 0) is guarded as l = 1, as the TPU kernel does
  float inv[2];
  float* lseh = lse + ((long)bb * h + hh) * sq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l = quad_sum(l_r[i]);
    const float lsafe = l == 0.0f ? 1.0f : l;
    inv[i] = 1.0f / lsafe;
    const int qpos = q0 + row0 + g + 8 * i;
    if (t == 0 && qpos < sq) lseh[qpos] = m_r[i] + logf(lsafe);
  }
  store_rows<D>(o + (long)bb * sq * qstride + (long)hh * D, qstride, acc, q0 + row0 + g, sq,
                inv[0], inv[1], lane);
}

// ---------------------------------------------------------------------------
// backward dq: grid (q-tiles, h, b)
//   p = exp(scale q.k - lse), ds = p (do.v - delta) scale, dq = sum_k ds k
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int sq, int sk, int h, int hkv,
                    float scale, int causal) {
  using T = Tile<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + T::ELEMS;
  bf16* Ks = dOs + T::ELEMS;     // two buffers
  bf16* Vs = Ks + 2 * T::ELEMS;  // two buffers

  const int nq = (sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - blockIdx.x) * BQ;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int hk = hh / (h / hkv);
  const long qstride = (long)h * D, kstride = (long)hkv * D;
  const long qoff = (long)bb * sq * qstride + (long)hh * D;
  const long koff = (long)bb * sk * kstride + (long)hk * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = 16 * warp;

  const int k_lim = causal ? min(sk, min(q0 + BQ, sq)) : sk;
  const int nkt = (k_lim + BK - 1) / BK;
  load_tile_async<D>(Qs, q + qoff, q0, sq, qstride);
  load_tile_async<D>(dOs, dout + qoff, q0, sq, qstride);
  load_tile_async<D>(Ks, k + koff, 0, sk, kstride);
  load_tile_async<D>(Vs, v + koff, 0, sk, kstride);
  cp_async_commit();

  const float* lseh = lse + ((long)bb * h + hh) * sq;
  const float* deltah = delta + ((long)bb * h + hh) * sq;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = q0 + row0 + g + 8 * i;
    lse_r[i] = qpos < sq ? lseh[qpos] : 0.0f;
    delta_r[i] = qpos < sq ? deltah[qpos] : 0.0f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int kt = 0; kt < nkt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nkt) {
      load_tile_async<D>(Ks + (buf ^ 1) * T::ELEMS, k + koff, (kt + 1) * BK, sk, kstride);
      load_tile_async<D>(Vs + (buf ^ 1) * T::ELEMS, v + koff, (kt + 1) * BK, sk, kstride);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Kb = Ks + buf * T::ELEMS;
    const bf16* Vb = Vs + buf * T::ELEMS;
    const int k0 = kt * BK;

    float s[8][4], dp[8][4];
    scores<D>(s, Qs, row0, Kb, lane);
    scores<D>(dp, dOs, row0, Vb, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2;
        const int qpos = q0 + row0 + g + 8 * i, kpos = k0 + 8 * j + 2 * t + (e % 2);
        const float p =
            visible(qpos, kpos, sq, sk, causal) ? __expf(s[j][e] * scale - lse_r[i]) : 0.0f;
        s[j][e] = p * (dp[j][e] - delta_r[i]) * scale;  // ds
      }
    accumulate<D>(acc, s, Kb, lane);
    __syncthreads();
  }
  store_rows<D>(dq + qoff, qstride, acc, q0 + row0 + g, sq, 1.0f, 1.0f, lane);
}

// ---------------------------------------------------------------------------
// backward dk/dv: grid (k-tiles, hkv, b); loops over the group's query heads
// and their q-tiles, so dk/dv of one kv head are summed on chip. Each warp
// owns 16 keys and computes the transposed products directly:
//   s^T = k q^T, p^T = exp(scale s^T - lse), dp^T = v do^T,
//   dv += p^T do,  ds^T = p^T (dp^T - delta) scale,  dk += ds^T q
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int sk,
                     int h, int hkv, float scale, int causal) {
  using T = Tile<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + T::ELEMS;
  bf16* Qs = Vs + T::ELEMS;       // two buffers
  bf16* dOs = Qs + 2 * T::ELEMS;  // two buffers
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * T::ELEMS);  // [2][BQ]
  float* delta_s = lse_s + 2 * BQ;                               // [2][BQ]

  const int ki = blockIdx.x, hk = blockIdx.y, bb = blockIdx.z;
  const int group = h / hkv;
  const int k0 = ki * BK;
  const long qstride = (long)h * D, kstride = (long)hkv * D;
  const long koff = (long)bb * sk * kstride + (long)hk * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = 16 * warp;  // the warp's keys within the tile

  const int nq = (sq + BQ - 1) / BQ;
  const int qt0 = causal ? k0 / BQ : 0;  // q-tiles wholly above the diagonal skip
  const int per_head = max(nq - qt0, 0);
  const int n_iter = group * per_head;

  // (query head, q-tile) of iteration `it` -> its tiles into buffer `buf`
  auto load_q_tiles = [&](int it, int buf) {
    const int hq = hk * group + it / per_head;
    const int qs = (qt0 + it % per_head) * BQ;
    const long qoff = (long)bb * sq * qstride + (long)hq * D;
    load_tile_async<D>(Qs + buf * T::ELEMS, q + qoff, qs, sq, qstride);
    load_tile_async<D>(dOs + buf * T::ELEMS, dout + qoff, qs, sq, qstride);
    const long voff = ((long)bb * h + hq) * sq;
    for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
      const bool ok = qs + i < sq;
      lse_s[buf * BQ + i] = ok ? lse[voff + qs + i] : 0.0f;
      delta_s[buf * BQ + i] = ok ? delta[voff + qs + i] : 0.0f;
    }
  };

  load_tile_async<D>(Ks, k + koff, k0, sk, kstride);
  load_tile_async<D>(Vs, v + koff, k0, sk, kstride);
  if (n_iter > 0) load_q_tiles(0, 0);
  cp_async_commit();

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk_acc[n][e] = 0.0f;
      dv_acc[n][e] = 0.0f;
    }

  for (int it = 0; it < n_iter; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_iter) load_q_tiles(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Qb = Qs + buf * T::ELEMS;
    const bf16* dOb = dOs + buf * T::ELEMS;
    const float* lse_b = lse_s + buf * BQ;
    const float* delta_b = delta_s + buf * BQ;
    const int q0 = (qt0 + it % per_head) * BQ;

    float p[8][4];  // p^T: rows = the warp's keys, cols = the tile's queries
    scores<D>(p, Ks, row0, Qb, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e % 2);
        const int kpos = k0 + row0 + g + 8 * (e / 2);
        p[j][e] = visible(q0 + col, kpos, sq, sk, causal)
                      ? __expf(p[j][e] * scale - lse_b[col])
                      : 0.0f;
      }
    accumulate<D>(dv_acc, p, dOb, lane);  // dv += p^T do

    float ds[8][4];
    scores<D>(ds, Vs, row0, dOb, lane);  // dp^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e % 2);
        ds[j][e] = p[j][e] * (ds[j][e] - delta_b[col]) * scale;
      }
    accumulate<D>(dk_acc, ds, Qb, lane);  // dk += ds^T q
    __syncthreads();  // the next prefetch overwrites this buffer
  }
  cp_async_wait<0>();  // with no q-tile at all, K and V may still be landing
  store_rows<D>(dk + koff, kstride, dk_acc, k0 + row0 + g, sk, 1.0f, 1.0f, lane);
  store_rows<D>(dv + koff, kstride, dv_acc, k0 + row0 + g, sk, 1.0f, 1.0f, lane);
}

template <int D>
constexpr int fwd_smem() { return 5 * Tile<D>::BYTES; }  // Q, 2 K, 2 V
template <int D>
constexpr int dq_smem() { return 6 * Tile<D>::BYTES; }  // Q, dO, 2 K, 2 V
template <int D>
constexpr int dkv_smem() {  // K, V, 2 Q, 2 dO, 2 x (lse, delta)
  return 6 * Tile<D>::BYTES + 4 * BQ * (int)sizeof(float);
}

template <typename Kernel>
int prepare(Kernel kernel, int smem_bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem_bytes);
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int b,
               int sq, int sk, int h, int hkv, float scale, int causal,
               cudaStream_t stream) {
  constexpr int smem = fwd_smem<D>();
  int err = prepare(flash_fwd_kernel<D>, smem);
  if (err) return err;
  dim3 grid((sq + BQ - 1) / BQ, h, b);
  flash_fwd_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse, sq, sk, h,
      hkv, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int b, int sq, int sk, int h,
              int hkv, float scale, int causal, cudaStream_t stream) {
  constexpr int smem = dq_smem<D>();
  int err = prepare(flash_bwd_dq_kernel<D>, smem);
  if (err) return err;
  dim3 grid((sq + BQ - 1) / BQ, h, b);
  flash_bwd_dq_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dq, sq, sk, h, hkv, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int b, int sq,
               int sk, int h, int hkv, float scale, int causal, cudaStream_t stream) {
  constexpr int smem = dkv_smem<D>();
  int err = prepare(flash_bwd_dkv_kernel<D>, smem);
  if (err) return err;
  dim3 grid((sk + BK - 1) / BK, hkv, b);
  flash_bwd_dkv_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, sq, sk, h, hkv, scale,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// head dims the kernels are instantiated for; the wrappers check first
int dlrover_flash_supports_head_dim(int d) { return d == 64 || d == 128; }

int dlrover_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                      int b, int sq, int sk, int h, int hkv, int d, float scale,
                      int causal, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 128) return launch_fwd<128>(q, k, v, o, lse, b, sq, sk, h, hkv, scale, causal, s);
  if (d == 64) return launch_fwd<64>(q, k, v, o, lse, b, sq, sk, h, hkv, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

int dlrover_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dq, int b, int sq,
                         int sk, int h, int hkv, int d, float scale, int causal,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 128)
    return launch_dq<128>(q, k, v, dout, lse, delta, dq, b, sq, sk, h, hkv, scale, causal, s);
  if (d == 64)
    return launch_dq<64>(q, k, v, dout, lse, delta, dq, b, sq, sk, h, hkv, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

int dlrover_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* delta, void* dk, void* dv, int b,
                          int sq, int sk, int h, int hkv, int d, float scale, int causal,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 128)
    return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, b, sq, sk, h, hkv, scale,
                           causal, s);
  if (d == 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, b, sq, sk, h, hkv, scale,
                          causal, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
