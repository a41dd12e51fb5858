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
// operations.
//
// The forward is written for Hopper: a block of one producer and two
// consumer warpgroups owns a 128-row Q tile of one (batch, head). The
// producer's one thread (40 registers after setmaxnreg) loads Q once and
// streams 128-key K and V tiles through a 3-stage ring by TMA, each stage
// behind a full and an empty mbarrier; each tile is a rank-4 box over
// (d, s, head, batch) under 128-byte swizzle, so a ragged tile reads zeros
// at its own sequence's end. Each consumer warpgroup (232 registers) owns
// 64 of the rows: S = Q K^T by wgmma m64n128k16 from shared memory, the
// online softmax on the accumulator registers (row max and sum over the
// quad; exp2 with the scale folded in), then O += P V by wgmma with P
// converted to bf16 in registers as the A operand (the accumulator layout
// is already the A fragment's) and V read MN-major. A tile's S product is
// issued with the previous tile's P V, so each warpgroup's softmax runs
// while the tensor cores work, and the two warpgroups interleave besides.
// Only the diagonal tile and a tile reaching past sk mask; the k loop stops
// at the diagonal; the longest causal q-tiles launch first (the q-tile is
// the grid's slowest index).
//
// The backward kernels keep the FlashAttention-2 layout on mma.sync: a
// block of 4 warps owns one 64-row tile and loops over 64-row tiles of the
// other sequence axis; each warp owns 16 of the rows, and its scores,
// softmax probabilities and output accumulator stay in registers as
// m16n8k16 fragments (a score fragment is re-packed in registers as the A
// operand of the next product). Only the streamed 64 x d bf16 tiles pass
// through shared memory, double-buffered with cp.async and read into
// fragments with ldmatrix (.trans where the product needs the transpose). A
// dq block owns one (b, h, q-tile) and stops at the causal diagonal; a
// dk/dv block owns one (b, kv-head, k-tile) and loops over group x q-tiles,
// so the group's query heads sum on chip and no block writes another
// block's output (no atomics).
//
// Plain C interface (bound with ctypes). Each entry returns the
// cudaError_t of its launch, 0 on success; the forward returns
// cudaErrorInvalidValue if a tensor map cannot be encoded.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90_gemm.cuh"

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
                                           int row, int nrows, int lane) {
  const int t = lane % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int rr = row + 8 * half;
    if (rr >= nrows) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      __nv_bfloat162 v = __floats2bfloat162_rn(acc[n][2 * half], acc[n][2 * half + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dst + (long)rr * stride + 8 * n + 2 * t) = v;
    }
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int sq, int sk, int causal) {
  return qpos < sq && kpos < sk && (!causal || kpos <= qpos);
}

// 2^x on the special-function unit; 2^(-huge) = 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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
// forward, on wgmma + TMA: grid (h, b, q-tiles of FWD_ROWS), the longest
// causal q-tiles first. Warpgroup 0 is the producer: one thread loads the
// block's Q tile once, then streams K and V tiles of FWD_KEYS keys through
// a ring of FWD_STAGES stages (full / empty mbarriers). Warpgroups 1 and 2
// each own 64 query rows: S = Q K^T (wgmma from shared memory, both
// K-major), the online softmax on S's registers, then O += P V with P
// rounded to bf16 in registers as the A operand and V read MN-major
// ([k = key][n = d], d contiguous). S of tile kt and P V of tile kt - 1
// are issued together, so the softmax of kt runs while the tensor cores
// finish kt - 1; the ring holds tile kt - 1's V, tile kt and the next
// load, so it is 3 deep (230,456 bytes at d = 128). On the card this beat
// a 2- or 3-deep ring without the overlap by 2-7 % at the main shapes
// (PERF.md). Every tile is a rank-4 TMA box over
// (d, s, head, batch), so rows past a sequence's end read as zeros and no
// tile reaches into the next batch; keys past sk still score 0, not -inf,
// so the last k tile masks them.
// ---------------------------------------------------------------------------
constexpr int FWD_ROWS = 128;  // query rows a block
constexpr int FWD_KEYS = 128;  // keys a K / V tile
constexpr int FWD_STAGES = 3;
constexpr int FWD_THREADS = 384;

// S for a tile of FWD_KEYS keys from k0, in the accumulator layout
// (sc[4 i + 2 h + e] is row `row` + 8 h, key k0 + 8 i + 2 t + e): keys past
// sk and, when causal, keys after the row score NEG
__device__ __forceinline__ void mask_scores(float (&sc)[FWD_KEYS / 2], int k0, int row, int t,
                                            int sk, int causal) {
#pragma unroll
  for (int i = 0; i < FWD_KEYS / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kpos = k0 + 8 * i + 2 * t + (e % 2), qpos = row + 8 * (e / 2);
      if (kpos >= sk || (causal && kpos > qpos)) sc[4 * i + e] = NEG;
    }
}

// one online-softmax step on the two rows a thread holds: m_r (the raw-score
// max) moves to the tile's, corr is exp of the move, sc becomes
// p = exp(scale (s - m_r)) in place and rowsum the thread's part of its sum
__device__ __forceinline__ void softmax_step(float (&sc)[FWD_KEYS / 2], float (&m_r)[2],
                                             float (&corr)[2], float (&rowsum)[2], float sl2) {
  float mx[2] = {NEG, NEG}, base[2];
#pragma unroll
  for (int i = 0; i < FWD_KEYS / 2; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m_r[r], quad_max(mx[r]));
    corr[r] = exp2_approx((m_r[r] - m_new) * sl2);
    m_r[r] = m_new;
    // a row with nothing visible yet keeps p = exp2(-1e30 sl2) = 0
    base[r] = m_new == NEG ? 0.0f : m_new * sl2;
    rowsum[r] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < FWD_KEYS / 2; ++i) {
    sc[i] = exp2_approx(fmaf(sc[i], sl2, -base[(i / 2) % 2]));
    rowsum[(i / 2) % 2] += sc[i];
  }
}

// p (accumulator layout) -> bf16 A operands, one a k16 step: pa[kk][j] is
// (row + 8 (j % 2), keys 16 kk + 8 (j / 2) + 2 t, + 1)
__device__ __forceinline__ void pack_p(uint32_t (&pa)[FWD_KEYS / 16][4],
                                       const float (&p)[FWD_KEYS / 2]) {
#pragma unroll
  for (int kk = 0; kk < FWD_KEYS / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) pa[kk][j] = pack_bf16(p[8 * kk + 2 * j], p[8 * kk + 2 * j + 1]);
}

template <int D>
struct FwdSmem {
  static constexpr int BOX_BYTES = 128 * 128;     // one [128 rows][64] box
  static constexpr int TILE_BYTES = D / 64 * BOX_BYTES;  // a Q, K or V tile
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;     // K and V
  // Q, the ring, q_full + full[] + empty[], and slack to round up to 1024
  static constexpr int BYTES = 1024 + TILE_BYTES + FWD_STAGES * STAGE_BYTES +
                               (1 + 2 * FWD_STAGES) * 8;
  static_assert(BYTES <= 232448, "fits a block's shared memory");
};

template <int D>
__global__ void __launch_bounds__(FWD_THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o,
                 float* __restrict__ lse, int sq, int sk, int h, int hkv, float scale,
                 int causal) {
  using L = FwdSmem<D>;
  extern __shared__ unsigned char fwd_smem[];
  // 128-byte swizzle repeats every 1024 bytes; each box starts on that
  // boundary
  const uint32_t qs = (sm90::smem_u32(fwd_smem) + 1023u) & ~1023u;
  const uint32_t ring = qs + L::TILE_BYTES;
  const uint32_t q_full = ring + FWD_STAGES * L::STAGE_BYTES;
  const uint32_t full = q_full + 8, empty = full + 8 * FWD_STAGES;

  const int hh = blockIdx.x, bb = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * FWD_ROWS;
  const int hk = hh / (h / hkv);
  const int k_lim = causal ? min(sk, min(q0 + FWD_ROWS, sq)) : sk;
  const int nk = (k_lim + FWD_KEYS - 1) / FWD_KEYS;  // stops at the diagonal
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < FWD_STAGES; ++s) {
      sm90::mbar_init(full + 8 * s, 1);   // the producer's arrive, plus the bytes
      sm90::mbar_init(empty + 8 * s, 2);  // one arrive per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      sm90::mbar_expect_tx(q_full, L::TILE_BYTES);
#pragma unroll
      for (int j = 0; j < D / 64; ++j)
        sm90::tma_load_4d(qs + j * L::BOX_BYTES, &q_map, q_full, 64 * j, q0, hh, bb);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % FWD_STAGES;
        sm90::mbar_wait(empty + 8 * s, ((kt / FWD_STAGES) & 1) ^ 1);
        const uint32_t ks = ring + s * L::STAGE_BYTES, vs = ks + L::TILE_BYTES;
        const uint32_t bar = full + 8 * s;
        sm90::mbar_expect_tx(bar, L::STAGE_BYTES);
#pragma unroll
        for (int j = 0; j < D / 64; ++j) {
          sm90::tma_load_4d(ks + j * L::BOX_BYTES, &k_map, bar, 64 * j, kt * FWD_KEYS, hk, bb);
          sm90::tma_load_4d(vs + j * L::BOX_BYTES, &v_map, bar, 64 * j, kt * FWD_KEYS, hk, bb);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1;  // this warpgroup's 64 rows of the tile
    const int lane = threadIdx.x % 32, t = lane % 4;
    const int row = q0 + 64 * c + 16 * ((threadIdx.x / 32) % 4) + lane / 4;  // and row + 8
    const float sl2 = scale * 1.4426950408889634f;  // exp(scale x) = exp2(sl2 x)
    // Q and K: K-major, rows of 128 bytes, 8-row groups 1024 apart, a k16
    // step 32 bytes along the row and the next 64 of d one box further. V:
    // MN-major, [keys][64 of d] boxes BOX_BYTES apart (LBO), 8-key groups
    // 1024 apart (SBO), a k16 step 16 keys down.
    const uint64_t dq = sm90::smem_desc(qs + c * 64 * 128, 16, 1024);

    float acc[D / 2];  // O: acc[4 i + 2 h + e] is (row + 8 h, 8 i + 2 t + e)
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    float m_r[2] = {NEG, NEG}, l_r[2] = {0.0f, 0.0f};  // raw-score max, lane-partial sum
    sm90::mbar_wait(q_full, 0);

    // a tile that reaches past sk or across this warpgroup's part of the
    // diagonal masks; every tile below the diagonal skips the test
    auto masks = [&](int k0) {
      return k0 + FWD_KEYS > sk || (causal && k0 + FWD_KEYS - 1 > q0 + 64 * c);
    };
    // S = Q K^T for the K tile of stage s, issued and committed
    auto issue_s = [&](float (&sc)[FWD_KEYS / 2], int s) {
      const uint64_t dk = sm90::smem_desc(ring + s * L::STAGE_BYTES, 16, 1024);
#pragma unroll
      for (int i = 0; i < FWD_KEYS / 2; ++i) sc[i] = 0.0f;
      sm90::fence_acc(sc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t off = (uint64_t)(((kk / 4) * L::BOX_BYTES + (kk % 4) * 32) >> 4);
        sm90::wgmma_ss<FWD_KEYS>(sc, dq + off, dk + off);
      }
      sm90::wgmma_commit();
    };
    // O += P V for the V tile of stage s, issued and committed
    auto issue_pv = [&](uint32_t (&pa)[FWD_KEYS / 16][4], int s) {
      const uint64_t dv =
          sm90::smem_desc(ring + s * L::STAGE_BYTES + L::TILE_BYTES, L::BOX_BYTES, 1024);
      sm90::fence_acc(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < FWD_KEYS / 16; ++kk)
        sm90::wgmma_rs<D, true>(acc, pa[kk], dv + (uint64_t)((kk * 16 * 128) >> 4));
      sm90::wgmma_commit();
    };
    auto rescale = [&](const float (&corr)[2], const float (&rowsum)[2]) {
#pragma unroll
      for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * corr[r] + rowsum[r];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i / 2) % 2];
    };

    float sc[FWD_KEYS / 2];         // S, then P, over the tile's keys
    uint32_t pa[FWD_KEYS / 16][4];  // P as the A operand, one k16 step each
    float corr[2], rowsum[2];
    // the softmax of tile kt runs while the tensor cores do tile kt - 1's
    // P V: S of kt and P V of kt - 1 are issued together. Tile 0 goes
    // first on its own, so no wgmma issue sits under a branch of the loop:
    // folded in, it ran slower on the card (PERF.md).
    if (nk > 0) {
      sm90::mbar_wait(full, 0);
      issue_s(sc, 0);
      sm90::wgmma_wait<0>();
      sm90::fence_acc(sc);
      if (masks(0)) mask_scores(sc, 0, row, t, sk, causal);
      softmax_step(sc, m_r, corr, rowsum, sl2);
      rescale(corr, rowsum);
      pack_p(pa, sc);
    }
    for (int kt = 1; kt < nk; ++kt) {
      const int s = kt % FWD_STAGES, prev = (kt - 1) % FWD_STAGES, k0 = kt * FWD_KEYS;
      sm90::mbar_wait(full + 8 * s, (kt / FWD_STAGES) & 1);
      issue_s(sc, s);
      issue_pv(pa, prev);
      sm90::wgmma_wait<1>();  // S is in; P V may still run
      sm90::fence_acc(sc);
      if (masks(k0)) mask_scores(sc, k0, row, t, sk, causal);
      softmax_step(sc, m_r, corr, rowsum, sl2);
      sm90::wgmma_wait<0>();
      sm90::fence_acc(acc);
#pragma unroll
      for (int kk = 0; kk < FWD_KEYS / 16; ++kk) sm90::fence_regs(pa[kk]);
      if (threadIdx.x % 128 == 0) sm90::mbar_arrive(empty + 8 * prev);
      rescale(corr, rowsum);
      pack_p(pa, sc);
    }
    if (nk > 0) {
      issue_pv(pa, (nk - 1) % FWD_STAGES);
      sm90::wgmma_wait<0>();
      sm90::fence_acc(acc);
#pragma unroll
      for (int kk = 0; kk < FWD_KEYS / 16; ++kk) sm90::fence_regs(pa[kk]);
    }

    // an empty row (l == 0) is guarded as l = 1, as the TPU kernel does
    const long qstride = (long)h * D;
    bf16* oh = o + (long)bb * sq * qstride + (long)hh * D;
    float* lseh = lse + ((long)bb * h + hh) * sq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float l = quad_sum(l_r[r]);
      const float lsafe = l == 0.0f ? 1.0f : l;
      const float inv = 1.0f / lsafe;
      const int qpos = row + 8 * r;
      if (qpos >= sq) continue;
      if (t == 0) lseh[qpos] = m_r[r] == NEG ? NEG : m_r[r] * scale + logf(lsafe);
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(oh + (long)qpos * qstride + 8 * i + 2 * t) =
            __floats2bfloat162_rn(acc[4 * i + 2 * r] * inv, acc[4 * i + 2 * r + 1] * inv);
    }
  }
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
  store_rows<D>(dq + qoff, qstride, acc, q0 + row0 + g, sq, lane);
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
  store_rows<D>(dk + koff, kstride, dk_acc, k0 + row0 + g, sk, lane);
  store_rows<D>(dv + koff, kstride, dv_acc, k0 + row0 + g, sk, lane);
}

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

// a (b, s, heads, D) bf16 tensor as a rank-4 tensor map over (d, s, head,
// batch), read in [FWD_ROWS][64] boxes of one head of one sequence
template <int D>
int map_heads(CUtensorMap* map, const void* base, int b, int s, int heads) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)s, (cuuint64_t)heads, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)heads * D * 2, (cuuint64_t)D * 2,
                                 (cuuint64_t)s * heads * D * 2};
  const cuuint32_t box[4] = {64, FWD_ROWS, 1, 1};
  return sm90::encode_tiled(map, base, 4, dims, strides, box);
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int b,
               int sq, int sk, int h, int hkv, float scale, int causal,
               cudaStream_t stream) {
  static_assert(FWD_KEYS == FWD_ROWS, "one box shape for Q, K and V");
  CUtensorMap q_map, k_map, v_map;
  int err = map_heads<D>(&q_map, q, b, sq, h);
  if (!err) err = map_heads<D>(&k_map, k, b, sk, hkv);
  if (!err) err = map_heads<D>(&v_map, v, b, sk, hkv);
  if (!err) err = prepare(flash_fwd_kernel<D>, FwdSmem<D>::BYTES);
  if (err) return err;
  dim3 grid(h, b, (sq + FWD_ROWS - 1) / FWD_ROWS);
  flash_fwd_kernel<D><<<grid, FWD_THREADS, FwdSmem<D>::BYTES, stream>>>(
      q_map, k_map, v_map, (bf16*)o, (float*)lse, sq, sk, h, hkv, scale, causal);
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
