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
// operations: the tensor cores' rate, and what keeps them waiting (the
// softmax and the gradient arithmetic on the accumulators, the loads, a
// causal grid's longest block).
//
// All three kernels share one design, written for Hopper: a block of one
// producer and two consumer warpgroups owns a 128-row tile of one (batch,
// head) and loops over 64- or 128-row tiles of the other sequence axis. The
// producer warpgroup (24-40 registers after setmaxnreg; one thread issues
// the TMA loads) loads the block's own tiles once and streams the others
// through a 3-stage ring, each stage behind a full and an empty mbarrier;
// each tile is a rank-4 box over (d, s, head, batch) under 128-byte
// swizzle, so a ragged tile reads zeros at its own sequence's end and
// never the next batch's rows. Each consumer warpgroup (232-240
// registers) owns 64 of the rows and runs wgmma m64nNk16: products of two
// tiles from shared memory (both K-major), and products whose A operand is
// a probability or gradient tile converted to bf16 in registers (the m64
// accumulator layout is the A fragment's) against a tile read MN-major.
// The arithmetic between products runs on the accumulator registers,
// overlapped with the tensor cores' next product. Zero fill is not a mask
// (a key past sk scores 0, so its p would be exp(-lse)): every tile that
// reaches past sq or sk or crosses the causal diagonal masks explicitly,
// and a tile wholly below the diagonal skips the test.
//
// Plain C interface (bound with ctypes). Each entry returns the
// cudaError_t of its launch, 0 on success, or cudaErrorInvalidValue if a
// tensor map cannot be encoded.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90_gemm.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// An accumulator tile (m64 x N, N / 2 floats a thread) -> bf16 A operands,
// one a k16 step: pa[kk][j] is (row + 8 (j % 2), columns 16 kk + 8 (j / 2)
// + 2 t, + 1), the layout of an m64nNk16 accumulator and of a wgmma A
// fragment alike
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&pa)[N / 16][4], const float (&p)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) pa[kk][j] = pack_bf16(p[8 * kk + 2 * j], p[8 * kk + 2 * j + 1]);
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
      pack_a<FWD_KEYS>(pa, sc);
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
      pack_a<FWD_KEYS>(pa, sc);
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
// backward, on wgmma + TMA. Both kernels: a block owns BWD_ROWS rows of one
// (batch, head) in two 64-row halves, one a consumer warpgroup, and streams
// tiles of BWD_COLS rows of the other axis through a ring of BWD_STAGES
// stages. Their score tiles are 64 x 64 (m64n64k16), so S and dP take 32
// f32 registers a thread each beside the gradient accumulators.
// ---------------------------------------------------------------------------
constexpr int BWD_ROWS = 128;  // rows a block owns: queries (dq), keys (dk/dv)
constexpr int BWD_COLS = 64;   // rows of a streamed tile: keys (dq), queries (dk/dv)
constexpr int BWD_STAGES = 3;
constexpr int BWD_THREADS = 384;

template <int D>
struct BwdSmem {
  static constexpr int OWN_BOX = BWD_ROWS * 128;       // one [128 rows][64] box
  static constexpr int OWN_TILE = D / 64 * OWN_BOX;    // an owned Q, dO, K or V tile
  static constexpr int COL_BOX = BWD_COLS * 128;       // one [64 rows][64] box
  static constexpr int COL_TILE = D / 64 * COL_BOX;    // a streamed tile
  static constexpr int STAGE_BYTES = 2 * COL_TILE;     // K and V (dq), Q and dO (dk/dv)
  static constexpr int VEC_BYTES = 2 * BWD_COLS * 4;   // a dk/dv stage's lse and delta
  // two owned tiles, the ring, (dk/dv) the ring's vectors, own_full +
  // full[] + empty[], and slack to round up to 1024
  static constexpr int DQ_BYTES =
      1024 + 2 * OWN_TILE + BWD_STAGES * STAGE_BYTES + (1 + 2 * BWD_STAGES) * 8;
  static constexpr int DKV_BYTES = DQ_BYTES + BWD_STAGES * VEC_BYTES;
  static_assert(DKV_BYTES <= 232448, "fits a block's shared memory");
};

// offsets (bytes >> 4, to add to a descriptor) of k16 step kk along d of a
// K-major tile of 64-wide boxes BOX bytes apart
template <int BOX>
__device__ __forceinline__ uint64_t kstep(int kk) {
  return (uint64_t)(((kk / 4) * BOX + (kk % 4) * 32) >> 4);
}

// A 64 x 64 score tile in the accumulator layout (sc[4 i + 2 h + e] is row
// `row` + 8 h, column col0 + 8 i + 2 t + e): every pair that is not visible
// (a query past sq, a key past sk, or a key after its query when causal)
// scores NEG, so its p = exp2(NEG sl2 - lse) is 0. Rows are queries and
// columns keys in dq, the reverse in dk/dv.
template <bool ROWS_ARE_KEYS>
__device__ __forceinline__ void mask_tile(float (&sc)[BWD_COLS / 2], int row, int col0, int t,
                                          int sq, int sk, int causal) {
#pragma unroll
  for (int i = 0; i < BWD_COLS / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row + 8 * (e / 2), cl = col0 + 8 * i + 2 * t + (e % 2);
      const int qpos = ROWS_ARE_KEYS ? cl : r, kpos = ROWS_ARE_KEYS ? r : cl;
      if (qpos >= sq || kpos >= sk || (causal && kpos > qpos)) sc[4 * i + e] = NEG;
    }
}

// ---------------------------------------------------------------------------
// backward dq: grid (h, b, q-tiles of BWD_ROWS), the longest causal q-tiles
// first.
//   p = exp(scale q.k - lse), ds = p (do.v - delta) scale, dq = sum_k ds k
// The producer's one thread loads the block's Q and dO once and streams
// 64-key K and V tiles (the K tile of a stage serves both S and dQ). Each
// consumer warpgroup owns 64 query rows, keeps lse and delta of its
// thread's two rows in registers and runs, for key tile kt:
//   S = Q K^T and dP = dO V^T (wgmma from shared memory, both K-major, one
//   commit group each), then P = exp2(sl2 S - lse log2 e) and
//   dS = P (dP - delta) on the accumulators, then dQ += dS K with dS in
//   bf16 registers as the A operand and K read MN-major ([k = key][n = d],
//   as the forward reads V). The scale multiplies dQ once, at the store.
// dQ of tile kt - 1 is issued behind S and dP of tile kt, so P and dS of kt
// are computed while the tensor cores run dQ of kt - 1; the ring holds tile
// kt - 1's K for that, tile kt and the next load. Tile 0 runs outside the
// loop, as the forward's does, so no wgmma issue sits under a branch.
// What bounds it: 3 products of 64 x 64 x d a tile, two of them with both
// operands in shared memory (at n = 64 those read as many bytes as the
// shared memory delivers while the tensor cores run them), and the exp2 of
// 4,096 scores a warpgroup; the ring keeps the loads out of the way. At
// the main case a 2-stage ring ran 32 % slower on the card and a 4-stage
// one no faster (PERF.md).
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(BWD_THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap do_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int sq, int sk, int h, int hkv, float scale,
                    int causal) {
  using L = BwdSmem<D>;
  extern __shared__ unsigned char dq_smem[];
  const uint32_t qs = (sm90::smem_u32(dq_smem) + 1023u) & ~1023u;
  const uint32_t dos = qs + L::OWN_TILE;
  const uint32_t ring = dos + L::OWN_TILE;
  const uint32_t own_full = ring + BWD_STAGES * L::STAGE_BYTES;
  const uint32_t full = own_full + 8, empty = full + 8 * BWD_STAGES;

  const int hh = blockIdx.x, bb = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BWD_ROWS;
  const int hk = hh / (h / hkv);
  const int k_lim = causal ? min(sk, min(q0 + BWD_ROWS, sq)) : sk;
  const int nk = (k_lim + BWD_COLS - 1) / BWD_COLS;  // stops at the diagonal
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    sm90::mbar_init(own_full, 1);
#pragma unroll
    for (int s = 0; s < BWD_STAGES; ++s) {
      sm90::mbar_init(full + 8 * s, 1);   // the producer's arrive, plus the bytes
      sm90::mbar_init(empty + 8 * s, 2);  // one arrive per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      sm90::mbar_expect_tx(own_full, 2 * L::OWN_TILE);
#pragma unroll
      for (int j = 0; j < D / 64; ++j) {
        sm90::tma_load_4d(qs + j * L::OWN_BOX, &q_map, own_full, 64 * j, q0, hh, bb);
        sm90::tma_load_4d(dos + j * L::OWN_BOX, &do_map, own_full, 64 * j, q0, hh, bb);
      }
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % BWD_STAGES;
        sm90::mbar_wait(empty + 8 * s, ((kt / BWD_STAGES) & 1) ^ 1);
        const uint32_t ks = ring + s * L::STAGE_BYTES, vs = ks + L::COL_TILE;
        const uint32_t bar = full + 8 * s;
        sm90::mbar_expect_tx(bar, L::STAGE_BYTES);
#pragma unroll
        for (int j = 0; j < D / 64; ++j) {
          sm90::tma_load_4d(ks + j * L::COL_BOX, &k_map, bar, 64 * j, kt * BWD_COLS, hk, bb);
          sm90::tma_load_4d(vs + j * L::COL_BOX, &v_map, bar, 64 * j, kt * BWD_COLS, hk, bb);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1;  // this warpgroup's 64 rows of the tile
    const int lane = threadIdx.x % 32, t = lane % 4;
    const int row = q0 + 64 * c + 16 * ((threadIdx.x / 32) % 4) + lane / 4;  // and row + 8
    const float sl2 = scale * LOG2E;  // exp(scale x - lse) = exp2(sl2 x - lse log2 e)
    const float* lseh = lse + ((long)bb * h + hh) * sq;
    const float* deltah = delta + ((long)bb * h + hh) * sq;
    float lse2[2], dlt[2];  // rows past sq are never stored
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool ok = row + 8 * r < sq;
      lse2[r] = ok ? lseh[row + 8 * r] * LOG2E : 0.0f;
      dlt[r] = ok ? deltah[row + 8 * r] : 0.0f;
    }
    // Q and dO: K-major, this warpgroup's 64 rows from row 64 c of each
    // [128][64] box. K and V: K-major for S and dP; K again MN-major for
    // dQ: [keys][64 of d] boxes COL_BOX apart (LBO), 8-key groups 1024
    // apart (SBO), a k16 step 16 keys down.
    const uint64_t dqd = sm90::smem_desc(qs + c * 64 * 128, 16, 1024);
    const uint64_t dod = sm90::smem_desc(dos + c * 64 * 128, 16, 1024);

    float acc[D / 2];  // dQ: acc[4 i + 2 h + e] is (row + 8 h, 8 i + 2 t + e)
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    sm90::mbar_wait(own_full, 0);

    auto masks = [&](int k0) {
      return k0 + BWD_COLS > sk || (causal && k0 + BWD_COLS - 1 > q0 + 64 * c);
    };
    // S = Q K^T and dP = dO V^T for the tiles of stage s: two commit groups
    auto issue_s_dp = [&](float (&sc)[BWD_COLS / 2], float (&dp)[BWD_COLS / 2], int s) {
      const uint64_t dk = sm90::smem_desc(ring + s * L::STAGE_BYTES, 16, 1024);
      const uint64_t dv = sm90::smem_desc(ring + s * L::STAGE_BYTES + L::COL_TILE, 16, 1024);
#pragma unroll
      for (int i = 0; i < BWD_COLS / 2; ++i) sc[i] = dp[i] = 0.0f;
      sm90::fence_acc(sc);
      sm90::fence_acc(dp);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::wgmma_ss<BWD_COLS>(sc, dqd + kstep<L::OWN_BOX>(kk), dk + kstep<L::COL_BOX>(kk));
      sm90::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::wgmma_ss<BWD_COLS>(dp, dod + kstep<L::OWN_BOX>(kk), dv + kstep<L::COL_BOX>(kk));
      sm90::wgmma_commit();
    };
    // dQ += dS K for the K tile of stage s, issued and committed
    auto issue_dq = [&](uint32_t (&dsa)[BWD_COLS / 16][4], int s) {
      const uint64_t dk = sm90::smem_desc(ring + s * L::STAGE_BYTES, L::COL_BOX, 1024);
      sm90::fence_acc(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BWD_COLS / 16; ++kk)
        sm90::wgmma_rs<D, true>(acc, dsa[kk], dk + (uint64_t)((kk * 16 * 128) >> 4));
      sm90::wgmma_commit();
    };
    auto probs = [&](float (&sc)[BWD_COLS / 2], int k0) {
      if (masks(k0)) mask_tile<false>(sc, row, k0, t, sq, sk, causal);
#pragma unroll
      for (int i = 0; i < BWD_COLS / 2; ++i)
        sc[i] = exp2_approx(fmaf(sc[i], sl2, -lse2[(i / 2) % 2]));
    };
    auto grads = [&](const float (&p)[BWD_COLS / 2], float (&dp)[BWD_COLS / 2]) {
#pragma unroll
      for (int i = 0; i < BWD_COLS / 2; ++i) dp[i] = p[i] * (dp[i] - dlt[(i / 2) % 2]);
    };

    float sc[BWD_COLS / 2], dp[BWD_COLS / 2];  // S then P, dP then dS
    uint32_t dsa[BWD_COLS / 16][4];            // dS as the A operand
    if (nk > 0) {
      sm90::mbar_wait(full, 0);
      issue_s_dp(sc, dp, 0);
      sm90::wgmma_wait<1>();
      sm90::fence_acc(sc);
      probs(sc, 0);
      sm90::wgmma_wait<0>();
      sm90::fence_acc(dp);
      grads(sc, dp);
      pack_a<BWD_COLS>(dsa, dp);
    }
    for (int kt = 1; kt < nk; ++kt) {
      const int s = kt % BWD_STAGES, prev = (kt - 1) % BWD_STAGES;
      sm90::mbar_wait(full + 8 * s, (kt / BWD_STAGES) & 1);
      issue_s_dp(sc, dp, s);
      issue_dq(dsa, prev);
      sm90::wgmma_wait<2>();  // S is in
      sm90::fence_acc(sc);
      probs(sc, kt * BWD_COLS);
      sm90::wgmma_wait<1>();  // dP is in; dQ of kt - 1 may still run
      sm90::fence_acc(dp);
      grads(sc, dp);
      sm90::wgmma_wait<0>();
      sm90::fence_acc(acc);
#pragma unroll
      for (int kk = 0; kk < BWD_COLS / 16; ++kk) sm90::fence_regs(dsa[kk]);
      if (threadIdx.x % 128 == 0) sm90::mbar_arrive(empty + 8 * prev);
      pack_a<BWD_COLS>(dsa, dp);
    }
    if (nk > 0) {
      issue_dq(dsa, (nk - 1) % BWD_STAGES);
      sm90::wgmma_wait<0>();
      sm90::fence_acc(acc);
#pragma unroll
      for (int kk = 0; kk < BWD_COLS / 16; ++kk) sm90::fence_regs(dsa[kk]);
    }

    const long qstride = (long)h * D;
    bf16* dqh = dq + (long)bb * sq * qstride + (long)hh * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = row + 8 * r;
      if (qpos >= sq) continue;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(dqh + (long)qpos * qstride + 8 * i + 2 * t) =
            __floats2bfloat162_rn(acc[4 * i + 2 * r] * scale, acc[4 * i + 2 * r + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// backward dk/dv: grid (h, b, k-tiles of BWD_ROWS), the longest causal
// k-tiles (the first) first. A block owns the k-tile of one QUERY head:
//   s^T = k q^T, p^T = exp(scale s^T - lse), dp^T = v do^T,
//   dv += p^T do,  ds^T = p^T (dp^T - delta) scale,  dk += ds^T q
// summed over that head's q-tiles. One block a query head, not a kv head,
// balances the causal grid: a kv head's column of group x q-tiles would
// make the first k-tile's block group times longer than a query head's.
// With group 1 the block stores dk and dv in bf16. With group > 1 each
// block stores its f32 sums, dK unscaled, once, into its query head's rows
// of a (b, h, sk, d) scratch pair, with no atomics, and flash_dkv_sum_kernel
// then adds each kv head's group of partials in head order, scales dK and
// casts both to bf16: the same inputs give the same bits on every run, as
// the Pallas kernel's group sum on chip does (atomics would add the
// group's terms in an order that varies, and so would dk's and dv's last
// bits).
// The producer warp loads K and V once; lane 0 streams 64-query Q and dO
// tiles by TMA and the warp's 32 lanes copy the tile's lse (times log2 e)
// and delta into the stage beside them, bounded by sq, before each lane
// arrives on the stage's full barrier. Each consumer warpgroup owns 64 keys
// and computes the products transposed, so no transpose is ever stored:
//   S^T = K Q^T and dP^T = V dO^T (wgmma from shared memory, both K-major,
//   one commit group each); P^T = exp2(sl2 S^T - lse) with lse a column's,
//   read from the stage; dV += P^T dO (P^T in bf16 registers, dO MN-major)
//   issued while dS^T = P^T (dP^T - delta) is computed; dK += dS^T Q (Q
//   MN-major); the scale multiplies dK once, at the store.
// What bounds it: 4 products of 64 x 64 x d a tile, and S^T and dP^T read
// both operands from shared memory as dq's S and dP do. Each tile waits
// for its own dK product before the next tile's S^T: issuing S^T of the
// next tile first (dK and dV in flight across the loop) made ptxas
// serialise the wgmma (C7515) and ran 16 % slower on the card, so the two
// warpgroups' turns on the tensor cores are what overlaps.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(BWD_THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap do_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ dk_part,
                     float* __restrict__ dv_part, int sq, int sk, int h, int hkv, float scale,
                     int causal) {
  using L = BwdSmem<D>;
  extern __shared__ unsigned char dkv_smem[];
  const uint32_t raw = sm90::smem_u32(dkv_smem);
  const uint32_t ks = (raw + 1023u) & ~1023u;
  const uint32_t vs = ks + L::OWN_TILE;
  const uint32_t ring = vs + L::OWN_TILE;
  const uint32_t vecs = ring + BWD_STAGES * L::STAGE_BYTES;  // [stage][lse, delta][64]
  const uint32_t own_full = vecs + BWD_STAGES * L::VEC_BYTES;
  const uint32_t full = own_full + 8, empty = full + 8 * BWD_STAGES;
  float* vec_ptr = reinterpret_cast<float*>(dkv_smem + (vecs - raw));

  const int hh = blockIdx.x, bb = blockIdx.y;
  const int k0 = blockIdx.z * BWD_ROWS;
  const int hk = hh / (h / hkv);
  const int nq = (sq + BWD_COLS - 1) / BWD_COLS;
  const int qt0 = causal ? min(k0 / BWD_COLS, nq) : 0;  // q-tiles wholly above the diagonal skip
  const int n_it = nq - qt0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    sm90::mbar_init(own_full, 1);
#pragma unroll
    for (int s = 0; s < BWD_STAGES; ++s) {
      sm90::mbar_init(full + 8 * s, 32);  // the producer warp's lanes; lane 0's with the bytes
      sm90::mbar_init(empty + 8 * s, 2);  // one arrive per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    const int lane = threadIdx.x % 32;
    if (threadIdx.x < 32) {
      if (lane == 0) {
        sm90::mbar_expect_tx(own_full, 2 * L::OWN_TILE);
#pragma unroll
        for (int j = 0; j < D / 64; ++j) {
          sm90::tma_load_4d(ks + j * L::OWN_BOX, &k_map, own_full, 64 * j, k0, hk, bb);
          sm90::tma_load_4d(vs + j * L::OWN_BOX, &v_map, own_full, 64 * j, k0, hk, bb);
        }
      }
      const float* lseh = lse + ((long)bb * h + hh) * sq;
      const float* deltah = delta + ((long)bb * h + hh) * sq;
      for (int it = 0; it < n_it; ++it) {
        const int s = it % BWD_STAGES, q0 = (qt0 + it) * BWD_COLS;
        sm90::mbar_wait(empty + 8 * s, ((it / BWD_STAGES) & 1) ^ 1);
        float* v = vec_ptr + s * 2 * BWD_COLS;
#pragma unroll
        for (int j = lane; j < BWD_COLS; j += 32) {
          const bool ok = q0 + j < sq;
          v[j] = ok ? lseh[q0 + j] * LOG2E : 0.0f;
          v[BWD_COLS + j] = ok ? deltah[q0 + j] : 0.0f;
        }
        const uint32_t bar = full + 8 * s;
        if (lane == 0) {
          const uint32_t qst = ring + s * L::STAGE_BYTES, dost = qst + L::COL_TILE;
          sm90::mbar_expect_tx(bar, L::STAGE_BYTES);
#pragma unroll
          for (int j = 0; j < D / 64; ++j) {
            sm90::tma_load_4d(qst + j * L::COL_BOX, &q_map, bar, 64 * j, q0, hh, bb);
            sm90::tma_load_4d(dost + j * L::COL_BOX, &do_map, bar, 64 * j, q0, hh, bb);
          }
        } else {
          sm90::mbar_arrive(bar);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = wg - 1;  // this warpgroup's 64 keys of the tile
    const int lane = threadIdx.x % 32, t = lane % 4;
    const int key = k0 + 64 * c + 16 * ((threadIdx.x / 32) % 4) + lane / 4;  // and key + 8
    const float sl2 = scale * LOG2E;
    // K and V: K-major, this warpgroup's 64 keys from row 64 c of each
    // [128][64] box. Q and dO: K-major for S^T and dP^T; MN-major for dK
    // and dV ([queries][64 of d] boxes COL_BOX apart, 8-query groups 1024
    // apart, a k16 step 16 queries down).
    const uint64_t dkd = sm90::smem_desc(ks + c * 64 * 128, 16, 1024);
    const uint64_t dvd = sm90::smem_desc(vs + c * 64 * 128, 16, 1024);

    float dk_r[D / 2], dv_r[D / 2];  // [4 i + 2 h + e] is (key + 8 h, 8 i + 2 t + e)
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_r[i] = dv_r[i] = 0.0f;
    sm90::mbar_wait(own_full, 0);

    float st[BWD_COLS / 2], dpt[BWD_COLS / 2];  // S^T then P^T, dP^T then dS^T
    uint32_t pa[BWD_COLS / 16][4], dsa[BWD_COLS / 16][4];
    for (int it = 0; it < n_it; ++it) {
      const int s = it % BWD_STAGES, q0 = (qt0 + it) * BWD_COLS;
      const uint32_t qst = ring + s * L::STAGE_BYTES, dost = qst + L::COL_TILE;
      const float2* lse_v = reinterpret_cast<const float2*>(vec_ptr + s * 2 * BWD_COLS);
      const float2* dlt_v = lse_v + BWD_COLS / 2;
      sm90::mbar_wait(full + 8 * s, (it / BWD_STAGES) & 1);

      const uint64_t dq_k = sm90::smem_desc(qst, 16, 1024);
      const uint64_t ddo_k = sm90::smem_desc(dost, 16, 1024);
#pragma unroll
      for (int i = 0; i < BWD_COLS / 2; ++i) st[i] = dpt[i] = 0.0f;
      sm90::fence_acc(st);
      sm90::fence_acc(dpt);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::wgmma_ss<BWD_COLS>(st, dkd + kstep<L::OWN_BOX>(kk), dq_k + kstep<L::COL_BOX>(kk));
      sm90::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::wgmma_ss<BWD_COLS>(dpt, dvd + kstep<L::OWN_BOX>(kk), ddo_k + kstep<L::COL_BOX>(kk));
      sm90::wgmma_commit();

      sm90::wgmma_wait<1>();  // S^T is in
      sm90::fence_acc(st);
      if (q0 + BWD_COLS > sq || k0 + 64 * c + 64 > sk || (causal && q0 < k0 + 64 * c + 63))
        mask_tile<true>(st, key, q0, t, sq, sk, causal);
#pragma unroll
      for (int i = 0; i < BWD_COLS / 8; ++i) {
        const float2 l2 = lse_v[4 * i + t];  // columns 8 i + 2 t, + 1
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st[4 * i + e] = exp2_approx(fmaf(st[4 * i + e], sl2, -(e % 2 ? l2.y : l2.x)));
      }
      pack_a<BWD_COLS>(pa, st);
      // dV += P^T dO, while dS^T is computed
      const uint64_t ddo_mn = sm90::smem_desc(dost, L::COL_BOX, 1024);
      sm90::fence_acc(dv_r);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BWD_COLS / 16; ++kk)
        sm90::wgmma_rs<D, true>(dv_r, pa[kk], ddo_mn + (uint64_t)((kk * 16 * 128) >> 4));
      sm90::wgmma_commit();

      sm90::wgmma_wait<1>();  // dP^T is in; dV may still run
      sm90::fence_acc(dpt);
#pragma unroll
      for (int i = 0; i < BWD_COLS / 8; ++i) {
        const float2 dl = dlt_v[4 * i + t];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[4 * i + e] = st[4 * i + e] * (dpt[4 * i + e] - (e % 2 ? dl.y : dl.x));
      }
      pack_a<BWD_COLS>(dsa, dpt);
      // dK += dS^T Q
      const uint64_t dq_mn = sm90::smem_desc(qst, L::COL_BOX, 1024);
      sm90::fence_acc(dk_r);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BWD_COLS / 16; ++kk)
        sm90::wgmma_rs<D, true>(dk_r, dsa[kk], dq_mn + (uint64_t)((kk * 16 * 128) >> 4));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_acc(dv_r);
      sm90::fence_acc(dk_r);
#pragma unroll
      for (int kk = 0; kk < BWD_COLS / 16; ++kk) {
        sm90::fence_regs(pa[kk]);
        sm90::fence_regs(dsa[kk]);
      }
      // the stage's vectors were read before this warpgroup issued dK's
      // wgmma, which every warp of it joins, so they are read once its
      // products are done
      if (threadIdx.x % 128 == 0) sm90::mbar_arrive(empty + 8 * s);
    }

    const long kstride = (long)hkv * D;
    const long base = (long)bb * sk * kstride + (long)hk * D;
    // this query head's rows of the scratch: (b, h, sk, D)
    const long pbase = ((long)bb * h + hh) * sk * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kpos = key + 8 * r;
      if (kpos >= sk) continue;
      const long off = base + (long)kpos * kstride + 2 * t;
      if (dk_part != nullptr) {
        // every row is written, zeros included (a block with no q-tile),
        // so the scratch needs no fill
        const long poff = pbase + (long)kpos * D + 2 * t;
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          *reinterpret_cast<float2*>(dk_part + poff + 8 * i) =
              make_float2(dk_r[4 * i + 2 * r], dk_r[4 * i + 2 * r + 1]);
          *reinterpret_cast<float2*>(dv_part + poff + 8 * i) =
              make_float2(dv_r[4 * i + 2 * r], dv_r[4 * i + 2 * r + 1]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * i) =
              __floats2bfloat162_rn(dk_r[4 * i + 2 * r] * scale, dk_r[4 * i + 2 * r + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * i) =
              __floats2bfloat162_rn(dv_r[4 * i + 2 * r], dv_r[4 * i + 2 * r + 1]);
        }
      }
    }
  }
}

// dk and dv of every kv head: its group of query heads' f32 partials
// ((b, h, sk, D), dK unscaled) added in head order, dK times the scale,
// both cast to bf16 into (b, sk, hkv, D). A thread takes 4 columns of one
// row, so a warp reads 128 contiguous floats of a partial's row; one pass
// over the scratch, bound by its bytes.
template <int D>
__global__ void __launch_bounds__(256)
flash_dkv_sum_kernel(const float* __restrict__ dk_part, const float* __restrict__ dv_part,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int b, int sk, int h,
                     int hkv, float scale) {
  const int group = h / hkv;
  const long n = (long)b * sk * hkv * (D / 4);
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    const int c = 4 * (int)(i % (D / 4));
    long r = i / (D / 4);
    const int hk = (int)(r % hkv);
    r /= hkv;
    const int s = (int)(r % sk);
    const long bb = r / sk;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), v = a;
    for (int g = 0; g < group; ++g) {
      const long off = ((bb * h + (long)hk * group + g) * sk + s) * D + c;
      const float4 x = *reinterpret_cast<const float4*>(dk_part + off);
      const float4 y = *reinterpret_cast<const float4*>(dv_part + off);
      a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
      v.x += y.x; v.y += y.y; v.z += y.z; v.w += y.w;
    }
    const long out = ((bb * sk + s) * hkv + hk) * D + c;
    __nv_bfloat162* dko = reinterpret_cast<__nv_bfloat162*>(dk + out);
    __nv_bfloat162* dvo = reinterpret_cast<__nv_bfloat162*>(dv + out);
    dko[0] = __floats2bfloat162_rn(a.x * scale, a.y * scale);
    dko[1] = __floats2bfloat162_rn(a.z * scale, a.w * scale);
    dvo[0] = __floats2bfloat162_rn(v.x, v.y);
    dvo[1] = __floats2bfloat162_rn(v.z, v.w);
  }
}

template <typename Kernel>
int prepare(Kernel kernel, int smem_bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem_bytes);
}

// a (b, s, heads, D) bf16 tensor as a rank-4 tensor map over (d, s, head,
// batch), read in [rows][64] boxes of one head of one sequence
template <int D>
int map_heads(CUtensorMap* map, const void* base, int b, int s, int heads, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)s, (cuuint64_t)heads, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)heads * D * 2, (cuuint64_t)D * 2,
                                 (cuuint64_t)s * heads * D * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  return sm90::encode_tiled(map, base, 4, dims, strides, box);
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int b,
               int sq, int sk, int h, int hkv, float scale, int causal,
               cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  int err = map_heads<D>(&q_map, q, b, sq, h, FWD_ROWS);
  if (!err) err = map_heads<D>(&k_map, k, b, sk, hkv, FWD_KEYS);
  if (!err) err = map_heads<D>(&v_map, v, b, sk, hkv, FWD_KEYS);
  if (!err) err = prepare(flash_fwd_kernel<D>, FwdSmem<D>::BYTES);
  if (err) return err;
  dim3 grid(h, b, (sq + FWD_ROWS - 1) / FWD_ROWS);
  flash_fwd_kernel<D><<<grid, FWD_THREADS, FwdSmem<D>::BYTES, stream>>>(
      q_map, k_map, v_map, (bf16*)o, (float*)lse, sq, sk, h, hkv, scale, causal);
  return (int)cudaGetLastError();
}

// the backward's four maps: q and do of (b, sq, h), k and v of (b, sk,
// hkv), the owned pair in boxes of BWD_ROWS rows and the streamed pair in
// boxes of BWD_COLS
template <int D>
int bwd_maps(CUtensorMap (&maps)[4], const void* q, const void* dout, const void* k,
             const void* v, int b, int sq, int sk, int h, int hkv, bool q_owned) {
  const int q_rows = q_owned ? BWD_ROWS : BWD_COLS, k_rows = q_owned ? BWD_COLS : BWD_ROWS;
  int err = map_heads<D>(&maps[0], q, b, sq, h, q_rows);
  if (!err) err = map_heads<D>(&maps[1], dout, b, sq, h, q_rows);
  if (!err) err = map_heads<D>(&maps[2], k, b, sk, hkv, k_rows);
  if (!err) err = map_heads<D>(&maps[3], v, b, sk, hkv, k_rows);
  return err;
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int b, int sq, int sk, int h,
              int hkv, float scale, int causal, cudaStream_t stream) {
  constexpr int smem = BwdSmem<D>::DQ_BYTES;
  CUtensorMap maps[4];
  int err = bwd_maps<D>(maps, q, dout, k, v, b, sq, sk, h, hkv, true);
  if (!err) err = prepare(flash_bwd_dq_kernel<D>, smem);
  if (err) return err;
  dim3 grid(h, b, (sq + BWD_ROWS - 1) / BWD_ROWS);
  flash_bwd_dq_kernel<D><<<grid, BWD_THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], (const float*)lse, (const float*)delta, (bf16*)dq,
      sq, sk, h, hkv, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, void* dk_part,
               void* dv_part, int b, int sq, int sk, int h, int hkv, float scale, int causal,
               cudaStream_t stream) {
  constexpr int smem = BwdSmem<D>::DKV_BYTES;
  CUtensorMap maps[4];
  int err = bwd_maps<D>(maps, q, dout, k, v, b, sq, sk, h, hkv, false);
  if (!err) err = prepare(flash_bwd_dkv_kernel<D>, smem);
  if (err) return err;
  dim3 grid(h, b, (sk + BWD_ROWS - 1) / BWD_ROWS);
  flash_bwd_dkv_kernel<D><<<grid, BWD_THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], (const float*)lse, (const float*)delta, (bf16*)dk,
      (bf16*)dv, (float*)dk_part, (float*)dv_part, sq, sk, h, hkv, scale, causal);
  err = (int)cudaGetLastError();
  if (err || dk_part == nullptr) return err;
  const long n = (long)b * sk * hkv * (D / 4);
  flash_dkv_sum_kernel<D><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      (const float*)dk_part, (const float*)dv_part, (bf16*)dk, (bf16*)dv, b, sk, h, hkv, scale);
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

// dk and dv: the bf16 (b, sk, hkv, d) results. dk_part and dv_part: null
// when h == hkv (the kernel stores dk and dv), else f32 (b, h, sk, d)
// scratch that the kernel fills with each query head's sums and a second
// kernel, on the same stream, adds by kv head in head order into dk and dv
int dlrover_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* delta, void* dk, void* dv,
                          void* dk_part, void* dv_part, int b, int sq, int sk, int h, int hkv,
                          int d, float scale, int causal, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 128)
    return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, dk_part, dv_part, b, sq, sk, h,
                           hkv, scale, causal, s);
  if (d == 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, dk_part, dv_part, b, sq, sk, h,
                          hkv, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
