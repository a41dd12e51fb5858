// Fused lm-head cross-entropy for Hopper (sm_90a): forward, merge, and the
// backward's q, dx and dw kernels.
//
// Replaces the three Pallas TPU kernels of dlrover_tpu/ops/fused_ce.py:
//   fused_ce_fwd_kernel    <- _fused_ce_fwd_kernel (fused_ce.py:201), its
//   fused_ce_merge_kernel     per-token finalize (:230) split off
//   fused_ce_bwd_q_kernel  <- the logits recompute of _bwd_q_tile (:290),
//                             which _fused_ce_dx_kernel (:300) and
//                             _fused_ce_dw_kernel (:322) each ran
//   fused_ce_bwd_dx_kernel <- _fused_ce_dx_kernel (:300)
//   fused_ce_bwd_dw_kernel <- _fused_ce_dw_kernel (:322)
//
// Operands: x (n, d) bf16 tokens; w (d, vp) bf16, the lm-head rounded once
// per call by the wrapper, columns zero-padded from the real vocab width v
// to vp = v rounded up to 8 (so every row starts 16-byte aligned); targets
// (n,) int32, < 0 ignored; logz, row_scale (n,) f32. Columns >= v are masked
// here: the wrappers make no padded copies of x or of the outputs.
//
// What bounds them: each kernel is a (tokens x d x vocab-columns) product
// with an element-wise epilogue, 2 n d v FLOPs on O((n + v) d) bytes, so all
// are bound by operations (n = 2048, d = 4096: ~2000 FLOPs a byte). Two GEMM
// main loops, bf16 operands and f32 accumulators in registers in both:
//   - wgmma + TMA (sm90_gemm.cuh), for bwd_q, bwd_dx and bwd_dw: a block of
//     one producer and two consumer warpgroups owns a 128 x 256 output tile;
//     the producer's one thread keeps a 4-stage ring of 64-deep K steps
//     (48 KB a stage: 128 rows of A and 256 columns of B) filled by TMA
//     through full/empty mbarriers, and each consumer warpgroup (232
//     registers after setmaxnreg) runs m64n256k16 wgmma on its 64 rows
//     straight from the 128-byte-swizzled shared tiles. Only wgmma reaches
//     the tensor cores' full rate; TMA takes the address arithmetic and
//     the ragged-edge zero fill off the threads; the mbarriers replace a
//     __syncthreads() a K step. bwd_q's B is w as [k = feature][n = vocab],
//     vocab contiguous (MN-major, wgmma's transposed B); bwd_dx reads the
//     same w chunk as [n = feature][k = vocab] (K-major); bwd_dw reads x as
//     [k = token][m = feature] (MN-major A, wgmma's transposed A) and q as
//     [k = token][n = column] (MN-major B). Each chunk's tensor map starts
//     at column c0 and is cw wide, so no kernel reads a neighbouring chunk.
//     Measured on the card (PERF.md), the 128 x 256 tile over 4 stages beat
//     128 x 128 tiles over 4 or 6 stages by 13-25 %, and 3 stages or a
//     persistent grid were no faster; one block an SM (a 192 KiB ring), 384
//     threads.
//   - mma.sync m16n8k16 (gemm_tile below), for fwd: a block of 8 warps owns
//     a 128 x 128 output tile and walks K in 64-wide steps through a
//     3-stage cp.async ring in shared memory (110.6 KB, so two blocks share
//     an SM); each warp owns 64 x 32 of the tile and reads its fragments
//     with ldmatrix (.trans for operands stored the other way round).
//     Measured on the card, two blocks of 16 warps hid latency better than
//     one 128 x 256 block of 8 warps, and 64-wide K steps, with half the
//     barriers, beat 32-wide ones by 20%. The forward moves to the wgmma
//     loop next.
// The epilogues run on the register tile:
//   - fwd: per row of the tile, (max, sum exp, gold logit) over its 128
//     columns, written as one vocab tile's partial. The TPU grid carried
//     (m, s, gold) across the vocab in order; here every (token tile, vocab
//     tile) pair is its own block, so the grid fills the 132 SMs (16 x 1002
//     blocks at the main shape) and the token tiles of one vocab tile run
//     side by side, reading that lm-head tile from L2.
//   - merge: one warp per token combines the partials into logz and gold.
//   - bwd_q: q = (exp(l - logz) - onehot) * row_scale, rounded to bf16, for
//     one vocab chunk of C columns, into an (n, C) buffer.
//   - bwd_dx: dx (n, d) f32 += q @ w_chunk^T, each element read and written
//     by its one owning block, no atomics.
//   - bwd_dw: dw[:, chunk] = x^T @ q, each dw column written once, f32,
//     with row stride v: an odd v (32001, 1000) leaves rows 4-byte aligned
//     only, so pairs go out as one float2 only where v is even.
// The TPU kernels kept a (tokens x d) dx and a (d x vocab-tile) dw
// accumulator in VMEM, 1 MB each at d = 4096, and recomputed the logits in
// both; neither fits a Hopper block. Going chunk by chunk recomputes the
// logits once (6 n d v backward FLOPs, not 8) and no f32 (n, v) tensor ever
// exists. Not yet: persistent scheduling.
//
// Plain C interface (bound with ctypes). Each entry returns the cudaError_t
// of its launch, 0 on success; bwd_q, bwd_dx and bwd_dw return
// cudaErrorInvalidValue if a tensor map cannot be encoded.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90_gemm.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;  // output tile rows
constexpr int BN = 128;  // output tile columns (the forward's vocab tile)
constexpr int BK = 64;   // K per pipeline stage
constexpr int STAGES = 3;
constexpr int MIN_BLOCKS = 2;  // resident blocks an SM must fit
constexpr int NWARPS = 8;
constexpr int WARPS_N = NWARPS / 2;  // 2 (rows) x WARPS_N (columns) warps
constexpr int NTHREADS = NWARPS * 32;
constexpr int WN = BN / WARPS_N;  // the warp tile's columns, 64 rows
constexpr int NI = WN / 8;  // its 8-column accumulator fragments
constexpr float NEG = -1e30f;

// shared tiles, rows padded by 16 bytes so ldmatrix's eight row addresses
// fall in distinct banks: K-contiguous tiles are [BM or BN][BK + 8], the
// others [BK][BM + 8] and [BK][BN + 8]
constexpr int LD_K = BK + 8;
constexpr int LD_M = BM + 8;
constexpr int LD_N = BN + 8;
constexpr int A_ELEMS = BM * LD_K > BK * LD_M ? BM * LD_K : BK * LD_M;
constexpr int B_ELEMS = BN * LD_K > BK * LD_N ? BN * LD_K : BK * LD_N;
constexpr int STAGE_ELEMS = A_ELEMS + B_ELEMS;
constexpr int PIPE_BYTES = STAGES * STAGE_ELEMS * 2;

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

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---- the GEMM main loop ---------------------------------------------------------
//
// acc (the warp's 64 x WN of the block's 128 x BN tile at (m0, n0)) =
// A (M x K) @ B (K x N), f32 accumulation. Storage of each operand:
//   A_KCONTIG: A is [m][k] with k contiguous (row stride lda), else [k][m]
//   B_NCONTIG: B is [k][n] with n contiguous (row stride ldb), else [n][k]
// The contiguous extent of each (K or M for A, N or K for B) is a multiple
// of 8; elements past M, N or K read as zeros.
//
// Lane l of a warp: g = l / 4, t = l % 4. Accumulator fragment acc[mi][ni]
// holds rows 16 mi + g (+ 8 for e >= 2) and columns 8 ni + 2 t + (e % 2) of
// the warp's tile. For ldmatrix.x4, lane l addresses row l % 8 of matrix
// l / 8.

// rows [r0, r0 + TR) x columns [c0, c0 + TC) of a (R x C) row-major matrix
// -> shared, zero-filling outside it; C and c0 are multiples of 8
template <int TR, int TC>
__device__ __forceinline__ void load_tile(bf16* dst, int ld_dst, const bf16* src, long ld_src,
                                          int r0, int c0, int R, int C) {
  constexpr int VPR = TC / 8;  // 16-byte vectors per row
#pragma unroll
  for (int i = threadIdx.x; i < TR * VPR; i += NTHREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const bool ok = r0 + r < R && c0 + c < C;
    cp_async16(dst + r * ld_dst + c, ok ? src + (long)(r0 + r) * ld_src + c0 + c : src, ok);
  }
}

template <bool A_KCONTIG, bool B_NCONTIG>
__device__ __forceinline__ void load_stage(bf16* stage, const bf16* A, long lda, const bf16* B,
                                           long ldb, int M, int N, int K, int m0, int n0,
                                           int k0) {
  bf16* As = stage;
  bf16* Bs = stage + A_ELEMS;
  if (A_KCONTIG)
    load_tile<BM, BK>(As, LD_K, A, lda, m0, k0, M, K);
  else
    load_tile<BK, BM>(As, LD_M, A, lda, k0, m0, K, M);
  if (B_NCONTIG)
    load_tile<BK, BN>(Bs, LD_N, B, ldb, k0, n0, K, N);
  else
    load_tile<BN, BK>(Bs, LD_K, B, ldb, n0, k0, N, K);
}

template <bool A_KCONTIG, bool B_NCONTIG>
__device__ __forceinline__ void gemm_tile(float (&acc)[4][NI][4], const bf16* A, long lda,
                                          const bf16* B, long ldb, int M, int N, int K,
                                          int m0, int n0, bf16* smem) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int q = lane / 8, r = lane % 8;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_stage<A_KCONTIG, B_NCONTIG>(smem + s * STAGE_ELEMS, A, lda, B, ldb, M, N, K, m0,
                                       n0, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // stage kt has landed
    __syncthreads();              // and every warp is done with stage kt - 1
    const int pre = kt + STAGES - 1;
    if (pre < nk)
      load_stage<A_KCONTIG, B_NCONTIG>(smem + (pre % STAGES) * STAGE_ELEMS, A, lda, B, ldb,
                                       M, N, K, m0, n0, pre * BK);
    cp_async_commit();
    const bf16* As = smem + (kt % STAGES) * STAGE_ELEMS;
    const bf16* Bs = As + A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int m = wm * 64 + mi * 16;
        if (A_KCONTIG)
          ldmatrix_x4(a[mi], As + (m + r + 8 * (q % 2)) * LD_K + 16 * kk + 8 * (q / 2));
        else
          ldmatrix_x4_trans(a[mi], As + (16 * kk + 8 * (q / 2) + r) * LD_M + m + 8 * (q % 2));
      }
#pragma unroll
      for (int np = 0; np < NI / 2; ++np) {
        const int n = wn * WN + 16 * np;
        uint32_t b[4];
        if (B_NCONTIG)
          ldmatrix_x4_trans(b, Bs + (16 * kk + 8 * (q % 2) + r) * LD_N + n + 8 * (q / 2));
        else
          ldmatrix_x4(b, Bs + (n + 8 * (q / 2) + r) * LD_K + 16 * kk + 8 * (q % 2));
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          mma(acc[mi][2 * np], a[mi], b[0], b[1]);
          mma(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// forward: grid (token tiles, vocab tiles). part is (3, n, ntiles) f32:
// the tile's row max, sum of exp(l - max) and gold logit, per token
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS)
fused_ce_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const int* __restrict__ tgt, float* __restrict__ part, int n, int d,
                    int vp, int v, int ntiles) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  float acc[4][NI][4];
  gemm_tile<true, true>(acc, x, d, w, vp, n, vp, d, m0, n0, smem);
  __syncthreads();  // the reduction below reuses the pipeline's memory
  float* red = reinterpret_cast<float*>(smem_raw);  // [3][WARPS_N][BM]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rt = wm * 64 + mi * 16 + g + 8 * h;  // row within the tile
      const int tg = m0 + rt < n ? tgt[m0 + rt] : -1;
      float mx = NEG;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn * WN + ni * 8 + 2 * t + e;
          if (col < v) mx = fmaxf(mx, acc[mi][ni][2 * h + e]);
        }
      mx = quad_max(mx);
      float s = 0.0f, gold = 0.0f;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn * WN + ni * 8 + 2 * t + e;
          const float l = acc[mi][ni][2 * h + e];
          // a masked column adds nothing, so a warp whose columns are all
          // past v reports (NEG, 0, 0)
          if (col < v) s += __expf(l - mx);
          if (col < v && col == tg) gold += l;
        }
      s = quad_sum(s);
      gold = quad_sum(gold);
      if (t == 0) {
        red[(0 * WARPS_N + wn) * BM + rt] = mx;
        red[(1 * WARPS_N + wn) * BM + rt] = s;
        red[(2 * WARPS_N + wn) * BM + rt] = gold;
      }
    }
  __syncthreads();
  if (threadIdx.x < BM && m0 + threadIdx.x < n) {
    const int rt = threadIdx.x;
    float mx = NEG;
#pragma unroll
    for (int i = 0; i < WARPS_N; ++i) mx = fmaxf(mx, red[i * BM + rt]);
    float s = 0.0f, gold = 0.0f;
#pragma unroll
    for (int i = 0; i < WARPS_N; ++i) {
      s += red[(WARPS_N + i) * BM + rt] * __expf(red[i * BM + rt] - mx);
      gold += red[(2 * WARPS_N + i) * BM + rt];
    }
    const long row = m0 + rt, plane = (long)n * ntiles;
    part[row * ntiles + blockIdx.y] = mx;
    part[plane + row * ntiles + blockIdx.y] = s;
    part[2 * plane + row * ntiles + blockIdx.y] = gold;
  }
}

// ---------------------------------------------------------------------------
// merge: one warp per token folds its ntiles partials into logz and gold
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NTHREADS)
fused_ce_merge_kernel(const float* __restrict__ part, float* __restrict__ logz,
                      float* __restrict__ gold, int n, int ntiles) {
  const int row = blockIdx.x * NWARPS + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= n) return;
  const long plane = (long)n * ntiles;
  const float* pm = part + (long)row * ntiles;
  float m = NEG, s = 0.0f, gsum = 0.0f;
  for (int i = lane; i < ntiles; i += 32) {
    const float mi = pm[i], si = pm[plane + i];
    const float mn = fmaxf(m, mi);
    s = s * __expf(m - mn) + si * __expf(mi - mn);
    m = mn;
    gsum += pm[2 * plane + i];
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float so = __shfl_xor_sync(0xffffffffu, s, off);
    gsum += __shfl_xor_sync(0xffffffffu, gsum, off);
    const float mn = fmaxf(m, mo);
    s = s * __expf(m - mn) + so * __expf(mo - mn);
    m = mn;
  }
  if (lane == 0) {
    // an empty row (s == 0) is guarded as s = 1, as the TPU kernel does
    logz[row] = m + logf(s == 0.0f ? 1.0f : s);
    gold[row] = gsum;
  }
}

// ---------------------------------------------------------------------------
// backward q for vocab columns [c0, c0 + cw), on the wgmma main loop: grid
// (token tiles, cw / BN); q (n, cw) bf16. A = x (n, d) is K-major; B is w's
// chunk, [k = feature][n = vocab column], MN-major.
// ---------------------------------------------------------------------------
typedef sm90::Gemm<false, true> BwdQGemm;

struct BwdQEpilogue {
  const int* __restrict__ tgt;
  const float* __restrict__ logz;
  const float* __restrict__ scale;
  bf16* __restrict__ q;
  int n, v, c0, cw;

  // row: a token; col: a column of the chunk
  template <int N>
  __device__ __forceinline__ void operator()(const float (&acc)[N], int row0, int col0) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= n) continue;
      const float lz = logz[row], sc = scale[row];
      const int tg = tgt[row] - c0;  // the target's column in the chunk
#pragma unroll
      for (int i = 0; i < N / 4; ++i) {
        const int col = col0 + 8 * i;  // even; cw is a multiple of 8
        if (col >= cw) continue;
        float p[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float l = acc[4 * i + 2 * h + e];
          p[e] = c0 + col + e < v ? __expf(l - lz) : 0.0f;
          if (col + e == tg) p[e] -= 1.0f;
          p[e] *= sc;
        }
        *reinterpret_cast<__nv_bfloat162*>(q + (long)row * cw + col) =
            __floats2bfloat162_rn(p[0], p[1]);
      }
    }
  }
};

__global__ void __launch_bounds__(BwdQGemm::THREADS, 1)
fused_ce_bwd_q_kernel(const __grid_constant__ CUtensorMap x_map,
                      const __grid_constant__ CUtensorMap w_map, const int* __restrict__ tgt,
                      const float* __restrict__ logz, const float* __restrict__ scale,
                      bf16* __restrict__ q, int n, int d, int v, int c0, int cw) {
  BwdQGemm::run(&x_map, &w_map, blockIdx.x * BwdQGemm::BM, blockIdx.y * BwdQGemm::BN, d,
                BwdQEpilogue{tgt, logz, scale, q, n, v, c0, cw});
}

// ---------------------------------------------------------------------------
// backward dx += q @ w[:, c0:c0+cw]^T, on the wgmma main loop: grid (token
// tiles, d / BN); dx (n, d) f32, read and written by its one owning block
// per launch. A = q (n, cw) and B (w's chunk read as [n = feature][k =
// vocab column]) are both K-major.
// ---------------------------------------------------------------------------
typedef sm90::Gemm<false, false> BwdDxGemm;

struct BwdDxEpilogue {
  float* __restrict__ dx;
  int n, d;

  // a batch's loads all go out before its stores, so their latencies
  // overlap: one at a time, 64 round trips to L2 a thread stalled the SM
  static constexpr int BATCH = 16;  // 8-column groups a batch, per row

  template <int N>
  __device__ __forceinline__ void operator()(const float (&acc)[N], int row0, int col0) const {
#pragma unroll
    for (int i0 = 0; i0 < N / 4; i0 += BATCH) {
      float2 cur[2][BATCH];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < BATCH; ++i) {
          const int row = row0 + 8 * h, col = col0 + 8 * (i0 + i);  // col even; d % 8 == 0
          if (row < n && col < d)
            cur[h][i] = *reinterpret_cast<const float2*>(dx + (long)row * d + col);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < BATCH; ++i) {
          const int row = row0 + 8 * h, col = col0 + 8 * (i0 + i);
          if (row >= n || col >= d) continue;
          cur[h][i].x += acc[4 * (i0 + i) + 2 * h];
          cur[h][i].y += acc[4 * (i0 + i) + 2 * h + 1];
          *reinterpret_cast<float2*>(dx + (long)row * d + col) = cur[h][i];
        }
    }
  }
};

__global__ void __launch_bounds__(BwdDxGemm::THREADS, 1)
fused_ce_bwd_dx_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap w_map, float* __restrict__ dx, int n,
                       int d, int cw) {
  BwdDxGemm::run(&q_map, &w_map, blockIdx.x * BwdDxGemm::BM, blockIdx.y * BwdDxGemm::BN, cw,
                 BwdDxEpilogue{dx, n, d});
}

// ---------------------------------------------------------------------------
// backward dw[:, c0:c0+cw] = x^T @ q, on the wgmma main loop: grid (d / BM,
// cw / BN); dw (d, v) f32, each column written once. A is x read as [k =
// token][m = feature] and B is q read as [k = token][n = column]: both
// MN-major.
// ---------------------------------------------------------------------------
typedef sm90::Gemm<true, true> BwdDwGemm;

struct BwdDwEpilogue {
  float* __restrict__ dw;
  int d, v, c0, cw;

  // row: a feature; col: a column of the chunk
  template <int N>
  __device__ __forceinline__ void operator()(const float (&acc)[N], int row0, int col0) const {
    const int c_end = min(cw, v - c0);  // the chunk's real columns
    // an odd v leaves every other row 4-byte aligned only
    const bool pairs = (v % 2) == 0;  // c0 and col are even
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= d) continue;
      float* out = dw + (long)row * v + c0;
#pragma unroll
      for (int i = 0; i < N / 4; ++i) {
        const int col = col0 + 8 * i;
        const float a = acc[4 * i + 2 * h], b = acc[4 * i + 2 * h + 1];
        if (pairs && col + 1 < c_end) {
          *reinterpret_cast<float2*>(out + col) = make_float2(a, b);
        } else {
          if (col < c_end) out[col] = a;
          if (col + 1 < c_end) out[col + 1] = b;
        }
      }
    }
  }
};

__global__ void __launch_bounds__(BwdDwGemm::THREADS, 1)
fused_ce_bwd_dw_kernel(const __grid_constant__ CUtensorMap x_map,
                       const __grid_constant__ CUtensorMap q_map, float* __restrict__ dw,
                       int n, int d, int v, int c0, int cw) {
  BwdDwGemm::run(&x_map, &q_map, blockIdx.x * BwdDwGemm::BM, blockIdx.y * BwdDwGemm::BN, n,
                 BwdDwEpilogue{dw, d, v, c0, cw});
}

static_assert(3 * WARPS_N * BM * sizeof(float) <= PIPE_BYTES, "fwd reduction fits");
static_assert(NTHREADS >= BM, "one thread a row finishes the fwd reduction");

template <typename Kernel>
int prepare(Kernel kernel, int smem_bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem_bytes);
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// the forward's vocab tile: the wrapper sizes the partials with it
int dlrover_ce_tile() { return BN; }

int dlrover_ce_fwd(const void* x, const void* w, const void* tgt, void* part, int n, int d,
                   int vp, int v, void* stream) {
  int err = prepare(fused_ce_fwd_kernel, PIPE_BYTES);
  if (err) return err;
  const int ntiles = cdiv(v, BN);
  fused_ce_fwd_kernel<<<dim3(cdiv(n, BM), ntiles), NTHREADS, PIPE_BYTES,
                        (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)w, (const int*)tgt, (float*)part, n, d, vp, v, ntiles);
  return (int)cudaGetLastError();
}

int dlrover_ce_merge(const void* part, void* logz, void* gold, int n, int ntiles,
                     void* stream) {
  fused_ce_merge_kernel<<<cdiv(n, NWARPS), NTHREADS, 0, (cudaStream_t)stream>>>(
      (const float*)part, (float*)logz, (float*)gold, n, ntiles);
  return (int)cudaGetLastError();
}

int dlrover_ce_bwd_q(const void* x, const void* w, const void* tgt, const void* logz,
                     const void* scale, void* q, int n, int d, int vp, int v, int c0, int cw,
                     void* stream) {
  typedef BwdQGemm G;
  CUtensorMap x_map, w_map;
  int err = G::map_a(&x_map, x, n, d, d);
  // the chunk's map is cw wide: TMA reads no neighbouring chunk's columns
  if (!err) err = G::map_b(&w_map, (const bf16*)w + c0, cw, d, vp);
  if (!err) err = prepare(fused_ce_bwd_q_kernel, G::SMEM_BYTES);
  if (err) return err;
  fused_ce_bwd_q_kernel<<<dim3(cdiv(n, G::BM), cdiv(cw, G::BN)), G::THREADS, G::SMEM_BYTES,
                          (cudaStream_t)stream>>>(x_map, w_map, (const int*)tgt,
                                                  (const float*)logz, (const float*)scale,
                                                  (bf16*)q, n, d, v, c0, cw);
  return (int)cudaGetLastError();
}

int dlrover_ce_bwd_dx(const void* q, const void* w, void* dx, int n, int d, int vp, int c0,
                      int cw, void* stream) {
  typedef BwdDxGemm G;
  CUtensorMap q_map, w_map;
  int err = G::map_a(&q_map, q, n, cw, cw);
  if (!err) err = G::map_b(&w_map, (const bf16*)w + c0, d, cw, vp);
  if (!err) err = prepare(fused_ce_bwd_dx_kernel, G::SMEM_BYTES);
  if (err) return err;
  fused_ce_bwd_dx_kernel<<<dim3(cdiv(n, G::BM), cdiv(d, G::BN)), G::THREADS, G::SMEM_BYTES,
                           (cudaStream_t)stream>>>(q_map, w_map, (float*)dx, n, d, cw);
  return (int)cudaGetLastError();
}

int dlrover_ce_bwd_dw(const void* x, const void* q, void* dw, int n, int d, int v, int c0,
                      int cw, void* stream) {
  typedef BwdDwGemm G;
  // with no tokens the K loop is empty and no load is issued, so the maps
  // (which cannot describe an empty matrix) stay zeros and dw gets zeros
  CUtensorMap x_map = {}, q_map = {};
  int err = n ? G::map_a(&x_map, x, d, n, d) : 0;
  if (!err && n) err = G::map_b(&q_map, q, cw, n, cw);
  if (!err) err = prepare(fused_ce_bwd_dw_kernel, G::SMEM_BYTES);
  if (err) return err;
  fused_ce_bwd_dw_kernel<<<dim3(cdiv(d, G::BM), cdiv(cw, G::BN)), G::THREADS, G::SMEM_BYTES,
                           (cudaStream_t)stream>>>(x_map, q_map, (float*)dw, n, d, v, c0, cw);
  return (int)cudaGetLastError();
}

}  // extern "C"
