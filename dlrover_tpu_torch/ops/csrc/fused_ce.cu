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
// What bounds them: fwd, bwd_q, bwd_dx and bwd_dw are each a (tokens x d x
// vocab-columns) product with an element-wise epilogue, 2 n d v FLOPs on
// O((n + v) d) bytes, so all four are bound by operations (n = 2048,
// d = 4096: ~2000 FLOPs a byte). All four run one main loop, the wgmma +
// TMA loop of sm90_gemm.cuh, with bf16 operands and f32 accumulators in
// registers: a block of one producer and two consumer warpgroups owns a
// 128 x 256 output tile; the producer's one thread keeps a 4-stage ring of
// 64-deep K steps (48 KB a stage: 128 rows of A and 256 columns of B)
// filled by TMA through full/empty mbarriers, and each consumer warpgroup
// (232 registers after setmaxnreg) runs m64n256k16 wgmma on its 64 rows
// straight from the 128-byte-swizzled shared tiles. Only wgmma reaches the
// tensor cores' full rate; TMA takes the address arithmetic and the
// ragged-edge zero fill off the threads; the mbarriers replace a
// __syncthreads() a K step. fwd and bwd_q read B as w, [k = feature][n =
// vocab], vocab contiguous (MN-major, wgmma's transposed B); bwd_dx reads a
// w chunk as [n = feature][k = vocab] (K-major); bwd_dw reads x as [k =
// token][m = feature] (MN-major A, wgmma's transposed A) and q as [k =
// token][n = column] (MN-major B). A backward chunk's tensor map starts at
// column c0 and is cw wide, so no kernel reads a neighbouring chunk.
// Measured on the card (PERF.md), the 128 x 256 tile over 4 stages beat
// 128 x 128 tiles over 4 or 6 stages by 13-25 %, and 3 stages or a
// persistent grid were no faster; one block an SM (a 192 KiB ring), 384
// threads.
// The epilogues run on the register tile:
//   - fwd: per token, (max, sum exp, gold logit) over one 256-column vocab
//     tile, written as that tile's partial. The TPU grid carried (m, s,
//     gold) across the vocab in order; here every (token tile, vocab tile)
//     pair is its own block, so the grid fills the 132 SMs (16 x 501 blocks
//     at the main shape), and blockIdx.x being the token tile, the 16 token
//     tiles of one vocab tile run side by side, reading that lm-head tile
//     from L2. A row's 256 columns lie in the four lanes of one quad, so a
//     two-step shuffle finishes each reduction; the two consumer
//     warpgroups own separate rows and never meet.
//   - merge: folds the partials into logz and gold, one token a lane of
//     each half-warp.
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
// of its launch, 0 on success; the GEMM entries return
// cudaErrorInvalidValue if a tensor map cannot be encoded.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90_gemm.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float NEG = -1e30f;

// the logits x @ w: A = x (n, d) K-major, B = w [k = feature][n = vocab]
// MN-major; the forward and bwd_q run this one instance
typedef sm90::Gemm<false, true> LogitsGemm;

// the forward's vocab tile: the loop's N tile, one partial per token
constexpr int FWD_TILE = 256;
static_assert(FWD_TILE == LogitsGemm::BN, "a partial covers one N tile");

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------------------
// forward: grid (token tiles, vocab tiles). part is (3, ntiles, n) f32: the
// tile's row max, sum of exp(l - max) and gold logit, per token, so a
// block's stores of consecutive tokens coalesce
// ---------------------------------------------------------------------------
struct FwdEpilogue {
  const int* __restrict__ tgt;
  float* __restrict__ part;
  int n, v, ntiles;

  // row: a token; col: a vocab column. The quad's four lanes hold the
  // row's 256 columns, so the shuffles below run on every lane, rows past
  // n included, and only the stores are masked.
  template <int N>
  __device__ __forceinline__ void operator()(const float (&acc)[N], int row0, int col0) const {
    const int tile = col0 / FWD_TILE;  // col0 - n0 is 0, 2, 4 or 6
    const long plane = (long)ntiles * n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      const int tg = row < n ? tgt[row] : -1;
      // TMA fills zeros past vp and columns [v, vp) are zero padding: a
      // zero logit is no -inf, so columns >= v are masked here. Every tile
      // holds a real column, so the row's max is a real logit.
      float mx = NEG;
#pragma unroll
      for (int i = 0; i < N / 4; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (col0 + 8 * i + e < v) mx = fmaxf(mx, acc[4 * i + 2 * h + e]);
      mx = quad_max(mx);
      float s = 0.0f, gold = 0.0f;
#pragma unroll
      for (int i = 0; i < N / 4; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + 8 * i + e;
          const float l = acc[4 * i + 2 * h + e];
          if (col < v) s += __expf(l - mx);
          if (col < v && col == tg) gold += l;  // a -1 target matches nothing
        }
      s = quad_sum(s);
      gold = quad_sum(gold);
      if (row < n && threadIdx.x % 4 == 0) {
        const long at = (long)tile * n + row;
        part[at] = mx;
        part[plane + at] = s;
        part[2 * plane + at] = gold;
      }
    }
  }
};

__global__ void __launch_bounds__(LogitsGemm::THREADS, 1)
fused_ce_fwd_kernel(const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap w_map, const int* __restrict__ tgt,
                    float* __restrict__ part, int n, int d, int v, int ntiles) {
  LogitsGemm::run(&x_map, &w_map, blockIdx.x * LogitsGemm::BM, blockIdx.y * LogitsGemm::BN, d,
                  FwdEpilogue{tgt, part, n, v, ntiles});
}

// ---------------------------------------------------------------------------
// merge: a block owns MERGE_TOKENS tokens, one a lane of each half-warp, so
// a half-warp's loads of one tile's partials are one coalesced 64-byte
// run; its MERGE_GROUPS half-warps fold every MERGE_GROUPS-th tile, and
// the groups' (m, s) are folded by a shuffle, then through shared memory.
// 16-token blocks put 128 blocks on the SMs at n = 2048.
// ---------------------------------------------------------------------------
constexpr int MERGE_TOKENS = 16;
constexpr int MERGE_GROUPS = 32;
constexpr int MERGE_THREADS = MERGE_TOKENS * MERGE_GROUPS;
static_assert(2 * MERGE_TOKENS == 32, "a warp is two token groups");

// (m, s) <- the online-softmax fold of (m, s) and (mo, so)
__device__ __forceinline__ void fold(float& m, float& s, float mo, float so) {
  const float mn = fmaxf(m, mo);
  s = s * __expf(m - mn) + so * __expf(mo - mn);
  m = mn;
}

__global__ void __launch_bounds__(MERGE_THREADS)
fused_ce_merge_kernel(const float* __restrict__ part, float* __restrict__ logz,
                      float* __restrict__ gold, int n, int ntiles) {
  __shared__ float red[3][MERGE_GROUPS / 2][MERGE_TOKENS];
  const int tok = threadIdx.x % MERGE_TOKENS, grp = threadIdx.x / MERGE_TOKENS;
  const int row = blockIdx.x * MERGE_TOKENS + tok;
  const long plane = (long)ntiles * n;
  // a group that has no tile, or a row past n, holds (NEG, 0, 0): it adds
  // nothing to a fold
  float m = NEG, s = 0.0f, g = 0.0f;
  if (row < n) {
#pragma unroll 4
    for (int i = grp; i < ntiles; i += MERGE_GROUPS) {
      const long at = (long)i * n + row;
      fold(m, s, part[at], part[plane + at]);
      g += part[2 * plane + at];
    }
  }
  // the warp's two half-warps hold the same tokens
  fold(m, s, __shfl_xor_sync(0xffffffffu, m, MERGE_TOKENS),
       __shfl_xor_sync(0xffffffffu, s, MERGE_TOKENS));
  g += __shfl_xor_sync(0xffffffffu, g, MERGE_TOKENS);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 < MERGE_TOKENS) {
    red[0][warp][tok] = m;
    red[1][warp][tok] = s;
    red[2][warp][tok] = g;
  }
  __syncthreads();
  if (threadIdx.x >= MERGE_TOKENS || row >= n) return;
#pragma unroll
  for (int w = 1; w < MERGE_GROUPS / 2; ++w) {
    fold(m, s, red[0][w][tok], red[1][w][tok]);
    g += red[2][w][tok];
  }
  // an empty row (s == 0) is guarded as s = 1, as the TPU kernel does
  logz[row] = m + logf(s == 0.0f ? 1.0f : s);
  gold[row] = g;
}

// ---------------------------------------------------------------------------
// backward q for vocab columns [c0, c0 + cw), on the forward's instance of
// the loop: grid (token tiles, cw / BN); q (n, cw) bf16. B is w's chunk.
// ---------------------------------------------------------------------------

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

__global__ void __launch_bounds__(LogitsGemm::THREADS, 1)
fused_ce_bwd_q_kernel(const __grid_constant__ CUtensorMap x_map,
                      const __grid_constant__ CUtensorMap w_map, const int* __restrict__ tgt,
                      const float* __restrict__ logz, const float* __restrict__ scale,
                      bf16* __restrict__ q, int n, int d, int v, int c0, int cw) {
  LogitsGemm::run(&x_map, &w_map, blockIdx.x * LogitsGemm::BM, blockIdx.y * LogitsGemm::BN, d,
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

template <typename Kernel>
int prepare(Kernel kernel, int smem_bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem_bytes);
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// the forward's vocab tile: the wrapper sizes the partials with it
int dlrover_ce_tile() { return FWD_TILE; }

int dlrover_ce_fwd(const void* x, const void* w, const void* tgt, void* part, int n, int d,
                   int vp, int v, void* stream) {
  typedef LogitsGemm G;
  CUtensorMap x_map, w_map;
  int err = G::map_a(&x_map, x, n, d, d);
  if (!err) err = G::map_b(&w_map, w, vp, d, vp);
  if (!err) err = prepare(fused_ce_fwd_kernel, G::SMEM_BYTES);
  if (err) return err;
  const int ntiles = cdiv(v, FWD_TILE);
  fused_ce_fwd_kernel<<<dim3(cdiv(n, G::BM), ntiles), G::THREADS, G::SMEM_BYTES,
                        (cudaStream_t)stream>>>(x_map, w_map, (const int*)tgt, (float*)part, n,
                                                d, v, ntiles);
  return (int)cudaGetLastError();
}

int dlrover_ce_merge(const void* part, void* logz, void* gold, int n, int ntiles,
                     void* stream) {
  fused_ce_merge_kernel<<<cdiv(n, MERGE_TOKENS), MERGE_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)part, (float*)logz, (float*)gold, n, ntiles);
  return (int)cudaGetLastError();
}

int dlrover_ce_bwd_q(const void* x, const void* w, const void* tgt, const void* logz,
                     const void* scale, void* q, int n, int d, int vp, int v, int c0, int cw,
                     void* stream) {
  typedef LogitsGemm G;
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
