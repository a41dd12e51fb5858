// A Hopper (sm_90a) GEMM main loop: TMA loads into an mbarrier ring, wgmma
// from shared memory, one producer warpgroup and two consumer warpgroups.
//
// Gemm<A_MN, B_MN>::run computes one 128 x 256 tile of
// C = A (M x K) @ B (K x N) with bf16 operands and f32 accumulators in
// registers, then hands the accumulators to the caller's epilogue. A grid
// of one block a tile; a persistent grid (one block an SM walking the
// tiles) measured no faster on the card.
//
// Operand majors, fixed at compile time:
//   A_MN = false: A is [m][k], k contiguous (K-major); true: A is [k][m].
//   B_MN = false: B is [n][k], k contiguous (K-major); true: B is [k][n].
// Each operand is read through a 2D tensor map whose inner dimension is the
// contiguous one, under 128-byte swizzle. A box's inner extent is 64 bf16
// (128 bytes, the swizzle's width), so K steps are 64 deep, a K-major tile
// of R rows arrives as one [R][64] box and an MN-major tile W wide as W / 64
// boxes of [64][64]. TMA fills zeros outside the map's bounds, so ragged
// M, N and K edges need no masking here; the epilogue masks its stores.
//
// Roles (384 threads):
//   warpgroup 0, producer: drops to 40 registers (setmaxnreg); one thread
//     walks K, waits on each stage's "empty" barrier, arms its "full"
//     barrier with the stage's byte count and issues the stage's TMA loads.
//   warpgroups 1 and 2, consumers: 232 registers each; each owns 64 rows of
//     the tile (128 f32 accumulators a thread), waits on a stage's "full"
//     barrier, issues four m64n256k16 wgmma on it, and releases the stage one
//     K step later, once the next step's wgmma group is in flight.
// The ring has 4 stages of 48 KB (the tile and depth are chosen in
// fused_ce.cu's note).
// No __syncthreads() runs after the barriers are initialised.
//
// Host side: map_a / map_b build each operand's tensor map for a launch;
// cuTensorMapEncodeTiled is reached through cudaGetDriverEntryPoint, so the
// library needs no link against libcuda.
//
// Beside the loop, the pieces flash attention's forward (flash_attn.cu)
// builds its own warp-specialised loop from: rank-4 TMA loads and maps
// (encode_tiled), and m64n64k16 / m64n128k16 wgmma with A from shared
// memory (wgmma_ss) or from registers (wgmma_rs).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

// ---- PTX wrappers -------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// returns once the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// box at (inner, outer) element coordinates -> shared, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int inner, int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(inner), "r"(outer)
      : "memory");
}

// box at element coordinates (c0 innermost) of a rank-4 map -> shared
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulators while a wgmma owns them
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the same for registers a wgmma reads as its A operand
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | 1ull << 62;
}

#define SM90_ACC8(i)                                                                 \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),        \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define SM90_ACC64                                                                   \
  SM90_ACC8(0), SM90_ACC8(8), SM90_ACC8(16), SM90_ACC8(24), SM90_ACC8(32),           \
      SM90_ACC8(40), SM90_ACC8(48), SM90_ACC8(56)
#define SM90_REGS64                                                                  \
  "%0, %1, %2, %3, %4, %5, %6, %7, "                                                 \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                                           \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                                         \
  "%24, %25, %26, %27, %28, %29, %30, %31, "                                         \
  "%32, %33, %34, %35, %36, %37, %38, %39, "                                         \
  "%40, %41, %42, %43, %44, %45, %46, %47, "                                         \
  "%48, %49, %50, %51, %52, %53, %54, %55, "                                         \
  "%56, %57, %58, %59, %60, %61, %62, %63"

// d (64 x 256 f32, the warpgroup's fragment) += A (64 x 16) @ B (16 x 256),
// both bf16 in shared memory; TA / TB: the operand is MN-major
template <bool TA, bool TB>
__device__ __forceinline__ void wgmma(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" SM90_REGS64 ", "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      : SM90_ACC64, SM90_ACC8(64), SM90_ACC8(72), SM90_ACC8(80), SM90_ACC8(88),
        SM90_ACC8(96), SM90_ACC8(104), SM90_ACC8(112), SM90_ACC8(120)
      : "l"(da), "l"(db), "r"(1), "n"(int(TA)), "n"(int(TB)));
}

// Narrower shapes, for flash attention: d (64 x N f32) += A (64 x 16) @ B
// (16 x N), N = 64 or 128, bf16 operands. wgmma_ss reads both operands
// from shared memory (both K-major); wgmma_rs takes A from registers as four
// bf16x2 words a thread in the layout of mma.sync's m16n8k16 A fragment
// (warp w of the warpgroup holds rows 16 w .. 16 w + 15), the layout in
// which the accumulators of a previous product already lie (lane l holds
// acc[4 i + 2 h + e] = C[16 w + l / 4 + 8 h][8 i + 2 (l % 4) + e]), so an
// accumulator tile converts to an A operand without moving between
// threads. TB: B is MN-major.
#define SM90_ACC32 SM90_ACC8(0), SM90_ACC8(8), SM90_ACC8(16), SM90_ACC8(24)
#define SM90_REGS32                                                                  \
  "%0, %1, %2, %3, %4, %5, %6, %7, "                                                 \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                                           \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                                         \
  "%24, %25, %26, %27, %28, %29, %30, %31"

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db) {
  static_assert(N == 64 || N == 128, "n64 or n128");
  if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" SM90_REGS64 "}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : SM90_ACC64
        : "l"(da), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" SM90_REGS32 "}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : SM90_ACC32
        : "l"(da), "l"(db), "r"(1));
  }
}

template <int N, bool TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  static_assert(N == 64 || N == 128, "n64 or n128");
  if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" SM90_REGS64 "}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : SM90_ACC64
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(int(TB)));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" SM90_REGS32 "}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : SM90_ACC32
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(int(TB)));
  }
}

#undef SM90_ACC8
#undef SM90_ACC32
#undef SM90_ACC64
#undef SM90_REGS32
#undef SM90_REGS64

// ---- host: tensor maps -----------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// a bf16 tensor of `rank` dimensions (dims[0] innermost, contiguous;
// strides[i] the byte stride of dimension i + 1, a multiple of 16; base
// 16-byte aligned), read in boxes of box[] elements whose inner extent is 64
// (128 bytes), under 128-byte swizzle; elements outside the dims read as
// zeros. Returns a cudaError_t.
static inline int encode_tiled(CUtensorMap* map, const void* base, int rank,
                               const cuuint64_t* dims, const cuuint64_t* strides,
                               const cuuint32_t* box) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  const CUresult res =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
             strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// a row-major bf16 matrix of `outer` rows of `inner` elements, row stride
// ld elements (a multiple of 8; base 16-byte aligned), read in boxes of
// [box_outer][64]
static inline int encode_map(CUtensorMap* map, const void* base, int inner, int outer,
                             long ld, int box_outer) {
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_outer};
  return encode_tiled(map, base, 2, dims, strides, box);
}

// ---- the main loop ---------------------------------------------------------------

template <bool A_MN, bool B_MN>
struct Gemm {
  static constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;
  static constexpr int THREADS = 384;
  static constexpr int ACC = BN / 2;  // accumulators a consumer thread holds
  static constexpr int A_BYTES = BM * BK * 2, B_BYTES = BN * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // the ring, its barriers, and slack to round the ring up to 1024 bytes
  static constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
  static_assert(SMEM_BYTES <= 232448, "fits a block's shared memory");

  // A (M x K): [m][k] with row stride lda, or [k][m] when A_MN
  static int map_a(CUtensorMap* map, const void* a, int M, int K, long lda) {
    return A_MN ? encode_map(map, a, M, K, lda, BK) : encode_map(map, a, K, M, lda, BM);
  }

  // B (K x N): [n][k] with row stride ldb, or [k][n] when B_MN
  static int map_b(CUtensorMap* map, const void* b, int N, int K, long ldb) {
    return B_MN ? encode_map(map, b, N, K, ldb, BK) : encode_map(map, b, K, N, ldb, BN);
  }

  // The tile at (m0, n0) over K. epi(acc, row, col) runs on each consumer
  // thread: acc[4 i + 2 h + e] is C[row + 8 h][col + 8 i + e].
  template <class Epilogue>
  static __device__ __forceinline__ void run(const CUtensorMap* ta, const CUtensorMap* tb,
                                             int m0, int n0, int K, const Epilogue& epi) {
    extern __shared__ unsigned char sm90_smem[];
    // 128-byte swizzle repeats every 1024 bytes and the descriptors assume
    // each box starts on that boundary; dynamic shared memory is only
    // guaranteed to be 16-byte aligned
    const uint32_t ring = (smem_u32(sm90_smem) + 1023u) & ~1023u;
    const uint32_t full = ring + STAGES * STAGE_BYTES, empty = full + STAGES * 8;
    const int nk = (K + BK - 1) / BK;
    const int wg = threadIdx.x / 128;

    if (threadIdx.x == 0) {
#pragma unroll
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(full + 8 * s, 1);   // the producer's arrive, plus the bytes
        mbar_init(empty + 8 * s, 2);  // one arrive per consumer warpgroup
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (wg == 0) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
      if (threadIdx.x == 0) {
        for (int kt = 0; kt < nk; ++kt) {
          const int s = kt % STAGES, k0 = kt * BK;
          mbar_wait(empty + 8 * s, ((kt / STAGES) & 1) ^ 1);
          const uint32_t a = ring + s * STAGE_BYTES, b = a + A_BYTES, bar = full + 8 * s;
          mbar_expect_tx(bar, STAGE_BYTES);
          if (A_MN) {
#pragma unroll
            for (int j = 0; j < BM / 64; ++j)
              tma_load(a + j * BK * 128, ta, bar, m0 + 64 * j, k0);
          } else {
            tma_load(a, ta, bar, k0, m0);
          }
          if (B_MN) {
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              tma_load(b + j * BK * 128, tb, bar, n0 + 64 * j, k0);
          } else {
            tma_load(b, tb, bar, k0, n0);
          }
        }
      }
    } else {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
      const int c = wg - 1;  // this warpgroup's 64 rows of the tile
      // K-major: rows of 128 bytes, 8-row groups 1024 apart, a k16 step is
      // 32 bytes along the row. MN-major: [64][64] boxes BK * 128 bytes
      // apart (LBO), 8-deep K groups 1024 apart (SBO), a k16 step is 16
      // rows of 128 bytes.
      const uint64_t da = A_MN ? smem_desc(ring + c * BK * 128, BK * 128, 1024)
                               : smem_desc(ring + c * 64 * 128, 16, 1024);
      const uint64_t db = B_MN ? smem_desc(ring + A_BYTES, BK * 128, 1024)
                               : smem_desc(ring + A_BYTES, 16, 1024);
      constexpr uint32_t A_STEP = (A_MN ? 16 * 128 : 32) >> 4;
      constexpr uint32_t B_STEP = (B_MN ? 16 * 128 : 32) >> 4;

      float acc[ACC];
#pragma unroll
      for (int i = 0; i < ACC; ++i) acc[i] = 0.0f;
      fence_acc(acc);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(full + 8 * s, (kt / STAGES) & 1);
        const uint64_t off = (uint64_t)((s * STAGE_BYTES) >> 4);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma<A_MN, B_MN>(acc, da + off + kk * A_STEP, db + off + kk * B_STEP);
        wgmma_commit();
        fence_acc(acc);
        wgmma_wait<1>();  // the previous step's group has read its stage
        if (kt > 0 && threadIdx.x % 128 == 0) mbar_arrive(empty + 8 * ((kt - 1) % STAGES));
      }
      wgmma_wait<0>();
      fence_acc(acc);
      const int lane = threadIdx.x % 32;
      epi(acc, m0 + 64 * c + 16 * ((threadIdx.x / 32) % 4) + lane / 4, n0 + 2 * (lane % 4));
    }
  }
};

}  // namespace sm90
