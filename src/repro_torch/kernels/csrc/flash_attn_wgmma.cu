// Causal flash-attention forward in bf16 or f16 on Hopper's tensor cores:
// TMA loads into a shared-memory ring, wgmma for both products.
//
// Replaces, for bf16 and f16, the TPU kernel flash_attention_fwd
// (src/repro/kernels/flash_attn.py, _flash_kernel), and computes its
// function: q [BH, S, hd], k and v [BH, Sk, hd] in bf16 (or f16);
// scores (q . k) * hd^-0.5 accumulated in f32; mask k_pos <= q_pos on
// absolute positions (aligned at the start, also when Sk != S); an online
// softmax in f32; P rounded to the input type before P.V, as the reference
// casts it to v's dtype; the output acc / l (l summed from the f32 P)
// rounded to the input type.  f16 has bf16's layout and instructions with
// .f16 in place of .bf16 (template flag F16).  The f32 path is
// flash_attn_tf32.cu.
//
// What bounds it on this card: at S = Sk = 8192, hd = 128 the causal
// products are about 5.5e11 FLOP on 0.27 GB of inputs, so the tensor
// cores' bf16 rate (989 TFLOP/s, SXM data sheet) bounds it, not memory.
// What the design does about that:
//   - One block per (bh, 128-row q tile): two warpgroups of 64 q rows
//     each.  Blocks run the heaviest q tiles (the most keys under the
//     diagonal) first, so the causal tail does not leave SMs idle.
//   - TMA loads the q tile once and K and V tiles of 128 keys through a
//     three-stage ring, with full and empty mbarriers kept apart for K and
//     V; the tensor maps are rank 3 over [BH, rows, hd], so a ragged last
//     tile reads zeros, never the next head's rows.  Tiles wholly above
//     the diagonal are not loaded.  One thread of the second warpgroup
//     refills stages while its own products run; K and V land a step or
//     more before they are read.
//   - S = Q K^T is a wgmma m64n128k16 with Q and K from shared memory; P
//     goes from the S accumulator's registers straight into the A operand
//     of the P.V wgmma (m64n{hd}k16, A from registers, V from shared
//     memory with the transpose bit, since V is [keys, hd] row-major).
//   - The tensor cores are kept busy through the softmax: a warpgroup
//     issues S of tile t together with P.V of tile t - 1 and runs tile t's
//     softmax while P.V runs, and the two warpgroups take turns issuing
//     (named barriers), so one's softmax overlaps the other's products.
//   - Rows of 64 bf16 (128 B) are TMA boxes with the 128-byte swizzle, so
//     an hd-128 tile arrives as two boxes and the wgmma descriptors step
//     across them; hd 32 (64-byte rows) uses the 64-byte swizzle.  The
//     descriptors' swizzle mode always equals the tensor map's.
//   - Registers: with the overlap a thread holds S (64 f32), O (hd / 2
//     f32) and P (32 words) at once, 199 registers at hd 128.  So the
//     block is the two warpgroups alone, 256 threads, for which ptxas may
//     use up to 255 registers a thread.  A block of 288 or 384 threads,
//     as a producer warp or warpgroup needs, is held to 168 and spills
//     unless setmaxnreg raises the consumers (tools/flash_ablation.py).
//   - Masks are applied only on tiles that cross the diagonal or the Sk
//     edge; rows past S are computed on zeros and never stored.
//
// Interface (flash_attn_wgmma_launch for bf16, flash_attn_wgmma_f16_launch
// for f16): q, k, v, o device pointers (contiguous, 16-byte aligned), bh,
// s, sk, hd in {32, 64, 128}, scale.  Grid (BH, ceil(S / 128)), 256
// threads, up to 226 KB of dynamic shared memory.  Launches on the given
// stream and does not synchronise; returns cudaGetLastError(), or
// cudaErrorInvalidValue for an unsupported hd, a misaligned pointer or
// more than 65535 q tiles, or cudaErrorNotSupported when the driver has no
// cuTensorMapEncodeTiled.

#include <cuda.h>  // CUtensorMap and its enums only: no driver-API link
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 128;                 // q rows per block
constexpr int kBK = 128;                 // keys per K/V tile
constexpr int kStages = 3;               // K/V ring depth
constexpr int kWarps = 8;                // two warpgroups
constexpr int kThreads = 32 * kWarps;
constexpr int kRefiller = 128;           // first thread of warpgroup 1
constexpr int kMaxQTiles = 65535;        // gridDim.y
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
// polls of an mbarrier before the kernel traps: a lost arrival becomes a
// launch error instead of a hang (a real wait is microseconds)
constexpr uint32_t kSpinLimit = 1u << 24;

template <int HD>
struct Cfg {
  static constexpr int kBoxCols = HD < 64 ? HD : 64;  // bf16 per box row
  static constexpr int kRowBytes = 2 * kBoxCols;      // 64 or 128
  static constexpr int kBoxes = HD / kBoxCols;        // boxes per tile
  static constexpr int kKSteps = kRowBytes / 32;      // k16 steps per box
  static constexpr int kQBytes = kBQ * HD * 2;
  static constexpr int kKVBytes = kBK * HD * 2;       // one K or V tile
  // wgmma descriptor layout type: 1 = 128-byte swizzle, 2 = 64-byte
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;
  // q tile, the K and V rings, 1 + 4 kStages mbarriers, and slack to
  // align to 1024
  static constexpr int kSmem = kQBytes + 2 * kStages * kKVBytes + 128 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (i == kSpinLimit) __trap();
  }
}

// one TMA box of a rank-3 map at (column, row, bh) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of wgmma are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// named barriers over the block's 256 threads: one warpgroup syncs while
// the other arrives
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// Keep the compiler from moving reads of an accumulator above the wait of
// the wgmma that writes it, or reusing an A-operand register before the
// wgmma that reads it has completed.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ uint64_t desc_bits(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32) |
         (layout << 62);
}

// K-major operand (Q or K: hd contiguous) from a swizzled box: 8-row
// groups kRowBytes * 8 apart; the leading offset is unused.
template <class C>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return desc_bits(addr, 16, 8 * C::kRowBytes, C::kLayout);
}

// MN-major operand (V: hd contiguous, keys the reduction axis): 64-column
// boxes kBK * kRowBytes apart (leading), 8-key groups 8 * kRowBytes apart
template <class C>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) {
  return desc_bits(addr, kBK * C::kRowBytes, 8 * C::kRowBytes, C::kLayout);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two f32 rounded to nearest into one register of bf16 or f16 (lo first)
template <bool F16>
__device__ __forceinline__ uint32_t pack_half(float lo, float hi) {
  if constexpr (F16) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

// wgmma wrappers: D (f32, m64nN) += A (T, m64k16) * B (T, k16nN), T bf16
// or f16 (one layout: only the type in the instruction differs).
// The accumulator fragment of thread (warp w, lane l) holds row
// 16 w + l / 4 (+ 8 for elements 4 j + 2, 4 j + 3) and columns
// 8 j + 2 (l % 4) + {0, 1}.  ss: A and B from shared memory, both K-major,
// D overwritten when acc == 0.  rs: A from registers (the m16k16 fragment
// of mma.sync), B MN-major (transpose bit), D accumulated.
#define REPRO_WGMMA_SS_N128(T)                                    \
  asm volatile(                                                   \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." T "." T " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                          \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                    \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                  \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                  \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                  \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                  \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                  \
      "%56, %57, %58, %59, %60, %61, %62, %63"                    \
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                          \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),           \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),           \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),         \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),       \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),       \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),       \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),       \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),       \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),       \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),       \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),       \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),       \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),       \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),       \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])        \
      : "l"(da), "l"(db), "r"(acc))
template <bool F16>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int acc) {
  if constexpr (F16) {
    REPRO_WGMMA_SS_N128("f16");
  } else {
    REPRO_WGMMA_SS_N128("bf16");
  }
}

#define REPRO_WGMMA_RS_N32(T)                                    \
  asm volatile(                                                  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"               \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." T "." T " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                         \
      "%8, %9, %10, %11, %12, %13, %14, %15"                     \
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"           \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),          \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),          \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),        \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])       \
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1))
template <bool F16>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3,
                                             uint64_t db) {
  if constexpr (F16) {
    REPRO_WGMMA_RS_N32("f16");
  } else {
    REPRO_WGMMA_RS_N32("bf16");
  }
}

#define REPRO_WGMMA_RS_N64(T)                                    \
  asm volatile(                                                  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"               \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." T "." T " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                         \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                   \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                 \
      "%24, %25, %26, %27, %28, %29, %30, %31"                   \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"           \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),          \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),          \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),        \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),      \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),      \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),      \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])       \
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1))
template <bool F16>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3,
                                             uint64_t db) {
  if constexpr (F16) {
    REPRO_WGMMA_RS_N64("f16");
  } else {
    REPRO_WGMMA_RS_N64("bf16");
  }
}

#define REPRO_WGMMA_RS_N128(T)                                    \
  asm volatile(                                                   \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." T "." T " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                          \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                    \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                  \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                  \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                  \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                  \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                  \
      "%56, %57, %58, %59, %60, %61, %62, %63"                    \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"            \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),           \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),           \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),         \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),       \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),       \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),       \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),       \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),       \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),       \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),       \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),       \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),       \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),       \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),       \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])        \
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1))
template <bool F16>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3,
                                             uint64_t db) {
  if constexpr (F16) {
    REPRO_WGMMA_RS_N128("f16");
  } else {
    REPRO_WGMMA_RS_N128("bf16");
  }
}

// A thread's two rows of the online softmax (rows r0 and r0 + 8): the
// running max m (log2 domain), the normaliser l, and the correction of
// the output accumulator that the last tile's new max calls for.
struct RowState {
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};
  float corr[2] = {1.f, 1.f};
};

// S = Q K^T of one k/v tile into s (m64n128, k over hd), one wgmma group
template <int HD, bool F16>
__device__ __forceinline__ void issue_s(float (&s)[kBK / 2], uint32_t sq_wg,
                                        uint32_t sk) {
  using C = Cfg<HD>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t box = kk / C::kKSteps, col = 32 * (kk % C::kKSteps);
    wgmma_ss_n128<F16>(s, kmajor_desc<C>(sq_wg + box * kBQ * C::kRowBytes + col),
                  kmajor_desc<C>(sk + box * kBK * C::kRowBytes + col), kk > 0);
  }
  wgmma_commit();
}

// O = O * corr + P V of one k/v tile (k over the tile's keys), one group
template <int HD, bool F16>
__device__ __forceinline__ void issue_pv(float (&acc)[HD / 2],
                                         const uint32_t (&p)[kBK / 4],
                                         const RowState& rows, uint32_t sv) {
  using C = Cfg<HD>;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    acc[4 * j] *= rows.corr[0];
    acc[4 * j + 1] *= rows.corr[0];
    acc[4 * j + 2] *= rows.corr[1];
    acc[4 * j + 3] *= rows.corr[1];
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint64_t db = mnmajor_desc<C>(sv + kk * 16 * C::kRowBytes);
    if constexpr (HD == 32) {
      wgmma_rs_n32<F16>(acc, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                   p[4 * kk + 3], db);
    } else if constexpr (HD == 64) {
      wgmma_rs_n64<F16>(acc, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                   p[4 * kk + 3], db);
    } else {
      wgmma_rs_n128<F16>(acc, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                    p[4 * kk + 3], db);
    }
  }
  wgmma_commit();
}

// Online softmax of the tile of keys k0 .. k0 + 127 in the log2 domain
// (scale_log2 = scale * log2 e; m is kept scaled): keys past row r or past
// Sk are masked only when the tile crosses the diagonal or the Sk edge,
// so other tiles pay nothing for the mask; P (f32) is left in s.
__device__ __forceinline__ void softmax_tile(float (&s)[kBK / 2],
                                             RowState& rows, int k0,
                                             bool masked, int r0, int cq,
                                             int Sk, float scale_log2) {
  if (masked) {
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // row r0 + 8 (e / 2), key 8 j + cq + e % 2
        const int key = k0 + 8 * j + cq + (e & 1);
        if (key > r0 + 8 * (e >> 1) || key >= Sk) s[4 * j + e] = kNeg;
      }
    }
  }
  float mx[2] = {kNeg, kNeg};
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // a row's 128 scores live in the 4 lanes of one quad
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(rows.m[h], mx[h] * scale_log2);
    rows.corr[h] = ex2(rows.m[h] - m_new);
    rows.m[h] = m_new;
  }
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = ex2(fmaf(s[4 * j + e], scale_log2, -rows.m[e >> 1]));
      sum[e >> 1] += s[4 * j + e];
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    rows.l[h] = rows.l[h] * rows.corr[h] + sum[h];
  }
}

// P in bf16 or f16: the S fragment of keys 16 kk .. 16 kk + 15 is the A
// fragment of the P.V k step kk, two adjacent keys per register
template <bool F16>
__device__ __forceinline__ void pack_p(uint32_t (&p)[kBK / 4],
                                       const float (&s)[kBK / 2]) {
#pragma unroll
  for (int i = 0; i < kBK / 4; ++i)
    p[i] = pack_half<F16>(s[2 * i], s[2 * i + 1]);
}

// this warp is done with a K or V tile
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// one thread loads a tile (kBQ or kBK rows from row0 of head bh, all hd
// columns, as kBoxes boxes) into shared memory at dst, completing on bar
template <int HD>
__device__ __forceinline__ void load_tile(const CUtensorMap* map,
                                          uint32_t dst, uint32_t bar,
                                          int row0, int bh) {
  using C = Cfg<HD>;
  mbar_expect_tx(bar, kBK * HD * 2);
#pragma unroll
  for (int b = 0; b < C::kBoxes; ++b)
    tma_load(dst + b * kBK * C::kRowBytes, map, b * C::kBoxCols, row0, bh,
             bar);
}

template <int HD, bool F16>
__global__ void __launch_bounds__(kThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       uint16_t* __restrict__ o, int S, int Sk,
                       float scale_log2) {
  using C = Cfg<HD>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk0 = sq + C::kQBytes;              // + s kKVBytes: K, stage s
  const uint32_t sv0 = sk0 + kStages * C::kKVBytes;  // + s kKVBytes: V, stage s
  const uint32_t bar_q = sv0 + kStages * C::kKVBytes;
  const uint32_t bar_k = bar_q + 8;                   // + 8 s: K of stage s in
  const uint32_t bar_v = bar_k + 8 * kStages;         // + 8 s: V of stage s in
  const uint32_t bar_kfree = bar_v + 8 * kStages;     // + 8 s: K of s read
  const uint32_t bar_vfree = bar_kfree + 8 * kStages; // + 8 s: V of s read
  auto sk = [&](int t) { return sk0 + (t % kStages) * C::kKVBytes; };
  auto sv = [&](int t) { return sv0 + (t % kStages) * C::kKVBytes; };

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest tiles first
  const int q_last = min(q0 + kBQ, S) - 1;
  // k tiles up to the one holding the block's last query (causal skip)
  const int n_tiles = min((Sk + kBK - 1) / kBK, q_last / kBK + 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_kfree + 8 * s, kWarps);
      mbar_init(bar_vfree + 8 * s, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    load_tile<HD>(&tm_q, sq, bar_q, q0, bh);
    for (int t = 0; t < kStages && t < n_tiles; ++t) {
      load_tile<HD>(&tm_k, sk(t), bar_k + 8 * t, t * kBK, bh);
      load_tile<HD>(&tm_v, sv(t), bar_v + 8 * t, t * kBK, bh);
    }
  }
  __syncthreads();

  // warpgroup wg owns q rows q0 + 64 wg .. + 63; this thread rows r0 and
  // r0 + 8, columns 8 j + cq + {0, 1} of each fragment
  const int wg = warp >> 2;
  const int q_wg = q0 + 64 * wg;
  const int r0 = q_wg + 16 * (warp & 3) + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const uint32_t sq_wg = sq + 64 * wg * C::kRowBytes;
  // the tile of keys from k0 crosses the diagonal or the Sk edge
  auto masked = [&](int k0) { return k0 + kBK - 1 > q_wg || k0 + kBK > Sk; };
  // The first thread of warpgroup 1, which issues its products second,
  // refills the ring while its own products run: at step t, K of tile
  // t + 2 into the stage of tile t - 1 and V of tile t + 1 into that of
  // tile t - 2, which both warpgroups released a step before, so it
  // hardly ever waits, and each tile lands a step or more before use.
  const bool refiller = threadIdx.x == kRefiller;
  auto refill = [&](int t) {
    const int tk = t - 1, tv = t - 2;  // tiles whose stages are reused
    if (refiller && tk + kStages < n_tiles) {
      mbar_wait(bar_kfree + 8 * (tk % kStages), (tk / kStages) & 1);
      load_tile<HD>(&tm_k, sk(tk), bar_k + 8 * (tk % kStages),
                    (tk + kStages) * kBK, bh);
    }
    if (refiller && tv >= 0 && tv + kStages < n_tiles) {
      mbar_wait(bar_vfree + 8 * (tv % kStages), (tv / kStages) & 1);
      load_tile<HD>(&tm_v, sv(tv), bar_v + 8 * (tv % kStages),
                    (tv + kStages) * kBK, bh);
    }
    __syncwarp();
  };

  float acc[HD / 2];
  float s[kBK / 2];
  uint32_t p[kBK / 4];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) s[i] = 0.f;
  RowState rows;

  // Step t issues S of tile t together with P.V of tile t - 1 and runs
  // tile t's softmax while P.V is still on the tensor cores.  The
  // warpgroups take turns to issue (named barriers 1 and 2, warpgroup 0
  // first), so one's softmax overlaps the other's products.  No wgmma
  // sits under a branch (ptxas would serialise them), so the first S and
  // the last P.V are issued outside the loop.
  const int my_turn = 1 + wg, next_turn = 2 - wg;
  if (wg == 1) named_arrive(1);
  mbar_wait(bar_q, 0);
  mbar_wait(bar_k, 0);
  named_sync(my_turn);
  issue_s<HD, F16>(s, sq_wg, sk(0));
  named_arrive(next_turn);
  wgmma_wait<0>();
  fence_regs(s);
  release(bar_kfree, lane);
  softmax_tile(s, rows, 0, masked(0), r0, cq, Sk, scale_log2);
  pack_p<F16>(p, s);
  for (int t = 1; t < n_tiles; ++t) {
    const int st = t % kStages, pst = (t - 1) % kStages;
    mbar_wait(bar_k + 8 * st, (t / kStages) & 1);
    mbar_wait(bar_v + 8 * pst, ((t - 1) / kStages) & 1);
    named_sync(my_turn);
    issue_s<HD, F16>(s, sq_wg, sk(t));
    issue_pv<HD, F16>(acc, p, rows, sv(t - 1));
    named_arrive(next_turn);
    refill(t);
    wgmma_wait<1>();
    fence_regs(s);
    release(bar_kfree + 8 * st, lane);
    softmax_tile(s, rows, t * kBK, masked(t * kBK), r0, cq, Sk, scale_log2);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(p);
    release(bar_vfree + 8 * pst, lane);
    pack_p<F16>(p, s);
  }
  const int last = n_tiles - 1;
  mbar_wait(bar_v + 8 * (last % kStages), (last / kStages) & 1);
  named_sync(my_turn);
  issue_pv<HD, F16>(acc, p, rows, sv(last));
  if (wg == 0) named_arrive(next_turn);  // warpgroup 1 issues last
  wgmma_wait<0>();
  fence_regs(acc);

  // o = acc / l in bf16 or f16, rows past S dropped
  const long long row = static_cast<long long>(bh) * S + r0;
  if (r0 < S) {
    uint32_t* out = reinterpret_cast<uint32_t*>(o + row * HD + cq);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      out[4 * j] = pack_half<F16>(acc[4 * j] / rows.l[0],
                             acc[4 * j + 1] / rows.l[0]);
  }
  if (r0 + 8 < S) {
    uint32_t* out = reinterpret_cast<uint32_t*>(o + (row + 8) * HD + cq);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      out[4 * j] = pack_half<F16>(acc[4 * j + 2] / rows.l[1],
                             acc[4 * j + 3] / rows.l[1]);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found at run time so the library
// links against the runtime only
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// rank-3 map over [bh, rows, hd] bf16 or f16; boxes of 128 rows by up to
// 64 columns, swizzled as wide as a box row, zeros outside the tensor
int make_map(CUtensorMap* map, const void* ptr, int bh, int rows, int hd,
             bool f16) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint32_t box_cols = hd < 64 ? hd : 64;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(rows) * hd * 2};
  const cuuint32_t box[3] = {box_cols, kBQ, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map,
      f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      3, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int HD, bool F16>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int s, int sk, float scale, cudaStream_t stream) {
  static_assert(kBQ == kBK, "one box height serves q and k/v maps");
  CUtensorMap mq, mk, mv;
  int err = make_map(&mq, q, bh, s, HD, F16);
  if (!err) err = make_map(&mk, k, bh, sk, HD, F16);
  if (!err) err = make_map(&mv, v, bh, sk, HD, F16);
  if (err) return err;
  auto kernel = flash_wgmma_kernel<HD, F16>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<HD>::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>(bh),
                  static_cast<unsigned>((s + kBQ - 1) / kBQ));
  kernel<<<grid, kThreads, Cfg<HD>::kSmem, stream>>>(
      mq, mk, mv, static_cast<uint16_t*>(o), s, sk, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <bool F16>
int dispatch(const void* q, const void* k, const void* v, void* o, int bh,
             int s, int sk, int hd, float scale, void* stream) {
  if (bh <= 0 || s <= 0 || sk <= 0) return 0;
  const uintptr_t align = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) |
                          reinterpret_cast<uintptr_t>(o);
  if (align % 16 || (s + kBQ - 1) / kBQ > kMaxQTiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch<32, F16>(q, k, v, o, bh, s, sk, scale, st);
    case 64:
      return launch<64, F16>(q, k, v, o, bh, s, sk, scale, st);
    case 128:
      return launch<128, F16>(q, k, v, o, bh, s, sk, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_attn_wgmma_launch(const void* q, const void* k,
                                       const void* v, void* o, int bh, int s,
                                       int sk, int hd, float scale,
                                       void* stream) {
  return dispatch<false>(q, k, v, o, bh, s, sk, hd, scale, stream);
}

extern "C" int flash_attn_wgmma_f16_launch(const void* q, const void* k,
                                           const void* v, void* o, int bh,
                                           int s, int sk, int hd, float scale,
                                           void* stream) {
  return dispatch<true>(q, k, v, o, bh, s, sk, hd, scale, stream);
}
