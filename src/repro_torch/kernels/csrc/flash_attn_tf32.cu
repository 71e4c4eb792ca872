// Causal flash-attention forward in f32 on Hopper's tensor cores, as
// error-compensated 3xTF32 wgmma, with a pre-pass that splits the inputs.
//
// Replaces, for f32, the TPU kernel flash_attention_fwd (src/repro/
// kernels/flash_attn.py, _flash_kernel), and computes its function: q
// [BH, S, hd], k and v [BH, Sk, hd] in f32; scores (q . k) * hd^-0.5; mask
// k_pos <= q_pos on absolute positions (aligned at the start, also when
// Sk != S); key tiles wholly above the diagonal skipped; an online softmax
// in f32; the output acc / l in f32.  The bf16 path is flash_attn_wgmma.cu.
//
// What bounds it on this card: at S = Sk = 8192, hd = 128 the causal
// products are 5.5e11 FLOP.  TF32 keeps 11 significant bits, too few for
// the reference's 2e-5, so each f32 operand x is split into a TF32 high
// part hi = rna(x) and a low part lo = rna(x - hi) (x - hi is exact), and
// each product is hi.hi + hi.lo + lo.hi (the dropped lo.lo is about 2^-22
// of it): three TF32 products at 495 TFLOP/s (SXM data sheet), 3.3 ms,
// against 8.2 ms for plain f32 FMAs on the CUDA cores.  So the tensor
// cores bound it.  What the design does about that:
//   - A pre-pass (tf32_split_kernel, elementwise, bound by its 1.2 GB of
//     traffic) writes q_hi, q_lo, k_hi, k_lo and V transposed to
//     vt_hi, vt_lo [BH, hd, sk_pad], zero past Sk.  wgmma takes tf32
//     operands from shared memory only K-major (the transpose bit exists
//     for 16-bit types alone), and P.V reduces over keys, so vT puts keys
//     innermost.  After it every operand of the main kernel is a K-major
//     TMA tile, and the main loop splits nothing but P.
//   - Within every group of 8 keys the pre-pass stores vT's keys in the
//     order 0, 2, 4, 6, 1, 3, 5, 7.  The S accumulator of a thread holds
//     keys 2t and 2t + 1 (t = lane % 4) of each 8-key block, while the
//     m64k8 tf32 A fragment takes k slots t and t + 4; with vT permuted
//     so, the S registers are the A fragment of P.V as they stand.
//   - One block per (bh, 128-row q tile), two warpgroups of 64 rows,
//     heaviest q tiles first.  TMA loads q_hi and q_lo once (128 KB at
//     hd 128) and tiles of 32 keys (k_hi + k_lo, or vt_hi + vt_lo, 32 KB)
//     through one three-slot ring in the order K0, V0, K1, V1, ...; one
//     thread of warpgroup 1 refills a slot once both warpgroups released
//     it.  Rank-3 maps over [BH, rows, cols] read zeros past S and Sk.
//   - S = Qhi.Klo + Qlo.Khi + Qhi.Khi (small terms first), 3 hd / 8
//     wgmma m64n32k8 with both operands from shared memory; O += Plo.vThi
//     + Phi.vTlo + Phi.vThi, 12 wgmma m64n{hd}k8 with P from registers,
//     split with the same rna.  The row sum l adds the unsplit f32 P.
//   - A box row of the 128-byte swizzle holds 32 f32, so an hd-128 row is
//     4 boxes; a k8 step of tf32 is 32 bytes, and the K-major descriptors
//     step 32 bytes inside a box row and then to the next box.
//   - Masks only on tiles that cross the diagonal or the Sk edge; ex2 with
//     the scale folded into one FFMA; rows past S are computed on zeros
//     and never stored.
//
// Interface: flash_tf32_split_launch(q, k, v, q_hi, q_lo, k_hi, k_lo,
// vt_hi, vt_lo, bh, s, sk, sk_pad, hd, stream) and flash_attn_tf32_launch(
// q_hi, q_lo, k_hi, k_lo, vt_hi, vt_lo, o, bh, s, sk, sk_pad, hd, scale,
// stream): f32 device pointers, contiguous and 16-byte aligned; hd in
// {32, 64, 128}; sk_pad a multiple of 32 at least sk.  Both launch on the
// given stream without synchronising and return cudaGetLastError(), or
// cudaErrorInvalidValue for an unsupported argument, or
// cudaErrorNotSupported when the driver has no cuTensorMapEncodeTiled.

#include <cuda.h>  // CUtensorMap and its enums only: no driver-API link
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 128;                 // q rows per block
constexpr int kBK = 32;                  // keys per K or vT tile
constexpr int kSlots = 3;                // ring depth (K and vT tiles)
constexpr int kWarps = 8;                // two warpgroups
constexpr int kThreads = 32 * kWarps;
constexpr int kRefiller = 128;           // first thread of warpgroup 1
constexpr int kMaxQTiles = 65535;        // gridDim.y
constexpr int kBoxCols = 32;             // f32 per box row: 128 bytes
constexpr int kRowBytes = 4 * kBoxCols;
constexpr uint64_t kLayout = 1;          // descriptor: 128-byte swizzle
constexpr int kSplitThreads = 256;
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
// polls of an mbarrier before the kernel traps: a lost arrival becomes a
// launch error instead of a hang (a real wait is microseconds)
constexpr uint32_t kSpinLimit = 1u << 24;

template <int HD>
struct Cfg {
  static constexpr int kQBytes = kBQ * HD * 4;         // q_hi or q_lo
  static constexpr int kPlaneBytes = kBK * HD * 4;     // one plane of a tile
  static constexpr int kSlotBytes = 2 * kPlaneBytes;   // its hi and lo
  // q_hi, q_lo, the ring, 1 + 2 kSlots mbarriers, slack to align to 1024
  static constexpr int kSmem = 2 * kQBytes + kSlots * kSlotBytes + 128 + 1024;
};

__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, each a TF32 value rounded to nearest, ties away
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = __uint_as_float(tf32_bits(x));
  lo = __uint_as_float(tf32_bits(x - hi));
}

__device__ __forceinline__ void split4(float4 x, float4& hi, float4& lo) {
  split(x.x, hi.x, lo.x);
  split(x.y, hi.y, lo.y);
  split(x.z, hi.z, lo.z);
  split(x.w, hi.w, lo.w);
}

// The pre-pass.  Blocks below elem_blocks split q and k, one float4 a
// thread; each later block takes one tile of kBK keys of one head, splits
// v through a shared-memory tile and writes it transposed to vt, 16 bytes
// a thread along keys, zeros past Sk.  Slot 4 c + j (c = 0, 1) of each
// group of 8 keys holds key 2 j + c.
__global__ void __launch_bounds__(kSplitThreads)
    tf32_split_kernel(const float4* __restrict__ q,
                      const float4* __restrict__ k,
                      const float* __restrict__ v, float4* __restrict__ q_hi,
                      float4* __restrict__ q_lo, float4* __restrict__ k_hi,
                      float4* __restrict__ k_lo, float* __restrict__ vt_hi,
                      float* __restrict__ vt_lo, long long nq4, long long nk4,
                      int elem_blocks, int Sk, int sk_pad, int hd) {
  __shared__ float tile[kBK][128 + 1];
  if (static_cast<int>(blockIdx.x) < elem_blocks) {
    const long long i =
        static_cast<long long>(blockIdx.x) * kSplitThreads + threadIdx.x;
    float4 hi, lo;
    if (i < nq4) {
      split4(q[i], hi, lo);
      q_hi[i] = hi;
      q_lo[i] = lo;
    } else if (i < nq4 + nk4) {
      split4(k[i - nq4], hi, lo);
      k_hi[i - nq4] = hi;
      k_lo[i - nq4] = lo;
    }
    return;
  }
  const int tiles = sk_pad / kBK;
  const int t = blockIdx.x - elem_blocks;
  const int bh = t / tiles, key0 = (t % tiles) * kBK;
  const int c4 = hd / 4;  // float4 per v row
  for (int i = threadIdx.x; i < kBK * c4; i += kSplitThreads) {
    const int r = i / c4, c = 4 * (i % c4);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (key0 + r < Sk)
      x = *reinterpret_cast<const float4*>(
          v + (static_cast<long long>(bh) * Sk + key0 + r) * hd + c);
    tile[r][c] = x.x;
    tile[r][c + 1] = x.y;
    tile[r][c + 2] = x.z;
    tile[r][c + 3] = x.w;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < hd * (kBK / 4); i += kSplitThreads) {
    const int d = i / (kBK / 4), c = i % (kBK / 4);
    const int key = 8 * (c >> 1) + (c & 1);  // slots 4 c .. 4 c + 3
    const float4 x = make_float4(tile[key][d], tile[key + 2][d],
                                 tile[key + 4][d], tile[key + 6][d]);
    float4 hi, lo;
    split4(x, hi, lo);
    const long long at =
        (static_cast<long long>(bh) * hd + d) * sk_pad + key0 + 4 * c;
    *reinterpret_cast<float4*>(vt_hi + at) = hi;
    *reinterpret_cast<float4*>(vt_lo + at) = lo;
  }
}

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

// K-major operand from a 128-byte-swizzled box: 8-row groups 1024 bytes
// apart; the leading offset is unused
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>((8 * kRowBytes) >> 4) << 32) |
         (kLayout << 62);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

#define D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define D16(i) D4(i), D4(i + 4), D4(i + 8), D4(i + 12)

// wgmma wrappers: D (f32, m64nN) += A (tf32, m64k8) * B (tf32, k8nN), B
// K-major from shared memory.  The accumulator fragment of thread (warp
// w, lane l) holds row 16 w + l / 4 (+ 8 for elements 4 j + 2, 4 j + 3)
// and columns 8 j + 2 (l % 4) + {0, 1}; the A fragment from registers
// holds rows 16 w + l / 4 (a0, a2) and + 8 (a1, a3), k slots l % 4 (a0,
// a1) and l % 4 + 4 (a2, a3).  ss: A K-major from shared memory, D
// overwritten when acc == 0.  rs: A from registers, D accumulated.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : D16(0)
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : D16(0)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : D16(0), D16(16)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : D16(0), D16(16), D16(32), D16(48)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

#undef D16
#undef D4

// A thread's two rows of the online softmax (rows r0 and r0 + 8): the
// running max m (log2 domain), the normaliser l, and the correction of
// the output accumulator that the last tile's new max calls for.
struct RowState {
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};
  float corr[2] = {1.f, 1.f};
};

// byte offset of k step kk (8 columns) in a tile of `rows`-row boxes
template <int ROWS>
__device__ __forceinline__ uint32_t kstep(int kk) {
  return (kk / 4) * ROWS * kRowBytes + 32 * (kk % 4);
}

// S = Q K^T of one key tile into s (m64n32, k over hd) as 3xTF32, one
// wgmma group: Qhi.Klo and Qlo.Khi first, Qhi.Khi last
template <int HD>
__device__ __forceinline__ void issue_s(float (&s)[kBK / 2], uint32_t qhi,
                                        uint32_t qlo, uint32_t khi,
                                        uint32_t klo) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk)
    wgmma_ss_n32(s, kmajor_desc(qhi + kstep<kBQ>(kk)),
                 kmajor_desc(klo + kstep<kBK>(kk)), kk > 0);
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk)
    wgmma_ss_n32(s, kmajor_desc(qlo + kstep<kBQ>(kk)),
                 kmajor_desc(khi + kstep<kBK>(kk)), 1);
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk)
    wgmma_ss_n32(s, kmajor_desc(qhi + kstep<kBQ>(kk)),
                 kmajor_desc(khi + kstep<kBK>(kk)), 1);
  wgmma_commit();
}

// the A fragment passed by register: through a pointer into a local array
// ptxas may serialise the products or spill
template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&acc)[HD / 2], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  if constexpr (HD == 32) {
    wgmma_rs_n32(acc, a0, a1, a2, a3, db);
  } else if constexpr (HD == 64) {
    wgmma_rs_n64(acc, a0, a1, a2, a3, db);
  } else {
    wgmma_rs_n128(acc, a0, a1, a2, a3, db);
  }
}

// O = O * corr + P V of one key tile (k over its keys) as 3xTF32, one
// group: Plo.vThi and Phi.vTlo first, Phi.vThi last.  vT's box is [hd
// rows][32 keys], so k step kk is 32 bytes into each row.
template <int HD>
__device__ __forceinline__ void issue_pv(float (&acc)[HD / 2],
                                         const uint32_t (&phi)[kBK / 2],
                                         const uint32_t (&plo)[kBK / 2],
                                         const RowState& rows, uint32_t vhi,
                                         uint32_t vlo) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    acc[4 * j] *= rows.corr[0];
    acc[4 * j + 1] *= rows.corr[0];
    acc[4 * j + 2] *= rows.corr[1];
    acc[4 * j + 3] *= rows.corr[1];
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 8; ++kk)
    wgmma_pv<HD>(acc, plo[4 * kk], plo[4 * kk + 1], plo[4 * kk + 2],
                 plo[4 * kk + 3], kmajor_desc(vhi + 32 * kk));
#pragma unroll
  for (int kk = 0; kk < kBK / 8; ++kk)
    wgmma_pv<HD>(acc, phi[4 * kk], phi[4 * kk + 1], phi[4 * kk + 2],
                 phi[4 * kk + 3], kmajor_desc(vlo + 32 * kk));
#pragma unroll
  for (int kk = 0; kk < kBK / 8; ++kk)
    wgmma_pv<HD>(acc, phi[4 * kk], phi[4 * kk + 1], phi[4 * kk + 2],
                 phi[4 * kk + 3], kmajor_desc(vhi + 32 * kk));
  wgmma_commit();
}

// Online softmax of the tile of keys k0 .. k0 + 31 in the log2 domain
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
    // a row's 32 scores live in the 4 lanes of one quad
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

// P split into TF32 hi and lo as the A fragments of P.V's k steps: step
// kk's slots t and t + 4 take keys 8 kk + 2 t and 8 kk + 2 t + 1 of the S
// fragment, which is the order in which the pre-pass stored vT's keys
__device__ __forceinline__ void split_p(uint32_t (&phi)[kBK / 2],
                                        uint32_t (&plo)[kBK / 2],
                                        const float (&s)[kBK / 2]) {
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
    const float a[4] = {s[4 * j], s[4 * j + 2], s[4 * j + 1], s[4 * j + 3]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      phi[4 * j + e] = tf32_bits(a[e]);
      plo[4 * j + e] = tf32_bits(a[e] - __uint_as_float(phi[4 * j + e]));
    }
  }
}

// this warp is done with a ring slot
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// one thread loads `rows` rows from row0 of head bh, all `cols` columns,
// of the hi and lo maps (as cols / 32 boxes each) into dst and dst +
// bytes / 2, completing on bar
template <int ROWS, int COLS>
__device__ __forceinline__ void load_pair(const CUtensorMap* hi,
                                          const CUtensorMap* lo,
                                          uint32_t dst, uint32_t bar,
                                          int col0, int row0, int bh) {
  constexpr int kPlane = ROWS * COLS * 4;
  mbar_expect_tx(bar, 2 * kPlane);
#pragma unroll
  for (int b = 0; b < COLS / kBoxCols; ++b) {
    tma_load(dst + b * ROWS * kRowBytes, hi, col0 + b * kBoxCols, row0, bh,
             bar);
    tma_load(dst + kPlane + b * ROWS * kRowBytes, lo, col0 + b * kBoxCols,
             row0, bh, bar);
  }
}

struct Maps {
  CUtensorMap qhi, qlo, khi, klo, vhi, vlo;
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_tf32_kernel(const __grid_constant__ Maps maps,
                      float* __restrict__ o, int S, int Sk,
                      float scale_log2) {
  using C = Cfg<HD>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sqhi = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sqlo = sqhi + C::kQBytes;
  const uint32_t ring = sqlo + C::kQBytes;  // + s kSlotBytes: slot s
  const uint32_t bar_q = ring + kSlots * C::kSlotBytes;
  const uint32_t bar_full = bar_q + 8;                // + 8 s: slot s loaded
  const uint32_t bar_free = bar_full + 8 * kSlots;    // + 8 s: slot s read
  auto slot = [&](int i) { return ring + (i % kSlots) * C::kSlotBytes; };

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest tiles first
  const int q_last = min(q0 + kBQ, S) - 1;
  // key tiles up to the one holding the block's last query (causal skip);
  // ring item 2 t is K of tile t, item 2 t + 1 its vT
  const int n_tiles = min((Sk + kBK - 1) / kBK, q_last / kBK + 1);
  const int n_items = 2 * n_tiles;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  auto load_item = [&](int i) {
    const uint32_t bar = bar_full + 8 * (i % kSlots);
    if (i % 2 == 0)
      load_pair<kBK, HD>(&maps.khi, &maps.klo, slot(i), bar, 0,
                         (i / 2) * kBK, bh);
    else
      load_pair<HD, kBK>(&maps.vhi, &maps.vlo, slot(i), bar, (i / 2) * kBK,
                         0, bh);
  };

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_free + 8 * s, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    load_pair<kBQ, HD>(&maps.qhi, &maps.qlo, sqhi, bar_q, 0, q0, bh);
    for (int i = 0; i < kSlots && i < n_items; ++i) load_item(i);
  }
  __syncthreads();

  // warpgroup wg owns q rows q0 + 64 wg .. + 63; this thread rows r0 and
  // r0 + 8, columns 8 j + cq + {0, 1} of each fragment
  const int wg = warp >> 2;
  const int q_wg = q0 + 64 * wg;
  const int r0 = q_wg + 16 * (warp & 3) + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const uint32_t qhi_wg = sqhi + 64 * wg * kRowBytes;
  const uint32_t qlo_wg = sqlo + 64 * wg * kRowBytes;
  // the tile of keys from k0 crosses the diagonal or the Sk edge
  auto masked = [&](int k0) { return k0 + kBK - 1 > q_wg || k0 + kBK > Sk; };
  // The first thread of warpgroup 1 loads item i + kSlots into the slot of
  // item i once both warpgroups have released it.
  const bool refiller = threadIdx.x == kRefiller;
  auto refill = [&](int i) {
    if (refiller && i + kSlots < n_items) {
      mbar_wait(bar_free + 8 * (i % kSlots), (i / kSlots) & 1);
      load_item(i + kSlots);
    }
    __syncwarp();
  };

  float acc[HD / 2];
  float s[kBK / 2];
  uint32_t phi[kBK / 2], plo[kBK / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) s[i] = 0.f;
  RowState rows;

  mbar_wait(bar_q, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int ik = 2 * t, iv = 2 * t + 1;
    mbar_wait(bar_full + 8 * (ik % kSlots), (ik / kSlots) & 1);
    issue_s<HD>(s, qhi_wg, qlo_wg, slot(ik), slot(ik) + C::kPlaneBytes);
    wgmma_wait<0>();
    fence_regs(s);
    release(bar_free + 8 * (ik % kSlots), lane);
    refill(ik);
    softmax_tile(s, rows, t * kBK, masked(t * kBK), r0, cq, Sk, scale_log2);
    split_p(phi, plo, s);
    mbar_wait(bar_full + 8 * (iv % kSlots), (iv / kSlots) & 1);
    issue_pv<HD>(acc, phi, plo, rows, slot(iv), slot(iv) + C::kPlaneBytes);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(phi);
    fence_regs(plo);
    release(bar_free + 8 * (iv % kSlots), lane);
    refill(iv);
  }

  // o = acc / l in f32, rows past S dropped
  const long long row = static_cast<long long>(bh) * S + r0;
  if (r0 < S) {
    float2* out = reinterpret_cast<float2*>(o + row * HD + cq);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      out[4 * j] = make_float2(acc[4 * j] / rows.l[0],
                               acc[4 * j + 1] / rows.l[0]);
  }
  if (r0 + 8 < S) {
    float2* out = reinterpret_cast<float2*>(o + (row + 8) * HD + cq);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      out[4 * j] = make_float2(acc[4 * j + 2] / rows.l[1],
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

// rank-3 map over [bh, rows, cols] f32; boxes of box_rows rows by 32
// columns (128 bytes, the 128-byte swizzle), zeros outside the tensor
int make_map(CUtensorMap* map, const void* ptr, int bh, int rows, int cols,
             int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 4,
                                 static_cast<cuuint64_t>(rows) * cols * 4};
  const cuuint32_t box[3] = {kBoxCols, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int HD>
int launch(const void* const* planes, float* o, int bh, int s, int sk,
           int sk_pad, float scale, cudaStream_t stream) {
  Maps m;
  int err = make_map(&m.qhi, planes[0], bh, s, HD, kBQ);
  if (!err) err = make_map(&m.qlo, planes[1], bh, s, HD, kBQ);
  if (!err) err = make_map(&m.khi, planes[2], bh, sk, HD, kBK);
  if (!err) err = make_map(&m.klo, planes[3], bh, sk, HD, kBK);
  if (!err) err = make_map(&m.vhi, planes[4], bh, HD, sk_pad, HD);
  if (!err) err = make_map(&m.vlo, planes[5], bh, HD, sk_pad, HD);
  if (err) return err;
  auto kernel = flash_tf32_kernel<HD>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<HD>::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>(bh),
                  static_cast<unsigned>((s + kBQ - 1) / kBQ));
  kernel<<<grid, kThreads, Cfg<HD>::kSmem, stream>>>(m, o, s, sk,
                                                     scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* const* ptrs, int n) {
  uintptr_t bits = 0;
  for (int i = 0; i < n; ++i) bits |= reinterpret_cast<uintptr_t>(ptrs[i]);
  return bits % 16 == 0;
}

bool valid_shape(int bh, int s, int sk, int sk_pad, int hd) {
  return bh > 0 && s > 0 && sk > 0 && sk_pad >= sk && sk_pad % kBK == 0 &&
         (hd == 32 || hd == 64 || hd == 128);
}

}  // namespace

extern "C" int flash_tf32_split_launch(const void* q, const void* k,
                                       const void* v, void* q_hi, void* q_lo,
                                       void* k_hi, void* k_lo, void* vt_hi,
                                       void* vt_lo, int bh, int s, int sk,
                                       int sk_pad, int hd, void* stream) {
  const void* ptrs[9] = {q, k, v, q_hi, q_lo, k_hi, k_lo, vt_hi, vt_lo};
  if (!valid_shape(bh, s, sk, sk_pad, hd) || !aligned16(ptrs, 9))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nq4 = static_cast<long long>(bh) * s * hd / 4;
  const long long nk4 = static_cast<long long>(bh) * sk * hd / 4;
  const long long elem_blocks =
      (nq4 + nk4 + kSplitThreads - 1) / kSplitThreads;
  const long long blocks =
      elem_blocks + static_cast<long long>(bh) * (sk_pad / kBK);
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  tf32_split_kernel<<<static_cast<unsigned>(blocks), kSplitThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(q), static_cast<const float4*>(k),
      static_cast<const float*>(v), static_cast<float4*>(q_hi),
      static_cast<float4*>(q_lo), static_cast<float4*>(k_hi),
      static_cast<float4*>(k_lo), static_cast<float*>(vt_hi),
      static_cast<float*>(vt_lo), nq4, nk4, static_cast<int>(elem_blocks),
      sk, sk_pad, hd);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_attn_tf32_launch(const void* q_hi, const void* q_lo,
                                      const void* k_hi, const void* k_lo,
                                      const void* vt_hi, const void* vt_lo,
                                      void* o, int bh, int s, int sk,
                                      int sk_pad, int hd, float scale,
                                      void* stream) {
  const void* planes[7] = {q_hi, q_lo, k_hi, k_lo, vt_hi, vt_lo, o};
  if (!valid_shape(bh, s, sk, sk_pad, hd) || !aligned16(planes, 7) ||
      (s + kBQ - 1) / kBQ > kMaxQTiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(o);
  switch (hd) {
    case 32:
      return launch<32>(planes, out, bh, s, sk, sk_pad, scale, st);
    case 64:
      return launch<64>(planes, out, bh, s, sk, sk_pad, scale, st);
    default:
      return launch<128>(planes, out, bh, s, sk, sk_pad, scale, st);
  }
}
