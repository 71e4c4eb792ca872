// Sliding-window MD5: digest word a of the WW-word window at every word
// offset of every byte phase of B rows.
//
// Replaces the TPU kernel sliding_md5_pallas (src/repro/kernels/
// sliding_md5.py, _sliding_kernel) together with the strip construction
// that fed it (src/repro/kernels/ops.py, _byte_phase_strips_batch).
//
// What bounds it on this card: every window is one MD5 compression for 4
// to 52 bytes of new input, so the kernel is bound by integer instruction
// issue, not bytes.  An SM issues at most 128 integer instructions per
// clock: 64 on the ALU pipe (IADD3, LOP3, SHF, ...) and 64 IMADs on the
// FMA pipe.  The design spends as few instructions per window as it can
// and splits them between the two pipes:
//   - Tiles, not a grid-stride loop.  A 2-D grid of (tile of kTile word
//     offsets, row): no 64-bit division.  A block stages the tile's words
//     and a halo of kHalo more into shared memory with 16-byte loads;
//     only a row's last tile (or a row that is not 16-byte aligned)
//     checks bounds, and it zero-fills past the row's end.
//   - Byte phases built once per tile.  For stride 1 or 2 the block
//     builds the R - 1 byte-shifted strips in shared memory, one funnel
//     shift per word and phase; stride 4 (R = 1) has no shift at all.
//   - Four windows per thread, at four consecutive offsets, as four
//     independent chains for instruction-level parallelism: their 12 to
//     15 distinct words come in four 16-byte shared-memory loads (a
//     quarter-warp covers 32 banks once, so no conflicts) and their
//     results leave in one 16-byte store (coalesced within each phase
//     plane).
//   - Only what word a needs.  The output is a0 + (b after round 61), so
//     rounds 62-64 are not computed; rounds 1-4 (1-based) use the initial
//     value's constants and the constant message words (padding and
//     length) fold into the round constants, all at compile time.
//   - Both integer pipes.  A round is the boolean function (one LOP3),
//     f = F + a + K + M (two adds), and b + rotl(f, s), which ptxas issues
//     as one LEA.HI of f funnel-shifted onto f.  LOP3 and LEA.HI run only
//     on the ALU pipe; the adds run on either.  Written plainly, both adds
//     go to the ALU pipe as IADD3s and the kernel is ALU-bound (three ALU
//     instructions a round).  So only every kAluAddEvery-th round adds on
//     the ALU pipe (one IADD3, then one IMAD); the others add a + K as a
//     VIADD and the rest as IMADs with a multiplier of 1 on the FMA pipe:
//     an instruction more, but the ALU pipe keeps two a round.  The 1 is
//     a kernel argument, so ptxas cannot fold the IMADs back into adds.
//     (b + rotl(f, s) as IMAD.HI + IMAD would free the ALU pipe further,
//     but IMAD.HI issues far more slowly: tools/sliding_ablation.py times
//     it.)
//
// Interface: words [B, L] uint32 row-major; out [B, R, L] uint32 with
// out[b, i, q] the hash of the window starting at byte 4q + i*stride of
// row b, R = 4 / stride (the phase-major layout the host finish step
// interleaves).  Words past the row end read as zero.  Launches on the
// given stream and does not synchronise; returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

#include "md5_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;                   // windows per thread, phase
constexpr int kTile = kThreads * kPerThread;    // word offsets per block
// strip words a thread reads past its first offset (4 offsets + 12 more
// words) and raw words staged past the tile (one more for the shift,
// rounded up to 16 bytes)
constexpr int kHalo = 16;
constexpr int kRawWords = kTile + kHalo + 4;
constexpr int kStripWords = kTile + kHalo;
constexpr int kMaxGridY = 65535;
// rounds I with I % kAluAddEvery == 0 add f's terms on the ALU pipe, the
// others on the FMA pipe
constexpr int kAluAddEvery = 3;

// the last round whose result reaches digest word a: a = a0 + the b that
// round kLastRound writes (0-based), three rounds before the end
constexpr int kLastRound = 60;

// The multiplier the kernel takes as an argument, so that its IMADs stay
// IMADs on the FMA pipe: one = 1.
struct Muls {
  uint32_t one;
};

__device__ __forceinline__ uint32_t mad_lo(uint32_t a, uint32_t b,
                                           uint32_t c) {
#ifdef __CUDA_ARCH__
  uint32_t d;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
#else
  return a * b + c;
#endif
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int s) {
  return (x << s) | (x >> (32 - s));
}

template <int I>
__device__ __forceinline__ uint32_t md5_f(uint32_t b, uint32_t c,
                                          uint32_t d) {
  if constexpr (I < 16) {
    return (b & c) | (~b & d);
  } else if constexpr (I < 32) {
    return (d & b) | (~d & c);
  } else if constexpr (I < 48) {
    return b ^ c ^ d;
  } else {
    return c ^ (b | ~d);
  }
}

// message word g of a WW-word window: the window's words, then the 0x80
// padding byte, zeros, and the length in bits in word 14
template <int WW>
__host__ __device__ constexpr uint32_t pad_word(int g) {
  return g == WW ? 0x80u : g == 14 ? static_cast<uint32_t>(WW * 32) : 0u;
}

// Round I of kPerThread interleaved windows.  x[slot][k] holds the state
// of window k; round I reads a, b, c, d from slots -I, 1 - I, 2 - I,
// 3 - I (mod 4) and writes its new b over a.  Window k's message word g
// is w[k + g] (g < WW) or a constant.
template <int I, int WW>
__device__ __forceinline__ void md5_round(uint32_t (&x)[4][kPerThread],
                                          const uint32_t (&w)[16],
                                          const Muls& mul) {
  constexpr int g = md5_g(I);
  constexpr int s = md5_s(I);
  constexpr uint32_t kv = md5_k(I);
  constexpr int ia = (64 - I) & 3, ib = (65 - I) & 3, ic = (66 - I) & 3,
                id = (67 - I) & 3;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const uint32_t a = x[ia][k], b = x[ib][k], c = x[ic][k], d = x[id][k];
    const uint32_t m = g < WW ? w[(k + g) & 15] : pad_word<WW>(g);
    const uint32_t fb = md5_f<I>(b, c, d);
    uint32_t f;
    if constexpr (I < 4) {
      // a, and some of b, c, d, are the initial value's constants: plain
      // arithmetic, which the compiler folds
      f = fb + a + kv + m;
    } else if constexpr (g >= WW) {                 // K + M is a constant
      if constexpr (I % kAluAddEvery == 0) {
        f = fb + a + (kv + m);                      // IADD3
      } else {
        f = mad_lo(fb, mul.one, a + (kv + m));      // VIADD, IMAD
      }
    } else if constexpr (I % kAluAddEvery == 0) {
      f = mad_lo(fb, mul.one, a + kv + m);          // IADD3, IMAD
    } else {
      f = mad_lo(fb, mul.one, mad_lo(m, mul.one, a + kv));  // VIADD, 2 IMAD
    }
    x[ia][k] = b + rotl(f, s);                      // LEA.HI
  }
}

template <int WW, int... I>
__device__ __forceinline__ void md5_rounds(uint32_t (&x)[4][kPerThread],
                                           const uint32_t (&w)[16],
                                           const Muls& mul,
                                           std::integer_sequence<int, I...>) {
  (md5_round<I, WW>(x, w, mul), ...);
}

// digest word a of kPerThread windows whose words are w[k .. k + WW - 1]
template <int WW>
__device__ __forceinline__ void window_hashes(const uint32_t (&w)[16],
                                              const Muls& mul,
                                              uint32_t (&h)[kPerThread]) {
  uint32_t x[4][kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j][k] = md5_iv(j);
  }
  md5_rounds<WW>(x, w, mul,
                 std::make_integer_sequence<int, kLastRound + 1>{});
  // round kLastRound wrote slot (-kLastRound) mod 4
#pragma unroll
  for (int k = 0; k < kPerThread; ++k)
    h[k] = md5_iv(0) + x[(64 - kLastRound) & 3][k];
}

// (A minimum of one block per SM leaves ptxas free to use the registers
// it wants: with the thread count alone it spills 8 bytes in <5, 2>.)
template <int WW, int STRIDE>
__global__ void __launch_bounds__(kThreads, 1)
    sliding_md5_kernel(const uint32_t* __restrict__ words,
                       uint32_t* __restrict__ out, long long n_rows,
                       long long len, int vec_ok, const Muls mul) {
  constexpr int R = 4 / STRIDE;
  __shared__ __align__(16) uint32_t raw[kRawWords];
  __shared__ __align__(16) uint32_t strips[R > 1 ? R - 1 : 1][kStripWords];
  const int t = threadIdx.x;
  const long long q0 = static_cast<long long>(blockIdx.x) * kTile;

  for (long long row = blockIdx.y; row < n_rows; row += gridDim.y) {
    const uint32_t* src = words + row * len;
    const bool interior = vec_ok && q0 + kRawWords <= len;
    // stage words q0 .. q0 + kRawWords - 1 of the row, zeros past its end
    if (interior) {
      for (int p = 4 * t; p < kRawWords; p += 4 * kThreads)
        *reinterpret_cast<uint4*>(raw + p) =
            __ldg(reinterpret_cast<const uint4*>(src + q0 + p));
    } else {
      for (int p = t; p < kRawWords; p += kThreads)
        raw[p] = q0 + p < len ? __ldg(src + q0 + p) : 0u;
    }
    __syncthreads();
    // strip i - 1 holds the row's bytes shifted by i * STRIDE: its word p
    // is the word at byte 4 (q0 + p) + i * STRIDE
    if constexpr (R > 1) {
      for (int p = 4 * t; p < kStripWords; p += 4 * kThreads) {
        const uint4 v = *reinterpret_cast<const uint4*>(raw + p);
        const uint32_t nxt = raw[p + 4];
#pragma unroll
        for (int i = 1; i < R; ++i) {
          const int sh = 8 * i * STRIDE;
          *reinterpret_cast<uint4*>(&strips[i - 1][p]) =
              make_uint4(__funnelshift_r(v.x, v.y, sh),
                         __funnelshift_r(v.y, v.z, sh),
                         __funnelshift_r(v.z, v.w, sh),
                         __funnelshift_r(v.w, nxt, sh));
        }
      }
      __syncthreads();
    }
#pragma unroll 1
    for (int i = 0; i < R; ++i) {
      const uint32_t* strip = i == 0 ? raw : strips[i - 1];
      uint32_t w[16];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint4 v =
            *reinterpret_cast<const uint4*>(strip + kPerThread * t + 4 * j);
        w[4 * j] = v.x;
        w[4 * j + 1] = v.y;
        w[4 * j + 2] = v.z;
        w[4 * j + 3] = v.w;
      }
      uint32_t h[kPerThread];
      window_hashes<WW>(w, mul, h);
      const long long q = q0 + kPerThread * t;
      uint32_t* dst = out + (row * R + i) * len + q;
      if (interior) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(h[0], h[1], h[2], h[3]);
      } else {
#pragma unroll
        for (int k = 0; k < kPerThread; ++k)
          if (q + k < len) dst[k] = h[k];
      }
    }
    __syncthreads();                 // raw and strips are reused
  }
}

template <int WW, int STRIDE>
int launch(const void* words, void* out, long long n_rows, long long len,
           cudaStream_t stream) {
  Muls mul;
  mul.one = 1u;
  const int vec_ok = len % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(words) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid(static_cast<unsigned>((len + kTile - 1) / kTile),
                  static_cast<unsigned>(n_rows < kMaxGridY ? n_rows
                                                           : kMaxGridY));
  sliding_md5_kernel<WW, STRIDE><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(words), static_cast<uint32_t*>(out),
      n_rows, len, vec_ok, mul);
  return static_cast<int>(cudaGetLastError());
}

template <int WW>
int launch_stride(const void* words, void* out, long long n_rows,
                  long long len, int stride, cudaStream_t stream) {
  switch (stride) {
    case 1:
      return launch<WW, 1>(words, out, n_rows, len, stream);
    case 2:
      return launch<WW, 2>(words, out, n_rows, len, stream);
    default:
      return launch<WW, 4>(words, out, n_rows, len, stream);
  }
}

}  // namespace

extern "C" int sliding_md5_launch(const void* words, void* out,
                                  long long n_rows, long long len,
                                  int w_words, int stride, void* stream) {
  if (stride != 1 && stride != 2 && stride != 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows <= 0 || len <= 0) return 0;
  if ((len + kTile - 1) / kTile > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w_words) {
#define REPRO_SLIDING_CASE(WW) \
  case WW:                     \
    return launch_stride<WW>(words, out, n_rows, len, stride, s);
    REPRO_SLIDING_CASE(1)
    REPRO_SLIDING_CASE(2)
    REPRO_SLIDING_CASE(3)
    REPRO_SLIDING_CASE(4)
    REPRO_SLIDING_CASE(5)
    REPRO_SLIDING_CASE(6)
    REPRO_SLIDING_CASE(7)
    REPRO_SLIDING_CASE(8)
    REPRO_SLIDING_CASE(9)
    REPRO_SLIDING_CASE(10)
    REPRO_SLIDING_CASE(11)
    REPRO_SLIDING_CASE(12)
    REPRO_SLIDING_CASE(13)
#undef REPRO_SLIDING_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
