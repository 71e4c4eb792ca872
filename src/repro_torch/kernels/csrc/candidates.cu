// Boundary candidates of content-defined chunking: per row, the window
// indices whose hash h meets the chunking rule (h & mask) == magic, in
// ascending order.  With a second rule (mask2, magic2; FastCDC's loose
// mask beside its strict one) a window is a candidate when it meets
// either, and comes out as 4 * k + flags: bit 0 set when it meets the
// first rule, bit 1 the second.  Each hash is still read once by the
// count pass; both tests run on the one load.
//
// Replaces no TPU kernel.  The JAX package, like the paper's HashGPU,
// brings every window hash back to the host and tests the rule there
// (src/repro/core/chunking.py, select_boundaries).  On this card that
// is 4 bytes of hashes per byte of input (1 GiB for a 256 MiB image at
// stride 1) copied to the host and passed over twice there, against
// about one candidate per avg_chunk bytes that the host's greedy
// min/max walk needs.  This kernel tests the rule where the hashes are
// and compacts the hits, so only the candidates leave the card.
//
// Input: hashes [B, R, Wc] uint32, phase-major as csrc/sliding_md5.cu
// writes them (R = 4 / stride; window index k = q * R + i lies at
// [b, i, q]), or gear's per-byte [B, L] as R = 1.  n_off[b] bounds row b:
// no k >= n_off[b] is a candidate, since windows there hash the stale
// bytes of a reused staging row or the padding of a bucketed width.
// n_off[b] <= R * Wc (the wrapper clamps it).
//
// What bounds it on this card: bytes.  Each kept hash is read by the
// count pass and, in a block that holds a hit, again by the scatter pass
// (4 or 8 B per window against a few integer instructions), so a 256 MiB
// image at stride 1 reads 1-2 GiB: 0.32-0.64 ms at 3.35 TB/s.  The
// design:
//   * Count pass.  Each thread takes kQ = 4 consecutive word offsets q of
//     every phase, so 4R consecutive windows, with one 16-byte load per
//     phase (coalesced within each phase plane), and keeps one bit per
//     hit.  A block sums its threads' popcounts by warp and writes one
//     count.  Reads stop at a row's n_off.
//   * The wrapper turns the counts into offsets with one cumsum over
//     B * tiles ints and reads the total to size the output exactly, so
//     no buffer of fixed capacity can overflow: a zero-filled or
//     periodic input, where every window may match, loses nothing.
//   * Scatter pass.  A block whose count is 0 returns at once (most
//     blocks, for 8 KiB chunks: 4096 windows a block); the others build
//     the bits again, place each thread's hits by a warp scan
//     (__shfl_up_sync) and the warps' totals, and write them lowest bit
//     first, so each row's candidates come out in ascending order.
//
// Interface: hashes, n_off [B] int64, counts [B, tiles] int32, ends
// [B * tiles] int64 (inclusive prefix sums of counts), out [ends[-1]]
// int64; rules 1 (mask2 and magic2 unused) or 2.  B <= 65535.  Launches
// on the given stream and does not synchronise; returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQ = 4;                           // word offsets a thread
constexpr int kTileQ = kThreads * kQ;           // word offsets a block
constexpr int kMaxRows = 65535;

struct Rules {
  uint32_t mask, magic, mask2, magic2;
};

// Bit j * R + i of b1 (of b2) is set when window (q0 + j) * R + i meets
// the first rule (the second; M == 2 only, else b2 stays 0).  With vec
// the row's planes are 16-byte aligned and Wc % 4 == 0, so a run that
// starts inside a plane (q0 * R < n_off <= R * Wc) lies in it.
template <int R, int M>
__device__ __forceinline__ void hit_bits(const uint32_t* __restrict__ row,
                                         long long wc, long long q0,
                                         long long n_off, Rules rules,
                                         bool vec, uint32_t& b1,
                                         uint32_t& b2) {
  b1 = 0u;
  b2 = 0u;
  if (q0 * R >= n_off) return;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const uint32_t* plane = row + i * wc;
    uint32_t h[kQ];
    if (vec) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(plane + q0));
      h[0] = v.x;
      h[1] = v.y;
      h[2] = v.z;
      h[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < kQ; ++j)
        h[j] = q0 + j < wc ? __ldg(plane + q0 + j) : 0u;
    }
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      const long long k = (q0 + j) * R + i;
      if (k >= n_off) continue;
      const uint32_t bit = 1u << (j * R + i);
      if ((h[j] & rules.mask) == rules.magic) b1 |= bit;
      if (M == 2 && (h[j] & rules.mask2) == rules.magic2) b2 |= bit;
    }
  }
}

template <int R, int M>
__global__ void __launch_bounds__(kThreads)
    candidate_count_kernel(const uint32_t* __restrict__ hashes,
                           const long long* __restrict__ n_off,
                           int* __restrict__ counts, long long wc,
                           long long tiles, Rules rules, bool vec) {
  const long long row = blockIdx.y;
  const long long q0 =
      static_cast<long long>(blockIdx.x) * kTileQ + threadIdx.x * kQ;
  uint32_t b1, b2;
  hit_bits<R, M>(hashes + row * R * wc, wc, q0, n_off[row], rules, vec, b1,
                 b2);
  const int n = __reduce_add_sync(0xffffffffu, __popc(b1 | b2));
  __shared__ int warp_n[kWarps];
  if ((threadIdx.x & 31) == 0) warp_n[threadIdx.x >> 5] = n;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_n[w];
    counts[row * tiles + blockIdx.x] = total;
  }
}

template <int R, int M>
__global__ void __launch_bounds__(kThreads)
    candidate_scatter_kernel(const uint32_t* __restrict__ hashes,
                             const long long* __restrict__ n_off,
                             const long long* __restrict__ ends,
                             const int* __restrict__ counts,
                             long long* __restrict__ out, long long wc,
                             long long tiles, Rules rules, bool vec) {
  const long long row = blockIdx.y;
  const long long idx = row * tiles + blockIdx.x;
  const int block_n = counts[idx];
  if (block_n == 0) return;                     // the whole block alike
  const long long q0 =
      static_cast<long long>(blockIdx.x) * kTileQ + threadIdx.x * kQ;
  uint32_t b1, b2;
  hit_bits<R, M>(hashes + row * R * wc, wc, q0, n_off[row], rules, vec, b1,
                 b2);
  uint32_t bits = b1 | b2;
  const int n = __popc(bits);
  const int lane = threadIdx.x & 31;
  int incl = n;                                 // inclusive, in the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  __shared__ int warp_n[kWarps];
  if (lane == 31) warp_n[threadIdx.x >> 5] = incl;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < (threadIdx.x >> 5); ++w) before += warp_n[w];
  long long pos = ends[idx] - block_n + before + incl - n;
  const long long k0 = q0 * R;
  while (bits) {
    const int b = __ffs(static_cast<int>(bits)) - 1;
    if (M == 1) {
      out[pos++] = k0 + b;
    } else {
      out[pos++] = (k0 + b) * 4 + ((b1 >> b) & 1u) + ((b2 >> b) & 1u) * 2;
    }
    bits &= bits - 1u;
  }
}

bool vectorizable(const void* hashes, long long wc) {
  return wc % kQ == 0 && reinterpret_cast<uintptr_t>(hashes) % 16 == 0;
}

}  // namespace

// The cases of a switch on phases * 4 + rules: kernel K<R, M> for R
// phases and M rules, on grid and stream s.
#define CANDIDATE_CASES(K, ...)                                         \
  case 1 * 4 + 1:                                                       \
    K<1, 1><<<grid, kThreads, 0, s>>>(__VA_ARGS__);                     \
    break;                                                              \
  case 2 * 4 + 1:                                                       \
    K<2, 1><<<grid, kThreads, 0, s>>>(__VA_ARGS__);                     \
    break;                                                              \
  case 4 * 4 + 1:                                                       \
    K<4, 1><<<grid, kThreads, 0, s>>>(__VA_ARGS__);                     \
    break;                                                              \
  case 1 * 4 + 2:                                                       \
    K<1, 2><<<grid, kThreads, 0, s>>>(__VA_ARGS__);                     \
    break;                                                              \
  case 2 * 4 + 2:                                                       \
    K<2, 2><<<grid, kThreads, 0, s>>>(__VA_ARGS__);                     \
    break;                                                              \
  case 4 * 4 + 2:                                                       \
    K<4, 2><<<grid, kThreads, 0, s>>>(__VA_ARGS__);                     \
    break;

extern "C" int candidate_count_launch(const void* hashes, const void* n_off,
                                      void* counts, int n_rows, int phases,
                                      long long wc, long long tiles,
                                      unsigned mask, unsigned magic,
                                      int rules, unsigned mask2,
                                      unsigned magic2, void* stream) {
  if (n_rows <= 0 || tiles <= 0) return 0;
  if (n_rows > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>(n_rows));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* h = static_cast<const uint32_t*>(hashes);
  const auto* n = static_cast<const long long*>(n_off);
  auto* c = static_cast<int*>(counts);
  const Rules r{mask, magic, mask2, magic2};
  const bool vec = vectorizable(hashes, wc);
  switch (phases * 4 + rules) {
    CANDIDATE_CASES(candidate_count_kernel, h, n, c, wc, tiles, r, vec)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int candidate_scatter_launch(const void* hashes,
                                        const void* n_off, const void* ends,
                                        const void* counts, void* out,
                                        int n_rows, int phases, long long wc,
                                        long long tiles, unsigned mask,
                                        unsigned magic, int rules,
                                        unsigned mask2, unsigned magic2,
                                        void* stream) {
  if (n_rows <= 0 || tiles <= 0) return 0;
  if (n_rows > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>(n_rows));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* h = static_cast<const uint32_t*>(hashes);
  const auto* n = static_cast<const long long*>(n_off);
  const auto* e = static_cast<const long long*>(ends);
  const auto* c = static_cast<const int*>(counts);
  auto* o = static_cast<long long*>(out);
  const Rules r{mask, magic, mask2, magic2};
  const bool vec = vectorizable(hashes, wc);
  switch (phases * 4 + rules) {
    CANDIDATE_CASES(candidate_scatter_kernel, h, n, e, c, o, wc, tiles, r,
                    vec)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
