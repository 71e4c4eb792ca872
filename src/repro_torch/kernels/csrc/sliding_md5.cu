// Sliding-window MD5: digest word a of the WW-word window at every word
// offset of every byte phase of B rows, one thread per (row, phase,
// offset).
//
// Replaces the TPU kernel sliding_md5_pallas (src/repro/kernels/
// sliding_md5.py, _sliding_kernel).  The TPU version hashed R byte-phase
// strips that the host wrapper built in device memory
// (src/repro/kernels/ops.py, _byte_phase_strips_batch) and got each tile's
// halo by passing the strip twice.  Here each thread loads its WW+1 words
// straight from the row and builds the byte-rotated words of phase r in
// registers with a funnel shift, so the strips never exist in memory and
// the halo is simply the next words of the row (neighbouring threads read
// neighbouring words, which the L1 serves).
//
// What bounds it on this card: every window is one 64-round compression
// for 4 to 52 bytes of new input, so the kernel is bound by integer
// operations, not bytes.  The design spends nothing else: one thread per
// window, no shared memory, no synchronisation, and only word a is
// written.
//
// Interface: words [B, L] uint32 row-major; out [B, R, L] uint32 with
// out[b, i, q] the hash of the window starting at byte 4q + i*stride of
// row b, R = 4 / stride (the phase-major layout the host finish step
// interleaves).  Words past the row end read as zero.  Launches on the
// given stream and does not synchronise; returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "md5_core.cuh"

namespace {

constexpr int kThreads = 256;

template <int WW>
__global__ void sliding_md5_kernel(const uint32_t* __restrict__ words,
                                   uint32_t* __restrict__ out,
                                   long long n_rows, long long len,
                                   int n_phases, int stride) {
  const long long total = n_rows * n_phases * len;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long q = idx % len;
    const long long rest = idx / len;
    const int phase = static_cast<int>(rest % n_phases);
    const long long row_id = rest / n_phases;
    const uint32_t* row = words + row_id * len;
    const int shift = 8 * phase * stride;

    uint32_t m[16];
    uint32_t cur = __ldg(row + q);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (j < WW) {
        const long long p = q + j + 1;
        const uint32_t nxt = p < len ? __ldg(row + p) : 0u;
        m[j] = __funnelshift_r(cur, nxt, shift);
        cur = nxt;
      } else if (j == WW) {
        m[j] = 0x80u;
      } else if (j == 14) {
        m[j] = WW * 32;
      } else {
        m[j] = 0u;
      }
    }
    uint32_t st[4];
    md5_init(st);
    md5_compress(st, m);
    out[idx] = st[0];
  }
}

template <int WW>
int launch(const void* words, void* out, long long n_rows, long long len,
           int n_phases, int stride, cudaStream_t stream) {
  const long long total = n_rows * n_phases * len;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;  // grid-stride beyond
  sliding_md5_kernel<WW><<<static_cast<unsigned>(blocks), kThreads, 0,
                           stream>>>(static_cast<const uint32_t*>(words),
                                     static_cast<uint32_t*>(out), n_rows,
                                     len, n_phases, stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sliding_md5_launch(const void* words, void* out,
                                  long long n_rows, long long len,
                                  int w_words, int stride, void* stream) {
  if (stride != 1 && stride != 2 && stride != 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_phases = 4 / stride;
  if (n_rows <= 0 || len <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w_words) {
#define REPRO_SLIDING_CASE(WW) \
  case WW:                     \
    return launch<WW>(words, out, n_rows, len, n_phases, stride, s);
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
