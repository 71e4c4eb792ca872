// Direct MD5 of B word-aligned messages, one thread per message.
//
// Replaces the TPU kernel md5_pallas (src/repro/kernels/md5.py,
// _md5_kernel).  That kernel put one message per VPU lane and carried the
// digest state across a sequential grid axis of chunk tiles.  Hopper has
// no ordered grid and nothing carries between blocks, so here each thread
// owns one message and loops over its 64-byte chunks with the state in
// registers (the paper's direct-hashing design: one GPU thread per
// segment).
//
// What bounds it on this card: MD5 is a chain of dependent rounds inside
// one message, so a message of n chunks costs n * 64 dependent rounds on
// one thread whatever the card's width.  At the write path's shapes (a few
// dozen 1 MiB blocks per launch) the kernel is bound by the length of one
// thread's dependency chain, not by integer throughput or memory.  The
// design hides the one stall it can: the next chunk's 16 words are loaded
// while the current chunk is compressed.  Blocks of 32 threads put each
// warp on its own SM.
//
// Padding is built in registers as in the TPU kernel: message words below
// lens, 0x80 at word lens, zeros, and the 64-bit bit length in words
// 16*nchunks-2 and 16*nchunks-1.  No word at or past W is ever read, so a
// message may fill its row (lens == W); lens > W hashes the row followed
// by zero words.
//
// Interface: words [B, W] uint32 row-major, lens_w [B] int32 (words),
// out [B, 4] uint32 (a, b, c, d).  Launches on the given stream and does
// not synchronise; returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "md5_core.cuh"

namespace {

constexpr int kThreads = 32;

__device__ __forceinline__ void load_chunk(const uint32_t* __restrict__ p,
                                           uint32_t m[16]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) m[j] = __ldg(p + j);
}

__global__ void md5_direct_kernel(const uint32_t* __restrict__ words,
                                  const int32_t* __restrict__ lens_w,
                                  uint32_t* __restrict__ out, int n_rows,
                                  long long width) {
  const int row_id = blockIdx.x * blockDim.x + threadIdx.x;
  if (row_id >= n_rows) return;
  const uint32_t* row = words + static_cast<long long>(row_id) * width;
  const long long len = lens_w[row_id] < 0 ? 0 : lens_w[row_id];
  const long long nchunks = (len + 18) / 16;
  const long long readable = len < width ? len : width;
  const long long nfull = readable / 16;  // chunks made only of message

  uint32_t st[4];
  md5_init(st);
  uint32_t m[16], nxt[16];
  if (nfull > 0) load_chunk(row, nxt);
  for (long long c = 0; c < nfull; ++c) {
#pragma unroll
    for (int j = 0; j < 16; ++j) m[j] = nxt[j];
    if (c + 1 < nfull) load_chunk(row + (c + 1) * 16, nxt);
    md5_compress(st, m);
  }
  const long long blo = nchunks * 16 - 2;
  for (long long c = nfull; c < nchunks; ++c) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const long long w = c * 16 + j;
      uint32_t v = 0u;
      if (w < readable) {
        v = __ldg(row + w);
      } else if (w == len) {
        v = 0x80u;
      } else if (w == blo) {
        v = static_cast<uint32_t>(len << 5);
      } else if (w == blo + 1) {
        v = static_cast<uint32_t>(len >> 27);
      }
      m[j] = v;
    }
    md5_compress(st, m);
  }
  uint32_t* o = out + static_cast<long long>(row_id) * 4;
  o[0] = st[0];
  o[1] = st[1];
  o[2] = st[2];
  o[3] = st[3];
}

}  // namespace

extern "C" int md5_direct_launch(const void* words, const void* lens_w,
                                 void* out, int n_rows, long long width,
                                 void* stream) {
  if (n_rows <= 0) return 0;
  const int blocks = (n_rows + kThreads - 1) / kThreads;
  md5_direct_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words),
      static_cast<const int32_t*>(lens_w), static_cast<uint32_t*>(out),
      n_rows, width);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
