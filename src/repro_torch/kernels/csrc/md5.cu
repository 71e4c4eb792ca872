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
//
// A second entry, md5_direct_kernel_spans, hashes the chunks of one image
// where they lie, for the write path, which holds the image and its chunk
// ends; rows stay for callers that hold separate blocks (read-verify,
// scrub and repair).

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

// Block digests of n chunks that lie end to end in one image, one thread
// per chunk: MD5(pad4(chunk) || u32_le(len)), the digest md5_direct_kernel
// computes over a pack_blocks row, without the row.  The host copies the
// image to the card once and no padded row is packed, staged or sent.
//
// A chunk starts at any byte (content-defined ends are byte-exact), so
// message word j is the funnel shift by 8 * (start & 3) of image words
// base + j and base + j + 1.  The bytes past the chunk's end in its last
// word belong to the next chunk and are masked to zero; the length word
// follows at word ceil(len / 4), then 0x80 and the bit length, all built
// in registers.  Words of whole 64-byte blocks are loaded one block ahead,
// as in md5_direct_kernel, and never past the word that holds the chunk's
// last byte; the tail blocks clamp their loads to that word, so no read
// leaves the staged image.
//
// Interface: image [n_words] uint32 (the image's bytes, a zero tail to a
// word multiple), starts [n] and lens [n] int64 bytes with start + len <=
// 4 * n_words (the wrapper checks), out [n, 4] uint32.
__global__ void md5_direct_kernel_spans(const uint32_t* __restrict__ image,
                                        const long long* __restrict__ starts,
                                        const long long* __restrict__ lens,
                                        uint32_t* __restrict__ out, int n) {
  const int id = blockIdx.x * blockDim.x + threadIdx.x;
  if (id >= n) return;
  const long long start = starts[id];
  const long long len = lens[id] < 0 ? 0 : lens[id];
  const uint32_t* p = image + (start >> 2);
  const int shift = 8 * static_cast<int>(start & 3);
  const long long lw = (len + 3) >> 2;          // message words of data
  const long long msg = lw + 1;                 // and the length word
  const long long nchunks = (msg + 18) / 16;
  // offset from p of the word that holds the chunk's last byte
  const long long last = len > 0 ? ((start & 3) + len - 1) >> 2 : 0;
  const long long nfull = lw > 0 ? (lw - 1) / 16 : 0;  // no masked word
  const int tail_bytes = static_cast<int>(len - 4 * (lw - 1));
  const uint32_t tail_mask =
      tail_bytes >= 4 ? 0xffffffffu : (1u << (8 * tail_bytes)) - 1u;

  uint32_t st[4];
  md5_init(st);
  uint32_t m[16], nxt[16];
  uint32_t lo = 0u;
  if (nfull > 0) {
    lo = __ldg(p);
    load_chunk(p + 1, nxt);
  }
  for (long long c = 0; c < nfull; ++c) {
    m[0] = __funnelshift_r(lo, nxt[0], shift);
#pragma unroll
    for (int j = 1; j < 16; ++j) m[j] = __funnelshift_r(nxt[j - 1], nxt[j],
                                                        shift);
    lo = nxt[15];
    if (c + 1 < nfull) load_chunk(p + (c + 1) * 16 + 1, nxt);
    md5_compress(st, m);
  }
  const long long blo = nchunks * 16 - 2;
  for (long long c = nfull; c < nchunks; ++c) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const long long w = c * 16 + j;
      uint32_t v = 0u;
      if (w < lw) {
        const uint32_t a = __ldg(p + w);
        const uint32_t b = __ldg(p + (w + 1 < last ? w + 1 : last));
        v = __funnelshift_r(a, b, shift);
        if (w == lw - 1) v &= tail_mask;
      } else if (w == lw) {
        v = static_cast<uint32_t>(len);
      } else if (w == msg) {
        v = 0x80u;
      } else if (w == blo) {
        v = static_cast<uint32_t>(msg << 5);
      } else if (w == blo + 1) {
        v = static_cast<uint32_t>(msg >> 27);
      }
      m[j] = v;
    }
    md5_compress(st, m);
  }
  uint32_t* o = out + static_cast<long long>(id) * 4;
  o[0] = st[0];
  o[1] = st[1];
  o[2] = st[2];
  o[3] = st[3];
}

}  // namespace

extern "C" int md5_spans_launch(const void* image, const void* starts,
                                const void* lens, void* out, int n,
                                void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  md5_direct_kernel_spans<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(image),
      static_cast<const long long*>(starts),
      static_cast<const long long*>(lens), static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

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
