// Windowed gear hash at every byte of B rows:
//   h_p = sum_{j<32} mix32(b_{p-j} + 1) << j   (mod 2^32)
// with zero bytes before the start of each row (they hash as mix32(1)).
//
// Replaces the TPU kernel gear_pallas (src/repro/kernels/gear.py) in all
// three of its constructions, _gear_kernel (32 direct taps),
// _gear_kernel_doubling (5 log-doubling levels) and _gear_kernel_hybrid
// (one doubling, then 16 taps): they compute one function, so one kernel
// serves meta['version'] 1, 2 and 3.  The TPU kernel took packed words
// with `tile` words of zero history in front of each row and wrote
// [B, 4, W] phase-major, which the host transposed; this kernel reads the
// bytes themselves, takes any row length in bytes, and writes per-byte
// order [B, L], so the host only slices.
//
// What bounds it on this card: every byte is read once (1 B) and its hash
// written once (4 B), against about 10 integer instructions per byte
// (mix32 of b + 1 and one shift-add).  At 3.35 TB/s that is memory:
// 5 B per byte take longer than the instructions at the card's integer
// issue rate.  The design keeps device traffic at those 5 B per byte:
//   * a block takes a tile of 4096 bytes of one row plus a 32-byte left
//     halo, reads them with coalesced byte loads and keeps mix32(b + 1)
//     of each in shared memory (bytes before the row start read as 0);
//   * each thread runs the FastCDC recurrence h = (h << 1) + g over 16
//     consecutive bytes after a 31-step warm-up on the bytes before them.
//     Bits older than 32 steps shift out of the 32-bit h, so this equals
//     the 32-tap sum exactly, at one shift-add per byte instead of 32;
//   * the hashes go to shared memory and leave in coalesced 4-byte
//     stores.  Shared arrays are skewed by one word per 16 so the 16-byte
//     runs of a warp's threads fall in distinct banks.
//
// Interface: data [B, L] uint8 row-major, out [B, L] uint32.  B <= 65535.
// Launches on the given stream and does not synchronise; returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 16;                  // consecutive bytes per thread
constexpr int kTile = kThreads * kRun;    // bytes per block
constexpr int kHalo = 32;                 // >= 31 bytes of history
constexpr int kWindow = 32;

// one spare word per 16: thread t's run starts at word 17 t + const
__host__ __device__ constexpr int skew(int i) { return i + (i >> 4); }

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__global__ void __launch_bounds__(kThreads)
    gear_kernel(const uint8_t* __restrict__ data, uint32_t* __restrict__ out,
                long long len) {
  __shared__ uint32_t g[skew(kHalo + kTile)];
  __shared__ uint32_t h_out[skew(kTile)];
  const long long row = blockIdx.y;
  const long long t0 = static_cast<long long>(blockIdx.x) * kTile;
  const uint8_t* src = data + row * len;
  uint32_t* dst = out + row * len;

  // local index i holds byte t0 - kHalo + i; past the row end: unused
  for (int i = threadIdx.x; i < kHalo + kTile; i += kThreads) {
    const long long p = t0 - kHalo + i;
    uint32_t byte = 0u;
    if (p >= 0 && p < len) byte = __ldg(src + p);
    g[skew(i)] = mix32(byte + 1u);
  }
  __syncthreads();

  const int base = kHalo + threadIdx.x * kRun;
  uint32_t h = 0u;
#pragma unroll
  for (int j = 0; j < kWindow - 1; ++j)
    h = (h << 1) + g[skew(base - (kWindow - 1) + j)];
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    h = (h << 1) + g[skew(base + k)];
    h_out[skew(threadIdx.x * kRun + k)] = h;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const long long p = t0 + i;
    if (p < len) dst[p] = h_out[skew(i)];
  }
}

}  // namespace

extern "C" int gear_launch(const void* data, void* out, int n_rows,
                           long long len, void* stream) {
  if (n_rows <= 0 || len <= 0) return 0;
  const long long tiles = (len + kTile - 1) / kTile;
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>(n_rows));
  gear_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<uint32_t*>(out), len);
  return static_cast<int>(cudaGetLastError());
}
