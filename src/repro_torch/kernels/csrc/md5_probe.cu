// Latency probe of one MD5 chain: how many SM clocks one thread needs per
// MD5 round when every round waits for the one before.
//
// The direct-MD5 kernel (md5.cu) runs one message per thread, and a
// message's rounds form one dependent chain: b feeds the round function
// (LOP3), its sum with a + K + M (IADD3), the rotation (SHF.L.W) and the
// add that makes the next b (IADD3).  So no launch can hash a message of n
// compressions faster than n * 64 rounds of that chain.  This kernel runs
// md5_compress, the same code md5.cu runs, n_comp times back to back on
// one thread with the message in registers, between two reads of the SM
// clock that the chain's state depends on.  Used only by the smoke run,
// to put a chain bound beside md5_direct's byte and operation bounds.
//
// Interface: out [2] int64 (clocks of the n_comp compressions, and the
// digest's word a so the chain is not dead code), n_comp, seed (makes the
// message words), stream.  One block of one thread.  Returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "md5_core.cuh"

namespace {

__global__ void md5_chain_probe_kernel(long long* __restrict__ out,
                                       long long n_comp, uint32_t seed) {
  uint32_t m[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) m[j] = seed * (2u * j + 1u);
  uint32_t st[4];
  md5_init(st);
  md5_compress(st, m);  // warm up: constant bank and instruction cache
  long long t0, t1;
  asm volatile("mov.u64 %0, %%clock64;\n"
               : "=l"(t0), "+r"(st[0]), "+r"(st[1]), "+r"(st[2]), "+r"(st[3])
               :
               : "memory");
  for (long long i = 0; i < n_comp; ++i) md5_compress(st, m);
  asm volatile("mov.u64 %0, %%clock64;\n"
               : "=l"(t1), "+r"(st[0]), "+r"(st[1]), "+r"(st[2]), "+r"(st[3])
               :
               : "memory");
  out[0] = t1 - t0;
  out[1] = st[0];
}

}  // namespace

extern "C" int md5_chain_probe_launch(void* out, long long n_comp, int seed,
                                      void* stream) {
  md5_chain_probe_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(out), n_comp, static_cast<uint32_t>(seed));
  return static_cast<int>(cudaGetLastError());
}
