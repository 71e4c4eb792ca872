// One MD5 compression (64 rounds over a 16-word message block), used by
// the direct-MD5 kernel and the chain probe, and MD5's constants and
// schedule, which the sliding-window kernel also uses for its own rounds.
//
// The loop is fully unrolled, so every round constant, shift and message
// index is a compile-time constant: the constants are read from the
// constant bank, the message words stay in registers, and each rotation is
// one funnel shift.
#pragma once

#include <cstdint>

// the 64 round constants, once: in the constant bank for md5_compress,
// and as a constexpr function for code that folds them into immediates
#define REPRO_MD5_K                                                     \
    0xd76aa478u, 0xe8c7b756u, 0x242070dbu, 0xc1bdceeeu,                 \
    0xf57c0fafu, 0x4787c62au, 0xa8304613u, 0xfd469501u,                 \
    0x698098d8u, 0x8b44f7afu, 0xffff5bb1u, 0x895cd7beu,                 \
    0x6b901122u, 0xfd987193u, 0xa679438eu, 0x49b40821u,                 \
    0xf61e2562u, 0xc040b340u, 0x265e5a51u, 0xe9b6c7aau,                 \
    0xd62f105du, 0x02441453u, 0xd8a1e681u, 0xe7d3fbc8u,                 \
    0x21e1cde6u, 0xc33707d6u, 0xf4d50d87u, 0x455a14edu,                 \
    0xa9e3e905u, 0xfcefa3f8u, 0x676f02d9u, 0x8d2a4c8au,                 \
    0xfffa3942u, 0x8771f681u, 0x6d9d6122u, 0xfde5380cu,                 \
    0xa4beea44u, 0x4bdecfa9u, 0xf6bb4b60u, 0xbebfbc70u,                 \
    0x289b7ec6u, 0xeaa127fau, 0xd4ef3085u, 0x04881d05u,                 \
    0xd9d4d039u, 0xe6db99e5u, 0x1fa27cf8u, 0xc4ac5665u,                 \
    0xf4292244u, 0x432aff97u, 0xab9423a7u, 0xfc93a039u,                 \
    0x655b59c3u, 0x8f0ccc92u, 0xffeff47du, 0x85845dd1u,                 \
    0x6fa87e4fu, 0xfe2ce6e0u, 0xa3014314u, 0x4e0811a1u,                 \
    0xf7537e82u, 0xbd3af235u, 0x2ad7d2bbu, 0xeb86d391u

static __constant__ uint32_t kMd5K[64] = {REPRO_MD5_K};

__host__ __device__ constexpr uint32_t md5_k(int i) {
  constexpr uint32_t k[64] = {REPRO_MD5_K};
  return k[i];
}

// the initial value, word j
__host__ __device__ constexpr uint32_t md5_iv(int j) {
  return j == 0 ? 0x67452301u
       : j == 1 ? 0xefcdab89u
       : j == 2 ? 0x98badcfeu
       : 0x10325476u;
}

__device__ __forceinline__ void md5_init(uint32_t st[4]) {
  st[0] = md5_iv(0);
  st[1] = md5_iv(1);
  st[2] = md5_iv(2);
  st[3] = md5_iv(3);
}

// message word read by round i
__host__ __device__ constexpr int md5_g(int i) {
  return i < 16 ? i
       : i < 32 ? (5 * i + 1) % 16
       : i < 48 ? (3 * i + 5) % 16
       : (7 * i) % 16;
}

// left-rotation amount of round i
__host__ __device__ constexpr int md5_s(int i) {
  return i < 16 ? (i % 4 == 0 ? 7 : i % 4 == 1 ? 12 : i % 4 == 2 ? 17 : 22)
       : i < 32 ? (i % 4 == 0 ? 5 : i % 4 == 1 ? 9 : i % 4 == 2 ? 14 : 20)
       : i < 48 ? (i % 4 == 0 ? 4 : i % 4 == 1 ? 11 : i % 4 == 2 ? 16 : 23)
       : (i % 4 == 0 ? 6 : i % 4 == 1 ? 10 : i % 4 == 2 ? 15 : 21);
}

__device__ __forceinline__ void md5_compress(uint32_t st[4],
                                             const uint32_t m[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    uint32_t f;
    if (i < 16) {
      f = (b & c) | (~b & d);
    } else if (i < 32) {
      f = (d & b) | (~d & c);
    } else if (i < 48) {
      f = b ^ c ^ d;
    } else {
      f = c ^ (b | ~d);
    }
    f = f + a + kMd5K[i] + m[md5_g(i)];
    a = d;
    d = c;
    c = b;
    b = b + __funnelshift_l(f, f, md5_s(i));
  }
  st[0] += a;
  st[1] += b;
  st[2] += c;
  st[3] += d;
}
