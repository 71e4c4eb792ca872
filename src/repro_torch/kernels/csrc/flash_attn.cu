// Causal flash-attention forward with an online softmax.
//
// Replaces the TPU kernel flash_attention_fwd (src/repro/kernels/
// flash_attn.py, _flash_kernel).  That kernel ran a grid (BH, q-block,
// k-block) in order on one core and carried the running max m, the
// normaliser l and the unnormalised output across the k-blocks in its
// output blocks.  Hopper runs blocks in no order, so here one block owns
// one (bh, 64-row q tile) and loops over the k/v tiles itself, with m, l
// and the output accumulator in registers.
//
// This is the f32 path; bf16 runs on the tensor cores in
// flash_attn_wgmma.cu.  Semantics as the reference: q [BH, S, hd], k and v
// [BH, Sk, hd] in f32; scores (q . k) * hd^-0.5; mask k_pos <= q_pos on
// absolute positions (aligned at the start, also when Sk != S); k tiles
// wholly above the diagonal are skipped; the output is acc / l.  expf and
// f32 FMAs throughout; no fast-math.
//
// What bounds it on this card: at S = Sk = 8192, hd = 128 the causal
// products are about 5.5e11 FLOP on 0.27 GB of inputs, so the card's
// arithmetic rate bounds it, not memory.  This kernel computes both
// products in plain f32 FMAs on the CUDA cores (67 TFLOP/s, SXM data
// sheet); the tensor cores' f32 modes (TF32) keep too few digits for the
// reference's 2e-5 without error compensation.  What the design does: each
// thread computes a 4 x 4 tile of scores and a 4 x hd/16 tile of the
// output from shared memory, so every shared-memory word it loads feeds
// 4 FMAs; K is stored transposed with a padded row (65 words) so its
// transposing stores and its reads are free of bank conflicts, and P is
// stored transposed with rows of 68 words so the 16-byte P writes of a
// quarter warp fall in distinct banks.
//
// Interface: q, k, v, o f32 device pointers (contiguous), bh, s, sk, hd in
// {32, 64, 128}, scale.  Grid (ceil(S / 64), BH), 256 threads,
// dynamic shared memory (up to 116 KB at hd 128).  Launches on the given
// stream and does not synchronise; returns cudaGetLastError(), or
// cudaErrorInvalidValue for an unsupported hd.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;           // q rows per block
constexpr int kBK = 64;           // keys per tile
constexpr int kThreads = 256;     // 16 x 16: ty picks rows, tx columns
constexpr int kKStr = kBK + 1;    // kT row stride (words)
constexpr int kPStr = kBQ + 4;    // pT row stride (words, 16-byte rows)
constexpr float kNeg = -1e30f;

template <int HD>
constexpr int smem_floats() {
  return HD * kBQ + HD * kKStr + kBK * HD + kBK * kPStr;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int S, int Sk, float scale) {
  constexpr int kCols = HD / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;                // [HD][kBQ]
  float* kT = qT + HD * kBQ;       // [HD][kKStr]
  float* vs = kT + HD * kKStr;     // [kBK][HD]
  float* pT = vs + kBK * HD;       // [kBK][kPStr]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const long long qbase = static_cast<long long>(blockIdx.y) * S * HD;
  const long long kbase = static_cast<long long>(blockIdx.y) * Sk * HD;

  // q tile, transposed; rows past S read as 0 and are never stored
  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    qT[d * kBQ + r] =
        q0 + r < S ? q[qbase + static_cast<long long>(q0 + r) * HD + d] : 0.f;
  }

  float acc[4][kCols];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  // k tiles up to the one holding the tile's last query (causal skip)
  const int q_last = min(q0 + kBQ, S) - 1;
  const int n_tiles = min((Sk + kBK - 1) / kBK, q_last / kBK + 1);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the q tile is in; the last tile's readers are done
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int r = e / HD, d = e % HD;
      const bool in = k0 + r < Sk;
      const long long gi = kbase + static_cast<long long>(k0 + r) * HD + d;
      kT[d * kKStr + r] = in ? k[gi] : 0.f;
      vs[r * HD + d] = in ? v[gi] : 0.f;
    }
    __syncthreads();

    // scores of rows 4 ty + i against keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a =
          *reinterpret_cast<const float4*>(qT + d * kBQ + 4 * ty);
      const float av[4] = {a.x, a.y, a.z, a.w};
      float bv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = kT[d * kKStr + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    // online softmax; a row's 64 scores live in the 16 lanes of one
    // half-warp (same ty), reduced with xor shuffles over tx
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * ty + i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const float x = (kp <= qp && kp < Sk) ? s[i][j] * scale : kNeg;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pT + (tx + 16 * j) * kPStr + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc += P V for rows 4 ty + i and this thread's output columns:
    // 4 tx + (c % 4) + 64 (c / 4) for hd >= 64, 2 tx + c for hd 32
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 p4 =
          *reinterpret_cast<const float4*>(pT + kk * kPStr + 4 * ty);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      float vv[kCols];
      if constexpr (HD >= 64) {
#pragma unroll
        for (int g = 0; g < HD / 64; ++g) {
          const float4 w =
              *reinterpret_cast<const float4*>(vs + kk * HD + 64 * g + 4 * tx);
          vv[4 * g] = w.x;
          vv[4 * g + 1] = w.y;
          vv[4 * g + 2] = w.z;
          vv[4 * g + 3] = w.w;
        }
      } else {
        const float2 w =
            *reinterpret_cast<const float2*>(vs + kk * HD + 2 * tx);
        vv[0] = w.x;
        vv[1] = w.y;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
    const long long ob = qbase + static_cast<long long>(row) * HD;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = HD >= 64 ? 64 * (c / 4) + 4 * tx + (c % 4) : 2 * tx + c;
      o[ob + col] = acc[i][c] / l[i];
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int s, int sk, float scale, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) * smem_floats<HD>();
  auto kernel = flash_fwd_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((s + kBQ - 1) / kBQ),
                  static_cast<unsigned>(bh));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), s, sk, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attn_fwd_launch(const void* q, const void* k,
                                     const void* v, void* o, int bh, int s,
                                     int sk, int hd, float scale,
                                     void* stream) {
  if (bh <= 0 || s <= 0 || sk <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch<32>(q, k, v, o, bh, s, sk, scale, st);
    case 64:
      return launch<64>(q, k, v, o, bh, s, sk, scale, st);
    case 128:
      return launch<128>(q, k, v, o, bh, s, sk, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
