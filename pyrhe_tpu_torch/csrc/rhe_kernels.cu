// Fused 2-bit genotype decode + moment products for the RHE main path,
// written for Hopper (sm_90a). Bound to Python through ctypes
// (pyrhe_tpu_torch/ops/kernels.py); every entry point launches on the
// caller's stream and returns cudaGetLastError().
//
// Replaces the Pallas TPU kernels of pyrhe_tpu/ops/kernels.py on their
// clean int32-word path:
//   rhe_gp      <- gp_matmul / _gp_kernel          GP  = g @ C
//   rhe_ytg     <- ytg_matmul / _ytg_kernel        out = Yt @ g
//   rhe_ytg_acc <- ytg_acc_matmul / _ytg_acc_kernel
//                  tot += mask * (scale * (sum_halves(Yt @ g) - rank1))
//
// Layout contract (shared with the plain PyTorch versions): `words` is the
// (m_pad, n_pad/16) block of cleaned .bed bytes viewed as little-endian
// int32, 16 two-bit codes per word, no missing codes. Word k of a row holds
// individuals 16k..16k+15; field p (bits 2p..2p+1) is individual 16k+p.
// Decoded columns are in "plane order": word k, plane p lands in column
// (k / 128) * 2048 + p * 128 + k % 128, the 16-plane permutation with
// period 2048 (ops/kernels.plane_permutation).
//
// All sums are f32 FMA chains in a fixed order with no atomics, so every
// launch is deterministic, and rhe_ytg / rhe_ytg_acc share one main loop:
// their products are bitwise equal element by element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileN = 2048;      // plane-permutation period (individuals)
constexpr int kTileWords = 128;   // int32 words per permutation period
constexpr int kPlanes = 16;       // codes per word

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// SWAR dosages of a cleaned word: code 00/10/11 -> 0/1/2 in every 2-bit
// field at once, with no carry between fields. Unsigned: dosage 2 in the
// top field sets bit 31.
__device__ __forceinline__ uint32_t swar_doses(uint32_t w) {
  const uint32_t h = (w >> 1) & 0x55555555u;
  return h + (h & w);
}

// Field p of SWAR dosages as float. OR-ing the 2-bit value into the
// mantissa of 2^23 and subtracting 2^23 is exact and costs one LOP3 and
// one FADD instead of an integer-to-float conversion.
__device__ __forceinline__ float dose_f32(uint32_t d, int p) {
  return __uint_as_float(0x4B000000u | ((d >> (2 * p)) & 3u)) - 8388608.0f;
}

// ------------------------------------------------------------------ gp
// out (m_pad, wc) = g (m_pad, n_pad) @ C (n_pad, wc). One block per tile
// of 16 SNP rows x 24 columns; each block loops over all of N. A warp owns
// 4 rows x 12 columns; its 32 lanes take 32 consecutive words and keep
// 4 x 12 f32 accumulators in registers, reduced over the lanes by a fixed
// shuffle tree at the end. C rows for the 32 words x 8 planes in flight
// are staged through shared memory (odd row stride: lane-strided reads
// hit 32 distinct banks).
constexpr int GP_THREADS = 256;
constexpr int GP_RPT = 4;                 // rows per warp
constexpr int GP_ROWS = 4 * GP_RPT;       // rows per block (4 row groups)
constexpr int GP_CPT = 12;                // columns per warp
constexpr int GP_COLS = 2 * GP_CPT;       // columns per block (2 groups)
constexpr int GP_WORDS = 32;              // words per step, one per lane
constexpr int GP_PLANES = 8;              // planes staged per phase
constexpr int GP_SROW = GP_COLS + 1;

template <typename T>
__global__ void __launch_bounds__(GP_THREADS)
gp_kernel(const uint32_t* __restrict__ words, const T* __restrict__ c,
          float* __restrict__ out, int64_t nw, int wc) {
  __shared__ float cs[GP_PLANES * GP_WORDS * GP_SROW];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row0 = (int64_t)blockIdx.x * GP_ROWS + (warp >> 1) * GP_RPT;
  const int cb = blockIdx.y * GP_COLS;
  const int cw = (warp & 1) * GP_CPT;     // warp's first column in the tile

  float acc[GP_RPT][GP_CPT];
#pragma unroll
  for (int r = 0; r < GP_RPT; ++r)
#pragma unroll
    for (int j = 0; j < GP_CPT; ++j) acc[r][j] = 0.0f;

  for (int64_t k0 = 0; k0 < nw; k0 += GP_WORDS) {
    uint32_t d[GP_RPT];
#pragma unroll
    for (int r = 0; r < GP_RPT; ++r)
      d[r] = swar_doses(words[(row0 + r) * nw + k0 + lane]);
    // column of word k0 + l, plane p: n0 + p * 128 + l
    const int64_t n0 = (k0 / kTileWords) * kTileN + k0 % kTileWords;
#pragma unroll
    for (int ph = 0; ph < kPlanes / GP_PLANES; ++ph) {
      __syncthreads();
      for (int e = threadIdx.x; e < GP_PLANES * GP_WORDS * GP_COLS;
           e += GP_THREADS) {
        const int col = e % GP_COLS, rr = e / GP_COLS;
        const int64_t n = n0 + (int64_t)(ph * GP_PLANES + rr / GP_WORDS)
                                   * kTileWords + rr % GP_WORDS;
        cs[rr * GP_SROW + col] =
            cb + col < wc ? to_f32(c[n * wc + cb + col]) : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int pp = 0; pp < GP_PLANES; ++pp) {
        const float* cr = cs + (pp * GP_WORDS + lane) * GP_SROW + cw;
        float cv[GP_CPT];
#pragma unroll
        for (int j = 0; j < GP_CPT; ++j) cv[j] = cr[j];
#pragma unroll
        for (int r = 0; r < GP_RPT; ++r) {
          const float g = dose_f32(d[r], ph * GP_PLANES + pp);
#pragma unroll
          for (int j = 0; j < GP_CPT; ++j)
            acc[r][j] = fmaf(g, cv[j], acc[r][j]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < GP_RPT; ++r) {
#pragma unroll
    for (int j = 0; j < GP_CPT; ++j) {
      float v = acc[r][j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      const int col = cb + cw + j;
      if (lane == 0 && col < wc) out[(row0 + r) * wc + col] = v;
    }
  }
}

// ----------------------------------------------------------- ytg main loop
// One block per tile of 16 words (x 16 planes = 256 decoded columns) x 32
// Yt rows; the loop over all SNP rows runs inside the block, 32 rows per
// shared-memory step. Thread layout: wl = word in tile (16), pg = plane
// group (4 planes each), qg = Yt row group (8 rows each); every thread
// keeps 8 x 4 f32 accumulators. The Yt tile is stored transposed so a
// thread reads its 8 rows with two 16-byte loads; the 32 threads of a warp
// share one qg, so those loads are broadcasts.
constexpr int YT_THREADS = 256;
constexpr int YT_WORDS = 16;              // words per tile
constexpr int YT_ROWS = 32;               // Yt rows per tile
constexpr int YT_RPT = 8;                 // Yt rows per thread
constexpr int YT_PPT = 4;                 // planes per thread
constexpr int YT_MC = 32;                 // SNP rows per shared-memory step
constexpr int YT_SROW = YT_ROWS + 4;      // keeps float4 alignment

struct YtgSmem {
  uint32_t w[YT_MC][YT_WORDS];
  float y[YT_MC][YT_SROW];
  int rows[YT_ROWS];                      // Yt row of each tile row, or -1
};

// acc[i][pp] = sum over m = 0..m_pad-1, in order, of
//   Yt[rows[qg*8 + i], m] * g[m, column(word kb + wl, plane 4*pg + pp)]
// as one FMA chain. s.rows must be written before the call (the first
// barrier inside publishes it).
template <typename T>
__device__ __forceinline__ void ytg_mainloop(
    const uint32_t* __restrict__ words, const T* __restrict__ yt,
    int64_t m_pad, int64_t nw, int64_t kb, YtgSmem& s,
    float (&acc)[YT_RPT][YT_PPT]) {
  const int wl = threadIdx.x & 15;
  const int pg = (threadIdx.x >> 4) & 3;
  const int qg = threadIdx.x >> 6;
#pragma unroll
  for (int i = 0; i < YT_RPT; ++i)
#pragma unroll
    for (int pp = 0; pp < YT_PPT; ++pp) acc[i][pp] = 0.0f;

  for (int64_t m0 = 0; m0 < m_pad; m0 += YT_MC) {
    __syncthreads();
    for (int e = threadIdx.x; e < YT_MC * YT_WORDS; e += YT_THREADS) {
      const int mm = e / YT_WORDS, w = e % YT_WORDS;
      s.w[mm][w] = words[(m0 + mm) * nw + kb + w];
    }
    for (int e = threadIdx.x; e < YT_ROWS * YT_MC; e += YT_THREADS) {
      const int r = e / YT_MC, mm = e % YT_MC;
      const int q = s.rows[r];
      s.y[mm][r] = q >= 0 ? to_f32(yt[q * m_pad + m0 + mm]) : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int mm = 0; mm < YT_MC; ++mm) {
      const uint32_t d = swar_doses(s.w[mm][wl]) >> (8 * pg);
      float g[YT_PPT];
#pragma unroll
      for (int pp = 0; pp < YT_PPT; ++pp) g[pp] = dose_f32(d, pp);
      const float4 y0 = *reinterpret_cast<const float4*>(&s.y[mm][qg * 8]);
      const float4 y1 =
          *reinterpret_cast<const float4*>(&s.y[mm][qg * 8 + 4]);
      const float yv[YT_RPT] = {y0.x, y0.y, y0.z, y0.w,
                                y1.x, y1.y, y1.z, y1.w};
#pragma unroll
      for (int i = 0; i < YT_RPT; ++i)
#pragma unroll
        for (int pp = 0; pp < YT_PPT; ++pp)
          acc[i][pp] = fmaf(yv[i], g[pp], acc[i][pp]);
    }
  }
}

// Column of this thread's word, plane 4*pg + 0 (add pp * 128 per plane).
__device__ __forceinline__ int64_t ytg_col0(int64_t kb) {
  const int wl = threadIdx.x & 15, pg = (threadIdx.x >> 4) & 3;
  return (kb / kTileWords) * kTileN + kb % kTileWords + wl
         + (int64_t)(4 * pg) * kTileWords;
}

// ------------------------------------------------------------------ ytg
template <typename T>
__global__ void __launch_bounds__(YT_THREADS)
ytg_kernel(const uint32_t* __restrict__ words, const T* __restrict__ yt,
           float* __restrict__ out, int64_t m_pad, int64_t nw, int qr) {
  __shared__ __align__(16) YtgSmem s;
  const int64_t kb = (int64_t)blockIdx.x * YT_WORDS;
  const int q0 = blockIdx.y * YT_ROWS;
  if (threadIdx.x < YT_ROWS) {
    const int q = q0 + threadIdx.x;
    s.rows[threadIdx.x] = q < qr ? q : -1;
  }
  float acc[YT_RPT][YT_PPT];
  ytg_mainloop(words, yt, m_pad, nw, kb, s, acc);

  const int qg = threadIdx.x >> 6;
  const int64_t n_pad = nw * kPlanes, col0 = ytg_col0(kb);
#pragma unroll
  for (int i = 0; i < YT_RPT; ++i) {
    const int q = q0 + qg * YT_RPT + i;
    if (q >= qr) continue;
#pragma unroll
    for (int pp = 0; pp < YT_PPT; ++pp)
      out[q * n_pad + col0 + pp * kTileWords] = acc[i][pp];
  }
}

// -------------------------------------------------------------- ytg_acc
// Same tile geometry and main loop as ytg_kernel. Split: a tile's 32 Yt
// rows are 16 output rows' hi AND lo halves, interleaved so each thread
// holds both halves of its 4 output rows (tile rows i < 4 hi, i >= 4 lo);
// unsplit: 32 output rows. Epilogue in round-to-nearest intrinsics, never
// contracted into FMAs, in the order of the materializing path's separate
// tensor ops: (hi + lo), - rank1, * scale, * mask, then tot + . (bitwise).
__device__ __forceinline__ void acc_store(float a, int oq, int64_t n,
                                          const float* __restrict__ rank1,
                                          const float* __restrict__ scale,
                                          const float* __restrict__ mask,
                                          float* __restrict__ tot,
                                          int64_t n_pad) {
  const float v = __fmul_rn(__fmul_rn(__fsub_rn(a, rank1[oq]), scale[n]),
                            mask[n]);
  tot[oq * n_pad + n] = __fadd_rn(tot[oq * n_pad + n], v);
}

template <typename T>
__global__ void __launch_bounds__(YT_THREADS)
ytg_acc_kernel(const uint32_t* __restrict__ words, const T* __restrict__ yt,
               const float* __restrict__ rank1,
               const float* __restrict__ scale,
               const float* __restrict__ mask, float* __restrict__ tot,
               int64_t m_pad, int64_t nw, int q, int split) {
  __shared__ __align__(16) YtgSmem s;
  const int64_t kb = (int64_t)blockIdx.x * YT_WORDS;
  const int q0 = blockIdx.y * (split ? YT_ROWS / 2 : YT_ROWS);
  if (threadIdx.x < YT_ROWS) {
    const int r = threadIdx.x;
    int oq, yrow;
    if (split) {
      const int i = r % YT_RPT;
      oq = q0 + (r / YT_RPT) * (YT_RPT / 2) + i % (YT_RPT / 2);
      yrow = i < YT_RPT / 2 ? oq : q + oq;
    } else {
      oq = yrow = q0 + r;
    }
    s.rows[r] = oq < q ? yrow : -1;
  }
  float acc[YT_RPT][YT_PPT];
  ytg_mainloop(words, yt, m_pad, nw, kb, s, acc);

  const int qg = threadIdx.x >> 6;
  const int64_t n_pad = nw * kPlanes, col0 = ytg_col0(kb);
  if (split) {
#pragma unroll
    for (int i = 0; i < YT_RPT / 2; ++i) {
      const int oq = q0 + qg * (YT_RPT / 2) + i;
      if (oq >= q) continue;
#pragma unroll
      for (int pp = 0; pp < YT_PPT; ++pp)
        acc_store(__fadd_rn(acc[i][pp], acc[i + YT_RPT / 2][pp]), oq,
                  col0 + pp * kTileWords, rank1, scale, mask, tot, n_pad);
    }
  } else {
#pragma unroll
    for (int i = 0; i < YT_RPT; ++i) {
      const int oq = q0 + qg * YT_RPT + i;
      if (oq >= q) continue;
#pragma unroll
      for (int pp = 0; pp < YT_PPT; ++pp)
        acc_store(acc[i][pp], oq, col0 + pp * kTileWords, rank1, scale,
                  mask, tot, n_pad);
    }
  }
}

}  // namespace

extern "C" {

// Shapes are checked by the Python wrappers: m_pad % 32 == 0,
// nw % 128 == 0, all tensors contiguous on the current device.
int rhe_gp(const void* words, const void* c, int c_bf16, void* out,
           int64_t m_pad, int64_t nw, int wc, void* stream) {
  const dim3 grid((unsigned)(m_pad / GP_ROWS),
                  (unsigned)((wc + GP_COLS - 1) / GP_COLS));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const uint32_t*>(words);
  if (c_bf16)
    gp_kernel<<<grid, GP_THREADS, 0, st>>>(
        w, static_cast<const __nv_bfloat16*>(c), static_cast<float*>(out),
        nw, wc);
  else
    gp_kernel<<<grid, GP_THREADS, 0, st>>>(
        w, static_cast<const float*>(c), static_cast<float*>(out), nw, wc);
  return (int)cudaGetLastError();
}

int rhe_ytg(const void* words, const void* yt, int yt_bf16, void* out,
            int64_t m_pad, int64_t nw, int qr, void* stream) {
  const dim3 grid((unsigned)(nw / YT_WORDS),
                  (unsigned)((qr + YT_ROWS - 1) / YT_ROWS));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const uint32_t*>(words);
  if (yt_bf16)
    ytg_kernel<<<grid, YT_THREADS, 0, st>>>(
        w, static_cast<const __nv_bfloat16*>(yt), static_cast<float*>(out),
        m_pad, nw, qr);
  else
    ytg_kernel<<<grid, YT_THREADS, 0, st>>>(
        w, static_cast<const float*>(yt), static_cast<float*>(out), m_pad,
        nw, qr);
  return (int)cudaGetLastError();
}

int rhe_ytg_acc(const void* words, const void* yt, int yt_bf16,
                const void* rank1, const void* scale, const void* mask,
                void* tot, int64_t m_pad, int64_t nw, int q, int split,
                void* stream) {
  const int rows = split ? YT_ROWS / 2 : YT_ROWS;
  const dim3 grid((unsigned)(nw / YT_WORDS), (unsigned)((q + rows - 1) / rows));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const uint32_t*>(words);
  const auto* r1 = static_cast<const float*>(rank1);
  const auto* sc = static_cast<const float*>(scale);
  const auto* mk = static_cast<const float*>(mask);
  auto* t = static_cast<float*>(tot);
  if (yt_bf16)
    ytg_acc_kernel<<<grid, YT_THREADS, 0, st>>>(
        w, static_cast<const __nv_bfloat16*>(yt), r1, sc, mk, t, m_pad, nw,
        q, split);
  else
    ytg_acc_kernel<<<grid, YT_THREADS, 0, st>>>(
        w, static_cast<const float*>(yt), r1, sc, mk, t, m_pad, nw, q,
        split);
  return (int)cudaGetLastError();
}

}  // extern "C"
