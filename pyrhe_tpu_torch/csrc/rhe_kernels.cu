// Fused 2-bit genotype decode + moment products for RHE and RHE-DOM,
// written for Hopper (sm_90a). Bound to Python through ctypes
// (pyrhe_tpu_torch/ops/kernels.py); every entry point launches on the
// caller's stream and returns cudaGetLastError().
//
// Replaces the Pallas TPU kernels of pyrhe_tpu/ops/kernels.py on their
// clean int32-word path:
//   rhe_gp       <- gp_matmul / _gp_kernel         GP  = g @ C  (g² @ C)
//   rhe_ytg      <- ytg_matmul / _ytg_kernel       out = Yt @ g (Yt @ g²)
//   rhe_ytg_acc  <- ytg_acc_matmul / _ytg_acc_kernel
//                   tot += mask * (scale * (sum_halves(Yt @ g) - rank1))
//   rhe_ytg_acc2 <- ytg_acc2_matmul / _ytg_acc2_kernel
//                   tot += mask * ((sum_halves(Yt1 @ g) + sum_halves(Yt2 @ g²))
//                                  - rank1)
// and adds, for pass 2 (core/normal_eq.py), a kernel with no TPU
// counterpart:
//   rhe_sample_contract  one jackknife sample's length-N contractions
//                        (Gram, covariate projections, border products)
// `square` selects g² = dosage² in {0, 1, 4} (RHE-DOM), the values of the
// reference's _swar_plane(..., square=True).
//
// Layout contract (shared with the plain PyTorch versions): `words` is the
// (m_pad, n_pad/16) block of cleaned .bed bytes viewed as little-endian
// int32, 16 two-bit codes per word, no missing codes. Word k of a row holds
// individuals 16k..16k+15; field p (bits 2p..2p+1) is individual 16k+p.
// Decoded columns are in "plane order": word k, plane p lands in column
// (k / 128) * 2048 + p * 128 + k % 128, the 16-plane permutation with
// period 2048 (ops/kernels.plane_permutation).
//
// No kernel uses atomics and every sum runs in a fixed order, so every
// launch is deterministic. bf16 operands run on the tensor cores
// (mma.sync, f32 accumulators): rhe_gp sums over individuals in a split-K
// grid with an ordered reduction; rhe_ytg / rhe_ytg_acc / rhe_ytg_acc2 sum
// over SNP rows inside one block and share one main loop, so their
// products are bitwise equal element by element. f32 operands take f32
// FMA loops on the CUDA cores instead (the tensor cores would round them
// to TF32), the ytg family again through one shared loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileN = 2048;      // plane-permutation period (individuals)
constexpr int kTileWords = 128;   // int32 words per permutation period
constexpr int kPlanes = 16;       // codes per word

// SWAR dosages of a cleaned word: code 00/10/11 -> 0/1/2 in every 2-bit
// field at once, with no carry between fields. Unsigned: dosage 2 in the
// top field sets bit 31.
__device__ __forceinline__ uint32_t swar_doses(uint32_t w) {
  const uint32_t h = (w >> 1) & 0x55555555u;
  return h + (h & w);
}

// Field p of SWAR dosages as float, squared when `square` (v + (v & 2):
// 0, 1, 2 -> 0, 1, 4). OR-ing the value (at most 4) into the mantissa of
// 2^23 and subtracting 2^23 is exact and costs one LOP3 and one FADD
// instead of an integer-to-float conversion.
__device__ __forceinline__ float dose_f32(uint32_t d, int p, bool square) {
  uint32_t v = (d >> (2 * p)) & 3u;
  if (square) v += v & 2u;
  return __uint_as_float(0x4B000000u | v) - 8388608.0f;
}

// ------------------------------------------------------------------ gp
// out (m_pad, wc) = g (m_pad, n_pad) @ C (n_pad, wc), g² @ C when Square.
// Replaces pyrhe_tpu/ops/kernels.py:476 gp_matmul / _gp_kernel.
//
// Bound: bytes. At one block of the main path (m_pad 1024, n_pad 100352,
// wc 44 bf16 hi|lo) the words (25.7 MB) and C (8.8 MB) take 10.4 us at
// 3.35 TB/s; the 9.0 GFLOP take 9.1 us on the bf16 tensor cores.
//
// Design: a deterministic split-K over individuals that fills the card.
// Block (x, y, z) takes GP_ROWS SNP rows, GP_COLS columns and the z-th
// contiguous range of `per_split` whole plane-permutation periods
// (ops/kernels.gp_splits: the partition depends on the shapes alone), and
// writes its partial product to part[z]; gp_reduce then sums the S partials
// of each output in the order z = 0 .. S-1. No atomics: every launch is
// deterministic. A block walks its periods one group at a time, 16 words x
// 16 planes = 256 individuals, where plane p is the 16 consecutive C rows
// base + p*128 + w0 .. w0+15; the group's words and C rows are staged in
// shared memory with cp.async, double-buffered, while the previous group is
// computed. C rows keep their global width (88 bytes at wc = 44): the copy
// granule is the widest of 16/8/4 bytes that divides the row pitch and the
// base address, with zero-fill of a ragged last granule (2-byte plain
// copies for odd bf16 widths); columns past wc are never stored.
//   bf16 C (split2, the main path): mma.sync m16n8k16 bf16 -> f32 on the
//     tensor cores. A warp owns 32 rows (two m16 tiles) x all the block's
//     columns; one k step is one plane of the group. A thread's A fragment
//     holds words 2t, 2t+1, 2t+8, 2t+9 of rows g and g+8: it decodes the
//     8 words once per group into pairs of 16-bit halves (PRMT) and per
//     plane forms each bf16x2 operand with a shift, an AND-OR that makes
//     bf16 128 + v, and an exact bf16x2 FMA that takes 128 away; dosages
//     (and their squares) are exact in bf16. B fragments come from the
//     staged C tile through ldmatrix.trans (row pitch an odd number of
//     16-byte units: no bank conflicts).
//   f32 C: the same grid, staging and reduction with an f32 FMA loop on
//     the CUDA cores (the tensor cores would round f32 C to TF32); each
//     thread keeps 8 rows x 8 columns.
constexpr int GP_ROWS = 128;                // SNP rows per block
constexpr int GP_THREADS = GP_ROWS;         // one warp per 32 rows
constexpr int GP_COLS = 64;                 // output columns per block
constexpr int GP_GW = 16;                   // words per group
constexpr int GP_IND = GP_GW * kPlanes;     // individuals per group
constexpr int GP_WBYTES = GP_ROWS * GP_GW * 4;   // staged words of a group
constexpr int GP_STAGES = 2;                // groups in flight (buffers)

struct GpShape {
  int64_t m_pad, nw;
  int wc;          // columns of C and out
  int per_split;   // periods per split
  int wp;          // staged columns: wc rounded up to 16, at most GP_COLS
  int gran;        // bytes per copy of a C row segment: 16, 8, 4 or 2
};

// C elements per staged row: bf16 rows are an odd number of 16-byte units
// long (ldmatrix without bank conflicts); f32 rows are read as broadcasts.
template <typename T>
__host__ __device__ constexpr int gp_srow(int wp) {
  return sizeof(T) == 2 ? wp + 8 : wp;
}

template <typename T>
__host__ __device__ constexpr int gp_stage_bytes(int wp) {
  return GP_WBYTES + GP_IND * gp_srow<T>(wp) * (int)sizeof(T);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies `n` <= N bytes and zero-fills the rest of the N-byte granule.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(smem_u32(dst)), "l"(src), "n"(N), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Which granule of which staged C row this thread copies: thread t takes
// granule t % per_row of rows t / per_row, + step, ... (one division per
// launch instead of one per copy); threads past the last whole row idle.
struct GpCopyLane {
  int r0, step, off, nb;     // first row, row step, byte offset, bytes
};

__device__ __forceinline__ GpCopyLane gp_copy_lane(int row_bytes, int gran) {
  const int per_row = (row_bytes + gran - 1) / gran;
  const int step = GP_THREADS / per_row;
  const int q = threadIdx.x % per_row;
  GpCopyLane l;
  l.r0 = threadIdx.x < step * per_row ? threadIdx.x / per_row : GP_IND;
  l.step = step;
  l.off = q * gran;
  l.nb = min(gran, row_bytes - l.off);
  return l;
}

// Stage words [k0, k0 + 16) of the block's rows and the 256 C rows of that
// group (row p*16 + j of the tile is individual n0 + p*128 + j).
template <typename T>
__device__ __forceinline__ void gp_stage(char* buf,
                                         const uint32_t* __restrict__ words,
                                         const T* __restrict__ c,
                                         const GpShape& sh, int64_t row0,
                                         int cb, const GpCopyLane& cl,
                                         int64_t k0) {
  uint32_t* sw = reinterpret_cast<uint32_t*>(buf);
#pragma unroll
  for (int e = threadIdx.x; e < GP_ROWS * 4; e += GP_THREADS) {
    const int r = e >> 2, q = e & 3;
    if (row0 + r < sh.m_pad)
      cp_async<16>(sw + r * GP_GW + 4 * q,
                   words + (row0 + r) * sh.nw + k0 + 4 * q, 16);
  }
  char* sc = buf + GP_WBYTES + cl.off;
  const int pitch = gp_srow<T>(sh.wp) * (int)sizeof(T);
  const char* cs = reinterpret_cast<const char*>(c + cb) + cl.off;
  const int64_t n0 = (k0 / kTileWords) * kTileN + k0 % kTileWords;
  for (int r = cl.r0; r < GP_IND; r += cl.step) {
    const int64_t n = n0 + (int64_t)(r >> 4) * kTileWords + (r & 15);
    const char* src = cs + n * sh.wc * (int64_t)sizeof(T);
    char* dst = sc + r * pitch;
    if (sh.gran == 16) cp_async<16>(dst, src, cl.nb);
    else if (sh.gran == 8) cp_async<8>(dst, src, cl.nb);
    else if (sh.gran == 4) cp_async<4>(dst, src, cl.nb);
    else *reinterpret_cast<uint16_t*>(dst) =
        *reinterpret_cast<const uint16_t*>(src);
  }
}

// Fields 0-7 (lo) and 8-15 (hi) of two words' SWAR dosages as 16-bit
// halves: the word with the lower k in the low half, as mma's bf16x2 wants.
__device__ __forceinline__ void dose_pairs(uint2 w, uint32_t& lo,
                                           uint32_t& hi) {
  const uint32_t d0 = swar_doses(w.x), d1 = swar_doses(w.y);
  lo = __byte_perm(d0, d1, 0x5410);
  hi = __byte_perm(d0, d1, 0x7632);
}

// The two 2-bit fields at `shift` of a pair as bf16x2 dosages (squared
// when Square): (0x4300 | v) is bf16 128 + v, and 1 * x - 128 is exact.
template <bool Square>
__device__ __forceinline__ uint32_t dose_bf16x2(uint32_t pair, int shift) {
  uint32_t x;
  if (Square) {
    const uint32_t v = (pair >> shift) & 0x00030003u;
    x = v + (v & 0x00020002u) + 0x43004300u;         // no carry out of a half
  } else {                                   // (v & mask) | 128: one LOP3
    asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n"
        : "=r"(x) : "r"(pair >> shift), "r"(0x00030003u), "r"(0x43004300u));
  }
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(r) : "r"(x), "r"(0x3F803F80u), "r"(0xC300C300u));
  return r;
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0,
                                              uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr) : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16 C on the tensor cores: warp w owns rows w*32 .. w*32+31 of the
// block as two m16 tiles, and the NT n8 tiles of the block's columns (NT
// is a template parameter so that the plane loop has no branch: the
// scheduler overlaps one pair's ldmatrix with the other pairs' mma).
template <bool Square, int NT>
struct GpMmaTile {
  static_assert(NT % 2 == 0 && NT * 8 <= GP_COLS, "NT: even, <= 8");
  float acc[2][NT][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.0f;
  }

  __device__ __forceinline__ void compute(const char* buf, const GpShape& sh,
                                          int64_t row0) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (row0 + warp * 32 >= sh.m_pad) return;    // m_pad % 32 == 0
    const int g = lane >> 2, t = lane & 3;
    // A register i of m tile mt: 0 (row g, k 2t..2t+1), 1 (row g+8, same
    // k), 2 (row g, k 2t+8..2t+9), 3 (row g+8, k 2t+8..)
    uint32_t lo[2][4], hi[2][4];
    const uint32_t* sw = reinterpret_cast<const uint32_t*>(buf)
                         + (warp * 32 + g) * GP_GW + 2 * t;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t* rw = sw + (mt * 16 + h * 8) * GP_GW;
        dose_pairs(*reinterpret_cast<const uint2*>(rw), lo[mt][h],
                   hi[mt][h]);
        dose_pairs(*reinterpret_cast<const uint2*>(rw + 8), lo[mt][2 + h],
                   hi[mt][2 + h]);
      }
    // ldmatrix x4: lanes 8i..8i+7 address the rows of matrix i = (k half
    // i & 1, n8 tile i >> 1) of a pair of n8 tiles
    constexpr int srow = gp_srow<__nv_bfloat16>(NT * 8);
    const int mi = lane >> 3;
    const uint32_t b_base = smem_u32(
        reinterpret_cast<const __nv_bfloat16*>(buf + GP_WBYTES)
        + ((mi & 1) * 8 + (lane & 7)) * srow + (mi >> 1) * 8);
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[mt][i] = dose_bf16x2<Square>(p < 8 ? lo[mt][i] : hi[mt][i],
                                         2 * (p & 7));
      const uint32_t bp = b_base + p * GP_GW * srow * 2;
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(bp + j * 16, b0, b1, b2, b3);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][j], a[mt], b0, b1);
          mma_bf16(acc[mt][j + 1], a[mt], b2, b3);
        }
      }
    }
  }

  // Accumulator i of an n8 tile: row g + 8 * (i >> 1), column 2t + (i & 1).
  __device__ __forceinline__ void store(float* __restrict__ out,
                                        const GpShape& sh, int64_t row0,
                                        int cb) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t row = row0 + warp * 32 + mt * 16 + (i >> 1) * 8 + g;
        if (row >= sh.m_pad) continue;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = cb + j * 8 + 2 * t + (i & 1);
          if (col < sh.wc) out[row * sh.wc + col] = acc[mt][j][i];
        }
      }
  }
};

// f32 C on the CUDA cores: thread (rg, cg) keeps rows rg*8 .. rg*8+7 x
// columns cg*8 .. cg*8+7 of the block, one FMA chain per output in
// (group, word, plane) order.
template <bool Square>
struct GpFmaTile {
  float acc[8][8];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[i][q] = 0.0f;
  }

  __device__ __forceinline__ void compute(const char* buf, const GpShape& sh,
                                          int64_t row0) {
    const int rg = threadIdx.x >> 3, cg = threadIdx.x & 7;
    if (row0 + rg * 8 >= sh.m_pad || cg * 8 >= sh.wp) return;
    const uint32_t* sw = reinterpret_cast<const uint32_t*>(buf)
                         + rg * 8 * GP_GW;
    const float* sc = reinterpret_cast<const float*>(buf + GP_WBYTES)
                      + cg * 8;
    for (int j = 0; j < GP_GW; ++j) {
      uint32_t d[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) d[i] = swar_doses(sw[i * GP_GW + j]);
#pragma unroll
      for (int p = 0; p < kPlanes; ++p) {
        const float4* cr =
            reinterpret_cast<const float4*>(sc + (p * GP_GW + j) * sh.wp);
        const float4 c0 = cr[0], c1 = cr[1];
        const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float gv = dose_f32(d[i], p, Square);
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[i][q] = fmaf(gv, cv[q], acc[i][q]);
        }
      }
    }
  }

  __device__ __forceinline__ void store(float* __restrict__ out,
                                        const GpShape& sh, int64_t row0,
                                        int cb) const {
    const int rg = threadIdx.x >> 3, cg = threadIdx.x & 7;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int64_t row = row0 + rg * 8 + i;
      if (row >= sh.m_pad) continue;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int col = cb + cg * 8 + q;
        if (col < sh.wc) out[row * sh.wc + col] = acc[i][q];
      }
    }
  }
};

// One block: rows [x * GP_ROWS, +GP_ROWS), columns [y * GP_COLS,
// +GP_COLS), periods [z * per_split, +per_split) clipped to n_pad; its
// partial product goes to part[z] (the output itself when S == 1).
template <class Tile, typename T>
__global__ void __launch_bounds__(GP_THREADS)
gp_kernel(const uint32_t* __restrict__ words, const T* __restrict__ c,
          float* __restrict__ part, GpShape sh) {
  extern __shared__ __align__(16) char smem[];
  const int64_t row0 = (int64_t)blockIdx.x * GP_ROWS;
  const int cb = blockIdx.y * GP_COLS, ncols = min(GP_COLS, sh.wc - cb);
  const int64_t periods = sh.nw / kTileWords;
  const int64_t p0 = (int64_t)blockIdx.z * sh.per_split;
  const int groups = (int)((min(periods, p0 + sh.per_split) - p0)
                           * (kTileWords / GP_GW));
  const int64_t k0 = p0 * kTileWords;
  const int stage = gp_stage_bytes<T>(sh.wp);

  const GpCopyLane cl = gp_copy_lane(ncols * (int)sizeof(T), sh.gran);

  Tile tile;
  tile.zero();
#pragma unroll
  for (int i = 0; i < GP_STAGES - 1; ++i) {
    if (i < groups)
      gp_stage(smem + i * stage, words, c, sh, row0, cb, cl,
               k0 + (int64_t)i * GP_GW);
    cp_async_commit();
  }
  for (int i = 0; i < groups; ++i) {
    const int next = i + GP_STAGES - 1;
    if (next < groups)
      gp_stage(smem + (next % GP_STAGES) * stage, words, c, sh, row0, cb, cl,
               k0 + (int64_t)next * GP_GW);
    cp_async_commit();          // empty groups near the end keep the count
    cp_async_wait<GP_STAGES - 1>();   // group i has landed
    __syncthreads();
    tile.compute(smem + (i % GP_STAGES) * stage, sh, row0);
    __syncthreads();            // its buffer is free for group i + STAGES
  }
  tile.store(part + (int64_t)blockIdx.z * sh.m_pad * sh.wc, sh, row0, cb);
}

// out[i] = part[0][i] + part[1][i] + ... + part[S-1][i], in that order.
__global__ void gp_reduce(const float* __restrict__ part,
                          float* __restrict__ out, int splits, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = part[i];
#pragma unroll 8
  for (int s = 1; s < splits; ++s) v = __fadd_rn(v, part[s * n + i]);
  out[i] = v;
}

// ------------------------------------------------------------ ytg family
// Three kernels, one main loop per operand type, so that their products
// are bitwise equal element by element:
//   ytg_kernel         out (Qr, n_pad) = Yt @ g (Yt @ g² when Square);
//                      replaces pyrhe_tpu/ops/kernels.py:524 ytg_matmul
//   ytg_acc_kernel<1>  tot += mask * (scale * (sum_halves(Yt @ g) - rank1));
//                      replaces pyrhe_tpu/ops/kernels.py:407 ytg_acc_matmul
//   ytg_acc_kernel<2>  tot += mask * ((sum_halves(Yt1 @ g)
//                                      + sum_halves(Yt2 @ g²)) - rank1);
//                      replaces pyrhe_tpu/ops/kernels.py:346 ytg_acc2_matmul
//
// Bound: operations. At one block of the main path (320 split Yt rows,
// m_pad 1024, n_pad 100352) the 65.8 GFLOP take 66.5 us on the bf16
// tensor cores (ytg_acc2: two products, 133 us); the words (25.7 MB) and
// the f32 output, or the totals' read and write (128 MB), take 46 us at
// 3.35 TB/s.
//
// Design for bf16 Yt (split2 hi/lo rows, the main path; or plain bf16):
// mma.sync m16n8k16 bf16 -> f32 on the tensor cores with A = Yt (m = Yt
// rows, k = SNP rows) and B = dosages (k = SNP rows, n = 8 consecutive
// words at one plane: 8 consecutive output columns). A block of 8 warps
// takes 64 Yt rows, picked by a row map (identity; for the split acc
// kernels the hi and lo rows of one output row sit at rows r and r + 8 of
// one m16 tile, so one thread holds both halves), x MT*NT words x 16
// planes, and loops over all SNP rows inside the block in increasing
// order, 64 a stage: each stage's words and mapped Yt rows are staged
// with cp.async in a 4-stage ring (unmapped rows and rows past m_pad
// zero-filled; no f32 copy). A warp owns MT m16 tiles of rows x NT planes
// of one 8-word group. Per k16 step a thread loads its word column at SNP
// rows 2t, 2t+1, 2t+8, 2t+9 (its B fragment's k), packs the halves
// holding its planes into two 16-bit pairs (PRMT), SWAR-decodes each pair
// once and forms every plane's b0 / b1 with one LOP3 and one exact bf16x2
// FMA (field_bf16x2; g² with one more, square_bf16x2); one B pair feeds
// the warp's MT m16 tiles (and both operands of ytg_acc2). A fragments
// come from the staged Yt through ldmatrix. No split-K, no atomics: every
// accumulator starts at zero and takes the same mma chain in increasing k
// in all three kernels, whatever the tile shape, so results depend on the
// shapes alone. (MT, NT) are template parameters, so no branch separates
// ldmatrix from mma: 64 accumulators a thread, (4, 4) for ytg, (2, 8) for
// ytg_acc, (2, 4) per operand for ytg_acc2, each the fastest of the shapes
// timed on the card.
//
// f32 Yt (not on the card's main path) takes the CUDA-core FMA loop
// further down: the tensor cores would round it to TF32.
constexpr int YM_THREADS = 256;          // 8 warps
constexpr int YM_ROWS = 64;              // Yt rows per block
constexpr int YM_KC = 64;                // SNP rows per stage
constexpr int YM_STAGES = 4;             // stages in the ring
constexpr int YM_WPITCH = 20;            // staged words per SNP row: 2*20 % 32
                                         // == 8, so B loads are conflict-free
constexpr int YM_YPITCH = YM_KC + 8;     // staged bf16 per Yt row: 144 bytes,
                                         // an odd number of 16-byte units
constexpr int YM_WBYTES = YM_KC * YM_WPITCH * 4;
constexpr int YM_YBYTES = YM_ROWS * YM_YPITCH * 2;
constexpr int YTG_MT = 4, YTG_NT = 4;    // m16 tiles, planes a warp: ytg
constexpr int ACC_MT = 2, ACC_NT = 8;    // ytg_acc
constexpr int ACC2_MT = 2, ACC2_NT = 4;  // ytg_acc2 (two operand sets)

template <int NOps>
__host__ __device__ constexpr int ym_stage_bytes() {
  return YM_WBYTES + NOps * YM_YBYTES;
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
      : "memory");
}

// The 2-bit field at bit pos (0, 2 or 4) of each 16-bit half of d as
// bf16x2 dosages: OR-ing it into the mantissa of bf16 2^(7 - pos) (one
// LOP3) gives 2^(7 - pos) + v, and one exact bf16x2 FMA takes 2^(7 - pos)
// away. Fields 0-7 of a half sit at pos 2 (j % 3) of d >> 6 (j / 3).
__device__ __forceinline__ uint32_t field_bf16x2(uint32_t d, int pos) {
  const uint32_t base = (uint32_t)(134 - pos) << 7;       // bf16 2^(7 - pos)
  uint32_t x, r;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n"
      : "=r"(x) : "r"(d), "r"(0x00030003u << pos), "r"(base * 0x10001u));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(r)
      : "r"(x), "r"(0x3F803F80u), "r"((base | 0x8000u) * 0x10001u));
  return r;
}

// v * v: bf16x2 dosages 0, 1, 2 -> 0, 1, 4, exact (adding -0 keeps +0).
__device__ __forceinline__ uint32_t square_bf16x2(uint32_t v) {
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %1, %2;\n"
      : "=r"(r) : "r"(v), "r"(0x80008000u));
  return r;
}

// Column of word w at plane 0 (add p * 128 for plane p).
__device__ __forceinline__ int64_t word_col(int64_t w) {
  return (w / kTileWords) * kTileN + w % kTileWords;
}

// Stage SNP rows [m0, m0 + YM_KC): the block's WB words of each, and
// the 64 mapped rows of each Yt operand. Unmapped rows (rows[r] < 0) and
// SNP rows past m_pad are zero-filled; zero words decode to dosage 0, so
// a stage past m_pad adds exact zeros. Every loop has a compile-time trip
// count (YM_THREADS copies a round), so the copies unroll into straight
// code.
template <int NOps, int WB>
__device__ __forceinline__ void ym_stage(char* buf,
                                         const uint32_t* __restrict__ words,
                                         const __nv_bfloat16* yt0,
                                         const __nv_bfloat16* yt1,
                                         const int* rows, int64_t m_pad,
                                         int64_t nw, int64_t kb, int64_t m0) {
  constexpr int WCP = WB / 4;            // 16-byte copies per word row
  constexpr int YCP = YM_KC / 8;         // 16-byte copies per Yt row
  constexpr int NW = YM_KC * WCP, NY = YM_ROWS * YCP;
  static_assert(NY % YM_THREADS == 0, "Yt copies: whole rounds");
  uint32_t* sw = reinterpret_cast<uint32_t*>(buf);
#pragma unroll
  for (int i = 0; i < (NW + YM_THREADS - 1) / YM_THREADS; ++i) {
    const int e = threadIdx.x + i * YM_THREADS;
    if (NW % YM_THREADS == 0 || e < NW) {
      const int r = e / WCP, q = e % WCP;
      const bool ok = m0 + r < m_pad;
      cp_async<16>(sw + r * YM_WPITCH + 4 * q,
                   ok ? words + (m0 + r) * nw + kb + 4 * q : words,
                   ok ? 16 : 0);
    }
  }
#pragma unroll
  for (int k = 0; k < NOps; ++k) {
    const __nv_bfloat16* yt = k == 0 ? yt0 : yt1;
    __nv_bfloat16* sy =
        reinterpret_cast<__nv_bfloat16*>(buf + YM_WBYTES + k * YM_YBYTES);
#pragma unroll
    for (int i = 0; i < NY / YM_THREADS; ++i) {
      const int e = threadIdx.x + i * YM_THREADS;
      const int r = e / YCP, q = e % YCP, y = rows[r];
      const bool ok = y >= 0 && m0 + 8 * q < m_pad;
      cp_async<16>(sy + r * YM_YPITCH + 8 * q,
                   ok ? yt + y * m_pad + m0 + 8 * q : yt, ok ? 16 : 0);
    }
  }
}

// One warp's accumulators: acc[k][mt][j] is the m16 x n8 tile of operand
// k (Yt1 against g, or g² when Square; Yt2 against g²), m16 tile mt of
// the warp's rows, plane plane0 + j. Accumulator i of a tile: tile row
// g + 8 * (i >> 1), word 2t + (i & 1) of the warp's group, so i = 0, 1
// (and 2, 3) are two adjacent output columns.
template <int NOps, int MT, int NT, bool Square>
struct YtgMmaTile {
  static_assert(YM_ROWS % (16 * MT) == 0 && 8 % NT == 0 && MT * NT % 8 == 0,
                "the warps' m16 tiles cover the block's rows, a warp's planes "
                "lie in one 16-bit half, and the 8 warps whole 8-word groups");
  static constexpr int kRows = 16 * MT;                // Yt rows a warp
  static constexpr int kRowWarps = YM_ROWS / kRows;
  static constexpr int kWarpsPerGroup = kPlanes / NT;
  static constexpr int kWords = MT * NT;               // words a block
  float acc[NOps][MT][NT][4];
  int wr, wcol, plane0;       // row warp, first word, first plane

  __device__ __forceinline__ YtgMmaTile() {
    const int warp = threadIdx.x >> 5, wc = warp / kRowWarps;
    wr = warp % kRowWarps;
    wcol = 8 * (wc / kWarpsPerGroup);
    plane0 = NT * (wc % kWarpsPerGroup);
#pragma unroll
    for (int k = 0; k < NOps; ++k)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[k][mt][j][i] = 0.0f;
  }

  __device__ __forceinline__ void compute(const char* buf) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    // the 16-bit halves holding planes plane0 .. plane0 + NT - 1
    const uint32_t sel = plane0 < 8 ? 0x5410u : 0x7632u;
    const int sh = 2 * (plane0 & 7);
    const uint32_t* sw = reinterpret_cast<const uint32_t*>(buf)
                         + 2 * t * YM_WPITCH + wcol + g;
    // ldmatrix x4: lane l addresses row (l & 7) + 8 ((l >> 3) & 1), k
    // 8 (l >> 4) of an m16 x k16 tile, which gives a0 .. a3 in mma order
    const uint32_t a_base = smem_u32(
        reinterpret_cast<const __nv_bfloat16*>(buf + YM_WBYTES)
        + (wr * kRows + (lane & 7) + ((lane >> 3) & 1) * 8) * YM_YPITCH
        + (lane >> 4) * 8);
#pragma unroll
    for (int kk = 0; kk < YM_KC; kk += 16) {
      const uint32_t* w = sw + kk * YM_WPITCH;
      const uint32_t d0 =
          swar_doses(__byte_perm(w[0], w[YM_WPITCH], sel)) >> sh;
      const uint32_t d1 = swar_doses(
          __byte_perm(w[8 * YM_WPITCH], w[9 * YM_WPITCH], sel)) >> sh;
      uint32_t a[NOps][MT][4];
#pragma unroll
      for (int k = 0; k < NOps; ++k)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldsm_x4(a_base + k * YM_YBYTES
                      + (mt * 16 * YM_YPITCH + kk) * 2, a[k][mt]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int s = 6 * (j / 3), pos = 2 * (j % 3);
        const uint32_t v0 = field_bf16x2(d0 >> s, pos);
        const uint32_t v1 = field_bf16x2(d1 >> s, pos);
#pragma unroll
        for (int k = 0; k < NOps; ++k) {
          const bool sq = Square || k > 0;
          const uint32_t b0 = sq ? square_bf16x2(v0) : v0;
          const uint32_t b1 = sq ? square_bf16x2(v1) : v1;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_bf16(acc[k][mt][j], a[k][mt], b0, b1);
        }
      }
    }
  }

  // Column of accumulator 0 of plane plane0 (add j * 128 for plane j).
  __device__ __forceinline__ int64_t col0(int64_t kb) const {
    return word_col(kb + wcol + 2 * (threadIdx.x & 3))
           + (int64_t)plane0 * kTileWords;
  }
};

// The ytg family's main loop over SNP rows: rows[] (the block's row map)
// must be written before the call; the first barrier publishes it. A warp
// whose first mapped row is unmapped has no mapped row (both maps grow
// with the tile row) and skips the mma.
template <int NOps, class Tile>
__device__ __forceinline__ void ytg_mma_mainloop(
    Tile& tile, char* smem, const int* rows,
    const uint32_t* __restrict__ words, const __nv_bfloat16* yt0,
    const __nv_bfloat16* yt1, int64_t m_pad, int64_t nw, int64_t kb) {
  constexpr int stage = ym_stage_bytes<NOps>();
  constexpr int WB = Tile::kWords;
  __syncthreads();
  const bool active = rows[tile.wr * Tile::kRows] >= 0;
  const int nk = (int)((m_pad + YM_KC - 1) / YM_KC);
#pragma unroll
  for (int s = 0; s < YM_STAGES - 1; ++s) {
    if (s < nk)
      ym_stage<NOps, WB>(smem + s * stage, words, yt0, yt1, rows, m_pad, nw,
                         kb, (int64_t)s * YM_KC);
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<YM_STAGES - 2>();   // stage i has landed (this thread's)
    __syncthreads();                  // everyone's; stage i - 1 is computed
    const int next = i + YM_STAGES - 1;
    if (next < nk)
      ym_stage<NOps, WB>(smem + (next % YM_STAGES) * stage, words, yt0, yt1,
                         rows, m_pad, nw, kb, (int64_t)next * YM_KC);
    cp_async_commit();                // empty groups near the end keep count
    if (active) tile.compute(smem + (i % YM_STAGES) * stage);
  }
}

template <bool Square, int MT, int NT>
__global__ void __launch_bounds__(YM_THREADS, 2)
ytg_kernel(const uint32_t* __restrict__ words,
           const __nv_bfloat16* __restrict__ yt, float* __restrict__ out,
           int64_t m_pad, int64_t nw, int qr) {
  extern __shared__ __align__(16) char smem[];
  __shared__ int rows[YM_ROWS];
  using Tile = YtgMmaTile<1, MT, NT, Square>;
  const int q0 = blockIdx.x * YM_ROWS;
  const int64_t kb = (int64_t)blockIdx.y * Tile::kWords;
  if (threadIdx.x < YM_ROWS) {
    const int q = q0 + threadIdx.x;
    rows[threadIdx.x] = q < qr ? q : -1;
  }
  Tile tile;
  ytg_mma_mainloop<1>(tile, smem, rows, words, yt, yt, m_pad, nw, kb);

  const int g = (threadIdx.x & 31) >> 2;
  const int64_t n_pad = nw * kPlanes, col0 = tile.col0(kb);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = q0 + tile.wr * Tile::kRows + mt * 16 + h * 8 + g;
      if (q >= qr) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        *reinterpret_cast<float2*>(out + q * n_pad + col0 + j * kTileWords) =
            make_float2(tile.acc[0][mt][j][2 * h],
                        tile.acc[0][mt][j][2 * h + 1]);
    }
}

// The acc epilogue of one element, each step rounded on its own (never
// contracted into FMAs) in the order of the materializing path's tensor
// ops, so the result is bitwise equal to them:
//   NOps = 1: tot + mask * (scale * (a0 - rank1))    (a0 = hi + lo)
//   NOps = 2: tot + mask * ((a0 + a1) - rank1)       (a0 = hi1 + lo1, ...)
template <int NOps>
__device__ __forceinline__ float acc_value(float a0, float a1, float r1,
                                           float s, float m, float t) {
  float v = __fsub_rn(NOps == 2 ? __fadd_rn(a0, a1) : a0, r1);
  if (NOps == 1) v = __fmul_rn(v, s);
  return __fadd_rn(t, __fmul_rn(v, m));
}

// acc_value at columns n, n + 1 of output row oq, as 8-byte accesses.
template <int NOps>
__device__ __forceinline__ void acc_store2(
    const float (&a0)[2], const float (&a1)[2], int oq, int64_t n,
    const float* __restrict__ rank1, const float* __restrict__ scale,
    const float* __restrict__ mask, float* __restrict__ tot, int64_t n_pad) {
  float2* tp = reinterpret_cast<float2*>(tot + oq * n_pad + n);
  const float2 m = *reinterpret_cast<const float2*>(mask + n);
  const float2 s = NOps == 1 ? *reinterpret_cast<const float2*>(scale + n)
                             : make_float2(1.0f, 1.0f);
  const float r1 = rank1[oq];
  float2 v = *tp;
  v.x = acc_value<NOps>(a0[0], a1[0], r1, s.x, m.x, v.x);
  v.y = acc_value<NOps>(a0[1], a1[1], r1, s.y, m.y, v.y);
  *tp = v;
}

// NOps = 1 (ytg_acc): one operand against g, epilogue with the
// per-individual scale. NOps = 2 (ytg_acc2, dominance): Yt1 against g and
// Yt2 against g² over the same staged words, same row map, no scale.
// Split: tile row r holds the hi (r & 8 == 0) or lo half of output row
// q0 + (r >> 4) * 8 + (r & 7), so a block takes 32 output rows; unsplit:
// 64 output rows as they come.
template <int NOps, int MT, int NT>
__global__ void __launch_bounds__(YM_THREADS, 2)
ytg_acc_kernel(const uint32_t* __restrict__ words,
               const __nv_bfloat16* __restrict__ yt0,
               const __nv_bfloat16* __restrict__ yt1,
               const float* __restrict__ rank1,
               const float* __restrict__ scale,
               const float* __restrict__ mask, float* __restrict__ tot,
               int64_t m_pad, int64_t nw, int q, int split) {
  extern __shared__ __align__(16) char smem[];
  __shared__ int rows[YM_ROWS];
  using Tile = YtgMmaTile<NOps, MT, NT, false>;
  const int q0 = blockIdx.x * (split ? YM_ROWS / 2 : YM_ROWS);
  const int64_t kb = (int64_t)blockIdx.y * Tile::kWords;
  if (threadIdx.x < YM_ROWS) {
    const int r = threadIdx.x;
    const int oq = split ? q0 + (r >> 4) * 8 + (r & 7) : q0 + r;
    rows[r] = oq >= q ? -1 : (split && (r & 8)) ? q + oq : oq;
  }
  Tile tile;
  ytg_mma_mainloop<NOps>(tile, smem, rows, words, yt0, yt1, m_pad, nw, kb);

  const int g = (threadIdx.x & 31) >> 2;
  const int64_t n_pad = nw * kPlanes, col0 = tile.col0(kb);
  constexpr int L = NOps - 1;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int64_t n = col0 + j * kTileWords;
      const float(&c0)[4] = tile.acc[0][mt][j];
      const float(&c1)[4] = tile.acc[L][mt][j];
      if (split) {
        const int oq = q0 + (tile.wr * MT + mt) * 8 + g;
        if (oq >= q) continue;
        const float a0[2] = {__fadd_rn(c0[0], c0[2]),
                             __fadd_rn(c0[1], c0[3])};
        const float a1[2] = {__fadd_rn(c1[0], c1[2]),
                             __fadd_rn(c1[1], c1[3])};
        acc_store2<NOps>(a0, a1, oq, n, rank1, scale, mask, tot, n_pad);
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int oq = q0 + tile.wr * Tile::kRows + mt * 16 + h * 8 + g;
          if (oq >= q) continue;
          const float a0[2] = {c0[2 * h], c0[2 * h + 1]};
          const float a1[2] = {c1[2 * h], c1[2 * h + 1]};
          acc_store2<NOps>(a0, a1, oq, n, rank1, scale, mask, tot, n_pad);
        }
      }
    }
}

// ------------------------------------------------ ytg family, f32 Yt
// The same three contracts in f32 FMA chains on the CUDA cores. One block
// per tile of 16 words (x 16 planes = 256 decoded columns) x 32 Yt rows;
// the loop over all SNP rows runs inside the block, 32 rows per
// shared-memory step. Thread layout: wl = word in tile (16), pg = plane
// group (4 planes each), qg = Yt row group (8 rows each); every thread
// keeps 8 x 4 f32 accumulators per operand. The Yt tile is stored
// transposed so a thread reads its 8 rows with two 16-byte loads; the 32
// threads of a warp share one qg, so those loads are broadcasts.
constexpr int YT_THREADS = 256;
constexpr int YT_WORDS = 16;              // words per tile
constexpr int YT_ROWS = 32;               // Yt rows per tile
constexpr int YT_RPT = 8;                 // Yt rows per thread
constexpr int YT_PPT = 4;                 // planes per thread
constexpr int YT_MC = 32;                 // SNP rows per shared-memory step
constexpr int YT_SROW = YT_ROWS + 4;      // keeps float4 alignment

template <int NOps>
struct YtgSmem {
  uint32_t w[YT_MC][YT_WORDS];
  float y[NOps][YT_MC][YT_SROW];
  int rows[YT_ROWS];                      // Yt row of each tile row, or -1
};

// acc[k][i][pp] = sum over m = 0..m_pad-1, in order, of
//   Yt_k[rows[qg*8 + i], m] * x_k[m, column(word kb + wl, plane 4*pg + pp)]
// as one FMA chain, where x_0 = g (g² when Square) and x_1 = g² (NOps = 2:
// both operands share the tile rows, the staged words and their decode).
// Operand k's chain is the one a one-operand launch with Square = (k > 0
// || Square) computes for that row. s.rows must be written before the call
// (the first barrier inside publishes it).
template <bool Square, int NOps>
__device__ __forceinline__ void ytg_fma_mainloop(
    const uint32_t* __restrict__ words, const float* __restrict__ yt0,
    const float* __restrict__ yt1, int64_t m_pad, int64_t nw, int64_t kb,
    YtgSmem<NOps>& s, float (&acc)[NOps][YT_RPT][YT_PPT]) {
  const int wl = threadIdx.x & 15;
  const int pg = (threadIdx.x >> 4) & 3;
  const int qg = threadIdx.x >> 6;
#pragma unroll
  for (int k = 0; k < NOps; ++k)
#pragma unroll
    for (int i = 0; i < YT_RPT; ++i)
#pragma unroll
      for (int pp = 0; pp < YT_PPT; ++pp) acc[k][i][pp] = 0.0f;

  for (int64_t m0 = 0; m0 < m_pad; m0 += YT_MC) {
    __syncthreads();
    for (int e = threadIdx.x; e < YT_MC * YT_WORDS; e += YT_THREADS) {
      const int mm = e / YT_WORDS, w = e % YT_WORDS;
      s.w[mm][w] = words[(m0 + mm) * nw + kb + w];
    }
#pragma unroll
    for (int k = 0; k < NOps; ++k) {
      const float* __restrict__ yt = k == 0 ? yt0 : yt1;
      for (int e = threadIdx.x; e < YT_ROWS * YT_MC; e += YT_THREADS) {
        const int r = e / YT_MC, mm = e % YT_MC;
        const int q = s.rows[r];
        s.y[k][mm][r] = q >= 0 ? yt[q * m_pad + m0 + mm] : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int mm = 0; mm < YT_MC; ++mm) {
      const uint32_t d = swar_doses(s.w[mm][wl]) >> (8 * pg);
#pragma unroll
      for (int k = 0; k < NOps; ++k) {
        float g[YT_PPT];
#pragma unroll
        for (int pp = 0; pp < YT_PPT; ++pp)
          g[pp] = dose_f32(d, pp, Square || k > 0);
        const float4 y0 =
            *reinterpret_cast<const float4*>(&s.y[k][mm][qg * 8]);
        const float4 y1 =
            *reinterpret_cast<const float4*>(&s.y[k][mm][qg * 8 + 4]);
        const float yv[YT_RPT] = {y0.x, y0.y, y0.z, y0.w,
                                  y1.x, y1.y, y1.z, y1.w};
#pragma unroll
        for (int i = 0; i < YT_RPT; ++i)
#pragma unroll
          for (int pp = 0; pp < YT_PPT; ++pp)
            acc[k][i][pp] = fmaf(yv[i], g[pp], acc[k][i][pp]);
      }
    }
  }
}

// Column of this thread's word, plane 4*pg + 0 (add pp * 128 per plane).
__device__ __forceinline__ int64_t ytg_col0(int64_t kb) {
  const int wl = threadIdx.x & 15, pg = (threadIdx.x >> 4) & 3;
  return word_col(kb + wl) + (int64_t)(4 * pg) * kTileWords;
}

template <bool Square>
__global__ void __launch_bounds__(YT_THREADS)
ytg_fma_kernel(const uint32_t* __restrict__ words,
               const float* __restrict__ yt, float* __restrict__ out,
               int64_t m_pad, int64_t nw, int qr) {
  __shared__ __align__(16) YtgSmem<1> s;
  const int64_t kb = (int64_t)blockIdx.x * YT_WORDS;
  const int q0 = blockIdx.y * YT_ROWS;
  if (threadIdx.x < YT_ROWS) {
    const int q = q0 + threadIdx.x;
    s.rows[threadIdx.x] = q < qr ? q : -1;
  }
  float acc[1][YT_RPT][YT_PPT];
  ytg_fma_mainloop<Square>(words, yt, yt, m_pad, nw, kb, s, acc);

  const int qg = threadIdx.x >> 6;
  const int64_t n_pad = nw * kPlanes, col0 = ytg_col0(kb);
#pragma unroll
  for (int i = 0; i < YT_RPT; ++i) {
    const int q = q0 + qg * YT_RPT + i;
    if (q >= qr) continue;
#pragma unroll
    for (int pp = 0; pp < YT_PPT; ++pp)
      out[q * n_pad + col0 + pp * kTileWords] = acc[0][i][pp];
  }
}

template <int NOps>
__device__ __forceinline__ void acc_store(float a0, float a1, int oq,
                                          int64_t n,
                                          const float* __restrict__ rank1,
                                          const float* __restrict__ scale,
                                          const float* __restrict__ mask,
                                          float* __restrict__ tot,
                                          int64_t n_pad) {
  float& t = tot[oq * n_pad + n];
  t = acc_value<NOps>(a0, a1, rank1[oq], NOps == 1 ? scale[n] : 1.0f,
                      mask[n], t);
}

// Split: a tile's 32 Yt rows are 16 output rows' hi AND lo halves,
// interleaved so each thread holds both halves of its 4 output rows (tile
// rows i < 4 hi, i >= 4 lo), for both operands alike; unsplit: 32 output
// rows.
template <int NOps>
__global__ void __launch_bounds__(YT_THREADS)
ytg_acc_fma_kernel(const uint32_t* __restrict__ words,
                   const float* __restrict__ yt0,
                   const float* __restrict__ yt1,
                   const float* __restrict__ rank1,
                   const float* __restrict__ scale,
                   const float* __restrict__ mask, float* __restrict__ tot,
                   int64_t m_pad, int64_t nw, int q, int split) {
  __shared__ __align__(16) YtgSmem<NOps> s;
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
  float acc[NOps][YT_RPT][YT_PPT];
  ytg_fma_mainloop<false>(words, yt0, yt1, m_pad, nw, kb, s, acc);

  const int qg = threadIdx.x >> 6;
  const int64_t n_pad = nw * kPlanes, col0 = ytg_col0(kb);
  if (split) {
#pragma unroll
    for (int i = 0; i < YT_RPT / 2; ++i) {
      const int oq = q0 + qg * (YT_RPT / 2) + i;
      if (oq >= q) continue;
#pragma unroll
      for (int pp = 0; pp < YT_PPT; ++pp)
        acc_store<NOps>(
            __fadd_rn(acc[0][i][pp], acc[0][i + YT_RPT / 2][pp]),
            __fadd_rn(acc[NOps - 1][i][pp],
                      acc[NOps - 1][i + YT_RPT / 2][pp]),
            oq, col0 + pp * kTileWords, rank1, scale, mask, tot, n_pad);
    }
  } else {
#pragma unroll
    for (int i = 0; i < YT_RPT; ++i) {
      const int oq = q0 + qg * YT_RPT + i;
      if (oq >= q) continue;
#pragma unroll
      for (int pp = 0; pp < YT_PPT; ++pp)
        acc_store<NOps>(acc[0][i][pp], acc[NOps - 1][i][pp], oq,
                        col0 + pp * kTileWords, rank1, scale, mask, tot,
                        n_pad);
    }
  }
}

template <class Tile, typename T>
int gp_launch(const uint32_t* w, const void* c, float* part, float* out,
              const GpShape& sh, int splits, cudaStream_t st) {
  const int smem = GP_STAGES * gp_stage_bytes<T>(sh.wp);
  const cudaError_t e = cudaFuncSetAttribute(
      gp_kernel<Tile, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((sh.m_pad + GP_ROWS - 1) / GP_ROWS),
                  (unsigned)((sh.wc + GP_COLS - 1) / GP_COLS),
                  (unsigned)splits);
  gp_kernel<Tile, T><<<grid, GP_THREADS, smem, st>>>(
      w, static_cast<const T*>(c), splits > 1 ? part : out, sh);
  if (splits > 1) {
    const int64_t n = sh.m_pad * sh.wc;
    gp_reduce<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(part, out,
                                                           splits, n);
  }
  return (int)cudaGetLastError();
}

// bf16 C: NT = wp / 8 n8 tiles of mma per block.
template <bool Square>
int gp_mma(const uint32_t* w, const void* c, float* part, float* out,
           const GpShape& sh, int splits, cudaStream_t st) {
  using T = __nv_bfloat16;
  switch (sh.wp / 8) {
    case 2: return gp_launch<GpMmaTile<Square, 2>, T>(w, c, part, out, sh,
                                                      splits, st);
    case 4: return gp_launch<GpMmaTile<Square, 4>, T>(w, c, part, out, sh,
                                                      splits, st);
    case 6: return gp_launch<GpMmaTile<Square, 6>, T>(w, c, part, out, sh,
                                                      splits, st);
    default: return gp_launch<GpMmaTile<Square, 8>, T>(w, c, part, out, sh,
                                                       splits, st);
  }
}

// bf16 Yt: one launch of ytg_kernel, 64 Yt rows x YTG_MT*YTG_NT words a
// block.
template <bool Square>
int ytg_mma_launch(const uint32_t* w, const void* yt, float* out,
                   int64_t m_pad, int64_t nw, int qr, cudaStream_t st) {
  constexpr int smem = YM_STAGES * ym_stage_bytes<1>();
  auto* kern = ytg_kernel<Square, YTG_MT, YTG_NT>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((qr + YM_ROWS - 1) / YM_ROWS),
                  (unsigned)(nw / (YTG_MT * YTG_NT)));
  kern<<<grid, YM_THREADS, smem, st>>>(
      w, static_cast<const __nv_bfloat16*>(yt), out, m_pad, nw, qr);
  return (int)cudaGetLastError();
}

// bf16 Yt: one launch of ytg_acc_kernel<NOps>, 32 (split) or 64 output
// rows x MT*NT words a block.
template <int NOps>
int acc_mma_launch(const void* words, const void* yt0, const void* yt1,
                   const void* rank1, const void* scale, const void* mask,
                   void* tot, int64_t m_pad, int64_t nw, int q, int split,
                   cudaStream_t st) {
  constexpr int MT = NOps == 1 ? ACC_MT : ACC2_MT;
  constexpr int NT = NOps == 1 ? ACC_NT : ACC2_NT;
  constexpr int smem = YM_STAGES * ym_stage_bytes<NOps>();
  auto* kern = ytg_acc_kernel<NOps, MT, NT>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int rows = split ? YM_ROWS / 2 : YM_ROWS;
  const dim3 grid((unsigned)((q + rows - 1) / rows),
                  (unsigned)(nw / (MT * NT)));
  kern<<<grid, YM_THREADS, smem, st>>>(
      static_cast<const uint32_t*>(words),
      static_cast<const __nv_bfloat16*>(yt0),
      static_cast<const __nv_bfloat16*>(yt1),
      static_cast<const float*>(rank1), static_cast<const float*>(scale),
      static_cast<const float*>(mask), static_cast<float*>(tot), m_pad, nw,
      q, split);
  return (int)cudaGetLastError();
}

// f32 Yt: the CUDA-core FMA kernels.
int ytg_fma_launch(const uint32_t* w, const void* yt, int square, float* out,
                   int64_t m_pad, int64_t nw, int qr, cudaStream_t st) {
  const dim3 grid((unsigned)(nw / YT_WORDS),
                  (unsigned)((qr + YT_ROWS - 1) / YT_ROWS));
  const float* y = static_cast<const float*>(yt);
  if (square)
    ytg_fma_kernel<true><<<grid, YT_THREADS, 0, st>>>(w, y, out, m_pad, nw,
                                                      qr);
  else
    ytg_fma_kernel<false><<<grid, YT_THREADS, 0, st>>>(w, y, out, m_pad, nw,
                                                       qr);
  return (int)cudaGetLastError();
}

template <int NOps>
int acc_fma_launch(const void* words, const void* yt0, const void* yt1,
                   const void* rank1, const void* scale, const void* mask,
                   void* tot, int64_t m_pad, int64_t nw, int q, int split,
                   cudaStream_t st) {
  const int rows = split ? YT_ROWS / 2 : YT_ROWS;
  const dim3 grid((unsigned)(nw / YT_WORDS), (unsigned)((q + rows - 1) / rows));
  ytg_acc_fma_kernel<NOps><<<grid, YT_THREADS, 0, st>>>(
      static_cast<const uint32_t*>(words), static_cast<const float*>(yt0),
      static_cast<const float*>(yt1), static_cast<const float*>(rank1),
      static_cast<const float*>(scale), static_cast<const float*>(mask),
      static_cast<float*>(tot), m_pad, nw, q, split);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ sample_contract
// The length-N contractions of one jackknife sample's normal equations
// (core/normal_eq.assemble_Tq_core), in one pass over the sample's stats.
// Replaces no TPU kernel: the JAX package runs them as XLA multiply+reduce
// (pyrhe_tpu/core/normal_eq.py _gram x3, project_cov, _dotvec x2, after
// the leave-one-out subtraction and NxE concatenation of
// assemble_Tq_chunk). The sample's stats X (E, b2, N), N contiguous, are
// read where they lie: rows e < e_geno are tot[e] - drop[e] (tot[e] when
// there is no drop; the difference rounded in T, as torch's tot - drop),
// rows e_geno .. E-1 the NxE rows. With B probe columns (b2 = B, or 2B with
// ncov > 0 covariates), C^T (ncov, N), Z^T and Uzb^T (B, N), it writes in
// float64, into out = [G1 | P | R | zd | ud]:
//   G1[e, f]   = sum_{b<B} sum_n X[e,b,n] X[f,b,n]         (E, E)
//   P[e, k, b] = sum_n C[n,k] X[e,b,n]                     (E, ncov, B)
//   R[e, k, b] = sum_n C[n,k] X[e,B+b,n]                   (E, ncov, B)
//   zd[e]      = sum_b sum_n X[e,b,n] Z[n,b]               (E,)
//   ud[e]      = sum_b sum_n X[e,b,n] Uzb[n,b]             (E,), ncov > 0
//
// Bound: bytes. The stats are read once (tot and drop: 418 MB a GENIE
// sample at E = 26, b2 = 20, N = 100,352 f32; 642 MB at RHE k = 50), at
// about one FMA a byte, far below the card's ~20 f32 FMAs a byte.
//
// Design: block (x, y, z) takes the SC_CHUNK individuals of chunk x at
// probe column b = y, for tile group z. Per stage of `ncs` individuals it
// stages in shared memory the rows it needs at that b: X[:, b] (E rows,
// padded to 4), X[:, B + b] (with covariates) and [C^T | z_b | u_b], loaded
// 16 bytes a thread along N, coalesced, tot - drop formed on the way. The
// outputs are 4 x 4 tiles of (left row, right row) pairs: X x X (the upper
// triangle of tiles: G1 is symmetric), X x [C | z | u] and
// X_U x [C | z | u] (whose X_U x z / u entries nobody reads). A tile is
// computed by `lanes` threads, each over its own quads of 4 individuals
// (64 FMAs per 8 16-byte shared loads; a 4-element pad per row keeps the
// rows on distinct banks), TPT tiles a thread; more than 32 * TPT tiles
// take more tile groups, each reading the stats again. Products and sums
// are in T, but a lane's run is at most SC_CHUNK / 8 = 256 terms: the block
// then sums its lanes' partials in float64 in lane order into part[b, x].
// sample_contract_merge sums part over the chunks (and over b for G1, zd
// and ud) in float64, one warp an output: strided lanes in a fixed order,
// then a fixed butterfly. No atomics: every launch is deterministic, and
// the result depends on the shapes alone.
constexpr int SC_THREADS = 256;
constexpr int SC_CHUNK = 2048;    // individuals a block
constexpr int SC_PAD = 4;         // elements after each staged row
constexpr int SC_STAGE_BYTES = 48 << 10;   // staged rows aim at no more
constexpr int SC_SMEM_MAX = 232448;        // a block's most (227 KB)

struct ScShape {
  int64_t n;             // individuals
  int e, e_geno;         // rows of X; rows from tot (the rest NxE)
  int b, b2, ncov;       // probe columns, stats columns, covariates
  int na, nk;            // 4-row tiles of X rows, of [C | z | u] rows
  int ntiles, tg, tpt;   // tiles in all, tiles a group, tiles a thread
  int nchunks, ncs;      // blocks along N, individuals a stage
  int smem;              // a block's dynamic shared memory, bytes
  int vec;               // 1: 16-byte loads (N % 4 == 0, aligned bases)
};

// The partition of a launch, from the shapes alone: 4-row tiles of the E
// stats rows (na) and of the [C^T | z | u] rows (nk); the tiles (the upper
// triangle of X x X, X x [C | z | u] and, with covariates,
// X_U x [C | z | u]); tiles a thread (tpt: 2 in f32 past 32 tiles, else
// 1); tiles a group (tg: more tiles take more groups); blocks along N;
// individuals a stage (ncs: the most of 512, 256, ..., 16 whose staged
// rows and their source table fit SC_STAGE_BYTES, else 16); and smem, the
// staged rows with their source table or the lanes' partials, whichever
// is larger.
ScShape sc_plan(int64_t n, int e, int e_geno, int b, int b2, int ncov,
                bool f64) {
  ScShape sh{};
  sh.n = n;
  sh.e = e;
  sh.e_geno = e_geno;
  sh.b = b;
  sh.b2 = b2;
  sh.ncov = ncov;
  const int item = f64 ? 8 : 4;
  sh.na = (e + 3) / 4;
  sh.nk = (ncov + 1 + (ncov > 0 ? 1 : 0) + 3) / 4;
  sh.ntiles = sh.na * (sh.na + 1) / 2 + sh.na * sh.nk * (ncov > 0 ? 2 : 1);
  sh.tpt = !f64 && sh.ntiles > 32 ? 2 : 1;
  sh.tg = sh.ntiles < 32 * sh.tpt ? sh.ntiles : 32 * sh.tpt;
  sh.nchunks = (int)((n + SC_CHUNK - 1) / SC_CHUNK);
  const int rows = 4 * sh.na * (ncov > 0 ? 2 : 1) + 4 * sh.nk;
  auto staged = [&](int ncs) {   // a row: its elements and two pointers
    return rows * ((ncs + SC_PAD) * item + 2 * (int)sizeof(void*));
  };
  sh.ncs = 512;
  while (sh.ncs > 16 && staged(sh.ncs) > SC_STAGE_BYTES) sh.ncs /= 2;
  const int partials = SC_THREADS * sh.tpt * 16 * item;
  sh.smem = staged(sh.ncs) > partials ? staged(sh.ncs) : partials;
  return sh;
}

__device__ __forceinline__ float sc_sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sc_sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float sc_fma(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double sc_fma(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// 4 consecutive elements from 16-byte-aligned global memory (read-only
// path) or shared memory.
__device__ __forceinline__ void sc_ldg(const float* p, float (&v)[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void sc_ldg(const double* p, double (&v)[4]) {
  const double2 x = __ldg(reinterpret_cast<const double2*>(p));
  const double2 y = __ldg(reinterpret_cast<const double2*>(p) + 1);
  v[0] = x.x; v[1] = x.y; v[2] = y.x; v[3] = y.y;
}
__device__ __forceinline__ void sc_lds(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void sc_lds(const double* p, double (&v)[4]) {
  const double2 x = *reinterpret_cast<const double2*>(p);
  const double2 y = *(reinterpret_cast<const double2*>(p) + 1);
  v[0] = x.x; v[1] = x.y; v[2] = y.x; v[3] = y.y;
}
__device__ __forceinline__ void sc_sts(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void sc_sts(double* p, const double (&v)[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

// Individuals m .. m+3 of row a (less row d when given); zero past n.
template <typename T>
__device__ __forceinline__ void sc_load(const T* __restrict__ a,
                                        const T* __restrict__ d, int64_t m,
                                        int64_t n, bool vec, T (&v)[4]) {
  if (vec && m + 4 <= n) {
    sc_ldg(a + m, v);
    if (d) {
      T w[4];
      sc_ldg(d + m, w);
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = sc_sub(v[k], w[k]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = m + k >= n ? T(0) : d ? sc_sub(a[m + k], d[m + k]) : a[m + k];
  }
}

// Staged rows (left, right) of tile t: the upper triangle of X x X tiles
// row by row, then X x [C | z | u], then X_U x [C | z | u].
__device__ __forceinline__ void sc_tile_rows(int t, const ScShape& sh,
                                             int ea, int ko, int& l,
                                             int& r) {
  const int naa = sh.na * (sh.na + 1) / 2;
  if (t < naa) {
    int i = 0;
    while (t >= sh.na - i) {
      t -= sh.na - i;
      ++i;
    }
    l = 4 * i;
    r = 4 * (i + t);
    return;
  }
  t -= naa;
  const int seg = t / (sh.na * sh.nk);
  t -= seg * sh.na * sh.nk;
  l = seg * ea + 4 * (t / sh.nk);
  r = ko + 4 * (t % sh.nk);
}

template <typename T, int TPT>
__global__ void __launch_bounds__(SC_THREADS, 2)
sample_contract_kernel(const T* __restrict__ tot, const T* __restrict__ drop,
                       const T* __restrict__ nxe, const T* __restrict__ ct,
                       const T* __restrict__ zt, const T* __restrict__ ut,
                       double* __restrict__ part, ScShape sh) {
  extern __shared__ __align__(16) unsigned char sc_smem[];
  const bool cov = sh.ncov > 0;
  const int ea = 4 * sh.na, ko = cov ? 2 * ea : ea, rows = ko + 4 * sh.nk;
  const int pitch = sh.ncs + SC_PAD;
  T* stage = reinterpret_cast<T*>(sc_smem);
  const T** src = reinterpret_cast<const T**>(
      sc_smem + (size_t)rows * pitch * sizeof(T));
  const int chunk = blockIdx.x, b = blockIdx.y;
  const int64_t n0 = (int64_t)chunk * SC_CHUNK;
  const int len = (int)min((int64_t)SC_CHUNK, sh.n - n0);

  // Each staged row's source at this b and its subtrahend; pad rows have
  // none and stay zero.
  for (int r = threadIdx.x; r < rows; r += SC_THREADS) {
    const T* a = nullptr;
    const T* d = nullptr;
    if (r < ko) {
      const int e = r < ea ? r : r - ea;
      const int col = r < ea ? b : sh.b + b;
      if (e < sh.e_geno) {
        const int64_t off = ((int64_t)e * sh.b2 + col) * sh.n;
        a = tot + off;
        d = drop ? drop + off : nullptr;
      } else if (e < sh.e) {
        a = nxe + ((int64_t)(e - sh.e_geno) * sh.b2 + col) * sh.n;
      }
    } else {
      const int k = r - ko;
      if (k < sh.ncov) a = ct + (int64_t)k * sh.n;
      else if (k == sh.ncov) a = zt + (int64_t)b * sh.n;
      else if (k == sh.ncov + 1 && cov) a = ut + (int64_t)b * sh.n;
    }
    src[2 * r] = a;
    src[2 * r + 1] = d;
  }
  for (int i = threadIdx.x; i < rows * pitch; i += SC_THREADS)
    stage[i] = T(0);

  // This thread's tiles: tiles slot + s * nslots of the group, lane `lane`
  // of each.
  const int nslots = (sh.tg + TPT - 1) / TPT;
  const int lanes = nslots <= 8 ? 32 : nslots <= 16 ? 16 : 8;
  const int slot = threadIdx.x / lanes, lane = threadIdx.x % lanes;
  const int t0 = blockIdx.z * sh.tg;
  const int ntg = min(sh.tg, sh.ntiles - t0);
  int lrow[TPT], rrow[TPT];
  bool live[TPT];
  T acc[TPT][16];
#pragma unroll
  for (int s = 0; s < TPT; ++s) {
    const int tl = slot + s * nslots;
    live[s] = slot < nslots && tl < ntg;
    lrow[s] = rrow[s] = 0;
    if (live[s]) sc_tile_rows(t0 + tl, sh, ea, ko, lrow[s], rrow[s]);
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[s][i] = T(0);
  }

  const int qps = sh.ncs / 4;          // quads (4 individuals) a staged row
  const int items = rows * qps;
  for (int s0 = 0; s0 < len; s0 += sh.ncs) {
    __syncthreads();   // the sources and zeros, or the last stage's reads
    const int64_t nb = n0 + s0;
    // staged quads a thread keeps in flight: 8 in f32, 4 in f64 (8 spill)
    constexpr int kUnroll = sizeof(T) == 4 ? 8 : 4;
    for (int i0 = threadIdx.x; i0 < items; i0 += kUnroll * SC_THREADS) {
      T v[kUnroll][4];
      int dst[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * SC_THREADS;
        const int r = i / qps, q = i - r * qps;
        const T* a = i < items ? src[2 * r] : nullptr;
        dst[u] = a ? r * pitch + 4 * q : -1;
        if (a) sc_load(a, src[2 * r + 1], nb + 4 * q, sh.n, sh.vec != 0,
                       v[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (dst[u] >= 0) sc_sts(stage + dst[u], v[u]);
    }
    __syncthreads();
    const int nq = (min(sh.ncs, len - s0) + 3) / 4;
#pragma unroll
    for (int s = 0; s < TPT; ++s) {
      if (!live[s]) continue;
      const T* L = stage + lrow[s] * pitch;
      const T* R = stage + rrow[s] * pitch;
      for (int q = lane; q < nq; q += lanes) {
        T a[4][4], c[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sc_lds(L + i * pitch + 4 * q, a[i]);
          sc_lds(R + i * pitch + 4 * q, c[i]);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[s][i * 4 + j] = sc_fma(a[i][k], c[j][k], acc[s][i * 4 + j]);
      }
    }
  }

  // The lanes' partials of each tile entry, summed in float64 in lane
  // order: red[(tile * 16 + entry) * lanes + lane] over the staged rows.
  __syncthreads();
  T* red = stage;
#pragma unroll
  for (int s = 0; s < TPT; ++s) {
    if (!live[s]) continue;
    const int tl = slot + s * nslots;
#pragma unroll
    for (int i = 0; i < 16; ++i) red[(tl * 16 + i) * lanes + lane] = acc[s][i];
  }
  __syncthreads();
  double* out = part + ((int64_t)b * sh.nchunks + chunk) * sh.ntiles * 16
                + (int64_t)t0 * 16;
  for (int o = threadIdx.x; o < ntg * 16; o += SC_THREADS) {
    double sum = 0.0;
    for (int l = 0; l < lanes; ++l) sum += (double)red[o * lanes + l];
    out[o] = sum;
  }
}

// out[w] for every output w of [G1 | P | R | zd | ud], one warp each: the
// sum of part's (tile, entry) over its range of (b, chunk) blocks, lane l
// taking blocks l, l + 32, ... in order, then a fixed butterfly. G1[e, f]
// and G1[f, e] read the same tile entry (e <= f) and sum it alike.
__global__ void __launch_bounds__(256)
sample_contract_merge(const double* __restrict__ part,
                      double* __restrict__ out, ScShape sh) {
  const int64_t w = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int E = sh.e, B = sh.b, nc = sh.ncov;
  const int64_t n_g1 = (int64_t)E * E, n_p = (int64_t)E * nc * B;
  if (w >= n_g1 + 2 * n_p + (nc > 0 ? 2 : 1) * E) return;   // whole warps
  const int naa = sh.na * (sh.na + 1) / 2;
  int tile, ij;
  int64_t blk0 = 0, nblk = (int64_t)B * sh.nchunks;
  if (w < n_g1) {
    int e = (int)(w / E), f = (int)(w % E);
    if (e > f) {
      const int t = e;
      e = f;
      f = t;
    }
    const int i = e / 4, j = f / 4;
    tile = i * sh.na - i * (i - 1) / 2 + (j - i);
    ij = (e % 4) * 4 + f % 4;
  } else if (w < n_g1 + 2 * n_p) {
    int64_t t = w - n_g1;
    const int seg = t >= n_p;
    t -= seg * n_p;
    const int b = (int)(t % B), k = (int)((t / B) % nc);
    const int e = (int)(t / ((int64_t)B * nc));
    tile = naa + seg * sh.na * sh.nk + (e / 4) * sh.nk + k / 4;
    ij = (e % 4) * 4 + k % 4;
    blk0 = (int64_t)b * sh.nchunks;
    nblk = sh.nchunks;
  } else {
    const int64_t t = w - n_g1 - 2 * n_p;
    const int k = nc + (int)(t / E), e = (int)(t % E);
    tile = naa + (e / 4) * sh.nk + k / 4;
    ij = (e % 4) * 4 + k % 4;
  }
  const int64_t stride = (int64_t)sh.ntiles * 16;
  const double* p = part + blk0 * stride + tile * 16 + ij;
  double s = 0.0;
  for (int64_t t = lane; t < nblk; t += 32) s += p[t * stride];
#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) out[w] = s;
}

template <typename T, int TPT>
int sc_launch(const void* tot, const void* drop, const void* nxe,
              const void* ct, const void* zt, const void* ut, double* part,
              double* out, const ScShape& sh, cudaStream_t st) {
  auto* kern = sample_contract_kernel<T, TPT>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, sh.smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)sh.nchunks, (unsigned)sh.b,
                  (unsigned)((sh.ntiles + sh.tg - 1) / sh.tg));
  kern<<<grid, SC_THREADS, sh.smem, st>>>(
      static_cast<const T*>(tot), static_cast<const T*>(drop),
      static_cast<const T*>(nxe), static_cast<const T*>(ct),
      static_cast<const T*>(zt), static_cast<const T*>(ut), part, sh);
  const cudaError_t e2 = cudaGetLastError();
  if (e2 != cudaSuccess) return (int)e2;
  const int64_t outs = (int64_t)sh.e * sh.e
                       + 2 * (int64_t)sh.e * sh.ncov * sh.b
                       + (sh.ncov > 0 ? 2 : 1) * (int64_t)sh.e;
  sample_contract_merge<<<(unsigned)((outs * 32 + 255) / 256), 256, 0, st>>>(
      part, out, sh);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shapes are checked by the Python wrappers: m_pad % 32 == 0,
// nw % 128 == 0, all tensors contiguous on the current device.
// part: (splits, m_pad, wc) f32 workspace, unused when splits == 1.
int rhe_gp(const void* words, const void* c, int c_bf16, int square,
           void* part, void* out, int64_t m_pad, int64_t nw, int wc,
           int per_split, int splits, void* stream) {
  const int wp = (wc + 15) / 16 * 16;
  GpShape sh{m_pad, nw, wc, per_split, wp < GP_COLS ? wp : GP_COLS, 16};
  const uintptr_t align = reinterpret_cast<uintptr_t>(c)
                          | (uintptr_t)wc * (c_bf16 ? 2 : 4);
  while (sh.gran > 2 && align % sh.gran) sh.gran >>= 1;
  const auto* w = static_cast<const uint32_t*>(words);
  auto* p = static_cast<float*>(part);
  auto* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c_bf16)
    return square ? gp_mma<true>(w, c, p, o, sh, splits, st)
                  : gp_mma<false>(w, c, p, o, sh, splits, st);
  return square ? gp_launch<GpFmaTile<true>, float>(w, c, p, o, sh, splits, st)
                : gp_launch<GpFmaTile<false>, float>(w, c, p, o, sh, splits,
                                                     st);
}

int rhe_ytg(const void* words, const void* yt, int yt_bf16, int square,
            void* out, int64_t m_pad, int64_t nw, int qr, void* stream) {
  const auto* w = static_cast<const uint32_t*>(words);
  auto* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (yt_bf16)
    return square ? ytg_mma_launch<true>(w, yt, o, m_pad, nw, qr, st)
                  : ytg_mma_launch<false>(w, yt, o, m_pad, nw, qr, st);
  return ytg_fma_launch(w, yt, square, o, m_pad, nw, qr, st);
}

int rhe_ytg_acc(const void* words, const void* yt, int yt_bf16,
                const void* rank1, const void* scale, const void* mask,
                void* tot, int64_t m_pad, int64_t nw, int q, int split,
                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return yt_bf16
      ? acc_mma_launch<1>(words, yt, yt, rank1, scale, mask, tot, m_pad, nw,
                          q, split, st)
      : acc_fma_launch<1>(words, yt, yt, rank1, scale, mask, tot, m_pad, nw,
                          q, split, st);
}

int rhe_ytg_acc2(const void* words, const void* yt1, const void* yt2,
                 int yt_bf16, const void* rank1, const void* mask, void* tot,
                 int64_t m_pad, int64_t nw, int q, int split, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return yt_bf16
      ? acc_mma_launch<2>(words, yt1, yt2, rank1, nullptr, mask, tot, m_pad,
                          nw, q, split, st)
      : acc_fma_launch<2>(words, yt1, yt2, rank1, nullptr, mask, tot, m_pad,
                          nw, q, split, st);
}

// sample_contract's partition at these shapes (sc_plan) into plan =
// [na, nk, ntiles, tpt, tg, nchunks, ncs, smem]; the wrapper sizes its
// workspace from it. Returns 0, or cudaErrorInvalidValue when a block
// would need more than SC_SMEM_MAX bytes of shared memory.
int rhe_sample_contract_plan(int64_t n, int e, int ncov, int f64,
                             int* plan) {
  const ScShape sh = sc_plan(n, e, e, 1, 1, ncov, f64 != 0);
  const int v[8] = {sh.na, sh.nk, sh.ntiles, sh.tpt, sh.tg, sh.nchunks,
                    sh.ncs, sh.smem};
  for (int i = 0; i < 8; ++i) plan[i] = v[i];
  return sh.smem > SC_SMEM_MAX ? (int)cudaErrorInvalidValue : 0;
}

// The pass-2 contractions of one jackknife sample (sample_contract_kernel):
// tot (e_geno, b2, n), drop (the same, or null), nxe (e - e_geno, b2, n or
// null), ct (ncov, n, or null), zt and ut (b, n; ut null without
// covariates), all T = f64 ? double : float; part the f64 workspace of
// rhe_sample_contract_plan's b * nchunks rows of ntiles * 16, out the f64
// [G1 | P | R | zd | ud].
int rhe_sample_contract(const void* tot, const void* drop, const void* nxe,
                        const void* ct, const void* zt, const void* ut,
                        int f64, void* part, void* out, int64_t n, int e,
                        int e_geno, int b, int b2, int ncov, void* stream) {
  ScShape sh = sc_plan(n, e, e_geno, b, b2, ncov, f64 != 0);
  if (sh.smem > SC_SMEM_MAX) return (int)cudaErrorInvalidValue;
  sh.vec = n % 4 == 0;
  const void* ops[6] = {tot, drop, nxe, ct, zt, ut};
  for (const void* p : ops)
    if (reinterpret_cast<uintptr_t>(p) % 16) sh.vec = 0;
  auto* pt = static_cast<double*>(part);
  auto* o = static_cast<double*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f64)
    return sc_launch<double, 1>(tot, drop, nxe, ct, zt, ut, pt, o, sh, st);
  return sh.tpt == 2
      ? sc_launch<float, 2>(tot, drop, nxe, ct, zt, ut, pt, o, sh, st)
      : sc_launch<float, 1>(tot, drop, nxe, ct, zt, ut, pt, o, sh, st);
}

}  // extern "C"
