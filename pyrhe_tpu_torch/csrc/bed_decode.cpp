// Native PLINK .bed 2-bit decoder.
//
// Replaces the reference's `bed_reader` pip dependency (Rust-backed; see
// reference pyrhe/src/base/base.py:10,100). PLINK .bed stores genotypes
// SNP-major, 4 samples per byte, 2 bits each (low bits = first sample):
//   0b00 = homozygous A1, 0b01 = missing, 0b10 = het, 0b11 = homozygous A2.
//
// We decode directly to the reference's *post-flip* dosage convention
// (base.py:347-355 flips bed_reader's A1 counts 0<->2), i.e. the A2-allele
// count: code00 -> 0, code10 -> 1, code11 -> 2, code01 -> 255 (missing).
//
// Build: g++ -O3 -shared -fPIC -o libbeddecode.so bed_decode.cpp
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// 256-entry LUT: each byte expands to 4 dosage bytes packed in a uint32.
struct Lut {
  uint32_t t[256];
  Lut() {
    static const uint8_t code2dose[4] = {0, 255, 1, 2};
    for (int b = 0; b < 256; ++b) {
      uint32_t v = 0;
      for (int i = 0; i < 4; ++i) {
        uint8_t code = (b >> (2 * i)) & 3;
        v |= static_cast<uint32_t>(code2dose[code]) << (8 * i);
      }
      t[b] = v;
    }
  }
};
const Lut kLut;

inline void decode_row(const uint8_t* src, int64_t n_orig, uint8_t* dst) {
  // Decode one SNP's packed bytes to n_orig dosage bytes.
  int64_t nb = n_orig / 4;
  for (int64_t b = 0; b < nb; ++b) {
    uint32_t v = kLut.t[src[b]];
    std::memcpy(dst + 4 * b, &v, 4);
  }
  int64_t rem = n_orig - 4 * nb;
  if (rem > 0) {
    uint32_t v = kLut.t[src[nb]];
    std::memcpy(dst + 4 * nb, &v, static_cast<size_t>(rem));
  }
}

}  // namespace

extern "C" {

// Decode m SNPs (rows) of packed data into an (m, n_keep) uint8 dosage
// matrix (255 = missing). keep_idx: sorted indices of individuals to keep,
// or nullptr to keep all n_orig. Multithreaded over SNPs.
void bed_decode_block(const uint8_t* packed, int64_t m, int64_t n_orig,
                      const int64_t* keep_idx, int64_t n_keep, uint8_t* out,
                      int n_threads) {
  const int64_t bytes_per_snp = (n_orig + 3) / 4;
  const int64_t n_out = keep_idx ? n_keep : n_orig;
  if (n_threads < 1) n_threads = 1;
  auto work = [&](int64_t lo, int64_t hi) {
    std::vector<uint8_t> tmp;
    if (keep_idx) tmp.resize(static_cast<size_t>(n_orig));
    for (int64_t s = lo; s < hi; ++s) {
      const uint8_t* src = packed + s * bytes_per_snp;
      uint8_t* dst = out + s * n_out;
      if (!keep_idx) {
        decode_row(src, n_orig, dst);
      } else {
        decode_row(src, n_orig, tmp.data());
        for (int64_t i = 0; i < n_keep; ++i) dst[i] = tmp[keep_idx[i]];
      }
    }
  };
  if (n_threads == 1 || m < 8) {
    work(0, m);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (m + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < m ? lo + chunk : m;
    if (lo >= hi) break;
    ts.emplace_back(work, lo, hi);
  }
  for (auto& th : ts) th.join();
}

// Per-SNP observed-dosage sums and missing counts over an (m, n) decoded
// dosage matrix (255 = missing). Used to derive imputation fill values.
void bed_col_stats(const uint8_t* dosage, int64_t m, int64_t n, double* sums,
                   int64_t* nmiss) {
  for (int64_t s = 0; s < m; ++s) {
    const uint8_t* row = dosage + s * n;
    int64_t sum = 0, miss = 0;
    for (int64_t i = 0; i < n; ++i) {
      uint8_t v = row[i];
      if (v == 255) {
        ++miss;
      } else {
        sum += v;
      }
    }
    sums[s] = static_cast<double>(sum);
    nmiss[s] = miss;
  }
}

// Per-SNP observed-dosage sums and missing counts straight from PACKED
// bytes (no decode): 256-entry tables give each byte's dosage sum and
// missing count across its 4 samples. n_orig is the true individual count
// (trailing pad bits in the last byte are code 0 = dosage 0, so they only
// need excluding from the missing count, which they never hit).
// Multithreaded over SNP rows (each row is independent).
void bed_packed_col_stats(const uint8_t* packed, int64_t m, int64_t n_orig,
                          double* sums, int64_t* nmiss, int n_threads) {
  // C++11 magic static (thread-safe once-init, like kLut): callers arrive
  // concurrently from the staging thread pools, and a bare
  // fill-then-set-flag pattern would race on first use.
  struct StatsLut {
    int16_t sum_t[256];
    int8_t miss_t[256];
    StatsLut() {
      static const int8_t code2dose[4] = {0, 0, 1, 2};
      static const int8_t code2miss[4] = {0, 1, 0, 0};
      for (int b = 0; b < 256; ++b) {
        int s = 0, mi = 0;
        for (int i = 0; i < 4; ++i) {
          int code = (b >> (2 * i)) & 3;
          s += code2dose[code];
          mi += code2miss[code];
        }
        sum_t[b] = static_cast<int16_t>(s);
        miss_t[b] = static_cast<int8_t>(mi);
      }
    }
  };
  static const StatsLut lut;
  const int16_t* sum_t = lut.sum_t;
  const int8_t* miss_t = lut.miss_t;
  const int64_t bytes_per_snp = (n_orig + 3) / 4;
  auto work = [&](int64_t s0, int64_t s1) {
    for (int64_t s = s0; s < s1; ++s) {
      const uint8_t* row = packed + s * bytes_per_snp;
      int64_t sum = 0, miss = 0;
      for (int64_t b = 0; b < bytes_per_snp; ++b) {
        sum += sum_t[row[b]];
        miss += miss_t[row[b]];
      }
      sums[s] = static_cast<double>(sum);
      nmiss[s] = miss;
    }
  };
  if (n_threads < 1) n_threads = 1;
  if (n_threads == 1 || m < 8) {
    work(0, m);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (m + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t s0 = t * chunk;
    int64_t s1 = s0 + chunk < m ? s0 + chunk : m;
    if (s0 >= s1) break;
    ts.emplace_back(work, s0, s1);
  }
  for (auto& th : ts) th.join();
}

// Rewrite missing codes (0b01) in packed .bed bytes with a per-SNP fill
// code, writing rows into a (possibly wider, zero-padded) output buffer.
// fill_code[s] must be one of 0b00/0b10/0b11 (dosage 0/1/2) — imputation
// fills are always integral (HWE draw or mean-mode 0), so the device
// kernels can decode with NO missing-branch at all (see ops/kernels.py).
// out_stride >= bytes_per_snp; trailing bytes of each row are zeroed.
void bed_clean_packed(const uint8_t* packed, int64_t m, int64_t bytes_per_snp,
                      const uint8_t* fill_code, uint8_t* out,
                      int64_t out_stride, int n_threads) {
  // clean_t[f][b]: byte b with every 0b01 code replaced by fill code f
  // (f indexed 0..3; 0b01 unused). Magic static — see bed_packed_col_stats.
  struct CleanLut {
    uint8_t t[4][256];
    CleanLut() {
      for (int f = 0; f < 4; ++f) {
        for (int b = 0; b < 256; ++b) {
          uint8_t v = 0;
          for (int i = 0; i < 4; ++i) {
            uint8_t code = (b >> (2 * i)) & 3;
            if (code == 1) code = static_cast<uint8_t>(f);
            v |= static_cast<uint8_t>(code << (2 * i));
          }
          t[f][b] = v;
        }
      }
    }
  };
  static const CleanLut lut;
  const auto& clean_t = lut.t;
  if (n_threads < 1) n_threads = 1;
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t s = lo; s < hi; ++s) {
      const uint8_t* src = packed + s * bytes_per_snp;
      uint8_t* dst = out + s * out_stride;
      const uint8_t* lut = clean_t[fill_code[s] & 3];
      for (int64_t b = 0; b < bytes_per_snp; ++b) dst[b] = lut[src[b]];
      if (out_stride > bytes_per_snp)
        std::memset(dst + bytes_per_snp, 0,
                    static_cast<size_t>(out_stride - bytes_per_snp));
    }
  };
  if (n_threads == 1 || m < 8) {
    work(0, m);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (m + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < m ? lo + chunk : m;
    if (lo >= hi) break;
    ts.emplace_back(work, lo, hi);
  }
  for (auto& th : ts) th.join();
}

// Synthesize m SNP rows of HWE genotypes directly into PACKED .bed bytes,
// optionally accumulating a phenotype contribution — the generator never
// materializes the (m, n) dosage matrix, so it runs at register speed
// instead of host-RAM bandwidth (biobank-scale synthesis for benchmarks;
// the analog of the reference's simulate_pheno.py:17-59 generative model).
//
// Per SNP j (global index snp0+j seeds an independent xorshift128+ stream,
// so any block range reproduces the same data): each individual draws 16
// bits u_g and 16 bits u_m; dosage = 2 if u_g < t2[j], else 1 if
// u_g < t12[j], else 0 (t2 = p^2, t12 = p^2 + 2p(1-p), 16-bit fixed
// point); the entry is missing if u_m < miss_thr. When w != nullptr,
// y[i] += w[j] * dosage is accumulated from the TRUE (pre-missing)
// genotypes into per-thread buffers reduced at the end.
void bed_synth_block(uint64_t seed, int64_t snp0, int64_t m, int64_t n,
                     const uint16_t* t2, const uint16_t* t12,
                     uint16_t miss_thr, const float* w, uint8_t* out,
                     double* y, int n_threads) {
  const int64_t bytes_per_snp = (n + 3) / 4;
  if (n_threads < 1) n_threads = 1;
  std::vector<std::vector<double>> y_parts;
  auto work = [&](int64_t lo, int64_t hi, double* y_loc) {
    for (int64_t j = lo; j < hi; ++j) {
      // splitmix64 expansion of the per-SNP seed into xorshift128+ state
      uint64_t sm = seed + 0x9E3779B97F4A7C15ULL *
                             static_cast<uint64_t>(snp0 + j + 1);
      auto mix = [&sm]() {
        sm += 0x9E3779B97F4A7C15ULL;
        uint64_t z = sm;
        z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
        z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
        return z ^ (z >> 31);
      };
      uint64_t s0 = mix(), s1 = mix();
      auto next = [&s0, &s1]() {
        uint64_t x = s0, yv = s1;
        s0 = yv;
        x ^= x << 23;
        s1 = x ^ yv ^ (x >> 17) ^ (yv >> 26);
        return s1 + yv;
      };
      const uint16_t th2 = t2[j], th12 = t12[j];
      const float wj = w ? w[j] : 0.0f;
      uint8_t* dst = out + j * bytes_per_snp;
      static const uint8_t dose2code[3] = {0b00, 0b10, 0b11};
      for (int64_t b = 0; b < bytes_per_snp; ++b) {
        uint8_t byte = 0;
        uint64_t r = 0;
        for (int k = 0; k < 4; ++k) {
          int64_t i = 4 * b + k;
          if (i >= n) break;                       // pad bits stay code 0
          if ((k & 1) == 0) r = next();            // 32 bits per individual
          uint16_t ug = static_cast<uint16_t>(r >> (32 * (k & 1)));
          uint16_t um = static_cast<uint16_t>(r >> (32 * (k & 1) + 16));
          uint8_t dose = (ug < th2) ? 2 : (ug < th12) ? 1 : 0;
          if (w && dose) y_loc[i] += wj * dose;
          uint8_t code = (um < miss_thr) ? 0b01 : dose2code[dose];
          byte |= static_cast<uint8_t>(code << (2 * k));
        }
        dst[b] = byte;
      }
    }
  };
  if (n_threads == 1 || m < 8) {
    work(0, m, y);
    return;
  }
  std::vector<std::thread> ts;
  y_parts.resize(static_cast<size_t>(n_threads));
  int64_t chunk = (m + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < m ? lo + chunk : m;
    if (lo >= hi) break;
    y_parts[t].assign(w ? static_cast<size_t>(n) : 0, 0.0);
    ts.emplace_back(work, lo, hi, w ? y_parts[t].data() : nullptr);
  }
  for (auto& th : ts) th.join();
  if (w && y) {
    for (auto& part : y_parts)
      for (size_t i = 0; i < part.size(); ++i) y[i] += part[i];
  }
}

// Pack an (m, n) uint8 dosage matrix (255 = missing) into PLINK .bed bytes
// using the same A2-count convention the decoder emits.
void bed_encode_block(const uint8_t* dosage, int64_t m, int64_t n,
                      uint8_t* packed) {
  static const uint8_t dose2code[3] = {0b00, 0b10, 0b11};
  const int64_t bytes_per_snp = (n + 3) / 4;
  for (int64_t s = 0; s < m; ++s) {
    const uint8_t* row = dosage + s * n;
    uint8_t* dst = packed + s * bytes_per_snp;
    std::memset(dst, 0, static_cast<size_t>(bytes_per_snp));
    for (int64_t i = 0; i < n; ++i) {
      uint8_t v = row[i];
      uint8_t code = (v == 255) ? 0b01 : dose2code[v];
      dst[i / 4] |= static_cast<uint8_t>(code << ((i % 4) * 2));
    }
  }
}

}  // extern "C"
