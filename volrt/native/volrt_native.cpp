// Native runtime components of volrt (C ABI, loaded via ctypes).
//
// The reference framework's loader is native C++ (Stefan Roettger's ddsbase,
// reference: VolumeRendering/ddsbase.cpp); this is volrt's native
// equivalent, implemented from the format description derived in
// volrt/io/pvm.py (not a copy of the reference code):
//
//   DDS container body (after the 8-byte magic): big-endian MSB-first
//   bitstream of [2 bits skip-1] [16 bits strip-1] then groups of
//   [7-bit count][3-bit width-code][count x width-bit residuals] until a
//   zero count. Width code b means b+1 bits when b >= 1 else 0 bits. Each
//   residual decodes to value - 2^bits/2; bytes reconstruct with a
//   first-order predictor for the first strip+1 bytes and a second-order
//   strip predictor afterwards (mod 256); finally the byte stream is
//   de-interleaved with period `skip` (v3e: in chunks of skip * 2^24).
//
// Also provides the ESL min/max block-grid build (the host hot loop of
// reference RaycasterBase.cpp:94-125) for large volumes.
//
// Build: g++ -O3 -shared -fPIC -o libvolrt_native.so volrt_native.cpp

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

class BitReader {
 public:
  BitReader(const uint8_t* data, int64_t n) : data_(data), nbits_(n * 8) {}

  // Read up to 24 bits MSB-first.
  inline uint32_t read(int bits) {
    uint32_t v = 0;
    for (int i = 0; i < bits; ++i) {
      v = (v << 1) | bit(pos_ + i);
    }
    pos_ += bits;
    return v;
  }

  inline void skip(int64_t bits) { pos_ += bits; }
  inline int64_t pos() const { return pos_; }
  inline int64_t nbits() const { return nbits_; }

  inline uint32_t bit(int64_t p) const {
    if (p >= nbits_) return 0;
    return (data_[p >> 3] >> (7 - (p & 7))) & 1u;
  }

  // Fast extraction of a <=8-bit value at an arbitrary bit offset.
  inline uint32_t extract(int64_t p, int bits) const {
    int64_t byte0 = p >> 3;
    int bit_in = static_cast<int>(p & 7);
    uint32_t word = 0;
    for (int i = 0; i < 2; ++i) {
      uint32_t b = (byte0 + i) * 8 < nbits_ ? data_[byte0 + i] : 0;
      word = (word << 8) | b;
    }
    int shift = 16 - bit_in - bits;
    return (word >> shift) & ((1u << bits) - 1u);
  }

 private:
  const uint8_t* data_;
  int64_t nbits_;
  int64_t pos_ = 0;
};

inline int width_code(int code) { return code >= 1 ? code + 1 : code; }

void deinterleave_chunk(const uint8_t* in, uint8_t* out, int64_t n,
                        int skip) {
  int64_t src = 0;
  for (int i = 0; i < skip; ++i) {
    for (int64_t j = i; j < n; j += skip) {
      out[j] = in[src++];
    }
  }
}

}  // namespace

extern "C" {

// Decode a DDS body (bytes after the magic). Writes up to out_cap bytes;
// sets *n_out to the true decoded size. Returns:
//   0 = ok; 1 = output buffer too small (*n_out holds required size);
//   2 = corrupt stream.
int volrt_dds_decode(const uint8_t* in, int64_t n_in, int block,
                     uint8_t* out, int64_t out_cap, int64_t* n_out) {
  BitReader br(in, n_in);
  int skip = static_cast<int>(br.read(2)) + 1;
  int64_t strip = static_cast<int64_t>(br.read(16)) + 1;

  // Pass 1: count total output bytes.
  struct Group {
    int64_t start;
    int32_t count;
    int32_t width;
  };
  std::vector<Group> groups;
  int64_t total = 0;
  while (true) {
    uint32_t cnt = br.read(7);
    if (cnt == 0) break;
    int w = width_code(static_cast<int>(br.read(3)));
    groups.push_back({br.pos(), static_cast<int32_t>(cnt), w});
    br.skip(static_cast<int64_t>(cnt) * w);
    total += cnt;
    if (br.pos() > br.nbits() + 32) return 2;
  }
  *n_out = total;
  if (total > out_cap) return 1;
  if (total == 0) return 0;

  // Pass 2+3: residual extraction + predictor reconstruction (mod 256).
  std::vector<uint8_t> flat(total);
  int64_t idx = 0;
  uint32_t act = 0;  // running predictor accumulator
  for (const Group& g : groups) {
    int64_t p = g.start;
    int bits = g.width;
    int32_t half = bits ? (1 << bits) / 2 : 0;
    for (int32_t i = 0; i < g.count; ++i, ++idx) {
      int32_t delta =
          static_cast<int32_t>(bits ? br.extract(p, bits) : 0) - half;
      p += bits;
      if (strip == 1 || idx <= strip) {
        act = static_cast<uint32_t>(
            static_cast<int32_t>(act) + delta);
      } else {
        act = static_cast<uint32_t>(
            static_cast<int32_t>(act) + delta +
            static_cast<int32_t>(flat[idx - strip]) -
            static_cast<int32_t>(flat[idx - strip - 1]));
      }
      flat[idx] = static_cast<uint8_t>(act & 255u);
    }
  }

  // Pass 4: de-interleave with period `skip`.
  if (skip <= 1) {
    std::memcpy(out, flat.data(), total);
  } else if (block == 0) {
    deinterleave_chunk(flat.data(), out, total, skip);
  } else {
    int64_t chunk = static_cast<int64_t>(skip) * block;
    for (int64_t start = 0; start < total; start += chunk) {
      int64_t len = total - start < chunk ? total - start : chunk;
      deinterleave_chunk(flat.data() + start, out + start, len, skip);
    }
  }
  return 0;
}

// ESL min/max block grid over a uint8 volume (z-major (d, h, w)).
// min_out/max_out are dense (gd, gh, gw) grids with gd=ceil(d/block) etc.
// Mirrors the semantics of the reference's host scan
// (reference: RaycasterBase.cpp:101-117) without the 32^3 padding.
int volrt_esl_minmax(const uint8_t* vol, int64_t d, int64_t h, int64_t w,
                     int64_t block, uint8_t* min_out, uint8_t* max_out) {
  if (block <= 0) return 2;
  int64_t gd = (d + block - 1) / block;
  int64_t gh = (h + block - 1) / block;
  int64_t gw = (w + block - 1) / block;
  int64_t gn = gd * gh * gw;
  std::memset(min_out, 255, gn);
  std::memset(max_out, 0, gn);
  for (int64_t z = 0; z < d; ++z) {
    int64_t gz = z / block;
    for (int64_t y = 0; y < h; ++y) {
      int64_t gy = y / block;
      const uint8_t* row = vol + (z * h + y) * w;
      int64_t gbase = (gz * gh + gy) * gw;
      for (int64_t x = 0; x < w; ++x) {
        uint8_t v = row[x];
        int64_t gi = gbase + x / block;
        if (v < min_out[gi]) min_out[gi] = v;
        if (v > max_out[gi]) max_out[gi] = v;
      }
    }
  }
  return 0;
}

// Histogram of a uint8 volume (256 bins) — the loader-side stat the
// reference computes per volume (reference: ModelBase.cpp:19-33).
int volrt_histogram(const uint8_t* vol, int64_t n, int64_t* bins) {
  std::memset(bins, 0, 256 * sizeof(int64_t));
  for (int64_t i = 0; i < n; ++i) bins[vol[i]]++;
  return 0;
}

// Non-linear gradient-weighted 16->8 bit quantization over a uint16
// volume (z-major (d, h, w)); the loader-side hot loop for 2-component
// PVM/RAW assets (reference: ddsbase.cpp:475-558 and the gradient at
// 444-472). Matches io/pvm.py:quantize16 term for term: per-voxel
// central-difference gradient magnitude (one-sided at borders), a
// 65536-bucket histogram of sqrt(magnitude), cube root, 256 rounds of
// outlier capping at mean level, prefix integration, 255-normalization,
// and (int)(x + 0.5) truncation. The capping rounds total the buckets
// with numpy-style pairwise summation so the cap level — and therefore
// the emitted bytes — match the Python path bit for bit.
static double pairwise_sum(const double* a, int64_t n) {
  if (n <= 8) {
    double s = 0.0;
    for (int64_t i = 0; i < n; ++i) s += a[i];
    return s;
  }
  if (n <= 128) {
    // numpy's unrolled-by-8 inner block.
    double r[8];
    for (int i = 0; i < 8; ++i) r[i] = a[i];
    int64_t i = 8;
    for (; i + 8 <= n; i += 8)
      for (int j = 0; j < 8; ++j) r[j] += a[i + j];
    double s = ((r[0] + r[1]) + (r[2] + r[3]))
             + ((r[4] + r[5]) + (r[6] + r[7]));
    for (; i < n; ++i) s += a[i];
    return s;
  }
  int64_t half = n / 2;
  half -= half % 8;
  return pairwise_sum(a, half) + pairwise_sum(a + half, n - half);
}

int volrt_quantize16(const uint16_t* v, int64_t d, int64_t h, int64_t w,
                     int linear, uint8_t* out) {
  const int64_t n = d * h * w;
  if (n <= 0) return 2;
  uint16_t vmin = v[0], vmax = v[0];
  for (int64_t i = 0; i < n; ++i) {
    if (v[i] < vmin) vmin = v[i];
    if (v[i] > vmax) vmax = v[i];
  }
  std::vector<double> err(65536, 0.0);
  if (linear) {
    double den = (vmax > 0 ? vmax : 1);
    for (int64_t i = 0; i < 65536; ++i)
      err[i] = 255.0 * static_cast<double>(i) / den;
  } else {
    auto at = [&](int64_t z, int64_t y, int64_t x) -> double {
      return static_cast<double>(v[(z * h + y) * w + x]);
    };
    for (int64_t z = 0; z < d; ++z)
      for (int64_t y = 0; y < h; ++y)
        for (int64_t x = 0; x < w; ++x) {
          double gz = 0.0, gy = 0.0, gx = 0.0;
          if (d > 1)
            gz = (z == 0) ? at(1, y, x) - at(0, y, x)
               : (z == d - 1) ? at(d - 1, y, x) - at(d - 2, y, x)
               : (at(z + 1, y, x) - at(z - 1, y, x)) / 2.0;
          if (h > 1)
            gy = (y == 0) ? at(z, 1, x) - at(z, 0, x)
               : (y == h - 1) ? at(z, h - 1, x) - at(z, h - 2, x)
               : (at(z, y + 1, x) - at(z, y - 1, x)) / 2.0;
          if (w > 1)
            gx = (x == 0) ? at(z, y, 1) - at(z, y, 0)
               : (x == w - 1) ? at(z, y, w - 1) - at(z, y, w - 2)
               : (at(z, y, x + 1) - at(z, y, x - 1)) / 2.0;
          double mag = std::sqrt(gz * gz + gy * gy + gx * gx);
          err[v[(z * h + y) * w + x]] += std::sqrt(mag);
        }
    // numpy power(x, 1/3), not cbrt: the two differ in ULPs.
    for (int64_t i = 0; i < 65536; ++i)
      err[i] = std::pow(err[i], 1.0 / 3.0);
    err[vmin] = 0.0;
    err[vmax] = 0.0;
    for (int round = 0; round < 256; ++round) {
      double cap = pairwise_sum(err.data(), 65536) / 256.0;
      bool over = false;
      for (int64_t i = 0; i < 65536; ++i)
        if (err[i] > cap) { err[i] = cap; over = true; }
      if (!over) break;
    }
    double acc = 0.0;
    for (int64_t i = 0; i < 65536; ++i) { acc += err[i]; err[i] = acc; }
    if (err[65535] > 0.0) {
      double scale = 255.0 / err[65535];
      for (int64_t i = 0; i < 65536; ++i) err[i] *= scale;
    }
  }
  for (int64_t i = 0; i < n; ++i)
    out[i] = static_cast<uint8_t>(err[v[i]] + 0.5);
  return 0;
}

int volrt_native_abi_version(void) { return 2; }

}  // extern "C"
