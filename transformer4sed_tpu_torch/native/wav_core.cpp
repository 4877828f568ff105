// Native waveform loader: RIFF/WAV decode + mono downmix + windowed-sinc
// resampling + pad/truncate, GIL-free and batch-threaded.
//
// TPU-native counterpart of the reference's librosa-based data layer
// (src/preprocess/feats_extraction.py:7-38 wraps librosa.load -> mono ->
// pad). librosa/ffmpeg are CPython-bound and GIL-limited; on a TPU host
// the input pipeline must keep up with the device from plain CPU
// threads, so the decode hot path lives here. Python falls back to the
// scipy implementation in data/audio_io.py when no toolchain exists.
//
// Supported containers: RIFF WAVE with PCM u8/s16/s24/s32 and IEEE
// float32/float64 payloads (chunk walker skips LIST/fact/etc), and
// native FLAC (dispatched on the 'fLaC' magic): STREAMINFO + frame
// decode with constant / verbatim / fixed / LPC subframes, rice and
// rice2 partitioned residuals, wasted bits, and left-side / right-side
// / mid-side stereo decorrelation — the full lossless subset the
// format defines (AudioSet-strong clips in the wild ship as flac;
// the reference ingests them via librosa/ffmpeg,
// src/preprocess/feats_extraction.py:7-16).
// Resampler: Hann-windowed sinc interpolation with a 512-samples-per-
// zero-crossing lookup table (16 zero crossings each side, scaled by
// min(1, target/orig) for anti-aliasing on downsample) — the resampy
// "kaiser_fast"-class design, chosen over rational polyphase so any
// rate pair works without factorization.
//
// C ABI (ctypes):
//   t4s_load_wav(path, target_sr, pad_to, out[pad_to], &true_len) -> err
//   t4s_load_wav_batch(paths, n, target_sr, pad_to, out[n*pad_to],
//                      true_len[n], err[n], n_threads)
// err codes: 0 ok, 1 open failed, 2 not a wav, 3 unsupported encoding,
//            4 malformed/truncated.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kZeroCrossings = 16;
constexpr int kTablePrecision = 512;

// Hann-windowed sinc table, built once per process.
struct SincTable {
  std::vector<double> v;
  SincTable() : v(kZeroCrossings * kTablePrecision + 1) {
    const int n = kZeroCrossings * kTablePrecision;
    v[0] = 1.0;
    for (int i = 1; i <= n; ++i) {
      const double x = static_cast<double>(i) / kTablePrecision;  // in crossings
      const double s = std::sin(M_PI * x) / (M_PI * x);
      const double w = 0.5 * (1.0 + std::cos(M_PI * x / kZeroCrossings));
      v[i] = s * w;
    }
  }
  double operator()(double x) const {  // x in zero-crossing units, >= 0
    const double p = x * kTablePrecision;
    const int i = static_cast<int>(p);
    if (i >= kZeroCrossings * kTablePrecision) return 0.0;
    const double f = p - i;
    return v[i] * (1.0 - f) + v[i + 1] * f;
  }
};

const SincTable& sinc_table() {
  static SincTable t;
  return t;
}

struct WavData {
  std::vector<float> samples;  // interleaved
  int channels = 0;
  int sample_rate = 0;
};

uint32_t rd_u32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) | (static_cast<uint32_t>(p[3]) << 24);
}
uint16_t rd_u16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0]) | (static_cast<uint16_t>(p[1]) << 8);
}

// ---------------------------------------------------------------------------
// FLAC decode (spec: RFC 9639 / xiph FLAC format). MSB-first bit reader.
// ---------------------------------------------------------------------------

struct BitReader {
  const uint8_t* p;
  size_t n;        // bytes available
  size_t bit = 0;  // absolute bit cursor
  bool ok = true;

  bool ensure(size_t k) {
    if (bit + k > n * 8) {
      ok = false;
      return false;
    }
    return true;
  }
  uint64_t bits(int k) {  // k in [0, 57], MSB-first
    if (k == 0) return 0;
    if (!ensure(static_cast<size_t>(k))) return 0;
    const size_t byte = bit >> 3;
    const int off = static_cast<int>(bit & 7);
    bit += static_cast<size_t>(k);
    const int need = off + k;
    const int nb = (need + 7) / 8;
    uint64_t acc = 0;
    for (int i = 0; i < nb; ++i) acc = (acc << 8) | p[byte + i];
    acc >>= nb * 8 - need;
    return acc & ((k >= 64) ? ~0ULL : ((1ULL << k) - 1));
  }
  int64_t sbits(int k) {  // two's complement
    const uint64_t v = bits(k);
    if (k == 0) return 0;
    if (v & (1ULL << (k - 1))) return static_cast<int64_t>(v) - (1LL << k);
    return static_cast<int64_t>(v);
  }
  uint32_t unary() {  // count of 0 bits before the next 1 bit
    uint32_t q = 0;
    while (ok) {
      if (!ensure(1)) return 0;
      const uint32_t b = (p[bit >> 3] >> (7 - (bit & 7))) & 1u;
      ++bit;
      if (b) return q;
      if (++q > (1u << 24)) {  // runaway guard on corrupt streams
        ok = false;
        return 0;
      }
    }
    return 0;
  }
  void align() { bit = (bit + 7) & ~static_cast<size_t>(7); }
};

int flac_residual(BitReader* br, uint32_t n, int order, std::vector<int64_t>* res) {
  res->assign(n - static_cast<uint32_t>(order), 0);
  const uint32_t method = static_cast<uint32_t>(br->bits(2));
  if (method > 1) return 4;
  const int pbits = method == 0 ? 4 : 5;
  const uint32_t escape = method == 0 ? 0xFu : 0x1Fu;
  const uint32_t po = static_cast<uint32_t>(br->bits(4));
  const uint32_t nparts = 1u << po;
  // blocksize must split evenly and the first partition (which drops the
  // `order` warmup samples) must not underflow
  if ((n >> po) << po != n || (n >> po) < static_cast<uint32_t>(order)) return 4;
  size_t idx = 0;
  for (uint32_t part = 0; part < nparts; ++part) {
    const uint32_t take = (n >> po) - (part == 0 ? static_cast<uint32_t>(order) : 0u);
    const uint32_t param = static_cast<uint32_t>(br->bits(pbits));
    if (param == escape) {
      const int raw = static_cast<int>(br->bits(5));
      for (uint32_t i = 0; i < take; ++i) (*res)[idx++] = raw ? br->sbits(raw) : 0;
    } else {
      for (uint32_t i = 0; i < take; ++i) {
        const uint64_t q = br->unary();
        const uint64_t v = (q << param) | br->bits(static_cast<int>(param));
        (*res)[idx++] = static_cast<int64_t>(v >> 1) ^ -static_cast<int64_t>(v & 1);
      }
    }
    if (!br->ok) return 4;
  }
  return 0;
}

int flac_subframe(BitReader* br, uint32_t n, int bps, std::vector<int64_t>* out,
                  std::vector<int64_t>* res) {
  out->assign(n, 0);
  if (br->bits(1) != 0) return 4;  // padding bit
  const uint32_t type = static_cast<uint32_t>(br->bits(6));
  int wasted = 0;
  if (br->bits(1)) wasted = 1 + static_cast<int>(br->unary());
  bps -= wasted;
  if (bps <= 0 || bps > 33) return 4;

  if (type == 0) {  // CONSTANT
    const int64_t v = br->sbits(bps);
    for (auto& s : *out) s = v;
  } else if (type == 1) {  // VERBATIM
    for (uint32_t i = 0; i < n; ++i) (*out)[i] = br->sbits(bps);
  } else if (type >= 8 && type <= 12) {  // FIXED, order 0..4
    const int order = static_cast<int>(type) - 8;
    if (static_cast<uint32_t>(order) > n) return 4;
    for (int i = 0; i < order; ++i) (*out)[i] = br->sbits(bps);
    if (flac_residual(br, n, order, res)) return 4;
    int64_t* s = out->data();
    for (uint32_t i = static_cast<uint32_t>(order); i < n; ++i) {
      int64_t pred;
      switch (order) {
        case 0: pred = 0; break;
        case 1: pred = s[i - 1]; break;
        case 2: pred = 2 * s[i - 1] - s[i - 2]; break;
        case 3: pred = 3 * s[i - 1] - 3 * s[i - 2] + s[i - 3]; break;
        default: pred = 4 * s[i - 1] - 6 * s[i - 2] + 4 * s[i - 3] - s[i - 4];
      }
      s[i] = pred + (*res)[i - static_cast<uint32_t>(order)];
    }
  } else if (type >= 32) {  // LPC, order 1..32
    const int order = static_cast<int>(type & 31u) + 1;
    if (static_cast<uint32_t>(order) > n) return 4;
    for (int i = 0; i < order; ++i) (*out)[i] = br->sbits(bps);
    const int prec = static_cast<int>(br->bits(4)) + 1;
    if (prec == 16) return 4;  // 0b1111 is invalid per spec
    const int shift = static_cast<int>(br->sbits(5));
    if (shift < 0) return 4;
    int64_t coef[32];
    for (int i = 0; i < order; ++i) coef[i] = br->sbits(prec);
    if (flac_residual(br, n, order, res)) return 4;
    int64_t* s = out->data();
    for (uint32_t i = static_cast<uint32_t>(order); i < n; ++i) {
      int64_t acc = 0;  // <= 33 + 15 + 5 bits — no overflow in 64
      for (int j = 0; j < order; ++j) acc += coef[j] * s[i - 1 - static_cast<uint32_t>(j)];
      s[i] = (acc >> shift) + (*res)[i - static_cast<uint32_t>(order)];
    }
  } else {
    return 4;
  }
  if (wasted)
    for (auto& s : *out) s = static_cast<int64_t>(static_cast<uint64_t>(s) << wasted);
  return br->ok ? 0 : 4;
}

int decode_flac(const std::vector<uint8_t>& buf, WavData* out) {
  if (buf.size() < 42 || std::memcmp(buf.data(), "fLaC", 4) != 0) return 2;
  size_t pos = 4;
  int sample_rate = 0, channels = 0, bps = 0;
  uint64_t total = 0;
  bool have_si = false, last = false;
  while (!last) {
    if (pos + 4 > buf.size()) return 4;
    const uint8_t h = buf[pos];
    last = (h & 0x80u) != 0;
    const uint32_t type = h & 0x7Fu;
    const uint32_t len = (static_cast<uint32_t>(buf[pos + 1]) << 16) |
                         (static_cast<uint32_t>(buf[pos + 2]) << 8) | buf[pos + 3];
    pos += 4;
    if (pos + len > buf.size()) return 4;
    if (type == 0 && len >= 34) {  // STREAMINFO
      const uint8_t* s = &buf[pos];
      sample_rate = (static_cast<int>(s[10]) << 12) | (static_cast<int>(s[11]) << 4) |
                    (s[12] >> 4);
      channels = ((s[12] >> 1) & 0x7) + 1;
      bps = (((s[12] & 1) << 4) | (s[13] >> 4)) + 1;
      total = (static_cast<uint64_t>(s[13] & 0xF) << 32) |
              (static_cast<uint64_t>(s[14]) << 24) | (static_cast<uint64_t>(s[15]) << 16) |
              (static_cast<uint64_t>(s[16]) << 8) | s[17];
      have_si = true;
    }
    pos += len;
  }
  if (!have_si || sample_rate <= 0 || channels < 1 || channels > 8 || bps < 4 || bps > 32)
    return 3;
  out->channels = channels;
  out->sample_rate = sample_rate;
  out->samples.clear();
  if (total) out->samples.reserve(static_cast<size_t>(total) * static_cast<size_t>(channels));
  const double norm = 1.0 / static_cast<double>(1ULL << (bps - 1));

  std::vector<std::vector<int64_t>> ch(static_cast<size_t>(channels));
  std::vector<int64_t> res;
  while (pos + 2 <= buf.size()) {
    if (buf[pos] != 0xFF || (buf[pos + 1] & 0xFC) != 0xF8) return 4;
    BitReader br{buf.data() + pos, buf.size() - pos};
    br.bits(16);  // sync(14) + reserved + blocking strategy
    const uint32_t bs_code = static_cast<uint32_t>(br.bits(4));
    const uint32_t sr_code = static_cast<uint32_t>(br.bits(4));
    const uint32_t ca = static_cast<uint32_t>(br.bits(4));
    const uint32_t ss_code = static_cast<uint32_t>(br.bits(3));
    br.bits(1);  // reserved
    {            // UTF-8 coded frame/sample number
      const uint32_t b0 = static_cast<uint32_t>(br.bits(8));
      if (b0 >= 0x80u) {
        int ones = 0;
        while (ones < 8 && (b0 & (0x80u >> ones))) ++ones;
        if (ones < 2 || ones > 7) return 4;
        for (int i = 0; i < ones - 1; ++i) br.bits(8);
      }
    }
    uint32_t blocksize;
    if (bs_code == 0) return 4;
    else if (bs_code == 1) blocksize = 192;
    else if (bs_code <= 5) blocksize = 576u << (bs_code - 2);
    else if (bs_code == 6) blocksize = static_cast<uint32_t>(br.bits(8)) + 1;
    else if (bs_code == 7) blocksize = static_cast<uint32_t>(br.bits(16)) + 1;
    else blocksize = 256u << (bs_code - 8);
    if (sr_code == 12) br.bits(8);
    else if (sr_code == 13 || sr_code == 14) br.bits(16);
    else if (sr_code == 15) return 4;
    int frame_bps = bps;
    if (ss_code == 1) frame_bps = 8;
    else if (ss_code == 2) frame_bps = 12;
    else if (ss_code == 4) frame_bps = 16;
    else if (ss_code == 5) frame_bps = 20;
    else if (ss_code == 6) frame_bps = 24;
    else if (ss_code == 7) frame_bps = 32;
    else if (ss_code == 3) return 4;
    br.bits(8);  // header CRC-8 (structure-validated stream; not re-checked)
    if (ca > 10) return 4;
    const int nch = ca < 8 ? static_cast<int>(ca) + 1 : 2;
    if (nch != channels || blocksize > (1u << 16) || blocksize == 0) return 4;

    for (int c = 0; c < nch; ++c) {
      int sbps = frame_bps;
      if ((ca == 8 && c == 1) || (ca == 9 && c == 0) || (ca == 10 && c == 1)) sbps += 1;
      if (flac_subframe(&br, blocksize, sbps, &ch[static_cast<size_t>(c)], &res)) return 4;
    }
    if (!br.ok) return 4;
    br.align();
    br.bits(16);  // frame CRC-16
    if (!br.ok) return 4;

    if (ca == 8) {  // left/side -> right = left - side
      for (uint32_t i = 0; i < blocksize; ++i) ch[1][i] = ch[0][i] - ch[1][i];
    } else if (ca == 9) {  // side/right -> left = right + side
      for (uint32_t i = 0; i < blocksize; ++i) ch[0][i] = ch[1][i] + ch[0][i];
    } else if (ca == 10) {  // mid/side
      for (uint32_t i = 0; i < blocksize; ++i) {
        const int64_t side = ch[1][i];
        const int64_t mid = (ch[0][i] << 1) | (side & 1);
        ch[0][i] = (mid + side) >> 1;
        ch[1][i] = (mid - side) >> 1;
      }
    }
    for (uint32_t i = 0; i < blocksize; ++i)
      for (int c = 0; c < channels; ++c)
        out->samples.push_back(
            static_cast<float>(static_cast<double>(ch[static_cast<size_t>(c)][i]) * norm));
    pos += br.bit >> 3;
    if (total && out->samples.size() >=
                     static_cast<size_t>(total) * static_cast<size_t>(channels))
      break;
  }
  if (total) {
    const size_t want = static_cast<size_t>(total) * static_cast<size_t>(channels);
    // STREAMINFO promised `total` samples; a stream cut at a frame
    // boundary decodes clean-but-short — padding it with zeros would
    // silently turn a partial download into silence.
    // Limitation (inherent to FLAC, shared by data/flac.py): when
    // STREAMINFO total_samples == 0 ("unknown"), a frame-boundary cut
    // still decodes clean-but-short with no error.
    if (out->samples.size() < want) return 4;
    out->samples.resize(want);
  }
  return 0;
}

int decode_wav(const char* path, WavData* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  std::vector<uint8_t> buf;
  {
    std::fseek(f, 0, SEEK_END);
    const long sz = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    if (sz < 12) { std::fclose(f); return 2; }
    buf.resize(static_cast<size_t>(sz));
    if (std::fread(buf.data(), 1, buf.size(), f) != buf.size()) {
      std::fclose(f);
      return 4;
    }
    std::fclose(f);
  }
  if (std::memcmp(buf.data(), "fLaC", 4) == 0) return decode_flac(buf, out);
  if (buf.size() < 44 || std::memcmp(buf.data(), "RIFF", 4) != 0 ||
      std::memcmp(buf.data() + 8, "WAVE", 4) != 0)
    return 2;

  uint16_t fmt_code = 0, channels = 0, bits = 0;
  uint32_t sample_rate = 0;
  const uint8_t* data = nullptr;
  size_t data_len = 0;
  size_t pos = 12;
  while (pos + 8 <= buf.size()) {
    const uint32_t chunk_len = rd_u32(&buf[pos + 4]);
    const uint8_t* body = &buf[pos + 8];
    const size_t avail = buf.size() - pos - 8;
    const size_t len = chunk_len < avail ? chunk_len : avail;
    if (std::memcmp(&buf[pos], "fmt ", 4) == 0) {
      if (len < 16) return 4;
      fmt_code = rd_u16(body);
      channels = rd_u16(body + 2);
      sample_rate = rd_u32(body + 4);
      bits = rd_u16(body + 14);
      if (fmt_code == 0xFFFE && len >= 40) fmt_code = rd_u16(body + 24);  // extensible
    } else if (std::memcmp(&buf[pos], "data", 4) == 0) {
      data = body;
      data_len = len;
    }
    pos += 8 + chunk_len + (chunk_len & 1);  // chunks are word-aligned
  }
  if (!data || channels == 0 || sample_rate == 0) return 4;

  const size_t bytes_per = bits / 8;
  if (bytes_per == 0) return 3;
  const size_t n = data_len / bytes_per;
  out->samples.resize(n);
  out->channels = channels;
  out->sample_rate = static_cast<int>(sample_rate);

  if (fmt_code == 1 && bits == 16) {
    for (size_t i = 0; i < n; ++i) {
      int16_t v;
      std::memcpy(&v, data + 2 * i, 2);
      out->samples[i] = static_cast<float>(v) / 32768.0f;
    }
  } else if (fmt_code == 1 && bits == 32) {
    for (size_t i = 0; i < n; ++i) {
      int32_t v;
      std::memcpy(&v, data + 4 * i, 4);
      out->samples[i] = static_cast<float>(static_cast<double>(v) / 2147483648.0);
    }
  } else if (fmt_code == 1 && bits == 24) {
    for (size_t i = 0; i < n; ++i) {
      const uint8_t* p = data + 3 * i;
      int32_t v = (static_cast<int32_t>(p[0]) << 8) | (static_cast<int32_t>(p[1]) << 16) |
                  (static_cast<int32_t>(p[2]) << 24);
      out->samples[i] = static_cast<float>(static_cast<double>(v) / 2147483648.0);
    }
  } else if (fmt_code == 1 && bits == 8) {
    for (size_t i = 0; i < n; ++i)
      out->samples[i] = (static_cast<float>(data[i]) - 128.0f) / 128.0f;
  } else if (fmt_code == 3 && bits == 32) {
    for (size_t i = 0; i < n; ++i) {
      float v;
      std::memcpy(&v, data + 4 * i, 4);
      out->samples[i] = v;
    }
  } else if (fmt_code == 3 && bits == 64) {
    for (size_t i = 0; i < n; ++i) {
      double v;
      std::memcpy(&v, data + 8 * i, 8);
      out->samples[i] = static_cast<float>(v);
    }
  } else {
    return 3;
  }
  return 0;
}

// mono downmix (mean over channels), matching audio_io.to_mono.
void downmix(const WavData& w, std::vector<float>* mono) {
  const size_t frames = w.samples.size() / w.channels;
  mono->resize(frames);
  if (w.channels == 1) {
    std::memcpy(mono->data(), w.samples.data(), frames * sizeof(float));
    return;
  }
  const float inv = 1.0f / static_cast<float>(w.channels);
  for (size_t i = 0; i < frames; ++i) {
    double acc = 0.0;
    for (int c = 0; c < w.channels; ++c) acc += w.samples[i * w.channels + c];
    (*mono)[i] = static_cast<float>(acc) * inv;
  }
}

long gcd_l(long a, long b) { return b == 0 ? a : gcd_l(b, a % b); }

void resample_sinc(const std::vector<float>& in, int orig_sr, int target_sr,
                   std::vector<float>* out) {
  if (orig_sr == target_sr || in.empty()) {
    *out = in;
    return;
  }
  const double ratio = static_cast<double>(target_sr) / orig_sr;
  const double scale = ratio < 1.0 ? ratio : 1.0;
  const double width = kZeroCrossings / scale;  // taps each side, input units
  const size_t n_out = static_cast<size_t>(std::ceil(in.size() * ratio));
  out->assign(n_out, 0.0f);
  const SincTable& tbl = sinc_table();
  const long n_in = static_cast<long>(in.size());

  // Rational ratio -> polyphase: output t sits at input position
  // base + phase/L with phase = (t*M) mod L, so only L distinct tap
  // vectors exist. Precompute them (L*(2W+2) sinc evals, trivial) and
  // the hot loop becomes a pure FIR dot product — no per-tap window
  // interpolation. Audio rates always reduce to small L (44100->32000:
  // L=320); the direct path below covers pathological ratios.
  const long g = gcd_l(target_sr, orig_sr);
  const long L = target_sr / g, M = orig_sr / g;
  if (L <= 8192) {
    const int w_half = static_cast<int>(std::ceil(width)) + 1;
    const int n_taps = 2 * w_half + 2;
    std::vector<float> taps(static_cast<size_t>(L) * n_taps);
    for (long p = 0; p < L; ++p) {
      const double frac = static_cast<double>(p) / L;
      for (int j = 0; j < n_taps; ++j) {
        const double d = std::fabs((j - w_half - frac) * scale);
        taps[static_cast<size_t>(p) * n_taps + j] = static_cast<float>(tbl(d) * scale);
      }
    }
    for (size_t t = 0; t < n_out; ++t) {
      const long num = static_cast<long>(t) * M;
      const long base = num / L;
      const long phase = num % L;
      const float* tp = &taps[static_cast<size_t>(phase) * n_taps];
      long k0 = base - w_half;
      int j0 = 0;
      if (k0 < 0) { j0 = static_cast<int>(-k0); k0 = 0; }
      long k1 = base - w_half + n_taps - 1;
      if (k1 >= n_in) k1 = n_in - 1;
      float acc = 0.0f;
      const float* src = in.data() + k0;
      const int nk = static_cast<int>(k1 - k0 + 1);
      const float* tw = tp + j0;
      for (int j = 0; j < nk; ++j) acc += src[j] * tw[j];
      (*out)[t] = acc;
    }
    return;
  }

  for (size_t t = 0; t < n_out; ++t) {
    const double x = static_cast<double>(t) / ratio;  // position in input
    long k0 = static_cast<long>(std::ceil(x - width));
    long k1 = static_cast<long>(std::floor(x + width));
    if (k0 < 0) k0 = 0;
    if (k1 >= n_in) k1 = n_in - 1;
    double acc = 0.0;
    for (long k = k0; k <= k1; ++k) {
      const double d = std::fabs((k - x) * scale);
      acc += in[static_cast<size_t>(k)] * tbl(d);
    }
    (*out)[t] = static_cast<float>(acc * scale);
  }
}

int load_one(const char* path, int target_sr, long pad_to, float* out, long* true_len) {
  WavData w;
  const int err = decode_wav(path, &w);
  if (err) return err;
  std::vector<float> mono, res;
  downmix(w, &mono);
  resample_sinc(mono, w.sample_rate, target_sr, &res);
  const long n = static_cast<long>(res.size()) < pad_to ? static_cast<long>(res.size()) : pad_to;
  std::memcpy(out, res.data(), static_cast<size_t>(n) * sizeof(float));
  if (n < pad_to) std::memset(out + n, 0, static_cast<size_t>(pad_to - n) * sizeof(float));
  *true_len = n;
  return 0;
}

}  // namespace

extern "C" {

int t4s_load_wav(const char* path, int target_sr, long pad_to, float* out, long* true_len) {
  return load_one(path, target_sr, pad_to, out, true_len);
}

void t4s_load_wav_batch(const char** paths, long n, int target_sr, long pad_to,
                        float* out, long* true_len, int* err, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = static_cast<int>(n);
  std::atomic<long> next(0);
  auto worker = [&]() {
    long i;
    while ((i = next.fetch_add(1)) < n)
      err[i] = load_one(paths[i], target_sr, pad_to, out + i * pad_to, &true_len[i]);
  };
  if (n_threads == 1) {
    worker();
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // extern "C"
