// Native host-side audio decode for speechbrain_tpu.
//
// The reference reads audio through torchaudio's C++ backends
// (sox/soundfile; reference dataio/dataio.py:162).  This file is the
// framework's own native decode layer.  The centerpiece is a
// self-contained FLAC decoder (LibriSpeech's container): full subframe
// support (constant / verbatim / fixed 0-4 / LPC), rice + rice2
// residuals with escape partitions, wasted bits, and all stereo
// decorrelation modes (independent, left/side, right/side, mid/side).
// CRCs are not verified (decode speed path).
//
// C ABI (ctypes):
//   int sb_flac_decode(path, &out, &n_frames, &channels, &rate)
//     out: malloc'd interleaved float32 in [-1, 1]; free with
//     sb_free_f32.  Returns 0 on success, negative error codes.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct BitReader {
  // 64-bit MSB-aligned bit buffer refilled bytewise: bits()/unary()
  // run in a handful of ops instead of a per-byte loop (the rice
  // residual loop is the decode hot path).
  const uint8_t* data;
  size_t size;
  size_t pos = 0;     // next source byte to load
  uint64_t buf = 0;   // MSB-aligned pending bits
  int nbits = 0;      // valid bits in buf

  size_t consumed_bits() const { return pos * 8 - (size_t)nbits; }

  bool eof() const { return consumed_bits() >= size * 8; }

  void refill() {
    if (nbits > 56) return;
    if (pos + 8 <= size) {
      // word-at-a-time: load 8 bytes, byte-swap to MSB-first, splice
      // the whole-byte prefix that fits above the pending bits
      uint64_t v;
      memcpy(&v, data + pos, 8);
      v = __builtin_bswap64(v);
      int take = (64 - nbits) & ~7;  // multiple of 8, in [8, 64]
      uint64_t chunk =
          take == 64 ? v : (v >> (64 - take)) << (64 - nbits - take);
      buf |= chunk;
      nbits += take;
      pos += take >> 3;
      return;
    }
    while (nbits <= 56 && pos < size) {
      buf |= (uint64_t)data[pos++] << (56 - nbits);
      nbits += 8;
    }
  }

  // n <= 32
  uint32_t bits(int n) {
    if (n <= 0) return 0;
    if (n > nbits) refill();
    if (n <= nbits) {
      uint32_t v = (uint32_t)(buf >> (64 - n));
      buf <<= n;
      nbits -= n;
      return v;
    }
    // zero-pad past EOF (caller checks eof)
    uint32_t v = nbits ? (uint32_t)(buf >> (64 - nbits)) : 0;
    v <<= (n - nbits);
    buf = 0;
    nbits = 0;
    return v;
  }

  int32_t sbits(int n) {
    uint32_t v = bits(n);
    if (n <= 0 || n >= 32) return (int32_t)v;
    if (v & (1u << (n - 1))) return (int32_t)(v | (~0u << n));
    return (int32_t)v;
  }

  uint32_t unary() {
    uint32_t q = 0;
    for (;;) {
      if (nbits == 0 || buf == 0) {
        refill();
        if (nbits == 0) return q;  // EOF
      }
      if (buf == 0) {  // buffer all zeros: consume and keep counting
        q += nbits;
        nbits = 0;
        continue;
      }
      int lead = __builtin_clzll(buf);
      if (lead >= nbits) {  // zeros run past valid bits
        q += nbits;
        buf = 0;
        nbits = 0;
        continue;
      }
      q += lead;
      buf = (lead + 1 < 64) ? buf << (lead + 1) : 0;
      nbits -= lead + 1;
      return q;
    }
  }

  void align() {
    int r = (int)(consumed_bits() % 8);
    if (r) {
      int drop = 8 - r;
      if (drop > nbits) drop = nbits;
      buf <<= drop;
      nbits -= drop;
    }
  }

  size_t byte_pos() const { return consumed_bits() / 8; }

  // Skip n whole bytes; caller must be byte-aligned.
  void skip_bytes(size_t n) {
    size_t from_buf = (size_t)nbits / 8;
    if (from_buf > n) from_buf = n;
    int shift = (int)(from_buf * 8);
    buf = shift < 64 ? buf << shift : 0;
    nbits -= shift;
    pos += n - from_buf;
    if (pos > size) pos = size;
  }

  // frame/sample number: UTF-8-style coded integer (up to 56 bits)
  uint64_t utf8_num() {
    uint32_t b0 = bits(8);
    if (!(b0 & 0x80)) return b0;
    int n = 0;
    for (uint32_t m = 0x40; b0 & m; m >>= 1) ++n;
    uint64_t v = b0 & (0x3F >> n);
    for (int i = 0; i < n; ++i) v = (v << 6) | (bits(8) & 0x3F);
    return v;
  }
};

const int kFixedCoef[5][4] = {
    {},
    {1},
    {2, -1},
    {3, -3, 1},
    {4, -6, 4, -1},
};

bool decode_residual(BitReader& br, int blocksize, int order,
                     std::vector<int64_t>& out) {
  int method = br.bits(2);
  if (method > 1) return false;
  int plen = method == 0 ? 4 : 5;
  int escape = method == 0 ? 15 : 31;
  int po = br.bits(4);
  int n_part = 1 << po;
  if (blocksize % n_part) return false;
  int part_samples = blocksize >> po;
  int idx = order;
  for (int p = 0; p < n_part; ++p) {
    int n = part_samples - (p == 0 ? order : 0);
    if (n < 0) return false;
    int param = br.bits(plen);
    if (param == escape) {
      int nbits = br.bits(5);
      for (int i = 0; i < n; ++i) out[idx++] = br.sbits(nbits);
    } else {
      for (int i = 0; i < n; ++i) {
        uint32_t q, r;
        br.refill();
        int lead = br.buf ? __builtin_clzll(br.buf) : 64;
        if (lead + 1 + param <= br.nbits) {
          // fused fast path: the whole rice code is buffered
          q = (uint32_t)lead;
          uint64_t b = (br.buf << lead) << 1;  // drop zeros + stop bit
          r = param ? (uint32_t)(b >> (64 - param)) : 0;
          br.buf = b << param;
          br.nbits -= lead + 1 + param;
        } else {  // code spans refills / EOF
          q = br.unary();
          r = br.bits(param);
        }
        uint64_t v = ((uint64_t)q << param) | r;
        out[idx++] = (int64_t)(v >> 1) ^ -(int64_t)(v & 1);
      }
    }
    if (br.eof()) return false;
  }
  return true;
}

bool decode_subframe(BitReader& br, int blocksize, int bps,
                     std::vector<int64_t>& out) {
  if (br.bits(1) != 0) return false;  // mandatory zero pad
  int type = br.bits(6);
  int wasted = 0;
  if (br.bits(1)) wasted = br.unary() + 1;
  bps -= wasted;
  // avoid re-zeroing: every decode path overwrites all entries
  if ((int)out.size() != blocksize) out.assign(blocksize, 0);

  if (type == 0) {  // constant
    int32_t v = br.sbits(bps);
    for (int i = 0; i < blocksize; ++i) out[i] = v;
  } else if (type == 1) {  // verbatim
    for (int i = 0; i < blocksize; ++i) out[i] = br.sbits(bps);
  } else if ((type & 0x38) == 0x08 && (type & 0x07) <= 4) {  // fixed
    int order = type & 0x07;
    for (int i = 0; i < order; ++i) out[i] = br.sbits(bps);
    if (!decode_residual(br, blocksize, order, out)) return false;
    int64_t* o = out.data();
    switch (order) {  // unrolled: the per-sample j-loop dominates decode
      case 0:
        break;
      case 1:
        for (int i = 1; i < blocksize; ++i) o[i] += o[i - 1];
        break;
      case 2:
        for (int i = 2; i < blocksize; ++i)
          o[i] += 2 * o[i - 1] - o[i - 2];
        break;
      case 3:
        for (int i = 3; i < blocksize; ++i)
          o[i] += 3 * o[i - 1] - 3 * o[i - 2] + o[i - 3];
        break;
      default:
        for (int i = 4; i < blocksize; ++i)
          o[i] += 4 * o[i - 1] - 6 * o[i - 2] + 4 * o[i - 3] - o[i - 4];
    }
  } else if (type & 0x20) {  // LPC
    int order = (type & 0x1F) + 1;
    for (int i = 0; i < order; ++i) out[i] = br.sbits(bps);
    int precision = br.bits(4) + 1;
    if (precision == 16) return false;  // 1111 invalid
    int shift = br.sbits(5);
    if (shift < 0) return false;
    std::vector<int64_t> coef(order);
    for (int i = 0; i < order; ++i) coef[i] = br.sbits(precision);
    if (!decode_residual(br, blocksize, order, out)) return false;
    for (int i = order; i < blocksize; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j) pred += coef[j] * out[i - 1 - j];
      out[i] += pred >> shift;
    }
  } else {
    return false;  // reserved
  }
  if (wasted)
    for (auto& v : out) v = (int64_t)((uint64_t)v << wasted);
  return !br.eof();
}

}  // namespace

extern "C" {

void sb_free_f32(float* p) { free(p); }

int sb_flac_decode(const char* path, float** out_samples,
                   int64_t* out_frames, int* out_channels, int* out_rate) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(fsize);
  if (fread(buf.data(), 1, fsize, f) != (size_t)fsize) {
    fclose(f);
    return -2;
  }
  fclose(f);
  if (fsize < 42 || memcmp(buf.data(), "fLaC", 4) != 0) return -3;

  BitReader br{buf.data(), buf.size()};
  br.pos = 4;

  // ---- metadata blocks (STREAMINFO is mandatory and first) ----
  int sample_rate = 0, channels = 0, bps = 0;
  uint64_t total_samples = 0;
  bool last = false, have_info = false;
  while (!last && !br.eof()) {
    last = br.bits(1);
    int btype = br.bits(7);
    uint32_t blen = br.bits(24);
    if (btype == 0) {
      br.bits(16);  // min blocksize
      br.bits(16);  // max blocksize
      br.bits(24);  // min framesize
      br.bits(24);  // max framesize
      sample_rate = br.bits(20);
      channels = br.bits(3) + 1;
      bps = br.bits(5) + 1;
      total_samples = ((uint64_t)br.bits(4) << 32) | br.bits(32);
      br.skip_bytes(16);  // md5
      have_info = true;
    } else {
      br.skip_bytes(blen);
    }
  }
  if (!have_info || channels < 1 || channels > 8 || bps < 4 || bps > 32)
    return -4;

  std::vector<std::vector<float>> pcm(channels);
  if (total_samples)
    for (auto& c : pcm) c.reserve(total_samples);
  std::vector<std::vector<int64_t>> chan(channels);
  const double scale = 1.0 / (double)(1ull << (bps - 1));

  // ---- frames ----
  while (br.byte_pos() + 2 < br.size) {
    if (total_samples && pcm[0].size() >= total_samples) break;
    uint32_t sync = br.bits(14);
    if (sync != 0x3FFE) break;
    br.bits(1);  // reserved
    br.bits(1);  // blocking strategy
    int bs_code = br.bits(4);
    int sr_code = br.bits(4);
    int ch_asgn = br.bits(4);
    int ss_code = br.bits(3);
    br.bits(1);  // reserved
    br.utf8_num();
    int blocksize;
    switch (bs_code) {
      case 0: return -5;
      case 1: blocksize = 192; break;
      case 6: blocksize = br.bits(8) + 1; break;
      case 7: blocksize = br.bits(16) + 1; break;
      default:
        blocksize = bs_code <= 5 ? 576 << (bs_code - 2)
                                 : 256 << (bs_code - 8);
    }
    if (sr_code == 12) br.bits(8);
    else if (sr_code == 13 || sr_code == 14) br.bits(16);
    int frame_bps = bps;
    static const int kBps[8] = {0, 8, 12, 0, 16, 20, 24, 32};
    if (ss_code != 0 && ss_code != 3) frame_bps = kBps[ss_code];
    br.bits(8);  // crc8 (unverified)

    int n_ch = ch_asgn < 8 ? channels : 2;
    if (ch_asgn >= 8 && channels != 2) return -6;
    for (int c = 0; c < n_ch; ++c) {
      int ebps = frame_bps;
      if ((ch_asgn == 8 && c == 1) || (ch_asgn == 9 && c == 0) ||
          (ch_asgn == 10 && c == 1))
        ebps += 1;  // side channel carries one extra bit
      if (!decode_subframe(br, blocksize, ebps, chan[c])) return -7;
    }
    br.align();
    br.bits(16);  // crc16 (unverified)

    // undo stereo decorrelation
    if (ch_asgn == 8) {  // left/side: R = L - S
      for (int i = 0; i < blocksize; ++i)
        chan[1][i] = chan[0][i] - chan[1][i];
    } else if (ch_asgn == 9) {  // right/side: L = R + S
      for (int i = 0; i < blocksize; ++i) {
        int64_t side = chan[0][i];
        chan[0][i] = chan[1][i] + side;
      }
    } else if (ch_asgn == 10) {  // mid/side
      for (int i = 0; i < blocksize; ++i) {
        int64_t side = chan[1][i];
        int64_t mid = ((int64_t)((uint64_t)chan[0][i] << 1)) | (side & 1);
        chan[0][i] = (mid + side) >> 1;
        chan[1][i] = (mid - side) >> 1;
      }
    }
    for (int c = 0; c < channels; ++c) {
      auto& dst = pcm[c];
      const int64_t* src = chan[c].data();
      size_t base = dst.size();
      dst.resize(base + blocksize);
      float* outp = dst.data() + base;
      const float fscale = (float)scale;
      for (int i = 0; i < blocksize; ++i)
        outp[i] = (float)src[i] * fscale;
    }
  }

  uint64_t n = pcm[0].size();
  if (total_samples && n > total_samples) n = total_samples;
  if (n == 0) return -8;
  float* out = (float*)malloc(sizeof(float) * n * channels);
  if (!out) return -9;
  if (channels == 1) {
    memcpy(out, pcm[0].data(), sizeof(float) * n);
  } else {
    for (uint64_t i = 0; i < n; ++i)
      for (int c = 0; c < channels; ++c) out[i * channels + c] = pcm[c][i];
  }
  *out_samples = out;
  *out_frames = (int64_t)n;
  *out_channels = channels;
  *out_rate = sample_rate;
  return 0;
}

}  // extern "C"
