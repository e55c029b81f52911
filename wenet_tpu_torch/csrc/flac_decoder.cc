// FLAC decoder (from scratch, no libFLAC) for the data pipeline.  The
// port's copy of wenet_tpu/runtime/cpp/flac_decoder.cc.
//
// The reference decodes flac through torchaudio/sox, which the port does
// not depend on, and LibriSpeech-family corpora ship 16 kHz mono 16-bit
// flac.  This implements the FLAC bitstream per the public format spec
// (https://xiph.org/flac/format.html): metadata blocks, frame +
// subframe headers, constant / verbatim / fixed(0-4) / LPC subframes,
// partitioned Rice residuals (methods 0 and 1, incl. escape codes),
// wasted bits, and the four channel assignments (independent,
// left/side, right/side, mid/side).  CRCs are not verified (the data
// pipeline treats a malformed file as a hard error either way).
//
// C API (ctypes, wenet_tpu_torch/dataset/audio.py read_flac):
//   flac_decode(data, size, &samples, &frames, &channels, &rate, &bps)
//     samples: malloc'd interleaved int32, caller frees via flac_free.
//   flac_info(data, size, &frames, &channels, &rate, &bps) reads
//     STREAMINFO only.
//   returns 0 on success, negative error codes otherwise.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t byte = 0;
  int bit = 0;  // bits consumed of current byte (0..7)
  bool fail = false;

  BitReader(const uint8_t* d, size_t s) : data(d), size(s) {}

  bool eof() const { return byte >= size; }

  uint32_t bits(int n) {  // n in 0..32, MSB first
    uint32_t v = 0;
    while (n > 0) {
      if (byte >= size) { fail = true; return 0; }
      int avail = 8 - bit;
      int take = n < avail ? n : avail;
      uint32_t chunk = (data[byte] >> (avail - take)) & ((1u << take) - 1);
      v = (v << take) | chunk;
      bit += take;
      n -= take;
      if (bit == 8) { bit = 0; ++byte; }
    }
    return v;
  }

  int64_t sbits(int n) {  // signed two's complement, n in 1..32
    uint32_t v = bits(n);
    if (n < 32 && (v & (1u << (n - 1)))) {
      return (int64_t)v - ((int64_t)1 << n);
    }
    return (int64_t)(n == 32 ? (int32_t)v : (int32_t)v);
  }

  uint32_t unary() {  // count zeros up to the terminating 1
    uint32_t q = 0;
    for (;;) {
      if (byte >= size) { fail = true; return 0; }
      if (bits(1)) return q;
      ++q;
      if (q > 1u << 24) { fail = true; return 0; }  // corrupt stream
    }
  }

  void align() {
    if (bit) { bit = 0; ++byte; }
  }

  // UTF-8-style coded number used for frame/sample numbers (up to 56
  // bits, wider than real UTF-8)
  bool coded_number(uint64_t* out) {
    uint32_t b0 = bits(8);
    if (fail) return false;
    int extra;
    uint64_t v;
    if ((b0 & 0x80) == 0) { *out = b0; return true; }
    else if ((b0 & 0xE0) == 0xC0) { extra = 1; v = b0 & 0x1F; }
    else if ((b0 & 0xF0) == 0xE0) { extra = 2; v = b0 & 0x0F; }
    else if ((b0 & 0xF8) == 0xF0) { extra = 3; v = b0 & 0x07; }
    else if ((b0 & 0xFC) == 0xF8) { extra = 4; v = b0 & 0x03; }
    else if ((b0 & 0xFE) == 0xFC) { extra = 5; v = b0 & 0x01; }
    else if (b0 == 0xFE) { extra = 6; v = 0; }
    else return false;
    for (int i = 0; i < extra; ++i) {
      uint32_t b = bits(8);
      if (fail || (b & 0xC0) != 0x80) return false;
      v = (v << 6) | (b & 0x3F);
    }
    *out = v;
    return true;
  }
};

// -------- residual: partitioned Rice ---------------------------------
bool read_residual(BitReader& br, int pred_order, int block_size,
                   int64_t* out /* block_size entries, fill from
                                   pred_order */) {
  uint32_t method = br.bits(2);
  if (method > 1) return false;
  int plen = method == 0 ? 4 : 5;
  uint32_t escape = method == 0 ? 0x0F : 0x1F;
  uint32_t part_order = br.bits(4);
  uint32_t parts = 1u << part_order;
  if (block_size % parts != 0) return false;
  int psize = block_size >> part_order;
  if (psize <= pred_order && parts == 1) return false;
  int idx = pred_order;
  for (uint32_t p = 0; p < parts; ++p) {
    int n = psize - (p == 0 ? pred_order : 0);
    if (n < 0) return false;
    uint32_t rice = br.bits(plen);
    if (br.fail) return false;
    if (rice == escape) {
      uint32_t raw = br.bits(5);
      for (int i = 0; i < n; ++i) {
        out[idx++] = raw ? br.sbits((int)raw) : 0;
      }
    } else {
      for (int i = 0; i < n; ++i) {
        uint32_t q = br.unary();
        uint32_t r = rice ? br.bits((int)rice) : 0;
        uint64_t u = ((uint64_t)q << rice) | r;
        // zigzag: even -> u/2, odd -> -(u/2)-1
        out[idx++] = (u & 1) ? -((int64_t)(u >> 1)) - 1
                             : (int64_t)(u >> 1);
      }
    }
    if (br.fail) return false;
  }
  return idx == block_size;
}

// -------- subframe ----------------------------------------------------
bool read_subframe(BitReader& br, int block_size, int bps,
                   int64_t* out) {
  if (br.bits(1) != 0) return false;  // padding bit
  uint32_t type = br.bits(6);
  int wasted = 0;
  if (br.bits(1)) {  // wasted-bits-per-sample flag: unary count - 1
    wasted = 1 + (int)br.unary();
  }
  if (br.fail) return false;
  bps -= wasted;
  if (bps <= 0 || bps > 33) return false;

  if (type == 0) {  // CONSTANT
    int64_t v = br.sbits(bps);
    for (int i = 0; i < block_size; ++i) out[i] = v;
  } else if (type == 1) {  // VERBATIM
    for (int i = 0; i < block_size; ++i) out[i] = br.sbits(bps);
  } else if ((type & 0x38) == 0x08 && (type & 0x07) <= 4) {  // FIXED
    int order = type & 0x07;
    for (int i = 0; i < order; ++i) out[i] = br.sbits(bps);
    if (!read_residual(br, order, block_size, out)) return false;
    // polynomial predictors, residual already in out[order..]
    for (int i = order; i < block_size; ++i) {
      int64_t p = 0;
      switch (order) {
        case 0: p = 0; break;
        case 1: p = out[i - 1]; break;
        case 2: p = 2 * out[i - 1] - out[i - 2]; break;
        case 3: p = 3 * out[i - 1] - 3 * out[i - 2] + out[i - 3]; break;
        case 4: p = 4 * out[i - 1] - 6 * out[i - 2] + 4 * out[i - 3]
                     - out[i - 4]; break;
      }
      out[i] += p;
    }
  } else if (type & 0x20) {  // LPC
    int order = (int)(type & 0x1F) + 1;
    for (int i = 0; i < order; ++i) out[i] = br.sbits(bps);
    uint32_t prec = br.bits(4);
    if (prec == 0x0F || br.fail) return false;
    int precision = (int)prec + 1;
    int shift = (int)br.sbits(5);
    if (shift < 0) return false;
    int32_t coef[32];
    for (int i = 0; i < order; ++i) {
      coef[i] = (int32_t)br.sbits(precision);
    }
    if (!read_residual(br, order, block_size, out)) return false;
    for (int i = order; i < block_size; ++i) {
      int64_t p = 0;
      for (int j = 0; j < order; ++j) {
        p += (int64_t)coef[j] * out[i - 1 - j];
      }
      out[i] += p >> shift;
    }
  } else {
    return false;  // reserved type
  }
  if (br.fail) return false;
  if (wasted) {
    for (int i = 0; i < block_size; ++i) out[i] <<= wasted;
  }
  return true;
}

const int kBlockSizes[16] = {0, 192, 576, 1152, 2304, 4608, -1, -2,
                             256, 512, 1024, 2048, 4096, 8192, 16384,
                             32768};
const int kSampleRates[16] = {0, 88200, 176400, 192000, 8000, 16000,
                              22050, 24000, 32000, 44100, 48000, 96000,
                              -1, -2, -3, -4};

}  // namespace

extern "C" {

void flac_free(int32_t* p) { free(p); }

// returns 0 ok; -1 bad magic; -2 bad metadata; -3 bad frame;
// -4 alloc failure
int flac_decode(const uint8_t* data, size_t size, int32_t** out_samples,
                int64_t* out_frames, int* out_channels, int* out_rate,
                int* out_bps) {
  *out_samples = nullptr;
  *out_frames = 0;
  if (size < 42 || memcmp(data, "fLaC", 4) != 0) return -1;
  size_t pos = 4;
  int si_rate = 0, si_channels = 0, si_bps = 0;
  uint64_t si_total = 0;
  bool have_streaminfo = false, last = false;
  while (!last) {
    if (pos + 4 > size) return -2;
    last = data[pos] & 0x80;
    int type = data[pos] & 0x7F;
    uint32_t len = ((uint32_t)data[pos + 1] << 16) |
                   ((uint32_t)data[pos + 2] << 8) | data[pos + 3];
    pos += 4;
    if (pos + len > size) return -2;
    if (type == 0 && len >= 34) {  // STREAMINFO
      const uint8_t* p = data + pos;
      si_rate = ((int)p[10] << 12) | ((int)p[11] << 4) | (p[12] >> 4);
      si_channels = ((p[12] >> 1) & 0x07) + 1;
      si_bps = (((int)(p[12] & 1) << 4) | (p[13] >> 4)) + 1;
      si_total = (((uint64_t)(p[13] & 0x0F)) << 32) |
                 ((uint64_t)p[14] << 24) | ((uint64_t)p[15] << 16) |
                 ((uint64_t)p[16] << 8) | p[17];
      have_streaminfo = true;
    }
    pos += len;
  }
  if (!have_streaminfo || si_rate <= 0 || si_channels <= 0) return -2;

  std::vector<int32_t> pcm;
  if (si_total) pcm.reserve((size_t)si_total * si_channels);
  BitReader br(data + pos, size - pos);
  std::vector<int64_t> ch[8];

  while (true) {
    // skip to next frame sync; a clean stream is already aligned
    br.align();
    if (br.byte >= br.size) break;
    uint32_t sync = br.bits(14);
    if (br.fail) break;
    if (sync != 0x3FFE) return -3;
    br.bits(1);                       // reserved
    br.bits(1);                       // blocking strategy
    uint32_t bs_code = br.bits(4);
    uint32_t sr_code = br.bits(4);
    uint32_t ch_code = br.bits(4);
    uint32_t ss_code = br.bits(3);
    br.bits(1);                       // reserved
    uint64_t dummy;
    if (!br.coded_number(&dummy)) return -3;
    int block_size;
    if (bs_code == 0) return -3;
    else if (bs_code == 6) block_size = (int)br.bits(8) + 1;
    else if (bs_code == 7) block_size = (int)br.bits(16) + 1;
    else block_size = kBlockSizes[bs_code];
    if (sr_code == 12) br.bits(8);
    else if (sr_code == 13 || sr_code == 14) br.bits(16);
    else if (sr_code == 15) return -3;
    int bps = si_bps;
    switch (ss_code) {
      case 0: break;  // from STREAMINFO
      case 1: bps = 8; break;
      case 2: bps = 12; break;
      case 4: bps = 16; break;
      case 5: bps = 20; break;
      case 6: bps = 24; break;
      case 7: bps = 32; break;
      default: return -3;
    }
    br.bits(8);  // CRC-8
    if (br.fail) return -3;

    int nch;
    if (ch_code < 8) nch = (int)ch_code + 1;
    else if (ch_code <= 10) nch = 2;
    else return -3;
    if (nch != si_channels) return -3;

    for (int c = 0; c < nch; ++c) {
      int sub_bps = bps;
      // side channel carries one extra bit
      if ((ch_code == 8 && c == 1) || (ch_code == 9 && c == 0) ||
          (ch_code == 10 && c == 1)) {
        sub_bps += 1;
      }
      ch[c].assign(block_size, 0);
      if (!read_subframe(br, block_size, sub_bps, ch[c].data())) {
        return -3;
      }
    }
    br.align();
    br.bits(16);  // frame CRC-16

    // undo inter-channel decorrelation
    if (ch_code == 8) {  // left/side: right = left - side
      for (int i = 0; i < block_size; ++i) {
        ch[1][i] = ch[0][i] - ch[1][i];
      }
    } else if (ch_code == 9) {  // right/side: left = right + side
      for (int i = 0; i < block_size; ++i) {
        ch[0][i] = ch[1][i] + ch[0][i];
      }
    } else if (ch_code == 10) {  // mid/side
      for (int i = 0; i < block_size; ++i) {
        int64_t side = ch[1][i];
        int64_t mid = (ch[0][i] << 1) | (side & 1);
        ch[0][i] = (mid + side) >> 1;
        ch[1][i] = (mid - side) >> 1;
      }
    }
    for (int i = 0; i < block_size; ++i) {
      for (int c = 0; c < nch; ++c) {
        pcm.push_back((int32_t)ch[c][i]);
      }
    }
    if (si_total && pcm.size() >= (size_t)si_total * si_channels) break;
  }

  if (si_total && pcm.size() > (size_t)si_total * si_channels) {
    pcm.resize((size_t)si_total * si_channels);  // drop end padding
  }
  int64_t frames = (int64_t)(pcm.size() / si_channels);
  int32_t* buf = (int32_t*)malloc(pcm.size() * sizeof(int32_t));
  if (!buf && !pcm.empty()) return -4;
  memcpy(buf, pcm.data(), pcm.size() * sizeof(int32_t));
  *out_samples = buf;
  *out_frames = frames;
  *out_channels = si_channels;
  *out_rate = si_rate;
  *out_bps = si_bps;
  return 0;
}

// STREAMINFO only (duration probes, wav_info analog)
int flac_info(const uint8_t* data, size_t size, int64_t* out_frames,
              int* out_channels, int* out_rate, int* out_bps) {
  if (size < 42 || memcmp(data, "fLaC", 4) != 0) return -1;
  const uint8_t* p = data + 8;  // first block header is at 4, len 4
  if ((data[4] & 0x7F) != 0) return -2;  // STREAMINFO must be first
  *out_rate = ((int)p[10] << 12) | ((int)p[11] << 4) | (p[12] >> 4);
  *out_channels = ((p[12] >> 1) & 0x07) + 1;
  *out_bps = (((int)(p[12] & 1) << 4) | (p[13] >> 4)) + 1;
  *out_frames = (int64_t)((((uint64_t)(p[13] & 0x0F)) << 32) |
                          ((uint64_t)p[14] << 24) |
                          ((uint64_t)p[15] << 16) |
                          ((uint64_t)p[16] << 8) | p[17]);
  return 0;
}

}  // extern "C"
