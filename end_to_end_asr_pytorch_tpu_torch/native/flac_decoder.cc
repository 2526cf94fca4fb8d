// Native FLAC decoder (subset sufficient for LibriSpeech and general
// 8/16/24-bit fixed-blocksize streams): STREAMINFO parsing, frame decoding
// with constant/verbatim/fixed/LPC subframes, Rice residuals, and
// left-side/right-side/mid-side stereo reconstruction. CRCs are not verified
// (decode-for-training, not validation).
//
// The reference relied on torchaudio/sox for FLAC decode (SURVEY.md 2.12);
// this replaces that dependency. The port's own copy of the JAX package's
// native/flac_decoder.cc, built by utils/native.py. Exposed via ctypes:
//   flac_decode(path, out_samples**, out_n*, out_sr*, out_ch*) -> 0 on ok
//   flac_free(ptr)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

class BitReader {
 public:
  BitReader(const uint8_t* data, size_t size) : data_(data), size_(size) {}

  bool ok() const { return !error_; }
  size_t byte_pos() const { return pos_; }

  uint32_t read_bits(int n) {  // n <= 32
    uint32_t v = 0;
    for (int i = 0; i < n; ++i) v = (v << 1) | read_bit();
    return v;
  }

  uint64_t read_bits64(int n) {
    uint64_t v = 0;
    for (int i = 0; i < n; ++i) v = (v << 1) | read_bit();
    return v;
  }

  int64_t read_signed(int n) {
    uint64_t v = read_bits64(n);
    if (n == 0) return 0;
    uint64_t sign = 1ULL << (n - 1);
    return (v & sign) ? (int64_t)(v | ~((sign << 1) - 1)) : (int64_t)v;
  }

  uint32_t read_unary() {
    uint32_t q = 0;
    while (ok() && read_bit() == 0) ++q;
    return q;
  }

  void align_byte() { bit_ = 0; }

  void seek(size_t byte) {  // reposition to a byte boundary
    if (byte > size_) { error_ = true; return; }
    pos_ = byte;
    bit_ = 0;
  }

  int read_bit() {
    if (bit_ == 0) {
      if (pos_ >= size_) {
        error_ = true;
        return 0;
      }
      cur_ = data_[pos_++];
      bit_ = 8;
    }
    --bit_;
    return (cur_ >> bit_) & 1;
  }

 private:
  const uint8_t* data_;
  size_t size_;
  size_t pos_ = 0;
  uint8_t cur_ = 0;
  int bit_ = 0;  // bits remaining in cur_
  bool error_ = false;
};

// UTF-8-style coded number used for frame/sample index (up to 36 bits).
uint64_t read_utf8(BitReader& br) {
  uint32_t b0 = br.read_bits(8);
  if (b0 < 0x80) return b0;
  int n = 0;
  uint8_t mask = 0x40;
  while (b0 & mask) {
    ++n;
    mask >>= 1;
  }
  uint64_t v = b0 & (mask - 1);
  for (int i = 0; i < n; ++i) v = (v << 6) | (br.read_bits(8) & 0x3F);
  return v;
}

const int kFixedOrderMax = 4;

bool decode_residual(BitReader& br, int blocksize, int pred_order,
                     std::vector<int64_t>& out) {
  uint32_t method = br.read_bits(2);
  if (method > 1) return false;
  int plen = method == 0 ? 4 : 5;
  uint32_t escape = method == 0 ? 0xF : 0x1F;
  uint32_t porder = br.read_bits(4);
  uint32_t nparts = 1u << porder;
  int idx = pred_order;
  for (uint32_t p = 0; p < nparts; ++p) {
    int count = blocksize >> porder;
    if (p == 0) count -= pred_order;
    if (count < 0) return false;
    uint32_t rice = br.read_bits(plen);
    if (rice == escape) {
      uint32_t bits = br.read_bits(5);
      for (int i = 0; i < count; ++i) out[idx++] = br.read_signed(bits);
    } else {
      for (int i = 0; i < count; ++i) {
        uint32_t q = br.read_unary();
        uint64_t r = br.read_bits64(rice);
        uint64_t u = ((uint64_t)q << rice) | r;
        out[idx++] = (u & 1) ? -(int64_t)(u >> 1) - 1 : (int64_t)(u >> 1);
      }
    }
    if (!br.ok()) return false;
  }
  return true;
}

bool decode_subframe(BitReader& br, int blocksize, int bps,
                     std::vector<int64_t>& out) {
  if (br.read_bits(1) != 0) return false;  // zero pad bit
  uint32_t type = br.read_bits(6);
  int wasted = 0;
  if (br.read_bits(1)) wasted = 1 + (int)br.read_unary();
  bps -= wasted;
  out.assign(blocksize, 0);

  if (type == 0) {  // CONSTANT
    int64_t v = br.read_signed(bps);
    for (int i = 0; i < blocksize; ++i) out[i] = v;
  } else if (type == 1) {  // VERBATIM
    for (int i = 0; i < blocksize; ++i) out[i] = br.read_signed(bps);
  } else if (type >= 8 && type <= 8 + kFixedOrderMax) {  // FIXED
    int order = type - 8;
    for (int i = 0; i < order; ++i) out[i] = br.read_signed(bps);
    if (!decode_residual(br, blocksize, order, out)) return false;
    for (int i = order; i < blocksize; ++i) {
      switch (order) {
        case 0: break;
        case 1: out[i] += out[i - 1]; break;
        case 2: out[i] += 2 * out[i - 1] - out[i - 2]; break;
        case 3: out[i] += 3 * out[i - 1] - 3 * out[i - 2] + out[i - 3]; break;
        case 4: out[i] += 4 * out[i - 1] - 6 * out[i - 2] + 4 * out[i - 3]
                          - out[i - 4]; break;
      }
    }
  } else if (type >= 32) {  // LPC
    int order = (int)type - 31;
    for (int i = 0; i < order; ++i) out[i] = br.read_signed(bps);
    int precision = (int)br.read_bits(4) + 1;
    if (precision == 16) return false;  // 0b1111 invalid
    int shift = (int)br.read_signed(5);
    if (shift < 0) shift = 0;
    std::vector<int64_t> coef(order);
    for (int i = 0; i < order; ++i) coef[i] = br.read_signed(precision);
    if (!decode_residual(br, blocksize, order, out)) return false;
    for (int i = order; i < blocksize; ++i) {
      int64_t acc = 0;
      for (int j = 0; j < order; ++j) acc += coef[j] * out[i - 1 - j];
      out[i] += acc >> shift;
    }
  } else {
    return false;
  }
  if (wasted > 0)
    for (int i = 0; i < blocksize; ++i) out[i] <<= wasted;
  return br.ok();
}

}  // namespace

extern "C" {

// Decodes a FLAC file to interleaved float32 in [-1, 1].
// Returns 0 on success; caller frees *out with flac_free.
int flac_decode(const char* path, float** out, int64_t* out_n,
                int32_t* out_sr, int32_t* out_ch) {
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

  size_t pos = 4;
  int sr = 0, channels = 0, bps = 0;
  uint64_t total_samples = 0;
  bool last = false;
  while (!last && pos + 4 <= (size_t)fsize) {
    uint8_t hdr = buf[pos];
    last = hdr & 0x80;
    int btype = hdr & 0x7F;
    uint32_t blen = (buf[pos + 1] << 16) | (buf[pos + 2] << 8) | buf[pos + 3];
    pos += 4;
    if (btype == 0 && blen >= 34) {  // STREAMINFO
      const uint8_t* si = buf.data() + pos;
      sr = (si[10] << 12) | (si[11] << 4) | (si[12] >> 4);
      channels = ((si[12] >> 1) & 0x7) + 1;
      bps = (((si[12] & 1) << 4) | (si[13] >> 4)) + 1;
      // cast every byte before shifting: si[14] << 24 as a signed int
      // goes negative for byte values >= 0x80 and would sign-extend
      // through the uint64 OR (total_samples ~1.8e19 -> bad_alloc)
      total_samples = ((uint64_t)(si[13] & 0xF) << 32)
                      | ((uint64_t)si[14] << 24) | ((uint64_t)si[15] << 16)
                      | ((uint64_t)si[16] << 8) | (uint64_t)si[17];
    }
    pos += blen;
  }
  if (sr == 0 || channels == 0 || bps == 0) return -4;

  std::vector<float> pcm;
  if (total_samples) pcm.reserve(total_samples * channels);

  BitReader br(buf.data() + pos, fsize - pos);
  std::vector<std::vector<int64_t>> ch(channels);
  const float scale = 1.0f / (float)(1u << (bps - 1));

  while (br.ok()) {
    // find frame sync (aligned on byte boundary). On mismatch, rescan
    // from the NEXT byte: the naive align-and-continue advanced 2 bytes
    // per attempt (14-bit read + byte realign) and could step over every
    // odd-offset sync code forever, silently truncating the audio.
    br.align_byte();
    size_t sync_start = br.byte_pos();
    uint32_t sync = br.read_bits(14);
    if (!br.ok()) break;
    if (sync != 0x3FFE) {  // resync scan, 1-byte stride
      br.seek(sync_start + 1);
      continue;
    }
    br.read_bits(1);                        // reserved
    br.read_bits(1);                        // blocking strategy
    uint32_t bs_code = br.read_bits(4);
    uint32_t sr_code = br.read_bits(4);
    uint32_t ch_asgn = br.read_bits(4);
    uint32_t ss_code = br.read_bits(3);
    br.read_bits(1);                        // reserved
    read_utf8(br);                          // frame/sample number

    int blocksize;
    switch (bs_code) {
      case 1: blocksize = 192; break;
      case 2: case 3: case 4: case 5:
        blocksize = 576 << (bs_code - 2); break;
      case 6: blocksize = (int)br.read_bits(8) + 1; break;
      case 7: blocksize = (int)br.read_bits(16) + 1; break;
      default:
        blocksize = bs_code >= 8 ? 256 << (bs_code - 8) : 0;
    }
    if (blocksize <= 0) return -5;
    if (sr_code == 12) br.read_bits(8);
    else if (sr_code == 13 || sr_code == 14) br.read_bits(16);
    int fbps = bps;
    switch (ss_code) {
      case 1: fbps = 8; break;
      case 2: fbps = 12; break;
      case 4: fbps = 16; break;
      case 5: fbps = 20; break;
      case 6: fbps = 24; break;
      case 7: fbps = 32; break;
      default: break;  // 0 = from STREAMINFO
    }
    br.read_bits(8);  // CRC-8

    int nch = channels;
    if (ch_asgn <= 7) {
      nch = (int)ch_asgn + 1;
      if (nch != channels) return -6;
      for (int c = 0; c < nch; ++c)
        if (!decode_subframe(br, blocksize, fbps, ch[c])) return -7;
    } else if (ch_asgn == 8) {  // left-side
      if (channels != 2) return -6;
      if (!decode_subframe(br, blocksize, fbps, ch[0])) return -7;
      if (!decode_subframe(br, blocksize, fbps + 1, ch[1])) return -7;
      for (int i = 0; i < blocksize; ++i) ch[1][i] = ch[0][i] - ch[1][i];
    } else if (ch_asgn == 9) {  // right-side
      if (channels != 2) return -6;
      if (!decode_subframe(br, blocksize, fbps + 1, ch[0])) return -7;
      if (!decode_subframe(br, blocksize, fbps, ch[1])) return -7;
      for (int i = 0; i < blocksize; ++i) ch[0][i] = ch[0][i] + ch[1][i];
    } else if (ch_asgn == 10) {  // mid-side
      if (channels != 2) return -6;
      if (!decode_subframe(br, blocksize, fbps, ch[0])) return -7;
      if (!decode_subframe(br, blocksize, fbps + 1, ch[1])) return -7;
      for (int i = 0; i < blocksize; ++i) {
        int64_t side = ch[1][i];
        int64_t mid = (ch[0][i] << 1) | (side & 1);
        ch[0][i] = (mid + side) >> 1;
        ch[1][i] = (mid - side) >> 1;
      }
    } else {
      return -6;
    }
    br.align_byte();
    br.read_bits(16);  // CRC-16

    for (int i = 0; i < blocksize; ++i)
      for (int c = 0; c < channels; ++c)
        pcm.push_back((float)ch[c][i] * scale);
    if (total_samples && pcm.size() >= total_samples * channels) break;
  }

  if (total_samples && pcm.size() > total_samples * channels)
    pcm.resize(total_samples * channels);
  float* mem = (float*)malloc(pcm.size() * sizeof(float));
  if (!mem) return -8;
  memcpy(mem, pcm.data(), pcm.size() * sizeof(float));
  *out = mem;
  *out_n = (int64_t)(pcm.size() / channels);
  *out_sr = sr;
  *out_ch = channels;
  return 0;
}

void flac_free(float* p) { free(p); }

}  // extern "C"
