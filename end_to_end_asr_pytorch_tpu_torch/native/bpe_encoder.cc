// BPE encoder: greedy lowest-rank merges over the JSON BPE model of
// utils/text.py (SubwordTextEncoder), the port's copy of the JAX package's
// native/bpe_encoder.cc, built at first use and bound by utils/native.py.
//
// Differences from that source, each of which could make it disagree with
// SubwordTextEncoder.encode_py:
//   - every string crosses with its byte length, so a NUL byte is an
//     ordinary byte of a word and not the end of the text;
//   - pieces are interned as ids and a merge is keyed on the pair of ids,
//     so no separator byte inside a piece can make two pairs collide;
//   - words are split on the space byte alone: the binding passes
//     " ".join(text.split()), so the words are those of Python's
//     str.split() (tabs, newlines, NBSP, U+3000 and the rest).
// A model is not written after bpe_create returns, so several threads may
// call bpe_encode on one handle at once (ctypes releases the GIL).
//
// C interface (ctypes):
//   void* bpe_create(vocab, vocab_off, n_vocab, merge_a, a_off, merge_b,
//                    b_off, n_merges, unk_id)
//       each string table is one buffer of UTF-8 bytes with n + 1 int64
//       offsets (string i is [off[i], off[i + 1])); merge i has rank i,
//       and a later duplicate replaces an earlier one, as in a Python dict.
//   int32_t bpe_encode(h, text, n_bytes, out, max_out)
//       the ids of the words of text (no <eos>) and their count, or minus
//       the count if max_out is too small. One id per code point at most.
//   void bpe_destroy(h)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr const char* kBoundary = "\xE2\x96\x81";  // U+2581

struct Merge {
  int32_t rank;
  int32_t merged;  // interned id of a + b
};

struct BpeModel {
  std::unordered_map<std::string, int32_t> intern;  // piece -> interned id
  std::vector<int32_t> vocab_id;                    // interned id -> id
  std::unordered_map<uint64_t, Merge> merges;       // (a, b) -> merge
  int32_t unk;

  int32_t add(const std::string& s) {
    auto it = intern.emplace(s, (int32_t)vocab_id.size());
    if (it.second) vocab_id.push_back(unk);
    return it.first->second;
  }
  int32_t find(const std::string& s) const {
    auto it = intern.find(s);
    return it == intern.end() ? -1 : it->second;
  }
};

uint64_t pair_key(int32_t a, int32_t b) {
  return ((uint64_t)(uint32_t)a << 32) | (uint32_t)b;
}

std::string slice(const char* buf, const int64_t* off, int32_t i) {
  return std::string(buf + off[i], (size_t)(off[i + 1] - off[i]));
}

// byte length of the UTF-8 sequence that starts with c
size_t utf8_len(unsigned char c) {
  return c < 0x80 ? 1 : (c >> 5) == 0x6 ? 2 : (c >> 4) == 0xE ? 3 : 4;
}

void encode_word(const BpeModel& m, const char* w, size_t n,
                 std::vector<int32_t>* ids) {
  std::vector<int32_t> pieces;  // interned ids, -1 for a piece not interned
  std::string piece;
  for (size_t i = 0; i < n;) {
    size_t len = std::min(utf8_len((unsigned char)w[i]), n - i);
    piece.assign(i == 0 ? kBoundary : "");
    piece.append(w + i, len);
    pieces.push_back(m.find(piece));
    i += len;
  }
  while (pieces.size() > 1) {
    int best = -1;
    const Merge* best_merge = nullptr;
    for (size_t i = 0; i + 1 < pieces.size(); ++i) {
      if (pieces[i] < 0 || pieces[i + 1] < 0) continue;
      auto it = m.merges.find(pair_key(pieces[i], pieces[i + 1]));
      if (it != m.merges.end() &&
          (best_merge == nullptr || it->second.rank < best_merge->rank)) {
        best = (int)i;
        best_merge = &it->second;
      }
    }
    if (best < 0) break;
    pieces[best] = best_merge->merged;
    pieces.erase(pieces.begin() + best + 1);
  }
  for (int32_t p : pieces) ids->push_back(p < 0 ? m.unk : m.vocab_id[p]);
}

}  // namespace

extern "C" {

void* bpe_create(const char* vocab, const int64_t* vocab_off, int32_t n_vocab,
                 const char* merge_a, const int64_t* a_off,
                 const char* merge_b, const int64_t* b_off, int32_t n_merges,
                 int32_t unk_id) {
  auto* m = new BpeModel();
  m->unk = unk_id;
  for (int32_t i = 0; i < n_vocab; ++i)
    m->vocab_id[m->add(slice(vocab, vocab_off, i))] = i;
  for (int32_t i = 0; i < n_merges; ++i) {
    std::string a = slice(merge_a, a_off, i), b = slice(merge_b, b_off, i);
    int32_t ia = m->add(a), ib = m->add(b);
    int32_t merged = m->add(a + b);
    m->merges[pair_key(ia, ib)] = Merge{i, merged};
  }
  return m;
}

void bpe_destroy(void* h) { delete static_cast<BpeModel*>(h); }

int32_t bpe_encode(const void* h, const char* text, int64_t n_bytes,
                   int32_t* out, int32_t max_out) {
  const auto& m = *static_cast<const BpeModel*>(h);
  std::vector<int32_t> ids;
  int64_t pos = 0;
  while (pos < n_bytes) {
    while (pos < n_bytes && text[pos] == ' ') ++pos;
    int64_t end = pos;
    while (end < n_bytes && text[end] != ' ') ++end;
    if (end > pos) encode_word(m, text + pos, (size_t)(end - pos), &ids);
    pos = end;
  }
  if ((int64_t)ids.size() > max_out) return -(int32_t)ids.size();
  if (!ids.empty()) std::memcpy(out, ids.data(), ids.size() * sizeof(int32_t));
  return (int32_t)ids.size();
}

}  // extern "C"
