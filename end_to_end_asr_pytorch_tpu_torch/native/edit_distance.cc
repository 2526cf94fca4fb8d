// Levenshtein distance over int32 token sequences, the port's copy of the
// JAX package's native/edit_distance.cc, built at first use and bound by
// utils/native.py (ctypes). utils/metrics.py scores WER and CER with it:
// the tokens are words or characters mapped to ids by the binding.
//
//   int32_t edit_distance(a, la, b, lb): two-row dynamic programme.
//   void edit_distance_batch(tokens_a, len_a, tokens_b, len_b, n, out):
//       n pairs in one call, each side's sequences back to back with their
//       lengths in len_a / len_b; distances into out[0..n).

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

int32_t edit_distance(const int32_t* a, int32_t la,
                      const int32_t* b, int32_t lb) {
  if (la < lb) {
    std::swap(a, b);
    std::swap(la, lb);
  }
  if (lb == 0) return la;
  std::vector<int32_t> prev(lb + 1), cur(lb + 1);
  for (int32_t j = 0; j <= lb; ++j) prev[j] = j;
  for (int32_t i = 1; i <= la; ++i) {
    cur[0] = i;
    const int32_t ca = a[i - 1];
    for (int32_t j = 1; j <= lb; ++j) {
      const int32_t sub = prev[j - 1] + (ca != b[j - 1]);
      cur[j] = std::min({prev[j] + 1, cur[j - 1] + 1, sub});
    }
    std::swap(prev, cur);
  }
  return prev[lb];
}

void edit_distance_batch(const int32_t* tokens_a, const int32_t* len_a,
                         const int32_t* tokens_b, const int32_t* len_b,
                         int32_t n, int32_t* out) {
  int64_t off_a = 0, off_b = 0;
  for (int32_t i = 0; i < n; ++i) {
    out[i] = edit_distance(tokens_a + off_a, len_a[i], tokens_b + off_b,
                           len_b[i]);
    off_a += len_a[i];
    off_b += len_b[i];
  }
}

}  // extern "C"
