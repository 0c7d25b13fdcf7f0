// Native greedy score-BPE merge engine.
//
// TPU-native counterpart of the reference's vendored tokenizer hot loop
// (kuiper/include/base/tiktoken.h:17-92 `_byte_pair_merge`; sentencepiece
// linked for Llama-2). The Python tokenizer handles vocab parsing and
// byte-fallback; this engine runs the merge loop — repeatedly fusing the
// adjacent pair whose concatenation is the highest-score piece — in
// O(n log n) with a lazy-invalidation heap instead of the O(n^2) rescan.
//
// Tie-break matches the Python oracle: strictly-greater score wins, equal
// scores keep the leftmost (earlier position) pair.
//
// C ABI only — consumed through ctypes.

#include <cstdint>
#include <cstring>
#include <queue>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Engine {
  std::vector<std::string> pieces;
  std::vector<float> scores;
  std::unordered_map<std::string, int32_t> piece_to_id;
};

struct Cand {
  float score;
  int32_t pos;     // left symbol index at push time
  int32_t merged;  // resulting piece id
  uint32_t stamp;  // left symbol's version at push time
};

struct CandLess {
  // max-heap by score; on ties, LEFTMOST pos wins
  bool operator()(const Cand& a, const Cand& b) const {
    if (a.score != b.score) return a.score < b.score;
    return a.pos > b.pos;
  }
};

}  // namespace

extern "C" {

void* spm_create(const char* const* pieces, const int32_t* lens,
                 const float* scores, int32_t n) {
  Engine* e = new Engine;
  e->pieces.reserve(n);
  e->scores.assign(scores, scores + n);
  for (int32_t i = 0; i < n; ++i) {
    e->pieces.emplace_back(pieces[i], lens[i]);
    e->piece_to_id.emplace(e->pieces.back(), i);
  }
  return e;
}

void spm_destroy(void* h) { delete static_cast<Engine*>(h); }

// In-place greedy merge of the symbol sequence `ids[0..n)`. Returns the
// merged length (ids compacted to the front).
int32_t spm_merge(void* h, int32_t* ids, int32_t n) {
  Engine* e = static_cast<Engine*>(h);
  if (n <= 1) return n;

  std::vector<int32_t> next(n), prev(n);
  std::vector<uint32_t> stamp(n, 0);
  std::vector<int32_t> sym(ids, ids + n);
  for (int32_t i = 0; i < n; ++i) {
    next[i] = i + 1 < n ? i + 1 : -1;
    prev[i] = i - 1;
  }

  std::priority_queue<Cand, std::vector<Cand>, CandLess> heap;
  auto try_push = [&](int32_t pos) {
    int32_t nx = next[pos];
    if (pos < 0 || nx < 0) return;
    const std::string& a = e->pieces[sym[pos]];
    const std::string& b = e->pieces[sym[nx]];
    auto it = e->piece_to_id.find(a + b);
    if (it == e->piece_to_id.end()) return;
    heap.push(Cand{e->scores[it->second], pos, it->second, stamp[pos]});
  };
  for (int32_t i = 0; i + 1 < n; ++i) try_push(i);

  while (!heap.empty()) {
    Cand c = heap.top();
    heap.pop();
    int32_t pos = c.pos;
    if (stamp[pos] != c.stamp) continue;  // left symbol changed since push
    int32_t nx = next[pos];
    if (nx < 0) continue;
    // revalidate: the pair must still concatenate to this piece
    const std::string& a = e->pieces[sym[pos]];
    const std::string& b = e->pieces[sym[nx]];
    if ((int64_t)a.size() + (int64_t)b.size() !=
            (int64_t)e->pieces[c.merged].size() ||
        e->pieces[c.merged].compare(0, a.size(), a) != 0 ||
        e->pieces[c.merged].compare(a.size(), b.size(), b) != 0)
      continue;

    // fuse nx into pos
    sym[pos] = c.merged;
    ++stamp[pos];
    int32_t nn = next[nx];
    next[pos] = nn;
    if (nn >= 0) prev[nn] = pos;
    stamp[nx] = UINT32_MAX;  // dead

    try_push(prev[pos]);
    try_push(pos);
  }

  int32_t out = 0;
  for (int32_t i = 0; i >= 0; i = next[i]) ids[out++] = sym[i];
  return out;
}

}  // extern "C"
