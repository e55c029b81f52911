// Incremental CTC prefix beam search, C ABI for ctypes.
//
// The port's own copy of wenet_tpu/runtime/cpp/ctc_prefix_beam_search.cc
// (the port imports nothing of the JAX package); built and loaded by
// wenet_tpu_torch/runtime/native_beam.py.  The card produces CTC
// posteriors and their per-frame top-k; this host-side search advances
// the beam, one utterance at a time or one streaming chunk at a time
// (reset, search, ..., finalize).  A plain C interface, loaded with
// ctypes.  The copy keeps the plain search only: context biasing and
// n-gram LM fusion are not ported, so finalizing adds no end-of-utterance
// score and only closes the beam: searching again needs a reset.
//
// Prefixes are interned in a trie (node = parent + token) and
// timestamps in a persistent trail pool, so every beam update is O(1)
// — no vector copies per candidate like the reference's
// std::vector<int> prefix keys (ctc_prefix_beam_search.h:35-48).
// ~10x faster per frame at beam=10, same token/time/score semantics
// (tested identical to the reference python implementation).
//
// Build (done at first use by native_beam.build()):
//   g++ -O2 -std=c++17 -shared -fPIC -o libctc_beam.so \
//       ctc_prefix_beam_search.cc

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

namespace {

constexpr float kNegInf = -std::numeric_limits<float>::infinity();

inline float LogAdd(float a, float b) {
  if (a == kNegInf) return b;
  if (b == kNegInf) return a;
  const float m = std::max(a, b);
  return m + std::log1p(std::exp(std::min(a, b) - m));
}

// persistent timestamp list: times of prefix[:-1]; the last token's
// stamp lives (mutable) on the hypothesis, because the reference
// re-stamps only the last element (search.py:171-176 / the C++
// next.times_ns.back() = abs_time).
struct TrailNode {
  int32_t prev;   // trail id of prefix[:-2] stamps (-1 = none)
  int32_t t;      // stamp of prefix[-2]
};

struct TrieNode {
  int32_t parent;  // trie id of prefix[:-1] (-1 for root's parent)
  int32_t token;
  int32_t depth;
};

// (trail, last) pair representing a full Times() list. last == -1
// means the empty list (root prefix).
struct Stamp {
  int32_t trail = -1;
  int32_t last = -1;
};

struct Score {
  float s = kNegInf;            // blank-ending score
  float ns = kNegInf;           // non-blank-ending score
  float v_s = kNegInf;          // viterbi blank-ending
  float v_ns = kNegInf;         // viterbi non-blank-ending
  float cur_token_prob = kNegInf;
  Stamp times_s;
  Stamp times_ns;

  float Total() const { return LogAdd(s, ns); }
  float Viterbi() const { return std::max(v_s, v_ns); }
  const Stamp& Times() const { return v_s > v_ns ? times_s : times_ns; }
};

struct Hyp {
  int32_t node;   // trie id
  Score sc;
};

// open-addressing int64 -> int32 map (trie child index); ~2x faster
// than unordered_map for the hot (node, token) -> child lookups
class ChildMap {
 public:
  void Clear() {
    keys_.assign(64, kEmpty);
    vals_.resize(64);
    mask_ = 63;
    size_ = 0;
  }

  int32_t* Find(int64_t key) {
    uint64_t h = Hash(key);
    for (;;) {
      uint64_t slot = h & mask_;
      if (keys_[slot] == kEmpty) return nullptr;
      if (keys_[slot] == key) return &vals_[slot];
      h = slot + 1;
    }
  }

  void Insert(int64_t key, int32_t val) {
    if ((size_ + 1) * 2 > keys_.size()) Grow();
    uint64_t h = Hash(key);
    for (;;) {
      uint64_t slot = h & mask_;
      if (keys_[slot] == kEmpty) {
        keys_[slot] = key;
        vals_[slot] = val;
        ++size_;
        return;
      }
      h = slot + 1;
    }
  }

 private:
  static constexpr int64_t kEmpty = -1;  // (node,token) keys are >= 0

  static uint64_t Hash(int64_t key) {
    uint64_t x = static_cast<uint64_t>(key);
    x ^= x >> 33;
    x *= 0xff51afd7ed558ccdULL;
    x ^= x >> 33;
    return x;
  }

  void Grow() {
    std::vector<int64_t> ok = std::move(keys_);
    std::vector<int32_t> ov = std::move(vals_);
    keys_.assign(ok.size() * 2, kEmpty);
    vals_.resize(ok.size() * 2);
    mask_ = keys_.size() - 1;
    size_ = 0;
    for (size_t i = 0; i < ok.size(); ++i) {
      if (ok[i] != kEmpty) Insert(ok[i], ov[i]);
    }
  }

  std::vector<int64_t> keys_;
  std::vector<int32_t> vals_;
  uint64_t mask_ = 0;
  size_t size_ = 0;
};

struct Searcher {
  int beam_size;
  int blank_id;
  int abs_time = 0;
  bool finalized = false;
  std::vector<TrieNode> trie;
  ChildMap child;  // (node<<32|token) -> id
  std::vector<TrailNode> trails;
  std::vector<Hyp> cur;
  // per-frame accumulator: open-addressing table over trie ids with
  // generation stamps (no clear per frame, no rehash, ~3x faster than
  // unordered_map at beam*k scale)
  std::vector<Hyp> next;
  std::vector<int32_t> tab_idx;
  std::vector<uint32_t> tab_gen;
  uint32_t gen = 0;
  uint32_t tab_mask = 0;

  void EnsureTable(size_t min_entries) {
    size_t want = 64;
    while (want < min_entries * 4) want <<= 1;
    if (tab_idx.size() < want) {
      tab_idx.assign(want, 0);
      tab_gen.assign(want, 0);
      tab_mask = static_cast<uint32_t>(want) - 1;
      gen = 0;
    }
  }

  Score& Acc(int32_t node) {
    uint32_t h = static_cast<uint32_t>(node) * 2654435761u & tab_mask;
    for (;;) {
      if (tab_gen[h] != gen) {
        tab_gen[h] = gen;
        tab_idx[h] = static_cast<int32_t>(next.size());
        next.push_back(Hyp{node, Score()});
        return next.back().sc;
      }
      Hyp& cand = next[tab_idx[h]];
      if (cand.node == node) return cand.sc;
      h = (h + 1) & tab_mask;
    }
  }

  void Reset() {
    abs_time = 0;
    finalized = false;
    trie.clear();
    child.Clear();
    trails.clear();
    cur.clear();
    trie.push_back(TrieNode{-1, -1, 0});  // root = empty prefix
    Hyp root;
    root.node = 0;
    root.sc.s = 0.0f;
    root.sc.v_s = 0.0f;
    root.sc.v_ns = 0.0f;
    cur.push_back(root);
  }

  int32_t Child(int32_t node, int32_t token) {
    int64_t key = (static_cast<int64_t>(node) << 32) |
                  static_cast<uint32_t>(token);
    if (int32_t* v = child.Find(key)) return *v;
    int32_t id = static_cast<int32_t>(trie.size());
    trie.push_back(TrieNode{node, token, trie[node].depth + 1});
    child.Insert(key, id);
    return id;
  }

  // freeze a Times() pair into a trail id (times of the new prefix's
  // [:-1] part after an extension)
  int32_t Intern(const Stamp& st) {
    if (st.last < 0) return -1;  // empty list
    trails.push_back(TrailNode{st.trail, st.last});
    return static_cast<int32_t>(trails.size()) - 1;
  }

  void Step(const int* cand_ids, const float* cand_probs, int k) {
    EnsureTable(cur.size() * (k + 1) * 2);
    next.clear();
    ++gen;
    if (gen == 0) {  // stamp wraparound: invalidate everything
      std::fill(tab_gen.begin(), tab_gen.end(), 0u);
      gen = 1;
    }
    for (int i = 0; i < k; ++i) {
      const int u = cand_ids[i];
      const float prob = cand_probs[i];
      for (const Hyp& h : cur) {
        const Score& ps = h.sc;
        const int last = trie[h.node].token;  // -1 at root
        if (u == blank_id) {
          Score& nx = Acc(h.node);
          nx.s = LogAdd(nx.s, ps.Total() + prob);
          nx.v_s = ps.Viterbi() + prob;
          nx.times_s = ps.Times();
        } else if (u == last) {
          {  // stay: *uu -> *u
            Score& nx = Acc(h.node);
            nx.ns = LogAdd(nx.ns, ps.ns + prob);
            if (nx.v_ns < ps.v_ns + prob) {
              nx.v_ns = ps.v_ns + prob;
              if (nx.cur_token_prob < prob) {
                nx.cur_token_prob = prob;
                nx.times_ns = ps.times_ns;
                if (nx.times_ns.last >= 0) nx.times_ns.last = abs_time;
              }
            }
          }
          {  // extend through blank: *u-<b>-u -> *uu
            Score& nx = Acc(Child(h.node, u));
            nx.ns = LogAdd(nx.ns, ps.s + prob);
            if (nx.v_ns < ps.v_s + prob) {
              nx.v_ns = ps.v_s + prob;
              nx.cur_token_prob = prob;
              nx.times_ns.trail = Intern(ps.times_s);
              nx.times_ns.last = abs_time;
            }
          }
        } else {  // extend with a new token
          Score& nx = Acc(Child(h.node, u));
          nx.ns = LogAdd(nx.ns, ps.Total() + prob);
          if (nx.v_ns < ps.Viterbi() + prob) {
            nx.v_ns = ps.Viterbi() + prob;
            nx.cur_token_prob = prob;
            nx.times_ns.trail = Intern(ps.Times());
            nx.times_ns.last = abs_time;
          }
        }
      }
    }
    // second prune: keep top beam_size by total score
    const int keep =
        std::min<int>(beam_size, static_cast<int>(next.size()));
    std::partial_sort(next.begin(), next.begin() + keep, next.end(),
                      [](const Hyp& a, const Hyp& b) {
                        return a.sc.Total() > b.sc.Total();
                      });
    next.resize(keep);
    std::swap(cur, next);
  }

  // Candidates pre-selected on the card (torch.topk per frame), so no
  // O(V) work or O(B*T*V) transfer on the host.  The reference prefix
  // beam (ref wenet/models/transformer/search.py:146 logp.topk(beam_size))
  // only ever considers the per-frame top-k anyway.
  void SearchTopk(const float* vals, const int* ids, int num_frames,
                  int k) {
    for (int t = 0; t < num_frames; ++t, ++abs_time) {
      Step(ids + static_cast<int64_t>(t) * k,
           vals + static_cast<int64_t>(t) * k, k);
    }
  }

  void Tokens(int i, int* out) const {
    int32_t n = cur[i].node;
    int d = trie[n].depth;
    while (n > 0) {
      out[--d] = trie[n].token;
      n = trie[n].parent;
    }
  }

  void Times(int i, int* out) const {
    const Stamp& st = cur[i].sc.Times();
    int d = trie[cur[i].node].depth;
    if (st.last < 0 || d == 0) return;
    out[--d] = st.last;
    int32_t tr = st.trail;
    while (tr >= 0 && d > 0) {
      out[--d] = trails[tr].t;
      tr = trails[tr].prev;
    }
  }
};

}  // namespace

extern "C" {

void* ctc_beam_create(int beam_size, int blank_id) {
  Searcher* s = new Searcher();
  s->beam_size = beam_size;
  s->blank_id = blank_id;
  s->Reset();
  return s;
}

void ctc_beam_destroy(void* h) { delete static_cast<Searcher*>(h); }

void ctc_beam_reset(void* h) { static_cast<Searcher*>(h)->Reset(); }

void ctc_beam_finalize(void* h) { static_cast<Searcher*>(h)->finalized = true; }

// 0, or -1 (and no search) once the beam is finalized
int ctc_beam_search_topk(void* h, const float* vals, const int* ids,
                         int num_frames, int k) {
  Searcher* s = static_cast<Searcher*>(h);
  if (s->finalized) return -1;
  s->SearchTopk(vals, ids, num_frames, k);
  return 0;
}

int ctc_beam_num_hyps(void* h) {
  return static_cast<int>(static_cast<Searcher*>(h)->cur.size());
}

int ctc_beam_hyp_len(void* h, int i) {
  Searcher* s = static_cast<Searcher*>(h);
  return s->trie[s->cur[i].node].depth;
}

void ctc_beam_hyp(void* h, int i, int* out_tokens, int* out_times,
                  float* out_score) {
  Searcher* s = static_cast<Searcher*>(h);
  s->Tokens(i, out_tokens);
  s->Times(i, out_times);
  *out_score = s->cur[i].sc.Total();
}

}  // extern "C"
