// Incremental CTC prefix beam search, C ABI for ctypes.
//
// The port's own copy of wenet_tpu/runtime/cpp/ctc_prefix_beam_search.cc
// (the port imports nothing of the JAX package); built and loaded by
// wenet_tpu_torch/runtime/native_beam.py.  The card produces CTC
// posteriors and their per-frame top-k; this host-side search advances
// the beam, one utterance at a time or one streaming chunk at a time
// (reset, search, ..., finalize).  A plain C interface, loaded with
// ctypes.
//
// Context biasing (an Aho-Corasick graph flattened from
// utils/context_graph.py) and shallow fusion of an ARPA n-gram LM
// (flattened from lm/arpa.py, shared read-only between searchers) run in
// the search loop: prefixes are pruned by score + bias + weight * LM.
// Finalizing adds the LM's </s>, re-sorts, and replaces each hypothesis'
// bias with the back-off of its unfinished match; searching again needs
// a reset.
//
// Prefixes are interned in a trie (node = parent + token) and
// timestamps in a persistent trail pool, so every beam update is O(1)
// — no vector copies per candidate like the reference's
// std::vector<int> prefix keys (ctc_prefix_beam_search.h:35-48).
// ~10x faster per frame at beam=10, same token/time/score semantics
// (tested identical to the reference python implementation).
//
// Scores are summed in double, where the JAX package's copy sums in
// float: near |score| = 1500 a float sum moves in steps of 1.22e-4 (one
// ulp), so two runs whose per-frame log-probs differ only in their last
// bits (a stream stepped alone and in a batch) drift whole ulps apart
// over an utterance.  The inputs (log-probs, bias and LM tables) stay
// float; a hypothesis' score is returned in double.
//
// Build (done at first use by native_beam.build()):
//   g++ -O2 -std=c++17 -shared -fPIC -o libctc_beam.so \
//       ctc_prefix_beam_search.cc

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <numeric>
#include <vector>

namespace {

constexpr double kNegInf = -std::numeric_limits<double>::infinity();

inline double LogAdd(double a, double b) {
  if (a == kNegInf) return b;
  if (b == kNegInf) return a;
  const double m = std::max(a, b);
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
  double s = kNegInf;            // blank-ending score
  double ns = kNegInf;           // non-blank-ending score
  double v_s = kNegInf;          // viterbi blank-ending
  double v_ns = kNegInf;         // viterbi non-blank-ending
  double cur_token_prob = kNegInf;
  Stamp times_s;
  Stamp times_ns;

  double Total() const { return LogAdd(s, ns); }
  double Viterbi() const { return std::max(v_s, v_ns); }
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

// Aho-Corasick biasing graph, flattened from the python ContextGraph
// (wenet_tpu/utils/context_graph.py; ref wenet/utils/context_graph.py
// + runtime/core/decoder/context_graph.{h,cc}).  States/scores are
// deterministic functions of the prefix, so they live on trie nodes.
struct CtxGraph {
  bool active = false;
  std::vector<int32_t> fail;
  std::vector<float> node_score, output_score, token_score;
  ChildMap trans;  // (node<<32|token) -> child

  // python ContextGraph.forward_one_step (context_graph.py:117-131)
  std::pair<double, int32_t> Forward(int32_t state, int32_t tok) const {
    const int64_t key =
        (static_cast<int64_t>(state) << 32) | static_cast<uint32_t>(tok);
    if (const int32_t* v = const_cast<ChildMap&>(trans).Find(key)) {
      return {static_cast<double>(token_score[*v]) + output_score[*v], *v};
    }
    int32_t node = fail[state];
    for (;;) {
      const int64_t k2 = (static_cast<int64_t>(node) << 32) |
                         static_cast<uint32_t>(tok);
      if (const int32_t* v = const_cast<ChildMap&>(trans).Find(k2)) {
        node = *v;
        break;
      }
      if (node == 0) break;  // root (python: node.token == -1)
      node = fail[node];
    }
    return {static_cast<double>(node_score[node]) - node_score[state] +
                output_score[node],
            node};
  }
};

// Katz-backoff ARPA n-gram LM over word ids (flattened from
// wenet_tpu/lm/arpa.py NgramLM; natural-log scores).
struct NgramLm {
  bool active = false;
  int order = 0;
  int32_t bos = -1, eos = -1;
  std::vector<int32_t> tok2word;  // token id -> lm word id (-1 = miss)

  struct Table {  // (id tuple) -> (logp, backoff), open addressing
    int n = 0;
    std::vector<int32_t> pool;  // entry keys, n ids each
    std::vector<float> logp, backoff;
    std::vector<int32_t> slots;  // hash slot -> entry idx (-1 empty)
    uint64_t mask = 0;

    static uint64_t Hash(const int32_t* ids, int n) {
      uint64_t h = 1469598103934665603ull;
      for (int i = 0; i < n; ++i) {
        h ^= static_cast<uint32_t>(ids[i]);
        h *= 1099511628211ull;
      }
      return h;
    }

    void Build(int n_, int count, const int32_t* ids, const float* lp,
               const float* bo) {
      n = n_;
      pool.assign(ids, ids + static_cast<int64_t>(count) * n);
      logp.assign(lp, lp + count);
      backoff.assign(bo, bo + count);
      size_t want = 64;
      while (want < static_cast<size_t>(count) * 2) want <<= 1;
      slots.assign(want, -1);
      mask = want - 1;
      for (int e = 0; e < count; ++e) {
        uint64_t h = Hash(&pool[static_cast<int64_t>(e) * n], n);
        while (slots[h & mask] >= 0) ++h;
        slots[h & mask] = e;
      }
    }

    int32_t Find(const int32_t* key) const {
      if (slots.empty()) return -1;
      uint64_t h = Hash(key, n);
      for (;;) {
        const int32_t e = slots[h & mask];
        if (e < 0) return -1;
        if (std::memcmp(&pool[static_cast<int64_t>(e) * n], key,
                        n * sizeof(int32_t)) == 0) {
          return e;
        }
        ++h;
      }
    }
  };
  std::vector<Table> tables;  // tables[k]: (k+1)-grams

  // python NgramLM.score_word/_score_backed (arpa.py:30-53); `ctx`
  // holds the last (order-1) word ids, earliest first.
  double ScoreWord(const int32_t* ctx, int ctx_len, int32_t word) const {
    if (word < 0) return -20.0;  // not in LM vocab, no <unk>
    double total = 0.0;
    int start = 0, len = ctx_len;
    std::vector<int32_t> key(len + 1);
    for (;;) {
      for (int i = 0; i < len; ++i) key[i] = ctx[start + i];
      key[len] = word;
      const int32_t e = tables[len].Find(key.data());
      if (e >= 0) return total + tables[len].logp[e];
      if (len == 0) return total - 20.0;
      const int32_t b = tables[len - 1].Find(&key[0]);  // ctx alone
      if (b >= 0) total += tables[len - 1].backoff[b];
      ++start;
      --len;
      key.resize(len + 1);
    }
  }
};

struct Searcher {
  int beam_size;
  int blank_id;
  int abs_time = 0;
  std::vector<TrieNode> trie;
  ChildMap child;  // (node<<32|token) -> id
  std::vector<TrailNode> trails;
  std::vector<Hyp> cur;
  // per-trie-node prefix-deterministic fusion state
  CtxGraph ctx;
  std::vector<int32_t> ctx_state;  // graph node per trie node
  std::vector<double> ctx_cum;      // accumulated bias score
  const NgramLm* lm_ptr = nullptr;  // shared across searchers
  double lm_weight = 0.0;
  std::vector<double> lm_cum;       // accumulated natural-log LM score
  bool LmActive() const { return lm_ptr && lm_ptr->active; }
  bool finalized = false;
  std::vector<double> fin_extra;    // per-cur-hyp finalize adjustment
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
    trie.clear();
    child.Clear();
    trails.clear();
    cur.clear();
    finalized = false;
    fin_extra.clear();
    trie.push_back(TrieNode{-1, -1, 0});  // root = empty prefix
    ctx_state.assign(1, 0);
    ctx_cum.assign(1, 0.0);
    lm_cum.assign(1, 0.0);
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
    // prefix-deterministic fusion bookkeeping, computed once per prefix
    if (ctx.active) {
      auto [delta, state] = ctx.Forward(ctx_state[node], token);
      ctx_state.push_back(state);
      ctx_cum.push_back(ctx_cum[node] + delta);
    } else {
      ctx_state.push_back(0);
      ctx_cum.push_back(0.0);
    }
    if (LmActive()) {
      const NgramLm& lm = *lm_ptr;
      // context = [<s>] + prefix words, last (order-1), earliest first
      int32_t ctx_ids[16];
      int len = 0;
      const int cap = lm.order - 1;
      int32_t p = node;
      while (p > 0 && len < cap) {
        ctx_ids[len++] = lm.tok2word[trie[p].token];
        p = trie[p].parent;
      }
      if (p == 0 && len < cap) ctx_ids[len++] = lm.bos;
      std::reverse(ctx_ids, ctx_ids + len);
      const double delta =
          lm.ScoreWord(ctx_ids, len, lm.tok2word[token]);
      lm_cum.push_back(lm_cum[node] + delta);
    } else {
      lm_cum.push_back(0.0);
    }
    return id;
  }

  // pruning/reporting total: base + bias + weighted LM, mirroring the
  // python CtcPrefixBeamSearch sort key (ctc_prefix_beam_search.py:
  // 123-127) / _PrefixScore.total_score (context_graph.py:177-178)
  double FusedTotal(const Hyp& h) const {
    double t = h.sc.Total();
    if (ctx.active) t += ctx_cum[h.node];
    if (LmActive()) t += lm_weight * lm_cum[h.node];
    return t;
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
    // second prune: keep top beam_size by (bias+LM-fused) total score
    const int keep =
        std::min<int>(beam_size, static_cast<int>(next.size()));
    std::partial_sort(next.begin(), next.begin() + keep, next.end(),
                      [this](const Hyp& a, const Hyp& b) {
                        return FusedTotal(a) > FusedTotal(b);
                      });
    next.resize(keep);
    std::swap(cur, next);
  }

  // python CtcPrefixBeamSearch.finalize_search
  // (runtime/ctc_prefix_beam_search.py:130-152): add the LM </s> cost
  // and re-sort, then replace each hyp's bias score with the
  // partial-match backoff -node_score (assignment, not +=, exactly as
  // the reference does — search.py:229-234)
  void Finalize() {
    if (finalized) return;
    finalized = true;
    std::vector<double> lm_final(cur.size(), 0.0);
    if (LmActive()) {
      const NgramLm& lm = *lm_ptr;
      for (size_t i = 0; i < cur.size(); ++i) {
        int32_t ctx_ids[16];
        int len = 0;
        const int cap = lm.order - 1;
        int32_t p = cur[i].node;
        while (p > 0 && len < cap) {
          ctx_ids[len++] = lm.tok2word[trie[p].token];
          p = trie[p].parent;
        }
        if (p == 0 && len < cap) ctx_ids[len++] = lm.bos;
        std::reverse(ctx_ids, ctx_ids + len);
        lm_final[i] = lm.ScoreWord(ctx_ids, len, lm.eos);
      }
      std::vector<int> idx(cur.size());
      std::iota(idx.begin(), idx.end(), 0);
      std::stable_sort(idx.begin(), idx.end(), [&](int a, int b) {
        return FusedTotal(cur[a]) + lm_weight * lm_final[a] >
               FusedTotal(cur[b]) + lm_weight * lm_final[b];
      });
      std::vector<Hyp> reord;
      std::vector<double> lf;
      reord.reserve(cur.size());
      for (int i : idx) {
        reord.push_back(cur[i]);
        lf.push_back(lm_final[i]);
      }
      cur = std::move(reord);
      lm_final = std::move(lf);
    }
    fin_extra.assign(cur.size(), 0.0);
    for (size_t i = 0; i < cur.size(); ++i) {
      if (LmActive()) fin_extra[i] += lm_weight * lm_final[i];
      if (ctx.active) {
        // replace accumulated bias with finalize()'s -node_score
        fin_extra[i] += -ctx.node_score[ctx_state[cur[i].node]] -
                        ctx_cum[cur[i].node];
      }
    }
  }

  double HypScore(int i) const {
    double s = FusedTotal(cur[i]);
    if (finalized && i < static_cast<int>(fin_extra.size())) {
      s += fin_extra[i];
    }
    return s;
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
                  double* out_score) {
  Searcher* s = static_cast<Searcher*>(h);
  s->Tokens(i, out_tokens);
  s->Times(i, out_times);
  *out_score = s->HypScore(i);
}

// ---- context biasing + LM fusion configuration ----

void ctc_beam_set_context(void* h, int n_nodes, const int* fail,
                          const float* node_score,
                          const float* output_score,
                          const float* token_score, int n_trans,
                          const int* trans_from, const int* trans_tok,
                          const int* trans_to) {
  Searcher* s = static_cast<Searcher*>(h);
  CtxGraph& c = s->ctx;
  c.active = n_nodes > 0;
  c.fail.assign(fail, fail + n_nodes);
  c.node_score.assign(node_score, node_score + n_nodes);
  c.output_score.assign(output_score, output_score + n_nodes);
  c.token_score.assign(token_score, token_score + n_nodes);
  c.trans.Clear();
  for (int i = 0; i < n_trans; ++i) {
    c.trans.Insert((static_cast<int64_t>(trans_from[i]) << 32) |
                       static_cast<uint32_t>(trans_tok[i]),
                   trans_to[i]);
  }
  s->Reset();
}

// LM is a SHARED object: flatten+upload the ARPA tables once, attach
// to any number of (possibly concurrent) searchers — scoring is
// read-only.
void* ctc_lm_create(int order, int n_tok, const int* tok2word, int bos,
                    int eos) {
  NgramLm* lm = new NgramLm();
  lm->active = order > 0;
  lm->order = std::min(order, 15);
  lm->bos = bos;
  lm->eos = eos;
  lm->tok2word.assign(tok2word, tok2word + n_tok);
  lm->tables.assign(lm->order, NgramLm::Table());
  return lm;
}

// one call per n-gram order: `ids` is count*(n) word ids row-major
// (context..., word); natural-log logp/backoff
void ctc_lm_add_table(void* lm_h, int n, int count, const int* ids,
                      const float* logp, const float* backoff) {
  NgramLm* lm = static_cast<NgramLm*>(lm_h);
  if (n < 1 || n > lm->order) return;
  lm->tables[n - 1].Build(n, count, ids, logp, backoff);
}

void ctc_lm_destroy(void* lm_h) { delete static_cast<NgramLm*>(lm_h); }

void ctc_beam_attach_lm(void* h, void* lm_h, double weight) {
  Searcher* s = static_cast<Searcher*>(h);
  s->lm_ptr = static_cast<const NgramLm*>(lm_h);
  s->lm_weight = weight;
  s->Reset();
}

void ctc_beam_finalize(void* h) { static_cast<Searcher*>(h)->Finalize(); }

}  // extern "C"
