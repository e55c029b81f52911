// CTC TLG/WFST lattice beam decoder (C, exported for ctypes): the port's
// copy of wenet_tpu/runtime/cpp/wfst_lattice_decoder.cc, built with g++ at
// first use by wenet_tpu_torch/utils/native.py and wrapped by
// wenet_tpu_torch/runtime/native_wfst.py.  Its plain version is the Python
// token-passing searcher, wenet_tpu_torch/runtime/wfst_beam_search.py.
//
// Native analog of the reference's CtcWfstBeamSearch wrapping Kaldi's
// LatticeFasterOnlineDecoder (ref:
// runtime/core/decoder/ctc_wfst_beam_search.{h,cc},
// runtime/core/kaldi/decoder/lattice-faster-decoder.{h,cc}):
//  * token passing over a text-format TLG with beam + max-active
//    pruning and an adaptive cutoff,
//  * a REAL lattice: per-token forward links carrying split
//    graph/acoustic costs (kaldi LatticeWeight), kept for every frame,
//  * n-best = best-first path enumeration over the token/link DAG with
//    exact backward heuristics (the ShortestPath(lat, nbest) analog),
//    deduped by word sequence,
//  * blank frame-skipping with the reference's re-inserted-blank rule
//    (ctc_wfst_beam_search.cc:77-103),
//  * streaming partials via viterbi backpointers (BestPathEnd analog).
//
// Index-pool design (no pointer chasing, trivially serializable):
// tokens and links live in flat vectors; the per-frame active set is a
// state->token hash map.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <limits>
#include <queue>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr float kInf = std::numeric_limits<float>::infinity();

struct Arc {
  int32_t ilabel;
  int32_t olabel;
  int32_t next_state;
  float weight;
};

struct Fst {
  int32_t start = 0;
  std::vector<std::vector<Arc>> arcs;     // per state
  std::vector<float> final_cost;          // kInf if non-final

  int32_t NumStates() const { return (int32_t)arcs.size(); }
  void EnsureState(int32_t s) {
    if (s >= NumStates()) {
      arcs.resize(s + 1);
      final_cost.resize(s + 1, kInf);
    }
  }
};

// Text format produced by wenet_tpu_torch.lm.build_graph.write_text:
//   "src dst ilabel olabel weight"  |  "state [final_cost]"
bool ParseTextFst(const char* path, Fst* fst) {
  FILE* f = fopen(path, "r");
  if (!f) return false;
  char line[512];
  bool first = true;
  while (fgets(line, sizeof(line), f)) {
    long long a[4];
    double w = 0.0;
    int n = sscanf(line, "%lld %lld %lld %lld %lf", &a[0], &a[1], &a[2],
                   &a[3], &w);
    if (n >= 4) {
      fst->EnsureState((int32_t)std::max(a[0], a[1]));
      fst->arcs[a[0]].push_back(
          Arc{(int32_t)a[2], (int32_t)a[3], (int32_t)a[1], (float)w});
      if (first) {
        fst->start = (int32_t)a[0];
        first = false;
      }
    } else if (n >= 1) {
      double fw = (n == 2) ? (double)a[1] : 0.0;
      // final line may be "state cost" with float cost
      double st, fc = 0.0;
      if (sscanf(line, "%lf %lf", &st, &fc) >= 1) {
        fst->EnsureState((int32_t)st);
        fst->final_cost[(int32_t)st] = (float)fc;
      }
      (void)fw;
    }
  }
  fclose(f);
  return fst->NumStates() > 0;
}

struct ForwardLink {
  int32_t next_tok;       // target token index
  int32_t ilabel;         // 0 for eps
  int32_t olabel;
  float graph_cost;
  float acoustic_cost;
  int32_t next;           // next link of the same source token (-1 end)
};

struct Token {
  float tot_cost;
  int32_t state;
  int32_t frame;          // decoded-frame index
  int32_t links;          // head of forward link list (-1 none)
  // viterbi backpointer for streaming partials:
  int32_t best_prev_tok;
  int32_t best_prev_ilabel;
  int32_t best_prev_olabel;
};

struct Options {
  int blank = 0;
  float acoustic_scale = 1.0f;
  float blank_skip_thresh = 0.98f;
  float blank_scale = 1.0f;
  float beam = 16.0f;
  int max_active = 7000;
  int nbest = 10;
};

struct Hyp {
  std::vector<int32_t> words;
  std::vector<int32_t> wtimes;   // original frame per word
  std::vector<int32_t> inputs;   // ctc tokens (blank removed, merged)
  std::vector<int32_t> times;    // original frame per input token
  float likelihood;              // -(graph + acoustic)
  float graph_cost;
  float acoustic_cost;
};

class LatticeDecoder {
 public:
  LatticeDecoder(Fst fst, const Options& opts)
      : fst_(std::move(fst)), opts_(opts) {
    Reset();
  }

  void Reset() {
    toks_.clear();
    links_.clear();
    frames_.clear();
    cur_.clear();
    num_frames_ = 0;
    decoded_frames_mapping_.clear();
    is_last_frame_blank_ = false;
    last_best_ = 0;
    last_frame_prob_.clear();
    finalized_ = false;
    hyps_.clear();
    // frame 0 active set = eps closure of the start state
    int32_t t0 = NewToken(fst_.start, 0, 0.0f);
    cur_[fst_.start] = t0;
    ProcessNonemitting();
    frames_.push_back(CurrentList());
  }

  // Reference blank-skip wrapper (ctc_wfst_beam_search.cc:75-105).
  void Search(const float* logp, int T, int V) {
    for (int i = 0; i < T; ++i) {
      const float* row = logp + (int64_t)i * V;
      float blank_score = std::exp(row[opts_.blank]);
      if (blank_score > opts_.blank_skip_thresh * opts_.blank_scale) {
        is_last_frame_blank_ = true;
        last_frame_prob_.assign(row, row + V);
      } else {
        int cur_best =
            (int)(std::max_element(row, row + V) - row);
        if (cur_best != opts_.blank && is_last_frame_blank_ &&
            cur_best == last_best_ && !last_frame_prob_.empty()) {
          AdvanceOneFrame(last_frame_prob_.data(), V, num_frames_ - 1);
        }
        last_best_ = cur_best;
        AdvanceOneFrame(row, V, num_frames_);
        is_last_frame_blank_ = false;
      }
      num_frames_++;
    }
  }

  void Finalize() {
    finalized_ = true;
    ComputeNbest();
  }

  // Streaming partial: viterbi backpointer chain from the best token.
  Hyp BestPartial() const {
    Hyp hyp;
    hyp.likelihood = 0.f;
    hyp.graph_cost = hyp.acoustic_cost = 0.f;
    if (frames_.empty()) return hyp;
    const std::vector<int32_t>& last = frames_.back();
    int32_t best = -1;
    float best_cost = kInf;
    for (int32_t ti : last) {
      if (toks_[ti].tot_cost < best_cost) {
        best_cost = toks_[ti].tot_cost;
        best = ti;
      }
    }
    if (best < 0) return hyp;
    std::vector<int32_t> align, words;
    for (int32_t ti = best; ti >= 0; ti = toks_[ti].best_prev_tok) {
      const Token& tk = toks_[ti];
      if (tk.best_prev_tok < 0) break;
      if (tk.best_prev_ilabel > 0) align.push_back(tk.best_prev_ilabel);
      if (tk.best_prev_olabel > 0) words.push_back(tk.best_prev_olabel);
    }
    std::reverse(align.begin(), align.end());
    std::reverse(words.begin(), words.end());
    hyp.words = words;
    ConvertToInputs(align, AlignFrames(align.size()), &hyp);
    hyp.likelihood = -best_cost;
    return hyp;
  }

  const std::vector<Hyp>& Hyps() const { return hyps_; }
  bool finalized() const { return finalized_; }

 private:
  int32_t NewToken(int32_t state, int32_t frame, float cost) {
    toks_.push_back(Token{cost, state, frame, -1, -1, 0, 0});
    return (int32_t)toks_.size() - 1;
  }

  std::vector<int32_t> CurrentList() const {
    std::vector<int32_t> v;
    v.reserve(cur_.size());
    for (const auto& kv : cur_) v.push_back(kv.second);
    return v;
  }

  void AddLink(int32_t from, int32_t to, int32_t il, int32_t ol,
               float gc, float ac) {
    // replace an existing identical-arc link if re-relaxed
    for (int32_t li = toks_[from].links; li >= 0; li = links_[li].next) {
      ForwardLink& l = links_[li];
      if (l.next_tok == to && l.ilabel == il && l.olabel == ol) {
        if (gc + ac < l.graph_cost + l.acoustic_cost) {
          l.graph_cost = gc;
          l.acoustic_cost = ac;
        }
        return;
      }
    }
    links_.push_back(ForwardLink{to, il, ol, gc, ac,
                                 toks_[from].links});
    toks_[from].links = (int32_t)links_.size() - 1;
  }

  // GetCutoff analog (lattice-faster-decoder.cc): adaptive beam from
  // best cost + beam, tightened by the max_active-th best cost.
  float GetCutoff(const std::vector<int32_t>& list) const {
    float best = kInf;
    for (int32_t ti : list) best = std::min(best, toks_[ti].tot_cost);
    float cutoff = best + opts_.beam;
    if ((int)list.size() > opts_.max_active) {
      std::vector<float> costs;
      costs.reserve(list.size());
      for (int32_t ti : list) costs.push_back(toks_[ti].tot_cost);
      std::nth_element(costs.begin(), costs.begin() + opts_.max_active,
                       costs.end());
      cutoff = std::min(cutoff, costs[opts_.max_active]);
    }
    return cutoff;
  }

  void AdvanceOneFrame(const float* row, int V, int orig_frame) {
    const std::vector<int32_t>& prev = frames_.back();
    float cutoff = GetCutoff(prev);
    int32_t frame = (int32_t)frames_.size();

    cur_.clear();
    float next_best = kInf;
    for (int32_t ti : prev) {
      const float tok_cost = toks_[ti].tot_cost;
      if (tok_cost > cutoff) continue;
      const std::vector<Arc>& arcs = fst_.arcs[toks_[ti].state];
      for (const Arc& arc : arcs) {
        if (arc.ilabel == 0) continue;
        int idx = arc.ilabel - 1;  // DecodableTensorScaled: index-1
        if (idx >= V) continue;
        float ac = -opts_.acoustic_scale * row[idx];
        float new_cost = tok_cost + arc.weight + ac;
        if (new_cost >= next_best + opts_.beam) continue;
        int32_t to;
        auto it = cur_.find(arc.next_state);
        if (it == cur_.end()) {
          to = NewToken(arc.next_state, frame, kInf);
          cur_[arc.next_state] = to;
        } else {
          to = it->second;
        }
        if (new_cost < toks_[to].tot_cost) {
          toks_[to].tot_cost = new_cost;
          toks_[to].best_prev_tok = ti;
          toks_[to].best_prev_ilabel = arc.ilabel;
          toks_[to].best_prev_olabel = arc.olabel;
          next_best = std::min(next_best, new_cost);
        }
        AddLink(ti, to, arc.ilabel, arc.olabel, arc.weight, ac);
      }
    }
    ProcessNonemitting();
    frames_.push_back(CurrentList());
    decoded_frames_mapping_.push_back(orig_frame);
  }

  void ProcessNonemitting() {
    // relax eps arcs to fixpoint within the current frame
    std::vector<int32_t> queue = CurrentList();
    int32_t frame = frames_.empty() ? 0 : (int32_t)frames_.size();
    size_t guard = 0;
    const size_t kGuardMax = 20u * 1000u * 1000u;
    while (!queue.empty() && guard++ < kGuardMax) {
      int32_t ti = queue.back();
      queue.pop_back();
      float tok_cost = toks_[ti].tot_cost;
      const std::vector<Arc>& arcs = fst_.arcs[toks_[ti].state];
      for (const Arc& arc : arcs) {
        if (arc.ilabel != 0) continue;
        float new_cost = tok_cost + arc.weight;
        int32_t to;
        auto it = cur_.find(arc.next_state);
        if (it == cur_.end()) {
          to = NewToken(arc.next_state, frame, new_cost);
          cur_[arc.next_state] = to;
          toks_[to].tot_cost = kInf;  // force the improve branch below
        } else {
          to = it->second;
        }
        AddLink(ti, to, 0, arc.olabel, arc.weight, 0.0f);
        if (new_cost + 1e-6f < toks_[to].tot_cost) {
          toks_[to].tot_cost = new_cost;
          toks_[to].best_prev_tok = ti;
          toks_[to].best_prev_ilabel = 0;
          toks_[to].best_prev_olabel = arc.olabel;
          queue.push_back(to);
        }
      }
    }
  }

  std::vector<int32_t> AlignFrames(size_t n) const {
    // emitting step i corresponds to decoded frame i
    std::vector<int32_t> frames(n);
    for (size_t i = 0; i < n; ++i) {
      frames[i] = (i < decoded_frames_mapping_.size())
                      ? decoded_frames_mapping_[i]
                      : (int32_t)i;
    }
    return frames;
  }

  // ConvertToInputs (ctc_wfst_beam_search.cc:166-181): drop blanks,
  // merge consecutive repeats, map to original frames.
  void ConvertToInputs(const std::vector<int32_t>& align,
                       const std::vector<int32_t>& align_frames,
                       Hyp* hyp) const {
    hyp->inputs.clear();
    hyp->times.clear();
    for (size_t cur = 0; cur < align.size(); ++cur) {
      if (align[cur] - 1 == opts_.blank) continue;
      if (cur > 0 && align[cur] == align[cur - 1]) continue;
      hyp->inputs.push_back(align[cur] - 1);
      hyp->times.push_back(cur < align_frames.size()
                               ? align_frames[cur] : 0);
    }
  }

  // ---- n-best over the lattice ------------------------------------
  void ComputeNbest() {
    hyps_.clear();
    if (frames_.empty()) return;
    const std::vector<int32_t>& last = frames_.back();
    // final costs (FinalizeDecoding analog): prefer true final states,
    // fall back to all last-frame tokens like the python searcher.
    std::unordered_map<int32_t, float> final_of;
    bool any_final = false;
    for (int32_t ti : last) {
      float fc = fst_.final_cost[toks_[ti].state];
      if (fc != kInf) {
        final_of[ti] = fc;
        any_final = true;
      }
    }
    if (!any_final) {
      for (int32_t ti : last) final_of[ti] = 0.0f;
    }

    // backward exact heuristic beta: frames in reverse; eps links stay
    // within a frame -> relax each frame to fixpoint.
    std::vector<float> beta(toks_.size(), kInf);
    for (const auto& kv : final_of) beta[kv.first] = kv.second;
    for (int f = (int)frames_.size() - 1; f >= 0; --f) {
      const std::vector<int32_t>& lst = frames_[f];
      bool changed = true;
      int passes = 0;
      while (changed && passes++ < 100) {
        changed = false;
        for (int32_t ti : lst) {
          for (int32_t li = toks_[ti].links; li >= 0;
               li = links_[li].next) {
            const ForwardLink& l = links_[li];
            float via = l.graph_cost + l.acoustic_cost +
                        beta[l.next_tok];
            if (via + 1e-7f < beta[ti]) {
              beta[ti] = via;
              changed = true;
            }
          }
        }
      }
    }

    // best-first enumeration; persistent path nodes share prefixes.
    struct PathNode {
      int32_t parent;
      int32_t link;   // link taken to get here (-1 for root)
    };
    std::vector<PathNode> nodes;
    struct QEntry {
      float f_cost;     // g + beta
      float g_cost;
      int32_t tok;
      int32_t node;
      bool operator<(const QEntry& o) const { return f_cost > o.f_cost; }
    };
    std::priority_queue<QEntry> pq;
    int32_t root_tok = -1;
    // the very first token (index 0) is the start-state token
    if (!toks_.empty()) root_tok = 0;
    if (root_tok < 0 || beta[root_tok] == kInf) return;
    nodes.push_back(PathNode{-1, -1});
    pq.push(QEntry{beta[root_tok], 0.0f, root_tok, 0});

    std::unordered_map<std::string, int> seen;  // word-seq -> hyp idx
    size_t pops = 0;
    const size_t kMaxPops = 200000;
    while (!pq.empty() && (int)hyps_.size() < opts_.nbest &&
           pops++ < kMaxPops) {
      QEntry e = pq.top();
      pq.pop();
      auto fin = final_of.find(e.tok);
      if (fin != final_of.end()) {
        // complete path
        std::vector<int32_t> rev_links;
        for (int32_t ni = e.node; ni >= 0 && nodes[ni].link >= 0;
             ni = nodes[ni].parent) {
          rev_links.push_back(nodes[ni].link);
        }
        std::reverse(rev_links.begin(), rev_links.end());
        Hyp hyp;
        float gc = fin->second, ac = 0.0f;
        std::vector<int32_t> align;
        std::vector<int32_t> align_frames;
        int emit = 0;
        for (int32_t li : rev_links) {
          const ForwardLink& l = links_[li];
          gc += l.graph_cost;
          ac += l.acoustic_cost;
          int32_t cur_frame =
              emit < (int)decoded_frames_mapping_.size()
                  ? decoded_frames_mapping_[emit]
                  : (decoded_frames_mapping_.empty()
                         ? 0 : decoded_frames_mapping_.back());
          if (l.olabel > 0) {
            hyp.words.push_back(l.olabel);
            // word stamped at the frame of the arc emitting it (the
            // python searcher's convention); eps word-boundary arcs
            // inherit the upcoming emitting frame
            hyp.wtimes.push_back(cur_frame);
          }
          if (l.ilabel > 0) {
            align.push_back(l.ilabel);
            align_frames.push_back(cur_frame);
            emit++;
          }
        }
        std::string key((const char*)hyp.words.data(),
                        hyp.words.size() * sizeof(int32_t));
        if (seen.find(key) == seen.end()) {
          seen[key] = (int)hyps_.size();
          hyp.graph_cost = gc;
          hyp.acoustic_cost = ac;
          hyp.likelihood = -(gc + ac);
          ConvertToInputs(align, align_frames, &hyp);
          hyps_.push_back(std::move(hyp));
        }
        // do not expand past a final token at the last frame: final
        // tokens have no outgoing links anyway
      }
      for (int32_t li = toks_[e.tok].links; li >= 0;
           li = links_[li].next) {
        const ForwardLink& l = links_[li];
        if (beta[l.next_tok] == kInf) continue;
        float g = e.g_cost + l.graph_cost + l.acoustic_cost;
        nodes.push_back(PathNode{e.node, li});
        pq.push(QEntry{g + beta[l.next_tok], g, l.next_tok,
                       (int32_t)nodes.size() - 1});
      }
    }
  }

  Fst fst_;
  Options opts_;
  std::vector<Token> toks_;
  std::vector<ForwardLink> links_;
  std::vector<std::vector<int32_t>> frames_;  // token list per frame
  std::unordered_map<int32_t, int32_t> cur_;  // state -> token (frame)
  int num_frames_ = 0;
  std::vector<int32_t> decoded_frames_mapping_;
  bool is_last_frame_blank_ = false;
  int last_best_ = 0;
  std::vector<float> last_frame_prob_;
  bool finalized_ = false;
  std::vector<Hyp> hyps_;
};

struct Handle {
  Options opts;
  LatticeDecoder* dec = nullptr;
  std::vector<Hyp> partial_vec;
};

}  // namespace

extern "C" {

void* wfst_create(const char* fst_path, int blank_id,
                  float acoustic_scale, float blank_skip_thresh,
                  float blank_scale, float beam, int max_active,
                  int nbest) {
  Handle* h = new Handle();
  Fst fst;
  if (!ParseTextFst(fst_path, &fst)) {
    delete h;
    return nullptr;
  }
  h->opts.blank = blank_id;
  h->opts.acoustic_scale = acoustic_scale;
  h->opts.blank_skip_thresh = blank_skip_thresh;
  h->opts.blank_scale = blank_scale;
  h->opts.beam = beam;
  h->opts.max_active = max_active;
  h->opts.nbest = nbest;
  // move: a production TLG is large — keep exactly one copy resident
  h->dec = new LatticeDecoder(std::move(fst), h->opts);
  return h;
}

void wfst_destroy(void* p) {
  Handle* h = (Handle*)p;
  delete h->dec;
  delete h;
}

void wfst_reset(void* p) { ((Handle*)p)->dec->Reset(); }

void wfst_search(void* p, const float* logp, int T, int V) {
  ((Handle*)p)->dec->Search(logp, T, V);
}

void wfst_finalize(void* p) { ((Handle*)p)->dec->Finalize(); }

// hypotheses: after finalize -> n-best; before -> 1 partial best.
int wfst_num_hyps(void* p) {
  Handle* h = (Handle*)p;
  if (h->dec->finalized()) return (int)h->dec->Hyps().size();
  h->partial_vec.assign(1, h->dec->BestPartial());
  return 1;
}

static const Hyp* GetHyp(Handle* h, int i) {
  if (h->dec->finalized()) {
    if (i < 0 || i >= (int)h->dec->Hyps().size()) return nullptr;
    return &h->dec->Hyps()[i];
  }
  if (h->partial_vec.empty()) h->partial_vec.assign(1, h->dec->BestPartial());
  return &h->partial_vec[0];
}

int wfst_hyp_words_len(void* p, int i) {
  const Hyp* hyp = GetHyp((Handle*)p, i);
  return hyp ? (int)hyp->words.size() : 0;
}

int wfst_hyp_inputs_len(void* p, int i) {
  const Hyp* hyp = GetHyp((Handle*)p, i);
  return hyp ? (int)hyp->inputs.size() : 0;
}

// scores: [likelihood, graph_cost, acoustic_cost]
void wfst_hyp(void* p, int i, int* words, int* wtimes, int* inputs,
              int* times, float* scores) {
  const Hyp* hyp = GetHyp((Handle*)p, i);
  if (!hyp) return;
  if (words) memcpy(words, hyp->words.data(),
                    hyp->words.size() * sizeof(int32_t));
  if (wtimes) memcpy(wtimes, hyp->wtimes.data(),
                     hyp->wtimes.size() * sizeof(int32_t));
  if (inputs) memcpy(inputs, hyp->inputs.data(),
                     hyp->inputs.size() * sizeof(int32_t));
  if (times) memcpy(times, hyp->times.data(),
                    hyp->times.size() * sizeof(int32_t));
  if (scores) {
    scores[0] = hyp->likelihood;
    scores[1] = hyp->graph_cost;
    scores[2] = hyp->acoustic_cost;
  }
}

}  // extern "C"
