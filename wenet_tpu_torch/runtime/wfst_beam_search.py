"""CTC TLG/WFST beam search by token passing over a text FST, in plain
Python.  Counterpart of wenet_tpu/runtime/wfst_beam_search.py, and the
plain version the C++ lattice decoder (runtime/native_wfst.py) is held
against.

Per frame: if the blank posterior exceeds `blank_skip_thresh` the frame
is skipped; otherwise the top-k tokens advance every active state over
the matching arcs, epsilon closures are followed eagerly, and the beam
keeps the best `max_active` states.  Words come from the arcs' olabels.
For an n-best each state keeps a few tokens with distinct word
histories (`nbest_width`), so `hypotheses` holds different word
sequences with their own costs and times.  Incremental and stateful,
with the streaming searchers' interface (`reset`, `search` on whole
(T, V) log-prob rows, `finalize_search`, `hypotheses`, `likelihood`,
`times`).
"""

import heapq
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from wenet_tpu_torch.lm.fst import TextFst


@dataclass
class _Token:
    cost: float  # total -log score (acoustic*scale + graph)
    words: Tuple[int, ...]
    times: Tuple[int, ...]
    # split costs for k2-style hlg_rescore fusion (ref
    # k2/model.py:286-291: am + lm_scale*lm + decoder scores):
    ac: float = 0.0  # acoustic part
    gc: float = 0.0  # graph (LM) part


class CtcWfstBeamSearch:

    def __init__(self, fst: TextFst,
                 word_table: Optional[Dict[int, str]] = None,
                 beam_size: int = 10,
                 max_active: int = 7000,
                 acoustic_scale: float = 1.0,
                 blank_skip_thresh: float = 0.98,
                 blank_id: int = 0,
                 top_k: int = 10,
                 nbest_width: int = 3):
        self.fst = fst
        self.word_table = word_table or {}
        self.beam_size = beam_size
        self.max_active = max_active
        self.acoustic_scale = acoustic_scale
        self.blank_skip_thresh = blank_skip_thresh
        self.blank_id = blank_id
        self.top_k = top_k
        self.nbest_width = max(1, nbest_width)
        # Graphs built with the full CTC topology
        # (lm/build_graph.py build_token_fst) carry explicit
        # blank arcs (ilabel == blank_id+1): traverse them like any
        # other arc on non-blank frames instead of the implicit
        # stay-at-every-state shortcut (which would let repeats
        # collapse across emitted blanks — legal only for legacy
        # compact-T graphs that have no blank arcs at all).
        self._has_blank_arcs = any(
            arc.ilabel == blank_id + 1
            for arcs in fst.arcs.values() for arc in arcs)
        self.reset()

    def reset(self):
        self.abs_time = 0
        # state -> cost-sorted tokens with distinct word histories
        self.tokens: Dict[int, List[_Token]] = {}
        self._insert(self.tokens, self.fst.start,
                     _Token(0.0, (), (), 0.0, 0.0))
        self._expand_eps()
        self._final = None

    # -- internals -----------------------------------------------------
    def _insert(self, table: Dict[int, List[_Token]], state: int,
                tok: _Token) -> bool:
        """Keep per-state tokens deduped by word history, best-cost
        first, at most nbest_width entries."""
        toks = table.setdefault(state, [])
        for i, cur in enumerate(toks):
            if cur.words == tok.words:
                if tok.cost < cur.cost:
                    toks[i] = tok
                    toks.sort(key=lambda tk: tk.cost)
                    return True
                return False
        if len(toks) < self.nbest_width:
            toks.append(tok)
            toks.sort(key=lambda tk: tk.cost)
            return True
        if tok.cost < toks[-1].cost:
            toks[-1] = tok
            toks.sort(key=lambda tk: tk.cost)
            return True
        return False

    def _expand_eps(self):
        """Eagerly follow ilabel-0 arcs (eps/backoff/word-boundary)."""
        queue = [(state, tok) for state, toks in self.tokens.items()
                 for tok in toks]
        while queue:
            state, tok = queue.pop()
            for arc in self.fst.state_arcs(state):
                if arc.ilabel != 0:
                    continue
                nw = tok.words + ((arc.olabel,) if arc.olabel else ())
                # words emitted on eps-input arcs (label-pushed graphs)
                # inherit the latest emitting frame so words and times
                # stay in lockstep for _update_result's zip
                ntimes = tok.times + (
                    (tok.times[-1] if tok.times else self.abs_time,)
                    if arc.olabel else ())
                nt = _Token(tok.cost + arc.weight, nw, ntimes,
                            tok.ac, tok.gc + arc.weight)
                if self._insert(self.tokens, arc.nextstate, nt):
                    queue.append((arc.nextstate, nt))

    def _prune(self):
        if len(self.tokens) <= self.max_active:
            return
        best = heapq.nsmallest(self.max_active, self.tokens.items(),
                               key=lambda kv: kv[1][0].cost)
        self.tokens = dict(best)

    # -- searcher interface (matches CtcPrefixBeamSearch) --------------
    def search(self, ctc_log_probs: np.ndarray):
        for frame in np.asarray(ctc_log_probs):
            t = self.abs_time
            self.abs_time += 1
            if math.exp(frame[self.blank_id]) > self.blank_skip_thresh:
                continue  # blank frame-skip (stay via implicit self-loop)
            k = min(self.top_k, len(frame))
            cand = set(np.argpartition(-frame, k - 1)[:k].tolist())
            cand.add(int(np.argmax(frame)))
            cand.add(self.blank_id)  # blank arcs always traversable
            blank_ac = -self.acoustic_scale * float(frame[self.blank_id])
            next_tokens: Dict[int, List[_Token]] = {}

            for state, toks in self.tokens.items():
                arcs = self.fst.state_arcs(state)
                for tok in toks:
                    if not self._has_blank_arcs:
                        # legacy compact-T graphs: blank/self-loop is
                        # implicit — stay put paying the blank cost
                        self._insert(next_tokens, state,
                                     _Token(tok.cost + blank_ac,
                                            tok.words, tok.times,
                                            tok.ac + blank_ac, tok.gc))
                    for arc in arcs:
                        if arc.ilabel == 0:
                            continue
                        u = arc.ilabel - 1  # ilabel = ctc_index + 1
                        if u not in cand:
                            continue
                        ac = -self.acoustic_scale * float(frame[u])
                        nw = tok.words + ((arc.olabel,) if arc.olabel
                                          else ())
                        ntimes = tok.times + ((t,) if arc.olabel else ())
                        self._insert(
                            next_tokens, arc.nextstate,
                            _Token(tok.cost + arc.weight + ac, nw,
                                   ntimes, tok.ac + ac,
                                   tok.gc + arc.weight))
            self.tokens = next_tokens
            self._expand_eps()
            self._prune()

    def finalize_search(self):
        """Add final costs; keep only completable paths if any."""
        finals: List[Tuple[float, _Token]] = []
        for state, toks in self.tokens.items():
            fc = self.fst.final_cost(state)
            if fc != float('inf'):
                for tok in toks:
                    finals.append((tok.cost + fc,
                                   _Token(tok.cost + fc, tok.words,
                                          tok.times, tok.ac,
                                          tok.gc + fc)))
        if not finals:
            finals = [(tok.cost, tok) for toks in self.tokens.values()
                      for tok in toks]
        # n-best over DISTINCT word sequences
        best: Dict[Tuple[int, ...], Tuple[float, _Token]] = {}
        for cost, tok in finals:
            cur = best.get(tok.words)
            if cur is None or cost < cur[0]:
                best[tok.words] = (cost, tok)
        pool = sorted(best.values(), key=lambda x: x[0])
        self._final = pool[:self.beam_size]

    def _nbest(self):
        if self._final is not None:
            return self._final
        best: Dict[Tuple[int, ...], Tuple[float, _Token]] = {}
        for toks in self.tokens.values():
            for tok in toks:
                cur = best.get(tok.words)
                if cur is None or tok.cost < cur[0]:
                    best[tok.words] = (tok.cost, tok)
        pool = sorted(best.values(), key=lambda x: x[0])
        return pool[:self.beam_size]

    @property
    def hypotheses(self) -> List[List[int]]:
        return [list(tok.words) for _, tok in self._nbest()]

    @property
    def likelihood(self) -> List[float]:
        return [-cost for cost, _ in self._nbest()]

    @property
    def times(self) -> List[List[int]]:
        return [list(tok.times) for _, tok in self._nbest()]

    def words(self) -> List[str]:
        """Best path as word strings (olabel lookup)."""
        hyps = self.hypotheses
        if not hyps:
            return []
        return [self.word_table.get(w, str(w)) for w in hyps[0]]
