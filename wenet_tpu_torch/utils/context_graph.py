"""Context biasing: an Aho-Corasick trie with fail and output arcs.
Counterpart of wenet_tpu/utils/context_graph.py: `tokenize`,
`ContextState`, `ContextGraph` and the Python prefix beam search with
biasing, `ctc_prefix_beam_search_with_context`, the plain version the
C++ searcher's context and LM paths (runtime/native_beam.py) are held
against; beside the JAX function's biasing it takes an n-gram LM for
shallow fusion, as the JAX package's Python streaming searcher does."""

import math
from collections import defaultdict, deque
from typing import Dict, List, Optional, Tuple


def tokenize(context_list_path: str, symbol_table: Dict[str, int],
             tokenizer=None) -> List[List[int]]:
    """Biasing phrases, one a line -> token id lists: through `tokenizer`
    when given, else char by char through `symbol_table` (a space is
    '▁', an unknown char <unk> when the table has it, else dropped)."""
    with open(context_list_path, encoding='utf-8') as fin:
        lines = [line.strip() for line in fin if line.strip()]
    out = []
    for txt in lines:
        labels = []
        if tokenizer is not None:
            _, labels = tokenizer.tokenize(txt)
        else:
            for ch in txt:
                if ch == ' ':
                    ch = '▁'
                if ch in symbol_table:
                    labels.append(symbol_table[ch])
                elif '<unk>' in symbol_table:
                    labels.append(symbol_table['<unk>'])
        out.append(labels)
    return out


class ContextState:
    """A node of the trie: its token, the score of the arc into it, the
    score of the path from the root (node_score), and what a match ending
    here adds (output_score, its own and its output links')."""

    def __init__(self, id: int, token: int, token_score: float,
                 node_score: float, output_score: float, is_end: bool):
        self.id = id
        self.token = token
        self.token_score = token_score
        self.node_score = node_score
        self.output_score = output_score
        self.is_end = is_end
        self.next: Dict[int, 'ContextState'] = {}
        self.fail: Optional['ContextState'] = None
        self.output: Optional['ContextState'] = None


class ContextGraph:
    """Aho-Corasick biasing graph over the phrases' token ids: each
    token of a phrase scores `context_score`; a partial match that breaks
    off gives its score back along the fail arcs."""

    def __init__(self, context_list_path: str,
                 symbol_table: Dict[str, int], tokenizer=None,
                 context_score: float = 6.0,
                 context_list: Optional[List[List[int]]] = None):
        self.context_score = context_score
        if context_list is None:
            context_list = tokenize(context_list_path, symbol_table,
                                    tokenizer)
        self.context_list = context_list
        self.num_nodes = 0
        self.root = ContextState(0, -1, 0, 0, 0, False)
        self.root.fail = self.root
        self.build_graph(self.context_list)

    def build_graph(self, token_ids: List[List[int]]):
        for tokens in token_ids:
            node = self.root
            for i, token in enumerate(tokens):
                if token not in node.next:
                    self.num_nodes += 1
                    is_end = i == len(tokens) - 1
                    node_score = node.node_score + self.context_score
                    node.next[token] = ContextState(
                        self.num_nodes, token, self.context_score,
                        node_score, node_score if is_end else 0, is_end)
                node = node.next[token]
        self._fill_fail_output()

    def _fill_fail_output(self):
        queue = deque()
        for node in self.root.next.values():
            node.fail = self.root
            queue.append(node)
        while queue:
            current = queue.popleft()
            for token, node in current.next.items():
                fail = current.fail
                if token in fail.next:
                    fail = fail.next[token]
                else:
                    fail = fail.fail
                    while token not in fail.next:
                        fail = fail.fail
                        if fail.token == -1:
                            break
                    if token in fail.next:
                        fail = fail.next[token]
                node.fail = fail
                output = node.fail
                while not output.is_end:
                    output = output.fail
                    if output.token == -1:
                        output = None
                        break
                node.output = output
                node.output_score += (0 if output is None else
                                      output.output_score)
                queue.append(node)

    def forward_one_step(self, state: ContextState,
                         token: int) -> Tuple[float, ContextState]:
        if token in state.next:
            node = state.next[token]
            score = node.token_score
        else:
            node = state.fail
            while token not in node.next:
                node = node.fail
                if node.token == -1:
                    break
            if token in node.next:
                node = node.next[token]
            score = node.node_score - state.node_score
        return score + node.output_score, node

    def finalize(self, state: ContextState) -> Tuple[float, ContextState]:
        return -state.node_score, self.root


# ---------------------------------------------------------------------------
# the prefix beam search with biasing and LM fusion, in Python
# ---------------------------------------------------------------------------
def _log_add(a: float, b: float) -> float:
    if a == -float('inf') and b == -float('inf'):
        return -float('inf')
    m = max(a, b)
    return m + math.log(math.exp(a - m) + math.exp(b - m))


class _PrefixScore:
    """A prefix's blank / non-blank log-probs, their Viterbi scores and
    times, and its biasing state."""

    __slots__ = ('s', 'ns', 'v_s', 'v_ns', 'cur_token_prob', 'times_s',
                 'times_ns', 'context_state', 'context_score',
                 'has_context')

    def __init__(self, s=-float('inf'), ns=-float('inf'),
                 v_s=-float('inf'), v_ns=-float('inf'),
                 context_state=None, context_score=0.0):
        self.s = s
        self.ns = ns
        self.v_s = v_s
        self.v_ns = v_ns
        self.cur_token_prob = -float('inf')
        self.times_s: List[int] = []
        self.times_ns: List[int] = []
        self.context_state = context_state
        self.context_score = context_score
        self.has_context = False

    def score(self):
        return _log_add(self.s, self.ns)

    def viterbi_score(self):
        return self.v_s if self.v_s > self.v_ns else self.v_ns

    def times(self):
        return self.times_s if self.v_s > self.v_ns else self.times_ns

    def total_score(self):
        return self.score() + self.context_score

    def copy_context(self, other):
        self.context_score = other.context_score
        self.context_state = other.context_state

    def update_context(self, graph, other, word_id):
        self.copy_context(other)
        score, state = graph.forward_one_step(other.context_state,
                                              word_id)
        self.context_score += score
        self.context_state = state


class _LmScores:
    """Cumulative LM scores of prefixes, each extended from its parent's
    by one token (`symbol_table`: token id -> LM word, the id's string
    when missing).  A word the LM does not know enters the history as
    <unk> when the LM has it, as in the C++ searcher (the JAX package's
    Python searcher keeps the word, which differs where <unk> has a
    back-off weight)."""

    def __init__(self, lm, symbol_table):
        self.lm = lm
        self.symbol_table = symbol_table or {}
        self.cache = {tuple(): (0.0, lm.start_state())}

    def __call__(self, prefix: tuple) -> float:
        cached = self.cache.get(prefix)
        if cached is None:
            base = self(prefix[:-1])
            state = self.cache[prefix[:-1]][1]
            word = self.symbol_table.get(int(prefix[-1]),
                                         str(int(prefix[-1])))
            if word not in self.lm.vocab and '<unk>' in self.lm.vocab:
                word = '<unk>'
            delta, nstate = self.lm.advance(state, word)
            cached = (base + delta, nstate)
            self.cache[prefix] = cached
        return cached[0]

    def finish(self, prefix: tuple) -> None:
        """Add the end-of-sentence score to `prefix`'s."""
        self(prefix)
        score, state = self.cache[prefix]
        self.cache[prefix] = (score + self.lm.final(state), state)


def ctc_prefix_beam_search_with_context(ctc_probs, ctc_lens, beam_size,
                                        context_graph=None, blank_id=0,
                                        lm=None, lm_weight: float = 0.5,
                                        symbol_table=None):
    """The CTC prefix beam search, one utterance at a time, with biasing
    by `context_graph` and shallow fusion of the n-gram `lm` (each
    optional): prefixes are pruned by score + bias + lm_weight * LM
    score; at the end the LM's </s> is added and the beam re-sorted, and
    each hypothesis' bias is replaced by the back-off of its unfinished
    match (-node_score).

    ctc_probs: (B, T, V) log-posteriors (array or tensor); ctc_lens: (B,).
    Returns one DecodeResult per utterance with its n-best, scores and
    times."""
    import numpy as np
    from wenet_tpu_torch.models.transformer.search import DecodeResult
    graph = context_graph
    results = []
    for i in range(ctc_probs.shape[0]):
        ctc_prob = np.asarray(ctc_probs[i])
        num_t = int(ctc_lens[i])
        lm_score = (_LmScores(lm, symbol_table) if lm is not None
                    else lambda prefix: 0.0)

        def fused(item):
            return item[1].total_score() + lm_weight * lm_score(item[0])

        cur_hyps = [(tuple(),
                     _PrefixScore(s=0.0, ns=-float('inf'), v_s=0.0,
                                  v_ns=0.0,
                                  context_state=(graph.root if graph
                                                 else None)))]
        for t in range(num_t):
            logp = ctc_prob[t]
            next_hyps = defaultdict(_PrefixScore)
            top_k_index = np.argpartition(-logp, beam_size)[:beam_size]
            for u in top_k_index:
                u = int(u)
                prob = float(logp[u])
                for prefix, ps in cur_hyps:
                    last = prefix[-1] if prefix else None
                    if u == blank_id:
                        nxt = next_hyps[prefix]
                        nxt.s = _log_add(nxt.s, ps.score() + prob)
                        nxt.v_s = ps.viterbi_score() + prob
                        nxt.times_s = ps.times().copy()
                        if graph is not None and not nxt.has_context:
                            nxt.copy_context(ps)
                            nxt.has_context = True
                    elif u == last:
                        n1 = next_hyps[prefix]
                        n1.ns = _log_add(n1.ns, ps.ns + prob)
                        if n1.v_ns < ps.v_ns + prob:
                            n1.v_ns = ps.v_ns + prob
                            if n1.cur_token_prob < prob:
                                n1.cur_token_prob = prob
                                n1.times_ns = ps.times_ns.copy()
                                if n1.times_ns:
                                    n1.times_ns[-1] = t
                        if graph is not None and not n1.has_context:
                            n1.copy_context(ps)
                            n1.has_context = True
                        n_prefix = prefix + (u,)
                        n2 = next_hyps[n_prefix]
                        n2.ns = _log_add(n2.ns, ps.s + prob)
                        if n2.v_ns < ps.v_s + prob:
                            n2.v_ns = ps.v_s + prob
                            n2.cur_token_prob = prob
                            n2.times_ns = ps.times_s.copy()
                            n2.times_ns.append(t)
                        if graph is not None and not n2.has_context:
                            n2.update_context(graph, ps, u)
                            n2.has_context = True
                    else:
                        n_prefix = prefix + (u,)
                        nxt = next_hyps[n_prefix]
                        nxt.ns = _log_add(nxt.ns, ps.score() + prob)
                        if nxt.v_ns < ps.viterbi_score() + prob:
                            nxt.v_ns = ps.viterbi_score() + prob
                            nxt.cur_token_prob = prob
                            nxt.times_ns = ps.times().copy()
                            nxt.times_ns.append(t)
                        if graph is not None and not nxt.has_context:
                            nxt.update_context(graph, ps, u)
                            nxt.has_context = True
            cur_hyps = sorted(next_hyps.items(), key=fused,
                              reverse=True)[:beam_size]
        if lm is not None:
            for prefix, _ in cur_hyps:
                lm_score.finish(prefix)
            cur_hyps.sort(key=fused, reverse=True)
        if graph is not None:
            for _, ps in cur_hyps:
                ps.context_score, ps.context_state = graph.finalize(
                    ps.context_state)
        nbest = [list(y[0]) for y in cur_hyps]
        nbest_scores = [fused(y) for y in cur_hyps]
        nbest_times = [y[1].times() for y in cur_hyps]
        results.append(
            DecodeResult(tokens=nbest[0], score=nbest_scores[0],
                         times=nbest_times[0], nbest=nbest,
                         nbest_scores=nbest_scores,
                         nbest_times=nbest_times))
    return results
