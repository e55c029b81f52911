"""ctypes wrapper over the port's C++ CTC prefix beam searcher
(`csrc/ctc_prefix_beam_search.cc`).  Counterpart of
wenet_tpu/runtime/native_beam.py: the searcher class (`search_topk`, the
streaming `reset` and `finalize_search`, `hypotheses`, `times`,
`likelihood`) with context biasing (`flatten_context_graph`) and shallow
fusion of an ARPA n-gram LM (`NativeLm`, one flattened copy shared by
every searcher), `batch_search_topk` and `make_searcher`.  The plain
version they are held against is
`utils/context_graph.ctc_prefix_beam_search_with_context`.

The library is compiled with g++ at first use into
`wenet_tpu_torch/build/`, keyed by the hash of the source
(`utils/native.py`), and `build()` raises when the compiler fails: there
is no pure-Python fallback."""

import ctypes
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

from wenet_tpu_torch.utils.native import load_library

_lib: Optional[ctypes.CDLL] = None
_build_lock = threading.Lock()

Hyps = Tuple[List[List[int]], List[List[int]], List[float]]


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    ip, fp = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.ctc_beam_create.restype = vp
    lib.ctc_beam_create.argtypes = [ci, ci]
    lib.ctc_beam_destroy.argtypes = [vp]
    lib.ctc_beam_reset.argtypes = [vp]
    lib.ctc_beam_finalize.argtypes = [vp]
    lib.ctc_beam_search_topk.restype = ci
    lib.ctc_beam_search_topk.argtypes = [vp, fp, ip, ci, ci]
    lib.ctc_beam_num_hyps.restype = ci
    lib.ctc_beam_num_hyps.argtypes = [vp]
    lib.ctc_beam_hyp_len.restype = ci
    lib.ctc_beam_hyp_len.argtypes = [vp, ci]
    lib.ctc_beam_hyp.argtypes = [vp, ci, ip, ip, dp]
    lib.ctc_beam_set_context.argtypes = [vp, ci, ip, fp, fp, fp, ci, ip, ip,
                                         ip]
    lib.ctc_lm_create.restype = vp
    lib.ctc_lm_create.argtypes = [ci, ci, ip, ci, ci]
    lib.ctc_lm_add_table.argtypes = [vp, ci, ci, ip, fp, fp]
    lib.ctc_lm_destroy.argtypes = [vp]
    lib.ctc_beam_attach_lm.argtypes = [vp, vp, ctypes.c_double]


def build() -> ctypes.CDLL:
    """Compile (once per hash of the source) and load the library; safe
    to call from several threads."""
    global _lib
    with _build_lock:
        if _lib is None:
            lib = load_library('ctc_prefix_beam_search.cc', 'ctc_beam')
            _declare(lib)
            _lib = lib
        return _lib


def _carr(dtype, seq):
    a = np.ascontiguousarray(seq, dtype)
    ptr = {np.int32: ctypes.POINTER(ctypes.c_int),
           np.float32: ctypes.POINTER(ctypes.c_float)}[dtype]
    return a, a.ctypes.data_as(ptr)


def flatten_context_graph(graph):
    """ContextGraph (utils/context_graph.py) -> the C++ searcher's flat
    arrays (fail, node_score, output_score, token_score, and the (n, 3)
    transitions from, token, to).  Cached on the graph, which does not
    change once built: a batch makes one searcher per utterance."""
    flat = getattr(graph, '_native_flat', None)
    if flat is not None:
        return flat
    n = graph.num_nodes + 1
    fail = np.zeros(n, np.int32)
    node_score = np.zeros(n, np.float32)
    output_score = np.zeros(n, np.float32)
    token_score = np.zeros(n, np.float32)
    trans = []
    stack = [graph.root]
    seen = set()
    while stack:
        node = stack.pop()
        if node.id in seen:
            continue
        seen.add(node.id)
        fail[node.id] = node.fail.id if node.fail is not None else 0
        node_score[node.id] = node.node_score
        output_score[node.id] = node.output_score
        token_score[node.id] = node.token_score
        for tok, child in node.next.items():
            trans.append((node.id, tok, child.id))
            stack.append(child)
    trans = np.asarray(trans or np.zeros((0, 3)), np.int32)
    flat = (fail, node_score, output_score, token_score, trans)
    graph._native_flat = flat
    return flat


def _flatten_lm(lm, symbol_table, vocab_size):
    """NgramLM (lm/arpa.py) -> (tok2word, bos, eos, tables) over word ids;
    tables[k] = (ids (count, k+1), logp, backoff), natural log.  A token
    the LM does not know maps to <unk> (-1 without one)."""
    word2id = {}

    def wid(w):
        if w not in word2id:
            word2id[w] = len(word2id)
        return word2id[w]

    tables = []
    for k, grams in enumerate(lm.ngrams):
        ids = np.zeros((len(grams), k + 1), np.int32)
        logp = np.zeros(len(grams), np.float32)
        backoff = np.zeros(len(grams), np.float32)
        for e, (words, (lp, bo)) in enumerate(grams.items()):
            for j, w in enumerate(words):
                ids[e, j] = wid(w)
            logp[e] = lp
            backoff[e] = bo
        tables.append((ids, logp, backoff))
    unk = word2id.get('<unk>', -1)
    symbol_table = symbol_table or {}
    tok2word = np.full(vocab_size, unk, np.int32)
    for t in range(vocab_size):
        sym = symbol_table.get(t, str(t))
        if sym in lm.vocab:
            tok2word[t] = word2id[sym]
    bos = word2id.get('<s>', -9)  # -9 matches nothing: backs off
    eos = word2id.get('</s>', unk)
    return tok2word, bos, eos, tables


def _lm_vocab(symbol_table, vocab_size):
    if vocab_size:
        return int(vocab_size)
    return (max(symbol_table) + 1) if symbol_table else 65536


class NativeLm:
    """An ARPA LM flattened into the C++ library once and attached to any
    number of searchers (read-only, safe across threads).
    `symbol_table` maps token id -> LM word (a char model's tokens are
    its words); tokens up to `vocab_size` (default: the table's largest
    id + 1) are mapped."""

    def __init__(self, lm, symbol_table=None, vocab_size=0):
        self._lib = build()
        tok2word, bos, eos, tables = _flatten_lm(
            lm, symbol_table, _lm_vocab(symbol_table, vocab_size))
        _, p_t2w = _carr(np.int32, tok2word)
        self.handle = self._lib.ctc_lm_create(lm.order, len(tok2word), p_t2w,
                                              bos, eos)
        for k, (ids, logp, backoff) in enumerate(tables):
            _, p_i = _carr(np.int32, ids)
            _, p_l = _carr(np.float32, logp)
            _, p_b = _carr(np.float32, backoff)
            self._lib.ctc_lm_add_table(self.handle, k + 1, ids.shape[0],
                                       p_i, p_l, p_b)

    def __del__(self):
        if getattr(self, 'handle', None):
            self._lib.ctc_lm_destroy(self.handle)
            self.handle = None

    @classmethod
    def get(cls, lm, symbol_table=None, vocab_size=0) -> 'NativeLm':
        """The flattened copy cached on `lm` itself (it dies with the LM),
        reused while the symbol table is equal and covers `vocab_size`."""
        vocab = _lm_vocab(symbol_table, vocab_size)
        ent = getattr(lm, '_native_lm_cache', None)
        if ent is not None:
            c_syms, c_vocab, native = ent
            if c_vocab >= vocab and c_syms == symbol_table:
                return native
        native = cls(lm, symbol_table, vocab)
        lm._native_lm_cache = (symbol_table, vocab, native)
        return native


class NativeCtcPrefixBeamSearch:
    """One utterance's incremental prefix beam (a C++ searcher): feed it
    chunk by chunk with `search_topk`, close it with `finalize_search`,
    start the next utterance with `reset`.  `context_graph` biases it;
    `lm` (an NgramLM) is fused with `lm_weight`, its words found through
    `symbol_table` (token id -> word)."""

    def __init__(self, beam_size: int = 10, blank_id: int = 0,
                 context_graph=None, lm=None, lm_weight: float = 0.5,
                 symbol_table=None, lm_vocab_size: int = 0):
        self._lib = build()
        self._h = self._lib.ctc_beam_create(beam_size, blank_id)
        self.beam_size = beam_size
        self.blank_id = blank_id
        self._cache: Optional[Hyps] = None
        if context_graph is not None:
            fail, ns, os_, ts, trans = flatten_context_graph(context_graph)
            # the arrays stay referenced until the call returns
            scores = [_carr(np.float32, a) for a in (ns, os_, ts)]
            cols = [_carr(np.int32, trans[:, i]) for i in range(3)]
            self._lib.ctc_beam_set_context(
                self._h, len(fail), _carr(np.int32, fail)[1],
                *[p for _, p in scores], len(trans), *[p for _, p in cols])
        if lm is not None:
            self._native_lm = NativeLm.get(lm, symbol_table, lm_vocab_size)
            self._lib.ctc_beam_attach_lm(self._h, self._native_lm.handle,
                                         ctypes.c_double(lm_weight))

    def __del__(self):
        if getattr(self, '_h', None):
            self._lib.ctc_beam_destroy(self._h)
            self._h = None

    def reset(self) -> None:
        """Back to the empty prefix, for a new utterance."""
        self._lib.ctc_beam_reset(self._h)
        self._cache = None

    def search_topk(self, vals: np.ndarray, ids: np.ndarray) -> None:
        """Advance over per-frame candidates: vals, ids (T, K), the top-k
        of the frame's log-posteriors.  Raises after `finalize_search`."""
        vals = np.ascontiguousarray(vals, np.float32)
        ids = np.ascontiguousarray(ids, np.int32)
        T, K = vals.shape
        if T == 0:
            return
        self._cache = None
        if self._lib.ctc_beam_search_topk(
                self._h, vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), T, K):
            raise RuntimeError('search after finalize_search: reset first')

    def finalize_search(self) -> None:
        """End of the utterance: the LM's </s> and the biasing back-off
        (without either the beam only closes)."""
        self._lib.ctc_beam_finalize(self._h)
        self._cache = None

    @property
    def hypotheses(self) -> List[List[int]]:
        return self.results()[0]

    @property
    def times(self) -> List[List[int]]:
        return self.results()[1]

    @property
    def likelihood(self) -> List[float]:
        return self.results()[2]

    def results(self) -> Hyps:
        """(hyps, times, scores), best first; read from the C++ beam once
        after each search."""
        if self._cache is not None:
            return self._cache
        hyps, times, scores = [], [], []
        for i in range(self._lib.ctc_beam_num_hyps(self._h)):
            n = self._lib.ctc_beam_hyp_len(self._h, i)
            toks = (ctypes.c_int * max(n, 1))()
            tms = (ctypes.c_int * max(n, 1))()
            score = ctypes.c_double()
            self._lib.ctc_beam_hyp(self._h, i, toks, tms,
                                   ctypes.byref(score))
            hyps.append(list(toks[:n]))
            times.append(list(tms[:n]))
            scores.append(float(score.value))
        self._cache = (hyps, times, scores)
        return self._cache


def batch_search_topk(vals: np.ndarray, ids: np.ndarray, lens: np.ndarray,
                      beam_size: int, blank_id: int = 0,
                      context_graph=None, lm=None, lm_weight: float = 0.5,
                      symbol_table=None, finalize: bool = False
                      ) -> List[Hyps]:
    """The C++ beam over a batch, one searcher per utterance, in up to 8
    threads (ctypes releases the GIL in the C call).  vals, ids:
    (B, T, K); lens: (B,) valid frames.  Each search is finalized when
    `finalize` is set or a context graph or an LM takes part.  Returns
    (hyps, times, scores) per utterance."""
    lm_vocab = 0
    if lm is not None and symbol_table is None and ids.size:
        lm_vocab = int(ids.max()) + 1

    def one(b):
        s = NativeCtcPrefixBeamSearch(
            beam_size, blank_id, context_graph=context_graph, lm=lm,
            lm_weight=lm_weight, symbol_table=symbol_table,
            lm_vocab_size=lm_vocab)
        n = int(lens[b])
        s.search_topk(vals[b, :n], ids[b, :n])
        if finalize or context_graph is not None or lm is not None:
            s.finalize_search()
        return s.results()

    B = vals.shape[0]
    if B == 1:
        return [one(0)]
    with ThreadPoolExecutor(min(8, B)) as ex:
        return list(ex.map(one, range(B)))


def make_searcher(beam_size: int = 10, blank_id: int = 0,
                  context_graph=None, lm=None, lm_weight: float = 0.5,
                  symbol_table=None) -> NativeCtcPrefixBeamSearch:
    """The streaming searcher, with biasing and LM fusion in the C++
    loop (there is no Python fallback)."""
    return NativeCtcPrefixBeamSearch(beam_size, blank_id,
                                     context_graph=context_graph, lm=lm,
                                     lm_weight=lm_weight,
                                     symbol_table=symbol_table)
