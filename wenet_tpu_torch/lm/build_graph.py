"""TLG graph building in plain Python (no openfst).  Counterpart of
wenet_tpu/lm/build_graph.py (the CTC token FST, the lexicon, G from an
ARPA n-gram, composition and connect, `build_tlg` and its alias
`build_hlg`; the LF-MMI denominator graph `build_den_graph` over a
token bigram, `build_token_bigram_fst`).

    T (CTC topology)  o  L (lexicon)  o  G (ARPA n-gram)  ->  TLG.txt

Composition uses the 3-state epsilon-sequencing filter, then connect
(trim).  There is no determinization or minimization: they shrink the
graph but Viterbi token passing does not need them, and without them no
#N disambiguation symbols are needed either.  The output is the JAX
package's byte for byte (same states, same order, same weights).

tokens.txt has <eps>=0, <blank>=1 and the units from 2; words.txt has
<eps>=0 and the words from 1.  Weights are tropical -log probs.

    from wenet_tpu_torch.lm.build_graph import build_tlg
    build_tlg('units.txt', 'lexicon.txt', 'lm.arpa', 'lang_test')
    # -> lang_test/{tokens.txt, words.txt, TLG.txt}

HLG.txt (the k2 model's decode graph) is the same composition, written
as TLG.txt; den.txt comes from `build_den_graph(seqs, num_units,
outdir)`.  Both equal what the JAX package's tools/k2/make_hlg.sh and
tools/k2/prepare_mmi.py write.
"""

import math
import os
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from wenet_tpu_torch.lm.arpa import NgramLM, read_arpa
from wenet_tpu_torch.lm.fst import Arc, TextFst

NEG_COST = float('inf')


# ---------------------------------------------------------------------------
# construction helpers
# ---------------------------------------------------------------------------
def _add_arc(fst: TextFst, src: int, dst: int, il: int, ol: int,
             w: float = 0.0):
    fst.arcs.setdefault(src, []).append(Arc(il, ol, w, dst))


def build_token_fst(num_units: int) -> TextFst:
    """CTC topology T over token ids (ref tools/fst/ctc_token_fst.py):
    blank self-loop at state 0; per-unit state with entry arc emitting
    the unit, repeat self-loop emitting eps, eps return to 0.

    ilabels/olabels are tokens.txt ids: <blank>=1, units 2..num_units+1.
    """
    fst = TextFst()
    fst.start = 0
    _add_arc(fst, 0, 0, 1, 0)  # blank self-loop
    for u in range(num_units):
        sym = u + 2
        state = u + 1
        _add_arc(fst, 0, state, sym, sym)
        _add_arc(fst, state, state, sym, 0)  # repeat collapse
        _add_arc(fst, state, 0, 0, 0)
    fst.finals[0] = 0.0
    return fst


def build_lexicon_fst(lexicon: Sequence[Tuple[str, Sequence[str]]],
                      token_ids: Dict[str, int],
                      word_ids: Dict[str, int]) -> TextFst:
    """L: maps token sequences to words (ref
    tools/fst/make_lexicon_fst.pl without disambig symbols — we never
    determinize LG).  First arc of each pronunciation carries the word
    olabel; closure at the root accepts word sequences."""
    fst = TextFst()
    fst.start = 0
    fst.finals[0] = 0.0
    state = 1
    for word, prons in lexicon:
        wid = word_ids[word]
        cur = 0
        for i, unit in enumerate(prons):
            il = token_ids[unit]
            ol = wid if i == 0 else 0
            if i == len(prons) - 1:
                _add_arc(fst, cur, 0, il, ol)
            else:
                _add_arc(fst, cur, state, il, ol)
                cur = state
                state += 1
    return fst


def build_g_fst(lm: NgramLM, word_ids: Dict[str, int]) -> TextFst:
    """G: ARPA backoff n-gram as a word acceptor (ref
    kaldi/lm/arpa-lm-compiler.cc semantics): one state per n-gram
    context, word arcs with -log P, eps backoff arcs with -log backoff,
    final cost = -log P(</s> | context)."""
    fst = TextFst()
    state_of: Dict[Tuple[str, ...], int] = {}

    def get_state(ctx: Tuple[str, ...]) -> int:
        # contexts longer than order-1 can't index an ARPA entry
        ctx = ctx[-(lm.order - 1):] if lm.order > 1 else ()
        while ctx and ctx not in lm.ngrams[len(ctx) - 1]:
            ctx = ctx[1:]
        if ctx not in state_of:
            state_of[ctx] = len(state_of)
        return state_of[ctx]

    # index (n+1)-grams by their length-n prefix context
    by_ctx: List[Dict[Tuple[str, ...], List[Tuple[str, float]]]] = [
        {} for _ in range(lm.order)
    ]
    for n, grams in enumerate(lm.ngrams):
        for gram, (logp, _) in grams.items():
            by_ctx[n].setdefault(gram[:-1], []).append((gram[-1], logp))

    start = get_state(('<s>',))
    fst.start = start
    # enumerate reachable contexts breadth-first
    seen = set()
    queue = deque([('<s>',) if lm.order > 1 else ()])
    while queue:
        ctx = queue.popleft()
        ctx = ctx[-(lm.order - 1):] if lm.order > 1 else ()
        while ctx and ctx not in lm.ngrams[len(ctx) - 1]:
            ctx = ctx[1:]
        if ctx in seen:
            continue
        seen.add(ctx)
        src = get_state(ctx)
        # backoff arc to the shortened context
        if ctx:
            entry = lm.ngrams[len(ctx) - 1].get(ctx)
            bo = entry[1] if entry is not None else 0.0
            _add_arc(fst, src, get_state(ctx[1:]), 0, 0, -bo)
            queue.append(ctx[1:])
        # word arcs for every ngram continuing this exact context
        for word, logp in by_ctx[len(ctx)].get(ctx, ()):
            if word in ('</s>', '<s>') or word not in word_ids:
                continue
            nctx = ctx + (word,)
            _add_arc(fst, src, get_state(nctx), word_ids[word],
                     word_ids[word], -logp)
            queue.append(nctx)
        # final cost: P(</s> | ctx) resolved through backoff
        fst.finals[src] = -lm._score_backed(ctx, '</s>')
    return fst


# ---------------------------------------------------------------------------
# composition (3-state epsilon filter) + connect
# ---------------------------------------------------------------------------
def compose(fa: TextFst, fb: TextFst) -> TextFst:
    """Weighted composition a o b with the epsilon-sequencing filter
    (Mohri's filter states: 0 = match, 1 = a-eps only, 2 = b-eps only).
    Matches openfst `fstcompose` up to state numbering."""
    out = TextFst()
    state_of: Dict[Tuple[int, int, int], int] = {}

    def get_state(key):
        if key not in state_of:
            state_of[key] = len(state_of)
        return state_of[key]

    # b's arcs of each state by input label, in arc order (built once a
    # state: a unigram state with one arc a unit meets every unit state)
    by_il: Dict[int, Dict[int, List[Arc]]] = {}

    def b_arcs_by_il(qb):
        if qb not in by_il:
            table = by_il[qb] = {}
            for arc in fb.state_arcs(qb):
                table.setdefault(arc.ilabel, []).append(arc)
        return by_il[qb]

    start = (fa.start, fb.start, 0)
    out.start = get_state(start)
    queue = deque([start])
    seen = set()
    while queue:
        key = queue.popleft()
        if key in seen:
            continue
        seen.add(key)
        qa, qb, f = key
        src = get_state(key)
        fca, fcb = fa.final_cost(qa), fb.final_cost(qb)
        if fca != NEG_COST and fcb != NEG_COST:
            out.finals[src] = fca + fcb
        a_arcs = fa.state_arcs(qa)
        # matched moves (olabel of a == ilabel of b, nonzero)
        b_by_il = b_arcs_by_il(qb)
        for aa in a_arcs:
            if aa.olabel != 0:
                for bb in b_by_il.get(aa.olabel, ()):
                    nkey = (aa.nextstate, bb.nextstate, 0)
                    _add_arc(out, src, get_state(nkey), aa.ilabel,
                             bb.olabel, aa.weight + bb.weight)
                    queue.append(nkey)
            else:
                if f == 0:
                    # combined eps move (Mohri's filter eps2:eps1 in
                    # state 0): an a output-eps arc and a b input-eps
                    # arc advance TOGETHER.  Without it, any path that
                    # needs adjacent a-eps + b-eps moves (e.g. an LM
                    # backoff right after blank/repeat self-loops in
                    # compose(TL, G)) is unreachable, because a-alone
                    # locks filter 1 where b-eps is forbidden and vice
                    # versa.  Allowed only from filter 0 -> 0, so each
                    # eps interleaving still has exactly one route (no
                    # path duplication — critical for the log-semiring
                    # FSA forward in the LF-MMI denominator).
                    for bb in b_by_il.get(0, ()):
                        nkey = (aa.nextstate, bb.nextstate, 0)
                        _add_arc(out, src, get_state(nkey), aa.ilabel,
                                 bb.olabel, aa.weight + bb.weight)
                        queue.append(nkey)
                if f != 2:
                    # a moves alone on output-eps (filter forbids after
                    # a b-eps move until a match resets it)
                    nkey = (aa.nextstate, qb, 1)
                    _add_arc(out, src, get_state(nkey), aa.ilabel, 0,
                             aa.weight)
                    queue.append(nkey)
        if f != 1:
            for bb in b_by_il.get(0, ()):
                nkey = (qa, bb.nextstate, 2)
                _add_arc(out, src, get_state(nkey), 0, bb.olabel,
                         bb.weight)
                queue.append(nkey)
    return connect(out)


def connect(fst: TextFst) -> TextFst:
    """Trim states not on a start->final path (openfst fstconnect)."""
    # forward reachability
    fwd = set()
    queue = deque([fst.start])
    while queue:
        s = queue.popleft()
        if s in fwd:
            continue
        fwd.add(s)
        for arc in fst.state_arcs(s):
            queue.append(arc.nextstate)
    # backward from finals over reversed arcs
    rev: Dict[int, List[int]] = {}
    for s in fwd:
        for arc in fst.state_arcs(s):
            rev.setdefault(arc.nextstate, []).append(s)
    bwd = set()
    queue = deque(s for s in fst.finals if s in fwd)
    while queue:
        s = queue.popleft()
        if s in bwd:
            continue
        bwd.add(s)
        for p in rev.get(s, ()):
            queue.append(p)
    keep = fwd & bwd
    remap = {s: i for i, s in enumerate(sorted(keep))}
    out = TextFst()
    if fst.start not in remap:
        return out  # empty language
    out.start = remap[fst.start]
    for s in keep:
        for arc in fst.state_arcs(s):
            if arc.nextstate in keep:
                _add_arc(out, remap[s], remap[arc.nextstate], arc.ilabel,
                         arc.olabel, arc.weight)
        if s in fst.finals:
            out.finals[remap[s]] = fst.finals[s]
    return out


def write_text(fst: TextFst, path: str):
    """Serialize in AT&T text format (`fstprint` layout), start first."""
    with open(path, 'w', encoding='utf-8') as f:
        states = sorted(fst.arcs.keys() | fst.finals.keys())
        order = [fst.start] + [s for s in states if s != fst.start]
        for s in order:
            for arc in fst.state_arcs(s):
                f.write(f'{s} {arc.nextstate} {arc.ilabel} '
                        f'{arc.olabel} {arc.weight}\n')
            if s in fst.finals:
                f.write(f'{s} {fst.finals[s]}\n')


# ---------------------------------------------------------------------------
# top-level pipelines
# ---------------------------------------------------------------------------
def read_lexicon(path: str) -> List[Tuple[str, List[str]]]:
    """lexicon.txt: `word unit1 unit2 ...` per line."""
    lex = []
    with open(path, encoding='utf-8') as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                lex.append((parts[0], parts[1:]))
    return lex


def read_units(path: str) -> List[str]:
    """units.txt: `unit [id]` per line (id column optional)."""
    units = []
    with open(path, encoding='utf-8') as f:
        for line in f:
            parts = line.split()
            if parts and parts[0] not in ('<eps>', '<blank>'):
                units.append(parts[0])
    return units


def build_tlg(units_path: str, lexicon_path: str, arpa_path: str,
              outdir: str) -> TextFst:
    """Full TLG pipeline (ref compile_lexicon_token_fst.sh +
    make_tlg.sh), pure python.  Writes tokens.txt, words.txt, TLG.txt
    under `outdir` and returns the composed graph."""
    os.makedirs(outdir, exist_ok=True)
    units = read_units(units_path)
    lexicon = read_lexicon(lexicon_path)
    lm = read_arpa(arpa_path)

    token_ids = {'<eps>': 0, '<blank>': 1}
    for i, u in enumerate(units):
        token_ids[u] = i + 2
    words = sorted({w for w, _ in lexicon})
    word_ids = {'<eps>': 0}
    for i, w in enumerate(words):
        word_ids[w] = i + 1

    with open(os.path.join(outdir, 'tokens.txt'), 'w',
              encoding='utf-8') as f:
        for sym, i in token_ids.items():
            f.write(f'{sym} {i}\n')
    with open(os.path.join(outdir, 'words.txt'), 'w',
              encoding='utf-8') as f:
        for sym, i in word_ids.items():
            f.write(f'{sym} {i}\n')

    t_fst = build_token_fst(len(units))
    l_fst = build_lexicon_fst(lexicon, token_ids, word_ids)
    g_fst = build_g_fst(lm, word_ids)
    lg = compose(l_fst, g_fst)
    tlg = compose(t_fst, lg)
    write_text(tlg, os.path.join(outdir, 'TLG.txt'))
    return tlg


# The k2 model's HLG is the same composition, the CTC topology playing H.
build_hlg = build_tlg


def build_token_bigram_fst(token_seqs: Sequence[Sequence[int]],
                           num_units: int,
                           interp: float = 0.8) -> TextFst:
    """An interpolated backoff bigram over the units (tokens.txt ids, units
    at 2..num_units+1) as a token acceptor.  Each seen bigram's arc costs
    -log(interp * p_ML(v|u)), and an eps backoff arc -log(1 - interp) to
    the unigram state, whose arcs cost -log of add-one unigram
    probabilities: in the log semiring the two paths sum to the
    interpolated probability."""
    uni_counts: Dict[int, float] = {}
    bi_counts: Dict[Tuple[int, int], float] = {}
    ctx_totals: Dict[int, float] = {}
    EOS = -1
    total = 0.0
    for seq in token_seqs:
        prev = None
        for tok in seq:
            uni_counts[tok] = uni_counts.get(tok, 0.0) + 1
            total += 1
            if prev is not None:
                bi_counts[(prev, tok)] = bi_counts.get((prev, tok),
                                                       0.0) + 1
                ctx_totals[prev] = ctx_totals.get(prev, 0.0) + 1
            prev = tok
        if prev is not None:
            bi_counts[(prev, EOS)] = bi_counts.get((prev, EOS), 0.0) + 1
            ctx_totals[prev] = ctx_totals.get(prev, 0.0) + 1
    uni_counts[EOS] = uni_counts.get(EOS, 0.0) + max(len(token_seqs), 1)
    total += uni_counts[EOS]

    fst = TextFst()
    UNI = 0  # the unigram (backoff) state
    fst.start = UNI
    V = num_units + 1  # the units and eos
    by_ctx: Dict[int, List[Tuple[int, float]]] = {}
    for (u, v), c in bi_counts.items():
        by_ctx.setdefault(u, []).append((v, c))

    def p_uni(tok):
        return (uni_counts.get(tok, 0.0) + 1.0) / (total + V)

    ctx_states = {u: i + 1
                  for i, u in enumerate(sorted({k[0] for k in bi_counts}))}
    # unigram arcs: UNI -> the context state of v (UNI if v has none)
    for v in range(2, num_units + 2):
        _add_arc(fst, UNI, ctx_states.get(v, UNI), v, v, -math.log(p_uni(v)))
    fst.finals[UNI] = -math.log(p_uni(EOS))
    for u, src in ctx_states.items():
        for v, c in by_ctx.get(u, ()):
            p = interp * (c / ctx_totals[u])
            if v == EOS:
                fst.finals[src] = -math.log(p)
            else:
                _add_arc(fst, src, ctx_states.get(v, UNI), v, v,
                         -math.log(p))
        _add_arc(fst, src, UNI, 0, 0, -math.log(1.0 - interp))
    return fst


def build_den_graph(token_seqs: Sequence[Sequence[int]], num_units: int,
                    outdir: Optional[str] = None,
                    interp: float = 0.8) -> TextFst:
    """The LF-MMI denominator graph: the CTC topology composed with the
    token bigram of `token_seqs` (CTC unit ids >= 1, shifted here to
    tokens.txt ids).  Writes `outdir`/den.txt when `outdir` is given."""
    shifted = [[t + 1 for t in seq] for seq in token_seqs]
    den = compose(build_token_fst(num_units),
                  build_token_bigram_fst(shifted, num_units, interp))
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        write_text(den, os.path.join(outdir, 'den.txt'))
    return den
