"""ARPA back-off n-gram language model, read and scored in Python.
Counterpart of wenet_tpu/lm/arpa.py: the ARPA file is read directly and a
word is scored with Katz back-off (what a G graph compiled from the same
file encodes), in natural log (ARPA stores log10; converted on load).
The C++ prefix beam takes a flattened copy (runtime/native_beam.py)."""

import gzip
import math
from typing import Dict, List, Sequence, Tuple

LOG10 = math.log(10.0)


class NgramLM:

    def __init__(self, order: int,
                 ngrams: List[Dict[Tuple[str, ...],
                                   Tuple[float, float]]]):
        self.order = order
        # ngrams[n-1]: (w1..wn) -> (logprob, backoff) in natural log
        self.ngrams = ngrams
        self.vocab = {w[0] for w in ngrams[0]}

    # -- scoring -------------------------------------------------------
    def score_word(self, context: Sequence[str], word: str) -> float:
        """log P(word | context) with Katz back-off; a word the LM does
        not know is <unk>, or -20 without one."""
        if word not in self.vocab:
            word = '<unk>'
            if word not in self.vocab:
                return -20.0
        context = tuple(context)[-(self.order - 1):] if self.order > 1 \
            else ()
        return self._score_backed(context, word)

    def _score_backed(self, context: Tuple[str, ...], word: str) -> float:
        """P(w|c) = ngram(c,w) if present else backoff(c)*P(w|c[1:])."""
        total = 0.0
        while True:
            entry = self.ngrams[len(context)].get(context + (word,))
            if entry is not None:
                return total + entry[0]
            if not context:
                return total - 20.0  # word missing from unigrams
            bo = self.ngrams[len(context) - 1].get(context)
            total += bo[1] if bo is not None else 0.0
            context = context[1:]

    def score_sequence(self, words: Sequence[str],
                       bos: bool = True, eos: bool = True) -> float:
        context: List[str] = ['<s>'] if bos else []
        total = 0.0
        for w in words:
            total += self.score_word(context, w)
            context.append(w)
        if eos:
            total += self.score_word(context, '</s>')
        return total

    # -- state API (for beam search fusion) -----------------------------
    def start_state(self) -> Tuple[str, ...]:
        return ('<s>',)

    def advance(self, state: Tuple[str, ...],
                word: str) -> Tuple[float, Tuple[str, ...]]:
        s = self.score_word(state, word)
        new = (state + (word,))[-(self.order - 1):] if self.order > 1 \
            else ()
        return s, new

    def final(self, state: Tuple[str, ...]) -> float:
        return self.score_word(state, '</s>')


def read_arpa(path: str) -> NgramLM:
    opener = gzip.open if path.endswith('.gz') else open
    with opener(path, 'rt', encoding='utf-8') as f:
        lines = iter(f)
        # header
        counts = []
        for line in lines:
            line = line.strip()
            if line == '\\data\\':
                break
        cur = None
        for line in lines:
            line = line.strip()
            if line.startswith('ngram'):
                counts.append(int(line.split('=')[1]))
            elif line:
                if line.startswith('\\') and '-grams:' in line:
                    cur = int(line[1:line.index('-')]) - 1
                break
        order = len(counts)
        ngrams: List[Dict[Tuple[str, ...], Tuple[float, float]]] = \
            [dict() for _ in range(order)]
        for line in lines:
            line = line.strip()
            if not line:
                continue
            if line.startswith('\\') and '-grams:' in line:
                cur = int(line[1:line.index('-')]) - 1
                continue
            if line == '\\end\\':
                break
            if cur is None:
                continue
            parts = line.split('\t')
            if len(parts) < 2:
                parts = line.split()
                if len(parts) < cur + 2:
                    continue
                logp = float(parts[0])
                words = tuple(parts[1:cur + 2])
                backoff = float(parts[cur + 2]) \
                    if len(parts) > cur + 2 else 0.0
            else:
                logp = float(parts[0])
                words = tuple(parts[1].split())
                backoff = float(parts[2]) if len(parts) > 2 else 0.0
            ngrams[cur][words] = (logp * LOG10, backoff * LOG10)
    return NgramLM(order, ngrams)
