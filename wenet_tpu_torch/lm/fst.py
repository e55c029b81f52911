"""Text-format WFSTs (the AT&T / `fstprint` layout) for TLG decoding.
Counterpart of wenet_tpu/lm/fst.py.

A graph is read from its text form, so no openfst runtime is needed where
it is decoded: the searchers are runtime/wfst_beam_search.py (plain
Python) and runtime/native_wfst.py (C++).  Arcs follow the tropical
semiring: ilabel = CTC index + 1 with 0 = <eps>, olabel = word id, weight
= -log prob (costs add)."""

from dataclasses import dataclass
from typing import Dict, List


@dataclass
class Arc:
    ilabel: int
    olabel: int
    weight: float
    nextstate: int


class TextFst:

    def __init__(self):
        self.start = 0
        self.arcs: Dict[int, List[Arc]] = {}
        self.finals: Dict[int, float] = {}

    @classmethod
    def read(cls, path: str) -> 'TextFst':
        """Parse lines of `src dst ilabel olabel [weight]` (an arc) or
        `state [weight]` (a final state); the first line's state is the
        start."""
        fst = cls()
        first = True
        with open(path, encoding='utf-8') as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                if len(parts) >= 4:
                    src, dst = int(parts[0]), int(parts[1])
                    il, ol = int(parts[2]), int(parts[3])
                    w = float(parts[4]) if len(parts) > 4 else 0.0
                    fst.arcs.setdefault(src, []).append(Arc(il, ol, w, dst))
                    state = src
                else:
                    state = int(parts[0])
                    fst.finals[state] = (float(parts[1]) if len(parts) > 1
                                         else 0.0)
                if first:
                    fst.start = state
                    first = False
        return fst

    def state_arcs(self, s: int) -> List[Arc]:
        return self.arcs.get(s, [])

    def final_cost(self, s: int) -> float:
        return self.finals.get(s, float('inf'))


def read_symbol_table(path: str) -> Dict[int, str]:
    """words.txt / tokens.txt: `symbol id` per line -> {id: symbol}."""
    table = {}
    with open(path, encoding='utf-8') as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                table[int(parts[1])] = parts[0]
    return table
