"""Whisper's byte-level BPE tokenizer.  Counterpart of
wenet_tpu/text/whisper_tokenizer.py, which builds a `tiktoken.Encoding`
over a `*.tiktoken` rank file: here the same encoding is plain Python, so
that nothing but the rank file is needed.

- The rank file holds `base64(token bytes) rank` lines.
- Text is pre-split as the pattern
  `'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+`
  splits it (`pre_split`), with \\p{L} and \\p{N} the Unicode general
  categories L* and N*, and \\s Unicode White_Space.
- A piece that is a rank is one token.  Otherwise its bytes are merged,
  over and over, at the adjacent pair whose concatenation has the lowest
  rank, the leftmost on ties (tiktoken's `byte_pair_merge`).
- Special-token text in a transcript is encoded as ordinary text
  (`disallowed_special=()`), and decoding joins the tokens' bytes as UTF-8
  with `errors='replace'`.

The special tokens follow the text ranks in whisper's layout
(models/whisper/tokens.py `special_token_ids`): endoftext,
startoftranscript, `num_languages` languages, six task tokens and 1501
timestamps."""

import base64
import os
import unicodedata
from typing import Dict, List, Optional

from wenet_tpu_torch.models.whisper.tokens import special_token_ids
from wenet_tpu_torch.text.base_tokenizer import BaseTokenizer

# Unicode White_Space (what \s matches); str.isspace also takes \x1c-\x1f
_WHITE_SPACE = frozenset(
    '\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004'
    '\u2005\u2006\u2007\u2008\u2009\u200a\u2028\u2029\u202f\u205f\u3000')
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
_SPACE, _LETTER, _NUMBER, _OTHER = range(4)


def _char_class(c: str) -> int:
    if c in _WHITE_SPACE:
        return _SPACE
    cat = unicodedata.category(c)[0]
    return _LETTER if cat == 'L' else _NUMBER if cat == 'N' else _OTHER


def pre_split(text: str) -> List[str]:
    """The pieces the whisper pattern finds in `text`, in order; they
    join back to `text`."""
    classes = [_char_class(c) for c in text]
    n, i, pieces = len(text), 0, []
    while i < n:
        if text[i] == "'":
            c = next((c for c in _CONTRACTIONS if text.startswith(c, i)),
                     None)
            if c is not None:
                pieces.append(c)
                i += len(c)
                continue
        # ' ?X+' for X letters, numbers or other: an optional ' ' joins
        # a run of the class of the character after it
        start = i + 1 if text[i] == ' ' and i + 1 < n and \
            classes[i + 1] != _SPACE else i
        cls = classes[start]
        if cls != _SPACE:
            j = start + 1
            while j < n and classes[j] == cls:
                j += 1
            pieces.append(text[i:j])
            i = j
            continue
        # whitespace: '\s+(?!\S)' leaves the run's last character to the
        # piece after it, unless the run ends the text or is one
        # character long ('\s+' then takes it)
        j = i + 1
        while j < n and classes[j] == _SPACE:
            j += 1
        if j < n and j - i > 1:
            j -= 1
        pieces.append(text[i:j])
        i = j
    return pieces


def byte_pair_merge(ranks: Dict[bytes, int], piece: bytes) -> List[int]:
    """The ranks of `piece`'s tokens: merge the adjacent pair of parts
    whose concatenation has the lowest rank (the leftmost of equals)
    until no pair is a rank."""
    parts = [piece[i:i + 1] for i in range(len(piece))]
    while len(parts) > 1:
        best, at = None, -1
        for i in range(len(parts) - 1):
            r = ranks.get(parts[i] + parts[i + 1])
            if r is not None and (best is None or r < best):
                best, at = r, i
        if best is None:
            break
        parts[at:at + 2] = [parts[at] + parts[at + 1]]
    return [ranks[p] for p in parts]


def read_ranks(path: str) -> Dict[bytes, int]:
    """A `*.tiktoken` file -> {token bytes: rank}."""
    ranks = {}
    with open(path, 'rb') as f:
        for line in f:
            if not line.strip():
                continue
            token, rank = line.split()
            ranks[base64.b64decode(token)] = int(rank)
    return ranks


class _Encoding:
    """Byte-level BPE over `ranks` with `specials` decoded as their text."""

    def __init__(self, ranks: Dict[bytes, int], specials: Dict[str, int]):
        self.ranks = ranks
        self.decoder = {r: t for t, r in ranks.items()}
        self.decoder.update({r: t.encode('utf-8')
                             for t, r in specials.items()})
        self.n_vocab = max(self.decoder) + 1

    def encode(self, text: str) -> List[int]:
        ids = []
        for piece in pre_split(text):
            b = piece.encode('utf-8')
            r = self.ranks.get(b)
            if r is not None:
                ids.append(r)
            else:
                ids.extend(byte_pair_merge(self.ranks, b))
        return ids

    def decode(self, ids: List[int]) -> str:
        return b''.join(self.decoder[int(i)] for i in ids).decode(
            'utf-8', errors='replace')


class WhisperTokenizer(BaseTokenizer):

    def __init__(self, multilingual: bool = True, num_languages: int = 100,
                 language: Optional[str] = None, task: Optional[str] = None,
                 vocab_path: Optional[str] = None) -> None:
        self.multilingual = multilingual
        self.num_languages = num_languages
        self.language = language
        self.task = task
        if vocab_path is None:
            name = ('multilingual.tiktoken'
                    if multilingual else 'gpt2.tiktoken')
            for base in (os.environ.get('WENET_WHISPER_ASSETS', ''),
                         os.path.expanduser('~/.wenet/whisper_assets')):
                cand = os.path.join(base, name) if base else None
                if cand and os.path.exists(cand):
                    vocab_path = cand
                    break
        self._vocab_path = vocab_path
        self.tokenizer = None
        self._t2i: Dict[str, int] = {}

    def _build(self):
        if self.tokenizer is not None:
            return
        if self._vocab_path is None or not os.path.exists(self._vocab_path):
            raise FileNotFoundError(
                'whisper tiktoken vocab not found; set '
                'WENET_WHISPER_ASSETS or pass vocab_path '
                '(ship multilingual.tiktoken next to the checkpoint)')
        ranks = read_ranks(self._vocab_path)
        # the full special set, multilingual or not (as whisper's)
        specials = special_token_ids(len(ranks), self.num_languages)
        self.tokenizer = _Encoding(ranks, specials)
        self._t2i = dict(specials)

    def __getstate__(self):
        state = self.__dict__.copy()
        state['tokenizer'] = None
        state['_t2i'] = {}
        return state

    @property
    def special_tokens(self) -> Dict[str, int]:
        """sot / eot / task / timestamp ids for the decode prompt."""
        self._build()
        t = self._t2i
        return {
            'sot': t['<|startoftranscript|>'],
            'eot': t['<|endoftext|>'],
            'transcribe': t['<|transcribe|>'],
            'translate': t['<|translate|>'],
            'sot_prev': t['<|startofprev|>'],
            'no_speech': t['<|nospeech|>'],
            'no_timestamps': t['<|notimestamps|>'],
            'timestamp_begin': t['<|0.00|>'],
        }

    def text2tokens(self, line: str) -> List[int]:
        self._build()
        return self.tokenizer.encode(line)

    def tokens2text(self, tokens: List[int]) -> str:
        self._build()
        return self.tokenizer.decode(tokens)

    def tokens2ids(self, tokens: List[int]) -> List[int]:
        return list(tokens)  # whisper's tokens are ids

    def ids2tokens(self, ids: List[int]) -> List[int]:
        return list(ids)

    def detokenize(self, ids: List[int]):
        """(text of the ids below the special tokens, those ids)."""
        self._build()
        n_base = self.tokenizer.n_vocab - len(self._t2i)
        content = [i for i in ids if i < n_base]
        return self.tokenizer.decode(content), content

    def vocab_size(self) -> int:
        self._build()
        return self.tokenizer.n_vocab

    @property
    def symbol_table(self) -> Dict[str, int]:
        self._build()
        return dict(self._t2i)
