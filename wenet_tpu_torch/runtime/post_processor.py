"""Result post-processing: space handling, symbol removal, optional ITN.
Counterpart of wenet_tpu/runtime/post_processor.py.  Behavior:

* kMandarinEnglish: spaces between mandarin chars are dropped, kept
  only between consecutive english words (code-switch safe).
* '▁' (BPE space, U+2581) becomes ' ' with head/tail/dup squeezing.
* `<unk>/<context>/</context>` markers removed.
* ITN (inverse text normalization, "一百二十三" -> "123") is delegated
  to WeTextProcessing's `itn` package when it is installed, else to the
  rule-based numerals of runtime/itn.py.
"""

import enum
from dataclasses import dataclass, field
from typing import Optional

SPACE_SYMBOL = '▁'


class LanguageType(enum.Enum):
    MANDARIN_ENGLISH = 0
    INDO_EUROPEAN = 1


@dataclass
class PostProcessOptions:
    language_type: LanguageType = LanguageType.MANDARIN_ENGLISH
    lowercase: bool = True
    itn: bool = False


def _is_english_word(word: str) -> bool:
    return bool(word) and all('a' <= c <= 'z' or 'A' <= c <= 'Z'
                              for c in word)


def _process_blank(s: str, lowercase: bool) -> str:
    out = []
    for ch in s.strip():
        if ch != SPACE_SYMBOL:
            out.append(ch)
        elif out and out[-1] != ' ':
            out.append(' ')
    result = ''.join(out).rstrip()
    return result.lower() if lowercase else result


class PostProcessor:

    def __init__(self, opts: Optional[PostProcessOptions] = None):
        self.opts = opts or PostProcessOptions()
        self._itn = None
        if self.opts.itn:
            try:
                from itn import Normalizer  # WeTextProcessing FSTs
            except ImportError:  # rule-based numerals only
                from wenet_tpu_torch.runtime.itn import Normalizer
            self._itn = Normalizer()

    def process_symbols(self, s: str) -> str:
        for sub in ('<unk>', '<context>', '</context>'):
            s = s.replace(sub, '')
        return s

    def process_space(self, s: str) -> str:
        if (self.opts.language_type is LanguageType.MANDARIN_ENGLISH
                and s):
            words = s.split()
            out = []
            prev_en = False
            for w in words:
                now_en = _is_english_word(w)
                if prev_en and now_en:
                    out.append(' ')
                out.append(w)
                prev_en = now_en
            s = ''.join(out)
        return _process_blank(s, self.opts.lowercase)

    def process(self, s: str, finish: bool = True) -> str:
        s = self.process_symbols(s)
        s = self.process_space(s)
        if finish and self._itn is not None:
            s = self._itn.normalize(s)
        return s
