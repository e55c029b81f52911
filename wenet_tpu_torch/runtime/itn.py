"""Lightweight rule-based Mandarin inverse text normalization.
Counterpart of wenet_tpu/runtime/itn.py.

Fallback for WeTextProcessing's FST ITN where that is not installed: spoken
Chinese numerals are rewritten to digits ("一百二十三" -> "123",
"百分之三十" -> "30%", "三点一四" -> "3.14").  Conservative: only
numeral runs that contain a magnitude unit or are at least two
characters long are rewritten, so ordinary words keep their characters.
"""

import re

_DIGITS = {'零': 0, '〇': 0, '一': 1, '二': 2, '两': 2, '三': 3,
           '四': 4, '五': 5, '六': 6, '七': 7, '八': 8, '九': 9}
_SMALL_UNITS = {'十': 10, '百': 100, '千': 1000}
_BIG_UNITS = {'万': 10**4, '亿': 10**8}
_NUM_CHARS = set(_DIGITS) | set(_SMALL_UNITS) | set(_BIG_UNITS) | {'点'}
_RUN = re.compile('([' + ''.join(_NUM_CHARS) + ']+)')
# negative lookbehind: '五百分之一' is the fraction 1/500, not 五 + 100%-
# of-一 — don't match when a numeral precedes 百
_PERCENT = re.compile('(?<![' + ''.join(_NUM_CHARS) + '])'
                      '百分之([' + ''.join(_NUM_CHARS) + ']+)')


def _parse_int(s: str):
    """Spoken-form integer -> value, or None if not a number."""
    if not s:
        return None
    total = 0      # completed 万/亿 sections
    section = 0    # current section below 万
    num = 0        # pending digit
    for ch in s:
        if ch in _DIGITS:
            num = num * 10 + _DIGITS[ch] if num else _DIGITS[ch]
        elif ch in _SMALL_UNITS:
            section += (num if num else 1) * _SMALL_UNITS[ch]
            num = 0
        elif ch == '万':
            section = (section + num) * _BIG_UNITS[ch]
            num = 0
        elif ch == '亿':
            total = (total + section + num) * _BIG_UNITS[ch]
            section = num = 0
        else:
            return None
    return total + section + num


def _parse_run(s: str):
    """Full numeral run incl. decimals; returns string or None."""
    if '点' in s:
        parts = s.split('点')
        if len(parts) != 2:
            return None
        ip = _parse_int(parts[0])
        if ip is None or not parts[1]:
            return None
        frac = []
        for ch in parts[1]:
            if ch not in _DIGITS:
                return None
            frac.append(str(_DIGITS[ch]))
        return f'{ip}.{"".join(frac)}'
    # digit-string form ("一九九七" -> 1997) when no units present
    if all(ch in _DIGITS for ch in s) and len(s) >= 2:
        return ''.join(str(_DIGITS[ch]) for ch in s)
    v = _parse_int(s)
    return None if v is None else str(v)


def normalize(text: str) -> str:
    def pct(m):
        v = _parse_run(m.group(1))
        return f'{v}%' if v is not None else m.group(0)

    text = _PERCENT.sub(pct, text)

    def num(m):
        s = m.group(1)
        if len(s) == 1 and s not in _SMALL_UNITS:
            return s  # lone digit char: leave prose alone
        # fraction construction 'X分之Y' (X/Y): leave the spoken form
        # untouched on BOTH sides — converting either the denominator
        # (run before 分之) or the numerator (run after it) corrupts it
        if text[m.end():m.end() + 2] == '分之':
            return s
        if text[max(m.start() - 2, 0):m.start()] == '分之':
            return s
        v = _parse_run(s)
        return v if v is not None else s

    return _RUN.sub(num, text)


class Normalizer:
    """Duck-typed drop-in for WeTextProcessing's itn.Normalizer."""

    def normalize(self, text: str) -> str:
        return normalize(text)
