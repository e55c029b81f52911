"""Mixed CJK / BPE tokenization.  The port's copy of
wenet_tpu/text/tokenize_utils.py: CJK characters are tokens of their own,
the other runs go through a sentencepiece model (`encode_as_pieces`) or a
segmentation dict."""

import re

_CJK = re.compile(r'([一-鿿])')


def tokenize_by_bpe_model(sp, txt):
    return _tokenize_mixed(txt, sp=sp, upper=True)


def tokenize_by_seg_dict(seg_dict, txt):
    return _tokenize_mixed(txt, seg_dict=seg_dict, upper=False)


def _tokenize_mixed(txt, sp=None, seg_dict=None, upper=True):
    tokens = []
    chars = _CJK.split(txt.upper() if upper else txt)
    mix_chars = [w for w in chars if len(w.strip()) > 0]
    for ch_or_w in mix_chars:
        if _CJK.fullmatch(ch_or_w) is not None:
            tokens.append(ch_or_w)
        elif sp is not None:
            tokens.extend(sp.encode_as_pieces(ch_or_w))
        else:
            for en_token in ch_or_w.split():
                en_token = en_token.strip()
                if en_token in seg_dict:
                    tokens.extend(seg_dict[en_token].split(' '))
                else:
                    tokens.append(en_token)
    return tokens
