"""Punctuation restoration after transcription.  Counterpart of
wenet_tpu/cli/punc_model.py: a TorchScript punctuation model (final.zip),
its units.txt and an optional jieba user dictionary in `model_dir`; the
text is cut into words with jieba (an optional dependency: ImportError
when it is absent) and a mark is put after each word."""

import logging
import os
from typing import Callable, List

import torch

from wenet_tpu_torch.text.char_tokenizer import CharTokenizer

PUNC_TABLE = ['<unk>', '', '，', '。', '？', '、']


def load_punc_model(model_dir: str) -> Callable[[str], str]:
    """-> a function from text to punctuated text."""
    try:
        import jieba
    except ImportError as e:
        raise ImportError(
            'punctuation restoration needs jieba (pip install jieba) '
            'plus a punc model dir (final.zip + units.txt), as in the '
            'reference cli/punc_model.py') from e
    logging.getLogger('jieba').disabled = True
    model = torch.jit.load(os.path.join(model_dir, 'final.zip'),
                           map_location='cpu')
    tokenizer = CharTokenizer(os.path.join(model_dir, 'units.txt'))
    usr_dict = os.path.join(model_dir, 'jieba_usr_dict')
    if os.path.exists(usr_dict):
        jieba.load_userdict(usr_dict)

    def apply(text: str) -> str:
        words: List[str] = list(jieba.cut(text))
        ids = tokenizer.tokens2ids(words)
        with torch.inference_mode():
            log_probs = model(torch.tensor([ids], dtype=torch.int64))
        if isinstance(log_probs, tuple):
            log_probs = log_probs[0]
        preds = log_probs.argmax(-1)[0].tolist()
        out = []
        for w, p in zip(words, preds):
            out.append(w)
            if 0 <= p < len(PUNC_TABLE):
                out.append(PUNC_TABLE[p])
        return ''.join(out)

    return apply
