"""Char + BPE tokenizer: CJK characters as chars, the rest through a
sentencepiece model.  Counterpart of wenet_tpu/text/bpe_tokenizer.py.
`sentencepiece` is imported at the first `text2tokens`, which raises
ImportError where it is not installed; `tokens2text` needs no model."""

from os import PathLike
from typing import Dict, List, Optional, Union

from wenet_tpu_torch.text.char_tokenizer import CharTokenizer
from wenet_tpu_torch.text.tokenize_utils import tokenize_by_bpe_model


class BpeTokenizer(CharTokenizer):

    def __init__(self, bpe_model: Union[str, PathLike],
                 symbol_table: Union[str, PathLike, Dict],
                 non_lang_syms: Optional[Union[str, PathLike, List]] = None,
                 split_with_space: bool = False, connect_symbol: str = '',
                 unk: str = '<unk>') -> None:
        super().__init__(symbol_table, non_lang_syms, split_with_space,
                         connect_symbol, unk)
        self._model_path = str(bpe_model)
        self.bpe_model = None  # built at first use; not pickled

    def _build_sp(self):
        if self.bpe_model is None:
            try:
                import sentencepiece as spm
            except ImportError as e:
                raise ImportError(
                    'BpeTokenizer requires sentencepiece; install it or '
                    'use the char/whisper/huggingface tokenizers'
                ) from e
            self.bpe_model = spm.SentencePieceProcessor()
            self.bpe_model.load(self._model_path)

    def __getstate__(self):
        state = self.__dict__.copy()
        state['bpe_model'] = None
        return state

    def text2tokens(self, line: str) -> List[str]:
        self._build_sp()
        line = line.strip()
        if self.non_lang_syms_pattern is not None:
            parts = self.non_lang_syms_pattern.split(line.upper())
            parts = [w.strip() for w in parts if len(w.strip()) > 0]
        else:
            parts = [line]
        tokens = []
        for part in parts:
            if part in self.non_lang_syms:
                tokens.append(part)
            else:
                tokens.extend(tokenize_by_bpe_model(self.bpe_model, part))
        return tokens

    def tokens2text(self, tokens: List[str]) -> str:
        return ''.join(tokens).replace('▁', ' ').strip()
