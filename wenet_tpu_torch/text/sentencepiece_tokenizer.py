"""A plain sentencepiece model as the tokenizer.  Counterpart of
wenet_tpu/text/sentencepiece_tokenizer.py; `sentencepiece` is imported at
first use."""

from typing import Dict, List

from wenet_tpu_torch.text.base_tokenizer import BaseTokenizer


class SentencepieceTokenizer(BaseTokenizer):

    def __init__(self, model_path: str) -> None:
        self._model_path = model_path
        self.model = None

    def _build(self):
        if self.model is None:
            try:
                import sentencepiece as spm
            except ImportError as e:
                raise ImportError(
                    'SentencepieceTokenizer requires sentencepiece'
                ) from e
            self.model = spm.SentencePieceProcessor()
            self.model.load(self._model_path)

    def __getstate__(self):
        state = self.__dict__.copy()
        state['model'] = None
        return state

    def text2tokens(self, line: str) -> List[str]:
        self._build()
        return self.model.encode_as_pieces(line)

    def tokens2text(self, tokens: List[str]) -> str:
        self._build()
        return self.model.decode_pieces(tokens)

    def tokens2ids(self, tokens: List[str]) -> List[int]:
        self._build()
        return [self.model.piece_to_id(t) for t in tokens]

    def ids2tokens(self, ids: List[int]) -> List[str]:
        self._build()
        return [self.model.id_to_piece(i) for i in ids]

    def vocab_size(self) -> int:
        self._build()
        return self.model.get_piece_size()

    @property
    def symbol_table(self) -> Dict[str, int]:
        self._build()
        return {self.model.id_to_piece(i): i
                for i in range(self.vocab_size())}
