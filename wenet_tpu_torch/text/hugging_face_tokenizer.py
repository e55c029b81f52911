"""A huggingface tokenizer (`AutoTokenizer.from_pretrained`).  Counterpart
of wenet_tpu/text/hugging_face_tokenizer.py; `transformers` is imported
at first use."""

from os import PathLike
from typing import Dict, List, Union

from wenet_tpu_torch.text.base_tokenizer import BaseTokenizer


class HuggingFaceTokenizer(BaseTokenizer):

    def __init__(self, model: Union[str, PathLike], *args, **kwargs) -> None:
        self.model = model
        self.tokenizer = None
        self.args = args
        self.kwargs = kwargs

    def _build(self):
        if self.tokenizer is None:
            from transformers import AutoTokenizer
            self.tokenizer = AutoTokenizer.from_pretrained(
                self.model, *self.args, **self.kwargs)
            self.t2i = self.tokenizer.get_vocab()

    def __getstate__(self):
        state = self.__dict__.copy()
        state['tokenizer'] = None
        return state

    def text2tokens(self, line: str) -> List[str]:
        self._build()
        return self.tokenizer.tokenize(line)

    def tokens2text(self, tokens: List[str]) -> str:
        self._build()
        return self.tokenizer.convert_tokens_to_string(tokens)

    def tokens2ids(self, tokens: List[str]) -> List[int]:
        self._build()
        return self.tokenizer.convert_tokens_to_ids(tokens)

    def ids2tokens(self, ids: List[int]) -> List[str]:
        self._build()
        return self.tokenizer.convert_ids_to_tokens(ids)

    def vocab_size(self) -> int:
        self._build()
        return len(self.tokenizer)

    @property
    def symbol_table(self) -> Dict[str, int]:
        self._build()
        return self.t2i
