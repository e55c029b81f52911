"""Tokenizer interface.  Counterpart of wenet_tpu/text/base_tokenizer.py."""

from abc import ABC, abstractmethod
from typing import Dict, List, Tuple, Union

T = Union[str, bytes]


class BaseTokenizer(ABC):

    def tokenize(self, line: str) -> Tuple[List[T], List[int]]:
        tokens = self.text2tokens(line)
        return tokens, self.tokens2ids(tokens)

    def detokenize(self, ids: List[int]) -> Tuple[str, List[T]]:
        tokens = self.ids2tokens(ids)
        return self.tokens2text(tokens), tokens

    @abstractmethod
    def text2tokens(self, line: str) -> List[T]:
        ...

    @abstractmethod
    def tokens2text(self, tokens: List[T]) -> str:
        ...

    @abstractmethod
    def tokens2ids(self, tokens: List[T]) -> List[int]:
        ...

    @abstractmethod
    def ids2tokens(self, ids: List[int]) -> List[T]:
        ...

    @abstractmethod
    def vocab_size(self) -> int:
        ...

    @property
    @abstractmethod
    def symbol_table(self) -> Dict[T, int]:
        ...
