"""Paraformer's tokenizer: characters of the symbol table, with English
words split by a segmentation dict.  Counterpart of
wenet_tpu/text/paraformer_tokenizer.py."""

from os import PathLike
from typing import Dict, List, Optional, Union

from wenet_tpu_torch.text.char_tokenizer import CharTokenizer
from wenet_tpu_torch.text.tokenize_utils import tokenize_by_seg_dict


def read_seg_dict(path) -> Dict[str, str]:
    """`word<TAB>piece piece ...` lines -> {word: 'piece piece ...'}."""
    seg_table = {}
    with open(path, encoding='utf8') as fin:
        for line in fin:
            arr = line.strip().split('\t')
            assert len(arr) == 2
            seg_table[arr[0]] = arr[1]
    return seg_table


class ParaformerTokenizer(CharTokenizer):

    def __init__(self, symbol_table: Union[str, PathLike, Dict],
                 seg_dict: Optional[Union[str, PathLike, Dict]] = None,
                 split_with_space: bool = False, connect_symbol: str = '',
                 unk: str = '<unk>') -> None:
        super().__init__(symbol_table, None, split_with_space,
                         connect_symbol, unk)
        if seg_dict is not None and not isinstance(seg_dict, dict):
            seg_dict = read_seg_dict(seg_dict)
        self.seg_dict = seg_dict

    def text2tokens(self, line: str) -> List[str]:
        assert self.seg_dict is not None
        return tokenize_by_seg_dict(self.seg_dict, line.strip())
