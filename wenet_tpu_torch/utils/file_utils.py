"""Symbol-table and list-file readers.  Counterpart of
wenet_tpu/utils/file_utils.py."""

import re
from typing import Dict, List, Optional

_NON_LANG_SYM = re.compile(r"(\[[^\[\]]+\]|<[^<>]+>|{[^{}]+})")


def read_lists(list_file: str) -> List[str]:
    with open(list_file, encoding='utf8') as fin:
        return [line.strip() for line in fin]


def read_non_lang_symbols(non_lang_sym_path: Optional[str]) -> List[str]:
    """One symbol per line, each {x}, <x> or [x]; raises ValueError on
    another form.  None gives no symbols."""
    if non_lang_sym_path is None:
        return []
    syms = read_lists(non_lang_sym_path)
    for sym in syms:
        if _NON_LANG_SYM.fullmatch(sym) is None:
            raise ValueError(f'non-linguistic symbols must be formatted '
                             f'{{xxx}}, <xxx> or [xxx]: {sym!r}')
    return syms


def read_symbol_table(symbol_table_file: str) -> Dict[str, int]:
    """'<symbol> <id>' per line -> {symbol: id}."""
    table = {}
    with open(symbol_table_file, encoding='utf8') as fin:
        for line in fin:
            arr = line.strip().split()
            if len(arr) != 2:
                raise ValueError(f'bad symbol table line: {line!r}')
            table[arr[0]] = int(arr[1])
    return table
