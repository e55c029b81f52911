"""Tokenizer factory from train.yaml.  Counterpart of
wenet_tpu/utils/init_tokenizer.py for the char tokenizer; the others
(whisper, bpe, paraformer, sentencepiece, huggingface) are not ported
and raise NotImplementedError."""

import logging

from wenet_tpu_torch.text.base_tokenizer import BaseTokenizer


def init_tokenizer(configs) -> BaseTokenizer:
    tokenizer_type = configs.get('tokenizer', 'char')
    if tokenizer_type != 'char':
        raise NotImplementedError(
            f'the {tokenizer_type} tokenizer is not ported (ROADMAP.md, '
            'queue 1 item 4)')
    from wenet_tpu_torch.text.char_tokenizer import CharTokenizer
    conf = configs.get('tokenizer_conf', {})
    tokenizer = CharTokenizer(
        conf['symbol_table_path'], conf.get('non_lang_syms_path'),
        split_with_space=conf.get('split_with_space', False),
        connect_symbol=conf.get('connect_symbol', ''))
    logging.info('use %s tokenizer', tokenizer_type)
    return tokenizer
