"""Tokenizer factory from train.yaml.  Counterpart of
wenet_tpu/utils/init_tokenizer.py: whisper, char, bpe, paraformer,
sentencepiece and huggingface."""

import logging

from wenet_tpu_torch.text.base_tokenizer import BaseTokenizer


def init_tokenizer(configs) -> BaseTokenizer:
    tokenizer_type = configs.get('tokenizer', 'char')
    conf = configs.get('tokenizer_conf', {})
    if tokenizer_type == 'whisper':
        from wenet_tpu_torch.text.whisper_tokenizer import WhisperTokenizer
        tokenizer = WhisperTokenizer(
            multilingual=conf['is_multilingual'],
            num_languages=conf['num_languages'],
            vocab_path=conf.get('vocab_path'))
    elif tokenizer_type == 'char':
        from wenet_tpu_torch.text.char_tokenizer import CharTokenizer
        tokenizer = CharTokenizer(
            conf['symbol_table_path'], conf.get('non_lang_syms_path'),
            split_with_space=conf.get('split_with_space', False),
            connect_symbol=conf.get('connect_symbol', ''))
    elif tokenizer_type == 'bpe':
        from wenet_tpu_torch.text.bpe_tokenizer import BpeTokenizer
        tokenizer = BpeTokenizer(
            conf['bpe_path'], conf['symbol_table_path'],
            conf.get('non_lang_syms_path'),
            split_with_space=conf.get('split_with_space', False))
    elif tokenizer_type == 'paraformer':
        from wenet_tpu_torch.text.paraformer_tokenizer import (
            ParaformerTokenizer)
        tokenizer = ParaformerTokenizer(
            symbol_table=conf['symbol_table_path'],
            seg_dict=conf['seg_dict_path'])
    elif tokenizer_type == 'sentencepiece':
        from wenet_tpu_torch.text.sentencepiece_tokenizer import (
            SentencepieceTokenizer)
        tokenizer = SentencepieceTokenizer(model_path=conf['model_path'])
    elif tokenizer_type == 'huggingface':
        from wenet_tpu_torch.text.hugging_face_tokenizer import (
            HuggingFaceTokenizer)
        tokenizer = HuggingFaceTokenizer(model=conf['model'])
    else:
        raise NotImplementedError(tokenizer_type)
    logging.info('use %s tokenizer', tokenizer_type)
    return tokenizer
