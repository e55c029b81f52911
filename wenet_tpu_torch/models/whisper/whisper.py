"""Whisper as an ASRModel, for decoding.  Counterpart of
wenet_tpu/models/whisper/whisper.py `Whisper` (:40-58): sos and eos are
the special tokens `sot` and `eot`, and the default decode mode is the
attention beam search over the [sot, lang, task, ...] prompt
(search.py `attention_beam_search`).  The whisper train step (the
prompt-building loss) is not ported yet."""

from torch import nn

from wenet_tpu_torch.models.transformer.asr_model import ASRModel


class Whisper(ASRModel):
    default_decode_method = 'attention'

    def __init__(self, vocab_size: int, encoder: nn.Module,
                 decoder: nn.Module, ctc: nn.Module,
                 special_tokens: dict, **kwargs):
        super().__init__(vocab_size, encoder, decoder, ctc,
                         special_tokens=special_tokens, **kwargs)
        self.sos = special_tokens['sot']
        self.eos = special_tokens['eot']

    def forward(self, *args, **kwargs):
        raise NotImplementedError('the whisper train step is not ported '
                                  'yet: decode with AsrRunner')
