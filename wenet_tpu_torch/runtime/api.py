"""Embedding API in the shape of the reference C API (wenet_init,
wenet_decode, wenet_reset, wenet_set_nbest, wenet_set_timestamp,
wenet_add_context, wenet_set_language, wenet_set_continuous_decoding).
Counterpart of wenet_tpu/runtime/api.py; the Python object is the handle.

    rec = wenet_init('exp/u2pp')            # on the card
    json_text = wenet_decode(rec, pcm_bytes, last=1)

`add_context` phrases (scored by `set_context_score`) bias the decoder
the next `reset` builds, in the C++ prefix beam."""

import json

import numpy as np


class WenetRecognizer:
    """The handle `wenet_init` returns: a model directory's model on
    `device` ('cuda' unless the caller asks for the CPU) and the settings
    of the decoder each `reset` builds."""

    def __init__(self, model_dir: str, device='cuda'):
        from wenet_tpu_torch.utils.checkpoint import load_model_dir
        self.device = device
        self.model, self.configs, self.tokenizer = load_model_dir(model_dir,
                                                                  device)
        self.nbest = 1
        self.enable_timestamp = False
        self.context = []
        self.context_score = 3.0
        self.continuous_decoding = False
        self.language = 'chs'
        self._decoder = None

    # -- settings --------------------------------------------------------
    def set_nbest(self, n: int):
        self.nbest = n

    def set_timestamp(self, flag: int):
        self.enable_timestamp = bool(flag)

    def add_context(self, word: str):
        self.context.append(word)

    def set_context_score(self, score: float):
        self.context_score = score

    def set_language(self, lang: str):
        self.language = lang

    def set_continuous_decoding(self, flag: int):
        self.continuous_decoding = bool(flag)

    # -- decode ----------------------------------------------------------
    def _make_decoder(self):
        from wenet_tpu_torch.runtime.asr_decoder import (AsrDecoder,
                                                         DecodeOptions)
        from wenet_tpu_torch.runtime.feature_pipeline import (
            FeaturePipelineConfig)
        graph = None
        if self.context:
            from wenet_tpu_torch.utils.context_graph import ContextGraph
            graph = ContextGraph(
                '', self.tokenizer.symbol_table,
                context_list=[self.tokenizer.tokenize(w)[1]
                              for w in self.context],
                context_score=self.context_score)
        return AsrDecoder(self.model, self.tokenizer, DecodeOptions(),
                          FeaturePipelineConfig.from_configs(self.configs),
                          context_graph=graph, device=self.device)

    def reset(self):
        self._decoder = self._make_decoder()

    def decode(self, pcm: bytes, last: int = 1) -> str:
        """Feed int16 samples -> the result as JSON.  With continuous
        decoding, an endpoint before the last piece closes the segment
        (rescoring, a final result) and the next segment starts."""
        from wenet_tpu_torch.runtime.asr_decoder import DecodeState
        if self._decoder is None:
            self.reset()
        self._decoder.accept_waveform(np.frombuffer(pcm, '<i2'))
        if last:
            self._decoder.set_input_finished()
        state = self._decoder.decode()
        is_final = bool(last)
        if last:
            self._decoder.rescoring()
        elif state == DecodeState.END_POINT and self.continuous_decoding:
            self._decoder.rescoring()
            is_final = True
        out = []
        for r in self._decoder.result[:self.nbest]:
            obj = {'sentence': r.sentence}
            if self.enable_timestamp:
                obj['word_pieces'] = [
                    {'word': w.word, 'start': w.start, 'end': w.end}
                    for w in r.word_pieces]
            out.append(obj)
        result = json.dumps({'type': 'final_result' if is_final else
                             'partial_result', 'nbest': out},
                            ensure_ascii=False)
        if is_final and not last:
            self._decoder.reset_continuous_decoding()
        return result


# the C API's free functions
def wenet_init(model_dir: str, device='cuda') -> WenetRecognizer:
    return WenetRecognizer(model_dir, device)


def wenet_free(handle: WenetRecognizer):
    del handle


def wenet_reset(handle: WenetRecognizer):
    handle.reset()


def wenet_decode(handle: WenetRecognizer, data: bytes,
                 last: int = 1) -> str:
    return handle.decode(data, last)


def wenet_set_nbest(handle: WenetRecognizer, n: int):
    handle.set_nbest(n)


def wenet_set_timestamp(handle: WenetRecognizer, flag: int):
    handle.set_timestamp(flag)


def wenet_add_context(handle: WenetRecognizer, word: str):
    handle.add_context(word)


def wenet_set_context_score(handle: WenetRecognizer, score: float):
    handle.set_context_score(score)


def wenet_set_language(handle: WenetRecognizer, lang: str):
    handle.set_language(lang)


def wenet_set_continuous_decoding(handle: WenetRecognizer, flag: int):
    handle.set_continuous_decoding(flag)
