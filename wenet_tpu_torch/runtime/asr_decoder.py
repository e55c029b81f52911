"""Streaming decode of one stream: the AsrDecoder of the serving stack.
Counterpart of wenet_tpu/runtime/asr_decoder.py.

Per chunk: the feature pipeline (host fbank) -> the model's chunk step on
the device (`forward_encoder_chunk` with fixed-size caches, K1 in every
block) -> CTC log-softmax and its top-k on the device -> one copy to the
host (the top-k and the blank column) -> the C++ prefix beam -> the
endpoint rules.  The encoder outputs stay on the device: `rescoring`
closes the beam and reranks its n-best with the attention decoder over
them (score + ctc_weight * ctc score).

With `batch_runner` (runtime/batch_runner.py) the chunk step is not run
here: the decoder submits its chunk and caches to the runner, which
steps many streams as one batch and hands each its rows, the host rows
of the same top-k and blank column included, so the rest of the path is
the same.  `post_processor` (runtime/post_processor.py) rewrites every
sentence.

`context_graph` (utils/context_graph.py) biases the prefix beam and
`lm` (an ARPA NgramLM, lm/arpa.py) is fused into it with `lm_weight`,
both in the C++ searcher; its words are the tokenizer's symbols.

Runs on `device` ('cuda' unless the caller asks for the CPU).  WFST
decoding (`tlg_fst`) is not ported and raises NotImplementedError
(ROADMAP.md, queue 1 item 5)."""

import enum
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from wenet_tpu_torch.models.transformer.search import (
    DecodeResult as SearchResult, attention_rescoring)
from wenet_tpu_torch.models.transformer.streaming import (StreamingConfig,
                                                          streaming_att_mask)
from wenet_tpu_torch.runtime.endpoint import CtcEndpoint, CtcEndpointConfig
from wenet_tpu_torch.runtime.feature_pipeline import (FeaturePipeline,
                                                      FeaturePipelineConfig)
from wenet_tpu_torch.runtime.native_beam import make_searcher


class DecodeState(enum.Enum):
    END_BATCH = 0
    END_POINT = 1
    END_FEATS = 2


@dataclass
class WordPiece:
    word: str
    start: int = -1  # ms
    end: int = -1


@dataclass
class DecodeResult:
    sentence: str = ''
    word_pieces: List[WordPiece] = field(default_factory=list)
    score: float = 0.0


@dataclass
class DecodeOptions:
    chunk_size: int = 16
    num_left_chunks: int = -1
    ctc_weight: float = 0.5
    rescoring_weight: float = 1.0  # the attention score's weight: 1 only
    reverse_weight: float = 0.0
    beam_size: int = 10
    blank_id: int = 0

    def __post_init__(self):
        # the JAX package accepts the option and ignores it; here a
        # setting that would change nothing raises instead
        if self.rescoring_weight != 1.0:
            raise NotImplementedError(
                f'rescoring_weight {self.rescoring_weight}: the rescoring '
                f'weighs the attention score by 1, as the JAX package does')


class AsrDecoder:
    """One stream's decoder over a shared model: `accept_waveform`,
    `decode` (as many chunks as the features allow; partials in
    `result`), `set_input_finished`, `rescoring` (the final), `reset`."""

    def __init__(self, model, tokenizer, opts: Optional[DecodeOptions] = None,
                 feature_config: Optional[FeaturePipelineConfig] = None,
                 endpoint_config: Optional[CtcEndpointConfig] = None,
                 context_graph=None, lm=None, lm_weight: float = 0.5,
                 tlg_fst=None, post_processor=None, batch_runner=None,
                 device='cuda'):
        if tlg_fst is not None:
            raise NotImplementedError('WFST decoding is not ported '
                                      '(ROADMAP.md, queue 1 item 5)')
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.tokenizer = tokenizer
        self.post_processor = post_processor
        self.opts = opts or DecodeOptions()
        self.feature_pipeline = FeaturePipeline(feature_config)
        encoder = self.model.encoder
        self.cfg = StreamingConfig(
            decoding_chunk_size=self.opts.chunk_size,
            num_decoding_left_chunks=self.opts.num_left_chunks,
            subsampling_rate=encoder.subsampling_rate,
            right_context=encoder.right_context)
        self.endpointer = CtcEndpoint(endpoint_config,
                                      10 * encoder.subsampling_rate)
        if batch_runner is not None:
            theirs = (batch_runner.cfg, batch_runner.beam_size,
                      batch_runner.blank_id, batch_runner.device)
            ours = (self.cfg, self.opts.beam_size,
                    self.endpointer.config.blank, self.device)
            if theirs != ours:
                raise ValueError(f'the batch runner steps {theirs} '
                                 f'(streaming config, top-k, blank, '
                                 f'device), this decoder needs {ours}')
        self.batch_runner = batch_runner
        self.searcher = make_searcher(
            self.opts.beam_size, self.opts.blank_id,
            context_graph=context_graph, lm=lm, lm_weight=lm_weight,
            symbol_table=({v: k for k, v in tokenizer.symbol_table.items()}
                          if lm is not None else None))
        self.reset()

    # -- lifecycle -------------------------------------------------------
    def reset(self):
        self.feature_pipeline.reset()
        self.reset_continuous_decoding()
        self.feature_buf = np.zeros(
            (0, self.feature_pipeline.config.num_mel_bins), np.float32)
        self.result: List[DecodeResult] = []

    def reset_continuous_decoding(self):
        """Start the next utterance of a stream; the feature pipeline
        and the buffered features carry on."""
        self.endpointer.reset()
        self.searcher.reset()
        self.state = None
        self.offset = 0
        self.valid_cache = 0
        self.encoder_outs: List[torch.Tensor] = []

    # -- decoding --------------------------------------------------------
    def accept_waveform(self, wav: np.ndarray):
        feats = self.feature_pipeline.accept_waveform(wav)
        if feats.shape[0]:
            self.feature_buf = np.concatenate([self.feature_buf, feats])

    def set_input_finished(self):
        self.feature_pipeline.set_input_finished()

    def decode(self) -> DecodeState:
        """Run every chunk the buffered features fill (and, once the input
        is finished, the zero-padded tail), then update `result`."""
        cfg = self.cfg
        state = DecodeState.END_BATCH
        while True:
            if self.feature_buf.shape[0] >= cfg.decoding_window:
                chunk = self.feature_buf[:cfg.decoding_window]
                self.feature_buf = self.feature_buf[cfg.stride:]
                tail = False
            elif (self.feature_pipeline.input_finished
                  and self.feature_buf.shape[0] > cfg.right_context):
                chunk = self.feature_buf
                self.feature_buf = self.feature_buf[:0]
                tail = True
            else:
                break
            if self._advance_one_chunk(chunk):
                state = DecodeState.END_POINT
                break
            if tail:
                state = DecodeState.END_FEATS
                break
        self._update_result(finish=False)
        return state

    @torch.inference_mode()
    def _advance_one_chunk(self, chunk: np.ndarray) -> bool:
        """One chunk step; True at an endpoint."""
        cfg = self.cfg
        model = self.model
        if self.state is None:
            self.state = model.encoder.zero_cache(
                1, cfg.required_cache_size, device=self.device)
        context = cfg.right_context + 1
        real_out = max((chunk.shape[0] - context) //
                       cfg.subsampling_rate + 1, 0)
        pad = cfg.decoding_window - chunk.shape[0]
        if pad > 0:
            chunk = np.pad(chunk, ((0, pad), (0, 0)))
        k = self.opts.beam_size
        blank = self.endpointer.config.blank
        if self.batch_runner is not None:
            ys, host, self.state = self.batch_runner.submit(
                chunk, self.state, self.offset, self.valid_cache,
                real_out).result()
            ys, host = ys[0, :real_out], host[:real_out]
        else:
            chunk_out = (cfg.decoding_window - context) // \
                cfg.subsampling_rate + 1
            att_mask = streaming_att_mask(1, cfg.required_cache_size,
                                          chunk_out, self.valid_cache,
                                          real_out, self.device)
            xs = torch.from_numpy(chunk)[None].to(self.device)
            ys, att_cache, cnn_cache = model.forward_encoder_chunk(
                xs, self.offset, *self.state, att_mask)
            self.state = (att_cache, cnn_cache)
            ys = ys[0, :real_out]
            # the one device-to-host copy of the step
            host = model.ctc_host_rows(ys, k, blank).cpu().numpy()
        self.offset += real_out
        self.valid_cache = min(self.valid_cache + real_out,
                               cfg.required_cache_size)
        self.encoder_outs.append(ys)
        self.searcher.search_topk(host[:, :k], host[:, k:2 * k].astype(
            np.int32))
        hyps = self.searcher.hypotheses
        decoded_sth = bool(hyps) and len(hyps[0]) > 0
        return self.endpointer.is_endpoint_blank(host[:, 2 * k],
                                                 decoded_sth)

    # -- results ---------------------------------------------------------
    def _update_result(self, finish: bool = False):
        hyps = self.searcher.hypotheses
        times = self.searcher.times
        likelihood = self.searcher.likelihood
        frame_shift_ms = self.endpointer.frame_shift_in_ms
        results = []
        for i, hyp in enumerate(hyps):
            r = DecodeResult(score=likelihood[i])
            text, tokens = self.tokenizer.detokenize([int(t) for t in hyp])
            if self.post_processor is not None:
                text = self.post_processor.process(text, finish)
            r.sentence = text
            if finish and i < len(times):
                for w, t in zip(tokens, times[i]):
                    start = t * frame_shift_ms
                    r.word_pieces.append(
                        WordPiece(w, start, start + frame_shift_ms))
            results.append(r)
        self.result = results

    @torch.inference_mode()
    def rescoring(self):
        """Close the beam and rerank its n-best with the attention decoder
        over the encoder outputs so far; `result[0]` becomes the final."""
        self.searcher.finalize_search()
        self._update_result(finish=True)
        if not self.encoder_outs or self.model.decoder is None:
            return
        hyps = self.searcher.hypotheses
        if not hyps or all(len(h) == 0 for h in hyps):
            return
        encoder_out = torch.cat(self.encoder_outs)[None]
        ctc_results = [SearchResult(tokens=hyps[0], nbest=hyps,
                                    nbest_scores=self.searcher.likelihood,
                                    nbest_times=self.searcher.times)]
        enc_lens = torch.tensor([encoder_out.shape[1]], device=self.device)
        best = attention_rescoring(self.model, ctc_results, encoder_out,
                                   enc_lens, self.opts.ctc_weight,
                                   self.opts.reverse_weight)[0]
        text, tokens = self.tokenizer.detokenize([int(t) for t in best.tokens])
        if self.post_processor is not None:
            text = self.post_processor.process(text, True)
        r = DecodeResult(sentence=text, score=best.score)
        if best.times:
            fs = self.endpointer.frame_shift_in_ms
            for w, t in zip(tokens, best.times):
                r.word_pieces.append(WordPiece(w, t * fs, (t + 1) * fs))
        self.result = [r] + self.result[1:]
