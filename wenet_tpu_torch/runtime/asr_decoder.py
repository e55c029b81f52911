"""Streaming decode of one stream: the AsrDecoder of the serving stack.
Counterpart of wenet_tpu/runtime/asr_decoder.py.

Per chunk: the feature pipeline (host fbank) -> the model's chunk step on
the device (`forward_encoder_chunk` with fixed-size caches, K1 in every
rel-pos block; an efficient conformer emits a frame per
`output_downsampling_factor` base frames) -> CTC log-softmax and its
top-k on the device -> one copy to the host (the top-k and the blank
column) -> the C++ prefix beam -> the endpoint rules.  The encoder
outputs stay on the device: `rescoring` closes the beam and reranks its
n-best with the attention decoder over them (score + ctc_weight * ctc
score).

With `batch_runner` (runtime/batch_runner.py) the chunk step is not run
here: the decoder submits its chunk and caches to the runner, which
steps many streams as one batch and hands each its rows, the host rows
of the same top-k and blank column included, so the rest of the path is
the same.  `post_processor` (runtime/post_processor.py) rewrites every
sentence.

`context_graph` (utils/context_graph.py) biases the prefix beam and
`lm` (an ARPA NgramLM, lm/arpa.py) is fused into it with `lm_weight`,
both in the C++ searcher; its words are the tokenizer's symbols.

With `tlg_fst` (a TLG.txt path or an `lm.fst.TextFst`, lm/build_graph.py)
the C++ lattice WFST decoder (runtime/native_wfst.py) takes the prefix
beam's place: the step then copies the whole CTC log-prob rows to the
host (chunk x vocabulary float32), results are words of `word_table`
({id: word}, words.txt) with their times, and `rescoring` closes the
search without attention rescoring, as in the JAX package.  Over a
`batch_runner` a WFST decoder asks the runner for its whole rows, which
the runner copies for such sessions alone.

Runs on `device` ('cuda' unless the caller asks for the CPU)."""

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
from wenet_tpu_torch.utils.ctc_utils import topk_host_rows


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
                 tlg_fst=None, word_table=None, post_processor=None,
                 batch_runner=None, device='cuda'):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        opts = opts or DecodeOptions()
        encoder = self.model.encoder
        self._setup(tokenizer, opts, feature_config, endpoint_config,
                    StreamingConfig(
                        decoding_chunk_size=opts.chunk_size,
                        num_decoding_left_chunks=opts.num_left_chunks,
                        subsampling_rate=encoder.subsampling_rate,
                        right_context=encoder.right_context),
                    encoder.output_downsampling_factor, post_processor)
        if batch_runner is not None:
            from wenet_tpu_torch.runtime.batch_runner import (
                BatchedChunkRunner)
            if not isinstance(batch_runner, BatchedChunkRunner):
                raise TypeError(f'batch_runner is a '
                                f'{type(batch_runner).__name__}, not a '
                                'BatchedChunkRunner')
            theirs = (batch_runner.cfg, batch_runner.beam_size,
                      batch_runner.blank_id, batch_runner.device)
            ours = (self.cfg, self.opts.beam_size,
                    self.endpointer.config.blank, self.device)
            if theirs != ours:
                raise ValueError(f'the batch runner steps {theirs} '
                                 f'(streaming config, top-k, blank, '
                                 f'device), this decoder needs {ours}')
        self.batch_runner = batch_runner
        self._make_searcher(context_graph, lm, lm_weight, tlg_fst,
                            word_table)
        self.reset()

    def _setup(self, tokenizer, opts, feature_config, endpoint_config, cfg,
               factor, post_processor):
        """What every decoder holds beside its model: the options, the
        feature pipeline, the chunk geometry `cfg` and the endpointer."""
        self.tokenizer = tokenizer
        self.opts = opts
        self.post_processor = post_processor
        self.feature_pipeline = FeaturePipeline(feature_config)
        self.cfg = cfg
        # an encoder that downsamples inside its trunk (the efficient
        # conformer) emits one frame per `factor` base frames of a chunk
        self.factor = factor
        self.endpointer = CtcEndpoint(
            endpoint_config, 10 * cfg.subsampling_rate * factor)

    def _make_searcher(self, context_graph=None, lm=None, lm_weight=0.5,
                       tlg_fst=None, word_table=None):
        self.is_wfst = tlg_fst is not None
        self.word_table = word_table or {}
        if self.is_wfst:
            from wenet_tpu_torch.runtime.native_wfst import (
                make_wfst_searcher)
            fst_obj, fst_path = ((None, tlg_fst) if isinstance(tlg_fst, str)
                                 else (tlg_fst, None))
            self.searcher = make_wfst_searcher(
                fst_obj, fst_path=fst_path, beam_size=self.opts.beam_size,
                blank_id=self.opts.blank_id)
        else:
            self.searcher = make_searcher(
                self.opts.beam_size, self.opts.blank_id,
                context_graph=context_graph, lm=lm, lm_weight=lm_weight,
                symbol_table=(
                    {v: k for k, v in self.tokenizer.symbol_table.items()}
                    if lm is not None else None))

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
        context = cfg.right_context + 1
        real_base = max((chunk.shape[0] - context) //
                        cfg.subsampling_rate + 1, 0)
        real_out = -(-real_base // self.factor)
        pad = cfg.decoding_window - chunk.shape[0]
        if pad > 0:
            chunk = np.pad(chunk, ((0, pad), (0, 0)))
        if self.state is None:
            self.state = self._zero_cache()
        if self.batch_runner is not None:
            ys, host, self.state = self.batch_runner.submit(
                chunk, self.state, self.offset, self.valid_cache,
                real_base, whole_rows=self.is_wfst).result()
            ys, host = ys[0, :real_out], host[:real_out]
        else:
            ys, logp = self._chunk_step(chunk, real_base, real_out)
            # the one device-to-host copy of the step: the whole rows for
            # the WFST search, the top-k and the blank column for the beam
            host = (logp.float() if self.is_wfst else topk_host_rows(
                logp, self.opts.beam_size, self.endpointer.config.blank)
                    ).cpu().numpy()
        self.offset += real_out
        self.valid_cache = min(self.valid_cache + real_base,
                               cfg.required_cache_size)
        self.encoder_outs.append(ys)
        return self._search(host)

    def _zero_cache(self):
        """The caches before a stream's first chunk."""
        return self.model.encoder.zero_cache(
            1, self.cfg.required_cache_size, device=self.device)

    def _chunk_step(self, chunk: np.ndarray, real_base: int, real_out: int):
        """The model's chunk step on the padded `chunk` with this stream's
        caches -> (encoder rows (real_out, D), CTC log-probs (real_out, V)),
        on the device."""
        cfg = self.cfg
        model = self.model
        chunk_out = (cfg.decoding_window - cfg.right_context - 1) // \
            cfg.subsampling_rate + 1
        att_mask = streaming_att_mask(1, cfg.required_cache_size, chunk_out,
                                      self.valid_cache, real_base,
                                      self.device)
        xs = torch.from_numpy(chunk)[None].to(self.device)
        ys, att_cache, cnn_cache = model.forward_encoder_chunk(
            xs, self.offset, *self.state, att_mask)
        self.state = (att_cache, cnn_cache)
        ys = ys[0, :real_out]
        return ys, model.ctc_activation(ys)

    def _search(self, host: np.ndarray) -> bool:
        """Advance the searcher over one step's host rows; True at an
        endpoint."""
        if self.is_wfst:
            self.searcher.search(host)
            blank = host[:, self.endpointer.config.blank]
        else:
            k = self.opts.beam_size
            self.searcher.search_topk(host[:, :k],
                                      host[:, k:2 * k].astype(np.int32))
            blank = host[:, 2 * k]
        hyps = self.searcher.hypotheses
        decoded_sth = bool(hyps) and len(hyps[0]) > 0
        return self.endpointer.is_endpoint_blank(blank, decoded_sth)

    # -- results ---------------------------------------------------------
    def _update_result(self, finish: bool = False):
        hyps = self.searcher.hypotheses
        times = self.searcher.times
        likelihood = self.searcher.likelihood
        frame_shift_ms = self.endpointer.frame_shift_in_ms
        results = []
        for i, hyp in enumerate(hyps):
            r = DecodeResult(score=likelihood[i])
            if self.is_wfst:
                tokens = [self.word_table.get(int(w), str(w)) for w in hyp]
                text = ''.join(tokens)
            else:
                text, tokens = self.tokenizer.detokenize(
                    [int(t) for t in hyp])
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
        """Close the search; with the prefix beam, also rerank its n-best
        with the attention decoder over the encoder outputs so far
        (`result[0]` becomes the final).  WFST hypotheses are words: they
        are not rescored."""
        self.searcher.finalize_search()
        self._update_result(finish=True)
        if self.is_wfst or not self.encoder_outs:
            return
        hyps = self.searcher.hypotheses
        if not hyps or all(len(h) == 0 for h in hyps):
            return
        best = self._rescore(hyps)
        if best is None:
            return
        tokens, score, times = best
        text, pieces = self.tokenizer.detokenize([int(t) for t in tokens])
        if self.post_processor is not None:
            text = self.post_processor.process(text, True)
        r = DecodeResult(sentence=text, score=score)
        if times:
            fs = self.endpointer.frame_shift_in_ms
            for w, t in zip(pieces, times):
                r.word_pieces.append(WordPiece(w, t * fs, (t + 1) * fs))
        self.result = [r] + self.result[1:]

    def _rescore(self, hyps):
        """The best of the n-best `hyps` by attention rescoring -> (tokens,
        score, times), or None without a decoder."""
        if self.model.decoder is None:
            return None
        encoder_out = torch.cat(self.encoder_outs)[None]
        ctc_results = [SearchResult(tokens=hyps[0], nbest=hyps,
                                    nbest_scores=self.searcher.likelihood,
                                    nbest_times=self.searcher.times)]
        enc_lens = torch.tensor([encoder_out.shape[1]], device=self.device)
        best = attention_rescoring(self.model, ctc_results, encoder_out,
                                   enc_lens, self.opts.ctc_weight,
                                   self.opts.reverse_weight)[0]
        return best.tokens, best.score, best.times
