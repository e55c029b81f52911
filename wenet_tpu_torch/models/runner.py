"""AsrRunner: offline batch decode.  Counterpart of
wenet_tpu/models/runner.py `AsrRunner.decode` for the CTC greedy, CTC
prefix beam (with context biasing), attention-rescoring and attention
(beam search) modes, a transducer's greedy and beam searches and a
paraformer's greedy and beam searches (`paraformer_decode`), with
its simulated streaming (`simulate_streaming`), and of `decode_wav` (the
fbank on the device) and `transcribe`.

CTC prefix beam search runs in the port's C++ trie searcher
(wenet_tpu_torch/runtime/native_beam.py, built with g++ at first use),
fed with the per-frame top-k that `torch.topk` computes on the device.

`quantize=True` stores the int8 weight-only model of ops/quant.py and
computes in `dtype` (bfloat16 unless given); `mesh`, a list of local
devices along `data`, decodes data-parallel: one replica per device, each
batch's rows split over them in order (a ragged batch padded by
repeating its last row, the pad rows trimmed from every result), the
replicas run side by side in threads."""

import copy
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import torch

from wenet_tpu_torch.models.paraformer.search import (
    paraformer_beam_search_ids, paraformer_greedy_search_ids)
from wenet_tpu_torch.models.transformer.search import (
    DecodeResult, attention_beam_search, attention_rescoring,
    ctc_greedy_search)
from wenet_tpu_torch.models.transformer.streaming import (
    StreamingConfig, forward_chunk_by_chunk)
from wenet_tpu_torch.ops.fbank import compute_fbank
from wenet_tpu_torch.runtime import native_beam

MODES = ('ctc_greedy_search', 'ctc_prefix_beam_search',
         'attention_rescoring', 'attention', 'rnnt_greedy_search',
         'rnnt_beam_search', 'paraformer_greedy_search',
         'paraformer_beam_search')
# what a paraformer decodes: its own searches and CTC on the encoder
PARAFORMER_MODES = ('paraformer_greedy_search', 'paraformer_beam_search',
                    'ctc_greedy_search', 'ctc_prefix_beam_search')


def ctc_prefix_beam_search(ctc_probs: torch.Tensor,
                           encoder_lens: torch.Tensor, beam_size: int,
                           blank_id: int = 0,
                           context_graph=None) -> List[DecodeResult]:
    """Per-frame top-k on the device, then the C++ prefix beam on host,
    biased by `context_graph` when given.  Raises when the native library
    cannot be built or loaded."""
    vals, ids = torch.topk(ctc_probs, beam_size, dim=-1)
    outs = native_beam.batch_search_topk(
        vals.float().cpu().numpy(), ids.int().cpu().numpy(),
        encoder_lens.cpu().numpy(), beam_size, blank_id,
        context_graph=context_graph)
    return [DecodeResult(tokens=hyps[0], score=scores[0], times=times[0],
                         nbest=hyps, nbest_scores=scores, nbest_times=times)
            for hyps, times, scores in outs]


def paraformer_decode(model, feats: torch.Tensor,
                      feats_lengths: torch.Tensor, methods: List[str],
                      beam_size: int = 10, blank_id: int = 0,
                      blank_penalty: float = 0.0, context_graph=None
                      ) -> Dict[str, List[DecodeResult]]:
    """{mode: one DecodeResult per utterance} of a paraformer
    (`PARAFORMER_MODES`): `forward_paraformer`, then the argmax and its
    log-prob on the device and the host searches over them; the greedy
    search's timestamps from the CIF peaks (the trace integrated on the
    host); the CTC modes on the encoder output.  As in the JAX package's
    `_decode_paraformer`."""
    other = [m for m in methods if m not in PARAFORMER_MODES]
    if other:
        raise ValueError(f'{other} are not paraformer decode modes')
    res = model.forward_paraformer(feats, feats_lengths)
    results: Dict[str, List[DecodeResult]] = {}
    if any(m.startswith('paraformer_') for m in methods):
        ids = res['decoder_out'].argmax(-1)
        lp = res['decoder_out'].gather(-1, ids[..., None])[..., 0]
        lens = res['decoder_out_lens'].cpu().numpy()
        ids, lp = ids.cpu().numpy(), lp.float().cpu().numpy()
        if 'paraformer_greedy_search' in methods:
            peaks = model.forward_cif_peaks(
                res['tp_alphas'].float().cpu(),
                res['decoder_out_lens'].cpu()).numpy()
            results['paraformer_greedy_search'] = \
                paraformer_greedy_search_ids(ids, lp, lens, peaks)
        if 'paraformer_beam_search' in methods:
            results['paraformer_beam_search'] = \
                paraformer_beam_search_ids(ids, lp, lens)
    if any(m.startswith('ctc_') for m in methods):
        if model.ctc is None:
            raise ValueError('this paraformer has no CTC head (ctc_weight '
                             '0): the ctc modes need one')
        ctc_probs = model.ctc_logprobs(res['encoder_out'], blank_penalty,
                                       blank_id)
        enc_lens = res['encoder_out_mask'][:, 0, :].sum(-1)
        if 'ctc_greedy_search' in methods:
            results['ctc_greedy_search'] = ctc_greedy_search(
                ctc_probs, enc_lens, blank_id)
        if 'ctc_prefix_beam_search' in methods:
            results['ctc_prefix_beam_search'] = ctc_prefix_beam_search(
                ctc_probs, enc_lens, beam_size, blank_id, context_graph)
    return results


def rnnt_decode(model, encoder_out: torch.Tensor,
                encoder_lens: torch.Tensor, methods: List[str],
                beam_size: int, rnnt_n_steps: int = 64
                ) -> Dict[str, List[DecodeResult]]:
    """{mode: one DecodeResult per utterance} of the transducer searches in
    `methods` over encoder outputs (B, T, D) with lengths (B,):
    `rnnt_greedy_search` (its tokens without blanks) with a budget of
    `rnnt_n_steps` units a frame, `rnnt_beam_search` (the best hypothesis,
    its score and the n-best) with `beam_size` hypotheses."""
    results: Dict[str, List[DecodeResult]] = {}
    if 'rnnt_greedy_search' in methods:
        tokens, n_emit = model.greedy_search(encoder_out, encoder_lens,
                                             rnnt_n_steps)
        tokens, n_emit = tokens.cpu().tolist(), n_emit.cpu().tolist()
        results['rnnt_greedy_search'] = [
            DecodeResult(tokens=[t for t in row[:n] if t != model.blank])
            for row, n in zip(tokens, n_emit)]
    if 'rnnt_beam_search' in methods:
        tokens, lens, scores = (x.cpu().tolist() for x in
                                model.beam_search(encoder_out, encoder_lens,
                                                  beam_size))
        results['rnnt_beam_search'] = [
            DecodeResult(tokens=row[0][:n[0]], score=sc[0],
                         nbest=[h[:k] for h, k in zip(row, n)],
                         nbest_scores=sc)
            for row, n, sc in zip(tokens, lens, scores)]
    return results


class AsrRunner:
    """A model bound to a device, in eval mode.  `dtype` (e.g.
    torch.bfloat16) casts the floating weights, and the features with
    them, as the JAX runner's `dtype` does.  `quantize` and `mesh`: see
    the module's docstring; with `mesh`, `device` is ignored and the
    model's first replica is on the mesh's first device."""

    def __init__(self, model: torch.nn.Module, device='cuda',
                 dtype: Optional[torch.dtype] = None,
                 quantize: bool = False, mesh=None):
        self._replicas: List['AsrRunner'] = []
        if mesh is not None:
            from wenet_tpu_torch.parallel.mesh import decode_devices
            devices = decode_devices(mesh)
            distinct = list(dict.fromkeys(devices))
            # the copies are taken before the first replica moves `model`
            models = [model] + [copy.deepcopy(model) for _ in distinct[1:]]
            own = {d: AsrRunner(m, d, dtype, quantize)
                   for d, m in zip(distinct, models)}
            self._replicas = [own[d] for d in devices]
            first = self._replicas[0]
            self.device, self.dtype, self.model = (first.device, first.dtype,
                                                   first.model)
            self._pool = ThreadPoolExecutor(len(devices))
            return
        self.device = torch.device(device)
        model = model.to(self.device).eval()
        if quantize:
            from wenet_tpu_torch.ops.quant import quantize_model
            dtype = dtype or torch.bfloat16
            model = quantize_model(model, dtype)
        elif dtype is not None:
            model = model.to(dtype)
        self.dtype = dtype
        self.model = model

    def _decode_sharded(self, methods, feats, feats_lengths, **kw):
        """`decode` with the batch's rows split over the replicas."""
        n = len(self._replicas)
        feats = torch.as_tensor(feats)
        lens = torch.as_tensor(feats_lengths)
        B = feats.shape[0]
        pad = -B % n
        if pad:
            feats = torch.cat([feats, feats[-1:].expand(pad,
                                                        *feats.shape[1:])])
            lens = torch.cat([lens, lens[-1:].expand(pad)])
        rows = (B + pad) // n
        infos = kw.pop('infos', None) or {}
        infos = {k: list(v) + [v[-1]] * pad for k, v in infos.items()}
        futs = [self._pool.submit(
            r.decode, methods, feats[i * rows:(i + 1) * rows],
            lens[i * rows:(i + 1) * rows],
            infos={k: v[i * rows:(i + 1) * rows] for k, v in infos.items()}
            or None, **kw)
            for i, r in enumerate(self._replicas)]
        parts = [f.result() for f in futs]
        return {m: [x for p in parts for x in p[m]][:B] for m in parts[0]}

    @torch.inference_mode()
    def decode(self, methods: List[str], feats, feats_lengths,
               beam_size: int = 10, decoding_chunk_size: int = -1,
               num_decoding_left_chunks: int = -1, ctc_weight: float = 0.0,
               simulate_streaming: bool = False,
               reverse_weight: float = 0.0, blank_id: int = 0,
               blank_penalty: float = 0.0, length_penalty: float = 0.0,
               infos: Optional[Dict[str, List[str]]] = None,
               context_graph=None, rnnt_n_steps: int = 64
               ) -> Dict[str, List[DecodeResult]]:
        """feats: (B, T, F) array or tensor; feats_lengths: (B,).
        `simulate_streaming` with decoding_chunk_size > 0 runs the encoder
        chunk by chunk with its caches (`forward_chunk_by_chunk`; one
        utterance, B = 1); otherwise the encoder sees the whole input under
        the chunk mask.  `length_penalty` is for the `attention` mode,
        `infos` (whisper's prompt: 'tasks', 'langs', 'no_timestamp') for
        it and the rescoring, `context_graph` (utils/context_graph.py)
        biases the prefix beam.  The rnnt modes need a transducer:
        `rnnt_greedy_search` with a budget of `rnnt_n_steps` units a frame
        (and 2T steps in all, the JAX package's formulation),
        `rnnt_beam_search` with `beam_size` hypotheses and the model's CTC
        fusion defaults.  Returns {mode: one DecodeResult per
        utterance}."""
        if self._replicas:
            return self._decode_sharded(
                methods, feats, feats_lengths, beam_size=beam_size,
                decoding_chunk_size=decoding_chunk_size,
                num_decoding_left_chunks=num_decoding_left_chunks,
                ctc_weight=ctc_weight, simulate_streaming=simulate_streaming,
                reverse_weight=reverse_weight, blank_id=blank_id,
                blank_penalty=blank_penalty, length_penalty=length_penalty,
                infos=infos, context_graph=context_graph,
                rnnt_n_steps=rnnt_n_steps)
        unknown = [m for m in methods if m not in MODES]
        if unknown:
            raise NotImplementedError(f'decode modes not ported: {unknown}')
        for prefix, attr, kind in (('rnnt_', 'greedy_search', 'transducer'),
                                   ('paraformer_', 'forward_paraformer',
                                    'paraformer')):
            wanted = [m for m in methods if m.startswith(prefix)]
            if wanted and not hasattr(self.model, attr):
                raise ValueError(f'{wanted} need a {kind} model')
        feats = torch.as_tensor(feats, device=self.device)
        if self.dtype is not None:
            feats = feats.to(self.dtype)
        feats_lengths = torch.as_tensor(feats_lengths, device=self.device)
        model = self.model
        if hasattr(model, 'forward_paraformer'):
            return paraformer_decode(model, feats, feats_lengths, methods,
                                     beam_size, blank_id, blank_penalty,
                                     context_graph)
        if simulate_streaming and decoding_chunk_size > 0:
            if feats.shape[0] != 1:
                raise ValueError('simulate_streaming decodes one utterance '
                                 f'at a time, got a batch of '
                                 f'{feats.shape[0]}')
            cfg = StreamingConfig(
                decoding_chunk_size, num_decoding_left_chunks,
                model.encoder.subsampling_rate, model.encoder.right_context)
            encoder_out, encoder_mask = forward_chunk_by_chunk(
                model, feats[:, :int(feats_lengths[0])], cfg)
        else:
            encoder_out, encoder_mask = model.forward_encoder(
                feats, feats_lengths, decoding_chunk_size,
                num_decoding_left_chunks)
        encoder_lens = encoder_mask[:, 0, :].sum(-1)
        results: Dict[str, List[DecodeResult]] = rnnt_decode(
            model, encoder_out, encoder_lens, methods, beam_size,
            rnnt_n_steps)
        if 'attention' in methods:
            results['attention'] = attention_beam_search(
                model, encoder_out, encoder_mask, beam_size, length_penalty,
                infos)
        if not any(m.startswith('ctc_') or m == 'attention_rescoring'
                   for m in methods):
            return results
        ctc_probs = model.ctc_logprobs(encoder_out, blank_penalty, blank_id)
        if 'ctc_greedy_search' in methods:
            results['ctc_greedy_search'] = ctc_greedy_search(
                ctc_probs, encoder_lens, blank_id)
        if ('ctc_prefix_beam_search' in methods or
                'attention_rescoring' in methods):
            prefix = ctc_prefix_beam_search(ctc_probs, encoder_lens,
                                            beam_size, blank_id,
                                            context_graph)
            if 'ctc_prefix_beam_search' in methods:
                results['ctc_prefix_beam_search'] = prefix
            if 'attention_rescoring' in methods:
                results['attention_rescoring'] = attention_rescoring(
                    model, prefix, encoder_out, encoder_lens, ctc_weight,
                    reverse_weight, infos)
        return results

    def decode_wav(self, methods: List[str], wav, wav_lengths,
                   sample_rate: int = 16000, num_mel_bins: int = 80, **kw
                   ) -> Dict[str, List[DecodeResult]]:
        """Decode a batch of [-1, 1] waveforms (B, S) with valid lengths
        (B,): the kaldi fbank on the runner's device, then `decode` with
        `kw`."""
        wav = torch.as_tensor(wav, device=self.device, dtype=torch.float32)
        with torch.inference_mode():
            feats = compute_fbank(wav * (1 << 15), num_mel_bins=num_mel_bins,
                                  sample_rate=sample_rate)
        frame_shift = sample_rate // 100
        lens = torch.as_tensor(wav_lengths, device=self.device)
        flen = ((lens - sample_rate * 25 // 1000) // frame_shift + 1).clamp(
            0, feats.shape[1])
        return self.decode(methods, feats, flen, **kw)

    def transcribe(self, wav_path: str, tokenizer=None,
                   compute_feature=None, method: Optional[str] = None
                   ) -> DecodeResult:
        """One file: `compute_feature(wav_path)` gives its (T, F) features,
        then `decode` with `method` (the model's `default_decode_method`
        when None); `tokenizer` fills the result's text."""
        if compute_feature is None:
            raise ValueError('transcribe needs compute_feature')
        method = method or self.model.default_decode_method
        feats = torch.as_tensor(compute_feature(wav_path))[None]
        result = self.decode([method], feats, [feats.shape[1]])[method][0]
        if tokenizer is not None:
            result.text = tokenizer.detokenize(list(result.tokens))[0]
        return result
