"""AsrRunner: offline batch decode on one device.  Counterpart of
wenet_tpu/models/runner.py `AsrRunner.decode` for the CTC greedy, CTC
prefix beam, attention-rescoring and attention (beam search) modes, with
its simulated streaming (`simulate_streaming`), and of `decode_wav`
(the fbank on the device) and `transcribe`.

CTC prefix beam search runs in the port's C++ trie searcher
(wenet_tpu_torch/runtime/native_beam.py, built with g++ at first use),
fed with the per-frame top-k that `torch.topk` computes on the device."""

from typing import Dict, List, Optional

import torch

from wenet_tpu_torch.models.transformer.search import (
    DecodeResult, attention_beam_search, attention_rescoring,
    ctc_greedy_search)
from wenet_tpu_torch.models.transformer.streaming import (
    StreamingConfig, forward_chunk_by_chunk)
from wenet_tpu_torch.ops.fbank import compute_fbank
from wenet_tpu_torch.runtime import native_beam

MODES = ('ctc_greedy_search', 'ctc_prefix_beam_search',
         'attention_rescoring', 'attention')


def ctc_prefix_beam_search(ctc_probs: torch.Tensor,
                           encoder_lens: torch.Tensor, beam_size: int,
                           blank_id: int = 0) -> List[DecodeResult]:
    """Per-frame top-k on the device, then the C++ prefix beam on host.
    Raises when the native library cannot be built or loaded."""
    vals, ids = torch.topk(ctc_probs, beam_size, dim=-1)
    outs = native_beam.batch_search_topk(
        vals.float().cpu().numpy(), ids.int().cpu().numpy(),
        encoder_lens.cpu().numpy(), beam_size, blank_id)
    return [DecodeResult(tokens=hyps[0], score=scores[0], times=times[0],
                         nbest=hyps, nbest_scores=scores, nbest_times=times)
            for hyps, times, scores in outs]


class AsrRunner:
    """A model bound to a device, in eval mode.  `dtype` (e.g.
    torch.bfloat16) casts the floating weights, and the features with
    them, as the JAX runner's `dtype` does."""

    def __init__(self, model: torch.nn.Module, device='cuda',
                 dtype: Optional[torch.dtype] = None):
        self.device = torch.device(device)
        model = model.to(self.device).eval()
        if dtype is not None:
            model = model.to(dtype)
        self.dtype = dtype
        self.model = model

    @torch.inference_mode()
    def decode(self, methods: List[str], feats, feats_lengths,
               beam_size: int = 10, decoding_chunk_size: int = -1,
               num_decoding_left_chunks: int = -1, ctc_weight: float = 0.0,
               simulate_streaming: bool = False,
               reverse_weight: float = 0.0, blank_id: int = 0,
               blank_penalty: float = 0.0, length_penalty: float = 0.0,
               infos: Optional[Dict[str, List[str]]] = None
               ) -> Dict[str, List[DecodeResult]]:
        """feats: (B, T, F) array or tensor; feats_lengths: (B,).
        `simulate_streaming` with decoding_chunk_size > 0 runs the encoder
        chunk by chunk with its caches (`forward_chunk_by_chunk`; one
        utterance, B = 1); otherwise the encoder sees the whole input under
        the chunk mask.  `length_penalty` and `infos` (whisper's prompt:
        'tasks', 'langs', 'no_timestamp') are for the `attention` mode.
        Returns {mode: one DecodeResult per utterance}."""
        unknown = [m for m in methods if m not in MODES]
        if unknown:
            raise NotImplementedError(f'decode modes not ported: {unknown}')
        feats = torch.as_tensor(feats, device=self.device)
        if self.dtype is not None:
            feats = feats.to(self.dtype)
        feats_lengths = torch.as_tensor(feats_lengths, device=self.device)
        model = self.model
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
        results: Dict[str, List[DecodeResult]] = {}
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
                                            beam_size, blank_id)
            if 'ctc_prefix_beam_search' in methods:
                results['ctc_prefix_beam_search'] = prefix
            if 'attention_rescoring' in methods:
                results['attention_rescoring'] = attention_rescoring(
                    model, prefix, encoder_out, encoder_lens, ctc_weight,
                    reverse_weight)
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
