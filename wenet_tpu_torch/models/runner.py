"""AsrRunner: offline batch decode on one device.  Counterpart of
wenet_tpu/models/runner.py `AsrRunner.decode` for the CTC greedy, CTC
prefix beam and attention-rescoring modes.

CTC prefix beam search runs in the shared C++ trie searcher
(wenet_tpu.runtime.native_beam, numpy + ctypes, no jax), fed with the
per-frame top-k that `torch.topk` computes on the device."""

from typing import Dict, List

import torch

from wenet_tpu_torch.models.transformer.search import (DecodeResult,
                                                       attention_rescoring,
                                                       ctc_greedy_search)

MODES = ('ctc_greedy_search', 'ctc_prefix_beam_search',
         'attention_rescoring')


def ctc_prefix_beam_search(ctc_probs: torch.Tensor,
                           encoder_lens: torch.Tensor, beam_size: int,
                           blank_id: int = 0) -> List[DecodeResult]:
    """Per-frame top-k on the device, then the C++ prefix beam on host.
    Raises when the native library cannot be built or loaded."""
    from wenet_tpu.runtime import native_beam
    if not native_beam.available():
        raise RuntimeError('ctc prefix beam search needs the native C++ '
                           'searcher: make -C wenet_tpu/runtime/cpp')
    vals, ids = torch.topk(ctc_probs, beam_size, dim=-1)
    outs = native_beam.batch_search_topk(
        vals.float().cpu().numpy(), ids.int().cpu().numpy(),
        encoder_lens.cpu().numpy(), beam_size, blank_id)
    return [DecodeResult(tokens=hyps[0], score=scores[0], times=times[0],
                         nbest=hyps, nbest_scores=scores, nbest_times=times)
            for hyps, times, scores in outs]


class AsrRunner:
    """A model bound to a device, in eval mode."""

    def __init__(self, model: torch.nn.Module, device='cuda'):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()

    @torch.inference_mode()
    def decode(self, methods: List[str], feats, feats_lengths,
               beam_size: int = 10, decoding_chunk_size: int = -1,
               num_decoding_left_chunks: int = -1, ctc_weight: float = 0.0,
               reverse_weight: float = 0.0, blank_id: int = 0,
               blank_penalty: float = 0.0
               ) -> Dict[str, List[DecodeResult]]:
        """feats: (B, T, F) array or tensor; feats_lengths: (B,).
        Returns {mode: one DecodeResult per utterance}."""
        unknown = [m for m in methods if m not in MODES]
        if unknown:
            raise NotImplementedError(f'decode modes not ported: {unknown}')
        feats = torch.as_tensor(feats, device=self.device)
        feats_lengths = torch.as_tensor(feats_lengths, device=self.device)
        model = self.model
        encoder_out, encoder_mask = model.forward_encoder(
            feats, feats_lengths, decoding_chunk_size,
            num_decoding_left_chunks)
        encoder_lens = encoder_mask[:, 0, :].sum(-1)
        ctc_probs = model.ctc_logprobs(encoder_out, blank_penalty, blank_id)
        results: Dict[str, List[DecodeResult]] = {}
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
