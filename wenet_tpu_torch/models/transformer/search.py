"""Decode algorithms: CTC greedy and attention rescoring.  Counterpart
of wenet_tpu/models/transformer/search.py (the attention beam search is
not ported yet; CTC prefix beam search runs in the shared C++ searcher,
see models/runner.py)."""

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from wenet_tpu_torch.utils.mask import make_pad_mask

NEG_INF = -1.0e30


@dataclass
class DecodeResult:
    tokens: List[int]
    score: float = 0.0
    confidence: float = 0.0
    tokens_confidence: Optional[List[float]] = None
    times: Optional[List[int]] = None
    nbest: Optional[List[List[int]]] = None
    nbest_scores: Optional[List[float]] = None
    nbest_times: Optional[List[List[int]]] = None
    text: str = ''


def remove_duplicates_and_blank(hyp: List[int],
                                blank_id: int = 0) -> List[int]:
    """Collapse repeats, then drop blanks."""
    out: List[int] = []
    prev = None
    for t in hyp:
        if t != prev and t != blank_id:
            out.append(int(t))
        prev = t
    return out


def ctc_greedy_search(ctc_probs: torch.Tensor, ctc_lens: torch.Tensor,
                      blank_id: int = 0) -> List[DecodeResult]:
    """ctc_probs: (B, T, V) log-posteriors; ctc_lens: (B,) frames."""
    ids = ctc_probs.argmax(dim=2)
    ids = ids.masked_fill(make_pad_mask(ctc_lens, ids.shape[1]), blank_id)
    return [DecodeResult(remove_duplicates_and_blank(h, blank_id))
            for h in ids.cpu().tolist()]


def attention_rescoring(model, ctc_prefix_results: List[DecodeResult],
                        encoder_outs: torch.Tensor,
                        encoder_lens: torch.Tensor,
                        ctc_weight: float = 0.0,
                        reverse_weight: float = 0.0) -> List[DecodeResult]:
    """Rescore each utterance's CTC nbest with the attention decoder(s),
    the whole (B, N) grid in one batched decoder pass, and keep the best
    of score + ctc_weight * ctc_score per utterance."""
    device = encoder_outs.device
    B, T = encoder_outs.shape[:2]
    N = max(len(r.nbest) for r in ctc_prefix_results)
    max_len = max((len(h) for r in ctc_prefix_results for h in r.nbest),
                  default=0)
    # the JAX package's padded width, so both decode identical tensors
    L = max(8, -(-max_len // 8) * 8)
    hyps_pad = np.full((B, N, L + 1), model.eos, np.int64)
    hyps_pad[:, :, 0] = model.sos
    hyps_lens = np.zeros((B, N), np.int64)
    ctc_scores = np.full((B, N), NEG_INF, np.float32)  # empty slots lose
    for b, r in enumerate(ctc_prefix_results):
        for i, h in enumerate(r.nbest):
            hyps_pad[b, i, 1:1 + len(h)] = h
            hyps_lens[b, i] = len(h)
            ctc_scores[b, i] = r.nbest_scores[i]

    flat_hyps = torch.from_numpy(hyps_pad.reshape(B * N, L + 1)).to(device)
    flat_lens = torch.from_numpy(hyps_lens.reshape(B * N)).to(device)
    enc = encoder_outs.repeat_interleave(N, dim=0)
    enc_mask = (~make_pad_mask(encoder_lens.repeat_interleave(N, dim=0),
                               T))[:, None, :]
    decoder_out, r_decoder_out = model.forward_attention_decoder(
        flat_hyps, flat_lens + 1, enc, reverse_weight, enc_mask)

    tok = flat_hyps[:, 1:]
    pos = torch.arange(L, device=device)[None, :]
    tok_mask = pos < flat_lens[:, None]
    rows = torch.arange(B * N, device=device)

    def token_and_eos_scores(out, tokens):
        logp = torch.gather(out[:, :L], 2, tokens[..., None])[..., 0]
        logp = logp.masked_fill(~tok_mask, 0.0)
        return logp, logp.sum(-1) + out[rows, flat_lens, model.eos]

    logp_tok, score = token_and_eos_scores(decoder_out, tok)
    tc = torch.exp(logp_tok)
    if reverse_weight > 0.0:
        # the right decoder's position j holds the (len-1-j)-th token
        rev_idx = (flat_lens[:, None] - 1 - pos).clamp(0, L - 1)
        r_logp_tok, r_score = token_and_eos_scores(
            r_decoder_out, torch.gather(tok, 1, rev_idx))
        r_tc = torch.gather(r_logp_tok, 1, rev_idx)
        tc = (tc + torch.exp(r_tc.masked_fill(~tok_mask, 0.0))) / 2
        score = score * (1 - reverse_weight) + r_score * reverse_weight
    confidence = torch.exp(score / (flat_lens + 1))
    fused = (score.reshape(B, N) +
             ctc_weight * torch.from_numpy(ctc_scores).to(device))

    fused, confidence = fused.cpu().numpy(), confidence.reshape(B, N).cpu()
    tc = tc.reshape(B, N, L).cpu()
    results = []
    for b, r in enumerate(ctc_prefix_results):
        best = int(np.argmax(fused[b, :len(r.nbest)]))
        hyp = r.nbest[best]
        results.append(DecodeResult(
            list(hyp), float(fused[b, best]),
            confidence=float(confidence[b, best]),
            times=r.nbest_times[best] if r.nbest_times else None,
            tokens_confidence=[float(x) for x in tc[b, best, :len(hyp)]]))
    return results
