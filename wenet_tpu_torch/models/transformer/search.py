"""Decode algorithms: CTC greedy, attention beam search (with whisper's
prompt and timestamp grammar) and attention rescoring.  Counterpart of
wenet_tpu/models/transformer/search.py; CTC prefix beam search runs in
the port's C++ searcher, see models/runner.py."""

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from wenet_tpu_torch.models.whisper.tokens import build_whisper_prefix
from wenet_tpu_torch.utils.mask import (make_pad_mask, mask_finished_preds,
                                        mask_finished_scores)

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


# ---------------------------------------------------------------------------
# attention beam search
# ---------------------------------------------------------------------------
def _apply_timestamp_rules(logp: torch.Tensor, last: torch.Tensor,
                           pen: torch.Tensor, pen_exists: bool,
                           ts_max: torch.Tensor, ts_begin: int,
                           eot: int) -> torch.Tensor:
    """Whisper's timestamp grammar as a log-prob filter (the JAX
    package's rules, OpenAI's ApplyTimestampRules with special tokens in
    (eot, ts_begin) always suppressed).

    logp: (R, V) next-token log-probs; last, pen: (R,) the last and
    penultimate tokens of the sampled suffix (which starts at the
    prompt's <|0.00|> anchor); pen_exists: False while the suffix has
    length 1 (the penultimate then counts as a timestamp); ts_max: (R,)
    the latest timestamp so far (>= ts_begin)."""
    V = logp.shape[1]
    neg = -1e30
    vocab = torch.arange(V, device=logp.device)
    is_ts = vocab >= ts_begin
    last_is_ts = last >= ts_begin
    pen_is_ts = pen >= ts_begin if pen_exists else torch.ones_like(
        last_is_ts)

    is_special = (vocab > eot) & (vocab < ts_begin)
    logp = logp.masked_fill(is_special[None, :], neg)

    # pairing: after <ts><ts> (or the lone anchor) text must follow; after
    # a single <ts>, a <ts> or <eot>
    suppress_ts = last_is_ts & pen_is_ts
    suppress_text = last_is_ts & ~pen_is_ts
    is_textish = (vocab < ts_begin) & (vocab != eot)
    logp = logp.masked_fill(suppress_ts[:, None] & is_ts[None, :], neg)
    logp = logp.masked_fill(suppress_text[:, None] & is_textish[None, :],
                            neg)

    # monotonicity: a closing timestamp may repeat the opening one, the
    # next opening one must be later
    min_allowed = torch.where(last_is_ts & ~pen_is_ts, ts_max, ts_max + 1)
    below = vocab[None, :] < min_allowed[:, None]
    logp = logp.masked_fill(is_ts[None, :] & below, neg)

    # mass rule: force a timestamp when their total probability beats
    # every single text token (shift-invariant: no re-normalization)
    ts_mass = torch.logsumexp(logp.masked_fill(~is_ts[None, :], neg), dim=1)
    text_best = logp.masked_fill(is_ts[None, :], neg).amax(dim=1)
    force_ts = ts_mass > text_best
    return logp.masked_fill(force_ts[:, None] & ~is_ts[None, :], neg)


def _decode_prefix(model, B: int, N: int,
                   infos: Optional[Dict[str, List[str]]]
                   ) -> Tuple[np.ndarray, Optional[Tuple[int, int]]]:
    """The (B·N, P) prompt rows and the timestamp rules: [sos] for an
    ordinary model; whisper's [sot, lang, task, notimestamps | <|0.00|>]
    from `infos` ('tasks', 'langs', 'no_timestamp'; default transcribe,
    en, no timestamps), with (timestamp_begin, eot) when timestamps are
    asked for."""
    st = model.special_tokens
    if st is not None and 'transcribe' in st:
        infos = infos or {}
        tasks = infos.get('tasks', ['transcribe'] * B)
        langs = infos.get('langs', ['en'] * B)
        no_ts = bool(infos.get('no_timestamp', True))
        rows = []
        for b in range(B):
            row = build_whisper_prefix(st, tasks[b], langs[b],
                                       no_timestamp=no_ts)
            rows.extend([row] * N)
        ts_rules = (None if no_ts else
                    (int(st['timestamp_begin']), int(st['eot'])))
        return np.asarray(rows, np.int64), ts_rules
    return np.full((B * N, 1), model.sos, np.int64), None


# steps between checks that every beam has ended (each check waits for
# the card)
CHECK_EVERY = 8


def _topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim with ties in index order, as
    `jax.lax.top_k` breaks them."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def attention_beam_search(model, encoder_out: torch.Tensor,
                          encoder_mask: torch.Tensor, beam_size: int = 10,
                          length_penalty: float = 0.0,
                          infos: Optional[Dict[str, List[str]]] = None
                          ) -> List[DecodeResult]:
    """Autoregressive beam search with the decoder's incremental step.

    encoder_out: (B, T, D); encoder_mask: (B, 1, T).  The JAX package's
    while_loop runs here as a host loop over decoder steps, one batched
    step for all B·N beams: the prompt is fed first (teacher forcing),
    then each step takes the per-beam top-N, the per-utterance top-N of
    the N·N candidates, reorders the hyps and self buffers and feeds the
    winners.  At most maxlen + 1 positions (maxlen = T); the loop stops
    early once every beam has emitted eos, checked every `CHECK_EVERY`
    steps (a step after that changes no hyp and no score).  The encoder
    keys are projected once per utterance, not per beam.  Scores are
    divided by length ** length_penalty, the length counting the prompt;
    the results hold the tokens after the prompt, eos removed."""
    device = encoder_out.device
    B, maxlen, _ = encoder_out.shape
    N = beam_size
    eos = model.eos
    max_steps = maxlen + 1
    prefix_np, ts_rules = _decode_prefix(model, B, N, infos)
    P = prefix_np.shape[1]
    prefix = torch.from_numpy(prefix_np).to(device)

    state = model.decoder_init_state(encoder_out, max_steps + 1, N)
    scores = torch.tensor([0.0] + [-float('inf')] * (N - 1),
                          device=device).repeat(B)[:, None]  # (B*N, 1)
    end_flag = torch.zeros(B * N, 1, dtype=torch.bool, device=device)
    hyps = torch.full((B * N, max_steps + 1), eos, dtype=torch.long,
                      device=device)
    hyps[:, :P] = prefix
    logp = None
    for i in range(P):
        logp, state = model.decoder_forward_step(prefix[:, i:i + 1], i,
                                                 state, encoder_mask)
    if ts_rules is not None:
        ts_begin, eot = ts_rules
        ts_max = torch.where(prefix >= ts_begin, prefix,
                             ts_begin).amax(dim=1)
    base = (torch.arange(B, device=device) * N)[:, None]
    self_caches = state[0]

    for i in range(P, max_steps):
        if ts_rules is not None:
            logp = _apply_timestamp_rules(logp, hyps[:, i - 1],
                                          hyps[:, i - 2], i - (P - 1) >= 2,
                                          ts_max, ts_begin, eot)
        top_k_logp, top_k_index = _topk(logp, N)  # (B*N, N)
        top_k_logp = mask_finished_scores(top_k_logp, end_flag)
        top_k_index = mask_finished_preds(top_k_index, end_flag, eos)
        s, offset_k_index = _topk((scores + top_k_logp).reshape(B, N * N),
                                  N)
        cache_index = (offset_k_index // N + base).reshape(-1)
        # reorder the beam-dependent state: positions < i are written
        for k_buf, v_buf in self_caches:
            k_buf[:, :, :i] = k_buf[cache_index, :, :i]
            v_buf[:, :, :i] = v_buf[cache_index, :, :i]
        hyps = hyps[cache_index]
        best_k_pred = torch.gather(top_k_index.reshape(B, N * N), 1,
                                   offset_k_index).reshape(-1)
        hyps[:, i] = best_k_pred
        scores = s.reshape(-1, 1)
        end_flag = (best_k_pred == eos)[:, None]
        if ts_rules is not None:
            ts_max = ts_max[cache_index]
            ts_max = torch.where(best_k_pred >= ts_begin,
                                 torch.maximum(ts_max, best_k_pred), ts_max)
        logp, state = model.decoder_forward_step(best_k_pred[:, None], i,
                                                 state, encoder_mask)
        if (i + 1 - P) % CHECK_EVERY == 0 and bool(end_flag.all()):
            break

    scores = scores.reshape(B, N)
    lengths = (hyps != eos).sum(dim=1).reshape(B, N).float()
    scores = scores / lengths ** length_penalty
    best_scores, best_index = scores.max(dim=-1)
    best_hyps = hyps[best_index + torch.arange(B, device=device) * N]
    best_hyps, best_scores = best_hyps.cpu().numpy(), best_scores.cpu()
    return [DecodeResult([int(x) for x in best_hyps[b, P:] if int(x) != eos],
                         score=float(best_scores[b])) for b in range(B)]
