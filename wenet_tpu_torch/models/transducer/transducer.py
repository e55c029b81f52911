"""Transducer model: the RNN-T loss with the optional CTC and attention
losses of ASRModel, and two on-device searches.  Counterpart of
wenet_tpu/models/transducer/transducer.py.

Both searches keep the JAX package's fixed-shape formulation as loops of
tensor ops on the encoder's device, with no host sync inside:
`greedy_search` takes a fixed 2T steps, each consuming a frame (blank,
or the frame's non-blank budget `n_steps` spent) or emitting a token;
`beam_search` consumes one symbol per hypothesis and frame, fuses CTC
log-probs in and merges equal prefixes by a rolling hash.  Where the
order of equal values decides a result (a top-K, the final ranking) a
stable descending sort stands in for `lax.top_k` / `argsort`: the lower
index first."""

from typing import Dict, Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from wenet_tpu_torch.models.transformer.asr_model import ASRModel
from wenet_tpu_torch.ops.rnnt_loss import NEG_INF, rnnt_loss_logits
from wenet_tpu_torch.parallel.mesh import data_denominator
from wenet_tpu_torch.utils.common import IGNORE_ID, add_blank

_HASH_MUL = 1000003
_HASH_MASK = 0xFFFFFFFF  # the JAX package's uint32 hash wraps mod 2**32


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, equal values by lower index
    first (lax.top_k's order; torch.topk promises none on the card)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class Transducer(ASRModel):
    default_decode_method = 'rnnt_greedy_search'

    def __init__(self, vocab_size: int, encoder: nn.Module,
                 decoder: Optional[nn.Module], ctc: Optional[nn.Module],
                 predictor: nn.Module, joint: nn.Module, blank: int = 0,
                 transducer_weight: float = 1.0, ctc_weight: float = 0.5,
                 ignore_id: int = IGNORE_ID, reverse_weight: float = 0.0,
                 lsm_weight: float = 0.0,
                 length_normalized_loss: bool = False,
                 special_tokens: Optional[dict] = None):
        super().__init__(vocab_size, encoder, decoder, ctc, ctc_weight,
                         ignore_id, reverse_weight, lsm_weight,
                         length_normalized_loss, special_tokens)
        self.predictor = predictor
        self.joint = joint
        self.blank = blank
        self.transducer_weight = transducer_weight

    @property
    def attention_decoder_weight(self) -> float:
        return 1 - self.transducer_weight - self.ctc_weight

    def forward(self, feats: torch.Tensor, feats_lengths: torch.Tensor,
                target: torch.Tensor, target_lengths: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                dynamic_chunk: Optional[Tuple[int, int]] = None
                ) -> Dict[str, Optional[torch.Tensor]]:
        """-> {loss, loss_att, loss_ctc, loss_rnnt, th_accuracy}: loss =
        transducer_weight * loss_rnnt + attention_decoder_weight *
        loss_att + ctc_weight * loss_ctc, each where its weight is not 0.
        Rows with feats_lengths == 0 are dummies and leave every loss, as
        in ASRModel."""
        encoder_out, encoder_mask = self.encoder(
            feats, feats_lengths, generator=generator,
            dynamic_chunk=dynamic_chunk)
        encoder_out_lens = encoder_mask[:, 0, :].sum(-1)
        row_valid = feats_lengths > 0
        loss_rnnt = self._compute_rnnt_loss(encoder_out, encoder_out_lens,
                                            target, target_lengths,
                                            row_valid)
        loss = self.transducer_weight * loss_rnnt
        loss_att = acc_att = loss_ctc = None
        if self.attention_decoder_weight != 0.0 and self.decoder is not None:
            loss_att, acc_att = self._calc_att_loss(
                encoder_out, encoder_mask, target, target_lengths, row_valid)
            loss = loss + self.attention_decoder_weight * loss_att
        if self.ctc_weight != 0.0 and self.ctc is not None:
            loss_ctc, _ = self.ctc(encoder_out, encoder_out_lens, target,
                                   target_lengths, row_valid)
            loss = loss + self.ctc_weight * loss_ctc
        return {'loss': loss, 'loss_att': loss_att, 'loss_ctc': loss_ctc,
                'loss_rnnt': loss_rnnt, 'th_accuracy': acc_att}

    def _compute_rnnt_loss(self, encoder_out, encoder_out_lens, target,
                           target_lengths, row_valid):
        """Mean RNN-T loss over the valid rows; a dummy row enters with
        one frame and no label, so its loss and gradient stay finite
        before it is dropped."""
        ys_in = add_blank(target, self.blank, self.ignore_id)  # (B, U+1)
        logits = self.joint(encoder_out, self.predictor(ys_in))
        labels = target.masked_fill(target == self.ignore_id, self.blank)
        per = rnnt_loss_logits(
            logits, labels, torch.where(row_valid, encoder_out_lens, 1),
            torch.where(row_valid, target_lengths, 0), blank=self.blank,
            reduction='none')
        per = torch.where(row_valid, per, 0.0)
        return per.sum() / data_denominator(row_valid.sum())

    def _init_predictor(self, rows: int, like: torch.Tensor):
        """The predictor's state and output after the leading blank, for
        `rows` rows on `like`'s device and type."""
        state = self.predictor.init_state(rows, like.device, like.dtype)
        padding = torch.zeros(rows, 1, device=like.device, dtype=like.dtype)
        first = torch.full((rows, 1), self.blank, device=like.device,
                           dtype=torch.long)
        pred_out, state = self.predictor.forward_step(first, padding, state)
        return pred_out, state, padding

    def greedy_search(self, encoder_out: torch.Tensor,
                      encoder_out_lens: torch.Tensor,
                      n_steps: int = 64) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
        """Batched greedy decode -> (tokens (B, 2T) padded with blank,
        emitted counts (B,)).  Each of the 2T steps either emits the
        frame's best unit (and advances the predictor on that row) or,
        on blank or with `n_steps` units already emitted on this frame,
        moves the row to its next frame; a row past its length idles."""
        B, T, _ = encoder_out.shape
        dev = encoder_out.device
        max_steps = 2 * T
        enc = self.joint.project_enc(encoder_out)
        pred_out, state, padding = self._init_predictor(B, encoder_out)
        pred = self.joint.project_pred(pred_out)
        tokens = torch.full((B, max_steps), self.blank, device=dev,
                            dtype=torch.long)
        rows = torch.arange(B, device=dev)
        t = torch.zeros(B, device=dev, dtype=torch.long)
        noblk = torch.zeros_like(t)
        n_emit = torch.zeros_like(t)
        lens = encoder_out_lens.to(dev)
        for _ in range(max_steps):
            frame = enc[rows, t.clamp(max=T - 1)][:, None]  # (B, 1, J)
            best = self.joint(frame, pred, pre_project=False)[:, 0, 0] \
                .argmax(-1)
            active = t < lens
            emit = (best != self.blank) & (noblk < n_steps) & active
            tokens[rows, n_emit] = torch.where(emit, best, self.blank)
            n_emit = n_emit + emit.long()
            new_out, new_state = self.predictor.forward_step(
                best[:, None], padding, state)
            pred = torch.where(emit[:, None, None],
                               self.joint.project_pred(new_out), pred)
            state = self.predictor.select_state(new_state, state, emit)
            t = t + ((~emit) & active).long()
            noblk = torch.where(emit, noblk + 1, 0)
        return tokens, n_emit

    def beam_search(self, encoder_out: torch.Tensor,
                    encoder_out_lens: torch.Tensor, beam_size: int = 4,
                    ctc_weight: float = 0.3, transducer_weight: float = 0.7,
                    max_len: int = 64):
        """Batched RNN-T prefix beam search on the device -> (tokens
        (B, K, max_len), lengths (B, K), scores (B, K)), best first.

        Every frame each of the K hypotheses consumes one symbol of its
        top K (blank keeps the prefix and the predictor's state, a unit
        appends and advances the predictor; a unit at a full prefix
        buffer is barred), with CTC shallow fusion log(tw·e^rnnt +
        cw·e^ctc); candidates with equal prefixes (equal uint32 rolling
        hashes, collisions included) are log-added into the first; the K
        best go on.  Rows past their length keep their hypotheses."""
        B, T, _ = encoder_out.shape
        K, U = beam_size, max_len
        dev = encoder_out.device
        axis = self.predictor.state_batch_axis
        enc = self.joint.project_enc(encoder_out)
        pred_out, state, padding = self._init_predictor(B * K, encoder_out)
        tokens = torch.full((B, K, U), self.blank, device=dev,
                            dtype=torch.long)
        lens = torch.zeros(B, K, device=dev, dtype=torch.long)
        scores = torch.full((B, K), NEG_INF, device=dev)
        scores[:, 0] = 0.0
        # distinct dummy hashes keep the dead initial rows from merging
        hashes = torch.arange(K, device=dev) + 2
        hashes[0] = 1
        hashes = hashes.expand(B, K)
        base = torch.arange(B, device=dev)[:, None] * K
        N = K * K
        cand = torch.arange(N, device=dev)
        src = torch.arange(K, device=dev)[:, None].expand(K, K).reshape(N)
        pos = torch.arange(U, device=dev)
        use_ctc = self.ctc is not None and ctc_weight > 0.0
        if use_ctc:
            ctc_probs = self.ctc.log_softmax(encoder_out).exp()
        lens_in = encoder_out_lens.to(dev)
        for t in range(T):
            frame = enc[:, t].repeat_interleave(K, dim=0)[:, None]
            logits = self.joint(frame, self.joint.project_pred(pred_out),
                                pre_project=False)
            logp = F.log_softmax(logits[:, 0, 0].float(), -1).view(B, K, -1)
            if use_ctc:
                logp = torch.log(torch.clamp(
                    transducer_weight * logp.exp() +
                    ctc_weight * ctc_probs[:, t, None], min=1e-30))
            top_v, top_i = _top_k(logp, K)  # (B, K, K)
            cand_sc = scores[:, :, None] + top_v
            is_blank = top_i == self.blank
            cand_sc = cand_sc.masked_fill(~is_blank & (lens >= U)[:, :, None],
                                          NEG_INF)
            cand_h = torch.where(
                is_blank, hashes[:, :, None],
                (hashes[:, :, None] * _HASH_MUL + top_i + 1) & _HASH_MASK)
            p_sc, p_h = cand_sc.reshape(B, N), cand_h.reshape(B, N)
            p_tok, p_blank = top_i.reshape(B, N), is_blank.reshape(B, N)
            # prefix fusion: log-add equal prefixes into the first
            eq = p_h[:, :, None] == p_h[:, None, :]
            merged = torch.logsumexp(
                torch.where(eq, p_sc[:, None, :], NEG_INF), dim=-1)
            first = torch.where(eq, cand, N).amin(-1) == cand
            top_fv, top_fi = _top_k(torch.where(first, merged, NEG_INF), K)
            sel_src = src[top_fi]
            sel_tok = p_tok.gather(1, top_fi)
            sel_blank = p_blank.gather(1, top_fi)
            n_hash = p_h.gather(1, top_fi)
            n_tok = tokens.gather(1, sel_src[..., None].expand(B, K, U))
            n_len = lens.gather(1, sel_src)
            n_tok = torch.where((pos == n_len[..., None]) &
                                ~sel_blank[..., None], sel_tok[..., None],
                                n_tok)
            n_len = n_len + (~sel_blank).long()
            # the predictor: blank keeps the source's state and output, a
            # unit advances it
            idx = (base + sel_src).reshape(-1)
            g_state = tuple(s.index_select(axis, idx) for s in state)
            g_out = pred_out.index_select(0, idx)
            new_out, new_state = self.predictor.forward_step(
                sel_tok.reshape(-1, 1), padding, g_state)
            emit = ~sel_blank.reshape(-1)
            n_out = torch.where(emit[:, None, None], new_out, g_out)
            n_state = self.predictor.select_state(new_state, g_state, emit)
            active = t < lens_in  # (B,)
            a2 = active[:, None]
            tokens = torch.where(a2[..., None], n_tok, tokens)
            lens = torch.where(a2, n_len, lens)
            scores = torch.where(a2, top_fv, scores)
            hashes = torch.where(a2, n_hash, hashes)
            active_rows = active.repeat_interleave(K)
            pred_out = torch.where(active_rows[:, None, None], n_out,
                                   pred_out)
            state = self.predictor.select_state(n_state, state, active_rows)
        scores, order = torch.sort(scores, dim=1, descending=True,
                                   stable=True)
        tokens = tokens.gather(1, order[..., None].expand(B, K, U))
        return tokens, lens.gather(1, order), scores
