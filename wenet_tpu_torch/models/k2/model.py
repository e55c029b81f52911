"""The k2 model: LF-MMI training and HLG decoding.  Counterpart of
wenet_tpu/models/k2/model.py, on this package's own pieces:

* The LF-MMI loss replaces the CTC branch of the joint loss: -(numerator
  - den_scale x denominator) per row, where the numerator is the CTC
  forward score of the supervision (`F.ctc_loss`, blank 0; infeasible
  rows count 0, as `ctc.py` counts them) and the denominator the forward
  score of the frame posteriors through the graph of
  `lfmmi_dir/den.txt` (`ops/fsa.py` `fsa_forward_score`; built by
  `lm/build_graph.py` `build_den_graph`, or the JAX package's
  tools/k2/prepare_mmi.py).  Rows with feats_lengths == 0 are left out.
  Without `lfmmi_dir` the model is `ASRModel`.
* `hlg_onebest` / `hlg_rescore` decode over an HLG text FST (`build_hlg`,
  or tools/k2/make_hlg.sh) with the token-passing searcher
  (`runtime/wfst_beam_search.py`): the best word path as unit ids, or
  the n-best re-ranked by am + lm_scale x lm + decoder_scale x att +
  r_decoder_scale x r_att, the right decoder at a fixed reverse weight
  of 0.5."""

import functools
import os
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from wenet_tpu_torch.lm.fst import TextFst, read_symbol_table
from wenet_tpu_torch.models.transformer.asr_model import ASRModel
from wenet_tpu_torch.parallel.mesh import data_denominator
from wenet_tpu_torch.ops.fsa import (DenseFsa, fsa_forward_score,
                                     fst_to_dense_arcs)


@functools.lru_cache(maxsize=4)
def load_den_fsa(lfmmi_dir: str) -> DenseFsa:
    return fst_to_dense_arcs(TextFst.read(os.path.join(lfmmi_dir,
                                                       'den.txt')))


@functools.lru_cache(maxsize=4)
def _load_hlg(path: str) -> TextFst:
    return TextFst.read(path)


@functools.lru_cache(maxsize=4)
def _load_word_table(path: str) -> Dict[int, str]:
    return read_symbol_table(path)


class K2Model(ASRModel):

    def __init__(self, vocab_size: int, encoder, decoder, ctc,
                 lfmmi_dir: str = '', den_scale: float = 1.0, **kwargs):
        super().__init__(vocab_size, encoder, decoder, ctc, **kwargs)
        if lfmmi_dir and ctc.blank_id != 0:
            raise ValueError('the LF-MMI numerator takes blank 0, the den '
                             f'graph\'s; ctc_blank_id is {ctc.blank_id}')
        self.lfmmi_dir = lfmmi_dir
        self.den_scale = den_scale

    def lfmmi_loss(self, encoder_out: torch.Tensor,
                   encoder_out_lens: torch.Tensor, target: torch.Tensor,
                   target_lengths: torch.Tensor,
                   row_valid: torch.Tensor) -> torch.Tensor:
        """The mean over valid rows of -(num - den_scale x den)."""
        num, logprobs = self.ctc.loss_per_sequence(
            encoder_out, encoder_out_lens, target, target_lengths, row_valid)
        den = fsa_forward_score(logprobs, encoder_out_lens,
                                load_den_fsa(self.lfmmi_dir))
        per_utt = torch.where(row_valid, num + self.den_scale * den, 0.0)
        return per_utt.sum() / data_denominator(row_valid.sum())

    def forward(self, feats: torch.Tensor, feats_lengths: torch.Tensor,
                target: torch.Tensor, target_lengths: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                dynamic_chunk=None) -> Dict[str, Optional[torch.Tensor]]:
        """ASRModel's joint loss with the LF-MMI loss as its loss_ctc."""
        if not self.lfmmi_dir:
            return super().forward(feats, feats_lengths, target,
                                   target_lengths, generator, dynamic_chunk)
        encoder_out, encoder_mask = self.encoder(
            feats, feats_lengths, generator=generator,
            dynamic_chunk=dynamic_chunk)
        encoder_out_lens = encoder_mask[:, 0, :].sum(-1)
        row_valid = feats_lengths > 0
        loss_ctc = loss_att = acc_att = None
        if self.ctc_weight != 0.0:
            loss_ctc = self.lfmmi_loss(encoder_out, encoder_out_lens, target,
                                       target_lengths, row_valid)
        if self.ctc_weight != 1.0:
            loss_att, acc_att = self._calc_att_loss(
                encoder_out, encoder_mask, target, target_lengths, row_valid)
        if loss_ctc is None:
            loss = loss_att
        elif loss_att is None:
            loss = loss_ctc
        else:
            loss = (self.ctc_weight * loss_ctc +
                    (1 - self.ctc_weight) * loss_att)
        return {'loss': loss, 'loss_att': loss_att, 'loss_ctc': loss_ctc,
                'th_accuracy': acc_att}


# --- HLG decoding: the device's encoder and CTC, the host's search -------
class HlgSearch(NamedTuple):
    nbest: list  # each row's searcher n-best [(cost, token)]
    word_table: Dict[int, str]
    encoder_out: torch.Tensor  # on the device
    enc_lens: np.ndarray


@torch.no_grad()
def hlg_search(model, speech: torch.Tensor, speech_lengths: torch.Tensor,
               hlg: str, word: str, beam_size: int = 10,
               nbest_width: int = 4) -> HlgSearch:
    """The encoder and CTC log-probs of a batch on its device, one copy to
    the host, and each row's token-passing search over the HLG.  Both hlg
    modes read one search (the JAX package runs it once a mode)."""
    from wenet_tpu_torch.runtime.wfst_beam_search import CtcWfstBeamSearch
    fst = _load_hlg(hlg)
    word_table = _load_word_table(word)
    encoder_out, encoder_mask = model.forward_encoder(speech, speech_lengths)
    logp = model.ctc_activation(encoder_out)
    enc_lens = encoder_mask[:, 0, :].sum(-1).cpu().numpy()
    ctc_probs = logp.float().cpu().numpy()
    per_utt = []
    for b in range(ctc_probs.shape[0]):
        dec = CtcWfstBeamSearch(fst, word_table=word_table,
                                beam_size=beam_size, nbest_width=nbest_width)
        dec.search(ctc_probs[b, :int(enc_lens[b])])
        dec.finalize_search()
        per_utt.append(dec._nbest())
    return HlgSearch(per_utt, word_table, encoder_out, enc_lens)


def _words_to_units(words: List[int], word_table: Dict[int, str],
                    symbol_table: Dict[str, int]) -> List[int]:
    """Word ids -> their strings' characters -> unit ids (those the table
    has)."""
    return [symbol_table[ch] for w in words for ch in word_table[w]
            if ch in symbol_table]


def hlg_onebest(model, speech: torch.Tensor, speech_lengths: torch.Tensor,
                hlg: str, word: str, symbol_table: Dict[str, int],
                search: Optional[HlgSearch] = None) -> List[List[int]]:
    """Each row's best word path over the HLG, as unit ids (`search`: the
    batch's `hlg_search`, when it has one)."""
    if search is None:
        search = hlg_search(model, speech, speech_lengths, hlg, word)
    return [_words_to_units(list(nbest[0][1].words), search.word_table,
                            symbol_table) if nbest else []
            for nbest in search.nbest]


@torch.no_grad()
def hlg_rescore(model, speech: torch.Tensor, speech_lengths: torch.Tensor,
                hlg: str, word: str, symbol_table: Dict[str, int],
                lm_scale: float = 0.0, decoder_scale: float = 0.0,
                r_decoder_scale: float = 0.0,
                search: Optional[HlgSearch] = None) -> List[List[int]]:
    """Each row's n-best over the HLG re-ranked by am + lm_scale x lm +
    decoder_scale x att + r_decoder_scale x r_att (the attention decoders'
    token log-probs; the right one's with its <eos>)."""
    if search is None:
        search = hlg_search(model, speech, speech_lengths, hlg, word)
    per_utt, word_table, encoder_out, enc_lens = search
    sos, eos = model.sos, model.eos
    device = encoder_out.device
    results = []
    for b, nbest in enumerate(per_utt):
        if not nbest:
            results.append([])
            continue
        hyps = [_words_to_units(list(tok.words), word_table, symbol_table)
                for _, tok in nbest]
        max_len = max(len(h) for h in hyps)
        hyps_pad = np.full((len(hyps), max_len + 1), eos, np.int64)
        hyps_pad[:, 0] = sos
        for i, h in enumerate(hyps):
            hyps_pad[i, 1:1 + len(h)] = h
        hyps_lens = np.asarray([len(h) + 1 for h in hyps], np.int64)
        enc = encoder_out[b:b + 1, :int(enc_lens[b])]
        decoder_out, r_decoder_out = model.forward_attention_decoder(
            torch.from_numpy(hyps_pad).to(device),
            torch.from_numpy(hyps_lens).to(device), enc, 0.5)
        decoder_out = decoder_out.float().cpu().numpy()
        if r_decoder_out is not None:
            r_decoder_out = r_decoder_out.float().cpu().numpy()
        best_i, best_score = 0, -float('inf')
        for i, h in enumerate(hyps):
            dec = sum(decoder_out[i, j, h[j]] for j in range(len(h)))
            r_dec = 0.0
            if r_decoder_out is not None:
                r_dec = sum(r_decoder_out[i, len(h) - j - 1, h[j]]
                            for j in range(len(h)))
                r_dec += r_decoder_out[i, len(h), eos]
            tot = (-nbest[i][1].ac + lm_scale * -nbest[i][1].gc +
                   decoder_scale * dec + r_decoder_scale * r_dec)
            if tot > best_score:
                best_score, best_i = tot, i
        results.append(hyps[best_i])
    return results
