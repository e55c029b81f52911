"""Paraformer decode post-processing on the host.  Counterpart of
wenet_tpu/models/paraformer/search.py: the greedy and "beam" results
from the argmax ids and their log-probs (the runner takes both on the
device, so the (B, L, V) log-probs never leave it), the CIF peak
timestamps, and the mixed Chinese / English detokenizer."""

import math
from typing import List

import numpy as np

from wenet_tpu_torch.models.transformer.search import DecodeResult


def _is_chinese(ch: str) -> bool:
    return '一' <= ch <= '鿿'


def _is_all_chinese(word) -> bool:
    word_lists = []
    for i in word:
        cur = i.replace(' ', '').replace('</s>', '').replace('<s>', '')
        word_lists.append(cur)
    if len(word_lists) == 0:
        return False
    return all(_is_chinese(ch) for phrase in word_lists for ch in phrase)


def _is_all_alpha(word) -> bool:
    word_lists = []
    for i in word:
        cur = i.replace(' ', '').replace('</s>', '').replace('<s>', '')
        word_lists.append(cur)
    if len(word_lists) == 0:
        return False
    for phrase in word_lists:
        if not phrase.isalpha() and '@' not in phrase:
            return False
    return True


def paraformer_beautify_result(tokens: List[str]) -> str:
    """Mixed Chinese / English detokenize: Chinese tokens as they are,
    `@@`-joined pieces merged, English words separated by spaces."""
    middle_lists: List[str] = []
    word_lists: List[str] = []
    word_item = ''
    for token in tokens:
        if token in ('<s>', '</s>', '<unk>'):
            continue
        middle_lists.append(token)
    for i, token in enumerate(middle_lists):
        if _is_all_chinese(token):
            if word_item:
                word_lists.append(word_item)
                word_lists.append(' ')
                word_item = ''
            word_lists.append(token)
        elif '@@' in token:
            word_item += token.replace('@@', '')
        elif _is_all_alpha(token):
            word_item += token
            word_lists.append(word_item)
            word_lists.append(' ')
            word_item = ''
    if word_item:
        word_lists.append(word_item)
    return ''.join(word_lists).strip()


def paraformer_greedy_search_ids(topk_index, logps_all,
                                 decoder_out_lens,
                                 cif_peaks=None) -> List[DecodeResult]:
    """Greedy results from the argmax ids (B, L) and their log-probs
    (B, L), taken on the device: the (B, L, V) log-probs stay there."""
    topk_index = np.asarray(topk_index)
    logps_all = np.asarray(logps_all)
    decoder_out_lens = np.asarray(decoder_out_lens)
    results: List[DecodeResult] = []
    for i in range(topk_index.shape[0]):
        n = int(decoder_out_lens[i])
        hyp = [int(t) for t in topk_index[i][:n]]
        logps = logps_all[i][:n]
        tokens_confidence = [math.exp(float(p)) for p in logps]
        confidence = math.exp(float(logps.sum()) / max(n, 1))
        results.append(
            DecodeResult(hyp, tokens_confidence=tokens_confidence,
                         confidence=confidence))
    _attach_peak_times(results, cif_peaks)
    return results


def _attach_peak_times(results, cif_peaks):
    """Each token's time: the frame of its CIF peak (a total of at least
    1 - 1e-4), in order, one per token."""
    if cif_peaks is None:
        return
    cif_peaks = np.asarray(cif_peaks)
    for b in range(cif_peaks.shape[0]):
        result = results[b]
        times = []
        n_token = 0
        for i, peak in enumerate(cif_peaks[b]):
            if n_token >= len(result.tokens):
                break
            if peak > 1 - 1e-4:
                times.append(i)
                n_token += 1
        result.times = times


def paraformer_beam_search_ids(topk_index, logps_all, decoder_out_lens,
                               **_) -> List[DecodeResult]:
    """The non-autoregressive "beam": positions are independent given
    the acoustic embeddings, so the best path is the argmax; the score is
    its summed log-prob (ids and log-probs taken on the device)."""
    topk_index = np.asarray(topk_index)
    logps_all = np.asarray(logps_all)
    decoder_out_lens = np.asarray(decoder_out_lens)
    results = []
    for b in range(topk_index.shape[0]):
        n = int(decoder_out_lens[b])
        results.append(DecodeResult(
            [int(t) for t in topk_index[b][:n]],
            score=float(logps_all[b][:n].sum())))
    return results
