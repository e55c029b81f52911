"""Serve from the programs bin/export_model.py writes, without the model's
Python code.  Counterpart of wenet_tpu/runtime/exported_model.py.

`ExportedAsrModel` loads `encoder_chunk.pt2`, `encoder_full.pt2` and
`decoder_rescore.pt2` with `torch.export.load` (after importing
ops/flash_attention.py, which registers K1's operator the encoder programs
call) and runs them on `device` ('cuda' unless the caller asks for the
CPU; a program exported on another device is moved there).
`ExportedAsrDecoder` is `AsrDecoder` (runtime/asr_decoder.py) with its
chunk step and its attention rescoring on those programs: the same
feature pipeline, endpointing and C++ prefix beam, the chunk geometry from
`export_meta.json`.

    from wenet_tpu_torch.runtime.exported_model import ExportedAsrDecoder
    dec = ExportedAsrDecoder('exp/export', tokenizer, device='cuda')
    dec.accept_waveform(pcm); dec.decode(); ...; dec.rescoring()
"""

import json
import os
from typing import Optional

import numpy as np
import torch

import wenet_tpu_torch.ops.flash_attention  # noqa: F401 (K1's operator)
from wenet_tpu_torch.models.transformer.streaming import (StreamingConfig,
                                                          streaming_att_mask)
from wenet_tpu_torch.runtime.asr_decoder import AsrDecoder, DecodeOptions
from wenet_tpu_torch.runtime.feature_pipeline import FeaturePipelineConfig

CACHE_INPUTS = ('att_k', 'att_v', 'cnn_cache')


def load_program(path: str, device) -> torch.export.ExportedProgram:
    """`torch.export.load`, moved to `device` when it was exported on
    another."""
    program = torch.export.load(path)
    tensors = list(program.state_dict.values()) + [
        t for t in program.constants.values() if isinstance(t, torch.Tensor)]
    if tensors and tensors[0].device != torch.device(device):
        from torch.export.passes import move_to_device_pass
        program = move_to_device_pass(program, torch.device(device))
    return program


class ExportedAsrModel:
    """The exported entry points, called as modules on `device`."""

    def __init__(self, export_dir: str, device='cuda'):
        self.device = torch.device(device)
        with open(os.path.join(export_dir, 'export_meta.json'),
                  encoding='utf-8') as f:
            self.meta = json.load(f)
        chunk = load_program(os.path.join(export_dir, 'encoder_chunk.pt2'),
                             self.device)
        # the caches' shapes and types are in the program's signature
        self._cache_vals = {
            node.name: node.meta['val'] for node in chunk.graph.nodes
            if node.op == 'placeholder' and node.name in CACHE_INPUTS}
        self.chunk_program = chunk
        self.chunk = chunk.module()
        self.full = load_program(
            os.path.join(export_dir, 'encoder_full.pt2'),
            self.device).module()
        dec_path = os.path.join(export_dir, 'decoder_rescore.pt2')
        self.decoder = (load_program(dec_path, self.device).module()
                        if os.path.exists(dec_path) else None)

    def zero_cache(self):
        """(att_k, att_v, cnn_cache) zeros of the exported shapes and types
        (cnn_cache None where the encoder has no causal conv)."""
        return tuple(
            torch.zeros(v.shape, dtype=v.dtype, device=self.device)
            if v is not None else None
            for v in (self._cache_vals.get(n) for n in CACHE_INPUTS))

    def forward_chunk(self, xs: torch.Tensor, offset: int, cache,
                      att_mask: torch.Tensor):
        """One chunk step -> (ys (1, chunk, D), log-probs (1, chunk, V),
        the new cache)."""
        # filled on the device: a copy from the host would wait for the
        # stream
        offset = torch.full((1,), offset, dtype=torch.int64,
                            device=self.device)
        ys, logp, k, v, cnn = self.chunk(xs, offset, *cache, att_mask)
        return ys, logp, (k, v, cnn)

    def forward_full(self, speech: torch.Tensor,
                     speech_lengths: torch.Tensor):
        """-> (encoder out, mask, CTC log-probs); the time must meet
        meta['time_constraint']."""
        return self.full(speech, speech_lengths)

    def rescore(self, hyps_pad: torch.Tensor, hyps_lens: torch.Tensor,
                encoder_out: torch.Tensor):
        """-> (decoder log-probs, the right decoder's or None)."""
        if self.decoder is None:
            raise RuntimeError('the decoder was not exported')
        out = self.decoder(hyps_pad, hyps_lens, encoder_out)
        return out[0], (out[1] if len(out) > 1 else None)


class ExportedAsrDecoder(AsrDecoder):
    """`AsrDecoder` running on the exported programs alone."""

    def __init__(self, export_dir: str, tokenizer,
                 opts: Optional[DecodeOptions] = None,
                 feature_config: Optional[FeaturePipelineConfig] = None,
                 endpoint_config=None, context_graph=None, device='cuda'):
        self.exported = ExportedAsrModel(export_dir, device)
        meta = self.exported.meta
        self.device = self.exported.device
        self.model = None
        self.batch_runner = None
        opts = opts or DecodeOptions(chunk_size=meta['chunk_size'],
                                     num_left_chunks=meta['num_left_chunks'])
        if (opts.chunk_size, opts.num_left_chunks) != (
                meta['chunk_size'], meta['num_left_chunks']):
            raise ValueError(
                f'the chunk step was exported for chunk_size '
                f'{meta["chunk_size"]}, num_left_chunks '
                f'{meta["num_left_chunks"]}: options ask for '
                f'{opts.chunk_size}, {opts.num_left_chunks}')
        cfg = StreamingConfig(
            decoding_chunk_size=meta['chunk_size'],
            num_decoding_left_chunks=meta['num_left_chunks'],
            subsampling_rate=meta['subsampling_rate'],
            right_context=meta['right_context'])
        self._setup(tokenizer, opts, feature_config or FeaturePipelineConfig(
            num_mel_bins=meta['input_dim']), endpoint_config, cfg, 1, None)
        self._make_searcher(context_graph)
        self.reset()

    def _zero_cache(self):
        return self.exported.zero_cache()

    def _chunk_step(self, chunk: np.ndarray, real_base: int, real_out: int):
        cfg = self.cfg
        chunk_out = (cfg.decoding_window - cfg.right_context - 1) // \
            cfg.subsampling_rate + 1
        att_mask = streaming_att_mask(1, cfg.required_cache_size, chunk_out,
                                      self.valid_cache, real_base,
                                      self.device)
        xs = torch.from_numpy(chunk)[None].to(self.device)
        ys, logp, self.state = self.exported.forward_chunk(
            xs, self.offset, self.state, att_mask)
        return ys[0, :real_out], logp[0, :real_out]

    def _rescore(self, hyps):
        """Attention rescoring through the exported decoder at its fixed
        (beam, max_hyp_len): the n-best's first `beam` hypotheses, each cut
        to max_hyp_len - 1 tokens, score = decoder log-probs of its tokens
        and <eos> (mixed with the right decoder's by reverse_weight) +
        ctc_weight * its CTC score, as the JAX package's
        ExportedAsrDecoder computes it."""
        if self.exported.decoder is None:
            return None
        meta = self.exported.meta
        beam, max_len = meta['beam'], meta['max_hyp_len']
        sos, eos = meta['sos'], meta['eos']
        n = min(len(hyps), beam)
        hyps = [list(h)[:max_len - 1] for h in hyps[:n]]
        hyps_pad = np.full((beam, max_len), eos, np.int64)
        hyps_pad[:, 0] = sos
        hyps_lens = np.ones(beam, np.int64)
        # position j predicts the token after j tokens: the hypothesis,
        # then <eos>; the right decoder reads it reversed
        targets = np.full((beam, max_len), eos, np.int64)
        r_targets = np.full((beam, max_len), eos, np.int64)
        valid = np.zeros((beam, max_len), bool)
        for i, h in enumerate(hyps):
            hyps_pad[i, 1:1 + len(h)] = h
            hyps_lens[i] = len(h) + 1
            targets[i, :len(h)] = h
            r_targets[i, :len(h)] = h[::-1]
            valid[i, :len(h) + 1] = True
        dev = self.device
        encoder_out = torch.cat(self.encoder_outs)[None]
        dec, r_dec = self.exported.rescore(
            torch.from_numpy(hyps_pad).to(dev),
            torch.from_numpy(hyps_lens).to(dev), encoder_out)
        valid_t = torch.from_numpy(valid).to(dev)

        def path_score(out, tgt):
            idx = torch.from_numpy(tgt).to(dev)[..., None]
            logp = torch.gather(out, 2, idx)
            return logp[..., 0].masked_fill(~valid_t, 0.0).double().sum(-1)

        score = path_score(dec, targets)
        rw = self.opts.reverse_weight
        if rw > 0.0 and r_dec is not None:
            score = score * (1 - rw) + path_score(r_dec, r_targets) * rw
        score = score[:n].cpu().numpy()
        likelihood = self.searcher.likelihood
        totals = [float(score[i]) + likelihood[i] * self.opts.ctc_weight
                  for i in range(n)]
        best = max(range(n), key=totals.__getitem__)
        times = self.searcher.times
        return hyps[best], totals[best], (times[best] if best < len(times)
                                          else [])
