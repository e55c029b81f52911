"""Export the deployment surface of a model as `torch.export` programs.
Counterpart of wenet_tpu/bin/export_model.py (the recipe's stage 6), with
`torch.export` in place of `jax.export`: each entry point is traced once
into an ExportedProgram and saved with `torch.export.save`; a later
process loads it with `torch.export.load` (runtime/exported_model.py) and
runs it without the model's Python code.  K1, the rel-pos attention
kernel, stays one node of each encoder program: the registered operator
`wenet_tpu_torch::relpos_attention_fwd` (ops/flash_attention.py), which
launches the CUDA kernel on the card and its plain version on the CPU.

Written to --output_dir:
  encoder_chunk.pt2    (xs, offset, att_k, att_v, cnn_cache, att_mask)
                       -> (ys, logp, new att_k, new att_v, new cnn_cache):
                       the streaming chunk step at fixed shapes, xs
                       (1, decoding_window, input_dim), offset a (1,) int64
                       tensor, so that one program serves every position
                       (no cnn cache in or out for a non-causal conv)
  encoder_full.pt2     (speech, speech_lengths) -> (out, mask, logp) with
                       a dynamic batch and time T = sub*t + (right_context
                       + sub) ('time_constraint' in the meta)
  decoder_rescore.pt2  (hyps, hyps_lens, encoder_out) -> decoder log-probs
                       (and the right decoder's with --reverse_weight > 0)
                       at fixed (beam, max_hyp_len), any encoder length
  export_meta.json     the JAX package's keys: chunk geometry, dims, beam,
                       sos / eos, time constraint

    python -m wenet_tpu_torch.bin.export_model --config exp/train.yaml \\
        --checkpoint exp/final.pt --output_dir exp/export --device cuda

The programs run on the device they were exported on (`--device`,
default cuda); `runtime/exported_model.py` moves them where asked.  Plain
self-attention and the decoder's cross attention are exported on the
plain matmul-softmax-matmul path, whatever the lengths: the flash gate
(`flash_eligible` in models/transformer/attention.py) is False while
`torch.export` traces, and its length rule is False for a symbolic
length, as the JAX package's export (wenet_tpu/bin/export_model.py)
never turns its `_FLASH` switch on.  So an exported transformer encoder,
or a decoder at any max_hyp_len, holds no K4: eager above the gate runs
K4, the exported program the plain path.  Shaw and RoPE self-attention
and GQA/MQA caches of `n_kv_head` heads export the same way."""

import argparse
import json
import os

import torch
from torch import nn

from wenet_tpu_torch.models.transformer.streaming import (StreamingConfig,
                                                          streaming_att_mask)

# the longest utterance an exported full encoder takes: t output frames
MAX_FRAMES = 8192


class _ChunkStep(nn.Module):

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, xs, offset, att_k, att_v, cnn_cache, att_mask):
        ys, (k, v), cnn = self.model.forward_encoder_chunk(
            xs, offset, (att_k, att_v), cnn_cache, att_mask)
        return ys, self.model.ctc_activation(ys), k, v, cnn


class _FullEncoder(nn.Module):

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, speech, speech_lengths):
        out, mask = self.model.forward_encoder(speech, speech_lengths)
        return out, mask, self.model.ctc_activation(out)


class _Rescore(nn.Module):

    def __init__(self, model, reverse_weight: float):
        super().__init__()
        self.model = model
        self.reverse_weight = reverse_weight

    def forward(self, hyps, hyps_lens, encoder_out):
        dec, r_dec = self.model.forward_attention_decoder(
            hyps, hyps_lens, encoder_out, self.reverse_weight)
        return (dec,) if r_dec is None else (dec, r_dec)


def _export(module, args, dynamic_shapes=None):
    with torch.no_grad():
        return torch.export.export(module, args,
                                   dynamic_shapes=dynamic_shapes)


def export_encoder_chunk(model, cfg: StreamingConfig, input_dim: int,
                         device='cuda'):
    """The streaming chunk step at fixed shapes -> (ExportedProgram, the
    example arguments it was traced with)."""
    att_cache, cnn_cache = model.encoder.zero_cache(
        1, cfg.required_cache_size, device=device)
    chunk_out = (cfg.decoding_window - cfg.right_context - 1) \
        // cfg.subsampling_rate + 1
    # distinct k and v (zero_cache hands one tensor for both): the export
    # would otherwise take the two inputs for one
    args = (torch.zeros(1, cfg.decoding_window, input_dim, device=device),
            torch.zeros(1, dtype=torch.int64, device=device),
            att_cache[0], att_cache[1].clone(), cnn_cache,
            streaming_att_mask(1, cfg.required_cache_size, chunk_out,
                               cfg.required_cache_size, device=device))
    return _export(_ChunkStep(model), args), args


def export_encoder_full(model, input_dim: int, device='cuda'):
    """The full-context encoder and CTC head with a dynamic batch and time
    -> (ExportedProgram, time constraint).  T = sub*t + (right_context +
    sub) gives t + 1 whole output frames, so the subsampling's lengths
    simplify without a guard."""
    enc = model.encoder
    sub, ctx = enc.subsampling_rate, enc.right_context + 1
    constraint = f'{sub}*t + {ctx + sub - 1}'
    b = torch.export.Dim('b', min=1, max=1024)
    t = torch.export.Dim('t', min=1, max=MAX_FRAMES)
    time = sub * t + (ctx + sub - 1)
    T = sub * 8 + ctx + sub - 1
    args = (torch.zeros(2, T, input_dim, device=device),
            torch.full((2,), T, dtype=torch.int64, device=device))
    dims = {'speech': {0: b, 1: time}, 'speech_lengths': {0: b}}
    return _export(_FullEncoder(model), args, dims), constraint


def export_decoder(model, beam: int, max_len: int, d_model: int,
                   reverse_weight: float, device='cuda'):
    """The rescoring decoder at fixed (beam, max_len) and a dynamic encoder
    length -> ExportedProgram.  Its attention is the plain path at every
    max_len (the flash gate is off under `torch.export`)."""
    te = torch.export.Dim('te', min=1, max=MAX_FRAMES)
    args = (torch.full((beam, max_len), model.sos, dtype=torch.int64,
                       device=device),
            torch.ones(beam, dtype=torch.int64, device=device),
            torch.zeros(1, 9, d_model, device=device))
    dims = {'hyps': None, 'hyps_lens': None, 'encoder_out': {1: te}}
    return _export(_Rescore(model, reverse_weight), args, dims)


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument('--config', required=True)
    p.add_argument('--checkpoint', required=True)
    p.add_argument('--output_dir', required=True)
    p.add_argument('--chunk_size', type=int, default=16)
    p.add_argument('--num_left_chunks', type=int, default=-1)
    p.add_argument('--beam', type=int, default=10)
    p.add_argument('--max_hyp_len', type=int, default=64)
    p.add_argument('--reverse_weight', type=float, default=0.0)
    p.add_argument('--device', default='cuda')
    return p


def main(argv=None) -> dict:
    """Write the three programs and the meta -> the meta."""
    from wenet_tpu_torch.utils.checkpoint import load_model
    from wenet_tpu_torch.utils.config import load_config
    args = get_parser().parse_args(argv)
    configs = load_config(args.config)
    model = load_model(configs, args.checkpoint, args.device)
    model.requires_grad_(False)
    os.makedirs(args.output_dir, exist_ok=True)
    input_dim = configs['input_dim']
    enc = model.encoder
    cfg = StreamingConfig(decoding_chunk_size=args.chunk_size,
                          num_decoding_left_chunks=args.num_left_chunks,
                          subsampling_rate=enc.subsampling_rate,
                          right_context=enc.right_context)
    meta = {
        'chunk_size': args.chunk_size,
        'num_left_chunks': args.num_left_chunks,
        'decoding_window': cfg.decoding_window,
        'stride': cfg.stride,
        'required_cache_size': cfg.required_cache_size,
        'subsampling_rate': enc.subsampling_rate,
        'right_context': enc.right_context,
        'input_dim': input_dim,
        'output_dim': configs['output_dim'],
        'beam': args.beam,
        'max_hyp_len': args.max_hyp_len,
        'sos': int(model.sos),
        'eos': int(model.eos),
    }

    def save(program, name):
        torch.export.save(program, os.path.join(args.output_dir, name))

    save(export_encoder_chunk(model, cfg, input_dim, args.device)[0],
         'encoder_chunk.pt2')
    program, meta['time_constraint'] = export_encoder_full(
        model, input_dim, args.device)
    save(program, 'encoder_full.pt2')
    if model.decoder is not None:
        save(export_decoder(model, args.beam, args.max_hyp_len,
                            enc.output_size(), args.reverse_weight,
                            args.device), 'decoder_rescore.pt2')
    with open(os.path.join(args.output_dir, 'export_meta.json'), 'w') as f:
        json.dump(meta, f, indent=2)
    print(f'exported to {args.output_dir}')
    return meta


if __name__ == '__main__':
    main()
