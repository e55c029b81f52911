"""The export and checkpoint holds of tests/test_torch_refused_options.py
(its families, models and bars), in a file of their own so that the
tier-1 command's workers run the parts side by side: bin/export_model's
programs equal eager within 1e-5, the JAX package's reference-layout
checkpoint loaded strict."""

import copy

import pytest
import torch

from test_torch_refused_options import DECODERS, batch, models
from torch_port_utils import IDIM, feats


EXPORTED = ['conformer_no_cnn_module', 'conformer_conv_bias_inner',
            'decoder_no_output_layer', 'decoder_post_norm_no_src',
            'efficient_post_norm_static']


@pytest.mark.parametrize('name', EXPORTED)
def test_export_equals_eager(name):
    """bin/export_model's programs (the chunk step, the full encoder, the
    rescoring decoder) equal eager within 1e-5; a decoder option's
    encoder is the tiny conformer, whose programs
    tests/test_torch_export.py holds, so only its decoder is exported."""
    from wenet_tpu_torch.bin import export_model as E
    from wenet_tpu_torch.models.transformer.streaming import StreamingConfig
    _, _, _, tmodel = models(name)
    enc = tmodel.encoder
    outs, wants = [], []
    if name not in DECODERS:
        cfg = StreamingConfig(4, 2, enc.subsampling_rate, enc.right_context)
        prog, args = E.export_encoder_chunk(tmodel, cfg, IDIM, device='cpu')
        args = list(args)
        args[1] = torch.tensor([6])
        args[2] = torch.randn(args[2].shape, generator=torch.Generator()
                              .manual_seed(1))
        x, lens = (torch.from_numpy(a) for a in feats(9, B=3, T=4 * 20 + 7))
        full, _ = E.export_encoder_full(tmodel, IDIM, device='cpu')
        outs += [prog.module()(*args), full.module()(x, lens)]
        with torch.no_grad():
            wants += [E._ChunkStep(tmodel)(*args),
                      E._FullEncoder(tmodel)(x, lens)]
    dec = E.export_decoder(tmodel, 3, 8, enc.output_size(), 0.3, 'cpu')
    hyps = torch.tensor([[2, 5, 6, 2, 2, 2, 2, 2]] * 3)
    dec_args = (hyps, torch.tensor([3, 4, 1]), torch.randn(1, 13, 64))
    outs.append(dec.module()(*dec_args))
    with torch.no_grad():
        wants.append(E._Rescore(tmodel, 0.3)(*dec_args))
    for got, want in zip(outs, wants):
        for g, w in zip(got, want):
            if w is not None:
                torch.testing.assert_close(g, w, atol=1e-5, rtol=0)


@pytest.mark.parametrize('name', ['conformer_conv_bias_inner',
                                  'conformer_no_macaron_relu',
                                  'decoder_no_output_layer',
                                  'branchformer_post_norm',
                                  'efficient_no_pos_no_cnn'])
def test_jax_torch_checkpoint_loads_strict(tmp_path, name):
    """The reference-layout .pt that the JAX package writes
    (`save_torch_checkpoint`) loads strict into the port's model and gives
    its outputs: no key missing or extra without the macaron FFN, the
    conv bias, the output layer or the after_norm."""
    from wenet_tpu.utils.checkpoint import save_torch_checkpoint
    from wenet_tpu_torch.utils.checkpoint import load_checkpoint
    from wenet_tpu_torch.utils.init_model import init_model
    cfg, _, variables, tmodel = models(name)
    path = str(tmp_path / 'final.pt')
    save_torch_checkpoint(variables, path)
    loaded = init_model(copy.deepcopy(cfg), device='cpu')
    load_checkpoint(loaded, path)
    loaded.eval()
    x, lens, _, _ = batch(5)
    with torch.no_grad():
        got = loaded.forward_encoder(torch.from_numpy(x),
                                     torch.from_numpy(lens))[0]
        want = tmodel.forward_encoder(torch.from_numpy(x),
                                      torch.from_numpy(lens))[0]
    torch.testing.assert_close(got, want, atol=0, rtol=0)
