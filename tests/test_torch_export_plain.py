"""The export holds of tests/test_torch_export.py that need no exported
flagship (its module fixture), in a file of their own so that the
tier-1 command's workers run them beside it: eager rel-pos inference
through the registered operator (one graph node), the conv2d
transformer's export on the plain path against the JAX package within
2e-4, and the flash gate's rule false on a symbolic length."""

import numpy as np
import torch
import yaml

from test_torch_export import _close, _op_nodes
from torch_port_utils import IDIM, jax_model, zoo_config


def test_eager_inference_goes_through_the_op():
    """Without grad, rel-pos attention is the registered operator: the
    plain version's values, laid out as the kernel writes them
    ((B, T1, h, d) memory), and one graph node when traced."""
    from wenet_tpu_torch.ops.flash_attention import (flash_attention_relpos,
                                                     relpos_fwd_reference)
    rng = np.random.RandomState(3)
    B, H, T1, T2, D = 2, 2, 5, 9, 16
    q1, q2 = (torch.from_numpy(rng.randn(B, H, T1, D).astype(np.float32))
              for _ in range(2))
    k, p, v = (torch.from_numpy(rng.randn(B, H, T2, D).astype(np.float32))
               for _ in range(3))
    mask = torch.from_numpy(rng.rand(B, 1, T2) > 0.3)
    with torch.no_grad():
        out = flash_attention_relpos(q1, q2, k, p, v, mask, 0.25)
    want, _ = relpos_fwd_reference(q1, q2, k, p, v, mask, 0.25)
    assert torch.equal(out, want)
    assert out.transpose(1, 2).is_contiguous()

    class Attend(torch.nn.Module):
        def forward(self, q1, q2, k, p, v, mask):
            return flash_attention_relpos(q1, q2, k, p, v, mask, 0.25)

    with torch.no_grad():
        program = torch.export.export(Attend(), (q1, q2, k, p, v, mask))
    assert _op_nodes(program) == 1
    assert torch.equal(program.module()(q1, q2, k, p, v, mask), want)


def test_export_refuses_a_gated_encoder(tmp_path):
    """The export that used to be refused: the conv2d abs-pos
    transformer's full encoder (plain self-attention) and its rescoring
    decoder at max_hyp_len 128 (the length where the cross attention's
    gate could open) export through bin/export_model, on the plain path
    as the JAX package's export, and match the JAX package's
    `forward_encoder` + `ctc_activation` and `forward_attention_decoder`
    within 2e-4."""
    import jax.numpy as jnp
    from wenet_tpu.utils.checkpoint import save_torch_checkpoint
    from wenet_tpu_torch.bin.export_model import main
    from wenet_tpu_torch.runtime.exported_model import ExportedAsrModel
    cfg = zoo_config('transformer')
    model, variables = jax_model(cfg, seed=37)
    (tmp_path / 'train.yaml').write_text(yaml.safe_dump(cfg))
    save_torch_checkpoint(variables, str(tmp_path / 'final.pt'))
    args = ['--config', str(tmp_path / 'train.yaml'), '--checkpoint',
            str(tmp_path / 'final.pt'), '--output_dir', str(tmp_path / 'out'),
            '--device', 'cpu', '--chunk_size', '4', '--beam', '2',
            '--max_hyp_len', '128', '--reverse_weight', '0.3']
    main(args)
    em = ExportedAsrModel(str(tmp_path / 'out'), device='cpu')
    sub = model.encoder.subsampling_rate
    T = sub * 21 + model.encoder.right_context + sub
    rng = np.random.RandomState(6)
    speech = rng.randn(2, T, IDIM).astype(np.float32)
    lens = np.asarray([T, T - 17], np.int64)
    out, mask, logp = em.forward_full(torch.from_numpy(speech),
                                      torch.from_numpy(lens))
    jout, jmask = model.apply(variables, jnp.asarray(speech),
                              jnp.asarray(lens, jnp.int32),
                              method=model.forward_encoder)
    jlogp = model.apply(variables, jout, method=model.ctc_activation)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    valid = np.asarray(jmask)[:, 0, :, None]
    _close(out * torch.from_numpy(valid), np.asarray(jout) * valid)
    _close(logp * torch.from_numpy(valid), np.asarray(jlogp) * valid)
    hyps = rng.randint(3, 30, (2, 128))
    hyps[:, 0] = em.meta['sos']
    hlens = np.asarray([128, 57])
    enc = np.asarray(jout)[:1]
    dec, r_dec = em.rescore(torch.from_numpy(hyps), torch.from_numpy(hlens),
                            torch.from_numpy(enc))
    jdec, jr_dec = model.apply(
        variables, jnp.asarray(hyps, jnp.int32), jnp.asarray(hlens, jnp.int32),
        jnp.asarray(enc), 0.3, method=model.forward_attention_decoder)
    _close(dec, jdec)
    _close(r_dec, jr_dec)


def test_gate_rule_is_false_for_a_symbolic_length():
    """The gate's length rule (apart from its device check, which alone
    is False on the CPU): True eagerly at (4, 20, 600, 600), False where
    torch.export traces the lengths as symbols, so no guard is put on
    them and the exported program is the plain path."""
    from wenet_tpu_torch.models.transformer.attention import flash_gate

    class Gate(torch.nn.Module):
        def forward(self, q, k):
            open_ = flash_gate(q.shape[0], q.shape[1], q.shape[2], k.shape[2])
            return q.sum() + (1.0 if open_ else 0.0)

    q = torch.zeros(4, 20, 600, 2)
    assert flash_gate(4, 20, 600, 600) and Gate()(q, q).item() == 1.0
    t = torch.export.Dim('t', min=1, max=4096)
    with torch.no_grad():
        program = torch.export.export(Gate(), (q, q), dynamic_shapes={
            'q': {2: t}, 'k': {2: t}})
    q = torch.zeros(4, 20, 900, 2)
    assert program.module()(q, q).item() == 0.0
