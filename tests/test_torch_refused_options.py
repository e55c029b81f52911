"""The options of the JAX encoders and decoders that the PyTorch port
refused until now, against the JAX package at tiny width: the conformer
without its macaron FFN (with relu), without its conv module, with
bias-free convs four times as wide inside; the decoders post-norm
without cross attention, without an output layer, and with the `no_pos`
input layer; Branchformer with `static_chunk_size`, RMSNorm, no q/k/v or
MLP biases and `cmvn_norm_var: false`, and post-norm; E-Branchformer
with gated bias-free FFNs and no final norm; Squeezeformer pre-norm with
static chunks; the efficient conformer post-norm with static chunks, and
without positions or conv modules in its plain layers (with relu).

Same weights (`state_dict_from_jax`, and the reference layout the JAX
package writes, loaded strict), same numpy inputs, every dropout 0.
Bars: encoder output and CTC log-probs within 2e-4 (the torch-import
bar); the losses within rtol 1e-4 and every gradient within 12c's bar
(1e-3 + 2e-4 of the tensor's largest); hypotheses of attention
of every decode mode identical; streaming equal to
the full forward under the chunk mask within 1e-4 where the encoder
streams so, else to the JAX package's chunk loop within 2e-4; the
exported programs equal eager within 1e-5."""

import copy

import numpy as np
import pytest
import torch

from torch_port_utils import (TINY_CONFIG, VOCAB, feats, jax_model,
                              torch_model, zoo_config)

ATOL = 2e-4
DECODERS = ['decoder_no_output_layer', 'decoder_post_norm_no_src']
FULL_ATOL = 1e-4
GRAD_SHARE = 2e-4  # 12c's bar: 1e-3 + this share of the largest gradient
# name: (ZOO_ENCODERS entry or None for the tiny conformer, encoder_conf
# and decoder_conf overrides, how it streams: 'full' equal to the full
# forward under the chunk mask, 'jax' equal to the JAX chunk loop, None
# for a decoder option, whose encoder is the tiny conformer)
FAMILIES = {
    'conformer_no_macaron_relu': (
        None, dict(macaron_style=False, activation_type='relu'), {}, 'full'),
    'conformer_no_cnn_module': (None, dict(use_cnn_module=False), {},
                                'full'),
    'conformer_conv_bias_inner': (
        None, dict(conv_bias=False, conv_inner_factor=4,
                   cnn_module_norm='batch_norm'), {}, 'full'),
    'decoder_post_norm_no_src': (
        None, {}, dict(normalize_before=False, src_attention=False), None),
    'decoder_no_output_layer': (None, {}, dict(use_output_layer=False),
                                None),
    'branchformer_base_options': (
        'branchformer_concat', dict(causal=True, static_chunk_size=4,
                                    layer_norm_type='rms_norm',
                                    cmvn_norm_var=False, query_bias=False,
                                    key_bias=False, mlp_bias=False), {},
        'full'),
    'branchformer_post_norm': (
        'branchformer_fixed_ave', dict(causal=True, use_dynamic_chunk=True,
                                       normalize_before=False), {}, 'full'),
    'e_branchformer_gated_mlp': (
        'e_branchformer', dict(mlp_type='gated', mlp_bias=False,
                               final_norm=False, causal=True,
                               use_dynamic_chunk=True, merge_conv_kernel=1),
        {}, 'full'),
    'squeezeformer_pre_norm_static': (
        'squeezeformer', dict(normalize_before=True, static_chunk_size=4,
                              cmvn_norm_var=False, causal=True,
                              cnn_norm_type='batch_norm'), {}, 'jax'),
    'efficient_post_norm_static': (
        'efficient_conformer', dict(normalize_before=False,
                                    static_chunk_size=4,
                                    use_dynamic_chunk=False), {}, 'jax'),
    # relu also in the grouped layers' conv modules
    'efficient_no_pos_no_cnn': (
        'efficient_conformer', dict(pos_enc_layer_type='no_pos',
                                    use_cnn_module=False,
                                    activation_type='relu'), {}, 'jax'),
}
_MODELS = {}


def family_config(name):
    entry, enc, dec, _ = FAMILIES[name]
    cfg = copy.deepcopy(TINY_CONFIG) if entry is None else zoo_config(entry)
    cfg['encoder_conf'].update(enc)
    cfg['decoder_conf'].update(dec)
    for conf in (cfg['encoder_conf'], cfg['decoder_conf']):
        for k in conf:
            if k.endswith('dropout_rate') or k == 'dropout':
                conf[k] = 0.0
    return cfg


def models(name):
    if name not in _MODELS:
        cfg = family_config(name)
        model, variables = jax_model(cfg, seed=len(_MODELS) + 90)
        _MODELS[name] = (cfg, model, variables, torch_model(cfg, variables))
    return _MODELS[name]


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


def batch(seed, B=3, T=71):
    x, lens = feats(seed, B, T)
    rng = np.random.RandomState(seed + 100)
    tl = rng.randint(2, 8, size=B)
    tgt = np.full((B, 7), -1, np.int64)
    for i, n in enumerate(tl):
        tgt[i, :n] = rng.randint(3, VOCAB, size=n)
    return x, lens, tgt, tl


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_modules_match_jax(name):
    """The encoder and the CTC head within 2e-4 of the JAX package's; the
    layers have what the JAX layers have (the strict load)."""
    import jax.numpy as jnp
    _, model, variables, tmodel = models(name)
    x, lens, _, _ = batch(1)
    jeo, jem = model.apply(variables, jnp.asarray(x), jnp.asarray(lens),
                           method=model.forward_encoder)
    jlogp = model.apply(variables, jeo, method=model.ctc_logprobs)
    with torch.no_grad():
        teo, tem = tmodel.forward_encoder(torch.from_numpy(x),
                                          torch.from_numpy(lens))
        tlogp = tmodel.ctc_logprobs(teo)
    np.testing.assert_array_equal(tem.numpy(), np.asarray(jem))
    _close(teo, jeo)
    _close(tlogp, jlogp)


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_loss_and_grads_match_jax(name):
    import jax
    import jax.numpy as jnp
    from wenet_tpu_torch.utils.checkpoint import state_dict_from_jax
    cfg, model, variables, _ = models(name)
    tmodel = torch_model(cfg, variables).train()
    x, lens, tgt, tl = batch(2)

    def loss_fn(params):
        out = model.apply({**variables, 'params': params},
                          *(jnp.asarray(a) for a in (x, lens, tgt, tl)),
                          train=True, rngs={'dropout': jax.random.PRNGKey(0)},
                          mutable=['batch_stats'])[0]
        return out['loss'], out

    (_, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables['params'])
    got = tmodel(*(torch.from_numpy(np.asarray(a)) for a in (x, lens, tgt,
                                                              tl)))
    got['loss'].backward()
    for k in ('loss', 'loss_att', 'loss_ctc'):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4,
                                   err_msg=k)
    want_grads = state_dict_from_jax({'params': grads})
    assert set(want_grads) == {n for n, _ in tmodel.named_parameters()}
    for pname, p in tmodel.named_parameters():
        w = want_grads[pname].numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), w, rtol=0, err_msg=pname,
            atol=1e-3 + GRAD_SHARE * float(np.abs(w).max()))


# --- on the card ---------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device to run the Hopper kernels')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['conformer_no_cnn_module',
                                  'conformer_conv_bias_inner',
                                  'branchformer_base_options',
                                  'efficient_post_norm_static'])
def test_cuda_step_matches_cpu(cuda, name):
    """A train step on the card (K1-train, K2, K3 once per rel-pos block)
    against the CPU: the loss within rtol 1e-4, every gradient within
    12c's bar."""
    from wenet_tpu_torch.ops.flash_attention import LAUNCHES
    from wenet_tpu_torch.utils.init_model import init_model
    cfg = family_config(name)
    cpu = init_model(cfg, torch.Generator().manual_seed(0), device='cpu')
    card = copy.deepcopy(cpu).cuda()
    x, lens, tgt, tl = (torch.from_numpy(np.asarray(a)) for a in batch(7))
    want = cpu.train()(x, lens, tgt, tl)
    want['loss'].backward()
    before = LAUNCHES['relpos_attention_bwd_dq']
    got = card.train()(*(a.cuda() for a in (x, lens, tgt, tl)))
    got['loss'].backward()
    torch.cuda.synchronize()
    assert LAUNCHES['relpos_attention_bwd_dq'] > before
    np.testing.assert_allclose(got['loss'].item(), want['loss'].item(),
                               rtol=1e-4)
    cpu_grads = dict(cpu.named_parameters())
    for pname, p in card.named_parameters():
        w = cpu_grads[pname].grad
        np.testing.assert_allclose(
            p.grad.cpu().numpy(), w.numpy(), rtol=0, err_msg=pname,
            atol=1e-3 + GRAD_SHARE * float(w.abs().max()))
