"""`gradient_checkpointing` in the port (models/transformer/recompute.py,
the encoders' layer loop, the decoders' and `attention_core`'s
'selective' path) against the step without it and against the JAX
package, at the tiny width of tests/torch_port_utils.py, on the CPU.

Two models: the conformer with its conv module's BatchNorm (the
`train_conformer.yaml` norm, whose running statistics a recompute would
update twice) and the transformer (plain attention, where 'selective'
keeps no (T1, T2) tensor), each with the bidirectional decoder, which
recomputes its layers too.  With the dropouts on (the rel-pos
attention's hash dropout seeded from the host generator, nn.Dropout
from torch's default one) a step with `gradient_checkpointing` true or
'selective' gives the loss, every gradient and the BatchNorm buffers of
the step without it bit for bit, and leaves the host generator where
that step does.  With the dropouts off it matches the JAX package's
loss (rtol 1e-5), gradients (2e-4) and batch_stats (1e-5)."""

import copy

import numpy as np
import pytest
import torch

from torch_port_utils import TINY_CONFIG, ZOO_ENCODERS, feats, jax_model

GRAD_ATOL = 2e-4
MODES = [True, 'selective']


def _config(kind, dropout):
    cfg = copy.deepcopy(TINY_CONFIG)
    if kind == 'transformer':
        cfg['encoder'], enc = ZOO_ENCODERS['transformer']
        cfg['encoder_conf'] = dict(enc, attention_dropout_rate=0.1,
                                   dropout_rate=0.1,
                                   positional_dropout_rate=0.1)
    else:
        cfg['encoder_conf'].update(cnn_module_norm='batch_norm')
    if not dropout:
        cfg['encoder_conf']['use_dynamic_chunk'] = False
        for conf in (cfg['encoder_conf'], cfg['decoder_conf']):
            for k in conf:
                if k.endswith('dropout_rate'):
                    conf[k] = 0.0
    return cfg


def _with_mode(cfg, mode):
    cfg = copy.deepcopy(cfg)
    cfg['encoder_conf']['gradient_checkpointing'] = mode
    cfg['decoder_conf']['gradient_checkpointing'] = bool(mode)
    return cfg


def _batch(seed=3):
    x, lens = feats(seed, B=3, T=67)
    rng = np.random.RandomState(seed + 1)
    tl = np.asarray([7, 5, 3])
    tgt = np.full((3, 7), -1, np.int64)
    for i, n in enumerate(tl):
        tgt[i, :n] = rng.randint(3, 30, size=n)
    return dict(feats=x, feats_lengths=lens.astype(np.int64), target=tgt,
                target_lengths=tl)


@pytest.fixture(scope='module')
def models():
    """kind -> (config with dropouts, config without, JAX model and
    variables of the config without dropouts)."""
    out = {}
    for kind in ('conformer_bn', 'transformer'):
        cfg = _config(kind, dropout=False)
        out[kind] = (_config(kind, dropout=True), cfg, jax_model(cfg, 41))
    return out


def _port(cfg, variables):
    from wenet_tpu_torch.utils.checkpoint import state_dict_from_jax
    from wenet_tpu_torch.utils.init_model import init_model
    model = init_model(copy.deepcopy(cfg), device='cpu')
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model.train()


def _step(model, b, seeds=(5, 6)):
    """One forward and backward: torch's default generator seeded with
    seeds[0], the host generator with seeds[1] -> (loss dict, grads,
    buffers, the host generator's state after the step)."""
    torch.manual_seed(seeds[0])
    gen = torch.Generator().manual_seed(seeds[1])
    model.zero_grad(set_to_none=True)
    out = model(*(torch.from_numpy(np.asarray(b[k])) for k in (
        'feats', 'feats_lengths', 'target', 'target_lengths')),
        generator=gen)
    out['loss'].backward()
    return ({k: v.detach() for k, v in out.items() if v is not None},
            {n: p.grad.clone() for n, p in model.named_parameters()},
            {n: t.clone() for n, t in model.named_buffers()},
            gen.get_state())


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('kind', ['conformer_bn', 'transformer'])
def test_step_equals_the_step_without_recompute(models, kind, mode):
    cfg, _, (_, variables) = models[kind]
    b = _batch()
    want = _step(_port(cfg, variables), b)
    model = _port(_with_mode(cfg, mode), variables)
    got = _step(model, b)
    for k, v in want[0].items():
        assert torch.equal(got[0][k], v), k
    for part in (1, 2):
        assert set(got[part]) == set(want[part])
        for k, v in want[part].items():
            assert torch.equal(got[part][k], v), k
    assert torch.equal(got[3], want[3])  # the host generator's position
    if kind == 'conformer_bn':
        assert any(k.endswith('running_mean') for k in got[2])


@pytest.mark.parametrize('mode', [False, True, 'selective'])
@pytest.mark.parametrize('kind', ['conformer_bn', 'transformer'])
def test_step_matches_jax(models, kind, mode):
    import jax
    import jax.numpy as jnp
    from wenet_tpu_torch.utils.checkpoint import state_dict_from_jax
    _, cfg, (jmodel, variables) = models[kind]
    b = _batch()
    args = [jnp.asarray(b[k]) for k in ('feats', 'feats_lengths', 'target',
                                        'target_lengths')]

    def loss_fn(params):
        v = {**variables, 'params': params}
        if 'batch_stats' in variables:
            out, new = jmodel.apply(v, *args, train=True,
                                    mutable=['batch_stats'])
            return out['loss'], (out, new['batch_stats'])
        out = jmodel.apply(v, *args, train=True)
        return out['loss'], (out, None)

    (_, (want, stats)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables['params'])
    got, got_grads, buffers, _ = _step(_port(_with_mode(cfg, mode),
                                             variables), b)
    for k in ('loss', 'loss_att', 'loss_ctc', 'th_accuracy'):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    want_grads = state_dict_from_jax({'params': grads})
    assert set(got_grads) == set(want_grads)
    for k, g in want_grads.items():
        np.testing.assert_allclose(got_grads[k].numpy(), g.numpy(),
                                   atol=GRAD_ATOL, err_msg=k)
    if stats is not None:
        want_stats = state_dict_from_jax({'params': variables['params'],
                                          'batch_stats': stats})
        keys = [k for k in buffers if k.endswith(('running_mean',
                                                  'running_var'))]
        assert keys
        for k in keys:
            np.testing.assert_allclose(buffers[k].numpy(),
                                       want_stats[k].numpy(), atol=1e-5,
                                       err_msg=k)


def _saved_shapes(model, b):
    """The shapes of every tensor autograd saves in a training forward."""
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        torch.manual_seed(0)
        model(*(torch.from_numpy(np.asarray(b[k])) for k in (
            'feats', 'feats_lengths', 'target', 'target_lengths')),
            generator=torch.Generator().manual_seed(0))
    return shapes


@pytest.mark.parametrize('mode', [True, 'selective'])
def test_what_the_transformer_keeps_for_the_backward(models, mode):
    """Without recompute the encoder's plain attention keeps (B, h, T', T')
    weights; with true or 'selective' no such tensor is kept, and fewer
    elements in all."""
    cfg, _, (_, variables) = models['transformer']
    b = _batch()
    T = ((b['feats'].shape[1] - 1) // 2 - 1) // 2
    counts = {}
    for m in (False, mode):
        shapes = _saved_shapes(_port(_with_mode(cfg, m), variables), b)
        square = [s for s in shapes if len(s) == 4 and s[-2:] == (T, T)]
        counts[m] = (len(square), sum(int(np.prod(s)) for s in shapes))
    assert counts[False][0] > 0
    assert counts[mode][0] == 0
    assert counts[mode][1] < counts[False][1]


@pytest.mark.parametrize('encoder', ['branchformer', 'e_branchformer',
                                     'squeezeformer', 'efficientConformer'])
def test_encoders_that_never_recompute_refuse_it(encoder):
    """The JAX package recomputes only its transformer and conformer
    layers (and the transformer decoders'): the other encoders refuse
    `gradient_checkpointing: true` with the reason, and take false."""
    from wenet_tpu_torch.utils.init_model import init_model
    name = {'efficientConformer': 'efficient_conformer',
            'branchformer': 'branchformer_concat'}.get(encoder, encoder)
    kind, conf = ZOO_ENCODERS[name]
    assert kind == encoder
    cfg = copy.deepcopy(TINY_CONFIG)
    cfg['encoder'] = encoder
    cfg['encoder_conf'] = dict(conf, gradient_checkpointing=True)
    with pytest.raises(NotImplementedError, match='never reads it|no such'):
        init_model(copy.deepcopy(cfg), device='meta')
    cfg['encoder_conf']['gradient_checkpointing'] = False
    init_model(cfg, device='meta')
