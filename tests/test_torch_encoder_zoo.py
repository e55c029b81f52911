"""The encoder zoo of the PyTorch port against the JAX package: the conv2d
transformer, the conv2d6 conformer, E-Branchformer, Branchformer (its
three merges), Squeezeformer and the efficient conformer, each at tiny
width (tests/torch_port_utils.py `ZOO_ENCODERS`) in a U2++ `asr_model`.

Same weights (`state_dict_from_jax`), same numpy inputs, every dropout at
0.  Encoder output and CTC log-probs agree within 2e-4; the training loss
dict within rtol 1e-5 and every gradient within 2e-4 (tests/
test_torch_train.py's GRAD_ATOL); the hypotheses of CTC greedy, CTC
prefix beam and attention rescoring are identical.  The JAX package's
`save_torch_checkpoint` (the reference layout) loads into the port with
`load_checkpoint`, strictly, to the same tensors.  The port runs on the
CPU: rel-pos attention takes the plain versions of its kernels, and the
grouped and Squeezeformer attentions are plain in both packages."""

import numpy as np
import pytest
import torch

from torch_port_utils import ZOO_ENCODERS, feats, jax_model, torch_model, \
    zoo_config

ATOL = 2e-4
GRAD_ATOL = 2e-4
MODES = ['ctc_greedy_search', 'ctc_prefix_beam_search',
         'attention_rescoring']
NAMES = sorted(ZOO_ENCODERS)
_MODELS = {}


def models(name):
    """(config, JAX model, its variables, the port's model), built once
    per encoder for the file."""
    if name not in _MODELS:
        cfg = zoo_config(name)
        model, variables = jax_model(cfg, seed=NAMES.index(name) + 40)
        _MODELS[name] = (cfg, model, variables, torch_model(cfg, variables))
    return _MODELS[name]


def batch(seed, B=3, T=71):
    """feats (the first row full, odd and even lengths) + labels."""
    x, lens = feats(seed, B, T)
    lens[-1] = T - 2  # 17 and 16 frames after x4 subsampling at T = 71
    rng = np.random.RandomState(seed + 100)
    tl = rng.randint(2, 8, size=B)
    tgt = np.full((B, 7), -1, np.int64)
    for i, n in enumerate(tl):
        tgt[i, :n] = rng.randint(3, 30, size=n)
    return x, lens, tgt, tl


@pytest.mark.parametrize('name', NAMES)
def test_forward_matches_jax(name):
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
    assert tuple(teo.shape) == jeo.shape
    np.testing.assert_array_equal(tem.numpy(), np.asarray(jem))
    np.testing.assert_allclose(teo.numpy(), np.asarray(jeo), atol=ATOL)
    np.testing.assert_allclose(tlogp.numpy(), np.asarray(jlogp), atol=ATOL)


@pytest.mark.parametrize('name', NAMES)
def test_loss_and_grads_match_jax(name):
    import jax
    import jax.numpy as jnp
    from wenet_tpu_torch.utils.checkpoint import state_dict_from_jax
    cfg, model, variables, _ = models(name)
    tmodel = torch_model(cfg, variables).train()
    x, lens, tgt, tl = batch(2)
    args = [jnp.asarray(a) for a in (x, lens, tgt, tl)]
    mutable = ['batch_stats'] if 'batch_stats' in variables else False

    def loss_fn(params):
        out = model.apply({**variables, 'params': params}, *args,
                          train=True, mutable=mutable,
                          rngs={'dropout': jax.random.PRNGKey(0)})
        out = out[0] if mutable else out
        return out['loss'], out

    (_, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables['params'])
    got = tmodel(*(torch.from_numpy(np.asarray(a)) for a in (x, lens, tgt,
                                                              tl)))
    got['loss'].backward()
    for k in ('loss', 'loss_att', 'loss_ctc', 'th_accuracy'):
        np.testing.assert_allclose(got[k].item(), float(want[k]),
                                   rtol=1e-5, err_msg=k)
    want_grads = state_dict_from_jax({'params': grads})
    for pname, p in tmodel.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), pname
        np.testing.assert_allclose(p.grad.numpy(),
                                   want_grads[pname].numpy(),
                                   atol=GRAD_ATOL, err_msg=pname)


@pytest.mark.parametrize('name', NAMES)
def test_decode_matches_jax(name):
    from wenet_tpu.models.runner import AsrRunner as JaxRunner
    from wenet_tpu_torch.models.runner import AsrRunner
    _, model, variables, tmodel = models(name)
    x, lens, _, _ = batch(3, B=4, T=91)
    kw = dict(beam_size=4, ctc_weight=0.3, reverse_weight=0.3)
    want = JaxRunner(model, variables).decode(MODES, x, lens, **kw)
    got = AsrRunner(tmodel, 'cpu').decode(MODES, x, lens, **kw)
    for mode in MODES:
        assert [r.tokens for r in got[mode]] == \
            [r.tokens for r in want[mode]], mode
    for g, w in zip(got['ctc_prefix_beam_search'],
                    want['ctc_prefix_beam_search']):
        assert g.nbest == w.nbest
    assert any(r.tokens for r in got['attention_rescoring'])


@pytest.mark.parametrize('name', NAMES)
def test_reference_checkpoint_loads_strictly(name, tmp_path):
    """The JAX package's export in the reference layout
    (`save_torch_checkpoint`, through `convert_to_torch_state_dict`)
    loads into a fresh port model with `load_checkpoint` (strict=True),
    every tensor equal to `state_dict_from_jax`'s."""
    from wenet_tpu.utils.checkpoint import save_torch_checkpoint
    from wenet_tpu_torch.utils.checkpoint import load_checkpoint
    from wenet_tpu_torch.utils.init_model import init_model
    cfg, _, variables, tmodel = models(name)
    path = str(tmp_path / 'final.pt')
    save_torch_checkpoint(variables, path)
    fresh = init_model(cfg, torch.Generator().manual_seed(1), device='cpu')
    load_checkpoint(fresh, path)
    want = tmodel.state_dict()
    for key, value in fresh.state_dict().items():
        torch.testing.assert_close(value, want[key], atol=0, rtol=0,
                                   msg=key)


# --- on the card ---------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device to run the Hopper kernels')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False  # the subsampling convs


@pytest.mark.cuda
@pytest.mark.parametrize('name', NAMES)
def test_cuda_forward_and_grads_match_cpu(cuda, name):
    """Each zoo encoder on the card (K1-K3 in its rel-pos layers) against
    the same model on the CPU: encoder output within 2e-4, the training
    loss within rtol 1e-5, gradients within 1e-3 (chip_smoke 6c's bar)."""
    import copy
    from wenet_tpu_torch.utils.init_model import init_model
    cpu = init_model(zoo_config(name), torch.Generator().manual_seed(0),
                     device='cpu')
    gpu = copy.deepcopy(cpu).cuda()
    x, lens, tgt, tl = (torch.from_numpy(np.asarray(a)) for a in batch(4))
    with torch.no_grad():
        want, _ = cpu.eval().forward_encoder(x, lens)
        got, _ = gpu.eval().forward_encoder(x.cuda(), lens.cuda())
    torch.testing.assert_close(got.cpu(), want, atol=ATOL, rtol=0)
    outs = []
    for model, dev in ((cpu, 'cpu'), (gpu, 'cuda')):
        out = model.train()(*(a.to(dev) for a in (x, lens, tgt, tl)))
        out['loss'].backward()
        outs.append(out['loss'].item())
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5)
    want_grads = dict(cpu.named_parameters())
    for pname, p in gpu.named_parameters():
        torch.testing.assert_close(p.grad.cpu(), want_grads[pname].grad,
                                   atol=1e-3, rtol=0, msg=pname)
