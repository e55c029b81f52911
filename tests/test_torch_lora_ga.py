"""LoRA-GA in the port (models/finetune/lora.py `estimate_gradient`,
`reinit_lora`) against the JAX package, on the configuration of
tests/test_lora_ctl.py::test_lora_ga_reinit (a one-block transformer
with LoRA on q and v, rank 4), its weights carried by
`state_dict_from_jax`, on the CPU.

- `estimate_gradient` over two batches equals the JAX one within 1e-5
  of the gradient's largest element.
- `reinit_lora('gradient')` on the same gradient: A's rows and B's
  columns equal the JAX ones up to each singular vector's sign (the
  solvers choose signs freely), or, where two of the top 2r singular
  values lie within 1e-3 relative, span the same subspace (projectors
  within 1e-4); the compensated weight equals the JAX kernel with the
  signs lined up; the loss is unchanged by the reinit (rtol 1e-4).
- `reinit_lora('gaussian')`: B zero, every A inside flax's kaiming
  bound sqrt(6 / r) and spread over it as a uniform draw is."""

import copy

import numpy as np
import pytest
import torch

CONFIG = {
    'input_dim': 80, 'output_dim': 12,
    'encoder': 'transformer',
    'encoder_conf': {'output_size': 32, 'attention_heads': 2,
                     'linear_units': 64, 'num_blocks': 1},
    'decoder': 'transformer',
    'decoder_conf': {'attention_heads': 2, 'linear_units': 64,
                     'num_blocks': 1},
    'model_conf': {'ctc_weight': 0.3},
    'lora_conf': {'use_lora': True, 'lora_rank': 4, 'lora_alpha': 4,
                  'lora_list': ['q', 'v']},
}
RANK = 4
GAP = 1e-3  # singular values closer than this (relative) span a subspace


def _batches():
    out = []
    for seed, lens in ((0, [32, 28]), (1, [30, 25])):
        rng = np.random.RandomState(seed)
        out.append({
            'feats': rng.randn(2, 32, 80).astype(np.float32),
            'feats_lengths': np.asarray(lens, np.int64),
            'target': np.asarray([[2, 3, 4, -1], [5, 6, -1, -1]], np.int64),
            'target_lengths': np.asarray([3, 2], np.int64)})
    return out


def _torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture(scope='module')
def pair():
    """(JAX model, variables, the JAX mean gradient, the port's model and
    its mean gradient)."""
    import jax
    import jax.numpy as jnp
    from wenet_tpu.models.finetune.lora import estimate_gradient as jax_est
    from wenet_tpu.utils.init_model import init_model as jax_init
    from wenet_tpu.utils.init_model import init_variables
    from wenet_tpu_torch.models.finetune.lora import estimate_gradient
    from wenet_tpu_torch.utils.checkpoint import state_dict_from_jax
    from wenet_tpu_torch.utils.init_model import init_model
    jmodel, configs = jax_init(None, copy.deepcopy(CONFIG))
    variables, _ = init_variables(jmodel, configs,
                                  rng=jax.random.PRNGKey(7))
    batches = _batches()
    jgrads = jax_est(jmodel, variables,
                     [{k: jnp.asarray(v) for k, v in b.items()}
                      for b in batches])
    model = init_model(copy.deepcopy(CONFIG), device='cpu')
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    model.train()
    grads = estimate_gradient(model, [_torch(b) for b in batches])
    return jmodel, variables, jgrads, model, grads


def test_estimate_gradient_matches_jax(pair):
    from wenet_tpu_torch.utils.checkpoint import state_dict_from_jax
    _, _, jgrads, model, grads = pair
    want = state_dict_from_jax({'params': jgrads})
    assert set(grads) == set(want)
    # relative to the gradient's largest element: a key bias's gradient
    # is zero but for rounding (softmax ignores a shift of every score)
    scale = max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(grads[k].numpy(), w.numpy(),
                                   atol=1e-5 * scale, rtol=0, err_msg=k)
    # the probe left the model as it found it
    assert model.training
    assert all(p.grad is None for p in model.parameters())


def _lora_layers(model):
    from wenet_tpu_torch.models.finetune.lora import LoRALinear
    return {n: m for n, m in model.named_modules()
            if isinstance(m, LoRALinear)}


def _jax_layer(params, name):
    """The JAX params dict of the port's module `name`."""
    from wenet_tpu_torch.utils.checkpoint import state_dict_from_jax
    flat = state_dict_from_jax({'params': params})
    return {k[len(name) + 1:]: v for k, v in flat.items()
            if k.startswith(name + '.')}


def _loss(model, b):
    model.eval()
    with torch.no_grad():
        out = model(*(torch.from_numpy(b[k]) for k in (
            'feats', 'feats_lengths', 'target', 'target_lengths')))
    return out['loss'].item()


def test_gradient_reinit_matches_jax_up_to_sign(pair):
    from wenet_tpu.models.finetune.lora import reinit_lora as jax_reinit
    from wenet_tpu_torch.models.finetune.lora import reinit_lora
    from wenet_tpu_torch.utils.checkpoint import state_dict_from_jax
    _, variables, jgrads, model, _ = pair
    model = copy.deepcopy(model)
    b = _batches()[0]
    before = _loss(model, b)
    # both on the JAX gradient: only the solvers differ
    reinit_lora(model, state_dict_from_jax({'params': jgrads}), 'gradient',
                stable_gamma=16.0)
    jparams = jax_reinit(variables['params'], jgrads, init_type='gradient',
                         stable_gamma=16.0, alpha=CONFIG['lora_conf'][
                             'lora_alpha'])
    layers = _lora_layers(model)
    assert len(layers) == 2  # q and v of the encoder layer (lora_decoder off)
    smallest_gap = np.inf
    for name, m in layers.items():
        want = _jax_layer(jparams, name)
        G = state_dict_from_jax({'params': jgrads})[name + '.weight']
        s = np.linalg.svd(G.double().numpy(), compute_uv=False)[:2 * RANK]
        gaps = np.abs(np.diff(s)) / s[1:].clip(min=1e-30)
        smallest_gap = min(smallest_gap, gaps.min())
        A, B = m.lora_A.detach().numpy(), m.lora_B.detach().numpy()
        jA, jB = want['lora_A'].numpy(), want['lora_B'].numpy()
        assert np.abs(B).max() > 0
        if gaps.min() < GAP:  # hold the spanned subspaces
            for got, ref in ((A.T, jA.T), (B, jB)):
                np.testing.assert_allclose(got @ got.T, ref @ ref.T,
                                           atol=1e-4, err_msg=name)
            continue
        sa = np.sign(np.sum(A * jA, axis=1))[:, None]
        sb = np.sign(np.sum(B * jB, axis=0))[None, :]
        np.testing.assert_allclose(A * sa, jA, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(B * sb, jB, atol=1e-5, err_msg=name)
        # the compensated weight, the port's signs lined up with the JAX
        w0 = m.weight.detach().numpy() + m.scaling * (B @ A)
        aligned = w0 - m.scaling * ((B * sb) @ (A * sa))
        np.testing.assert_allclose(aligned, want['weight'].numpy(),
                                   atol=1e-6, err_msg=name)
    print(f'smallest relative gap of the top {2 * RANK} singular values: '
          f'{smallest_gap:.3e}')
    np.testing.assert_allclose(_loss(model, b), before, rtol=1e-4)


def test_gaussian_reinit(pair):
    from wenet_tpu_torch.models.finetune.lora import reinit_lora
    model = copy.deepcopy(pair[3])
    b = _batches()[0]
    before = _loss(model, b)
    reinit_lora(model, init_type='gaussian',
                generator=torch.Generator().manual_seed(0))
    bound = np.sqrt(6.0 / RANK)
    a = []
    for m in _lora_layers(model).values():
        assert torch.count_nonzero(m.lora_B) == 0
        a.append(m.lora_A.detach().numpy().ravel())
    a = np.concatenate(a)
    assert np.abs(a).max() <= bound
    assert np.abs(a).max() > 0.95 * bound
    # U(-bound, bound): standard deviation bound / sqrt(3)
    np.testing.assert_allclose(a.std(), bound / np.sqrt(3), rtol=0.1)
    np.testing.assert_allclose(_loss(model, b), before, rtol=1e-6)
    with pytest.raises(ValueError, match='estimate_gradient'):
        reinit_lora(model, {}, 'gradient')
