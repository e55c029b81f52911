"""The train slice of the PyTorch port against the JAX package, at the tiny
width of tests/torch_port_utils.py (d=64, 2 heads, 2+2+2 blocks).

Same weights (converted with `state_dict_from_jax`), same numpy batches.
With every dropout at 0 the loss dict agrees within rtol 1e-5 and every
gradient within 2e-4 (the torch-import bar), dynamic chunk off and on
(the port gets the chunk size the JAX draw made).  The optimizer, fed the
same gradients, tracks optax within 1e-6.  Random streams differ between
the packages, so the chunk draw and the dropout sites are held to their
statistics and their count.  The port runs on the CPU, so rel-pos
attention takes the plain versions of its kernels."""

import copy

import numpy as np
import pytest
import torch

from torch_port_utils import (TINY_CONFIG, feats, jax_model, tiny_config,
                              torch_model)

GRAD_ATOL = 2e-4


def no_dropout(**encoder_overrides):
    cfg = tiny_config(dropout_rate=0.0, positional_dropout_rate=0.0,
                      attention_dropout_rate=0.0, **encoder_overrides)
    for k in ('dropout_rate', 'positional_dropout_rate',
              'self_attention_dropout_rate', 'src_attention_dropout_rate'):
        cfg['decoder_conf'][k] = 0.0
    return cfg


def batch(seed=0, B=3, T=67, edge_rows=False):
    """feats + IGNORE_ID-padded labels in [3, VOCAB).  edge_rows: row 1
    gets a label CTC cannot align (too long, all repeats) and row 2 is a
    zero-length dummy (feats_lengths 0, no label)."""
    x, lens = feats(seed, B, T)
    rng = np.random.RandomState(seed + 100)
    L = 9
    tl = rng.randint(2, L + 1, size=B)
    tl[0] = L
    tgt = np.full((B, L), -1, np.int64)
    for i, n in enumerate(tl):
        tgt[i, :n] = rng.randint(3, 30, size=n)
    if edge_rows:
        lens[1] = 27  # 5 frames after subsampling: 9 repeats cannot fit
        tgt[1, :] = 7
        tl[1] = L
        lens[2], tl[2] = 0, 0
        tgt[2, :] = -1
    return dict(feats=x, feats_lengths=lens.astype(np.int64), target=tgt,
                target_lengths=tl.astype(np.int64))


def _torch_batch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _jax_chunk(chunk_rng, max_len):
    """The chunk size JAX's add_optional_chunk_mask draws from chunk_rng
    (wenet_tpu/utils/mask.py, use_dynamic_left_chunk False)."""
    import jax
    r1, _ = jax.random.split(chunk_rng)
    draw = int(jax.random.randint(r1, (), 1, max(max_len, 2)))
    return (max_len if draw > max_len // 2 else draw % 25 + 1), -1


@pytest.fixture(scope='module')
def pair():
    """A dynamic-chunk model without dropout in both packages; without a
    chunk draw (no chunk_rng / generator) both run it at full context."""
    cfg = no_dropout(use_dynamic_chunk=True)
    model, variables = jax_model(cfg, seed=21)
    return cfg, model, variables


@pytest.mark.parametrize('case', ['full', 'dynamic_chunk', 'edge_rows'])
def test_loss_and_grads_match_jax(pair, case):
    import jax
    import jax.numpy as jnp
    from wenet_tpu_torch.utils.checkpoint import state_dict_from_jax
    cfg, model, variables = pair
    tmodel = torch_model(cfg, variables).train()
    b = batch(seed=22, edge_rows=case == 'edge_rows')
    chunk_rng = (jax.random.PRNGKey(23) if case == 'dynamic_chunk'
                 else None)

    def loss_fn(params):
        out = model.apply({**variables, 'params': params},
                          *(jnp.asarray(b[k]) for k in (
                              'feats', 'feats_lengths', 'target',
                              'target_lengths')),
                          train=True, chunk_rng=chunk_rng)
        return out['loss'], out

    (_, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables['params'])
    max_len = ((b['feats'].shape[1] - 1) // 2 - 1) // 2
    chunk = (_jax_chunk(chunk_rng, max_len) if case == 'dynamic_chunk'
             else None)
    tb = _torch_batch(b)
    got = tmodel(tb['feats'], tb['feats_lengths'], tb['target'],
                 tb['target_lengths'], dynamic_chunk=chunk)
    got['loss'].backward()
    for k in ('loss', 'loss_att', 'loss_ctc', 'th_accuracy'):
        np.testing.assert_allclose(got[k].item(), float(want[k]),
                                   rtol=1e-5, err_msg=k)
    want_grads = state_dict_from_jax({'params': grads})
    for name, p in tmodel.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        np.testing.assert_allclose(p.grad.numpy(),
                                   want_grads[name].numpy(),
                                   atol=GRAD_ATOL, err_msg=name)


def _graph_names(grad_fn, depth=8):
    """Names of the autograd nodes within `depth` edges of grad_fn."""
    names, frontier = set(), [grad_fn]
    for _ in range(depth):
        nxt = []
        for fn in frontier:
            if fn is not None:
                names.add(type(fn).__name__)
                nxt += [f for f, _ in fn.next_functions]
        frontier = nxt
    return names


def test_every_parameter_gets_a_gradient():
    """With the yaml's dropouts and dynamic chunk on, one train step gives
    every parameter a finite gradient, and each rel-pos attention records
    its autograd Function (the CPU path of what runs on the card)."""
    from wenet_tpu_torch.utils.init_model import init_model
    from wenet_tpu_torch.utils.train_utils import (
        TrainState, init_optimizer_and_scheduler, make_train_step)
    model = init_model(copy.deepcopy(TINY_CONFIG),
                       torch.Generator().manual_seed(0), device='cpu')
    graphs = []
    for layer in model.encoder.encoders:
        layer.self_attn.register_forward_hook(
            lambda m, i, o: graphs.append(_graph_names(o[0].grad_fn)))
    opt, schedule = init_optimizer_and_scheduler(
        {'optim': 'adam', 'optim_conf': {'lr': 1e-3}}, model)
    step = make_train_step(model, opt, schedule, grad_clip=5.0)
    _, metrics = step(TrainState(model, opt), _torch_batch(batch(1)), (0, 0))
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        assert p.grad.abs().sum() > 0, name
    assert len(graphs) == len(model.encoder.encoders)
    assert all('RelPosAttentionBackward' in g for g in graphs)
    assert torch.isfinite(metrics['loss']) and metrics['grad_norm'] > 0


def _apply_optax(tx, grads, opt_state, params):
    import optax
    updates, opt_state = tx.update(grads, opt_state, params)
    return optax.apply_updates(params, updates), opt_state


@pytest.mark.parametrize('accum_grad', [1, 2])
def test_optimizer_matches_optax(pair, accum_grad):
    """Adam + clip 5 + warmuplr fed the same gradients: params within
    1e-6 of optax after three updates (Adam's first steps are about
    lr·sign(g), so a loss-level comparison would be noise-sensitive)."""
    import jax
    from wenet_tpu.utils.train_utils import (
        init_optimizer_and_scheduler as jax_init)
    from wenet_tpu_torch.utils.checkpoint import state_dict_from_jax
    from wenet_tpu_torch.utils.train_utils import (
        TrainState, apply_gradients, init_optimizer_and_scheduler)
    configs = {'optim': 'adam', 'optim_conf': {'lr': 0.002},
               'scheduler': 'warmuplr',
               'scheduler_conf': {'warmup_steps': 3}, 'grad_clip': 5,
               'accum_grad': accum_grad}
    cfg, _, variables = pair
    tmodel = torch_model(cfg, variables)
    tx, jschedule = jax_init(configs)
    params = variables['params']
    opt_state = tx.init(params)
    update = jax.jit(lambda g, st, p: _apply_optax(tx, g, st, p))
    opt, schedule = init_optimizer_and_scheduler(configs, tmodel)
    state = TrainState(tmodel, opt)
    rng = np.random.RandomState(32)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    named = dict(tmodel.named_parameters())
    for micro in range(3 * accum_grad):
        # global norms from about 1 to about 20: clipping on and off
        scale = [0.002, 0.04][micro % 2]
        g = jax.tree_util.tree_unflatten(treedef, [
            (scale * rng.randn(*np.shape(x))).astype(np.float32)
            for x in leaves])
        params, opt_state = update(g, opt_state, params)
        for name, t in state_dict_from_jax({'params': g}).items():
            named[name].grad = t.clone()
        _, lr = apply_gradients(state, schedule, configs['grad_clip'],
                                accum_grad)
        np.testing.assert_allclose(
            lr, float(jschedule(micro // accum_grad)), rtol=1e-6)
    assert state.step == 3 * accum_grad
    want = state_dict_from_jax({'params': params})
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-6, err_msg=name)


def test_warmup_schedule_matches_jax():
    from wenet_tpu.utils.scheduler import warmup_lr as jax_warmup
    from wenet_tpu_torch.utils.scheduler import build_schedule
    got = build_schedule('warmuplr', {'warmup_steps': 25000}, 0.001)
    want = jax_warmup(0.001, 25000)
    for step in (0, 1, 99, 24999, 25000, 10 ** 6):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)
    with pytest.raises(ValueError, match='unknown scheduler'):
        build_schedule('no_such_schedule', {}, 0.001)


def test_dynamic_chunk_draw_statistics():
    """Over 2000 draws at the flagship's T'=299: full context about half
    the time (draw > L//2 of U[1, L)), as the JAX draw gives, and the
    small chunks fill [1, 25]; with dynamic left chunks the count lies
    in [0, (L-1)//chunk)."""
    import jax
    from wenet_tpu_torch.utils.mask import draw_dynamic_chunk
    L, n = 299, 2000
    gen = torch.Generator().manual_seed(0)
    draws = [draw_dynamic_chunk(L, False, gen) for _ in range(n)]
    chunks = np.asarray([c for c, _ in draws])
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    jchunks = np.asarray([_jax_chunk(k, L)[0] for k in keys[:400]])
    full = np.mean(chunks == L)
    assert abs(full - 149 / 298) < 0.04
    assert abs(full - np.mean(jchunks == L)) < 0.1
    small = chunks[chunks != L]
    assert small.min() == 1 and small.max() == 25
    assert set(np.unique(small)) == set(range(1, 26))
    assert all(left == -1 for _, left in draws)
    for chunk, left in (draw_dynamic_chunk(L, True, gen) for _ in range(n)):
        assert (left == -1) == (chunk == L)
        assert chunk == L or 0 <= left < max((L - 1) // chunk, 1)


def test_dropout_sites_match_jax():
    """One train forward has as many active dropout sites in the port
    (nn.Dropout calls plus rel-pos attention calls, whose dropout runs in
    the kernel) as JAX Dropout calls with rate > 0."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    from wenet_tpu.ops.dropout import Dropout
    cfg = tiny_config()
    model, variables = jax_model(cfg, seed=41)
    tmodel = torch_model(cfg, variables).train()
    b = batch(seed=42)
    jax_sites = []

    def count(next_fun, args, kwargs, context):
        mod = context.module
        if isinstance(mod, Dropout) and context.method_name == '__call__':
            det = kwargs.get('deterministic', mod.deterministic)
            if mod.rate > 0 and not det:
                jax_sites.append(mod.rate)
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(count):  # counted while tracing
        jax.eval_shape(lambda: model.apply(
            variables, *(jnp.asarray(b[k]) for k in (
                'feats', 'feats_lengths', 'target', 'target_lengths')),
            train=True, chunk_rng=jax.random.PRNGKey(0),
            rngs={'dropout': jax.random.PRNGKey(1)}))
    from wenet_tpu_torch.models.transformer.attention import (
        RelPositionMultiHeadedAttention)
    port_sites = []

    def hook(mod, args, out):
        if isinstance(mod, torch.nn.Dropout) and mod.training and mod.p > 0:
            port_sites.append(mod.p)
        elif isinstance(mod, RelPositionMultiHeadedAttention) and \
                mod.training and mod.dropout.p > 0:
            port_sites.append(mod.dropout.p)

    for m in tmodel.modules():
        if isinstance(m, (torch.nn.Dropout, RelPositionMultiHeadedAttention)):
            m.register_forward_hook(hook)
    tb = _torch_batch(b)
    tmodel(tb['feats'], tb['feats_lengths'], tb['target'],
           tb['target_lengths'], generator=torch.Generator().manual_seed(0))
    assert len(jax_sites) == 44  # 2 + 7 per encoder block + 14 per decoder
    assert sorted(port_sites) == sorted(jax_sites)


def test_executor_trains_saves_and_resumes(tmp_path):
    """Executor.train on the CPU: empty batches are skipped, three steps
    run, the loss falls on a repeated batch, a step-interval checkpoint
    loads back strictly with the same weights, and the resumed step gives
    the same lr; the same seed reproduces the same metrics."""
    from wenet_tpu_torch.utils.checkpoint import load_checkpoint
    from wenet_tpu_torch.utils.executor import Executor
    from wenet_tpu_torch.utils.init_model import init_model
    from wenet_tpu_torch.utils.train_utils import (
        TrainState, init_optimizer_and_scheduler, make_cv_step,
        make_train_step, restore_optimizer_step)
    configs = {'optim': 'adam', 'optim_conf': {'lr': 0.002},
               'scheduler': 'warmuplr', 'scheduler_conf': {'warmup_steps': 2},
               'log_interval': 1, 'save_interval': 3, 'epoch': 0,
               'seed': 5}

    def run():
        model = init_model(copy.deepcopy(TINY_CONFIG),
                           torch.Generator().manual_seed(1), device='cpu')
        opt, schedule = init_optimizer_and_scheduler(configs, model)
        state = TrainState(model, opt)
        step = make_train_step(model, opt, schedule, grad_clip=5.0)
        losses = []

        def logged(st, b, rng):
            st, m = step(st, b, rng)
            losses.append(m['loss'].item())
            return st, m

        b = batch(seed=3)
        empty = {k: v[:0] for k, v in b.items()}
        ex = Executor(device='cpu')
        state = ex.train(logged, state, [b, empty, b, b], [b],
                         make_cv_step(model), None, configs,
                         model_dir=str(tmp_path))
        return model, schedule, state, ex, losses

    model, schedule, state, ex, losses = run()
    assert ex.step == 3 and state.step == 3
    assert losses[2] < losses[0]
    fresh = init_model(copy.deepcopy(TINY_CONFIG), device='cpu')
    infos = load_checkpoint(fresh, str(tmp_path / 'step_3.pt'))
    assert infos['step'] == 3 and np.isfinite(infos['cv_loss'])
    for (n, a), b in zip(model.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), n
    opt, _ = init_optimizer_and_scheduler(configs, fresh)
    resumed = restore_optimizer_step(TrainState(fresh, opt), infos['step'])
    assert schedule(resumed.step) == schedule(state.step)
    assert run()[4] == losses


@pytest.mark.cuda
def test_cuda_train_step_matches_cpu():
    """The tiny model's forward + backward on the card (K1-train, K2, K3,
    once per encoder block) against the CPU with every dropout at 0, then
    one train step with the dropouts on: every parameter gets a finite
    gradient on the card."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device to run the Hopper kernels')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from wenet_tpu_torch.ops import flash_attention as fa
    from wenet_tpu_torch.utils.init_model import init_model
    from wenet_tpu_torch.utils.train_utils import (
        TrainState, init_optimizer_and_scheduler, make_train_step)
    n_blocks = TINY_CONFIG['encoder_conf']['num_blocks']
    model = init_model(no_dropout(), torch.Generator().manual_seed(2),
                       device='cpu')
    cpu_model = copy.deepcopy(model)
    model.cuda()
    b = batch(seed=5)
    outs = []
    for m, dev in ((model, 'cuda'), (cpu_model, 'cpu')):
        m.train()
        tb = {k: v.to(dev) for k, v in _torch_batch(b).items()}
        fa.reset_launches()
        out = m(tb['feats'], tb['feats_lengths'], tb['target'],
                tb['target_lengths'],
                generator=torch.Generator().manual_seed(3))
        out['loss'].backward()
        outs.append(out)
        if dev == 'cuda':
            torch.cuda.synchronize()
            assert fa.LAUNCHES['relpos_attention_fwd_train'] == n_blocks
            assert fa.LAUNCHES['relpos_attention_bwd_dq'] == n_blocks
            assert fa.LAUNCHES['relpos_attention_bwd_dkpv'] == n_blocks
    np.testing.assert_allclose(outs[0]['loss'].item(),
                               outs[1]['loss'].item(), rtol=1e-4)
    cpu_params = dict(cpu_model.named_parameters())
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        torch.testing.assert_close(p.grad.cpu(), cpu_params[name].grad,
                                   atol=1e-3, rtol=0, msg=name)

    model = init_model(copy.deepcopy(TINY_CONFIG),
                       torch.Generator().manual_seed(4), device='cpu').cuda()
    opt, schedule = init_optimizer_and_scheduler(
        {'optim': 'adam', 'optim_conf': {'lr': 1e-3}}, model)
    step = make_train_step(model, opt, schedule, grad_clip=5.0)
    tb = {k: v.cuda() for k, v in _torch_batch(b).items()}
    _, metrics = step(TrainState(model, opt), tb, (0, 0))
    assert torch.isfinite(metrics['loss'])
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
