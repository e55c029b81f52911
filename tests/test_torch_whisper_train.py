"""The whisper LoRA train slice of the PyTorch port against the JAX
package, on tiny whisper (tests/torch_port_utils.py `WHISPER_DIMS`) with
LoRA on the encoder's and the decoder's attention projections.

Same weights (converted with `state_dict_from_jax`; lora_B redrawn
nonzero, or the LoRA term would be invisible), same numpy batches, every
dropout 0 as in the finetune yaml.  The loss dict agrees within rtol 1e-5
and every gradient, lora_A and lora_B included, within 2e-4; the prompt
building is exact; AdamW + clip, fed the same gradients, tracks optax
within 1e-6.  LoRA's trainability flags and `merge_lora` are held to the
JAX package's mask and merge.  The port runs on the CPU, so attention
takes the plain path."""

import copy

import numpy as np
import pytest
import torch

from torch_port_utils import (WHISPER_TOKENS, jax_model, torch_model,
                              whisper_config, whisper_feats)

GRAD_ATOL = 2e-4
LORA = {'use_lora': True, 'lora_rank': 4, 'lora_alpha': 8,
        'lora_dropout': 0.0, 'lora_list': ['o', 'q', 'k', 'v'],
        'lora_decoder': True}


def lora_whisper_config():
    """Tiny whisper, every dropout 0 (as the finetune yaml), LoRA rank 4
    with alpha 8 (a scaling of 2) on encoder and decoder."""
    cfg = whisper_config()
    for conf in (cfg['encoder_conf'], cfg['decoder_conf']):
        for key in conf:
            if key.endswith('dropout_rate'):
                conf[key] = 0.0
    cfg['lora_conf'] = dict(LORA)
    return cfg


@pytest.fixture(scope='module')
def trio():
    """(config, JAX model, JAX variables with lora_B drawn N(0, 0.05):
    the LoRA term is visible, and the gradients stay well conditioned in
    fp32, where N(0, 0.3) puts both packages 1e-3 from float64)."""
    import jax
    cfg = lora_whisper_config()
    model, variables = jax_model(cfg, seed=11)
    rng = np.random.RandomState(12)

    def redraw(path, leaf):
        if path[-1].key == 'lora_B':
            return (0.05 * rng.randn(*np.shape(leaf))).astype(np.float32)
        return leaf
    variables = jax.tree_util.tree_map_with_path(redraw, variables)
    return cfg, model, variables


def batch(seed=0, B=3, T=63, L=9):
    """Features with ragged lengths and IGNORE_ID-padded text tokens
    (< 100, below the special tokens) of ragged lengths."""
    x, lens = whisper_feats(seed, B, T)
    rng = np.random.RandomState(seed + 100)
    tl = rng.randint(2, L + 1, size=B)
    tl[0] = L
    tgt = np.full((B, L), -1, np.int64)
    for i, n in enumerate(tl):
        tgt[i, :n] = rng.randint(0, 100, size=n)
    return dict(feats=x, feats_lengths=lens.astype(np.int64), target=tgt,
                target_lengths=tl.astype(np.int64))


def _torch_batch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def test_lora_weights_load_in_torch_layout(trio):
    """lora_A (r, in) and lora_B (out, r) carry over untransposed and
    load strict; the kernel next to them is transposed as usual."""
    cfg, _, variables = trio
    tmodel = torch_model(cfg, variables)
    jattn = variables['params']['encoder']['encoders_1']['self_attn']
    attn = tmodel.encoder.encoders[1].self_attn
    for name in ('linear_q', 'linear_out'):
        j = jattn[name]
        layer = getattr(attn, name)
        np.testing.assert_array_equal(layer.lora_A.detach().numpy(),
                                      np.asarray(j['lora_A']))
        np.testing.assert_array_equal(layer.lora_B.detach().numpy(),
                                      np.asarray(j['lora_B']))
        np.testing.assert_array_equal(layer.weight.detach().numpy(),
                                      np.asarray(j['kernel']).T)
        assert layer.lora_A.shape == (4, 32) and layer.scaling == 2.0
    assert tmodel.decoder.decoders[0].src_attn.linear_k.lora_B.abs().sum() > 0


@pytest.mark.parametrize('seed', [1, 2])
def test_loss_and_grads_match_jax(trio, seed):
    import jax
    import jax.numpy as jnp
    from wenet_tpu_torch.utils.checkpoint import state_dict_from_jax
    cfg, model, variables = trio
    tmodel = torch_model(cfg, variables).train()
    b = batch(seed)

    def loss_fn(params):
        out = model.apply({**variables, 'params': params},
                          *(jnp.asarray(b[k]) for k in (
                              'feats', 'feats_lengths', 'target',
                              'target_lengths')), train=True)
        return out['loss'], out

    (_, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables['params'])
    tb = _torch_batch(b)
    got = tmodel(tb['feats'], tb['feats_lengths'], tb['target'],
                 tb['target_lengths'])
    got['loss'].backward()
    assert got['loss_ctc'] is None and want['loss_ctc'] is None
    for k in ('loss', 'loss_att', 'th_accuracy'):
        np.testing.assert_allclose(got[k].item(), float(want[k]),
                                   rtol=1e-5, err_msg=k)
    want_grads = state_dict_from_jax({'params': grads})
    n_lora = 0
    for name, p in tmodel.named_parameters():
        w = want_grads[name].numpy()
        if name.startswith('ctc.'):  # no CTC loss at ctc_weight 0
            assert p.grad is None and not w.any(), name
            continue
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        np.testing.assert_allclose(p.grad.numpy(), w, atol=GRAD_ATOL,
                                   err_msg=name)
        if 'lora_' in name:
            n_lora += 1
            assert np.abs(w).max() > 1e-4, name  # the LoRA term is live
    assert n_lora == 2 * 4 * (2 + 2 * 2)  # A, B x q/k/v/o x 6 attentions


@pytest.mark.parametrize('task_ids', [None, [0, 1, 2, 0], [2, 2, 1, 5]])
@pytest.mark.parametrize('lang_ids', [None, [0, 1, 7, 3]])
def test_build_prefix_matches_jax(trio, lang_ids, task_ids):
    import jax.numpy as jnp
    cfg, model, variables = trio
    tmodel = torch_model(cfg, variables)
    B = 4
    want = model.apply(
        variables, B, None if lang_ids is None else jnp.asarray(lang_ids),
        None if task_ids is None else jnp.asarray(task_ids),
        method=model._build_prefix)
    got = tmodel._build_prefix(
        B, None if lang_ids is None else torch.tensor(lang_ids),
        None if task_ids is None else torch.tensor(task_ids))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if lang_ids is None and task_ids is None:  # zh, transcribe
        st = WHISPER_TOKENS
        assert got[0].tolist() == [st['sot'], st['sot'] + 2,
                                   st['transcribe'], st['no_timestamps']]


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_add_whisper_tokens_matches_jax(trio, seed):
    import jax.numpy as jnp
    cfg, model, variables = trio
    tmodel = torch_model(cfg, variables)
    b = batch(seed, B=4, L=7)
    b['target'][3] = -1  # an empty label
    rng = np.random.RandomState(seed)
    lang = rng.randint(0, 8, size=4)
    task = rng.randint(0, 3, size=4)
    prefix = model.apply(variables, 4, jnp.asarray(lang), jnp.asarray(task),
                         method=model._build_prefix)
    want = model.apply(variables, jnp.asarray(b['target']), prefix,
                       method=model._add_whisper_tokens)
    got = tmodel._add_whisper_tokens(torch.from_numpy(b['target']),
                                     torch.from_numpy(np.array(prefix)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_lang_and_task_ids_match_jax():
    from wenet_tpu.models.whisper import whisper as jw
    from wenet_tpu_torch.models.whisper import whisper as tw
    langs = ['zh', 'en', 'yue', 'xx', 'de']
    tasks = ['transcribe', 'translate', 'vad', 'other']
    np.testing.assert_array_equal(tw.lang_id_array(langs),
                                  jw.lang_id_array(langs))
    np.testing.assert_array_equal(tw.lang_id_array(langs, default='zh'),
                                  jw.lang_id_array(langs, default='zh'))
    np.testing.assert_array_equal(tw.task_id_array(tasks),
                                  jw.task_id_array(tasks))
    assert tw.TASK_IDS == jw.TASK_IDS


def test_prompt_ids_change_the_loss(trio):
    """lang_ids / task_ids reach the loss as in the JAX model."""
    import jax.numpy as jnp
    cfg, model, variables = trio
    tmodel = torch_model(cfg, variables)
    b = batch(3)
    lang, task = np.asarray([0, 2, 5]), np.asarray([1, 0, 2])
    want = model.apply(variables, *(jnp.asarray(b[k]) for k in (
        'feats', 'feats_lengths', 'target', 'target_lengths')),
        lang_ids=jnp.asarray(lang), task_ids=jnp.asarray(task))
    tb = _torch_batch(b)
    with torch.no_grad():
        got = tmodel(tb['feats'], tb['feats_lengths'], tb['target'],
                     tb['target_lengths'], lang_ids=torch.from_numpy(lang),
                     task_ids=torch.from_numpy(task))
        default = tmodel(tb['feats'], tb['feats_lengths'], tb['target'],
                         tb['target_lengths'])
    np.testing.assert_allclose(got['loss'].item(), float(want['loss']),
                               rtol=1e-5)
    assert abs(got['loss'].item() - default['loss'].item()) > 1e-3


def _apply_optax(tx, grads, opt_state, params):
    import optax
    updates, opt_state = tx.update(grads, opt_state, params)
    return optax.apply_updates(params, updates), opt_state


@pytest.mark.parametrize('weight_decay', [0.0, 0.01])
def test_adamw_matches_optax(trio, weight_decay):
    """The finetune yaml's optimizer (adamw, clip 5, accum_grad 8,
    warmuplr) at a raised lr, fed the same gradients: every parameter,
    LoRA or not (the JAX step trains them all), within 1e-6 of optax
    after two updates."""
    import jax
    from wenet_tpu.utils.train_utils import (
        init_optimizer_and_scheduler as jax_init)
    from wenet_tpu_torch.utils.checkpoint import state_dict_from_jax
    from wenet_tpu_torch.utils.train_utils import (
        TrainState, apply_gradients, init_optimizer_and_scheduler)
    accum = 8
    configs = {'optim': 'adamw',
               'optim_conf': {'lr': 0.002, 'weight_decay': weight_decay},
               'scheduler': 'warmuplr',
               'scheduler_conf': {'warmup_steps': 3}, 'grad_clip': 5,
               'accum_grad': accum}
    cfg, _, variables = trio
    tmodel = torch_model(cfg, variables)
    tx, jschedule = jax_init(configs)
    params = variables['params']
    opt_state = tx.init(params)
    update = jax.jit(lambda g, st, p: _apply_optax(tx, g, st, p))
    opt, schedule = init_optimizer_and_scheduler(configs, tmodel)
    assert isinstance(opt, torch.optim.AdamW)
    state = TrainState(tmodel, opt)
    rng = np.random.RandomState(13)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    named = dict(tmodel.named_parameters())
    for micro in range(2 * accum):
        # global norms from about 1 to about 20: clipping on and off
        scale = [0.005, 0.1][micro % 2]
        g = jax.tree_util.tree_unflatten(treedef, [
            (scale * rng.randn(*np.shape(x))).astype(np.float32)
            for x in leaves])
        params, opt_state = update(g, opt_state, params)
        for name, t in state_dict_from_jax({'params': g}).items():
            named[name].grad = t.clone()
        _, lr = apply_gradients(state, schedule, configs['grad_clip'],
                                accum)
        np.testing.assert_allclose(
            lr, float(jschedule(micro // accum)), rtol=1e-6)
    want = state_dict_from_jax({'params': params})
    moved = 0
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-6, err_msg=name)
        moved += 'lora_' in name and not np.array_equal(
            p.detach().numpy(), np.asarray(named[name].grad))
    assert moved > 0


def test_mark_only_lora_as_trainable(trio):
    """The port's trainability flags equal the JAX `lora_param_mask`;
    after a train step the frozen parameters are unchanged and every LoRA
    parameter moved (as tests/test_lora_ctl.py checks optax's updates)."""
    import jax
    from wenet_tpu.models.finetune.lora import lora_param_mask
    from wenet_tpu_torch.models.finetune.lora import (
        is_lora_param, mark_only_lora_as_trainable)
    from wenet_tpu_torch.utils.checkpoint import torch_key
    from wenet_tpu_torch.utils.train_utils import (
        TrainState, init_optimizer_and_scheduler, make_train_step)
    cfg, _, variables = trio
    mask = lora_param_mask(variables['params'])
    for path, leaf in jax.tree_util.tree_flatten_with_path(mask)[0]:
        key = torch_key(('params',) + tuple(k.key for k in path))
        assert is_lora_param(key) == bool(leaf), key
    tmodel = torch_model(cfg, variables)
    mark_only_lora_as_trainable(tmodel)
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    opt, schedule = init_optimizer_and_scheduler(
        {'optim': 'adamw', 'optim_conf': {'lr': 1e-3}, 'scheduler':
         'warmuplr', 'scheduler_conf': {'warmup_steps': 1}}, tmodel)
    n_opt = sum(len(g['params']) for g in opt.param_groups)
    assert n_opt == sum(is_lora_param(n) for n, _ in
                        tmodel.named_parameters()) == 48
    step = make_train_step(tmodel, opt, schedule, grad_clip=5.0)
    _, metrics = step(TrainState(tmodel, opt), _torch_batch(batch(4)),
                      (0, 0))
    assert torch.isfinite(metrics['loss'])
    for name, p in tmodel.named_parameters():
        same = torch.equal(p.detach(), before[name])
        assert same != is_lora_param(name), name


def test_merge_lora_keeps_the_output(trio):
    """Folding B·A·(alpha/r) into the weights and zeroing A and B keeps
    the loss, and gives the JAX `merge_lora`'s weights."""
    from wenet_tpu.models.finetune.lora import merge_lora as jax_merge
    from wenet_tpu_torch.models.finetune.lora import LoRALinear, merge_lora
    from wenet_tpu_torch.utils.checkpoint import state_dict_from_jax
    cfg, _, variables = trio
    tmodel = torch_model(cfg, variables)
    tb = _torch_batch(batch(5))
    args = [tb[k] for k in ('feats', 'feats_lengths', 'target',
                            'target_lengths')]
    with torch.no_grad():
        want = tmodel(*args)
        eo, _ = tmodel.forward_encoder(*args[:2])
        merged = merge_lora(copy.deepcopy(tmodel))
        got = merged(*args)
        geo, _ = merged.forward_encoder(*args[:2])
    torch.testing.assert_close(geo, eo, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got['loss'].item(), want['loss'].item(),
                               rtol=1e-5)
    layers = [m for m in merged.modules() if isinstance(m, LoRALinear)]
    assert len(layers) == 24
    assert all(not m.lora_A.any() and not m.lora_B.any() for m in layers)
    jax_merged = state_dict_from_jax(
        {'params': jax_merge(variables['params'], alpha=LORA['lora_alpha'])})
    for name, t in merged.state_dict().items():
        if name.endswith('.weight') and name in jax_merged:
            torch.testing.assert_close(t, jax_merged[name], atol=1e-6,
                                       rtol=1e-6, msg=name)


def test_executor_trains_whisper_lora(tmp_path):
    """Executor.train runs the whisper LoRA train step with the yaml's
    optimizer (adamw, clip 5, accum_grad 8, lr raised, no warmup): one
    update after eight micro-steps, a checkpoint that loads strict with
    its LoRA weights, and a loss that falls on a fixed batch."""
    from wenet_tpu_torch.utils.checkpoint import load_checkpoint
    from wenet_tpu_torch.utils.executor import Executor
    from wenet_tpu_torch.utils.init_model import init_model
    from wenet_tpu_torch.utils.train_utils import (
        TrainState, init_optimizer_and_scheduler, make_cv_step,
        make_train_step)
    cfg = lora_whisper_config()
    cfg.update(optim='adamw', optim_conf={'lr': 3e-3}, grad_clip=5,
               accum_grad=8, scheduler='warmuplr',
               scheduler_conf={'warmup_steps': 0})
    model = init_model(copy.deepcopy(cfg), torch.Generator().manual_seed(3),
                       device='cpu')
    opt, schedule = init_optimizer_and_scheduler(cfg, model)
    step = make_train_step(model, opt, schedule, None, 8, 5.0)
    b = batch(6)
    losses = []

    def counted(state, tb, rng):
        state, m = step(state, tb, rng)
        losses.append(float(m['loss']))
        return state, m
    state = Executor(device='cpu').train(
        counted, TrainState(model, opt), [b] * 16, [b], make_cv_step(model),
        None, dict(cfg, log_interval=4, save_interval=16, epoch=0, seed=1),
        model_dir=str(tmp_path))
    assert state.step == 16
    # no update inside an accumulation window, one after each eighth
    assert len(set(losses[:8])) == 1 and len(set(losses[8:])) == 1
    assert losses[8] < losses[7] - 1e-3
    fresh = init_model(copy.deepcopy(cfg), device='cpu')
    infos = load_checkpoint(fresh, str(tmp_path / 'step_16.pt'))
    assert infos['step'] == 16
    for (name, a), w in zip(model.state_dict().items(),
                            fresh.state_dict().values()):
        assert torch.equal(a, w), name
    assert any('lora_B' in n for n in fresh.state_dict())


@pytest.mark.cuda
def test_cuda_whisper_train_step_matches_cpu():
    """Tiny whisper with LoRA, its encoder attention sent through the
    flash kernels (gate lowered): forward + backward on the card (one
    launch of K4-train, K5 and K6 per encoder layer) against the CPU."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device to run the Hopper kernels')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from wenet_tpu_torch.models.transformer import attention as A
    from wenet_tpu_torch.ops import flash_attention as fa
    from wenet_tpu_torch.utils.init_model import init_model
    cfg = lora_whisper_config()
    cfg['encoder_conf']['attention_heads'] = 1  # d = 32: the kernels' least
    model = init_model(copy.deepcopy(cfg), torch.Generator().manual_seed(7),
                       device='cpu')
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith('lora_B'):
                p.normal_(0.0, 0.05)
    cpu_model = copy.deepcopy(model).train()
    model.cuda().train()
    tb = _torch_batch(batch(8, T=63))
    saved = dict(A.FLASH_GATE)
    A.FLASH_GATE.update(min_len=16)  # T' = 32: the encoder takes K4-K6
    try:
        fa.reset_launches()
        out = model(*(tb[k].cuda() for k in ('feats', 'feats_lengths',
                                              'target', 'target_lengths')))
        out['loss'].backward()
        torch.cuda.synchronize()
    finally:
        A.FLASH_GATE.update(saved)
    n = cfg['encoder_conf']['num_blocks']
    for name in ('flash_attention_fwd_train', 'flash_attention_bwd_dq',
                 'flash_attention_bwd_dkv'):
        assert fa.LAUNCHES[name] == n, name
    want = cpu_model(*(tb[k] for k in ('feats', 'feats_lengths', 'target',
                                       'target_lengths')))
    want['loss'].backward()
    np.testing.assert_allclose(out['loss'].item(), want['loss'].item(),
                               rtol=1e-4)
    cpu_params = dict(cpu_model.named_parameters())
    for name, p in model.named_parameters():
        if p.grad is None:
            assert cpu_params[name].grad is None, name
            continue
        torch.testing.assert_close(p.grad.cpu(), cpu_params[name].grad,
                                   atol=1e-3, rtol=0, msg=name)
