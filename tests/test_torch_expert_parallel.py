"""Expert parallelism and ZeRO-2 with the model axis in the port
(parallel/mesh.py, `MoEFFNLayer.shard_experts`), on the CPU: four gloo
ranks (tests/torch_parallel_worker.py `moe_data2_model2_zero2`) train the
tiny conformer of tests/torch_port_utils.py with an MoE FFN of four
experts (with biases) in every encoder and decoder layer, laid out as
data=2, model=2 with `model_axis` (min_dim 64) and `zero2`.

- Each model rank keeps two of the four experts (w1, w2, b1, b2 cut on
  dim 0) and the router whole.  The first step equals the one-process
  step on the two data ranks' batches concatenated (losses rtol 1e-5,
  gradients 2e-4, weights 1e-6), the router's gradient on every rank
  too.
- `optimizer_state_dict` gathers the whole Adam state to rank 0 (None
  elsewhere): every parameter's moments at its full shape, equal to the
  one-process run's after two steps (exp_avg within 1e-5, exp_avg_sq
  within 1e-8).
- Two steps, the checkpoint of the whole model and optimizer, a fresh
  layout that loads it, and a third step: the weights equal the
  uninterrupted run's bit for bit; the checkpoint has the one-process
  keys and shapes.
- Where the model size does not divide the experts they stay whole, as
  the JAX rule leaves them."""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_utils import TINY_CONFIG, rank_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, 'tests', 'torch_parallel_worker.py')
SCENARIO = 'moe_data2_model2_zero2'
RNG = (777, 0)
GRAD_ATOL = 2e-4
_MOE = dict(mlp_type='moe', n_expert=4, n_expert_activated=2)


def _config():
    cfg = copy.deepcopy(TINY_CONFIG)
    cfg['encoder_conf'].update(_MOE, use_dynamic_chunk=False)
    cfg['decoder_conf'].update(_MOE)
    for conf in (cfg['encoder_conf'], cfg['decoder_conf']):
        for k in conf:
            if k.endswith('dropout_rate'):
                conf[k] = 0.0
    cfg.update(optim='adam', optim_conf={'lr': 0.002, 'eps': 1e-3},
               scheduler='warmuplr', scheduler_conf={'warmup_steps': 5})
    return cfg


def _env():
    env = dict(os.environ, OMP_NUM_THREADS='1')
    env['PYTHONPATH'] = os.pathsep.join([REPO, env.get('PYTHONPATH', '')])
    for k in ('WORLD_SIZE', 'RANK', 'LOCAL_RANK', 'MASTER_ADDR',
              'MASTER_PORT', 'JAX_COORDINATOR'):
        env.pop(k, None)
    return env


def _concat(step):
    from wenet_tpu_torch.parallel.mesh import pad_batch
    bs = [rank_batch(r, step) for r in range(2)]
    dims = [max(len(b['feats_lengths']) for b in bs),
            max(b['feats'].shape[1] for b in bs),
            max(b['target'].shape[1] for b in bs)]
    bs = [pad_batch(b, *dims) for b in bs]
    return {k: np.concatenate([b[k] for b in bs]) for k in bs[0]}


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    """The four ranks' results, and the one-process run beside them: its
    first step's metrics and gradients, its weights after it, and its
    optimizer state after the second."""
    from wenet_tpu_torch.utils.executor import to_device_batch
    from wenet_tpu_torch.utils.init_model import init_model
    from wenet_tpu_torch.utils.train_utils import (
        TrainState, init_optimizer_and_scheduler, make_train_step)
    d = tmp_path_factory.mktemp('expert_parallel')
    cfg = _config()
    (d / 'moe.json').write_text(json.dumps(cfg))
    model = init_model(copy.deepcopy(cfg), torch.Generator().manual_seed(3),
                       device='cpu')
    torch.save(model.state_dict(), d / 'moe.pt')
    procs = [subprocess.Popen(
        [sys.executable, WORKER, SCENARIO, str(r), '4', str(d / 'init'),
         str(d)], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]
    try:
        opt, schedule = init_optimizer_and_scheduler(cfg, model)
        step = make_train_step(model, opt, schedule, None, 1, 5.0)
        state, metrics = step(TrainState(model, opt),
                              to_device_batch(_concat(0), 'cpu'), RNG)
        one = dict(metrics={k: float(v) for k, v in metrics.items()},
                   grads={n: p.grad.clone()
                          for n, p in model.named_parameters()},
                   weights={k: v.clone()
                            for k, v in model.state_dict().items()},
                   names=[n for n, _ in model.named_parameters()])
        step(state, to_device_batch(_concat(1), 'cpu'), RNG)
        one['optimizer'] = copy.deepcopy(opt.state_dict())
        one['shapes'] = {k: tuple(v.shape)
                         for k, v in model.state_dict().items()}
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    ranks = [torch.load(d / f'{SCENARIO}_rank{r}.pt', weights_only=False)
             for r in range(4)]
    return ranks, one


def test_each_model_rank_keeps_half_the_experts(run):
    ranks, one = run
    experts = [k for k in one['weights'] if '.experts_' in k]
    assert len(experts) == 4 * 8  # w1, w2, b1, b2 in 4 + 2 + 2 layers
    places = set()
    for r in ranks:
        places.add((r['data_rank'], r['model_rank']))
        for k in experts:
            assert r['sharded'][k] == 0, k
            full = one['shapes'][k]
            assert r['local_shapes'][k] == (full[0] // 2,) + full[1:], k
        gates = [k for k in r['local_shapes'] if k.endswith('.gate.weight')]
        assert gates and all(k not in r['sharded'] for k in gates)
    assert places == {(0, 0), (0, 1), (1, 0), (1, 1)}


def test_step_equals_the_one_process_step(run):
    ranks, one = run
    for r in ranks:
        got = r['step']
        for k in ('loss', 'loss_att', 'loss_ctc', 'th_accuracy',
                  'grad_norm'):
            np.testing.assert_allclose(got['metrics'][k], one['metrics'][k],
                                       rtol=1e-5, err_msg=k)
        assert set(got['grads']) == set(one['grads'])
        for k, g in one['grads'].items():
            np.testing.assert_allclose(got['grads'][k].numpy(), g.numpy(),
                                       atol=GRAD_ATOL, err_msg=k)
        for k, w in one['weights'].items():
            np.testing.assert_allclose(got['weights'][k].float().numpy(),
                                       w.float().numpy(), atol=1e-6,
                                       err_msg=k)


def test_router_gradient_is_whole_on_every_rank(run):
    """The all-reduce's backward is the identity and the router's
    gradient is summed over `model`: each rank's router gradient is the
    one process's, not its experts' share of it."""
    ranks, one = run
    gates = [k for k in one['grads'] if k.endswith('.gate.weight')]
    assert len(gates) == 8
    for k in gates:
        want = one['grads'][k].numpy()
        assert np.abs(want).max() > 0
        for r in ranks:
            np.testing.assert_allclose(r['step']['grads'][k].numpy(), want,
                                       atol=GRAD_ATOL, err_msg=k)


def test_optimizer_state_dict_gathers_the_whole_state(run):
    ranks, one = run
    assert all(r['optimizer'] is None for r in ranks[1:])
    got, want = ranks[0]['optimizer'], one['optimizer']
    names = one['names']
    assert set(got['state']) == set(want['state']) == set(range(len(names)))
    for i, st in want['state'].items():
        for k, v in st.items():
            g = got['state'][i][k]
            assert tuple(g.shape) == tuple(v.shape), (names[i], k)
            atol = {'exp_avg': 1e-5, 'exp_avg_sq': 1e-8}.get(k, 0)
            np.testing.assert_allclose(g.numpy(), v.numpy(), atol=atol,
                                       err_msg=f'{names[i]} {k}')


def test_resume_continues_bit_for_bit(run):
    ranks, one = run
    for r in ranks:
        res = r['resume']
        assert res['checkpoint_shapes'] == one['shapes']
        for k, w in res['uninterrupted'].items():
            assert torch.equal(res['resumed'][k], w), k


def test_experts_stay_whole_where_the_model_size_does_not_divide_them():
    from wenet_tpu_torch.models.transformer.positionwise_feed_forward import (
        MoEFFNLayer)
    layer = MoEFFNLayer(8, 16, n_expert=3, bias=True)
    shapes = [tuple(p.shape) for p in layer.parameters()]
    assert layer.shard_experts(None, 2, 1) == []
    assert [tuple(p.shape) for p in layer.parameters()] == shapes
    assert layer.expert_group is None
    layer = MoEFFNLayer(8, 16, n_expert=4, bias=True)
    layer.init_own(torch.Generator().manual_seed(0))
    w1 = layer.experts_w1.detach().clone()
    assert layer.shard_experts('g', 2, 1) == ['experts_w1', 'experts_w2',
                                              'experts_b1', 'experts_b2']
    assert torch.equal(layer.experts_w1, w1[2:])
    assert layer.expert_offset == 2
