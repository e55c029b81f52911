"""One rank of the multi-process checks of tests/test_torch_parallel.py,
tests/test_torch_zoo_slice.py (`moe_model2`) and
tests/test_torch_expert_parallel.py (`moe_data2_model2_zero2`), on the
CPU over gloo;
imports no JAX:

    python tests/torch_parallel_worker.py SCENARIO RANK WORLD INIT_FILE DIR

DIR holds what the test wrote (`<name>.json` configs, `<name>.pt`
initial state dicts); the rank writes its results to
DIR/SCENARIO_rank{RANK}.pt.  The ranks rendezvous through INIT_FILE
(file://), each collective times out after 60 s."""

import copy
import json
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)

from torch_port_utils import rank_batch  # noqa: E402
from wenet_tpu_torch.parallel import mesh as pm  # noqa: E402
from wenet_tpu_torch.utils.executor import (Executor,  # noqa: E402
                                            to_device_batch)
from wenet_tpu_torch.utils.init_model import init_model  # noqa: E402
from wenet_tpu_torch.utils.train_utils import (  # noqa: E402
    TrainState, init_optimizer_and_scheduler, make_train_step,
    restore_optimizer_step, step_seeds)

RNG = (777, 0)  # (seed, epoch) of every step


class Run:
    """A model from DIR/<cfg>.{json,pt} laid out on `shape`, its optimizer
    and its train step."""

    def __init__(self, ranks, work, cfg, shape, sharding=None, accum=1,
                 clip=5.0, state=None):
        with open(os.path.join(work, cfg + '.json')) as f:
            self.configs = json.load(f)
        self.model = init_model(copy.deepcopy(self.configs), device='cpu')
        self.model.load_state_dict(
            state if state is not None else
            torch.load(os.path.join(work, cfg + '.pt')), strict=True)
        self.mesh = pm.TrainMesh(ranks, shape)
        self.layout = pm.TrainLayout(self.mesh, self.model, sharding)
        self.opt, sched = init_optimizer_and_scheduler(
            self.configs, self.model, self.layout.zero_group())
        self.state = TrainState(self.model, self.opt)
        self.step_fn = make_train_step(self.model, self.opt, sched, None,
                                       accum, clip, self.layout)

    def batch(self, step):
        return self.layout.agree(rank_batch(self.mesh.data_rank, step))

    def step(self, step):
        self.state, metrics = self.step_fn(
            self.state, to_device_batch(self.batch(step), 'cpu'), RNG)
        return {k: float(v) for k, v in metrics.items()}

    def grads(self):
        m = self.mesh
        out = {}
        for name, p in self.model.named_parameters():
            g = p.grad
            if name in self.layout.sharded:
                g = pm.gather_model_shard(g, self.layout.sharded[name],
                                          m.model_group, m.model)
            out[name] = g.clone()
        return out

    def weights(self):
        return {k: v.clone() for k, v in
                self.layout.full_state_dict().items()}


def resume(ranks, work, cfg, shape, sharding, tag):
    """Three steps uninterrupted, and two steps, a checkpoint (model and
    optimizer, whole), a fresh model that loads it and takes its shards,
    and the third step -> both runs' weights after the third step."""
    a = Run(ranks, work, cfg, shape, sharding)
    for s in range(2):
        a.step(s)
    ckpt = os.path.join(work, f'{tag}_ckpt.pt')
    weights = a.layout.full_state_dict()
    opt_state = a.layout.optimizer_state_dict(a.opt)
    if a.layout.is_main:
        torch.save({'model': weights, 'optim': opt_state,
                    'step': a.state.step}, ckpt)
    dist.barrier()
    a.step(2)
    saved = torch.load(ckpt)
    b = Run(ranks, work, cfg, shape, sharding, state=saved['model'])
    b.layout.load_optimizer_state_dict(b.opt, saved['optim'])
    b.state = restore_optimizer_step(b.state, saved['step'])
    b.step(2)
    return dict(uninterrupted=a.weights(), resumed=b.weights(),
                checkpoint_shapes={k: tuple(v.shape)
                                   for k, v in saved['model'].items()})


def dropout_draws(ranks, work):
    """One training forward of the same batch on every rank under the
    data-parallel context: the dynamic-chunk draw, the attention-dropout
    seeds each call drew, the first call's dropout mask and the loss."""
    import wenet_tpu_torch.models.transformer.attention as att
    import wenet_tpu_torch.utils.mask as mask_mod
    from wenet_tpu_torch.ops.flash_attention import dense_dropout
    run = Run(ranks, work, 'dropout', {'data': ranks.world})
    seeds, masks, chunks = [], [], []
    real, real_draw = att.flash_attention_relpos, mask_mod.draw_dynamic_chunk

    def record(*args):
        q1, k, rate, seed = args[0], args[2], args[-2], args[-1]
        seeds.append(seed)
        masks.append(dense_dropout(q1.shape[0], q1.shape[1], q1.shape[2],
                                   k.shape[2], rate, seed, 'cpu'))
        return real(*args)

    def record_draw(*args):
        chunks.append(real_draw(*args))
        return chunks[-1]

    att.flash_attention_relpos = record
    mask_mod.draw_dynamic_chunk = record_draw
    try:
        device_seed, host_seed = step_seeds(*RNG, 0)
        b = to_device_batch(rank_batch(0, 0), 'cpu')
        with run.layout.context():
            torch.manual_seed(pm.rank_seed(device_seed))
            out = run.model(b['feats'], b['feats_lengths'], b['target'],
                            b['target_lengths'],
                            generator=torch.Generator().manual_seed(
                                host_seed))
    finally:
        att.flash_attention_relpos = real
        mask_mod.draw_dynamic_chunk = real_draw
    return dict(seeds=seeds, mask=masks[0], chunks=chunks,
                loss=float(out['loss'].detach()))


def uneven(ranks, work):
    """Executor.train over 5 batches on rank 0 and 3 on rank 1 -> the
    steps each rank took."""
    run = Run(ranks, work, 'plain', {'data': ranks.world})
    n = 5 if ranks.rank == 0 else 3
    loader = [rank_batch(run.mesh.data_rank, s) for s in range(n)]
    ex = Executor(device='cpu', layout=run.layout)
    ex.train(run.step_fn, run.state, loader, None, None, None,
             {'log_interval': 10 ** 9})
    return ex.totals['steps']


def data2(ranks, work):
    data = {'data': 2}
    one = Run(ranks, work, 'plain', data)
    out = {'step': dict(metrics=one.step(0), grads=one.grads(),
                        weights=one.weights())}
    acc = Run(ranks, work, 'plain', data, accum=2)
    acc.step(0)
    acc.step(1)
    out['accum'] = acc.weights()
    zero = Run(ranks, work, 'plain', data, {'zero2': True})
    out['zero2'] = dict(metrics=zero.step(0), weights=zero.weights(),
                        moments=len(zero.opt.optim.state),
                        params=len(list(zero.model.parameters())))
    bn = Run(ranks, work, 'bn', data)
    out['bn'] = dict(metrics=bn.step(0), grads=bn.grads(),
                     weights=bn.weights())
    out['zero2_resume'] = resume(ranks, work, 'plain', data,
                                 {'zero2': True}, 'zero2')
    out['dropout'] = dropout_draws(ranks, work)
    out['uneven_steps'] = uneven(ranks, work)
    return out


def model2(ranks, work):
    shape, sharding = {'model': 2}, {'model_axis': True, 'min_dim': 64}
    run = Run(ranks, work, 'plain', shape, sharding)
    out = {'sharded': dict(run.layout.sharded),
           'local_shapes': {n: tuple(p.shape) for n, p in
                            run.model.named_parameters()},
           'step': dict(metrics=run.step(0), grads=run.grads(),
                        weights=run.weights())}
    out['resume'] = resume(ranks, work, 'plain', shape, sharding, 'model2')
    return out


def data2_model2(ranks, work):
    run = Run(ranks, work, 'plain', {'data': 2, 'model': 2},
              {'model_axis': True, 'min_dim': 64})
    return {'step': dict(metrics=run.step(0), grads=run.grads(),
                         weights=run.weights()),
            'data_rank': run.mesh.data_rank,
            'model_rank': run.mesh.model_rank}


def moe_model2(ranks, work):
    """model=2 over the MoE conformer of tests/test_torch_zoo_slice.py:
    what was cut, each parameter's local shape, the first step."""
    run = Run(ranks, work, 'moe', {'model': 2},
              {'model_axis': True, 'min_dim': 64})
    return {'sharded': dict(run.layout.sharded),
            'local_shapes': {n: tuple(p.shape) for n, p in
                             run.model.named_parameters()},
            'step': dict(metrics=run.step(0), grads=run.grads(),
                         weights=run.weights())}


def moe_data2_model2_zero2(ranks, work):
    """data=2, model=2 with zero2 over the MoE config of
    tests/test_torch_expert_parallel.py: the first step, the whole
    optimizer state after the second, and the resume."""
    shape = {'data': 2, 'model': 2}
    sharding = {'model_axis': True, 'min_dim': 64, 'zero2': True}
    run = Run(ranks, work, 'moe', shape, sharding)
    out = {'sharded': dict(run.layout.sharded),
           'local_shapes': {n: tuple(p.shape) for n, p in
                            run.model.named_parameters()},
           'data_rank': run.mesh.data_rank,
           'model_rank': run.mesh.model_rank,
           'step': dict(metrics=run.step(0), grads=run.grads(),
                        weights=run.weights())}
    run.step(1)
    out['optimizer'] = run.layout.optimizer_state_dict(run.opt)
    out['resume'] = resume(ranks, work, 'moe', shape, sharding, 'moe_zero2')
    return out


SCENARIOS = {'data2': data2, 'model2': model2, 'data2_model2': data2_model2,
             'moe_model2': moe_model2,
             'moe_data2_model2_zero2': moe_data2_model2_zero2}


def main():
    scenario, rank, world, init_file, work = sys.argv[1:6]
    os.environ.update(WORLD_SIZE=world, RANK=rank, LOCAL_RANK=rank)
    ranks = pm.init_distributed('cpu', init_method=f'file://{init_file}',
                                timeout_s=60)
    try:
        out = SCENARIOS[scenario](ranks, work)
        torch.save(out, os.path.join(work, f'{scenario}_rank{rank}.pt'))
    finally:
        dist.destroy_process_group()


if __name__ == '__main__':
    main()
