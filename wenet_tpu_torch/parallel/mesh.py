"""Process groups, the (data, model) mesh and the training layouts.
Counterpart of wenet_tpu/parallel/mesh.py.

The JAX package lays one program over a `jax.sharding.Mesh` with the axes
`data` and `model`, lets GSPMD place the state, and starts its hosts from
`JAX_COORDINATOR`.  Here each rank is a process that torchrun starts
(WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT); the ranks form a
`DeviceMesh` with the dims `data` and `model` (rank = data rank x model
size + model rank), and the JAX layouts (`state_shardings`) become:

- data: DDP over the `data` group.  Each rank trains on its shard of the
  list; before every step the ranks agree on the batch's rows, frames and
  label length and pad to them (`TrainLayout.agree`), so that a step is
  the one-process step on the concatenated batch, the JAX global batch.
  Inside `TrainLayout.context()` a loss divides by its count summed over
  `data` (`data_denominator`), BatchNorm takes its statistics over `data`
  (`data_batch_stats`) and the dropout draws become the data rank's own
  (`rank_seed`).
- zero2: the optimizer moments sharded over `data`:
  ZeroRedundancyOptimizer over the same Adam / AdamW
  (utils/train_utils.py).
- model_axis: `_rule_single`'s column-parallel rule.  A linear map (an
  nn.Linear, or a pointwise Conv1d, a Dense kernel in the JAX package)
  whose out features divide by the model size and are at least `min_dim`
  keeps this rank's rows of them, an nn.Embedding this rank's columns of
  its embedding dim; the output is gathered over `model`, so every layer
  after it (attention and its kernels too) sees whole tensors.  The pair
  of functions is written out (an identity whose backward all-reduces the
  input's gradient; an all-gather whose backward keeps this rank's slice),
  in place of DTensor's ColwiseParallel: DTensor parameters sit under DDP
  only through the private `_pre_dp_module_transform`, which swaps each
  sharded parameter for a new nn.Parameter after every forward, and
  ZeroRedundancyOptimizer and the checkpoint would then read its private
  shard records.
- expert parallelism, the JAX 3-D rule (`_rule_single`'s (E, D, H)
  case): where the model size divides an MoE layer's experts, each model
  rank keeps E/M of its stacked experts (`experts_w1`, `experts_w2`, and
  `experts_b1`, `experts_b2` with them) and runs its tokens through them
  only; the router stays whole, so every rank computes the same top-k,
  and the combined output is summed over `model`
  (`MoEFFNLayer.shard_experts`, models/transformer/
  positionwise_feed_forward.py).  Elsewhere the experts stay whole, as
  the JAX rule leaves them.  DDP averages each shard over `data` only.

A checkpoint holds full tensors under the reference key names whatever
the layout: `TrainLayout.full_state_dict` gathers the shards (every rank
calls it, rank 0 writes); a rank loads the full file into the unsharded
model and `TrainLayout` takes its shard again.

Decode has no process group: `decode_devices` reads a list of local
devices along `data` (models/runner.py, runtime/batch_runner.py)."""

import contextlib
import contextvars
import datetime
import os
import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from wenet_tpu_torch.utils.checkpoint import _POINTWISE_CONV1D

DATA_AXIS = 'data'
MODEL_AXIS = 'model'
SHARDING_KEYS = ('model_axis', 'zero2', 'min_dim')
# read through `.weight` outside their forward: left whole
_READ_BY_WEIGHT = re.compile(r'(^|\.)pos_embed$')


# -- mesh shapes and ranks ---------------------------------------------------
def parse_mesh(spec: Optional[str]) -> Optional[Dict[str, int]]:
    """'data=4,model=2' -> {'data': 4, 'model': 2}; None or '' -> None."""
    if not spec:
        return None
    shape = {}
    for kv in spec.split(','):
        axis, _, size = kv.partition('=')
        if axis not in (DATA_AXIS, MODEL_AXIS) or not size:
            raise ValueError(f'--mesh {spec}: its axes are data=N and '
                             'model=M')
        shape[axis] = int(size)
    return shape


def mesh_sizes(shape: Optional[Dict[str, int]], world: int
               ) -> Tuple[int, int]:
    """(data, model) sizes of `shape` over `world` ranks: -1 fills, no
    shape puts every rank on `data`.  Raises unless the sizes multiply to
    `world`, as `make_mesh` asserts."""
    shape = dict(shape or {DATA_AXIS: world})
    fill = [a for a, s in shape.items() if s == -1]
    if len(fill) > 1:
        raise ValueError(f'mesh {shape}: one axis at most may be -1')
    if fill:
        known = int(np.prod([s for s in shape.values() if s != -1]))
        shape[fill[0]] = world // max(known, 1)
    data, model = shape.get(DATA_AXIS, 1), shape.get(MODEL_AXIS, 1)
    if data < 1 or model < 1 or data * model != world:
        raise ValueError(f'mesh {shape} spans {data * model} ranks, '
                         f'WORLD_SIZE is {world}')
    return data, model


@dataclass
class Ranks:
    """This process's place among the ranks and its device."""
    rank: int = 0
    world: int = 1
    device: torch.device = torch.device('cpu')
    backend: Optional[str] = None


def init_distributed(device='cuda', backend: Optional[str] = None,
                     init_method: str = 'env://',
                     timeout_s: float = 1800.0) -> Ranks:
    """Join the ranks that torchrun started (WORLD_SIZE, RANK, LOCAL_RANK,
    MASTER_ADDR, MASTER_PORT; `init_method` other than env:// rendezvous
    elsewhere, e.g. file://...).  `backend` None is NCCL on the card and
    gloo on the CPU; gloo also takes CUDA tensors, which runs several
    ranks on one card (NCCL refuses that).  A process that torchrun did
    not start (no WORLD_SIZE) starts no group; under torchrun even one
    rank does, so that its DDP runs over the backend.  A rank asked for
    the card that has none raises, as does the JAX package's launcher
    variable."""
    if 'JAX_COORDINATOR' in os.environ:
        raise ValueError('JAX_COORDINATOR starts the JAX package\'s hosts; '
                         'start the ranks of this trainer with torchrun '
                         '(WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR, '
                         'MASTER_PORT)')
    device = torch.device(device)
    world = int(os.environ.get('WORLD_SIZE', '1'))
    rank = int(os.environ.get('RANK', '0'))
    local = int(os.environ.get('LOCAL_RANK', '0'))
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(f'rank {rank} was asked for the card and has '
                               'no CUDA device (--device cpu trains on the '
                               'CPU)')
        if device.index is None:
            device = torch.device('cuda', local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if 'WORLD_SIZE' not in os.environ:
        return Ranks(0, 1, device)
    if init_method == 'env://':
        missing = [k for k in ('RANK', 'LOCAL_RANK', 'MASTER_ADDR',
                               'MASTER_PORT') if k not in os.environ]
        if missing:
            raise ValueError(f'WORLD_SIZE={world} without {missing}: start '
                             'the ranks with torchrun')
    backend = backend or ('nccl' if device.type == 'cuda' else 'gloo')
    if not dist.is_available() or not dist.is_backend_available(backend):
        raise RuntimeError(f'this torch has no {backend} backend for '
                           'torch.distributed')
    if backend == 'nccl' and device.type != 'cuda':
        raise ValueError('NCCL needs the card: --device cuda, or gloo')
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
    return Ranks(rank, world, device, backend)


class TrainMesh:
    """The (data, model) mesh of this process's ranks: its groups, and this
    rank's place on each axis.  One process is the 1 x 1 mesh."""

    def __init__(self, ranks: Ranks, shape: Optional[Dict[str, int]] = None):
        self.ranks = ranks
        self.data, self.model = mesh_sizes(shape, ranks.world)
        self.data_rank, self.model_rank = divmod(ranks.rank, self.model)
        self.device_mesh = self.data_group = self.model_group = None
        if ranks.backend is not None:
            from torch.distributed.device_mesh import init_device_mesh
            # a 'cuda' mesh would set each rank's device from LOCAL_RANK,
            # which several gloo ranks on one card do not have
            dm = init_device_mesh(
                'cuda' if ranks.backend == 'nccl' else 'cpu',
                (self.data, self.model),
                mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
            self.device_mesh = dm
            self.data_group = dm.get_group(DATA_AXIS)
            self.model_group = dm.get_group(MODEL_AXIS)
            self.data_rank = dm.get_local_rank(DATA_AXIS)
            self.model_rank = dm.get_local_rank(MODEL_AXIS)

    @property
    def comm_device(self) -> torch.device:
        """Where host-side integers go for a collective: the card under
        NCCL, the CPU under gloo."""
        return (self.ranks.device if self.ranks.backend == 'nccl'
                else torch.device('cpu'))


# -- the data-parallel step's context ---------------------------------------
@dataclass(frozen=True)
class DataContext:
    group: Any
    size: int
    rank: int


_DATA: contextvars.ContextVar = contextvars.ContextVar(
    'wenet_tpu_torch_data_parallel', default=None)


@contextlib.contextmanager
def data_parallel(ctx: Optional[DataContext]):
    """Run a train step's forward as one of `ctx.size` ranks on `data`."""
    token = _DATA.set(ctx)
    try:
        yield
    finally:
        _DATA.reset(token)


def data_denominator(n: torch.Tensor) -> torch.Tensor:
    """A loss's denominator from `n`, a count of this batch's rows or
    tokens: max(n, 1); inside a data-parallel step max(n summed over
    `data`, 1) / the data size, so that DDP's mean of the ranks' gradients
    is the gradient of the loss over the global batch, and the mean of the
    ranks' losses that loss."""
    ctx = _DATA.get()
    if ctx is None:
        return n.clamp(min=1)
    total = n.detach().to(torch.float32).clone()
    dist.all_reduce(total, group=ctx.group)
    return total.clamp(min=1) / ctx.size


def rank_seed(seed: int) -> int:
    """A seed drawn alike on every rank, made this data rank's own (the
    dropout draws): `seed` on data rank 0 and outside a data-parallel
    step."""
    ctx = _DATA.get()
    if ctx is None or ctx.rank == 0:
        return seed
    return int(np.random.SeedSequence([seed, ctx.rank]).generate_state(1)[0])


def data_batch_stats(x: torch.Tensor, dims: Sequence[int]
                     ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """(mean, biased variance) of x over `dims` and over every rank on
    `data`, differentiable (the JAX BatchNorm's statistics of the global
    batch); None outside a data-parallel step."""
    ctx = _DATA.get()
    if ctx is None:
        return None

    def all_reduce(t, group):
        return _AllReduce.apply(t, group)

    xf = x.float()
    count = torch.tensor(float(xf.numel() // xf.shape[1]), device=x.device)
    dist.all_reduce(count, group=ctx.group)
    keep = [d for d in range(x.dim()) if d not in dims]
    shape = [x.shape[d] if d in keep else 1 for d in range(x.dim())]
    mean = all_reduce(xf.sum(dims), group=ctx.group) / count
    var = all_reduce((xf - mean.view(shape)).square().sum(dims),
                     group=ctx.group) / count
    return mean, var


class _AllReduce(torch.autograd.Function):
    """The sum over `group`; its gradient is the sum of the ranks'
    gradients (every rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


# -- the model axis ----------------------------------------------------------
class _CopyToModel(torch.autograd.Function):
    """Identity; the input's gradient is summed over `model` (each rank
    holds the part of it that its slice of the output gives)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """The sum over `model` of every rank's part; the gradient passes to
    each part unchanged (every rank reads the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """x as it is; in the backward its gradient is summed over `model`."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over `model`; the backward is the identity."""
    return _ReduceFromModel.apply(x, group)


class _GatherFromModel(torch.autograd.Function):
    """Concatenate every model rank's slice along `dim`; the gradient keeps
    this rank's slice (the layers after it run alike on every model
    rank)."""

    @staticmethod
    def forward(ctx, y, group, size, rank, dim):
        ctx.rank, ctx.dim, ctx.n = rank, dim, y.shape[dim]
        y = y.contiguous()
        parts = [torch.empty_like(y) for _ in range(size)]
        dist.all_gather(parts, y, group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        return (grad.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n).contiguous(),
                None, None, None, None)


class _ModelSharded:
    """Set by `shard_model_axis`: the group, size and rank of `model`."""
    model_group: Any
    model_size: int
    model_rank: int

    def _gather(self, y, dim):
        return _GatherFromModel.apply(y, self.model_group, self.model_size,
                                      self.model_rank, dim)


class ColumnParallelLinear(_ModelSharded, nn.Linear):
    def forward(self, x):
        x = _CopyToModel.apply(x, self.model_group)
        return self._gather(F.linear(x, self.weight, self.bias), -1)


class ColumnParallelConv1d(_ModelSharded, nn.Conv1d):
    def forward(self, x):
        x = _CopyToModel.apply(x, self.model_group)
        return self._gather(self._conv_forward(x, self.weight, self.bias), 1)


class EmbeddingDimParallel(_ModelSharded, nn.Embedding):
    def forward(self, x):
        return self._gather(super().forward(x), -1)


_SHARDED = {nn.Linear: (ColumnParallelLinear, 0),
            nn.Conv1d: (ColumnParallelConv1d, 0),
            nn.Embedding: (EmbeddingDimParallel, 1)}


def _out_features(name: str, m: nn.Module) -> Optional[int]:
    """The JAX kernel's (or embedding's) column count if `_rule_single`
    reads this module as a 2-D kernel, else None."""
    if _READ_BY_WEIGHT.search(name):
        return None
    if type(m) is nn.Linear:
        return m.out_features
    if type(m) is nn.Embedding:
        return m.embedding_dim
    if type(m) is nn.Conv1d and m.kernel_size == (1,) and m.groups == 1 \
            and _POINTWISE_CONV1D.search(name):
        return m.out_channels
    return None


def shard_model_axis(model: nn.Module, group, size: int, rank: int,
                     min_dim: int = 512) -> Dict[str, int]:
    """Shard, in place, the modules that `_rule_single` puts column-parallel
    over `model` (out features divisible by `size` and at least `min_dim`)
    and the stacked experts it cuts over `model` (an MoE layer's, where
    `size` divides its experts) -> {parameter name: the dim its shard was
    cut from}."""
    tied = {f'{n}.embed.0' for n, m in model.named_modules()
            if getattr(m, 'tie_word_embedding', False)}
    sharded: Dict[str, int] = {}
    for name, m in list(model.named_modules()):
        out = _out_features(name, m)
        if out is None or out % size or out < min_dim or name in tied:
            continue
        cls, dim = _SHARDED[type(m)]
        with torch.no_grad():
            for pname, p in list(m.named_parameters(recurse=False)):
                d = dim if pname == 'weight' else 0
                local = p.detach().chunk(size, d)[rank].clone()
                setattr(m, pname, nn.Parameter(local, p.requires_grad))
                sharded[f'{name}.{pname}'] = d
        m.__class__ = cls
        m.model_group, m.model_size, m.model_rank = group, size, rank
    for name, m in model.named_modules():
        shard_experts = getattr(m, 'shard_experts', None)
        if shard_experts is not None:
            for pname in shard_experts(group, size, rank):
                sharded[f'{name}.{pname}'] = 0
    return sharded


def gather_model_shard(t: torch.Tensor, dim: int, group, size: int
                       ) -> torch.Tensor:
    """The full tensor of every model rank's shard `t` (cut along `dim`)."""
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim)


# -- the layout --------------------------------------------------------------
class TrainLayout:
    """A model's training layout on `mesh` from the yaml's `sharding_conf`
    ({model_axis, zero2, min_dim}, unknown keys raise).  `module` is what
    the train step calls (DDP over `data` whenever the ranks have a
    group, with `broadcast_buffers=False`: each rank's BatchNorm buffers
    follow the global statistics already); `model` the bare model."""

    def __init__(self, mesh: TrainMesh, model: nn.Module,
                 sharding_conf: Optional[dict] = None):
        conf = dict(sharding_conf or {})
        unknown = sorted(set(conf) - set(SHARDING_KEYS))
        if unknown:
            raise ValueError(f'sharding_conf keys {unknown} are not layouts '
                             f'(they are {list(SHARDING_KEYS)})')
        self.mesh = mesh
        self.model = model
        self.zero2 = bool(conf.get('zero2', False)) and mesh.data > 1
        self.sharded: Dict[str, int] = {}
        if conf.get('model_axis', False) and mesh.model > 1:
            self.sharded = shard_model_axis(model, mesh.model_group,
                                            mesh.model, mesh.model_rank,
                                            int(conf.get('min_dim', 512)))
        params = dict(model.named_parameters())
        self._sharded_params = {id(params[n]) for n in self.sharded
                                if n in params}
        self.module = model
        if mesh.ranks.backend is not None:
            from torch.nn.parallel import DistributedDataParallel
            device = mesh.ranks.device
            self.module = DistributedDataParallel(
                model, device_ids=[device] if device.type == 'cuda' else None,
                process_group=mesh.data_group, broadcast_buffers=False,
                find_unused_parameters=True)

    @property
    def is_main(self) -> bool:
        """The rank that logs and writes."""
        return self.mesh.ranks.rank == 0

    def zero_group(self):
        """The group ZeroRedundancyOptimizer shards the moments over, or
        None."""
        return self.mesh.data_group if self.zero2 else None

    def context(self):
        """The context of a train step's forward and backward."""
        m = self.mesh
        return data_parallel(DataContext(m.data_group, m.data, m.data_rank)
                             if m.data > 1 else None)

    # -- steps ---------------------------------------------------------------
    def agree(self, batch: Optional[dict]) -> Optional[dict]:
        """The ranks' agreement before a step (one all-reduce over all of
        them): None when any rank's data ran out, so that every rank ends
        the epoch (the JAX `wenet_join`); else `batch` padded to the most
        rows, frames and label length on any rank."""
        if self.mesh.ranks.world == 1:
            return batch
        dims = [0, 0, 0, 1]
        if batch is not None:
            dims = [len(batch['feats_lengths']), batch['feats'].shape[1],
                    np.shape(batch['target'])[1], 0]
        t = torch.tensor(dims, dtype=torch.int64,
                         device=self.mesh.comm_device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        rows, frames, labels, done = t.tolist()
        if done:
            return None
        return pad_batch(batch, rows, frames, labels)

    def mean_over_data(self, metrics: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
        """The metrics' mean over `data` (one all-reduce): each rank's
        losses are its share of the global batch's."""
        if self.mesh.data == 1 or not metrics:
            return metrics
        keys = list(metrics)
        t = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
        if self.mesh.ranks.backend == 'nccl':
            t = t.to(self.mesh.ranks.device)
        else:
            t = t.cpu()
        dist.all_reduce(t, group=self.mesh.data_group)
        t = t / self.mesh.data
        return dict(zip(keys, t.unbind()))

    def global_norm(self, params: Sequence[torch.Tensor],
                    grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """sqrt of the sum of squares of the whole model's gradients: a
        sharded tensor's squares summed over `model`, a replicated one's
        once."""
        sq = [g.float().square().sum() for g in grads]
        zero = grads[0].new_zeros((), dtype=torch.float32)
        rep = torch.stack([s for p, s in zip(params, sq)
                           if id(p) not in self._sharded_params] or [zero])
        if not self._sharded_params:
            return rep.sum().sqrt()
        shd = torch.stack([s for p, s in zip(params, sq)
                           if id(p) in self._sharded_params]).sum()
        dist.all_reduce(shd, group=self.mesh.model_group)
        return (rep.sum() + shd).sqrt()

    # -- checkpoints ---------------------------------------------------------
    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's state_dict with every shard gathered over `model`:
        the keys and shapes of a one-process model.  Every rank calls it."""
        state = self.model.state_dict()
        m = self.mesh
        for name, dim in self.sharded.items():
            state[name] = gather_model_shard(state[name], dim,
                                             m.model_group, m.model)
        return state

    def _param_names(self, optimizer) -> List[str]:
        names = {id(p): n for n, p in self.model.named_parameters()}
        return [names[id(p)] for g in optimizer.param_groups
                for p in g['params']]

    def optimizer_state_dict(self, optimizer) -> Optional[dict]:
        """The optimizer's whole state on rank 0 (None elsewhere): under
        zero2 each data group's partitions consolidated on its data rank
        0 (`consolidate_state_dict`), then the moments of sharded tensors
        (column-parallel maps, expert shards) gathered over `model`, by
        the data rank 0's model group.  Every rank calls it."""
        m = self.mesh
        if self.zero2:
            optimizer.consolidate_state_dict(to=0)  # rank 0 of the group
            if m.data_rank != 0:
                return None
        state = optimizer.state_dict()
        if not self.sharded:
            return state if self.is_main else None
        # state_dict() hands out the live per-parameter dicts
        state['state'] = {i: dict(s) for i, s in state['state'].items()}
        for i, name in enumerate(self._param_names(optimizer)):
            if name not in self.sharded:
                continue
            st = state['state'].get(i, {})
            for k, v in st.items():
                if torch.is_tensor(v) and v.dim() > 0:
                    # ZeRO consolidates on the CPU; NCCL gathers on the card
                    full = gather_model_shard(
                        v.to(m.comm_device) if self.zero2 else v,
                        self.sharded[name], m.model_group, m.model)
                    st[k] = full.to(v.device)
        return state if self.is_main else None

    def load_optimizer_state_dict(self, optimizer, state: dict) -> None:
        """Load `optimizer_state_dict`'s whole state: each rank takes its
        shards of it."""
        m = self.mesh
        if self.sharded:
            state = {'state': {i: dict(s) for i, s in state['state'].items()},
                     'param_groups': state['param_groups']}
            for i, name in enumerate(self._param_names(optimizer)):
                if name not in self.sharded or i not in state['state']:
                    continue
                st = state['state'][i]
                for k, v in st.items():
                    if torch.is_tensor(v) and v.dim() > 0:
                        st[k] = v.chunk(m.model, self.sharded[name])[
                            m.model_rank].clone()
        optimizer.load_state_dict(state)


def pad_batch(batch: dict, rows: int, frames: int, labels: int) -> dict:
    """`batch` (numpy, as the Dataset gives it) padded to `rows` x `frames`
    with zeros and its labels to `labels` with IGNORE_ID; added rows are
    zero-length dummies, which leave every loss (the JAX `_pad_rows`)."""
    from wenet_tpu_torch.utils.common import IGNORE_ID
    out = dict(batch)
    feats = np.asarray(batch['feats'])
    B, T = feats.shape[:2]
    out['feats'] = np.pad(feats, [(0, rows - B), (0, frames - T)] +
                          [(0, 0)] * (feats.ndim - 2))
    target = np.asarray(batch['target'])
    out['target'] = np.pad(target, [(0, rows - B),
                                    (0, labels - target.shape[1])],
                           constant_values=IGNORE_ID)
    for k in ('feats_lengths', 'target_lengths'):
        out[k] = np.pad(np.asarray(batch[k]), (0, rows - B))
    return out


# -- decode ------------------------------------------------------------------
def decode_devices(mesh) -> List[torch.device]:
    """The local devices of a decode mesh along `data`: a sequence of
    devices (or their names); one device may repeat, as two replicas on
    one card."""
    try:
        if isinstance(mesh, (str, torch.device)):
            raise TypeError
        devices = [torch.device(d) for d in mesh]
    except (TypeError, RuntimeError) as e:
        raise ValueError(f'mesh {mesh!r}: a decode mesh is a list of local '
                         'devices along data') from e
    if not devices:
        raise ValueError('a decode mesh needs one device at least')
    return devices
