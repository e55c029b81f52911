"""Positionwise FFN family.  Counterpart of
wenet_tpu/models/transformer/positionwise_feed_forward.py
`PositionwiseFeedForward`, `MoEFFNLayer`, `GatedVariantsMLP` and their
`MLP_CLASSES`.

The MoE layer keeps the JAX package's dense dispatch: every expert runs
every token through stacked (E, D, H) / (E, H, D) weights, and the top-k
router weights combine the results.  Its parameters keep the names and
layouts the JAX package's torch export writes (`gate.weight`,
`experts_w1`, `experts_w2`, `experts_b1`, `experts_b2`), which differ
from upstream wenet's `experts.{i}.w_1.weight`.  Over a `model` axis
(parallel/mesh.py) its experts may be split between the ranks
(`shard_experts`: expert parallelism)."""

import math
from typing import Callable, List

import torch
from torch import nn
import torch.nn.functional as F

from wenet_tpu_torch.models.transformer.activations import get_activation
from wenet_tpu_torch.parallel.mesh import copy_to_model, reduce_from_model


class PositionwiseFeedForward(nn.Module):
    """w_2(dropout(act(w_1(x))))."""

    def __init__(self, idim: int, hidden_units: int,
                 dropout_rate: float = 0.0,
                 activation: Callable[[torch.Tensor], torch.Tensor] = F.relu,
                 bias: bool = True):
        super().__init__()
        self.w_1 = nn.Linear(idim, hidden_units, bias=bias)
        self.activation = activation
        self.dropout = nn.Dropout(dropout_rate)
        self.w_2 = nn.Linear(hidden_units, idim, bias=bias)

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        return self.w_2(self.dropout(self.activation(self.w_1(xs))))


def top_k_lowest_index_first(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last dim, equal values
    in ascending index order, as `jax.lax.top_k` gives them
    (`torch.topk` promises no order on ties)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


class MoEFFNLayer(nn.Module):
    """Top-k routed mixture of FFN experts, dense dispatch: router logits
    `gate(x)`, softmax over the top-k in fp32, every expert's FFN over
    every token, the outputs combined with the top-k weights (zero for
    the experts not chosen).  No dropout, as in the JAX package."""

    def __init__(self, idim: int, hidden_units: int,
                 dropout_rate: float = 0.0,
                 activation: Callable[[torch.Tensor], torch.Tensor] = F.relu,
                 bias: bool = False, n_expert: int = 8,
                 n_expert_activated: int = 2):
        super().__init__()
        self.n_expert = n_expert
        self.k = n_expert_activated
        self.activation = activation
        self.gate = nn.Linear(idim, n_expert, bias=False)
        self.experts_w1 = nn.Parameter(torch.empty(n_expert, idim,
                                                   hidden_units))
        self.experts_w2 = nn.Parameter(torch.empty(n_expert, hidden_units,
                                                   idim))
        if bias:
            self.experts_b1 = nn.Parameter(torch.empty(n_expert,
                                                       hidden_units))
            self.experts_b2 = nn.Parameter(torch.empty(n_expert, idim))
        else:
            self.experts_b1 = self.experts_b2 = None

    # set by `shard_experts`: the model group and the first local expert
    expert_group = None
    expert_offset = 0

    def shard_experts(self, group, size: int, rank: int) -> List[str]:
        """Keep model rank `rank`'s E/size experts of the stacked weights
        and biases (cut on dim 0) -> the names of the parameters cut; none
        where `size` does not divide the experts (they stay whole, as the
        JAX rule leaves them).  The forward then runs this rank's experts
        and sums the combined output over `group`."""
        if self.n_expert % size:
            return []
        names = []
        with torch.no_grad():
            for name in ('experts_w1', 'experts_w2', 'experts_b1',
                         'experts_b2'):
                p = getattr(self, name)
                if p is None:
                    continue
                local = p.detach().chunk(size, 0)[rank].clone()
                setattr(self, name, nn.Parameter(local, p.requires_grad))
                names.append(name)
        self.expert_group = group
        self.expert_offset = rank * (self.n_expert // size)
        return names

    def init_own(self, generator=None):
        """The experts: fan-in uniform weights (the port's Linear init),
        zero biases."""
        own = [self.experts_w1, self.experts_w2]
        with torch.no_grad():
            for w in own:
                bound = 1.0 / math.sqrt(w.shape[1])
                w.uniform_(-bound, bound, generator=generator)
            for b in (self.experts_b1, self.experts_b2):
                if b is not None:
                    b.zero_()
                    own.append(b)
        return own

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        shape = xs.shape
        x = xs.reshape(-1, shape[-1])  # (N, D)
        top_v, top_i = top_k_lowest_index_first(self.gate(x), self.k)
        weights = torch.softmax(top_v.float(), dim=-1).to(xs.dtype)
        combine = x.new_zeros(x.shape[0], self.n_expert).scatter(
            1, top_i, weights)  # (N, E)
        group = self.expert_group
        if group is not None:
            # this rank's experts; the router's and the tokens' gradients
            # are summed over `model` (each rank's reaches its experts'
            # columns and tokens only), so every rank backpropagates the
            # whole router
            combine = copy_to_model(combine, group).narrow(
                1, self.expert_offset, self.experts_w1.shape[0])
            x = copy_to_model(x, group)
        h = torch.einsum('nd,edh->enh', x, self.experts_w1.to(x.dtype))
        if self.experts_b1 is not None:
            h = h + self.experts_b1[:, None, :].to(x.dtype)
        out = torch.einsum('enh,ehd->end', self.activation(h),
                           self.experts_w2.to(x.dtype))
        if self.experts_b2 is not None:
            out = out + self.experts_b2[:, None, :].to(x.dtype)
        y = torch.einsum('end,ne->nd', out, combine)
        if group is not None:
            y = reduce_from_model(y, group)
        return y.reshape(shape)


class GatedVariantsMLP(nn.Module):
    """Gated MLP (SwiGLU-style): w_2(dropout(act(gate(x)) * w_1(x))); the
    gate has no bias."""

    def __init__(self, idim: int, hidden_units: int,
                 dropout_rate: float = 0.0,
                 activation: Callable[[torch.Tensor], torch.Tensor] = F.gelu,
                 bias: bool = True):
        super().__init__()
        self.gate = nn.Linear(idim, hidden_units, bias=False)
        self.activation = activation
        self.w_1 = nn.Linear(idim, hidden_units, bias=bias)
        self.dropout = nn.Dropout(dropout_rate)
        self.w_2 = nn.Linear(hidden_units, idim, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fuse = self.activation(self.gate(x)) * self.w_1(x)
        return self.w_2(self.dropout(fuse))


MLP_CLASSES = {'position_wise_feed_forward': PositionwiseFeedForward,
               'moe': MoEFFNLayer, 'gated': GatedVariantsMLP}


def make_mlp(mlp_type: str, idim: int, hidden_units: int,
             dropout_rate: float, activation_type: str, bias: bool = True,
             n_expert: int = 8, n_expert_activated: int = 2) -> nn.Module:
    if mlp_type not in MLP_CLASSES:
        raise ValueError(f'unknown mlp_type {mlp_type!r}')
    kw = {}
    if mlp_type == 'moe':
        kw = dict(n_expert=n_expert, n_expert_activated=n_expert_activated)
    return MLP_CLASSES[mlp_type](idim, hidden_units, dropout_rate,
                                 get_activation(activation_type), bias,
                                 **kw)
