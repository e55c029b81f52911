"""LoRA fine-tuning.  Counterpart of wenet_tpu/models/finetune/lora.py
(`LoRADense`, `make_attention_dense`, `lora_param_mask` /
`mark_only_lora_as_trainable`, `merge_lora`).

`LoRALinear` is an `nn.Linear` with a rank-r update, so its state-dict
keys are the JAX `LoRADense`'s through `state_dict_from_jax`: `weight`,
`bias`, `lora_A` (r, in) and `lora_B` (out, r), the last two already in
torch layout.  Trainability is the parameters' `requires_grad` flag,
set before the optimizer is built (the JAX package masks the optax
transform instead).

LoRA-GA: `estimate_gradient` averages the loss gradient of every
parameter over a few batches, and `reinit_lora` sets each LoRA layer's A
and B from the SVD of its weight's gradient (A the top r right singular
vectors, B the next r left ones, both over sqrt(stable_gamma)) and takes
the scaled B·A off the weight, so that the model's function does not
change; or, `'gaussian'`, A kaiming-uniform and B zero."""

import math
from typing import Dict, Iterable, Optional

import torch
from torch import nn
import torch.nn.functional as F

LORA_KEYS = ('o', 'q', 'k', 'v')


class LoRALinear(nn.Linear):
    """y = x·Wᵀ + b + (dropout(x)·Aᵀ)·Bᵀ·(alpha / r)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, r: int = 8, alpha: float = 8,
                 dropout: float = 0.0):
        super().__init__(in_features, out_features, bias=bias)
        self.scaling = alpha / r
        self.lora_A = nn.Parameter(torch.empty(r, in_features))
        self.lora_B = nn.Parameter(torch.empty(out_features, r))
        self.lora_dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        update = F.linear(F.linear(self.lora_dropout(x), self.lora_A),
                          self.lora_B)
        return super().forward(x) + update * self.scaling


def make_attention_linear(in_features: int, out_features: int, bias: bool,
                          key: str, conf: Optional[dict] = None
                          ) -> nn.Linear:
    """`LoRALinear` when the lora conf has a rank > 0 and lists `key`
    (one of 'q', 'k', 'v', 'o'), else `nn.Linear`."""
    if conf and conf.get('lora_rank', 0) > 0 and key in conf.get(
            'lora_list', LORA_KEYS):
        return LoRALinear(in_features, out_features, bias,
                          r=conf['lora_rank'],
                          alpha=conf.get('lora_alpha', conf['lora_rank']),
                          dropout=conf.get('lora_dropout', 0.0))
    return nn.Linear(in_features, out_features, bias=bias)


def is_lora_param(name: str) -> bool:
    """True for LoRA parameters (any path segment starting 'lora_')."""
    return any(seg.startswith('lora_') for seg in name.split('.'))


def mark_only_lora_as_trainable(model: nn.Module) -> None:
    """Freeze every parameter but the LoRA ones.  Build the optimizer
    after this: `init_optimizer_and_scheduler` takes the parameters that
    require grad."""
    for name, p in model.named_parameters():
        p.requires_grad_(is_lora_param(name))


@torch.no_grad()
def merge_lora(model: nn.Module) -> nn.Module:
    """Fold B·A·(alpha / r) into each `LoRALinear`'s weight and zero A and
    B (export, eval), in place: the outputs do not change.  The JAX
    function takes alpha as an argument; here each layer keeps its own."""
    for m in model.modules():
        if isinstance(m, LoRALinear):
            m.weight += m.scaling * (m.lora_B @ m.lora_A)
            m.lora_A.zero_()
            m.lora_B.zero_()
    return model


def estimate_gradient(model: nn.Module, batches: Iterable[dict]
                      ) -> Dict[str, torch.Tensor]:
    """The mean over `batches` of the loss's gradient with respect to every
    parameter (frozen ones too) -> {name: mean gradient}, fp32, on the
    model's device.

    Each batch is a dict of device tensors feats, feats_lengths, target,
    target_lengths.  The model runs in eval mode (no dropout, full
    context) with autograd on, as the JAX `model.apply` without
    `train=True` does (finetune/lora.py:138-164); its mode and each
    parameter's `requires_grad` are put back after."""
    params = dict(model.named_parameters())
    trainable = {n: p.requires_grad for n, p in params.items()}
    was_training = model.training
    acc: Dict[str, torch.Tensor] = {}
    n = 0
    try:
        model.eval()
        for p in params.values():
            p.requires_grad_(True)
        with torch.enable_grad():
            for batch in batches:
                model.zero_grad(set_to_none=True)
                out = model(batch['feats'], batch['feats_lengths'],
                            batch['target'], batch['target_lengths'])
                out['loss'].float().backward()
                for name, p in params.items():
                    g = (torch.zeros_like(p, dtype=torch.float32)
                         if p.grad is None else p.grad.float())
                    acc[name] = g if name not in acc else acc[name] + g
                n += 1
    finally:
        model.zero_grad(set_to_none=True)
        for name, p in params.items():
            p.requires_grad_(trainable[name])
        model.train(was_training)
    if n == 0:
        raise ValueError('estimate_gradient needs at least one batch')
    return {name: g / n for name, g in acc.items()}


@torch.no_grad()
def reinit_lora(model: nn.Module,
                grads: Optional[Dict[str, torch.Tensor]] = None,
                init_type: str = 'gradient', stable_gamma: float = 16.0,
                generator: Optional[torch.Generator] = None) -> nn.Module:
    """Re-initialize every `LoRALinear`'s lora_A and lora_B in place
    (the JAX `reinit_lora`, finetune/lora.py:167-214).

    'gradient': G = grads[<layer>.weight] (out, in), U·S·Vh its thin SVD
    (`torch.linalg.svd`, fp32); A = Vh[:r] / sqrt(stable_gamma), B =
    U[:, r:2r] / sqrt(stable_gamma), and the weight loses the layer's
    scaling · B·A, so the output does not change.  The singular vectors'
    signs are the solver's: another solver may flip a row of A or a
    column of B.  The JAX function scales the compensation by its `alpha`
    argument over r (1 by default); here each layer takes its own alpha / r.
    'gaussian': A kaiming-uniform over fan_in = r (flax's
    `kaiming_uniform` on an (r, in) kernel: bound sqrt(6 / r)) drawn from
    `generator`, B zero; the JAX function draws from `fold_in(rng, 0)`
    for every layer, this one draws each layer afresh."""
    if init_type not in ('gradient', 'gaussian'):
        raise ValueError(f'init_type {init_type!r}: gradient or gaussian')
    for name, m in model.named_modules():
        if not isinstance(m, LoRALinear):
            continue
        r = m.lora_A.shape[0]
        if init_type == 'gaussian':
            bound = math.sqrt(6.0 / r)
            m.lora_A.uniform_(-bound, bound, generator=generator)
            m.lora_B.zero_()
            continue
        key = f'{name}.weight'
        if grads is None or key not in grads:
            raise ValueError(f'gradient init needs the gradient of {key} '
                             '(estimate_gradient)')
        U, _, Vh = torch.linalg.svd(grads[key].float().to(m.weight.device),
                                    full_matrices=False)
        scale = 1.0 / math.sqrt(stable_gamma)
        A = Vh[:r] * scale
        B = U[:, r:2 * r] * scale
        m.lora_A.copy_(A)
        m.lora_B.copy_(B)
        m.weight -= (m.scaling * (B @ A)).to(m.weight.dtype)
    return model
