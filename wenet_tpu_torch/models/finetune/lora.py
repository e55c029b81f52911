"""LoRA fine-tuning.  Counterpart of wenet_tpu/models/finetune/lora.py
(`LoRADense`, `make_attention_dense`, `lora_param_mask` /
`mark_only_lora_as_trainable`, `merge_lora`).

`LoRALinear` is an `nn.Linear` with a rank-r update, so its state-dict
keys are the JAX `LoRADense`'s through `state_dict_from_jax`: `weight`,
`bias`, `lora_A` (r, in) and `lora_B` (out, r), the last two already in
torch layout.  Trainability is the parameters' `requires_grad` flag,
set before the optimizer is built (the JAX package masks the optax
transform instead).  The LoRA-GA probe (`estimate_gradient`,
`reinit_lora`) is not ported yet."""

from typing import Optional

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
