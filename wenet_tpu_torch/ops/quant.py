"""Weight-only int8 quantization for serving.  Counterpart of
wenet_tpu/ops/quant.py.

The JAX package quantizes every 2-D `kernel` or `embedding` leaf of at
least `_MIN_SIZE` elements (no conv kernels, biases or norms), symmetric,
with a float32 scale per output channel; its runner dequantizes inside
the jitted programs to the compute dtype.  The same tensors here are the
weights of nn.Linear, nn.Embedding and the pointwise Conv1d that the JAX
package holds as Dense kernels.  The scale follows the JAX layout:

- a flax kernel (in, out) is scaled over axis 0, once per output, so the
  torch Linear weight (out, in) (and pointwise Conv1d's (out, in, 1)) is
  scaled per row;
- a flax embedding (vocab, D) is scaled over axis 0 too, once per
  embedding dim, and so is torch's (vocab, D).

The rounding is round half to even in both packages, so the int8 tensors
and scales are equal bit for bit.  `quantize_model` stores each weight as
int8 with its scale and dequantizes it in the module's forward (a
parametrization of `weight`: int8 * scale, then the compute dtype); the
existing F.linear / F.embedding / conv then run as before."""

from typing import Dict, Tuple

import torch
from torch import nn
from torch.nn.utils import parametrize

from wenet_tpu_torch.utils.checkpoint import _POINTWISE_CONV1D

_MIN_SIZE = 4096  # the JAX package's: no tiny tensors (biases, norms)


def _scale_dims(name: str, m: nn.Module):
    """The dims of `m.weight` its scale reduces over, if the JAX package
    quantizes the tensor, else None."""
    w = getattr(m, 'weight', None)
    if not isinstance(w, torch.Tensor) or w.numel() < _MIN_SIZE:
        return None
    if isinstance(m, nn.Linear):
        return (1,)
    if isinstance(m, nn.Embedding):
        return (0,)
    if type(m) is nn.Conv1d and m.kernel_size == (1,) and m.groups == 1 \
            and _POINTWISE_CONV1D.search(name):
        return (1, 2)
    return None


def quantizable(model: nn.Module) -> Dict[str, Tuple[nn.Module, tuple]]:
    """{weight key: (module, the dims its scale reduces over)} of the
    tensors the JAX package quantizes."""
    out = {}
    for name, m in model.named_modules():
        if parametrize.is_parametrized(m, 'weight'):
            continue
        dims = _scale_dims(name, m)
        if dims is not None:
            out[f'{name}.weight' if name else 'weight'] = (m, dims)
    return out


def quantize_int8(w: torch.Tensor, dims) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """(int8 tensor, float32 scale) of `w`, on its device: the scale is
    max |w| over `dims` / 127 (at least 1e-10), as the JAX package's.
    Computed on the host, as the JAX package computes it in numpy: on the
    card a division by a Python scalar is a multiplication by its
    reciprocal, which rounds some scales otherwise."""
    wf = w.detach().float().cpu()
    scale = (wf.abs().amax(dim=dims, keepdim=True) / 127.0).clamp(min=1e-10)
    q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return q.to(w.device), scale.to(w.device)


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype=torch.bfloat16) -> torch.Tensor:
    """int8 * scale in float32, then `dtype` (the JAX `dequantize`)."""
    return (q.float() * scale).to(dtype)


class Int8Weight(nn.Module):
    """The parametrization `quantize_model` puts on a weight: its stored
    tensor is the int8 one; reading `weight` dequantizes it."""

    def __init__(self, scale: torch.Tensor, dtype: torch.dtype):
        super().__init__()
        self.register_buffer('scale', scale)
        self.dtype = dtype

    def forward(self, q: torch.Tensor) -> torch.Tensor:
        return dequantize(q, self.scale, self.dtype)


def quantize_model(model: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """Quantize `model` in place, from its float32 weights: each tensor of
    `quantizable` becomes int8 with a float32 scale, dequantized to `dtype`
    wherever it is read; every other floating parameter and buffer is cast
    to `dtype`, as the JAX runner's `dequantize` casts the rest.  Raises if
    a tensor the rule picks is not left int8."""
    targets = quantizable(model)
    quant = {k: quantize_int8(m.weight, dims)
             for k, (m, dims) in targets.items()}
    for k, (m, _) in targets.items():
        del m.weight
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            if t.is_floating_point():
                t.data = t.data.to(dtype)
    for k, (m, _) in targets.items():
        q, scale = quant[k]
        m.weight = nn.Parameter(q, requires_grad=False)
        parametrize.register_parametrization(
            m, 'weight', Int8Weight(scale, dtype), unsafe=True)
        if m.parametrizations.weight.original.dtype != torch.int8:
            raise RuntimeError(f'{k} did not stay int8')
    return model


def quantized_bytes(model: nn.Module) -> Tuple[int, int]:
    """(bytes of the float32 state, bytes with the quantizable tensors in
    int8), over the tensors the JAX package's variables hold (integer
    step counts left out), as its `quantized_bytes` counts them."""
    picked = set(quantizable(model))
    fp = q = 0
    for k, t in model.state_dict().items():
        if not t.is_floating_point():
            continue
        fp += t.numel() * 4
        q += t.numel() * (1 if k in picked else 4)
    return fp, q
