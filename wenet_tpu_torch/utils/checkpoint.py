"""Checkpoints: save and load, and weights carried across from the JAX
package.

`save_checkpoint` / `load_checkpoint` are the counterparts of
wenet_tpu/utils/checkpoint.py's: the model's `state_dict` (torch.save)
with a YAML sidecar of infos (step, epoch, cv loss...), loaded back with
`strict=True`.

`state_dict_from_jax` turns the JAX package's variables (nested dicts of
arrays: 'params', 'cmvn' and, where present, 'batch_stats') into this
package's `state_dict`, whose keys are the reference wenet keys.  It
mirrors `flax_path_to_torch_key` and `_to_torch_leaf` of
wenet_tpu/utils/checkpoint.py for the modules this package has, without
importing them (that module imports jax)."""

import os
import re
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
import yaml

_LIST_SEG = re.compile(r'^(encoders|decoders)_(\d+)$')
_CONV_SEG = re.compile(r'^conv_(\d+)$')
_LEAF = {'kernel': 'weight', 'scale': 'weight', 'embedding': 'weight',
         'mean': 'running_mean', 'var': 'running_var'}


def _flatten(tree: Mapping, prefix=()) -> Iterator[Tuple[Tuple[str, ...],
                                                         Any]]:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flatten(val, prefix + (str(key),))
        else:
            yield prefix + (str(key),), val


def torch_key(path: Tuple[str, ...]) -> str:
    """('params', 'encoder', 'encoders_0', ...) -> 'encoder.encoders.0...'."""
    collection, *segs = path
    out = []
    for i, seg in enumerate(segs[:-1]):
        m = _LIST_SEG.match(seg)
        if m:
            out += [m.group(1), m.group(2)]
        elif _CONV_SEG.match(seg) and out[-1:] == ['embed']:
            # the subsampling Sequential interleaves ReLUs at odd indices
            out += ['conv', str(2 * int(seg.split('_')[1]))]
        elif seg == 'out' and out[-1:] == ['embed']:
            out += ['out', '0']
        elif seg == 'embed' and i > 0 and segs[i - 1] in (
                'decoder', 'left_decoder', 'right_decoder'):
            out += ['embed', '0']  # nn.Embedding inside the Sequential
        elif seg == 'pos_enc' and i > 0 and segs[i - 1] in (
                'decoder', 'left_decoder', 'right_decoder'):
            out += ['embed', '1']  # the learnable PE inside it (`pe`)
        else:
            out.append(seg)
    leaf = segs[-1]
    if collection != 'cmvn':
        leaf = _LEAF.get(leaf, leaf)
    return '.'.join(out + [leaf])


def _torch_layout(a: np.ndarray, leaf: str, key: str) -> np.ndarray:
    if leaf != 'kernel':
        return a
    if a.ndim == 2:
        a = a.T  # Dense (in, out) -> Linear (out, in)
        if 'pointwise_conv' in key:
            a = a[:, :, None]  # -> Conv1d (out, in, 1)
    elif a.ndim == 3:
        a = a.transpose(2, 1, 0)  # (K, in, out) -> Conv1d (out, in, K)
    elif a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)  # HWIO -> Conv2d OIHW
    return a


def state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX variables -> state dict for `load_state_dict(strict=True)`."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(variables):
        key = torch_key(path)
        arr = _torch_layout(np.asarray(leaf), path[-1], key)
        out[key] = torch.tensor(arr)
        if path[0] == 'batch_stats' and path[-1] == 'mean':
            # torch BatchNorm keeps a step count the JAX package has not
            out[key[:-len('running_mean')] + 'num_batches_tracked'] = (
                torch.tensor(0))
    return out


def _info_path(path: str) -> str:
    return re.sub(r'\.pt$', '', path) + '.yaml'


def save_checkpoint(model: torch.nn.Module, path: str,
                    infos: Optional[dict] = None) -> None:
    """Write `model.state_dict()` to `path` (e.g. step_1000.pt) and
    `infos` beside it (step_1000.yaml)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(model.state_dict(), path)
    with open(_info_path(path), 'w') as f:
        yaml.safe_dump(dict(infos or {}), f)


def load_checkpoint(model: torch.nn.Module, path: str) -> dict:
    """Load a `save_checkpoint` file into `model` (strict) -> its infos."""
    state = torch.load(path, map_location='cpu', weights_only=True)
    model.load_state_dict(state, strict=True)
    info_path = _info_path(path)
    if not os.path.exists(info_path):
        return {}
    with open(info_path) as f:
        return yaml.safe_load(f) or {}
