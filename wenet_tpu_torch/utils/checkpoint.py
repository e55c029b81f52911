"""Checkpoints: save and load, and weights carried across from the JAX
package.

`save_checkpoint` / `load_checkpoint` are the counterparts of
wenet_tpu/utils/checkpoint.py's: the model's `state_dict` (torch.save)
with a YAML sidecar of infos (step, epoch, cv loss...), loaded back with
`strict=True`.  `link_final` points a model directory's `final.pt` and
`final.yaml` at its newest epoch, as the JAX trainer's `final` link.
`load_checkpoint` also reads the reference layout that the JAX package's
`save_torch_checkpoint` writes (`final.pt`) and a TorchScript
`final.zip`; an orbax directory needs JAX and raises.
`find_checkpoint` and `load_model_dir` read a model directory
(train.yaml, the tokenizer's files, a final checkpoint), as the JAX
package's servers and `decoder_main` do.

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
# Dense kernels that are pointwise Conv1d in the reference: the conv
# modules' pointwise convs and Squeezeformer's time reduction
_POINTWISE_CONV1D = re.compile(
    r'pointwise_conv|time_reduction_layer\.pw_conv')
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
        elif seg in ('input_proj', 'channel_proj1'):
            # Sequential(Linear, act) in the reference (Squeezeformer's
            # front end, cgMLP)
            out += [seg, '0']
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
        if _POINTWISE_CONV1D.search(key):
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
    return re.sub(r'\.(pt|pth|bin|zip)$', '', path) + '.yaml'


def save_checkpoint(model, path: str, infos: Optional[dict] = None) -> None:
    """Write `model.state_dict()` (or `model`, a state dict) to `path`
    (e.g. step_1000.pt) and `infos` beside it (step_1000.yaml)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(model.state_dict() if isinstance(model, torch.nn.Module)
               else model, path)
    with open(_info_path(path), 'w') as f:
        yaml.safe_dump(dict(infos or {}), f)


def link_final(model_dir: str, name: str) -> None:
    """Make `final.pt` / `final.yaml` in `model_dir` symlinks to
    `name.pt` / `name.yaml`, replacing earlier links."""
    for ext in ('.pt', '.yaml'):
        final = os.path.join(model_dir, 'final' + ext)
        tmp = f'{final}.{os.getpid()}.tmp'
        os.symlink(name + ext, tmp)
        os.replace(tmp, final)


def load_checkpoint(model: torch.nn.Module, path: str) -> dict:
    """Load a checkpoint into `model` (strict) -> the infos beside it.

    `path` is a state dict (.pt, .pth, .bin: `save_checkpoint`'s, or the
    reference layout, with the JAX package's `module.` prefixes stripped
    and a `state_dict` key unwrapped, as its `load_checkpoint` does) or a
    TorchScript archive (.zip), read through its `state_dict()`.  Keys the
    reference persists that the port has no tensor for (sinusoidal `pe`
    tables, recomputed here) are dropped, BatchNorm step counts the
    JAX package does not write start at 0, and an (out, in) weight
    where the model has a pointwise Conv1d's (out, in, 1) gets its
    kernel axis."""
    if path.endswith('.zip'):
        state = torch.jit.load(path, map_location='cpu').state_dict()
    elif path.endswith(('.pt', '.pth', '.bin')):
        state = torch.load(path, map_location='cpu', weights_only=True)
    else:
        raise NotImplementedError(
            f'{path} is not a torch checkpoint: an orbax checkpoint needs '
            'JAX to read; write a final.pt from it with '
            'wenet_tpu.utils.checkpoint.save_torch_checkpoint')
    if 'state_dict' in state:
        state = state['state_dict']
    state = {k.removeprefix('module.'): v for k, v in state.items()}
    own = model.state_dict()
    state = {k: v for k, v in state.items()
             if k in own or not k.endswith('.pe')}
    for k in own:
        if k.endswith('num_batches_tracked') and k not in state:
            state[k] = torch.zeros_like(own[k])
        elif k in state and state[k].dim() == 2 and own[k].dim() == 3 \
                and tuple(state[k].shape) + (1,) == tuple(own[k].shape):
            # the JAX package's export keeps Squeezeformer's time
            # reduction pw_conv as its (out, in) Dense: the reference's
            # Conv1d has (out, in, 1)
            state[k] = state[k][:, :, None]
    model.load_state_dict(state, strict=True)
    info_path = _info_path(path)
    if not os.path.exists(info_path):
        return {}
    with open(info_path) as f:
        return yaml.safe_load(f) or {}


def find_checkpoint(model_dir: str) -> str:
    """The model directory's final checkpoint: `final` (orbax), `final.pt`
    or `final.zip`, the first that exists."""
    for cand in ('final', 'final.pt', 'final.zip'):
        p = os.path.join(model_dir, cand)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f'no checkpoint (final*) in {model_dir}')


def load_model(configs: dict, path: str, device='cuda'):
    """The model of `configs` (with `input_dim` and `output_dim` set) on
    `device`, in eval mode, with the checkpoint at `path` loaded."""
    from wenet_tpu_torch.utils.init_model import init_model
    model = init_model(configs, device='meta')
    model.to_empty(device=device)
    load_checkpoint(model, path)
    return model.eval()


def load_model_dir(model_dir: str, device='cuda'):
    """A model directory -> (model on `device` in eval mode, configs with
    `input_dim` and `output_dim` set, tokenizer).

    The cmvn stats are the checkpoint's `encoder.global_cmvn` buffers.
    `cmvn_conf.cmvn_file` is not read: it is relative to the recipe and
    absent from a model directory, and where the JAX package does find it
    the checkpoint overwrites what it read, so the stats are the same."""
    from wenet_tpu_torch.utils.config import load_config
    from wenet_tpu_torch.utils.init_tokenizer import init_tokenizer
    configs = load_config(os.path.join(model_dir, 'train.yaml'))
    tokenizer = init_tokenizer(configs)
    configs.setdefault('input_dim', configs.get('dataset_conf', {}).get(
        'fbank_conf', {}).get('num_mel_bins', 80))
    configs.setdefault('output_dim', tokenizer.vocab_size())
    return (load_model(configs, find_checkpoint(model_dir), device),
            configs, tokenizer)
