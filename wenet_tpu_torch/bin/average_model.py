"""Average the weights of a training run's checkpoints.  Counterpart of
wenet_tpu/bin/average_model.py for the port's `.pt` checkpoints:

    python -m wenet_tpu_torch.bin.average_model --src_path exp/u2pp \\
        --dst_model exp/u2pp/avg_5.pt --num 5 --val_best

Candidates are the `*.pt` files of --src_path with a `.yaml` of infos
beside them, except `final*` and `avg*`, whose `epoch` lies in
[--min_epoch, --max_epoch].  The --num best by `cv_loss` (--val_best) or
else the --num newest by epoch are summed in float64 and divided; tensors
that are not floating point (BatchNorm step counts) come from the first.
The average is written as a state dict with `averaged_from` in its infos."""

import argparse
import glob
import os
from typing import List

import torch
import yaml

from wenet_tpu_torch.utils.checkpoint import save_checkpoint


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description='average model')
    p.add_argument('--dst_model', required=True)
    p.add_argument('--src_path', required=True,
                   help='the model directory with epoch_*.pt / step_*.pt')
    p.add_argument('--val_best', action='store_true')
    p.add_argument('--num', default=5, type=int)
    p.add_argument('--min_epoch', default=0, type=int)
    p.add_argument('--max_epoch', default=65536, type=int)
    return p


def list_checkpoints(src_path: str, val_best: bool, num: int,
                     min_epoch: int, max_epoch: int) -> List[str]:
    cands = []
    for path in glob.glob(os.path.join(src_path, '*.pt')):
        name = os.path.basename(path)
        info = path[:-len('.pt')] + '.yaml'
        # final.pt links to the newest epoch: counting it would weigh
        # that epoch twice
        if name.startswith(('final', 'avg')) or not os.path.exists(info):
            continue
        with open(info) as f:
            meta = yaml.safe_load(f) or {}
        epoch = meta.get('epoch', -1)
        if min_epoch <= epoch <= max_epoch:
            cands.append((meta.get('cv_loss', float('inf')), epoch, path))
    if val_best:
        cands.sort(key=lambda c: c[0])
    else:
        cands.sort(key=lambda c: -c[1])
    return [c[2] for c in cands[:num]]


def average(paths: List[str]) -> dict:
    acc = None
    for path in paths:
        state = torch.load(path, map_location='cpu', weights_only=True)
        if acc is None:
            acc = {k: v.double() if v.is_floating_point() else v.clone()
                   for k, v in state.items()}
        else:
            for k, v in state.items():
                if v.is_floating_point():
                    acc[k] += v.double()
    return {k: (v / len(paths)).float() if v.is_floating_point() else v
            for k, v in acc.items()}


def main(argv=None) -> List[str]:
    """-> the checkpoints averaged."""
    args = get_parser().parse_args(argv)
    paths = list_checkpoints(args.src_path, args.val_best, args.num,
                             args.min_epoch, args.max_epoch)
    if not paths:
        raise SystemExit(f'no checkpoints to average in {args.src_path}')
    print('averaging:', paths)
    save_checkpoint(average(paths), args.dst_model,
                    {'averaged_from': [os.path.basename(p) for p in paths]})
    return paths


if __name__ == '__main__':
    main()
