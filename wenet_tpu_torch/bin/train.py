"""Train a model from data lists.  Counterpart of wenet_tpu/bin/train.py,
on the card unless --device cpu:

    python -m wenet_tpu_torch.bin.train --config train.yaml \\
        --train_data data/train/data.list --cv_data data/dev/data.list \\
        --model_dir exp/u2pp --device cuda

and on several cards, one rank each, under torchrun:

    torchrun --nproc_per_node 8 -m wenet_tpu_torch.bin.train \\
        --config train.yaml ... --mesh data=4,model=2

--mesh (data=N,model=M; -1 fills; no mesh is every rank on `data`) and
the yaml's `sharding_conf` ({model_axis, zero2, min_dim}) choose the
layout (parallel/mesh.py); the mesh must span WORLD_SIZE ranks.  Each
data rank reads its shard of the train list, every rank the whole cv
list; rank 0 logs and writes.  The ranks rendezvous through torchrun's
environment (--init_method env://), NCCL on the card and gloo on the
CPU (--dist_backend gloo also runs several ranks on one card).
JAX_COORDINATOR, the JAX package's launcher variable, raises.

Each epoch trains through the `Dataset` pipeline, runs cv, writes
`epoch_{n}.pt` with `epoch_{n}.yaml` (epoch, step, tag, cv_loss,
save_time) and points `final.pt` / `final.yaml` at it.  --checkpoint
loads weights (after the global cmvn stats of `cmvn_conf.cmvn_file`) and
resumes at the epoch after its `epoch`, at its `step`; a checkpoint
without LoRA factors (models/whisper/convert.py's, for a `lora_conf`
yaml such as examples/aishell/whisper/conf/finetune_whisper_largev3.yaml)
leaves them at their initial values.  `dtype: bf16` trains under bf16
autocast.  `dataset_conf.on_device_frontend` batches waveforms and computes
fbank, SpecAugment and SpecSub in the train step on the card
(`make_frontend`); cv reads host features.

`dataset: ssl` (the BEST-RQ, wav2vec 2.0 and W2V-BERT yamls, e.g.
examples/librispeech/ssl/conf/train_bestrq.yaml) pretrains on a
wav-only data list: no tokenizer, entries without `txt`, output_dim 1.

Beside the JAX trainer's flags it takes --device.  --tensorboard_dir has
no default: a SummaryWriter is made only when it is given and tensorboard
imports.  --prng_impl (a TPU workaround) and --no_flash_train (rel-pos
attention has no path on the card but its kernels) are not taken, nor is
--num_workers, which the JAX trainer ignores."""

import argparse
import datetime
import logging
import os
import time
import types

import torch
import torch.distributed as dist

from wenet_tpu_torch.dataset.dataset import Dataset
from wenet_tpu_torch.parallel.mesh import (TrainLayout, TrainMesh,
                                           init_distributed, parse_mesh)
from wenet_tpu_torch.utils.checkpoint import link_final, load_checkpoint
from wenet_tpu_torch.utils.config import load_config, save_config
from wenet_tpu_torch.utils.executor import Executor
from wenet_tpu_torch.utils.init_model import init_model
from wenet_tpu_torch.utils.init_tokenizer import init_tokenizer
from wenet_tpu_torch.utils.train_utils import (TrainState, frontend_conf_of,
                                               init_optimizer_and_scheduler,
                                               make_cv_step, make_train_step,
                                               restore_optimizer_step)


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description='train a model')
    p.add_argument('--config', required=True)
    p.add_argument('--train_data', required=True)
    p.add_argument('--cv_data', required=True)
    p.add_argument('--data_type', default='raw', choices=['raw', 'shard'])
    p.add_argument('--model_dir', required=True)
    p.add_argument('--checkpoint', default=None)
    p.add_argument('--tensorboard_dir', default=None)
    p.add_argument('--override_config', action='append', default=[])
    p.add_argument('--mesh', default=None,
                   help='e.g. data=8 or data=4,model=2 over WORLD_SIZE '
                        'ranks (default: every rank on data)')
    p.add_argument('--dist_backend', default=None, choices=['nccl', 'gloo'],
                   help='default: nccl on the card, gloo on the CPU')
    p.add_argument('--init_method', default='env://',
                   help='the ranks\' rendezvous (torchrun sets env://)')
    p.add_argument('--prefetch', type=int, default=2,
                   help='batches the pipeline thread runs ahead')
    p.add_argument('--seed', type=int, default=777)
    p.add_argument('--profile_dir', default=None,
                   help='write a torch.profiler Chrome trace of '
                        '--profile_steps steps of the first epoch')
    p.add_argument('--profile_start_step', type=int, default=10)
    p.add_argument('--profile_steps', type=int, default=5)
    p.add_argument('--device', default='cuda')
    return p


def datasets(args, configs, tokenizer, num_shards=1, shard_id=0):
    """(train, cv) pipelines: train sharded `num_shards` ways (this data
    rank's `shard_id`), cv without speed perturb, SpecAugment, SpecSub,
    SpecTrim or shuffles, one cycle, replicated, on host features also
    where the train set carries waveforms (`on_device_frontend`)."""
    train_conf = dict(configs['dataset_conf'], prefetch=args.prefetch)
    cv_conf = dict(train_conf, speed_perturb=False, spec_aug=False,
                   spec_sub=False, spec_trim=False, shuffle=False,
                   list_shuffle=False, cycle=1, on_device_frontend=False)
    train = Dataset(args.data_type, args.train_data, tokenizer, train_conf,
                    partition=True, num_shards=num_shards,
                    shard_id=shard_id, seed=args.seed)
    cv = Dataset(args.data_type, args.cv_data, tokenizer, cv_conf,
                 partition=False, seed=args.seed)
    return train, cv


def build(args) -> types.SimpleNamespace:
    """Everything `main` trains with: configs (with input_dim, output_dim,
    seed and init_infos set), tokenizer, the train and cv pipelines, the
    model on this rank's device (cmvn stats, then --checkpoint, loaded,
    then laid out over the mesh), its optimizer, schedule, TrainState and
    train and cv steps, and the layout.  Joins the ranks' group when
    WORLD_SIZE > 1."""
    configs = load_config(args.config, args.override_config)
    mesh_shape = parse_mesh(args.mesh)
    ranks = init_distributed(args.device, args.dist_backend,
                             args.init_method)
    mesh = TrainMesh(ranks, mesh_shape)
    configs['seed'] = args.seed
    dataset_type = configs.get('dataset', 'asr')
    if dataset_type not in ('asr', 'ssl'):
        raise ValueError(f'unknown dataset: {dataset_type}')
    # `dataset: ssl` pretrains on untranscribed audio: no tokenizer, data
    # list entries with no txt
    tokenizer = None if dataset_type == 'ssl' else init_tokenizer(configs)
    dc = configs['dataset_conf']
    configs['input_dim'] = dc.get('fbank_conf', dc.get(
        'mfcc_conf', dc.get('log_mel_spectrogram_conf', {}))).get(
            'num_mel_bins', 80)
    if 'lfr_conf' in configs:
        # the model's input is the LFR features: mel bins x lfr_m
        configs['input_dim'] *= configs['lfr_conf'].get('lfr_m', 7)
    if tokenizer is not None:
        configs['output_dim'] = tokenizer.vocab_size()
    else:
        configs.setdefault('output_dim', 1)  # the SSL heads do not read it
    train_dataset, cv_dataset = datasets(args, configs, tokenizer,
                                         mesh.data, mesh.data_rank)

    device = ranks.device
    model = init_model(configs,
                       torch.Generator(device).manual_seed(args.seed),
                       device=device)
    cmvn_file = configs.get('cmvn_conf', {}).get('cmvn_file')
    if configs.get('cmvn') == 'global_cmvn' and cmvn_file:
        # relative to the working directory, as in the JAX trainer
        from wenet_tpu_torch.utils.cmvn import load_cmvn
        mean, istd = load_cmvn(cmvn_file, configs['cmvn_conf'].get(
            'is_json_cmvn', True))
        # the encoder's, or the model's (SenseVoice: after LFR)
        cmvn = getattr(model.encoder, 'global_cmvn', None)
        if cmvn is None:
            cmvn = model.global_cmvn
        with torch.no_grad():
            cmvn.mean.copy_(torch.from_numpy(mean))
            cmvn.istd.copy_(torch.from_numpy(istd))
    infos = {}
    if args.checkpoint is not None:
        infos = load_checkpoint(model, args.checkpoint,
                                lora_from_init=True)
    configs['init_infos'] = infos
    # every rank holds the whole model here and takes its shards now
    layout = TrainLayout(mesh, model, configs.get('sharding_conf'))

    accum = max(int(configs.get('accum_grad', 1)), 1)
    optimizer, schedule = init_optimizer_and_scheduler(
        configs, model, layout.zero_group())
    state = TrainState(model, optimizer)
    step = int(infos.get('step', 0))
    if step > 0:
        state = restore_optimizer_step(state, step, accum)
    dtype = {'bf16': torch.bfloat16}.get(configs.get('dtype', 'fp32'))
    train_step = make_train_step(model, optimizer, schedule, dtype, accum,
                                 configs.get('grad_clip', 0.0), layout,
                                 frontend_conf_of(dc))
    return types.SimpleNamespace(
        configs=configs, tokenizer=tokenizer, train_dataset=train_dataset,
        cv_dataset=cv_dataset, model=model, optimizer=optimizer,
        schedule=schedule, state=state, train_step=train_step,
        cv_step=make_cv_step(model), device=device, layout=layout)


def _summary_writer(tensorboard_dir, model_dir):
    if not tensorboard_dir:
        return None
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        logging.warning('tensorboard does not import: no summaries')
        return None
    return SummaryWriter(os.path.join(tensorboard_dir,
                                      os.path.basename(model_dir)))


def _frame_seconds(dataset_conf: dict) -> float:
    """Seconds of audio per feature frame (per sample with the on-device
    front end: the train batches' lengths are samples)."""
    rate = dataset_conf.get('resample_conf', {}).get('resample_rate', 16000)
    if dataset_conf.get('on_device_frontend', False):
        return 1.0 / rate
    if dataset_conf.get('feats_type', 'fbank') == 'log_mel_spectrogram':
        conf = dataset_conf.get('log_mel_spectrogram_conf', {})
        return conf.get('hop_length', 160) / rate
    conf = dataset_conf.get('fbank_conf', dataset_conf.get('mfcc_conf', {}))
    return conf.get('frame_shift', 10) / 1000


def main(argv=None, on_step=None) -> dict:
    """Train; -> a summary: per epoch its steps, train seconds (the
    profiler's start and trace writing left out), audio seconds, data
    wait, profiler seconds, cv loss, cv and checkpoint-save seconds; the
    profiler trace written, if any.  `on_step` is given each train step's
    record (`Executor`).  Over several ranks each rank returns its own
    summary and leaves the group at the end."""
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format='%(asctime)s %(levelname)s %(message)s')
    run = build(args)
    try:
        return _train(args, run, on_step)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _train(args, run, on_step) -> dict:
    configs, state = run.configs, run.state
    main_rank = run.layout.is_main
    writer = None
    if main_rank:
        os.makedirs(args.model_dir, exist_ok=True)
        save_config(configs, os.path.join(args.model_dir, 'train.yaml'))
        writer = _summary_writer(args.tensorboard_dir, args.model_dir)
    infos = configs['init_infos']
    executor = Executor(global_step=int(infos.get('step', 0)),
                        device=run.device, on_step=on_step,
                        layout=run.layout)
    if args.profile_dir and main_rank:
        configs['profile'] = dict(dir=args.profile_dir,
                                  start=args.profile_start_step,
                                  steps=args.profile_steps)
    frame_s = _frame_seconds(configs['dataset_conf'])
    log = logging.info if main_rank else (lambda *_: None)
    epochs = []
    for epoch in range(int(infos.get('epoch', -1)) + 1,
                       configs.get('max_epoch', 100)):
        configs['epoch'] = epoch
        run.train_dataset.set_epoch(epoch)
        log('Epoch %d TRAIN info lr %s', epoch,
                     run.schedule(state.updates))
        t0 = time.perf_counter()
        state = executor.train(run.train_step, state, run.train_dataset,
                               run.cv_dataset, run.cv_step, writer, configs,
                               model_dir=args.model_dir)
        totals = executor.totals
        train_s = time.perf_counter() - t0 - totals['profile_seconds']
        audio_s = frame_s * totals['audio_frames']
        steps, wait_s = totals['steps'], totals['data_wait']
        log('Epoch %d TRAIN %d steps in %.3f s: %.3f steps/s, '
                     '%.1f audio-s/s, %.3f s waiting on data', epoch,
                     steps, train_s, steps / train_s, audio_s / train_s,
                     wait_s)
        t0 = time.perf_counter()
        loss_dict = executor.cv(run.cv_step, state, run.cv_dataset)
        cv_s = time.perf_counter() - t0
        log('Epoch %d CV info %s', epoch, loss_dict)
        t0 = time.perf_counter()
        name = f'epoch_{epoch}'
        executor.save(run.model, os.path.join(args.model_dir, name + '.pt'),
                      dict(epoch=epoch, step=state.step, tag=name,
                           cv_loss=float(loss_dict.get('loss', 0.0)),
                           save_time=datetime.datetime.now().strftime(
                               '%d/%m/%Y %H:%M:%S')))
        if main_rank:
            link_final(args.model_dir, name)
        epochs.append(dict(epoch=epoch, steps=steps,
                           train_seconds=train_s, audio_seconds=audio_s,
                           data_wait_seconds=wait_s,
                           profile_seconds=totals['profile_seconds'],
                           cv=loss_dict,
                           cv_seconds=cv_s,
                           save_seconds=time.perf_counter() - t0))
    if writer is not None:
        writer.close()
    return dict(epochs=epochs, profile_trace=executor.profile_trace)


if __name__ == '__main__':
    main()
