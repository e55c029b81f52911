"""Training layer: optimizer, schedule, train and cv steps.  Counterpart of
wenet_tpu/utils/train_utils.py.

The JAX package's optax chain, MultiSteps(clip_by_global_norm(grad_clip),
adam/adamw/sgd scaled by the schedule), becomes a torch optimizer plus
`apply_gradients`, which keeps its order: accumulate micro-step gradients
as a running mean, clip their global norm, set the lr of this update,
step.  The schedule advances once per update, so with accum_grad > 1 the
step count (micro-steps) and the update count differ, as there.

Over several ranks the step takes a `TrainLayout` (parallel/mesh.py): it
calls the layout's DDP module, which averages the gradients over `data`
after every micro-step's backward (so the running mean of an
accumulation window is the global one), clips by the whole model's norm
(a sharded tensor's squares summed over `model`), and reports the
losses' mean over `data`; `zero2` builds the optimizer as a
ZeroRedundancyOptimizer over `data`.

With the on-device front end (`frontend_conf_of`, `make_frontend`) the
batches carry waveforms and the step computes fbank, SpecAugment and
SpecSub first, on the batch's device."""

import contextlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from wenet_tpu_torch.parallel.mesh import rank_seed
from wenet_tpu_torch.utils.scheduler import build_schedule


class TrainState:
    """The training state: `step` counts micro-steps, `updates` the
    optimizer updates (the schedule's position) and `micro` the position
    in the accumulation window in progress, whose gradients' running mean
    `acc_grads` holds (None between updates).  As optax's MultiSteps
    keeps `gradient_step` and `mini_step`, the two counters are state of
    their own: after a resume they are not `step // accum_grad` and
    `step % accum_grad`."""

    def __init__(self, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer, step: int = 0):
        self.step = step
        self.updates = 0
        self.micro = 0
        self.model = model
        self.optimizer = optimizer
        self.acc_grads: Optional[List[torch.Tensor]] = None


def init_optimizer_and_scheduler(configs: dict, model: torch.nn.Module,
                                 zero_group=None
                                 ) -> Tuple[torch.optim.Optimizer,
                                            Callable[[int], float]]:
    """From train.yaml optim/optim_conf/scheduler/scheduler_conf.  adam
    folds weight decay into the gradient (L2, as optax's
    add_decayed_weights before scale_by_adam); adamw decouples it.  With
    `zero_group` (a layout's `zero_group()`), the optimizer is a
    ZeroRedundancyOptimizer over that group: each rank keeps the moments
    of its part of the parameters (zero2)."""
    optim_conf = dict(configs.get('optim_conf', {'lr': 0.001}))
    lr = optim_conf.get('lr', 0.001)
    schedule = build_schedule(configs.get('scheduler', 'warmuplr'),
                              configs.get('scheduler_conf', {}), lr)
    optim = configs.get('optim', 'adam')
    wd = optim_conf.get('weight_decay', 0.0)
    betas = tuple(optim_conf.get('betas', (0.9, 0.999)))
    eps = optim_conf.get('eps', 1e-8)
    params = [p for p in model.parameters() if p.requires_grad]
    if optim in ('adam', 'adamw'):
        cls = torch.optim.Adam if optim == 'adam' else torch.optim.AdamW
        kw = dict(lr=lr, betas=betas, eps=eps, weight_decay=wd)
    elif optim == 'sgd':
        cls = torch.optim.SGD
        kw = dict(lr=lr, momentum=optim_conf.get('momentum', 0.9))
    else:
        raise ValueError(f'unknown optim: {optim}')
    if zero_group is None:
        return cls(params, **kw), schedule
    from torch.distributed.optim import ZeroRedundancyOptimizer
    return ZeroRedundancyOptimizer(params, optimizer_class=cls,
                                   process_group=zero_group, **kw), schedule


def restore_optimizer_step(state: TrainState, step: int,
                           accum_grad: int = 1) -> TrainState:
    """Resume at `step` micro-steps, as the JAX package's
    `restore_optimizer_step` does: the update counter, which the lr
    reads, is set to `step // accum_grad` once and then moves by one per
    update; the accumulation window restarts at `step` (micro 0).  The
    optimizer's moments start afresh."""
    state.step = step
    state.updates = step // max(accum_grad, 1)
    state.micro = 0
    state.acc_grads = None
    return state


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm).
    Squares are summed with `sum`, whose CPU kernel accumulates in blocks:
    `vector_norm` on the CPU drifts by 2.6e-4 relative over a
    (51866, 1280) fp32 tensor (whisper's embedding gradient), enough to
    move the clip scale."""
    return torch.stack([t.float().square().sum() for t in tensors]).sum(
        ).sqrt()


def apply_gradients(state: TrainState, schedule: Callable[[int], float],
                    grad_clip: float = 0.0, accum_grad: int = 1,
                    layout=None) -> Tuple[torch.Tensor, float]:
    """One micro-step of the update from each parameter's `.grad` (None
    counts as zero).  Every `accum_grad`-th call clips the mean gradient
    of the window to global norm `grad_clip` (no epsilon, as optax),
    sets the lr to schedule(`state.updates`) and steps the optimizer.
    The norms are `layout`'s (the whole model's) when given.
    -> (global norm of this micro-step's gradients, lr)."""
    opt = state.optimizer
    params = [p for group in opt.param_groups for p in group['params']]
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in params]

    def norm(gs):
        return global_norm(gs) if layout is None else \
            layout.global_norm(params, gs)

    grad_norm = norm(grads)
    lr = schedule(state.updates)
    micro = state.micro
    state.step += 1
    if accum_grad > 1:
        if micro == 0:
            state.acc_grads = [torch.zeros_like(g) for g in grads]
        for acc, g in zip(state.acc_grads, grads):
            acc.add_((g - acc) / (micro + 1))  # running mean, as MultiSteps
        if micro < accum_grad - 1:
            state.micro = micro + 1
            return grad_norm, lr
        grads, state.acc_grads = state.acc_grads, None
    state.micro = 0
    state.updates += 1
    if grad_clip > 0:
        total = grad_norm if accum_grad == 1 else norm(grads)
        scale = torch.where(total < grad_clip, 1.0, grad_clip / total)
        for g in grads:
            g.mul_(scale)
    for p, g in zip(params, grads):
        p.grad = g
    for group in opt.param_groups:
        group['lr'] = lr
    opt.step()
    return grad_norm, lr


def step_seeds(seed: int, epoch: int, step: int) -> Tuple[int, int]:
    """(device seed, host seed) of one train step, a pure function of
    (seed, epoch, step): the analogue of fold_in(PRNGKey(seed + epoch),
    step), so a run is reproducible and a resumed run draws as the
    original did."""
    device_seed, host_seed = np.random.SeedSequence(
        [seed, epoch, step]).generate_state(2)
    return int(device_seed), int(host_seed)


# the keys of spec_aug_conf the on-device SpecAugment takes (no time warp)
SPEC_AUG_KEYS = ('num_t_mask', 'num_f_mask', 'max_t', 'max_f')


def frontend_conf_of(dataset_conf: dict) -> Optional[dict]:
    """The on-device front end's settings from a yaml's `dataset_conf`, as
    the JAX trainer reads them (bin/train.py:189-202): fbank_conf, the
    resample rate, spec_aug / spec_sub with their confs (spec_aug_conf
    without its time-warp keys); None without `on_device_frontend`."""
    dc = dataset_conf
    if not dc.get('on_device_frontend', False):
        return None
    return dict(dc.get('fbank_conf', {}),
                sample_rate=dc.get('resample_conf', {}).get(
                    'resample_rate', 16000),
                spec_aug=dc.get('spec_aug', True),
                spec_aug_conf={k: v for k, v in
                               dc.get('spec_aug_conf', {}).items()
                               if k in SPEC_AUG_KEYS},
                spec_sub=dc.get('spec_sub', False),
                spec_sub_conf=dict(dc.get('spec_sub_conf', {})))


def make_frontend(frontend_conf: dict):
    """The train step's front end (the JAX `_frontend`,
    train_utils.py:142-173) -> frontend(batch, generator, dither_seed=None,
    draws=None) -> batch with 'feats' the fbank (B, T, mel) and
    'feats_lengths' in frames.

    batch['feats'] holds the waveforms (B, S, 1) on the device and
    'feats_lengths' their samples.  In this order: the waveform times
    2^15, the kaldi fbank on its device (`ops/fbank.py`, fp32 out; dither
    from a generator of that device seeded with `dither_seed`), lengths
    max((n - frame_length) // frame_shift + 1, 0), then SpecAugment and
    SpecSub with their draws from the host `generator` (or `draws`,
    {'spec_aug': ..., 'spec_sub': ...}, which replace them)."""
    from wenet_tpu_torch.ops.fbank import compute_fbank
    from wenet_tpu_torch.ops.spec_augment import (spec_aug_apply,
                                                  spec_aug_draws,
                                                  spec_sub_apply,
                                                  spec_sub_draws)
    fc = frontend_conf
    sr = fc.get('sample_rate', 16000)
    shift = sr * fc.get('frame_shift', 10) // 1000
    flen = sr * fc.get('frame_length', 25) // 1000
    dither = fc.get('dither', 0.0)

    def frontend(batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator],
                 dither_seed: Optional[int] = None,
                 draws: Optional[dict] = None) -> Dict[str, torch.Tensor]:
        wav = batch['feats'][..., 0].float()
        device_gen = None
        if dither:
            device_gen = torch.Generator(wav.device)
            device_gen.manual_seed(0 if dither_seed is None else dither_seed)
        feats = compute_fbank(
            wav * (1 << 15), num_mel_bins=fc.get('num_mel_bins', 80),
            frame_length_ms=fc.get('frame_length', 25),
            frame_shift_ms=fc.get('frame_shift', 10), sample_rate=sr,
            dither=dither, generator=device_gen)
        lengths = torch.clamp((batch['feats_lengths'] - flen) // shift + 1,
                              min=0)
        B, T, F = feats.shape
        if fc.get('spec_aug', True):
            d = draws['spec_aug'] if draws else spec_aug_draws(
                B, T, F, generator=generator, **fc.get('spec_aug_conf', {}))
            feats = spec_aug_apply(feats, d)
        if fc.get('spec_sub', False):
            d = draws['spec_sub'] if draws else spec_sub_draws(
                B, T, generator=generator, **fc.get('spec_sub_conf', {}))
            feats = spec_sub_apply(feats, d)
        return dict(batch, feats=feats, feats_lengths=lengths)

    return frontend


def frontend_seed(seed: int, epoch: int, step: int) -> int:
    """The on-device front end's host seed of one step: the third word of
    `step_seeds`' stream."""
    return int(np.random.SeedSequence([seed, epoch, step]).generate_state(
        3)[2])


def make_train_step(model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer,
                    schedule: Callable[[int], float],
                    dtype: Optional[torch.dtype] = None,
                    accum_grad: int = 1, grad_clip: float = 0.0,
                    layout=None, frontend_conf: Optional[dict] = None):
    """Build the train step: (state, batch, (seed, epoch)) -> (state,
    metrics).

    batch: dict of device tensors feats (B, T, F), feats_lengths (B,),
    target (B, L) IGNORE_ID padded, target_lengths (B,).  Each step seeds
    the device RNG (nn.Dropout) and a host generator (the dynamic-chunk
    draw and the rel-pos attention dropout seeds) from (seed, epoch,
    state.step).  dtype=torch.bfloat16 runs forward and backward under
    autocast; params, grads and optimizer state stay fp32.  metrics:
    every value of the model's dict that is not None (loss, loss_att,
    loss_ctc, a transducer's loss_rnnt, an SSL model's codes_acc,
    features_l2, ...), th_accuracy and grad_norm as device tensors (no
    host sync), and lr as a float.

    With `layout` (parallel/mesh.py `TrainLayout`) the step runs the
    layout's module inside its context: the host generator is seeded
    alike on every rank (one dynamic-chunk draw for the global batch, as
    the JAX package draws), the device seed and the attention-dropout
    seeds are each data rank's own (`rank_seed`), and the losses in the
    metrics are their mean over `data`.

    With `frontend_conf` (`frontend_conf_of`) the batch carries waveforms
    and the step first runs `make_frontend`'s front end in fp32, outside
    autocast, its draws from a host generator of its own (seeded from
    (seed, epoch, state.step), the data rank's own) and its dither from
    the device seed."""
    device_type = next(model.parameters()).device.type
    net = model if layout is None else layout.module
    frontend = None if frontend_conf is None else make_frontend(frontend_conf)

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor],
                rng: Tuple[int, int]):
        device_seed, host_seed = step_seeds(*rng, state.step)
        generator = torch.Generator().manual_seed(host_seed)
        net.train()
        optimizer.zero_grad(set_to_none=True)
        with contextlib.ExitStack() as stack:
            if layout is not None:
                stack.enter_context(layout.context())
            torch.manual_seed(rank_seed(device_seed))
            if frontend is not None:
                batch = frontend(batch, torch.Generator().manual_seed(
                    rank_seed(frontend_seed(*rng, state.step))),
                    rank_seed(device_seed))
            with torch.autocast(device_type, dtype=dtype,
                                enabled=dtype is not None):
                out = net(batch['feats'], batch['feats_lengths'],
                          batch['target'], batch['target_lengths'],
                          generator=generator)
            out['loss'].backward()
        grad_norm, lr = apply_gradients(state, schedule, grad_clip,
                                        accum_grad, layout)
        metrics = {k: v.detach() for k, v in out.items() if v is not None}
        if layout is not None:
            metrics = layout.mean_over_data(metrics)
        metrics.update(grad_norm=grad_norm, lr=lr)
        return state, metrics

    return step_fn


def make_cv_step(model: torch.nn.Module):
    """(state, batch) -> (loss dict, number of utterances), in eval mode
    with full context and no dropout."""

    @torch.no_grad()
    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor]):
        was_training = model.training
        model.eval()
        try:
            out = model(batch['feats'], batch['feats_lengths'],
                        batch['target'], batch['target_lengths'])
        finally:
            model.train(was_training)
        return ({k: v for k, v in out.items() if v is not None},
                batch['target_lengths'].shape[0])

    return step_fn
