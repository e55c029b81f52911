"""Training layer: optimizer, schedule, train and cv steps.  Counterpart of
wenet_tpu/utils/train_utils.py on one device.

The JAX package's optax chain, MultiSteps(clip_by_global_norm(grad_clip),
adam/adamw/sgd scaled by the schedule), becomes a torch optimizer plus
`apply_gradients`, which keeps its order: accumulate micro-step gradients
as a running mean, clip their global norm, set the lr of this update,
step.  The schedule advances once per update, so with accum_grad > 1 the
step count (micro-steps) and the update count differ, as there."""

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from wenet_tpu_torch.utils.scheduler import build_schedule


class TrainState:
    """The training state: `step` counts micro-steps; `acc_grads` holds
    the running mean of the gradients of the accumulation window in
    progress (None between updates)."""

    def __init__(self, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer, step: int = 0):
        self.step = step
        self.model = model
        self.optimizer = optimizer
        self.acc_grads: Optional[List[torch.Tensor]] = None


def init_optimizer_and_scheduler(configs: dict, model: torch.nn.Module
                                 ) -> Tuple[torch.optim.Optimizer,
                                            Callable[[int], float]]:
    """From train.yaml optim/optim_conf/scheduler/scheduler_conf.  adam
    folds weight decay into the gradient (L2, as optax's
    add_decayed_weights before scale_by_adam); adamw decouples it."""
    optim_conf = dict(configs.get('optim_conf', {'lr': 0.001}))
    lr = optim_conf.get('lr', 0.001)
    schedule = build_schedule(configs.get('scheduler', 'warmuplr'),
                              configs.get('scheduler_conf', {}), lr)
    optim = configs.get('optim', 'adam')
    wd = optim_conf.get('weight_decay', 0.0)
    betas = tuple(optim_conf.get('betas', (0.9, 0.999)))
    eps = optim_conf.get('eps', 1e-8)
    params = [p for p in model.parameters() if p.requires_grad]
    if optim == 'adam':
        opt = torch.optim.Adam(params, lr=lr, betas=betas, eps=eps,
                               weight_decay=wd)
    elif optim == 'adamw':
        opt = torch.optim.AdamW(params, lr=lr, betas=betas, eps=eps,
                                weight_decay=wd)
    elif optim == 'sgd':
        opt = torch.optim.SGD(params, lr=lr,
                              momentum=optim_conf.get('momentum', 0.9))
    else:
        raise ValueError(f'unknown optim: {optim}')
    return opt, schedule


def restore_optimizer_step(state: TrainState, step: int) -> TrainState:
    """Resume at `step` micro-steps: the lr resumes mid-schedule (it is
    read from the step count), and the accumulation window restarts.  As
    in the JAX package, the optimizer's moments start afresh."""
    state.step = step
    state.acc_grads = None
    return state


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]))


def apply_gradients(state: TrainState, schedule: Callable[[int], float],
                    grad_clip: float = 0.0, accum_grad: int = 1
                    ) -> Tuple[torch.Tensor, float]:
    """One micro-step of the update from each parameter's `.grad` (None
    counts as zero).  Every `accum_grad`-th call clips the mean gradient
    of the window to global norm `grad_clip` (no epsilon, as optax),
    sets the lr to schedule(update index) and steps the optimizer.
    -> (global norm of this micro-step's gradients, lr)."""
    opt = state.optimizer
    params = [p for group in opt.param_groups for p in group['params']]
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in params]
    grad_norm = global_norm(grads)
    lr = schedule(state.step // accum_grad)
    micro = state.step % accum_grad
    state.step += 1
    if accum_grad > 1:
        if micro == 0:
            state.acc_grads = [torch.zeros_like(g) for g in grads]
        for acc, g in zip(state.acc_grads, grads):
            acc.add_((g - acc) / (micro + 1))  # running mean, as MultiSteps
        if micro < accum_grad - 1:
            return grad_norm, lr
        grads, state.acc_grads = state.acc_grads, None
    if grad_clip > 0:
        norm = grad_norm if accum_grad == 1 else global_norm(grads)
        scale = torch.where(norm < grad_clip, 1.0, grad_clip / norm)
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


def make_train_step(model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer,
                    schedule: Callable[[int], float],
                    dtype: Optional[torch.dtype] = None,
                    accum_grad: int = 1, grad_clip: float = 0.0):
    """Build the train step: (state, batch, (seed, epoch)) -> (state,
    metrics).

    batch: dict of device tensors feats (B, T, F), feats_lengths (B,),
    target (B, L) IGNORE_ID padded, target_lengths (B,).  Each step seeds
    the device RNG (nn.Dropout) and a host generator (the dynamic-chunk
    draw and the rel-pos attention dropout seeds) from (seed, epoch,
    state.step).  dtype=torch.bfloat16 runs forward and backward under
    autocast; params, grads and optimizer state stay fp32.  metrics:
    loss, loss_att, loss_ctc, th_accuracy, grad_norm as device tensors
    (no host sync) and lr as a float."""
    device_type = next(model.parameters()).device.type

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor],
                rng: Tuple[int, int]):
        device_seed, host_seed = step_seeds(*rng, state.step)
        torch.manual_seed(device_seed)
        generator = torch.Generator().manual_seed(host_seed)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        with torch.autocast(device_type, dtype=dtype,
                            enabled=dtype is not None):
            out = model(batch['feats'], batch['feats_lengths'],
                        batch['target'], batch['target_lengths'],
                        generator=generator)
        out['loss'].backward()
        grad_norm, lr = apply_gradients(state, schedule, grad_clip,
                                        accum_grad)
        metrics = {k: v.detach() for k, v in out.items() if v is not None}
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
