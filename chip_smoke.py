"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each of which raises on failure (non-zero exit):
  1. device   needs CUDA; prints the card's name and power limit; TF32 off
  2. build    compiles the rel-pos attention kernels (K1 forward, K2 and
              K3 backward; nvcc, sm_90a, one process per source) and the
              C++ CTC prefix-beam searcher from the checkout's sources
  3. kernel   K1 (inference) against its plain PyTorch version, fp32 and
              bf16, at the encoder's shapes; prints both times (CUDA events)
  4. slice    the flagship U2++ conformer (examples/aishell/s0/conf/
              train_u2pp_conformer.yaml, full width, random weights from
              a seed) through AsrRunner.decode on the card: K1 must run
              once per encoder block, and the encoder output and CTC
              log-probs must match the same model on the CPU
  5. speed    decode throughput at B=16 x 15 s (informational) and the
              device time by kernel from torch.profiler
  6a. train kernels: K1 with lse and dropout, and K2/K3 through the
              autograd Function's backward, against the plain versions
              (dense autograd), fp32 and bf16, at the train step's shapes
  6b. mask    the in-kernel dropout mask equals the plain hash bit for bit
  6c. train   the flagship train step: one step on the card against the
              CPU (every dropout 0), five steps through Executor.train
              (yaml dropouts, dynamic chunk; 12 launches of each training
              kernel per step), a checkpoint round trip, and thirty steps
              on one batch that must lower the loss
  6d. train speed (informational): steps/s, audio-sec/s, stage times,
              device-busy share and the profiler table, fp32 and bf16
The line before the last is the kernel report as JSON; the last line is
{"ok": true, "device": {...}}.  Imports nothing of jax.
"""

import copy
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, 'examples/aishell/s0/conf/'
                      'train_u2pp_conformer.yaml')
SEED = 0
MODES = ['ctc_greedy_search', 'ctc_prefix_beam_search',
         'attention_rescoring']
KERNEL_SHAPES = [  # B, h, T1, T2, d, mask
    (16, 4, 375, 375, 64, 'pad'),     # the encoder's shape at B=16 x 15 s
    (2, 4, 37, 53, 64, None),         # ragged edges, no mask
    (16, 4, 375, 375, 64, 'chunk'),   # (B, T1, T2) static chunk of 16
    (2, 4, 64, 64, 64, 'masked_row'),  # one fully masked row
    (2, 4, 1500, 1500, 64, 'pad'),
]
TOL = {torch.float32: dict(atol=2e-5, rtol=1e-5),
       torch.bfloat16: dict(atol=2e-2, rtol=0.0)}
TRAIN_SHAPES = [  # B, h, T1, T2, d, mask, dropout rate
    (16, 4, 299, 299, 64, 'chunk', 0.1),  # the train step's shape, B=16 x 12 s
    (16, 4, 299, 299, 64, 'pad', 0.0),
    (2, 4, 37, 53, 64, None, 0.1),         # ragged edges, no mask
    (2, 4, 64, 64, 64, 'masked_row', 0.1),  # one fully masked row
    (2, 2, 70, 70, 32, 'chunk', 0.1),
]
# fp32: summation order only; bf16: inputs rounded to bf16, math in fp32
TRAIN_TOL = {torch.float32: dict(atol=2e-4, rtol=1e-4),
             torch.bfloat16: dict(atol=5e-2, rtol=2e-2)}
TRAIN_KERNELS = {  # name: (source, TPU kernel it replaces)
    'relpos_attention_fwd_train': ('wenet_tpu_torch/csrc/relpos_attention.cu',
                                   'wenet_tpu/ops/flash_attention.py:548'),
    'relpos_attention_bwd_dq': ('wenet_tpu_torch/csrc/relpos_attention_bwd.cu',
                                'wenet_tpu/ops/flash_attention.py:719'),
    'relpos_attention_bwd_dkpv': (
        'wenet_tpu_torch/csrc/relpos_attention_bwd.cu',
        'wenet_tpu/ops/flash_attention.py:784'),
}
LOSS_DROP = 0.8  # 30 steps on one batch must end below 80% of the first loss


def phase(name):
    print(f'== {name}', flush=True)


def cuda_time_ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device():
    phase('1 device')
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def build():
    phase('2 build')
    from wenet_tpu_torch.ops import flash_attention as fa
    t0 = time.perf_counter()
    fa.build()
    print(f'rel-pos attention kernels built in '
          f'{time.perf_counter() - t0:.1f} s')
    for name in fa.SOURCES:
        log = fa.BUILD_DIR / f'{name}.log'
        if not log.exists():
            continue
        for line in log.read_text().splitlines():
            if 'Compiling entry' in line:
                print('  ' + line.split("'")[1][:110])
            elif 'registers' in line or 'spill' in line:
                print('    ' + line.strip())
    subprocess.run(['make', '-B', '-C',
                    os.path.join(REPO, 'wenet_tpu/runtime/cpp'),
                    'libctc_beam.so'], check=True, capture_output=True)
    from wenet_tpu.runtime import native_beam
    if not native_beam.available():
        raise RuntimeError('C++ prefix-beam searcher did not load')


def kernel_inputs(rng, B, h, T1, T2, d, mask_kind, dtype):
    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).cuda()
    # q1/q2 as the attention module hands them: (B, h, T, d) views of a
    # (B, T, h, d) buffer; p shared by the batch
    q1 = t(B, T1, h, d).transpose(1, 2)
    q2 = t(B, T1, h, d).transpose(1, 2)
    k, p, v = t(B, h, T2, d), t(1, h, T2, d), t(B, h, T2, d)
    lens = torch.from_numpy(rng.randint(T2 // 2, T2 + 1, size=B)).cuda()
    lens[0] = T2
    pad = torch.arange(T2, device='cuda')[None, :] < lens[:, None]
    if mask_kind == 'pad':
        mask = pad[:, None, :]
    elif mask_kind is None:
        mask = None
    else:
        rows = torch.arange(T1, device='cuda')[:, None] // 16
        mask = (torch.arange(T2, device='cuda')[None, :] < (rows + 1) * 16)
        mask = mask[None] & pad[:, None, :]
        if mask_kind == 'masked_row':
            mask[0, 5] = False
    return [x.to(dtype) for x in (q1, q2, k, p, v)], mask


def kernel_check():
    phase('3 kernel vs plain')
    from wenet_tpu_torch.ops.flash_attention import (
        flash_attention_relpos, relpos_fwd_reference)
    rng = np.random.RandomState(SEED)
    report = None
    max_err_fp32 = 0.0
    for B, h, T1, T2, d, mask_kind in KERNEL_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            (q1, q2, k, p, v), mask = kernel_inputs(rng, B, h, T1, T2, d,
                                                    mask_kind, dtype)
            scale = 1.0 / d ** 0.5
            got = flash_attention_relpos(q1, q2, k, p, v, mask, scale)
            torch.cuda.synchronize()
            # the plain version in fp32 on the (possibly bf16-rounded) inputs
            f32 = [x.float() for x in (q1, q2, k, p, v)]
            want, _ = relpos_fwd_reference(*f32, mask, scale)
            err = (got.float() - want).abs().max().item()
            torch.testing.assert_close(got.float(), want, **TOL[dtype])
            if not torch.isfinite(got).all():
                raise RuntimeError('kernel output is not finite')
            if mask_kind == 'masked_row' and got[0, :, 5].any():
                raise RuntimeError('fully masked row is not zero')
            ms = cuda_time_ms(
                lambda: flash_attention_relpos(q1, q2, k, p, v, mask, scale))
            plain_ms = cuda_time_ms(
                lambda: relpos_fwd_reference(q1, q2, k, p, v, mask, scale))
            print(f'  ({B},{h},{T1},{T2},{d}) mask={mask_kind} '
                  f'{str(dtype)[6:]}: max_abs_err={err:.3g} '
                  f'kernel {ms:.4f} ms, plain {plain_ms:.4f} ms', flush=True)
            if dtype == torch.float32:
                max_err_fp32 = max(max_err_fp32, err)
                if report is None:  # the first shape is the main path's
                    report = dict(ms=ms, plain_ms=plain_ms)
    report['max_abs_err'] = max_err_fp32
    return report


def flagship_configs(dropout=True):
    """The flagship yaml (input 80-d fbank, 4233 chars); dropout=False sets
    every dropout rate to 0."""
    import yaml
    with open(CONFIG) as f:
        configs = yaml.safe_load(f)
    configs['input_dim'], configs['output_dim'] = 80, 4233
    if not dropout:
        for conf in (configs['encoder_conf'], configs['decoder_conf']):
            for key in conf:
                if key.endswith('dropout_rate'):
                    conf[key] = 0.0
    return configs


def flagship_model(configs=None):
    from wenet_tpu_torch.utils.init_model import init_model
    configs = configs or flagship_configs()
    model = init_model(configs, torch.Generator().manual_seed(SEED))
    rng = np.random.RandomState(SEED)
    cmvn = model.encoder.global_cmvn
    cmvn.mean.copy_(torch.from_numpy(rng.randn(80).astype(np.float32)))
    cmvn.istd.copy_(torch.from_numpy(
        (0.5 + rng.rand(80)).astype(np.float32)))
    return model


def features(rng, B, T, min_len):
    feats = rng.randn(B, T, 80).astype(np.float32)
    lens = rng.randint(min_len, T + 1, size=B).astype(np.int64)
    lens[0] = T
    return feats, lens


def slice_check(fa):
    phase('4 slice: flagship decode on the card vs the CPU')
    from wenet_tpu_torch.models.runner import AsrRunner
    configs = flagship_configs()
    model = flagship_model(configs)
    n_blocks = configs['encoder_conf']['num_blocks']
    cpu_model = copy.deepcopy(model)
    runner = AsrRunner(model, 'cuda')
    feats, lens = features(np.random.RandomState(SEED + 1), 8, 1500, 600)
    kw = dict(beam_size=10, ctc_weight=0.3, reverse_weight=0.3)

    fa.reset_launches()
    got = runner.decode(MODES, feats, lens, **kw)
    torch.cuda.synchronize()
    launches = fa.LAUNCHES['relpos_attention_fwd']
    print(f'  rel-pos kernel launches in one decode: {launches}')
    if launches != n_blocks:
        raise RuntimeError(f'expected {n_blocks} kernel launches (one per '
                           f'encoder block), got {launches}')

    cpu_runner = AsrRunner(cpu_model, 'cpu')
    want = cpu_runner.decode(MODES, feats, lens, **kw)
    with torch.inference_mode():
        x, n = torch.from_numpy(feats), torch.from_numpy(lens)
        eo, em = runner.model.forward_encoder(x.cuda(), n.cuda())
        logp = runner.model.ctc_logprobs(eo)
        ceo, cem = cpu_model.forward_encoder(x, n)
        clogp = cpu_model.ctc_logprobs(ceo)
    for name, a, b in (('encoder_out', eo, ceo), ('ctc log-probs', logp,
                                                   clogp)):
        if not torch.isfinite(a).all():
            raise RuntimeError(f'{name} on the card is not finite')
        err = (a.cpu() - b).abs().max().item()
        print(f'  {name} {tuple(a.shape)}: max |card - cpu| = {err:.3g}')
        torch.testing.assert_close(a.cpu(), b, atol=1e-3, rtol=0)
    if not torch.equal(em.cpu(), cem):
        raise RuntimeError('encoder masks differ between card and CPU')
    for mode in MODES:
        same = sum(g.tokens == w.tokens
                   for g, w in zip(got[mode], want[mode]))
        lengths = [len(r.tokens) for r in got[mode]]
        print(f'  {mode}: {same}/{len(feats)} hypotheses equal to the CPU '
              f'run (token counts {lengths})')
        if len(got[mode]) != len(feats):
            raise RuntimeError(f'{mode}: wrong number of results')
    return runner, launches


def speed(runner, smi):
    phase('5 throughput (informational)')
    B, seconds = 16, 15.0
    feats, lens = features(np.random.RandomState(SEED + 2), B,
                           int(seconds * 100), int(seconds * 100))
    kw = dict(beam_size=10, ctc_weight=0.3, reverse_weight=0.3)

    def run():
        out = runner.decode(['attention_rescoring'], feats, lens, **kw)
        torch.cuda.synchronize()
        return out

    run()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    best = min(times)
    print(f'  attention_rescoring B={B} x {seconds:.0f} s: best of 3 '
          f'{best * 1e3:.1f} ms, {B * seconds / best:.1f} audio-sec/s '
          f'({smi})')
    # the same decode stage by stage, each ended by a synchronize
    from wenet_tpu_torch.models.runner import ctc_prefix_beam_search
    from wenet_tpu_torch.models.transformer.search import (
        attention_rescoring)
    model = runner.model
    stamps = [time.perf_counter()]
    with torch.inference_mode():
        eo, em = model.forward_encoder(torch.as_tensor(feats, device='cuda'),
                                       torch.as_tensor(lens, device='cuda'))
        logp = model.ctc_logprobs(eo)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        enc_lens = em[:, 0, :].sum(-1)
        prefix = ctc_prefix_beam_search(logp, enc_lens, 10)
        stamps.append(time.perf_counter())
        attention_rescoring(model, prefix, eo, enc_lens, 0.3, 0.3)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    for name, a, b in zip(('encoder + ctc', 'top-k + C++ prefix beam',
                           'attention rescoring'), stamps, stamps[1:]):
        print(f'    stage {name}: {(b - a) * 1e3:.1f} ms')

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in rows) / 1e3
    print(f'  kernel time in one profiled decode: {total:.2f} ms of '
          f'{wall * 1e3:.1f} ms wall ({100 * total / (wall * 1e3):.0f}% '
          f'device busy)')
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        ms = e.self_device_time_total / 1e3
        print(f'    {ms:8.3f} ms {100 * ms / max(total, 1e-9):5.1f}% '
              f'x{e.count:<4d} {e.key[:80]}')



# ---------------------------------------------------------------------------
# 6. the train slice
# ---------------------------------------------------------------------------
def train_kernel_check():
    phase('6a training kernels vs plain: K1 (lse, dropout), K2, K3')
    from wenet_tpu_torch.ops import flash_attention as fa
    rng = np.random.RandomState(SEED + 3)
    errs = {name: 0.0 for name in TRAIN_KERNELS}
    times = {}
    for B, h, T1, T2, d, mask_kind, rate in TRAIN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x, mask = kernel_inputs(rng, B, h, T1, T2, d, mask_kind, dtype)
            do = torch.from_numpy(
                rng.randn(B, h, T1, d).astype(np.float32)).cuda().to(dtype)
            scale = 1.0 / d ** 0.5
            seed = int(rng.randint(0, 1 << 32, dtype=np.int64))
            # the kernels: K1-train forward, K2 and K3 in the Function's
            # backward (dp summed over the batch: p is shared)
            leaves = [t.detach().requires_grad_() for t in x]
            out = fa.flash_attention_relpos(*leaves, mask, scale, rate, seed)
            out.backward(do)
            _, lse = fa.relpos_fwd(*x, mask, scale, True, rate, seed)
            torch.cuda.synchronize()
            # the plain versions: dense autograd in fp32 on the same inputs
            ref = [t.detach().float().requires_grad_() for t in x]
            want, want_lse = fa.relpos_fwd_reference(*ref, mask, scale, True,
                                                     rate, seed)
            want.backward(do.float())
            grads = [t.grad for t in leaves]
            want_grads = [t.grad for t in ref]
            pairs = {
                'relpos_attention_fwd_train': [(out, want), (lse, want_lse)],
                'relpos_attention_bwd_dq': list(zip(grads[:2],
                                                    want_grads[:2])),
                'relpos_attention_bwd_dkpv': list(zip(grads[2:],
                                                      want_grads[2:])),
            }
            line = []
            for name, checks in pairs.items():
                err = 0.0
                for got, w in checks:
                    if not torch.isfinite(got).all():
                        raise RuntimeError(f'{name}: output is not finite')
                    torch.testing.assert_close(got.float(), w.float(),
                                               **TRAIN_TOL[dtype], msg=name)
                    err = max(err, (got.float() - w.float()).abs().max()
                              .item())
                if dtype == torch.float32:
                    errs[name] = max(errs[name], err)
                line.append(f'{name[17:]} {err:.3g}')
            if mask_kind == 'masked_row' and (out[0, :, 5].any() or
                                              grads[0][0, :, 5].any()):
                raise RuntimeError('fully masked row is not zero')
            # CUDA-event times of each kernel and its plain version on the
            # same lse and delta
            delta = (do.float() * want.detach()).sum(-1)
            args = (mask, do, want_lse.detach(), delta, scale, rate, seed)
            t = {
                'relpos_attention_fwd_train': (
                    cuda_time_ms(lambda: fa.relpos_fwd(
                        *x, mask, scale, True, rate, seed)),
                    cuda_time_ms(lambda: fa.relpos_fwd_reference(
                        *x, mask, scale, True, rate, seed))),
                'relpos_attention_bwd_dq': (
                    cuda_time_ms(lambda: fa.relpos_bwd_dq(*x, *args)),
                    cuda_time_ms(lambda: fa.relpos_bwd_dq_reference(
                        *x, *args))),
                'relpos_attention_bwd_dkpv': (
                    cuda_time_ms(lambda: fa.relpos_bwd_dkpv(*x, *args)),
                    cuda_time_ms(lambda: fa.relpos_bwd_dkpv_reference(
                        *x, *args))),
            }
            if not times:  # the first shape in fp32 is the main path's
                times = t
            print(f'  ({B},{h},{T1},{T2},{d}) mask={mask_kind} '
                  f'dropout={rate} {str(dtype)[6:]}: max_abs_err '
                  + ', '.join(line), flush=True)
            print('    kernel / plain ms: ' + ', '.join(
                f'{n[17:]} {a:.4f} / {b:.4f}' for n, (a, b) in t.items()),
                flush=True)
    return {name: dict(max_abs_err=errs[name], ms=times[name][0],
                       plain_ms=times[name][1]) for name in TRAIN_KERNELS}


def mask_check():
    phase('6b dropout mask bit for bit')
    from wenet_tpu_torch.ops import flash_attention as fa
    T1, T2 = 256, 64
    n = 0
    for B, h in ((2, 3), (16, 4)):
        zq = torch.zeros(B, h, T1, T2, device='cuda')
        zk = torch.zeros(B, h, T2, T2, device='cuda')
        eye = torch.eye(T2, device='cuda').expand(B, h, T2, T2)
        for rate in (0.1, 0.5):
            for seed in (0, 1, 0x9E3779B1, 0xFFFFFFFF, 12345):
                # uniform softmax and v = I: out is the mask / T2
                out, _ = fa.relpos_fwd(zq, zq, zk, zk, eye, None, 1.0, True,
                                       rate, seed)
                want = fa.dense_dropout(B, h, T1, T2, rate, seed, 'cuda') / T2
                if not torch.equal(out, want):
                    raise RuntimeError(f'mask differs: B={B} h={h} '
                                       f'rate={rate} seed={seed}')
                n += 1
        kept = (out > 0).float().mean().item()
    print(f'  K1 mask == plain hash for {n} (b*h range, rate, seed) sets; '
          f'keep share at rate 0.5: {kept:.4f}')


def train_batch(rng, B, seconds, min_seconds):
    """A Dataset-format batch: fbank-shaped features, lengths in
    [min_seconds, seconds] (the first full), labels of 10-48 chars in
    [3, 4230], IGNORE_ID padded."""
    feats, lens = features(rng, B, int(seconds * 100),
                           int(min_seconds * 100))
    tl = rng.randint(10, 49, size=B)
    tgt = np.full((B, 48), -1, np.int64)
    for i, n in enumerate(tl):
        tgt[i, :n] = rng.randint(3, 4231, size=n)
    return dict(feats=feats, feats_lengths=lens, target=tgt,
                target_lengths=tl.astype(np.int64))


def train_check():
    phase('6c flagship train step')
    from wenet_tpu_torch.ops import flash_attention as fa
    from wenet_tpu_torch.utils.checkpoint import load_checkpoint
    from wenet_tpu_torch.utils.executor import Executor, to_device_batch
    from wenet_tpu_torch.utils.train_utils import (
        TrainState, init_optimizer_and_scheduler, make_cv_step,
        make_train_step, restore_optimizer_step)
    rng = np.random.RandomState(SEED + 4)
    n_blocks = flagship_configs()['encoder_conf']['num_blocks']

    # (1) one forward + backward on the card against the CPU, dropout 0
    model = flagship_model(flagship_configs(dropout=False))
    cpu_model = copy.deepcopy(model)
    model.cuda()
    b = train_batch(rng, 2, 4.0, 3.0)
    outs = []
    for m, dev in ((model, 'cuda'), (cpu_model, 'cpu')):
        m.train()
        tb = to_device_batch(b, dev)
        fa.reset_launches()
        out = m(tb['feats'], tb['feats_lengths'], tb['target'],
                tb['target_lengths'],
                generator=torch.Generator().manual_seed(SEED))
        out['loss'].backward()
        outs.append(out)
        if dev == 'cuda':
            torch.cuda.synchronize()
            for name in TRAIN_KERNELS:
                if fa.LAUNCHES[name] != n_blocks:
                    raise RuntimeError(
                        f'{name}: {fa.LAUNCHES[name]} launches in one '
                        f'forward + backward, expected {n_blocks}')
    for k in ('loss', 'loss_att', 'loss_ctc', 'th_accuracy'):
        a, w = outs[0][k].item(), outs[1][k].item()
        print(f'  B=2 x 4 s, dropout 0: {k} card {a:.6f} cpu {w:.6f}')
        if not abs(a - w) <= 1e-4 * abs(w) + 1e-6:
            raise RuntimeError(f'{k} differs from the CPU beyond rtol 1e-4')
    worst = 0.0
    cpu_params = dict(cpu_model.named_parameters())
    for name, p in model.named_parameters():
        if p.grad is None or not torch.isfinite(p.grad).all():
            raise RuntimeError(f'{name}: no finite gradient on the card')
        err = (p.grad.cpu() - cpu_params[name].grad).abs().max().item()
        worst = max(worst, err)
        if err > 1e-3:
            raise RuntimeError(f'{name}: grad differs from the CPU by {err}')
    print(f'  all {len(cpu_params)} parameters have finite grads; '
          f'max |card - cpu| over grads = {worst:.3g} (bar 1e-3)')

    # (2) five steps through Executor.train, yaml dropouts + dynamic chunk
    configs = flagship_configs()
    model = flagship_model(configs).cuda()
    opt, schedule = init_optimizer_and_scheduler(configs, model)
    accum = configs.get('accum_grad', 1)
    step_fn = make_train_step(model, opt, schedule, None, accum,
                              configs['grad_clip'])
    per_step = []

    def counted(state, batch, rng_seed):
        before = dict(fa.LAUNCHES)
        state, metrics = step_fn(state, batch, rng_seed)
        per_step.append(({k: fa.LAUNCHES[k] - before[k] for k in before},
                         {k: float(v) for k, v in metrics.items()}))
        return state, metrics

    batches = [train_batch(rng, 16, 12.0, 6.0) for _ in range(5)]
    model_dir = tempfile.mkdtemp(prefix='chip_smoke_ckpt_')
    run_conf = dict(configs, log_interval=1, save_interval=5, epoch=0,
                    seed=SEED)
    executor = Executor(device='cuda')
    state = TrainState(model, opt)
    fa.reset_launches()
    state = executor.train(counted, state, batches,
                           [train_batch(rng, 4, 12.0, 6.0)],
                           make_cv_step(model), None, run_conf,
                           model_dir=model_dir)
    torch.cuda.synchronize()
    main_launches = dict(fa.LAUNCHES)
    for i, (launches, m) in enumerate(per_step):
        print(f'  step {i + 1}: loss {m["loss"]:.4f} ctc {m["loss_ctc"]:.4f} '
              f'att {m["loss_att"]:.4f} acc {m["th_accuracy"]:.4f} '
              f'grad_norm {m["grad_norm"]:.4f} lr {m["lr"]:.3g}; launches '
              + ' '.join(f'{k[17:]}={v}' for k, v in launches.items()))
        for name in TRAIN_KERNELS:
            if launches[name] != n_blocks:
                raise RuntimeError(f'step {i + 1}: {name} ran '
                                   f'{launches[name]} times, expected '
                                   f'{n_blocks}')
        if not (np.isfinite(m['loss']) and np.isfinite(m['grad_norm'])):
            raise RuntimeError(f'step {i + 1}: loss or grad_norm not finite')
    if executor.step != 5 or state.step != 5:
        raise RuntimeError('Executor.train did not run five steps')

    # (3) the checkpoint the executor saved at step 5, loaded back
    fresh = flagship_model(configs)
    infos = load_checkpoint(fresh, os.path.join(model_dir, 'step_5.pt'))
    for (name, a), w in zip(model.state_dict().items(),
                            fresh.state_dict().values()):
        if not torch.equal(a.cpu(), w):
            raise RuntimeError(f'checkpoint: {name} differs after loading')
    opt2, schedule2 = init_optimizer_and_scheduler(configs, fresh)
    resumed = restore_optimizer_step(TrainState(fresh, opt2), infos['step'])
    lr_next, lr_resumed = (schedule(state.step // accum),
                           schedule2(resumed.step // accum))
    if lr_next != lr_resumed:
        raise RuntimeError(f'resumed lr {lr_resumed} != {lr_next}')
    print(f'  checkpoint step_5.pt: strict load, weights equal, cv_loss '
          f'{infos["cv_loss"]:.4f}, resumed lr {lr_resumed:.6g}')

    # (4) thirty steps on one fixed batch at a constant lr, dropout on
    fixed = to_device_batch(batches[0], 'cuda')
    const = make_train_step(model, opt, lambda step: 1e-3, None, 1,
                            configs['grad_clip'])
    losses = []
    for _ in range(30):
        state, m = const(state, fixed, (SEED, 1))
        losses.append(float(m['loss']))
    end = float(np.mean(losses[-5:]))
    print(f'  30 steps on one batch, lr 1e-3: loss {losses[0]:.4f} -> '
          f'{end:.4f} (mean of the last 5; must be < {LOSS_DROP} x first)')
    if not np.isfinite(losses).all() or end >= LOSS_DROP * losses[0]:
        raise RuntimeError('the loss did not fall on a fixed batch')
    return main_launches


def train_speed(smi):
    phase('6d train throughput (informational)')
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from wenet_tpu_torch.utils.executor import to_device_batch
    from wenet_tpu_torch.utils.train_utils import (
        TrainState, apply_gradients, init_optimizer_and_scheduler,
        make_train_step)
    configs = flagship_configs()
    model = flagship_model(configs).cuda()
    opt, schedule = init_optimizer_and_scheduler(configs, model)
    B, seconds = 16, 12.0
    b = train_batch(np.random.RandomState(SEED + 5), B, seconds, 6.0)
    audio = float(b['feats_lengths'].sum()) / 100
    batch = to_device_batch(b, 'cuda')
    for dtype in (None, torch.bfloat16):
        name = 'bf16 autocast' if dtype else 'fp32'
        state = TrainState(model, opt)
        step = make_train_step(model, opt, schedule, dtype, 1,
                               configs['grad_clip'])
        for _ in range(2):
            step(state, batch, (SEED, 0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = 5
        for _ in range(n):
            step(state, batch, (SEED, 0))
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / n
        print(f'  {name} B={B} x {seconds:.0f} s ({audio:.0f} s of audio): '
              f'{dt * 1e3:.1f} ms/step, {1 / dt:.2f} steps/s, '
              f'{audio / dt:.1f} audio-sec/s ({smi})')
        # the same step stage by stage, each ended by a synchronize
        gen = torch.Generator().manual_seed(SEED)
        stamps = [time.perf_counter()]
        opt.zero_grad(set_to_none=True)
        with torch.autocast('cuda', dtype=dtype, enabled=dtype is not None):
            out = model(batch['feats'], batch['feats_lengths'],
                        batch['target'], batch['target_lengths'],
                        generator=gen)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        out['loss'].backward()
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        apply_gradients(state, schedule, configs['grad_clip'], 1)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        print('    stages: ' + ', '.join(
            f'{s} {(t1 - t0) * 1e3:.1f} ms' for s, t0, t1 in zip(
                ('forward', 'backward', 'optimizer (clip + adam)'), stamps,
                stamps[1:])) + f' ({smi})')
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(state, batch, (SEED, 0))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # user annotations (Optimizer.step...) repeat their kernels' time
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and not getattr(e, 'is_user_annotation', False)]
        total = sum(e.self_device_time_total for e in rows) / 1e3
        print(f'    kernel time in one profiled step: {total:.2f} ms; '
              f'{100 * total / (wall * 1e3):.0f}% of its {wall * 1e3:.1f} ms '
              f'wall, {100 * total / (dt * 1e3):.0f}% of an unprofiled step '
              f'(device busy; {smi})')
        for label, key in (('K1', 'relpos_fwd_kernel'),
                           ('K2', 'relpos_bwd_dq_kernel'),
                           ('K3', 'relpos_bwd_dkpv_kernel')):
            ms = sum(e.self_device_time_total for e in rows
                     if key in e.key) / 1e3
            print(f'    {label} {key}: {ms:.3f} ms, '
                  f'{100 * ms / max(total, 1e-9):.1f}% of kernel time')
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:15]:
            ms = e.self_device_time_total / 1e3
            print(f'    {ms:8.3f} ms {100 * ms / max(total, 1e-9):5.1f}% '
                  f'x{e.count:<4d} {e.key[:80]}')


def main():
    smi = device()
    build()
    from wenet_tpu_torch.ops import flash_attention as fa
    report = kernel_check()
    runner, launches = slice_check(fa)
    speed(runner, smi)
    del runner
    train_report = train_kernel_check()
    mask_check()
    train_launches = train_check()
    train_speed(smi)
    if 'jax' in sys.modules:
        raise RuntimeError('jax was imported')
    kernels = [{
        'name': 'relpos_attention_fwd', 'route': 'cuda',
        'source': 'wenet_tpu_torch/csrc/relpos_attention.cu',
        'replaces': 'wenet_tpu/ops/flash_attention.py:548',
        'launches': launches, 'max_abs_err': report['max_abs_err'],
        'ms': report['ms'], 'plain_ms': report['plain_ms']}]
    for name, (source, replaces) in TRAIN_KERNELS.items():
        kernels.append(dict(name=name, route='cuda', source=source,
                            replaces=replaces,
                            launches=train_launches[name],
                            **train_report[name]))
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
