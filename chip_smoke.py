"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each of which raises on failure (non-zero exit):
  1. device   needs CUDA; prints the card's name and power limit; TF32 off
  2. build    compiles the rel-pos attention kernel (nvcc, sm_90a) and the
              C++ CTC prefix-beam searcher from the checkout's sources
  3. kernel   the kernel against its plain PyTorch version, fp32 and bf16,
              at the encoder's shapes; prints both times (CUDA events)
  4. slice    the flagship U2++ conformer (examples/aishell/s0/conf/
              train_u2pp_conformer.yaml, full width, random weights from
              a seed) through AsrRunner.decode on the card: the kernel
              must run once per encoder block, and the encoder output and
              CTC log-probs must match the same model on the CPU
  5. speed    decode throughput at B=16 x 15 s (informational) and the
              device time by kernel from torch.profiler
The line before the last is the kernel report as JSON; the last line is
{"ok": true, "device": {...}}.  Imports nothing of jax.
"""

import copy
import json
import os
import subprocess
import sys
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
    print(f'rel-pos attention kernel built in '
          f'{time.perf_counter() - t0:.1f} s')
    log = fa.BUILD_DIR / 'relpos_attention.log'
    if log.exists():
        for line in log.read_text().splitlines():
            if 'registers' in line or 'spill' in line:
                print('  ' + line.strip())
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
        flash_attention_relpos, relpos_attention_reference)
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
            want = relpos_attention_reference(*f32, mask, scale)
            err = (got.float() - want).abs().max().item()
            torch.testing.assert_close(got.float(), want, **TOL[dtype])
            if not torch.isfinite(got).all():
                raise RuntimeError('kernel output is not finite')
            if mask_kind == 'masked_row' and got[0, :, 5].any():
                raise RuntimeError('fully masked row is not zero')
            ms = cuda_time_ms(
                lambda: flash_attention_relpos(q1, q2, k, p, v, mask, scale))
            plain_ms = cuda_time_ms(
                lambda: relpos_attention_reference(q1, q2, k, p, v, mask,
                                                   scale))
            print(f'  ({B},{h},{T1},{T2},{d}) mask={mask_kind} '
                  f'{str(dtype)[6:]}: max_abs_err={err:.3g} '
                  f'kernel {ms:.4f} ms, plain {plain_ms:.4f} ms', flush=True)
            if dtype == torch.float32:
                max_err_fp32 = max(max_err_fp32, err)
                if report is None:  # the first shape is the main path's
                    report = dict(ms=ms, plain_ms=plain_ms)
    report['max_abs_err'] = max_err_fp32
    return report


def flagship_model():
    import yaml
    from wenet_tpu_torch.utils.init_model import init_model
    with open(CONFIG) as f:
        configs = yaml.safe_load(f)
    configs['input_dim'], configs['output_dim'] = 80, 4233
    model = init_model(configs, torch.Generator().manual_seed(SEED))
    rng = np.random.RandomState(SEED)
    cmvn = model.encoder.global_cmvn
    cmvn.mean.copy_(torch.from_numpy(rng.randn(80).astype(np.float32)))
    cmvn.istd.copy_(torch.from_numpy(
        (0.5 + rng.rand(80)).astype(np.float32)))
    return model, configs


def features(rng, B, T, min_len):
    feats = rng.randn(B, T, 80).astype(np.float32)
    lens = rng.randint(min_len, T + 1, size=B).astype(np.int64)
    lens[0] = T
    return feats, lens


def slice_check(fa):
    phase('4 slice: flagship decode on the card vs the CPU')
    from wenet_tpu_torch.models.runner import AsrRunner
    model, configs = flagship_model()
    n_blocks = configs['encoder_conf']['num_blocks']
    cpu_model = copy.deepcopy(model)
    runner = AsrRunner(model, 'cuda')
    feats, lens = features(np.random.RandomState(SEED + 1), 8, 1500, 600)
    kw = dict(beam_size=10, ctc_weight=0.3, reverse_weight=0.3)

    fa.flash_attention_relpos.launches = 0
    got = runner.decode(MODES, feats, lens, **kw)
    torch.cuda.synchronize()
    launches = fa.flash_attention_relpos.launches
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


def main():
    smi = device()
    build()
    from wenet_tpu_torch.ops import flash_attention as fa
    report = kernel_check()
    runner, launches = slice_check(fa)
    speed(runner, smi)
    if 'jax' in sys.modules:
        raise RuntimeError('jax was imported')
    print(json.dumps({'kernels': [{
        'name': 'relpos_attention_fwd', 'route': 'cuda',
        'source': 'wenet_tpu_torch/csrc/relpos_attention.cu',
        'replaces': 'wenet_tpu/ops/flash_attention.py:548',
        'launches': launches, 'max_abs_err': report['max_abs_err'],
        'ms': report['ms'], 'plain_ms': report['plain_ms']}]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
