"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each of which raises on failure (non-zero exit):
  1. device   needs CUDA; prints the card's name and power limit; TF32 off
  2. build    compiles the attention kernels (K1 forward, K2 and K3
              backward, K4 masked forward, K5 and K6 its backward; nvcc,
              sm_90a, one process per source, all started together) and
              the port's C++ CTC prefix-beam searcher (g++) from the
              checkout's sources
  3. kernel   K1 (inference) against its plain PyTorch version, fp32 and
              bf16, at the encoder's shapes, ragged edges, a fully masked
              row, a peaked softmax, key tiles closed mid-row, a chunk
              step (T1 = 16, T2 = 80), the serving chunk step of 9c
              (one stream, 16 queries, 512 cache slots + 16 keys: 16 and
              256 valid slots, and a padded tail chunk), 9f's batched
              one (eight streams, each with its own p and cache fill:
              16-512 valid slots and a tail) and the encoder zoo's
              decodes (12a: the efficient conformer's 8 heads of d = 32
              after its stride, (16,8,187,187,32), and the openasr
              conformer-large's (16,8,249,249,64)); each check's
              share of its bar, both times (CUDA events), and at the main
              and the serving shapes the bound (fp32: 3xTF32; FFMA beside
              it at the main shape), TFLOP/s and the SDPA call's time
  4. slice    the flagship U2++ conformer (examples/aishell/s0/conf/
              train_u2pp_conformer.yaml, full width, random weights from
              a seed) through AsrRunner.decode on the card: K1 must run
              once per encoder block, and the encoder output and CTC
              log-probs must match the same model on the CPU
  5. speed    decode throughput at B=16 x 15 s (informational) and the
              device time by kernel from torch.profiler
  6a. train kernels: K1 with lse and dropout, and K2/K3 through the
              autograd Function's backward, against the plain versions
              chained as the Function chains them (delta from the
              Function's own output, K1's), fp32 and bf16, at the
              train step's shapes, a peaked softmax, key tiles closed
              mid-row, key blocks wholly in the padding and the efficient
              conformer's train step (16,8,150,150,32) with a chunk mask
              and dropout 0.1, and without either; each output's
              share of its bar, kernel and plain times, and at the main
              shape the bounds (fp32: 3xTF32 beside FFMA) and TFLOP/s;
              K2 + K3 against SDPA's backward at the pad shape
  6b. mask    the in-kernel dropout mask equals the plain hash bit for bit
  6c. train   the flagship train step: one step on the card against the
              CPU (every dropout 0), five steps through Executor.train
              (yaml dropouts, dynamic chunk; 12 launches of each training
              kernel per step), a checkpoint round trip, and thirty steps
              on one batch that must lower the loss
  6d. train speed (informational): steps/s, audio-sec/s, stage times,
              device-busy share and the profiler table, fp32 and bf16
  7a. K4      masked flash attention against its plain version, fp32 and
              bf16, at whisper's encoder shapes, ragged edges, mask + bias,
              a fully masked row, d=128, a peaked softmax, key tiles
              closed mid-row and the conv2d transformer's (64,4,374,374,64)
              (12a); kernel, plain, SDPA and bound (fp32: 3xTF32
              beside FFMA) in both types; K4 and the ordinary path above
              and below the gate
  7b. whisper large-v3 at full width (4 + 4 layers) through
              AsrRunner.decode(['attention']) on the card against the CPU,
              beam 5, with and without timestamps: identical hypotheses,
              encoder output within 2e-4, one K4 launch per encoder layer
  7c. whisper speed (informational): 32 + 32 layers, B=4 x 20-30 s,
              beam 5, a fixed eot bias (116 decoder steps), fp32 then
              bf16: AsrRunner.decode end to end (audio-sec/s) with the
              encoder's share, peak memory, device-busy share, profiler
              table
  8a. K4-train, K5, K6: masked flash attention with lse and its backward
              through the FlashAttention Function against dense autograd
              of the plain version, fp32 and bf16, at whisper's train
              shapes, ragged edges, mask + bias (dbias of three bias
              shapes), a fully masked row and d=128; kernel, plain, SDPA
              forward / backward and bound
  8b. whisper large-v3 LoRA train step (examples/aishell/whisper/conf/
              finetune_whisper_largev3.yaml, full width, 4 + 4 layers):
              one step with the yaml's AdamW on the card against the CPU,
              eight micro-steps through Executor.train (accum_grad 8; one
              launch of K4-train, K5 and K6 per encoder layer and
              micro-step), a checkpoint round trip, and twenty steps on one
              batch that must lower the loss
  8c. whisper train speed (informational): 32 + 32 layers, B=2 x 30 s,
              eight micro-steps (one AdamW update) through Executor.train,
              fp32 then bf16 autocast: ms per micro-step, audio-sec/s,
              stage times, peak memory, device-busy share, profiler table
  9a. front end: the kaldi fbank on the card against the host's numpy
              one (B=16 x 15 s synthesized waveforms), and decode_wav on
              the card giving the hypotheses of decode on the host's
              features
  9b. chunk step: the flagship's forward_chunk_by_chunk (chunk 16, a
              512-frame cache) on the card against its full forward under
              the chunk mask (1e-4) and against the CPU (2e-4), 12 K1
              launches per chunk step; decode(simulate_streaming=True) on
              the card giving the CPU's hypotheses
  9c. AsrDecoder: three utterances fed in 200 ms pieces; every partial
              and the final after rescoring equal to the CPU decoder's;
              12 K1 launches per chunk step
  9d. HTTP: make_server on 127.0.0.1:0, two client threads POST four
              RIFF files and one raw s16le body; every answer's nbest is
              9c's final for its audio
  9e. streaming speed (informational): card time per chunk step (CUDA
              events) and K1's share of it, first-partial and final
              latency and real-time factor of one stream, the two HTTP
              clients' real-time factors, the device-busy share
  9f. batched serving: eight AsrDecoders, started 150 ms apart, over one
              BatchedChunkRunner(max_batch=8); every partial and final
              equal to the same stream decoded alone (9c's path), 12 K1
              launches per batched step, the histogram of coalesced batch
              sizes; then (informational, from that run and one
              unbatched run, both profiled) per-stream real-time factors
              batched and unbatched, the device-busy share of each, and
              the batched chunk step's card time and host enqueue at
              B = 1, 2, 4, 8
  9g. model directory: the flagship yaml with a written units.txt and
              final.pt from the card model; decoder_main --device cuda on
              9c's utterances writes 9c's finals; http_server_main answers
              one request on a free port and WenetRecognizer one decode,
              both equal to 9c's decoder at their default options
  10. train entry: the recipe's stages 1, 4 and 5 on written data (48
              train wavs of 3-12 s, four at 8 kHz, in a raw list; 8 cv
              wavs in a local tar shard; random char transcripts):
              bin/compute_cmvn_stats, then bin/train.main with the
              flagship yaml at full width (the dict and cmvn paths,
              max_epoch 2 and log_interval 1 overridden; speed perturb,
              dither, SpecAugment, SpecSub, shuffle, sort, pad 64,
              dynamic batches of 12000 frames) and a profiler window,
              then bin/average_model --num 2 --val_best and decoder_main
              on a model directory of the average, on the card and on
              the CPU.  Checks: the entry point's first step (its batch,
              weights, cmvn and seeds; nn.Dropout at 0, K1's hash dropout
              and the dynamic chunk kept) on the card against the CPU
              (loss rtol 1e-4, grads 1e-3); finite losses; both epoch
              checkpoints and the average; 12 launches of K1-train, K2
              and K3 a step, in the counts and in the trace; K1
              (inference) in cv; the card's hypotheses equal the CPU's.
              Prints each step's batch, data wait and step time, each
              epoch's steps/s and audio-sec/s, cv, save and averaging
              times, and the card's busy share over the profiled steps
  11. recognize: the recipe's decode stage (bin/recognize.py) on the
              flagship at full width (random weights from the seed, saved
              as the port's final.pt with train.yaml and units.txt) over
              64 written wavs of 3-12 s in a raw list, batch 16, beam 10,
              ctc_weight 0.3, reverse_weight 0.5: each of the four modes
              alone and all four together.  Checks: each mode's text alone
              == beside the other three; card == CPU on the first 16
              utterances (4 in the attention mode); at least half the
              hypotheses non-empty; 12 K1 launches per batch;
              --context_list_path with three phrases of the best
              hypotheses (list A) and with three chars of the n-best lists
              that the fewest best hypotheses hold (list B): for each, the
              C++ search on the card's top-k equals
              ctc_prefix_beam_search_with_context (up to float32 near-ties
              at the beam's edge), the recognize text is its best, and B's
              chars appear in more hypotheses than without the list; the
              C++ search with the LM fused on the card's top-k equals the
              plain version with the same LM; --lm_path with a written
              bigram ARPA equals a plain n-best rescoring; AsrDecoder with
              the context and the LM card == CPU partial by partial;
              bin/alignment card == CPU, each alignment collapsing to its
              label.  Prints audio-sec/s per mode (recognize.main, and the
              runner's loop over the Dataset; load excluded), the Dataset's
              own rate, the card's busy share and kernel time a batch, and
              the WER of each mode (tools/compute_wer.py: a reading)
  12. encoder zoo: six example yamls at their published widths and
              depths, random weights from the seed (examples/{aishell,
              timit}/s0 train_transformer.yaml: conv2d abs-pos
              transformer; openasr2021 train_conformer_large_10h.yaml:
              conv2d6, 24 x 512; aishell train_ebranchformer.yaml,
              train_squeezeformer.yaml, train_u2pp_efficonformer.yaml).
              12a: AsrRunner.decode of B=16 x 15 s in CTC greedy, CTC
              prefix beam and attention rescoring on the card against the
              CPU (encoder output and log-probs within 1e-3, identical
              hypotheses), the conv2d transformer also at B=64 x 15 s;
              12b: launches per decode: K1 16 (E-Branchformer), 24
              (openasr), 8 (efficient conformer), 0 (transformers,
              Squeezeformer); K4 12 at B=64 and 0 at B=16.  12c: one train
              step per yaml, B=4 x 8 s, card against CPU at dropout 0
              (loss rtol 1e-4, grads 1e-3).  12d: five steps through
              Executor.train with the yamls' dropouts: E-Branchformer and
              the efficient conformer at B=16 x 12 s (K1-train, K2, K3
              once per rel-pos layer and step), the conv2d transformer at
              B=64 x 15 s (K4-train, K5, K6 12 each a step).  12e: the
              efficient conformer through bin/compute_cmvn_stats,
              bin/train.py (2 epochs on 10's written recipe) and
              bin/recognize.py (card == CPU, 8 K1 launches a batch), and
              AsrDecoder over the trained model on the card against the
              CPU, partial by partial.  Prints each yaml's audio-sec/s of
              the rescoring decode
The line before the last is the kernel report as JSON; the last line is
{"ok": true, "device": {...}}.  Imports nothing of jax or of the JAX
package (wenet_tpu), and checks so at the end.
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
    (2, 4, 300, 300, 64, 'peaked'),   # q1, q2 scaled by 8
    (2, 4, 200, 448, 64, 'gap'),      # key tiles closed mid-row
    (16, 4, 16, 80, 64, 'step'),      # a streaming chunk step: 16 + 64 cache
    (2, 4, 130, 200, 128, 'pad'),     # d = 128 (fp32: the FFMA body)
    # the flagship's serving chunk step (9c): 16 queries against 512 cache
    # slots + 16 keys, one stream, with 16 and 256 valid cache slots, and
    # a padded tail chunk (368 valid slots, 7 valid frames of 16)
    (1, 4, 16, 528, 64, 'cache16'),
    (1, 4, 16, 528, 64, 'cache256'),
    (1, 4, 16, 528, 64, 'tailstep'),
    # the batched chunk step of 9f: eight streams, each with its own p (its
    # own offset) and its own cache fill
    (8, 4, 16, 528, 64, 'batch8'),
    # the encoder zoo's decodes at B=16 x 15 s (12a): the efficient
    # conformer's rel-pos layers after its stride (8 heads, d = 32) and
    # the openasr conformer-large (conv2d6, 8 heads of 64)
    (16, 8, 187, 187, 32, 'pad'),
    (16, 8, 249, 249, 64, 'pad'),
]
ZOO_KERNEL_SHAPES = {(16, 8, 187, 187, 32), (16, 8, 249, 249, 64)}
# mask kind -> (valid cache slots, valid chunk frames) of each batch row
SERVING = {'cache16': [(16, 16)], 'cache256': [(256, 16)],
           'tailstep': [(368, 7)],
           'batch8': [(16, 16), (256, 16), (512, 16), (368, 7), (64, 16),
                      (128, 16), (448, 16), (512, 16)]}
TRAIN_SHAPES = [  # B, h, T1, T2, d, mask, dropout rate
    (16, 4, 299, 299, 64, 'chunk', 0.1),  # the train step's shape, B=16 x 12 s
    (16, 4, 299, 299, 64, 'pad', 0.0),
    (2, 4, 37, 53, 64, None, 0.1),         # ragged edges, no mask
    (2, 4, 64, 64, 64, 'masked_row', 0.1),  # one fully masked row
    (2, 2, 70, 70, 32, 'chunk', 0.1),
    (2, 4, 300, 300, 64, 'peaked', 0.1),   # q1, q2 scaled by 8
    (2, 4, 200, 448, 64, 'gap', 0.1),      # key tiles closed mid-row
    (2, 4, 130, 300, 64, 'tail', 0.0),     # key blocks wholly in the padding
    # the efficient conformer's train step after its stride, B=16 x 12 s
    # (8 heads, d = 32, a dynamic chunk, dropout 0.1), and without dropout
    # for SDPA
    (16, 8, 150, 150, 32, 'chunk', 0.1),
    (16, 8, 150, 150, 32, 'pad', 0.0),
]
ZOO_TRAIN_SHAPE = (16, 8, 150, 150, 32)
TRAIN_OUTPUTS = {  # the outputs each training kernel is held to, in order
    'relpos_attention_fwd_train': ('out', 'lse'),
    'relpos_attention_bwd_dq': ('dq1', 'dq2'),
    'relpos_attention_bwd_dkpv': ('dk', 'dp', 'dv'),
}
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
PAD_SHAPE = '(16,4,299,299,64) pad'  # TRAIN_SHAPES[1], SDPA's yardstick
LOSS_DROP = 0.8  # 30 steps on one batch must end below 80% of the first loss
# published H100 SXM peaks: fp32 on the CUDA cores, bf16 dense tensor
# cores, HBM3 (the kernels' bounds are computed against these)
FP32_FLOPS, BF16_FLOPS, HBM_BYTES = 67e12, 989e12, 3.35e12
TF32_FLOPS = 495e12  # dense tf32 tensor cores: K4's fp32 route (3xTF32)
FLASH_SHAPES = [  # B, h, T1, T2, d, mask, bias
    (4, 20, 1500, 1500, 64, 'pad', False),   # whisper large-v3's encoder
    (4, 20, 1000, 1000, 64, 'pad', False),   # a 20 s batch
    (2, 4, 37, 53, 64, None, False),         # ragged edges
    (1, 2, 130, 257, 32, 'rows', True),      # (B, 1, T1, T2) mask + bias
    (2, 4, 64, 64, 64, 'masked_row', False),  # one fully masked row
    (2, 4, 600, 600, 128, 'pad', False),     # d = 128
    (2, 4, 300, 300, 64, 'peaked', False),   # q scaled by 8
    (2, 4, 200, 448, 64, 'gap', False),      # key tiles closed mid-row
    (64, 4, 374, 374, 64, 'pad', False),     # conv2d transformer, 64 x 15 s
]
ZOO_FLASH_SHAPE = (64, 4, 374, 374, 64)
# K1's and K4's bars.  The reference runs in fp32 on the same (rounded)
# inputs: in bf16 the kernel is held to the rounding of its output, about
# 2 bf16 ulps
FLASH_TOL = {torch.float32: dict(atol=2e-5, rtol=1e-5),
             torch.bfloat16: dict(atol=1e-3, rtol=8e-3)}
GATE_BELOW = (2, 20, 400, 400, 64)  # two 8 s utterances: 6.4M < 24M scores
WHISPER_V3 = {'n_mels': 128, 'n_vocab': 51866, 'n_audio_state': 1280,
              'n_audio_head': 20, 'n_audio_layer': 32, 'n_text_state': 1280,
              'n_text_head': 20, 'n_text_layer': 32, 'n_audio_ctx': 1500,
              'n_text_ctx': 448}
# 7c's eot bias, fixed so that every run decodes the same work: with 7c's
# seeded weights and features the beams end after 116 decoder steps (a
# value `calibrate_eot_bias` found for them)
WHISPER_SPEED_EOT_BIAS = 17.129


def bound(flops, nbytes, dtype=torch.float32, tf32_split=False):
    """(ms, 'operations' | 'bytes'): the least time the card could take for
    `flops` at the peak of the inputs' type and `nbytes` at the memory
    rate (3.35 TB/s).  bf16: the tensor cores' 989 TFLOP/s.  fp32: the
    CUDA cores' FFMA peak, 67 TFLOP/s, or with `tf32_split`, the fp32
    route of K4, three tf32 products for each fp32 one at the tensor
    cores' 495 TFLOP/s (so 165 TFLOP/s of fp32 work)."""
    if dtype == torch.bfloat16:
        t_ops = flops / BF16_FLOPS
    elif tf32_split:
        t_ops = 3 * flops / TF32_FLOPS
    else:
        t_ops = flops / FP32_FLOPS
    t_bytes = nbytes / HBM_BYTES
    return (1e3 * max(t_ops, t_bytes),
            'operations' if t_ops >= t_bytes else 'bytes')


def nbytes(*tensors):
    """Bytes of each tensor in its own shape (a broadcast operand once)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def open_key_nbytes(q1, q2, k, p, v, mask, out):
    """Bytes K1 must move where the mask closes whole key columns, as the
    serving step's cache mask does: q1, q2, the mask and the output whole,
    and k, p and v only at the key positions some query may attend (a p
    shared by the batch at those of any row); a closed key is never
    read."""
    B, h, _, d = q1.shape
    if mask.dim() == 4:
        mask = mask[:, 0]
    opened = mask.expand(B, mask.shape[1], mask.shape[2]).any(dim=1)
    per_key = h * d * k.element_size()
    p_keys = opened.sum() if p.shape[0] > 1 else opened.any(dim=0).sum()
    return (nbytes(q1, q2, mask, out) + 2 * per_key * int(opened.sum())
            + per_key * int(p_keys))


def attended_pairs(mask, B, h, T1, T2):
    """(query, key) pairs the mask lets through, over all heads."""
    if mask is None:
        return B * h * T1 * T2
    if mask.dim() == 3:
        mask = mask.unsqueeze(1)
    return int(mask.expand(B, h, T1, T2).sum())


_T0 = time.perf_counter()


def phase(name):
    print(f'== {name} (at {time.perf_counter() - _T0:.0f} s)', flush=True)


def host_ms(fn, reps=20):
    """The host's time to enqueue one call of `fn` (no synchronize)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * dt / reps


def cuda_time_ms(fn, reps=20, warmup=3):
    """The card's time for one call of `fn`: CUDA events around `reps`
    calls back to back.  The card first sleeps for twice the host's
    enqueue time of the calls, so that the events time the card's work
    and not the host's enqueue, which takes longer than a small kernel
    (a wrapper's checks and ctypes call, 0.05-0.1 ms)."""
    for _ in range(warmup):
        fn()
    enqueue = host_ms(fn, 2) / 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # cycles at 2 GHz, above the H100's top clock: at least that long
    torch.cuda._sleep(int(2e9 * (2 * reps * enqueue + 1e-3)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_rows(prof):
    """{name: [count, device ms]} of the kernels, copies and fills a
    torch.profiler run recorded (GPU user annotations left out), summed
    from its raw events: `key_averages()` first builds a Python event for
    every record, which takes the host far longer than the run itself
    when that holds 10^5 launches."""
    from torch.autograd import DeviceType
    rows = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        row = rows.setdefault(e.name(), [0, 0.0])
        row[0] += 1
        row[1] += e.duration_ns() / 1e6
    return rows


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
    print(f'attention kernels built in {time.perf_counter() - t0:.1f} s')
    for name in fa.SOURCES:
        log = fa.BUILD_DIR / f'{name}.log'
        if not log.exists():
            continue
        for line in log.read_text().splitlines():
            if 'Compiling entry' in line:
                print('  ' + line.split("'")[1][:110])
            elif 'registers' in line or 'spill' in line:
                print('    ' + line.strip())
    from wenet_tpu_torch.runtime import native_beam
    t0 = time.perf_counter()
    native_beam.build()
    print(f'C++ prefix-beam searcher built in '
          f'{time.perf_counter() - t0:.1f} s')


def kernel_inputs(rng, B, h, T1, T2, d, mask_kind, dtype):
    """q1, q2 as the attention module hands them, (B, h, T1, d) views of
    (B, T1, h, d) buffers (scaled by 8 for 'peaked'); k, v (B, h, T2, d);
    p (1, h, T2, d), shared by the batch, or (B, h, T2, d) for a batch of
    streams ('batch8'); the mask: (B, 1, T2) key
    padding ('pad', 'peaked'; 'tail': the last utterance T2 // 3 long, so
    that whole key blocks lie in its padding), with keys 64..191 closed
    ('gap'), a
    streaming chunk step's ('step': the last T1 keys are the chunk, the
    cache before it holds a random number of frames, none for the first
    utterance; `SERVING`'s kinds: the serving chunk step's right-aligned
    cache mask from `streaming_att_mask`, a row for each stream), or
    (B, T1, T2) static chunks
    of 16 over key padding ('chunk', 'masked_row' with row 5 of the first
    utterance closed)."""
    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).cuda()
    q1 = t(B, T1, h, d).transpose(1, 2)
    q2 = t(B, T1, h, d).transpose(1, 2)
    per_row_p = len(SERVING.get(mask_kind, ())) > 1  # a batch of streams
    k = t(B, h, T2, d)
    p = t(B if per_row_p else 1, h, T2, d)
    v = t(B, h, T2, d)
    lens = torch.from_numpy(rng.randint(T2 // 2, T2 + 1, size=B)).cuda()
    lens[0] = T2
    if mask_kind == 'tail':
        lens[-1] = T2 // 3
    keys = torch.arange(T2, device='cuda')
    pad = keys[None, :] < lens[:, None]
    if mask_kind in ('pad', 'peaked', 'gap', 'tail'):
        mask = pad[:, None, :]
        if mask_kind == 'peaked':  # a peaked softmax
            q1, q2 = q1 * 8, q2 * 8
        elif mask_kind == 'gap':
            mask = mask & ((keys < 64) | (keys >= 192))
    elif mask_kind == 'step':
        cache = torch.from_numpy(
            rng.randint(0, T2 - T1 + 1, size=B)).cuda()
        cache[0] = 0
        mask = (keys[None, :] >= T2 - T1 - cache[:, None])[:, None, :]
    elif mask_kind in SERVING:
        from wenet_tpu_torch.models.transformer.streaming import (
            streaming_att_mask)
        mask = torch.cat([streaming_att_mask(1, T2 - T1, T1, *row,
                                             device='cuda')
                          for row in SERVING[mask_kind]])
    elif mask_kind is None:
        mask = None
    else:
        rows = torch.arange(T1, device='cuda')[:, None] // 16
        mask = (keys[None, :] < (rows + 1) * 16)
        mask = mask[None] & pad[:, None, :]
        if mask_kind == 'masked_row':
            mask[0, 5] = False
    return [x.to(dtype) for x in (q1, q2, k, p, v)], mask


def share_of_bar(got, want, tol):
    """The largest share of its bar that an element's error takes."""
    diff = (got.float() - want.float()).abs()
    return (diff / (tol['atol'] + tol['rtol'] * want.float().abs())).max(
        ).item()


def kernel_check():
    phase('3 kernel vs plain')
    from wenet_tpu_torch.ops.flash_attention import (
        flash_attention_relpos, relpos_fwd_reference)
    rng = np.random.RandomState(SEED)
    report = None
    serving = {}  # mask kind -> readings at the serving chunk step
    zoo = {}  # shape -> readings at the encoder zoo's shapes
    max_err_fp32 = 0.0
    for i, (B, h, T1, T2, d, mask_kind) in enumerate(KERNEL_SHAPES):
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
            of_bar = share_of_bar(got, want, FLASH_TOL[dtype])
            torch.testing.assert_close(got.float(), want, **FLASH_TOL[dtype])
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
                  f'({100 * of_bar:.0f}% of the bar) kernel {ms:.4f} ms, '
                  f'plain {plain_ms:.4f} ms', flush=True)
            if dtype == torch.float32:
                max_err_fp32 = max(max_err_fp32, err)
            if mask_kind in SERVING:
                n_pairs = attended_pairs(mask, B, h, T1, T2)
                flops = 6 * d * n_pairs
                moved = open_key_nbytes(q1, q2, k, p, v, mask, got)
                b_ms, b_by = bound(flops, moved, dtype, tf32_split=True)
                lib_ms = relpos_sdpa(q1, q2, k, p, v, mask, scale, got)
                key = '' if dtype == torch.float32 else '_bf16'
                serving.setdefault(mask_kind, {}).update({
                    'ms' + key: ms, 'plain_ms' + key: plain_ms,
                    'bound_ms' + key: b_ms, 'bound_by' + key: b_by,
                    'library_ms' + key: lib_ms, 'max_abs_err' + key: err})
                print(f'    serving chunk step: {n_pairs} attended pairs, '
                      f'{moved} bytes over the open keys, bound '
                      f'{b_ms:.4g} ms ({b_by}), SDPA {lib_ms:.4f} ms, '
                      f'{flops / ms / 1e9:.2f} TFLOP/s', flush=True)
            if (B, h, T1, T2, d) in ZOO_KERNEL_SHAPES:
                n_pairs = attended_pairs(mask, B, h, T1, T2)
                flops = 6 * d * n_pairs
                b_ms, b_by = bound(flops, nbytes(q1, q2, k, p, v, mask, got),
                                   dtype, tf32_split=True)
                lib_ms = relpos_sdpa(q1, q2, k, p, v, mask, scale, got)
                key = '' if dtype == torch.float32 else '_bf16'
                zoo.setdefault(f'({B},{h},{T1},{T2},{d})', {}).update({
                    'ms' + key: ms, 'plain_ms' + key: plain_ms,
                    'bound_ms' + key: b_ms, 'bound_by' + key: b_by,
                    'library_ms' + key: lib_ms, 'max_abs_err' + key: err,
                    'share_of_bar' + key: of_bar,
                    'tflops' + key: flops / ms / 1e9})
                print(f'    zoo shape: bound {b_ms:.4f} ms ({b_by}), SDPA '
                      f'{lib_ms:.4f} ms, {flops / ms / 1e9:.1f} TFLOP/s',
                      flush=True)
            if i == 0:  # the first shape is the main path's
                # 3 products of 2*d FLOPs per attended pair; fp32 runs as
                # 3xTF32 (FFMA printed beside it)
                n_pairs = attended_pairs(mask, B, h, T1, T2)
                flops = 6 * d * n_pairs
                moved = nbytes(q1, q2, k, p, v, mask, got)
                b_ms, b_by = bound(flops, moved, dtype, tf32_split=True)
                lib_ms = relpos_sdpa(q1, q2, k, p, v, mask, scale, got)
                tflops = flops / ms / 1e9
                key = '' if dtype == torch.float32 else '_bf16'
                if report is None:
                    report = dict(plain_ms=plain_ms, bound_by=b_by)
                report.update({'ms' + key: ms, 'bound_ms' + key: b_ms,
                               'library_ms' + key: lib_ms,
                               'tflops' + key: tflops})
                extra = ''
                if dtype == torch.float32:
                    extra = (f' at 3xTF32, {bound(flops, moved)[0]:.4f} ms '
                             'at FFMA')
                wrapper_ms = host_ms(lambda: flash_attention_relpos(
                    q1, q2, k, p, v, mask, scale))
                # the same mask given a row per query: read per element
                # (tile_bits), not voted a tile ahead
                rows = mask.expand(B, T1, T2).contiguous()
                rows_ms = cuda_time_ms(lambda: flash_attention_relpos(
                    q1, q2, k, p, v, rows, scale))
                print(f'    main shape: {n_pairs / 1e6:.2f}M attended pairs, '
                      f'bound {b_ms:.4f} ms ({b_by}{extra}), SDPA '
                      f'{lib_ms:.4f} ms, {tflops:.1f} TFLOP/s; the host '
                      f'enqueues a call in {wrapper_ms:.4f} ms; the pad '
                      f'mask given per row {rows_ms:.4f} ms', flush=True)
    report['max_abs_err'] = max_err_fp32
    report['serving'] = serving
    report['zoo'] = zoo
    return report


def relpos_sdpa(q1, q2, k, p, v, mask, scale, want):
    """The one PyTorch call that computes K1 without dropout:
    SDPA([q1|q2], [k|p], v), since q1·kᵀ + q2·pᵀ = [q1|q2]·[k|p]ᵀ; its
    time (CUDA events) after checking it against the kernel's output."""
    import torch.nn.functional as F
    B = q1.shape[0]
    qc = torch.cat([q1, q2], -1)
    kc = torch.cat([k, p.expand(B, -1, -1, -1)], -1)
    m = None if mask is None else mask.unsqueeze(1)

    def call():
        return F.scaled_dot_product_attention(qc, kc, v, attn_mask=m,
                                              scale=scale)
    torch.testing.assert_close(call().float(), want.float(),
                               **TRAIN_TOL[q1.dtype])
    return cuda_time_ms(call)


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
    model = init_model(configs, torch.Generator().manual_seed(SEED),
                       device='cpu')
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
    k1 = [e for e in rows if 'relpos_fwd_' in e.key]
    k1_ms = sum(e.self_device_time_total for e in k1) / 1e3
    print(f'    K1: {k1_ms:.3f} ms over {sum(e.count for e in k1)} launches, '
          f'{100 * k1_ms / max(total, 1e-9):.1f}% of kernel time')
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
    main = {}  # dtype -> (times, bounds, TFLOP/s) at the main shape
    pad = {}  # dtype -> (times, SDPA forward / backward) at the pad shape
    zoo_main, zoo_pad = {}, {}  # the same at the zoo's d = 32 train shape
    for i, (B, h, T1, T2, d, mask_kind, rate) in enumerate(TRAIN_SHAPES):
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
            # the plain versions chained as the Function chains them, in
            # fp32 on the same inputs: the forward (K1's output and lse are
            # held to it below), delta = rowsum(do·out) of the Function's
            # own output, K1's (as the Function and the JAX package's
            # `_relpos_vjp_bwd` take it), plain K2 and K3, and dp summed
            # over the batch.  So K2 and K3 are held on the delta they were
            # given: a delta from the reference's own rounded output would
            # hold them to where K1's bf16 output rounds the other way,
            # which alone reads up to 105% of the bar on a peaked softmax
            # with exact kernels (tests/test_torch_relpos_bwd_precision.py).
            x32 = [t.float() for t in x]
            want, want_lse = fa.relpos_fwd_reference(*x32, mask, scale, True,
                                                     rate, seed)

            def chained(out_for_delta):
                args = (mask, do.float(), want_lse,
                        (do.float() * out_for_delta.float()).sum(-1), scale,
                        rate, seed)
                g = list(fa.relpos_bwd_dq_reference(*x32, *args) +
                         fa.relpos_bwd_dkpv_reference(*x32, *args))
                g[3] = g[3].sum(0, keepdim=True)
                return g
            want_grads = chained(out.detach())
            grads = [t.grad for t in leaves]
            if dtype == torch.bfloat16:
                # before: delta from the reference's output rounded to bf16
                old = chained(want.to(dtype))
                print('    bf16 dk / dp share of the bar, delta from the '
                      'rounded reference (before) -> from K1 (now): '
                      + ', '.join(
                          f'{n} {100 * share_of_bar(g, o, TRAIN_TOL[dtype]):.0f}%'
                          f' -> {100 * share_of_bar(g, w, TRAIN_TOL[dtype]):.0f}%'
                          for n, g, o, w in zip(('dk', 'dp'), grads[2:4],
                                                old[2:4], want_grads[2:4])),
                      flush=True)
            pairs = {
                'relpos_attention_fwd_train': [(out, want), (lse, want_lse)],
                'relpos_attention_bwd_dq': list(zip(grads[:2],
                                                    want_grads[:2])),
                'relpos_attention_bwd_dkpv': list(zip(grads[2:],
                                                      want_grads[2:])),
            }
            line = []
            for name, checks in pairs.items():
                err, shares = 0.0, []
                for out_name, (got, w) in zip(TRAIN_OUTPUTS[name], checks):
                    if not torch.isfinite(got).all():
                        raise RuntimeError(f'{name}: {out_name} is not '
                                           'finite')
                    torch.testing.assert_close(got.float(), w.float(),
                                               **TRAIN_TOL[dtype],
                                               msg=f'{name}: {out_name}')
                    err = max(err, (got.float() - w.float()).abs().max()
                              .item())
                    of_bar = share_of_bar(got, w, TRAIN_TOL[dtype])
                    shares.append(f'{out_name} {100 * of_bar:.0f}%')
                if dtype == torch.float32:
                    errs[name] = max(errs[name], err)
                line.append(f'{name[17:]} {err:.3g} ({", ".join(shares)} '
                            'of the bar)')
            if mask_kind == 'masked_row' and (out[0, :, 5].any() or
                                              grads[0][0, :, 5].any()):
                raise RuntimeError('fully masked row is not zero')
            # CUDA-event times of each kernel and its plain version on the
            # same lse and delta
            delta = (do.float() * want).sum(-1)
            args = (mask, do, want_lse, delta, scale, rate, seed)
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
            if i == 0 or (B, h, T1, T2, d) == ZOO_TRAIN_SHAPE:
                # the main path's shape, and the zoo's at its dropout
                n_pairs = attended_pairs(mask, B, h, T1, T2)
                common = nbytes(*x, mask, do, want_lse, delta)
                # 3, 5 and 6 products of 2*d FLOPs per attended pair; fp32
                # runs as 3xTF32 (FFMA printed beside it)
                work = {
                    'relpos_attention_fwd_train': (
                        6 * d * n_pairs, nbytes(*x, mask, out, lse)),
                    'relpos_attention_bwd_dq': (
                        10 * d * n_pairs, common + nbytes(*grads[:2])),
                    'relpos_attention_bwd_dkpv': (
                        12 * d * n_pairs, common + nbytes(*grads[2:])),
                }
                bounds = {n: bound(*w, dtype, tf32_split=True)
                          for n, w in work.items()}
                tflops = {n: w[0] / t[n][0] / 1e9 for n, w in work.items()}
                ffma = {n: bound(*w)[0] for n, w in work.items()}
                if i == 0:
                    main[dtype] = t, bounds, tflops, ffma
                elif rate > 0.0:
                    zoo_main[dtype] = t, bounds, tflops
                print('    bounds: ' + ', '.join(
                    f'{n[17:]} {b[0]:.4f} ms ({b[1]}'
                    + (f'; FFMA {ffma[n]:.4f}' if dtype == torch.float32
                       else '') + ')' for n, b in bounds.items())
                    + f'; {n_pairs / 1e6:.2f}M attended pairs; TFLOP/s: '
                    + ', '.join(f'{n[17:]} {f:.1f}'
                                for n, f in tflops.items()), flush=True)
            if rate == 0.0 and mask_kind == 'pad':
                readings = t, relpos_sdpa_train(x, mask, do, scale, out,
                                                grads)
                if (B, h, T1, T2, d) == ZOO_TRAIN_SHAPE:
                    zoo_pad[dtype] = readings
                else:
                    pad[dtype] = readings
            print(f'  ({B},{h},{T1},{T2},{d}) mask={mask_kind} '
                  f'dropout={rate} {str(dtype)[6:]}: max_abs_err '
                  + ', '.join(line), flush=True)
            print('    kernel / plain ms: ' + ', '.join(
                f'{n[17:]} {a:.4f} / {b:.4f}' for n, (a, b) in t.items()),
                flush=True)
    # the main shape's dropout has no library counterpart; K2's and K3's
    # library_ms is SDPA's backward at the pad shape, which computes both
    for dtype, (t, (_, sdpa_bwd)) in pad.items():
        both = (t['relpos_attention_bwd_dq'][0] +
                t['relpos_attention_bwd_dkpv'][0])
        print(f'  K2 + K3 at {PAD_SHAPE}, {str(dtype)[6:]}: {both:.4f} ms '
              f'against SDPA backward {sdpa_bwd:.4f} ms '
              f'({both / sdpa_bwd:.2f}x)', flush=True)
    report = {}
    for name in TRAIN_KERNELS:
        entry = dict(max_abs_err=errs[name])
        for dtype, key in ((torch.float32, ''), (torch.bfloat16, '_bf16')):
            times, bounds, tflops, ffma = main[dtype]
            pad_times, (sdpa_fwd, sdpa_bwd) = pad[dtype]
            entry.update({'ms' + key: times[name][0],
                          'bound_ms' + key: bounds[name][0],
                          'tflops' + key: tflops[name],
                          'ms_pad' + key: pad_times[name][0]})
            if dtype == torch.float32:
                entry.update(plain_ms=times[name][1], bound_by=bounds[name][1],
                             bound_ms_ffma=ffma[name])
            if name == 'relpos_attention_fwd_train':
                entry['library_ms' + key] = None
            else:
                entry['library_ms' + key] = sdpa_bwd
        if name != 'relpos_attention_fwd_train':
            entry['library_of'] = (f'K2 + K3: SDPA backward (dq, dk, dv) at '
                                   f'{PAD_SHAPE}, no dropout')
        zoo = {}
        for dtype, key in ((torch.float32, ''), (torch.bfloat16, '_bf16')):
            times, bounds, tflops = zoo_main[dtype]
            pad_times, (sdpa_fwd, sdpa_bwd) = zoo_pad[dtype]
            zoo.update({'ms' + key: times[name][0],
                        'plain_ms' + key: times[name][1],
                        'bound_ms' + key: bounds[name][0],
                        'bound_by' + key: bounds[name][1],
                        'tflops' + key: tflops[name],
                        'ms_nodropout' + key: pad_times[name][0],
                        'library_ms' + key: (
                            sdpa_fwd if name == 'relpos_attention_fwd_train'
                            else sdpa_bwd)})
        entry['zoo'] = {'shape': '(16,8,150,150,32) chunk, dropout 0.1; SDPA '
                        'and ms_nodropout at the pad mask, no dropout',
                        **zoo}
        report[name] = entry
    return report


def relpos_sdpa_train(x, mask, do, scale, out, grads):
    """SDPA forward and its backward (dq, dk, dv of [q1|q2], [k|p], v in
    one call: K2 and K3 together) on the kernels' inputs without dropout,
    checked against the kernels' outputs and timed (CUDA events);
    prints and returns the times (forward, backward) in ms."""
    import torch.nn.functional as F
    q1, q2, k, p, v = x
    B, _, _, d = q1.shape
    tol = TRAIN_TOL[q1.dtype]
    qc = torch.cat([q1, q2], -1).detach().requires_grad_()
    kc = torch.cat([k, p.expand(B, -1, -1, -1)], -1).detach()
    kc.requires_grad_()
    vv = v.detach().requires_grad_()
    m = mask.unsqueeze(1) if mask.dim() == 3 else mask
    with torch.enable_grad():
        o = F.scaled_dot_product_attention(qc, kc, vv, attn_mask=m,
                                           scale=scale)
        dq, dk, dv = torch.autograd.grad(o, (qc, kc, vv), do,
                                         retain_graph=True)
    torch.testing.assert_close(o.detach().float(), out.detach().float(),
                               **tol)
    for got, want in ((dq[..., :d], grads[0]), (dq[..., d:], grads[1]),
                      (dk[..., :d], grads[2]),
                      (dk[..., d:].sum(0, keepdim=True), grads[3]),
                      (dv, grads[4])):
        torch.testing.assert_close(got.float(), want.float(), **tol)
    fwd_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        qc.detach(), kc.detach(), vv, attn_mask=m, scale=scale))
    bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(
        o, (qc, kc, vv), do, retain_graph=True))
    print(f'    SDPA, no dropout, {str(q1.dtype)[6:]}: forward {fwd_ms:.4f} '
          f'ms, backward (dq, dk, dv: K2 + K3 together) {bwd_ms:.4f} ms',
          flush=True)
    return fwd_ms, bwd_ms


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
              + ' '.join(f'{k[17:]}={launches[k]}' for k in TRAIN_KERNELS))
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
    resumed = restore_optimizer_step(TrainState(fresh, opt2), infos['step'],
                                     accum)
    lr_next, lr_resumed = schedule(state.updates), schedule2(resumed.updates)
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
        for label, key in (('K1', 'relpos_fwd_'),
                           ('K2', 'relpos_bwd_dq_'),
                           ('K3', 'relpos_bwd_dkpv_')):
            ms = sum(e.self_device_time_total for e in rows
                     if key in e.key) / 1e3
            print(f'    {label} {key}: {ms:.3f} ms, '
                  f'{100 * ms / max(total, 1e-9):.1f}% of kernel time')
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:15]:
            ms = e.self_device_time_total / 1e3
            print(f'    {ms:8.3f} ms {100 * ms / max(total, 1e-9):5.1f}% '
                  f'x{e.count:<4d} {e.key[:80]}')


# ---------------------------------------------------------------------------
# 7. the whisper decode slice
# ---------------------------------------------------------------------------
def flash_inputs(rng, B, h, T1, T2, d, mask_kind, use_bias, dtype):
    """q, k, v as (B, h, T, d) views of (B, T, h, d) buffers, as the
    attention module hands them (q scaled by 8 and contiguous for
    'peaked'); the mask (B, 1, 1|T1, T2) bool; the bias
    fp32, (1, h, T1, T2) when `use_bias` is True, else of the shape it
    gives (or None)."""
    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).cuda()
    q, k, v = (t(B, T, h, d).transpose(1, 2).to(dtype)
               for T in (T1, T2, T2))
    lens = torch.from_numpy(rng.randint(T2 // 2, T2 + 1, size=B)).cuda()
    lens[0] = T2
    pad = torch.arange(T2, device='cuda')[None, :] < lens[:, None]
    mask = None
    if mask_kind in ('pad', 'peaked', 'gap'):
        mask = pad[:, None, None, :]
        if mask_kind == 'peaked':  # a peaked softmax
            q = q * 8
        elif mask_kind == 'gap':  # keys 64..191 closed for every query
            keys = torch.arange(T2, device='cuda')
            mask = mask & ((keys < 64) | (keys >= 192))
    elif mask_kind in ('rows', 'masked_row'):  # causal over key padding
        rows = torch.arange(T1, device='cuda')[:, None]
        mask = ((torch.arange(T2, device='cuda')[None, :] <= rows)[None]
                & pad[:, None, :])[:, None]
        if mask_kind == 'masked_row':
            mask[0, 0, 5] = False
    if use_bias is True:
        use_bias = (1, h, T1, T2)
    bias = t(*use_bias) * 0.5 if use_bias else None
    return q, k, v, mask, bias


def flash_sdpa(q, k, v, mask, bias, scale, want):
    """The one PyTorch call that computes K4: SDPA with the boolean mask,
    or with where(mask, bias·scale, -inf) when there is a bias; its time
    (CUDA events).  It is checked against the kernel on the rows that
    are not fully masked, with those rows opened in the mask (SDPA gives
    NaN there, the kernel 0); NaN elsewhere is reported, not raised: the
    call is a yardstick, not part of the port."""
    import torch.nn.functional as F

    def as_sdpa_mask(mask):
        if bias is None:
            return mask
        if mask is None:
            return (bias * scale).to(q.dtype)
        return torch.where(mask, bias * scale, -float('inf')).to(q.dtype)

    m = as_sdpa_mask(mask)
    rows = None
    check_mask = m
    if mask is not None:
        rows = mask.expand(q.shape[0], -1, q.shape[2], -1).any(-1)
        check_mask = as_sdpa_mask(mask | ~rows[..., None])
    got = F.scaled_dot_product_attention(q, k, v, attn_mask=check_mask,
                                         scale=scale).float()
    want = want.float()
    if rows is not None:
        rows = rows.expand(-1, q.shape[1], -1)
        got, want = got[rows], want[rows]
    bad = int((~torch.isfinite(got)).any(-1).sum())
    if bad:
        print(f'    SDPA gave non-finite values on {bad} attended rows',
              flush=True)
    else:
        torch.testing.assert_close(got, want, **TRAIN_TOL[q.dtype])
    return cuda_time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=m, scale=scale))


def flash_kernel_check():
    phase('7a K4 masked flash attention vs plain, SDPA and the bound')
    from wenet_tpu_torch.models.transformer import attention as A
    from wenet_tpu_torch.ops import flash_attention as fa
    rng = np.random.RandomState(SEED + 6)
    report, max_err, zoo = None, 0.0, {}
    for i, (B, h, T1, T2, d, mask_kind, use_bias) in enumerate(FLASH_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, mask, bias = flash_inputs(rng, B, h, T1, T2, d,
                                               mask_kind, use_bias, dtype)
            scale = 1.0 / d ** 0.5
            got = fa.flash_attention(q, k, v, mask, bias, scale)
            torch.cuda.synchronize()
            want, _ = fa.flash_fwd_reference(q.float(), k.float(),
                                             v.float(), mask, bias, scale)
            err = (got.float() - want).abs().max().item()
            tol = FLASH_TOL[dtype]
            of_bar = share_of_bar(got, want, tol)
            torch.testing.assert_close(got.float(), want, **tol)
            if not torch.isfinite(got).all():
                raise RuntimeError('K4 output is not finite')
            if mask_kind == 'masked_row' and got[0, :, 5].any():
                raise RuntimeError('K4: fully masked row is not zero')
            ms = cuda_time_ms(
                lambda: fa.flash_attention(q, k, v, mask, bias, scale))
            plain_ms = cuda_time_ms(
                lambda: fa.flash_fwd_reference(q, k, v, mask, bias, scale))
            lib_ms = flash_sdpa(q, k, v, mask, bias, scale, got)
            # 2 products of 2*d FLOPs per attended pair
            flops = 4 * d * attended_pairs(mask, B, h, T1, T2)
            moved = nbytes(q, k, v, mask, bias, got)
            b_ms, b_by = bound(flops, moved, dtype, tf32_split=True)
            extra = ''
            if dtype == torch.float32:  # 3xTF32, beside the CUDA cores' FFMA
                extra = f' at 3xTF32, {bound(flops, moved)[0]:.4f} ms at FFMA'
            print(f'  ({B},{h},{T1},{T2},{d}) mask={mask_kind} '
                  f'bias={use_bias} {str(dtype)[6:]}: max_abs_err={err:.3g} '
                  f'({100 * of_bar:.0f}% of the bar) kernel {ms:.4f} ms, '
                  f'plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, '
                  f'bound {b_ms:.4f} ms ({b_by}{extra}); '
                  f'{flops / ms / 1e9:.1f} TFLOP/s', flush=True)
            if dtype == torch.float32:
                max_err = max(max_err, err)
            if i == 0 and dtype == torch.float32:  # whisper's encoder
                report = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                              bound_by=b_by, library_ms=lib_ms,
                              tflops=flops / ms / 1e9)
            elif i == 0:
                report.update(ms_bf16=ms, bound_ms_bf16=b_ms,
                              library_ms_bf16=lib_ms,
                              tflops_bf16=flops / ms / 1e9)
            if (B, h, T1, T2, d) == ZOO_FLASH_SHAPE:
                key = '' if dtype == torch.float32 else '_bf16'
                zoo.update({'ms' + key: ms, 'plain_ms' + key: plain_ms,
                            'bound_ms' + key: b_ms, 'bound_by' + key: b_by,
                            'library_ms' + key: lib_ms,
                            'max_abs_err' + key: err,
                            'share_of_bar' + key: of_bar,
                            'tflops' + key: flops / ms / 1e9})

    # the gate: K4 against attention_core's ordinary path above and below
    for B, h, T1, T2, d in (FLASH_SHAPES[0][:5], GATE_BELOW):
        q, k, v, mask, _ = flash_inputs(rng, B, h, T1, T2, d, 'pad', False,
                                        torch.float32)
        scale = 1.0 / d ** 0.5
        above = A.flash_eligible(q, k)
        saved = dict(A.FLASH_GATE)
        A.FLASH_GATE.update(min_len=1 << 40, score_elems=1 << 62)
        try:
            fa.reset_launches()
            plain = A.attention_core(q, k, v, mask, scale)
            if fa.LAUNCHES['flash_attention_fwd']:
                raise RuntimeError('the gate did not close')
            plain_ms = cuda_time_ms(
                lambda: A.attention_core(q, k, v, mask, scale))
        finally:
            A.FLASH_GATE.update(saved)
        ms = cuda_time_ms(lambda: fa.flash_attention(q, k, v, mask, None,
                                                     scale))
        torch.testing.assert_close(
            fa.flash_attention(q, k, v, mask, None, scale), plain,
            **TRAIN_TOL[torch.float32])
        print(f'  gate at ({B},{h},{T1},{T2},{d}) fp32, '
              f'{"above" if above else "below"} it: K4 {ms:.4f} ms, '
              f'ordinary path {plain_ms:.4f} ms', flush=True)
    report['max_abs_err'] = max_err
    report['zoo'] = {'shape': str(ZOO_FLASH_SHAPE).replace(' ', '') + ' pad',
                     **zoo}
    return report


def whisper_configs(n_layers):
    """whisper large-v3 (build_config of the port's converter) at full
    width with `n_layers` encoder and decoder blocks."""
    from wenet_tpu_torch.models.whisper.convert import (
        build_config, default_special_tokens)
    configs = build_config(WHISPER_V3, default_special_tokens(51866))
    configs['encoder_conf']['num_blocks'] = n_layers
    configs['decoder_conf']['num_blocks'] = n_layers
    return configs


def mel_features(rng, B, T, min_len):
    feats = rng.randn(B, T, WHISPER_V3['n_mels']).astype(np.float32)
    lens = rng.randint(min_len, T + 1, size=B).astype(np.int64)
    lens[0] = T
    return feats, lens


def shape_decoder_weights(model, generator, logit_std=7.0):
    """Random tied N(0, 1) token embeddings make every step repeat its
    input token, and a random decoder falls into a fixed point where eot
    either always or never wins.  Redraw the embeddings at N(0, 0.02),
    the learned positions at N(0, 1) (so each step's state moves with its
    position) and set the final norm's gain so that the output keeps a
    standard deviation of about `logit_std` logits."""
    dec = model.decoder
    d = dec.embed[0].weight.shape[1]
    with torch.no_grad():
        dec.embed[0].weight.normal_(0.0, 0.02, generator=generator)
        dec.embed[1].pe.normal_(0.0, 1.0, generator=generator)
        dec.after_norm.weight.fill_(logit_std / (0.02 * d ** 0.5))


def set_eot_bias(model, value):
    with torch.no_grad():
        model.decoder.output_layer.bias[model.eos] = value


class _TooLong(Exception):
    pass


def calibrate_eot_bias(model, eo, em, beam, infos_list=(None,), high=200):
    """Random weights never emit eot: set its output bias (a real
    parameter, zero in OpenAI's checkpoints) to the least value, within
    1/8 of the first step's log-prob spread, at which every hypothesis
    of these decodes ends within `high` tokens.  Trials are cut once a
    decode passes `high` tokens.  Returns the bias and the lengths."""
    from wenet_tpu_torch.models.transformer.search import (
        _decode_prefix, attention_beam_search)
    prefix, _ = _decode_prefix(model, 1, 1, None)
    with torch.inference_mode():
        state = model.decoder_init_state(eo[:1], prefix.shape[1])
        for i in range(prefix.shape[1]):
            logp, state = model.decoder_forward_step(
                torch.from_numpy(prefix[:, i:i + 1]).to(eo.device), i,
                state, em[:1])
    sigma = float(logp.float().std())
    forward_step = model.decoder_forward_step
    trials = []

    def capped(tokens, step, *args):
        if step > prefix.shape[1] + high:
            raise _TooLong
        return forward_step(tokens, step, *args)

    def lengths(value):
        """Hypothesis lengths of every decode, None if one runs long."""
        set_eot_bias(model, value)
        trials.append(value)
        out = []
        try:
            with torch.inference_mode():
                for infos in infos_list:
                    out += [len(r.tokens) for r in attention_beam_search(
                        model, eo, em, beam, infos=infos)]
        except _TooLong:
            return None
        return out

    model.decoder_forward_step = capped
    try:
        ok, step = 3.0 * sigma, sigma
        while lengths(ok) is None:
            ok, step = ok + step, 2 * step
        low = ok - sigma
        while lengths(low) is not None:
            ok, low = low, low - sigma
        while ok - low > sigma / 8:
            mid = 0.5 * (ok + low)
            if lengths(mid) is None:
                low = mid
            else:
                ok = mid
        found = lengths(ok)
    finally:
        model.decoder_forward_step = forward_step
    print(f'  eot bias {ok:.3f} after {len(trials)} trials (first '
          f'log-probs\' std {sigma:.3f}): hypothesis lengths {found}',
          flush=True)
    return ok


def whisper_check():
    phase('7b whisper large-v3 (4 + 4 layers) decode on the card vs the CPU')
    from wenet_tpu_torch.models.runner import AsrRunner
    from wenet_tpu_torch.ops import flash_attention as fa
    from wenet_tpu_torch.utils.init_model import init_model
    configs = whisper_configs(4)
    gen = torch.Generator().manual_seed(SEED)
    model = init_model(configs, gen, device='cpu')
    shape_decoder_weights(model, gen)
    cpu_model = copy.deepcopy(model)
    runner = AsrRunner(model, 'cuda')
    cpu_runner = AsrRunner(cpu_model, 'cpu')
    feats, lens = mel_features(np.random.RandomState(SEED + 7), 2, 1400,
                               1200)  # 14 s and 12-14 s: T' = 600-700
    x, n = torch.from_numpy(feats), torch.from_numpy(lens)
    with torch.inference_mode():
        eo, em = runner.model.forward_encoder(x.cuda(), n.cuda())
        ceo, cem = cpu_model.forward_encoder(x, n)
    err = (eo.cpu() - ceo).abs().max().item()
    print(f'  encoder_out {tuple(eo.shape)}: max |card - cpu| = {err:.3g} '
          f'(bar 2e-4)')
    if not torch.isfinite(eo).all() or err > 2e-4:
        raise RuntimeError('whisper encoder output differs from the CPU')
    if not torch.equal(em.cpu(), cem):
        raise RuntimeError('encoder masks differ between card and CPU')
    decodes = ({'langs': ['en', 'zh']},
               {'langs': ['en', 'zh'], 'no_timestamp': False})
    set_eot_bias(cpu_model,
                 calibrate_eot_bias(runner.model, eo, em, 5, decodes))
    launches = None
    for infos in decodes:
        fa.reset_launches()
        got = runner.decode(['attention'], feats, lens, beam_size=5,
                            infos=infos)['attention']
        torch.cuda.synchronize()
        n_k4 = fa.LAUNCHES['flash_attention_fwd']
        launches = n_k4 if launches is None else launches
        want = cpu_runner.decode(['attention'], feats, lens, beam_size=5,
                                 infos=infos)['attention']
        kind = 'timestamps' if 'no_timestamp' in infos else 'no timestamps'
        print(f'  {kind}: K4 launches {n_k4}; hypothesis lengths '
              f'{[len(r.tokens) for r in got]}; scores card '
              f'{[round(r.score, 4) for r in got]} cpu '
              f'{[round(r.score, 4) for r in want]}', flush=True)
        if n_k4 != configs['encoder_conf']['num_blocks']:
            raise RuntimeError(f'expected one K4 launch per encoder layer, '
                               f'got {n_k4}')
        if [r.tokens for r in got] != [r.tokens for r in want]:
            raise RuntimeError(f'{kind}: hypotheses differ from the CPU')
        if not all(np.isfinite(r.score) for r in got):
            raise RuntimeError(f'{kind}: a score is not finite')
    return launches


def whisper_speed(smi):
    phase('7c whisper large-v3 decode speed (informational)')
    from torch.profiler import ProfilerActivity, profile
    from wenet_tpu_torch.models.runner import AsrRunner
    from wenet_tpu_torch.utils.init_model import init_model
    configs = whisper_configs(32)
    t0 = time.perf_counter()
    gen = torch.Generator('cuda').manual_seed(SEED)
    model = init_model(configs, gen, device='cuda')
    shape_decoder_weights(model, gen)
    set_eot_bias(model, WHISPER_SPEED_EOT_BIAS)
    print(f'  32 + 32 layers built on the card in '
          f'{time.perf_counter() - t0:.1f} s '
          f'({sum(p.numel() for p in model.parameters()) / 1e9:.3f}B '
          f'parameters); eot bias {WHISPER_SPEED_EOT_BIAS}')
    feats, lens = mel_features(np.random.RandomState(SEED + 8), 4, 3000,
                               2000)  # 20-30 s, padded to 30 s: T' = 1500
    audio = float(lens.sum()) / 100
    for dtype in (torch.float32, torch.bfloat16):
        runner = AsrRunner(model, 'cuda',
                           dtype=None if dtype == torch.float32 else dtype)
        steps, encoder = [], []
        forward_step = runner.model.decoder_forward_step
        forward_encoder = runner.model.forward_encoder

        def counted(*args):
            steps[-1] += 1
            return forward_step(*args)

        def timed_encoder(*args):
            """The encoder's device time between two CUDA events (no
            synchronization added to the decode)."""
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = forward_encoder(*args)
            end.record()
            encoder.append((start, end))
            return out
        runner.model.decoder_forward_step = counted
        runner.model.forward_encoder = timed_encoder

        def decode():
            """One `AsrRunner.decode(['attention'])` of the batch, end to
            end: features from the host, encoder, beam search."""
            steps.append(0)
            t0 = time.perf_counter()
            out = runner.decode(['attention'], feats, lens, beam_size=5)
            torch.cuda.synchronize()
            return out['attention'], time.perf_counter() - t0

        decode()  # warm-up
        torch.cuda.reset_peak_memory_stats()
        out, wall = decode()
        peak = torch.cuda.max_memory_allocated() / 2**30
        enc_s = encoder[-1][0].elapsed_time(encoder[-1][1]) / 1e3
        rest_s = wall - enc_s
        print(f'  {str(dtype)[6:]} B=4, {audio:.1f} s of audio: decode '
              f'{wall * 1e3:.1f} ms end to end over {steps[-1]} decoder '
              f'steps, {audio / wall:.1f} audio-sec/s; encoder '
              f'{enc_s * 1e3:.1f} ms (CUDA events), beam search and the '
              f'rest {rest_s * 1e3:.1f} ms ({rest_s * 1e3 / steps[-1]:.2f} '
              f'ms/step); peak device memory {peak:.2f} GiB; hypothesis '
              f'lengths {[len(r.tokens) for r in out]} ({smi})', flush=True)
        t_prof = time.perf_counter()
        # CUDA activity only: recording every host op would slow the
        # host-bound beam loop further
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, prof_wall = decode()
        rows = device_rows(prof)
        total = sum(ms for _, ms in rows.values())
        k4 = sum(ms for key, (_, ms) in rows.items() if 'flash_fwd_' in key)
        busy = 100 * total / (prof_wall * 1e3)
        print(f'    kernel time in one profiled decode: {total:.2f} ms of '
              f'{prof_wall * 1e3:.1f} ms wall ({busy:.0f}% device busy); '
              f'K4 {k4:.2f} ms ({100 * k4 / max(total, 1e-9):.1f}% of '
              f'kernel time)', flush=True)
        for key, (count, ms) in sorted(rows.items(),
                                       key=lambda r: -r[1][1])[:12]:
            print(f'    {ms:8.3f} ms {100 * ms / max(total, 1e-9):5.1f}% '
                  f'x{count:<5d} {key[:80]}')
        print(f'    profiled and tabled in {time.perf_counter() - t_prof:.1f}'
              f' s', flush=True)
        del runner.model.decoder_forward_step, runner.model.forward_encoder


# ---------------------------------------------------------------------------
# 8. the whisper LoRA train slice
# ---------------------------------------------------------------------------
FLASH_TRAIN_KERNELS = {  # name: (source, TPU kernel it replaces)
    'flash_attention_fwd_train': ('wenet_tpu_torch/csrc/flash_attention.cu',
                                  'wenet_tpu/ops/flash_attention.py:68'),
    'flash_attention_bwd_dq': ('wenet_tpu_torch/csrc/flash_attention_bwd.cu',
                               'wenet_tpu/ops/flash_attention.py:237'),
    'flash_attention_bwd_dkv': ('wenet_tpu_torch/csrc/flash_attention_bwd.cu',
                                'wenet_tpu/ops/flash_attention.py:288'),
}
FLASH_TRAIN_SHAPES = [  # B, h, T1, T2, d, mask, bias shape
    (2, 20, 1500, 1500, 64, 'pad', None),   # the train step's encoder, 2 x 30 s
    (4, 20, 1000, 1000, 64, 'pad', None),   # four 20 s utterances
    (2, 4, 37, 53, 64, None, None),          # ragged edges, no mask
    (1, 2, 130, 257, 32, 'rows', (1, 2, 130, 257)),  # rows mask + bias
    (2, 2, 130, 257, 32, 'rows', (2, 2, 130, 257)),  # dbias per (b, h)
    (2, 2, 130, 257, 32, 'rows', (1, 2, 130, 257)),  # summed over the batch
    (2, 2, 130, 257, 32, 'rows', (2, 130, 257)),     # summed over the heads
    (2, 4, 64, 64, 64, 'masked_row', None),  # one fully masked row
    (2, 4, 600, 600, 128, 'pad', None),      # d = 128
    (2, 4, 300, 300, 64, 'peaked', None),    # q scaled by 8
    (2, 4, 200, 448, 64, 'gap', (2, 4, 200, 448)),  # closed tiles + bias
    (2, 4, 129, 300, 64, 'pad', (2, 4, 129, 300)),  # T1 = 129 + bias
]
FINETUNE_CONFIG = os.path.join(REPO, 'examples/aishell/whisper/conf/'
                               'finetune_whisper_largev3.yaml')
WHISPER_TRAIN_LR = 2e-4  # 8b's twenty steps on one batch, no warmup


def flash_train_kernel_check():
    phase('8a K4-train, K5, K6 (masked flash attention backward) vs plain')
    from wenet_tpu_torch.ops import flash_attention as fa
    rng = np.random.RandomState(SEED + 9)
    errs = {name: 0.0 for name in FLASH_TRAIN_KERNELS}
    report = None
    for i, (B, h, T1, T2, d, mask_kind, bias_shape) in enumerate(
            FLASH_TRAIN_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, mask, bias = flash_inputs(rng, B, h, T1, T2, d,
                                               mask_kind, bias_shape, dtype)
            do = torch.from_numpy(
                rng.randn(B, h, T1, d).astype(np.float32)).cuda().to(dtype)
            scale = 1.0 / d ** 0.5
            # the kernels: K4-train in the Function's forward, K5 and K6
            # in its backward (dbias summed over the broadcast dims)
            leaves = [t.detach().requires_grad_()
                      for t in (q, k, v, bias) if t is not None]
            out = fa.flash_attention(*leaves[:3], mask,
                                     leaves[3] if bias is not None else None,
                                     scale)
            out.backward(do)
            _, lse = fa.flash_fwd(q, k, v, mask, bias, scale, True)
            torch.cuda.synchronize()
            # the plain versions chained as the Function chains them, in
            # fp32 on the same inputs: the forward, its output rounded to
            # the Function's type, delta = rowsum(do·out) of that (as the
            # JAX package's `_bwd_call` takes it), plain K5 and K6, and
            # dbias summed over the bias's broadcast dims.  In fp32 this
            # is dense autograd; in bf16 dense autograd would also hold
            # the kernels to the rounding of out, which on the peaked
            # shape alone takes dk past the bar with exact kernels.
            grads = [t.grad for t in leaves]
            x32 = [t.float() for t in (q, k, v)]
            want, want_lse = fa.flash_fwd_reference(*x32, mask, bias, scale,
                                                    True)
            ref_args = (mask, bias, do.float(), want_lse,
                        (do.float() * want.to(dtype).float()).sum(-1), scale)
            want_dq, want_dbias = fa.flash_bwd_dq_reference(*x32, *ref_args)
            want_grads = [want_dq,
                          *fa.flash_bwd_dkv_reference(*x32, *ref_args)]
            if bias is not None:
                b4 = bias if bias.dim() == 4 else bias.unsqueeze(1)
                dims = [i for i in range(4) if b4.shape[i] == 1]
                want_grads.append((want_dbias.sum(dims, keepdim=True)
                                   if dims else want_dbias).view(bias.shape))
            # K4-train is held to K4's bars (its output to its dtype's,
            # its fp32 lse to fp32's), the gradients to TRAIN_TOL
            g_tol = TRAIN_TOL[dtype]
            pairs = {
                'flash_attention_fwd_train': [
                    (out, want, FLASH_TOL[dtype]),
                    (lse, want_lse, FLASH_TOL[torch.float32])],
                'flash_attention_bwd_dq': [
                    (grads[0], want_grads[0], g_tol)] + (
                    [(grads[3], want_grads[3], g_tol)]
                    if bias is not None else []),
                'flash_attention_bwd_dkv': [
                    (g, w, g_tol) for g, w in zip(grads[1:3],
                                                  want_grads[1:3])],
            }
            line = []
            for name, checks in pairs.items():
                err = of_bar = 0.0
                for got, w, tol in checks:
                    if not torch.isfinite(got).all():
                        raise RuntimeError(f'{name}: output is not finite')
                    diff = (got.float() - w.float()).abs()
                    torch.testing.assert_close(got.float(), w.float(),
                                               **tol, msg=name)
                    err = max(err, diff.max().item())
                    of_bar = max(of_bar, share_of_bar(got, w, tol))
                if dtype == torch.float32:
                    errs[name] = max(errs[name], err)
                line.append(f'{name[16:]} {err:.3g} ({100 * of_bar:.0f}% '
                            f'of the bar)')
            if mask_kind == 'masked_row' and (
                    out[0, :, 5].any() or grads[0][0, :, 5].any()
                    or not lse[0, :, 5].eq(fa.NEG_INF).all()):
                raise RuntimeError('fully masked row: output or dq not zero, '
                                   'or lse not NEG_INF')
            # CUDA-event times of each kernel and of its plain version on
            # the same lse and delta
            delta = (do.float() * want.detach()).sum(-1)
            args = (mask, bias, do, want_lse.detach(), delta, scale)
            t = {
                'flash_attention_fwd_train': (
                    cuda_time_ms(lambda: fa.flash_fwd(
                        q, k, v, mask, bias, scale, True)),
                    cuda_time_ms(lambda: fa.flash_fwd_reference(
                        q, k, v, mask, bias, scale, True))),
                'flash_attention_bwd_dq': (
                    cuda_time_ms(lambda: fa.flash_bwd_dq(q, k, v, *args)),
                    cuda_time_ms(lambda: fa.flash_bwd_dq_reference(
                        q, k, v, *args))),
                'flash_attention_bwd_dkv': (
                    cuda_time_ms(lambda: fa.flash_bwd_dkv(q, k, v, *args)),
                    cuda_time_ms(lambda: fa.flash_bwd_dkv_reference(
                        q, k, v, *args))),
            }
            n_pairs = attended_pairs(mask, B, h, T1, T2)
            common = nbytes(q, k, v, mask, bias, do, want_lse, delta)
            # 2, 3 and 4 products of 2*d FLOPs per pair; each kernel's
            # fp32 route is 3xTF32 (FFMA printed beside it)
            work = {
                'flash_attention_fwd_train': (
                    4 * d * n_pairs, nbytes(q, k, v, mask, bias, out, lse)),
                'flash_attention_bwd_dq': (
                    6 * d * n_pairs, common + nbytes(grads[0]) + (
                        4 * B * h * T1 * T2 if bias is not None else 0)),
                'flash_attention_bwd_dkv': (
                    8 * d * n_pairs, common + nbytes(*grads[1:3])),
            }
            bounds = {n: bound(*w, dtype, tf32_split=True)
                      for n, w in work.items()}
            sdpa = None
            if bias is None and mask_kind in ('pad', None):
                sdpa = flash_sdpa_train(q, k, v, mask, scale, do, out,
                                        grads[:3])
            print(f'  ({B},{h},{T1},{T2},{d}) mask={mask_kind} '
                  f'bias={bias_shape} {str(dtype)[6:]}: max_abs_err '
                  + ', '.join(line), flush=True)
            print('    kernel / plain / bound ms: ' + ', '.join(
                f'{n[16:]} {a:.4f} / {b:.4f} / {bounds[n][0]:.4f} '
                f'({bounds[n][1]}' + (
                    f', FFMA {bound(*work[n])[0]:.4f}'
                    if dtype == torch.float32 else '') + ')'
                for n, (a, b) in t.items())
                + ('' if sdpa is None else
                   f'; SDPA forward {sdpa[0]:.4f}, backward (dq, dk, dv '
                   f'together) {sdpa[1]:.4f}'), flush=True)
            if i == 0:  # the first shape is the main path's
                # SDPA's forward is K4-train's yardstick, its backward
                # K5 + K6 together's
                key = '' if dtype == torch.float32 else '_bf16'
                if report is None:
                    report = {n: {} for n in FLASH_TRAIN_KERNELS}
                for n in FLASH_TRAIN_KERNELS:
                    report[n].update({
                        'ms' + key: t[n][0], 'bound_ms' + key: bounds[n][0],
                        'library_ms' + key: sdpa[0 if n.endswith('train')
                                                 else 1]})
                    if not key:
                        report[n].update(plain_ms=t[n][1],
                                         bound_by=bounds[n][1])
                tflops = [f * d * n_pairs / t[n][0] / 1e9 for f, n in
                          zip((4, 6, 8), FLASH_TRAIN_KERNELS)]
                for n, x in zip(FLASH_TRAIN_KERNELS, tflops):
                    report[n]['tflops' + key] = x
                print(f'    main shape: {n_pairs / 1e6:.1f}M attended pairs; '
                      + ' / '.join(f'{x:.1f}' for x in tflops)
                      + ' TFLOP/s (K4-train / K5 / K6)', flush=True)
    for name in FLASH_TRAIN_KERNELS:
        report[name]['max_abs_err'] = errs[name]
    return report


def flash_sdpa_train(q, k, v, mask, scale, do, out, grads):
    """One `F.scaled_dot_product_attention` forward (inputs requiring
    grad, so it keeps what its backward needs) and its backward (dq, dk
    and dv in one call) with the boolean mask: checked against the
    kernels' outputs and timed (CUDA events) -> (forward ms, backward
    ms).  The yardstick of K4-train, K5 and K6; the port never calls it."""
    import torch.nn.functional as F
    x = [t.detach().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        o = F.scaled_dot_product_attention(*x, attn_mask=mask, scale=scale)
        g = torch.autograd.grad(o, x, do, retain_graph=True)
    tol = TRAIN_TOL[q.dtype]
    torch.testing.assert_close(o.detach().float(), out.detach().float(),
                               **tol)
    for got, want in zip(g, grads):
        torch.testing.assert_close(got.float(), want.float(), **tol)

    def forward():
        with torch.enable_grad():
            return F.scaled_dot_product_attention(*x, attn_mask=mask,
                                                  scale=scale)
    return (cuda_time_ms(forward),
            cuda_time_ms(lambda: torch.autograd.grad(o, x, do,
                                                     retain_graph=True)))


def finetune_configs(n_layers):
    """The whisper large-v3 LoRA finetune yaml (128 mel bins, large-v3's
    51866 tokens) with `n_layers` encoder and decoder blocks."""
    import yaml
    with open(FINETUNE_CONFIG) as f:
        configs = yaml.safe_load(f)
    configs['input_dim'], configs['output_dim'] = WHISPER_V3['n_mels'], 51866
    configs['encoder_conf']['num_blocks'] = n_layers
    configs['decoder_conf']['num_blocks'] = n_layers
    return configs


def whisper_train_batch(rng, B, frames, min_frames):
    """A Dataset-format batch: mel-shaped features of `min_frames` to
    `frames` frames (the first full), text tokens of 16-64 ids below eot,
    IGNORE_ID padded."""
    feats, lens = mel_features(rng, B, frames, min_frames)
    tl = rng.randint(16, 65, size=B)
    tgt = np.full((B, 64), -1, np.int64)
    for i, n in enumerate(tl):
        tgt[i, :n] = rng.randint(0, 50257, size=n)
    return dict(feats=feats, feats_lengths=lens, target=tgt,
                target_lengths=tl.astype(np.int64))


def whisper_train_model(configs, generator, device):
    """The finetune model with weights from `generator`: the decoder
    shaped as in 7b, at a logit spread of 3 (random N(0, 1) tied
    embeddings give logits of std 36 and gradients near 100, where the
    card's fp32 gradients sit 3e-5 relative from float64 and so beyond
    8b's 1e-3 bar; the plain attention path on the card does the same),
    and lora_B drawn N(0, 0.02) instead of zero, so that the LoRA term
    and lora_A's gradient are not zero."""
    from wenet_tpu_torch.utils.init_model import init_model
    model = init_model(configs, generator, device=device)
    shape_decoder_weights(model, generator, logit_std=3.0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith('lora_B'):
                p.normal_(0.0, 0.02, generator=generator)
    return model


def whisper_train_check():
    phase('8b whisper large-v3 LoRA train step (4 + 4 layers): card vs CPU, '
          'Executor, checkpoint, loss')
    import shutil
    from wenet_tpu_torch.ops import flash_attention as fa
    from wenet_tpu_torch.utils.checkpoint import load_checkpoint
    from wenet_tpu_torch.utils.executor import Executor, to_device_batch
    from wenet_tpu_torch.utils.init_model import init_model
    from wenet_tpu_torch.utils.train_utils import (
        TrainState, init_optimizer_and_scheduler, make_cv_step,
        make_train_step)
    configs = finetune_configs(4)
    n_layers = configs['encoder_conf']['num_blocks']
    accum, clip = configs['accum_grad'], configs['grad_clip']
    rng = np.random.RandomState(SEED + 10)
    model = whisper_train_model(configs, torch.Generator().manual_seed(SEED),
                                'cpu')
    n_lora = sum(p.numel() for n, p in model.named_parameters()
                 if 'lora_' in n)
    print(f'  {sum(p.numel() for p in model.parameters()) / 1e6:.1f}M '
          f'parameters, {n_lora} of them LoRA (rank '
          f'{configs["lora_conf"]["lora_rank"]}, q/k/v/o of the encoder)')
    cpu_model = copy.deepcopy(model)
    model.cuda()

    # (1) one train step with the yaml's optimizer (adamw, warmuplr, clip
    # 5; accum_grad 1 so that it updates) on the card and on the CPU
    b = whisper_train_batch(rng, 2, 1400, 1200)  # 14 s, 12-14 s: T' 600-700
    outs = []
    for m, dev in ((model, 'cuda'), (cpu_model, 'cpu')):
        opt, schedule = init_optimizer_and_scheduler(configs, m)
        step = make_train_step(m, opt, schedule, None, 1, clip)
        fa.reset_launches()
        _, metrics = step(TrainState(m, opt), to_device_batch(b, dev),
                          (SEED, 0))
        outs.append({k: float(v) for k, v in metrics.items()})
        if dev == 'cuda':
            torch.cuda.synchronize()
            for name in FLASH_TRAIN_KERNELS:
                if fa.LAUNCHES[name] != n_layers:
                    raise RuntimeError(
                        f'{name}: {fa.LAUNCHES[name]} launches in one train '
                        f'step, expected {n_layers}')
            if fa.LAUNCHES['flash_attention_fwd']:
                raise RuntimeError('the train step ran the inference K4')
    for k in ('loss', 'loss_att', 'th_accuracy', 'grad_norm'):
        a, w = outs[0][k], outs[1][k]
        print(f'  B=2 x 12-14 s: {k} card {a:.6f} cpu {w:.6f}')
        if not abs(a - w) <= 1e-4 * abs(w) + 1e-6:
            raise RuntimeError(f'{k} differs from the CPU beyond rtol 1e-4')
    worst, cpu_params = 0.0, dict(cpu_model.named_parameters())
    for name, p in model.named_parameters():
        want = cpu_params[name]
        if name.startswith('ctc.'):  # no CTC loss at ctc_weight 0
            continue
        if p.grad is None or not torch.isfinite(p.grad).all():
            raise RuntimeError(f'{name}: no finite gradient on the card')
        err = max((p.grad.cpu() - want.grad).abs().max().item(),
                  (p.detach().cpu() - want.detach()).abs().max().item())
        worst = max(worst, err)
        if err > 1e-3:
            raise RuntimeError(f'{name}: grad or updated weight differs '
                               f'from the CPU by {err}')
    print(f'  one launch of each of K4-train, K5, K6 per encoder layer; '
          f'max |card - cpu| over clipped grads and updated weights = '
          f'{worst:.3g} (bar 1e-3)')
    del cpu_model, cpu_params

    # (2) eight micro-steps through Executor.train: one AdamW update
    opt, schedule = init_optimizer_and_scheduler(configs, model)
    step_fn = make_train_step(model, opt, schedule, None, accum, clip)
    per_step = []

    def counted(state, batch, rng_seed):
        before = dict(fa.LAUNCHES)
        state, metrics = step_fn(state, batch, rng_seed)
        per_step.append(({k: fa.LAUNCHES[k] - before[k] for k in before},
                         {k: float(v) for k, v in metrics.items()}))
        return state, metrics

    batches = [whisper_train_batch(rng, 2, 1400, 1200) for _ in range(accum)]
    model_dir = tempfile.mkdtemp(prefix='chip_smoke_whisper_')
    run_conf = dict(configs, log_interval=accum, save_interval=accum,
                    epoch=0, seed=SEED)
    executor = Executor(device='cuda')
    state = TrainState(model, opt)
    fa.reset_launches()
    state = executor.train(counted, state, batches, batches[:1],
                           make_cv_step(model), None, run_conf,
                           model_dir=model_dir)
    torch.cuda.synchronize()
    main_launches = {name: fa.LAUNCHES[name] for name in FLASH_TRAIN_KERNELS}
    for i, (launches, m) in enumerate(per_step):
        print(f'  micro-step {i + 1}: loss {m["loss"]:.4f} acc '
              f'{m["th_accuracy"]:.4f} grad_norm {m["grad_norm"]:.4f} lr '
              f'{m["lr"]:.3g}; launches ' + ' '.join(
                  f'{k[16:]}={launches[k]}' for k in FLASH_TRAIN_KERNELS))
        for name in FLASH_TRAIN_KERNELS:
            if launches[name] != n_layers:
                raise RuntimeError(f'micro-step {i + 1}: {name} ran '
                                   f'{launches[name]} times, expected '
                                   f'{n_layers}')
        if not (np.isfinite(m['loss']) and np.isfinite(m['grad_norm'])):
            raise RuntimeError(f'micro-step {i + 1}: loss or grad_norm not '
                               'finite')
    if executor.step != accum or state.step != accum:
        raise RuntimeError(f'Executor.train did not run {accum} micro-steps')

    # (3) the checkpoint the executor saved after the update, loaded back
    fresh = init_model(configs, device='cpu')
    infos = load_checkpoint(fresh, os.path.join(model_dir,
                                                f'step_{accum}.pt'))
    shutil.rmtree(model_dir)
    lora_keys = [k for k in fresh.state_dict() if 'lora_' in k]
    for (name, a), w in zip(model.state_dict().items(),
                            fresh.state_dict().values()):
        if not torch.equal(a.cpu(), w):
            raise RuntimeError(f'checkpoint: {name} differs after loading')
    if len(lora_keys) != 2 * 4 * n_layers:
        raise RuntimeError(f'checkpoint holds {len(lora_keys)} LoRA tensors')
    print(f'  checkpoint step_{accum}.pt: strict load, weights equal '
          f'({len(lora_keys)} LoRA tensors), cv_loss {infos["cv_loss"]:.4f}')
    del fresh

    # (4) twenty steps on one fixed batch, no warmup, a raised lr
    fixed = to_device_batch(batches[0], 'cuda')
    const = make_train_step(model, opt, lambda step: WHISPER_TRAIN_LR, None,
                            1, clip)
    losses = []
    for _ in range(20):
        state, m = const(state, fixed, (SEED, 1))
        losses.append(float(m['loss']))
    end = float(np.mean(losses[-5:]))
    print(f'  20 steps on one batch, lr {WHISPER_TRAIN_LR:g}: loss '
          f'{losses[0]:.4f} -> {end:.4f} (mean of the last 5; must be < '
          f'{LOSS_DROP} x first)')
    if not np.isfinite(losses).all() or end >= LOSS_DROP * losses[0]:
        raise RuntimeError('the whisper loss did not fall on a fixed batch')
    return main_launches


def whisper_train_speed(smi):
    phase('8c whisper large-v3 LoRA train speed (informational)')
    import gc
    gc.collect()  # 7c's model
    torch.cuda.empty_cache()
    configs = finetune_configs(32)
    t0 = time.perf_counter()
    model = whisper_train_model(
        configs, torch.Generator('cuda').manual_seed(SEED), 'cuda')
    print(f'  32 + 32 layers built on the card in '
          f'{time.perf_counter() - t0:.1f} s '
          f'({sum(p.numel() for p in model.parameters()) / 1e9:.3f}B '
          f'parameters)')
    for dtype in (None, torch.bfloat16):
        name = 'bf16 autocast' if dtype else 'fp32'
        for B in (2, 1):
            try:
                whisper_train_speed_one(model, configs, dtype, B, smi)
                break
            except torch.cuda.OutOfMemoryError:
                peak = torch.cuda.max_memory_allocated() / 2**30
                print(f'  {name} B={B}: out of memory (peak {peak:.2f} GiB); '
                      f'{"retrying at B=1" if B == 2 else "giving up"}',
                      flush=True)
                torch.cuda.empty_cache()
                if B == 1:
                    raise


def whisper_train_speed_one(model, configs, dtype, B, smi):
    """8c at one dtype and batch size."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from wenet_tpu_torch.ops import flash_attention as fa
    from wenet_tpu_torch.utils.executor import Executor, to_device_batch
    from wenet_tpu_torch.utils.train_utils import (
        TrainState, apply_gradients, init_optimizer_and_scheduler,
        make_train_step)
    name = 'bf16 autocast' if dtype else 'fp32'
    n_layers = configs['encoder_conf']['num_blocks']
    accum, clip = configs['accum_grad'], configs['grad_clip']
    rng = np.random.RandomState(SEED + 11)
    batches = [whisper_train_batch(rng, B, 3000, 3000) for _ in range(accum)]
    audio = float(sum(b['feats_lengths'].sum() for b in batches)) / 100
    opt, schedule = init_optimizer_and_scheduler(configs, model)
    state = TrainState(model, opt)
    step = make_train_step(model, opt, schedule, dtype, accum, clip)
    counts = []

    def counted(state, batch, rng_seed):
        before = dict(fa.LAUNCHES)
        out = step(state, batch, rng_seed)
        counts.append({k: fa.LAUNCHES[k] - before[k]
                       for k in FLASH_TRAIN_KERNELS})
        return out
    run_conf = dict(configs, log_interval=10 ** 9, save_interval=None,
                    epoch=0, seed=SEED)
    try:
        Executor(device='cuda').train(counted, state, batches, [], None,
                                      None, run_conf)  # warm-up update
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        Executor(device='cuda').train(counted, state, batches, [], None,
                                      None, run_conf)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / accum
        peak = torch.cuda.max_memory_allocated() / 2**30
        bad = [c for c in counts if any(v != n_layers for v in c.values())]
        if bad or len(counts) != 2 * accum:
            raise RuntimeError(f'expected {n_layers} launches of each of '
                               f'K4-train, K5, K6 per micro-step: {bad[:2]}')
        print(f'  {name} B={B} x 30 s ({audio:.0f} s of audio in '
              f'{accum} micro-steps, one AdamW update): '
              f'{dt * 1e3:.1f} ms per micro-step, '
              f'{B * 30.0 / dt:.1f} audio-sec/s; peak device memory '
              f'{peak:.2f} GiB; {n_layers} launches of each of K4-train, '
              f'K5, K6 per micro-step ({smi})', flush=True)
        # one micro-step stage by stage, each ended by a synchronize, and
        # the clip + AdamW update over its gradients
        batch = to_device_batch(batches[0], 'cuda')
        gen = torch.Generator().manual_seed(SEED)
        opt.zero_grad(set_to_none=True)
        stamps = [time.perf_counter()]
        with torch.autocast('cuda', dtype=dtype, enabled=dtype is not None):
            out = model(batch['feats'], batch['feats_lengths'],
                        batch['target'], batch['target_lengths'],
                        generator=gen)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        out['loss'].backward()
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        apply_gradients(TrainState(model, opt), schedule, clip, 1)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        print('    stages: ' + ', '.join(
            f'{s} {(t1 - t0) * 1e3:.1f} ms' for s, t0, t1 in zip(
                ('forward', 'backward', 'clip + AdamW update'), stamps,
                stamps[1:])) + f' ({smi})', flush=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(state, batch, (SEED, 0))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and not getattr(e, 'is_user_annotation', False)]
        total = sum(e.self_device_time_total for e in rows) / 1e3
        print(f'    kernel time in one profiled micro-step: {total:.2f} ms; '
              f'{100 * total / (wall * 1e3):.0f}% of its {wall * 1e3:.1f} '
              f'ms wall, {100 * total / (dt * 1e3):.0f}% of an unprofiled '
              f'micro-step (device busy; {smi})', flush=True)
        for label, key in (('K4-train', 'flash_fwd_'),
                           ('K5', 'flash_bwd_dq_'),
                           ('K6', 'flash_bwd_dkv_')):
            ms = sum(e.self_device_time_total for e in rows
                     if key in e.key) / 1e3
            print(f'    {label} {key}: {ms:.3f} ms, '
                  f'{100 * ms / max(total, 1e-9):.1f}% of kernel time')
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:15]:
            ms = e.self_device_time_total / 1e3
            print(f'    {ms:8.3f} ms {100 * ms / max(total, 1e-9):5.1f}% '
                  f'x{e.count:<5d} {e.key[:80]}')
    finally:
        opt.zero_grad(set_to_none=True)
        state.acc_grads = None
        del opt, state
        torch.cuda.empty_cache()


def grad_precision(smi):
    """On demand, not run by `main` (python3 -c "import chip_smoke as c;
    smi = c.device(); c.build(); c.grad_precision(smi)"): 8b's one train
    step forward + backward at 4 + 4 layers on the card, with the flash
    kernels and with the gate closed (the plain path), and on the CPU in
    fp32 and float64, for the weights 8b uses and for init_model's own;
    prints the global gradient norms and the worst |grad - float64| per
    run.  It locates the card's gradient error (kernels or the rest)."""
    phase('x whisper gradient precision: card, card plain path, CPU fp32 '
          'vs CPU float64')
    from wenet_tpu_torch.models.transformer import attention as A
    from wenet_tpu_torch.utils.executor import to_device_batch
    from wenet_tpu_torch.utils.init_model import init_model
    configs = finetune_configs(4)
    b = whisper_train_batch(np.random.RandomState(SEED + 10), 2, 1400, 1200)

    def grads(model, dev, dtype=torch.float32):
        model.to(dev, dtype).train()
        tb = to_device_batch(b, dev)
        tb['feats'] = tb['feats'].to(dtype)
        out = model(tb['feats'], tb['feats_lengths'], tb['target'],
                    tb['target_lengths'])
        out['loss'].backward()
        return {n: p.grad.detach().double().cpu()
                for n, p in model.named_parameters() if p.grad is not None}

    for label in ('8b weights', 'init_model weights'):
        gen = torch.Generator().manual_seed(SEED)
        model = (whisper_train_model(configs, gen, 'cpu')
                 if label == '8b weights' else
                 init_model(configs, gen, device='cpu'))
        runs = {'cpu float64': grads(copy.deepcopy(model), 'cpu',
                                     torch.float64),
                'cpu fp32': grads(copy.deepcopy(model), 'cpu'),
                'card': grads(copy.deepcopy(model), 'cuda')}
        saved = dict(A.FLASH_GATE)
        A.FLASH_GATE.update(min_len=1 << 40, score_elems=1 << 62)
        try:
            runs['card, plain attention'] = grads(copy.deepcopy(model),
                                                  'cuda')
        finally:
            A.FLASH_GATE.update(saved)
        ref = runs['cpu float64']
        print(f'  {label}: max |grad| {max(g.abs().max().item() for g in ref.values()):.4g} ({smi})')
        for name, g in runs.items():
            norm = torch.stack([t.square().sum() for t in g.values()]).sum(
                ).sqrt().item()
            worst = sorted(((g[n] - ref[n]).abs().max().item(),
                            ref[n].abs().max().item(), n) for n in ref)[-3:]
            print(f'    {name}: grad norm {norm:.6f}; worst |grad - '
                  f'float64| (max |grad| of the tensor): ' + ', '.join(
                      f'{e:.3g} ({m:.3g}) {n}' for e, m, n in worst[::-1]))


# ---------------------------------------------------------------------------
# 9. the streaming slice: the front end, the chunk step, AsrDecoder, HTTP
# ---------------------------------------------------------------------------
SR = 16000
PIECE = SR // 5  # AsrDecoder is fed 200 ms pieces
STREAM_OPTS = dict(chunk_size=16, num_left_chunks=-1, beam_size=10,
                   ctc_weight=0.3, reverse_weight=0.3)
# the card's fbank against the host's numpy one: both take the FFT in
# float64; what is left is float32 DC removal and pre-emphasis (4.8e-5 on
# the CPU, tests/test_torch_fbank.py), on features of about 5-25
FBANK_TOL = 2e-4
FULL_TOL = 1e-4  # streaming equal to full (the repo's bar)
CHUNK_CPU_TOL = 2e-4  # card against CPU, the torch-import bar
# beam scores, sums of a few hundred frames' log-probs (about -1e3), card
# against CPU
SCORE_TOL = dict(atol=1e-3, rtol=1e-5)
# a stream batched with others against the same stream alone, on the
# card both (9f): the tiny-width bar against the JAX package (2e-4,
# tests/test_torch_runtime.py), about 3 ulp of a float32 score near -1e3
BATCH_SCORE_TOL = dict(atol=2e-4, rtol=0.0)
STREAM_SECONDS = (4.0, 6.5, 9.0)  # 9c's three utterances


def speech_like(rng, seconds):
    """A [-1, 1] waveform on the int16 grid (what a 16-bit wav holds):
    noise and three tones that come and go."""
    t = np.arange(int(SR * seconds)) / SR
    x = 0.1 * rng.randn(len(t))
    for f, rate in zip(rng.uniform(120, 3500, 3), rng.uniform(0.5, 3, 3)):
        x += 0.15 * np.sin(2 * np.pi * f * t) * (np.sin(2 * np.pi * rate * t)
                                                 > 0)
    return (np.round(np.clip(x, -1, 1) * 32767) / 32768).astype(np.float32)


def flagship_tokenizer():
    from wenet_tpu_torch.text.char_tokenizer import CharTokenizer
    syms = {'<blank>': 0, '<unk>': 1, '<sos/eos>': 2}
    syms.update({chr(0x4e00 + i): i for i in range(3, 4233)})
    return CharTokenizer(syms)


def streaming_decoder(model, device, tokenizer, runner=None, **opts):
    """9c's decoder (STREAM_OPTS, with `opts` set), over `runner` when
    one is given."""
    from wenet_tpu_torch.runtime.asr_decoder import AsrDecoder, DecodeOptions
    from wenet_tpu_torch.runtime.feature_pipeline import (
        FeaturePipelineConfig)
    return AsrDecoder(model, tokenizer, DecodeOptions(**{**STREAM_OPTS,
                                                         **opts}),
                      FeaturePipelineConfig(num_mel_bins=80),
                      batch_runner=runner, device=device)


def stream_utterance(dec, wav):
    """Feed `wav` to `dec` in 200 ms pieces as fast as it decodes ->
    (partials after each decode(), final after rescoring(), times): the
    first partial's latency (from the accept_waveform of the piece that
    completed the first chunk to its decode() returning), the final's
    (from set_input_finished() to rescoring() returning), the wall time."""
    dec.reset()
    partials, first = [], None
    t0 = time.perf_counter()
    for lo in range(0, len(wav), PIECE):
        t_piece = time.perf_counter()
        before = dec.offset
        dec.accept_waveform(wav[lo:lo + PIECE])
        dec.decode()
        if first is None and dec.offset > before:
            first = time.perf_counter() - t_piece
        partials.append([(r.sentence, r.score) for r in dec.result])
    t_end = time.perf_counter()
    dec.set_input_finished()
    dec.decode()
    partials.append([(r.sentence, r.score) for r in dec.result])
    dec.rescoring()
    t_final = time.perf_counter()
    final = [(r.sentence, r.score) for r in dec.result]
    return partials, final, dict(first_ms=1e3 * first,
                                 final_ms=1e3 * (t_final - t_end),
                                 wall_s=t_final - t0)


def same_results(got, want, what, tol=SCORE_TOL):
    """Raise unless the sentences are identical and the scores close."""
    if [s for s, _ in got] != [s for s, _ in want]:
        raise RuntimeError(f'{what}: sentences differ: '
                           f'{[s[:20] for s, _ in got[:3]]} vs '
                           f'{[s[:20] for s, _ in want[:3]]}')
    a, b = np.array([x for _, x in got]), np.array([x for _, x in want])
    if not np.all(np.abs(a - b) <= tol['atol'] + tol['rtol'] * np.abs(b)):
        raise RuntimeError(f'{what}: scores differ by '
                           f'{np.abs(a - b).max():.3g}')
    return float(np.abs(a - b).max()) if len(a) else 0.0


def fbank_check(model):
    phase('9a front end: fbank on the card vs the host, decode_wav')
    from wenet_tpu_torch.models.runner import AsrRunner
    from wenet_tpu_torch.ops.fbank import compute_fbank, compute_fbank_np
    rng = np.random.RandomState(SEED + 11)
    B, seconds = 16, 15.0
    wav = np.stack([speech_like(rng, seconds) for _ in range(B)])
    lens = rng.randint(10 * SR, wav.shape[1] + 1, size=B)
    lens[0] = wav.shape[1]
    wav_gpu = torch.from_numpy(wav).cuda()
    with torch.inference_mode():
        got = compute_fbank(wav_gpu * (1 << 15))
    t0 = time.perf_counter()
    want = compute_fbank_np(wav * (1 << 15))
    host = time.perf_counter() - t0
    err = (got.cpu() - torch.from_numpy(want)).abs().max().item()
    if not torch.isfinite(got).all() or err > FBANK_TOL:
        raise RuntimeError(f'fbank on the card differs from the host by '
                           f'{err:.3g} (bar {FBANK_TOL})')
    with torch.inference_mode():
        card = cuda_time_ms(lambda: compute_fbank(wav_gpu * (1 << 15)),
                            reps=5)
    print(f'  fbank B={B} x {seconds:.0f} s {tuple(got.shape)}: max |card - '
          f'host| = {err:.3g} ({100 * err / FBANK_TOL:.0f}% of the bar '
          f'{FBANK_TOL}); card {card:.3f} ms, host numpy {1e3 * host:.1f} ms')
    runner = AsrRunner(model, 'cuda')
    kw = dict(beam_size=10, ctc_weight=0.3, reverse_weight=0.3)
    got = runner.decode_wav(MODES, wav, lens, **kw)
    flen = np.minimum((lens - SR * 25 // 1000) // (SR // 100) + 1,
                      want.shape[1])
    ref = runner.decode(MODES, want, flen, **kw)
    for mode in MODES:
        same = sum(g.tokens == w.tokens for g, w in zip(got[mode],
                                                        ref[mode]))
        print(f'  decode_wav {mode}: {same}/{B} hypotheses equal to decode '
              f'on the host features (token counts '
              f'{[len(r.tokens) for r in got[mode]][:4]}...)')
        if same != B:
            raise RuntimeError(f'decode_wav {mode} differs from decode on '
                               'the host features')
    return want


def chunk_check(model, cpu_model, feats):
    phase('9b chunk step: chunk by chunk vs full forward, card vs CPU')
    from wenet_tpu_torch.models.runner import AsrRunner
    from wenet_tpu_torch.models.transformer.streaming import (
        StreamingConfig, forward_chunk_by_chunk)
    from wenet_tpu_torch.ops import flash_attention as fa
    cfg = StreamingConfig(16, -1, model.encoder.subsampling_rate,
                          model.encoder.right_context)
    x = torch.from_numpy(feats[None])
    T = x.shape[1]
    n_chunks = len(range(0, T - cfg.right_context, cfg.stride))
    with torch.inference_mode():
        fa.reset_launches()
        ys, _ = forward_chunk_by_chunk(model, x.cuda(), cfg)
        torch.cuda.synchronize()
        launches = fa.LAUNCHES['relpos_attention_fwd']
        full, _ = model.forward_encoder(x.cuda(), torch.tensor([T]).cuda(),
                                        16, -1)
        cpu_ys, _ = forward_chunk_by_chunk(cpu_model, x, cfg)
    n_blocks = len(model.encoder.encoders)
    if launches != n_blocks * n_chunks:
        raise RuntimeError(f'{launches} K1 launches over {n_chunks} chunk '
                           f'steps, expected {n_blocks} per step')
    if not torch.isfinite(ys).all() or ys.shape != full.shape:
        raise RuntimeError(f'chunk output {tuple(ys.shape)} is not finite '
                           f'or not the full forward\'s {tuple(full.shape)}')
    e_full = (ys - full).abs().max().item()
    e_cpu = (ys.cpu() - cpu_ys).abs().max().item()
    print(f'  {T / 100:.0f} s, {n_chunks} chunk steps, {launches} K1 '
          f'launches, output {tuple(ys.shape)}: max |chunks - full forward '
          f'(chunk 16)| = {e_full:.3g} (bar {FULL_TOL}), max |card - cpu| = '
          f'{e_cpu:.3g} (bar {CHUNK_CPU_TOL})')
    if e_full > FULL_TOL or e_cpu > CHUNK_CPU_TOL:
        raise RuntimeError('the chunk loop misses its bar')
    kw = dict(beam_size=10, ctc_weight=0.3, reverse_weight=0.3,
              decoding_chunk_size=16, num_decoding_left_chunks=-1,
              simulate_streaming=True)
    got = AsrRunner(model, 'cuda').decode(MODES, x, [T], **kw)
    want = AsrRunner(cpu_model, 'cpu').decode(MODES, x, [T], **kw)
    for mode in MODES:
        if got[mode][0].tokens != want[mode][0].tokens:
            raise RuntimeError(f'simulate_streaming {mode}: the card\'s '
                               'hypothesis differs from the CPU\'s')
    print('  decode(simulate_streaming=True): hypotheses equal to the CPU '
          'run (token counts ' + ', '.join(
              f'{m} {len(got[m][0].tokens)}' for m in MODES) + ')')


def decoder_check(model, cpu_model, tokenizer):
    phase('9c AsrDecoder on the card vs the CPU, 200 ms pieces')
    from wenet_tpu_torch.ops import flash_attention as fa
    rng = np.random.RandomState(SEED + 12)
    utts = [speech_like(rng, s) for s in STREAM_SECONDS]
    want = [stream_utterance(streaming_decoder(cpu_model, 'cpu', tokenizer),
                             w)[:2] for w in utts]
    dec = streaming_decoder(model, 'cuda', tokenizer)
    steps = [0]
    advance = dec._advance_one_chunk

    def counted(chunk):
        steps[0] += 1
        return advance(chunk)
    dec._advance_one_chunk = counted
    stream_utterance(dec, utts[0])  # warm up
    steps[0] = 0
    fa.reset_launches()
    got = [stream_utterance(dec, w) for w in utts]
    torch.cuda.synchronize()
    launches = fa.LAUNCHES['relpos_attention_fwd']
    n_blocks = len(model.encoder.encoders)
    print(f'  {len(utts)} utterances ({", ".join(f"{s} s" for s in STREAM_SECONDS)}): '
          f'{steps[0]} chunk steps, {launches} K1 launches')
    if launches != n_blocks * steps[0] or not steps[0]:
        raise RuntimeError(f'expected {n_blocks} K1 launches per chunk step')
    finals = []
    for i, ((g_part, g_final, times), (w_part, w_final)) in enumerate(
            zip(got, want)):
        if len(g_part) != len(w_part):
            raise RuntimeError(f'utterance {i}: {len(g_part)} partials on '
                               f'the card, {len(w_part)} on the CPU')
        worst = max(same_results(g, w, f'utterance {i} partial {j}')
                    for j, (g, w) in enumerate(zip(g_part, w_part)))
        worst = max(worst, same_results(g_final, w_final,
                                        f'utterance {i} final'))
        print(f'  utterance {i}: {len(g_part)} partials and the final equal '
              f'to the CPU\'s (sentences identical, scores within '
              f'{worst:.3g}); final {len(g_final[0][0])} chars, '
              f'{len(g_final)}-best')
        finals.append(g_final)
    return utts, finals, launches


def http_check(model, tokenizer, utts, finals):
    phase('9d HTTP server: two clients, four RIFF files and raw s16le')
    import threading
    import urllib.request
    from wenet_tpu_torch.bin.http_server_main import make_server
    from wenet_tpu_torch.dataset.audio import write_wav
    tmp = tempfile.mkdtemp(prefix='chip_smoke_wav_')
    bodies = []  # (body, index of the utterance it holds)
    for n, i in enumerate((0, 1, 2, 0)):
        path = os.path.join(tmp, f'{n}.wav')
        write_wav(path, utts[i], SR)
        with open(path, 'rb') as f:
            bodies.append((f.read(), i))
    bodies.append((np.round(utts[1] * 32768).astype('<i2').tobytes(), 1))
    server = make_server(lambda: streaming_decoder(model, 'cuda', tokenizer),
                         0, '127.0.0.1')
    serve = threading.Thread(target=server.serve_forever, daemon=True)
    serve.start()
    url = f'http://127.0.0.1:{server.server_address[1]}/'
    answers, walls, errors = {}, {}, []

    def client(name, which):
        t0 = time.perf_counter()
        try:
            for n in which:
                req = urllib.request.Request(url, data=bodies[n][0],
                                             method='POST')
                with urllib.request.urlopen(req, timeout=300) as resp:
                    answers[n] = json.loads(resp.read())
        except Exception as e:  # reported and raised below
            errors.append(f'{name}: {e!r}')
        walls[name] = (time.perf_counter() - t0, which)
    try:
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(name, which))
                   for name, which in (('A', (0, 2, 4)), ('B', (1, 3)))]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        wall = time.perf_counter() - t0
        alive = [c for c in clients if c.is_alive()]
    finally:
        server.shutdown()
        server.server_close()
        serve.join(timeout=30)
    if errors or alive or sorted(answers) != list(range(len(bodies))):
        raise RuntimeError(f'HTTP requests failed: {errors}, '
                           f'{len(alive)} clients hung, answers for '
                           f'{sorted(answers)}')
    for n, (_, i) in enumerate(bodies):
        ans = answers[n]
        if ans.get('status') != 'ok' or ans.get('type') != 'final_result':
            raise RuntimeError(f'request {n}: {ans}')
        same_results([(r['sentence'], r['score']) for r in ans['nbest']],
                     finals[i], f'HTTP request {n}',
                     dict(atol=1e-4, rtol=0.0))
    audio = {name: sum(len(utts[bodies[n][1]]) for n in which) / SR
             for name, (_, which) in walls.items()}
    rtf = {name: walls[name][0] / audio[name] for name in walls}
    print(f'  {len(bodies)} requests answered; every nbest equals 9c\'s '
          f'final for its audio (sentences identical, scores within 1e-4)')
    print('  real-time factor, two concurrent clients (each request builds '
          'its decoder, as the server does): ' + ', '.join(
        f'{name} {rtf[name]:.4f} ({audio[name]:.1f} s of audio in '
        f'{walls[name][0]:.3f} s)' for name in sorted(walls)) +
        f'; both: {wall / sum(audio.values()):.4f}')
    return rtf


def streaming_speed(model, tokenizer, smi):
    phase('9e streaming speed (informational)')
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from wenet_tpu_torch.models.transformer.streaming import (
        streaming_att_mask)
    from wenet_tpu_torch.ops.flash_attention import flash_attention_relpos
    rng = np.random.RandomState(SEED + 13)
    cache, chunk, valid = 512, 16, 256
    n_blocks = len(model.encoder.encoders)
    xs = torch.from_numpy(rng.randn(1, 67, 80).astype(np.float32)).cuda()
    mask = streaming_att_mask(1, cache, chunk, valid, chunk, 'cuda')
    with torch.inference_mode():
        state = model.encoder.zero_cache(1, cache, device='cuda')

        def step():
            ys, _, _ = model.forward_encoder_chunk(xs, valid, *state, mask)
            return torch.topk(model.ctc_activation(ys), 10, dim=-1)
        # one step a reading: 20 steps' ≈ 8,000 launches would fill the
        # launch queue while the card sleeps, and the events would time
        # the host's enqueue
        step_ms = min(cuda_time_ms(step, reps=1) for _ in range(5))
        enqueue_ms = host_ms(step)
        (q1, q2, k, p, v), m = kernel_inputs(rng, 1, 4, chunk, cache + chunk,
                                             64, 'cache256', torch.float32)
        k1_ms = cuda_time_ms(lambda: flash_attention_relpos(
            q1, q2, k, p, v, m, 0.125))
    share = n_blocks * k1_ms / step_ms
    print(f'  chunk step (16 frames, 512-slot cache, {n_blocks} blocks, CTC '
          f'+ top-k): card {step_ms:.4f} ms (CUDA events, best of 5), host '
          f'enqueue {enqueue_ms:.4f} ms; K1 {k1_ms:.4f} ms x {n_blocks} = '
          f'{100 * share:.1f}% of the card time ({smi})')
    dec = streaming_decoder(model, 'cuda', tokenizer)
    wav = speech_like(rng, 15.0)
    stream_utterance(dec, wav)  # warm up
    runs = [stream_utterance(dec, wav)[2] for _ in range(3)]
    best = min(runs, key=lambda r: r['wall_s'])
    print(f'  one stream, 15 s fed in 200 ms pieces as fast as it decodes '
          f'(3 runs): first partial ' + ', '.join(
              f'{r["first_ms"]:.1f}' for r in runs) + ' ms; final ' +
          ', '.join(f'{r["final_ms"]:.1f}' for r in runs) + ' ms; real-time '
          'factor ' + ', '.join(f'{r["wall_s"] / 15.0:.4f}' for r in runs) +
          f' ({smi})')
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stream_utterance(dec, wav)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in rows) / 1e3
    k1_rows = [e for e in rows if 'relpos_fwd_' in e.key]
    k1 = sum(e.self_device_time_total for e in k1_rows) / 1e3
    steps = sum(e.count for e in k1_rows) // n_blocks
    print(f'  profiled stream: {total:.2f} ms of kernels in {wall * 1e3:.1f} '
          f'ms wall ({100 * total / (wall * 1e3):.1f}% device busy); '
          f'{steps} chunk steps; K1 {k1:.3f} ms ({100 * k1 / max(total, 1e-9):.1f}'
          f'% of kernel time, {k1 / max(steps, 1):.4f} ms a step)')
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        ms = e.self_device_time_total / 1e3
        print(f'    {ms:8.3f} ms {100 * ms / max(total, 1e-9):5.1f}% '
              f'x{e.count:<4d} {e.key[:80]}')
    # where the host's time goes: the ops by their own host time
    host = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU
            and not getattr(e, 'is_user_annotation', False)]
    host_total = sum(e.self_cpu_time_total for e in host) / 1e3
    print(f'  host: {host_total:.1f} ms of ops\' own time in the profiled '
          f'stream, the largest:')
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:10]:
        ms = e.self_cpu_time_total / 1e3
        print(f'    {ms:8.3f} ms {100 * ms / max(host_total, 1e-9):5.1f}% '
              f'x{e.count:<5d} {e.key[:80]}')
    return dict(chunk_step_ms=step_ms, k1_share_of_chunk_step=share,
                first_partial_ms=best['first_ms'],
                final_ms=best['final_ms'], rtf=best['wall_s'] / 15.0,
                busy=total / (wall * 1e3))


def run_streams(make_decoder, utts, stagger_s):
    """Decode `utts` concurrently, stream i on a thread of its own that
    starts i * stagger_s after the first, each through a decoder from
    `make_decoder` -> ([stream_utterance's result], wall seconds)."""
    import threading
    out, errors = [None] * len(utts), []

    def run(i):
        time.sleep(i * stagger_s)
        try:
            out[i] = stream_utterance(make_decoder(), utts[i])
        except Exception as e:  # reported and raised below
            errors.append(f'stream {i}: {e!r}')
    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(utts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f'streams failed: {errors}')
    return out, wall


def busy_share(fn):
    """(fn()'s result, kernel time over wall time of `fn()` from
    torch.profiler, the wall seconds)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = sum(ms for _, ms in device_rows(prof).values()) / 1e3
    return out, kernels / wall, wall


def batched_step_readings(model, smi):
    """The batched chunk step (16 frames, 512-slot caches with 256 valid,
    CTC + top-k) at B = 1, 2, 4, 8: card time (CUDA events, best of 5, one
    step a reading) and host enqueue."""
    from wenet_tpu_torch.models.transformer.streaming import (
        streaming_att_mask)
    rng = np.random.RandomState(SEED + 15)
    cache, chunk, valid = 512, 16, 256
    out = {}
    with torch.inference_mode():
        for B in (1, 2, 4, 8):
            xs = torch.from_numpy(rng.randn(B, 67, 80).astype(
                np.float32)).cuda()
            offsets = torch.full((B,), valid, device='cuda')
            state = model.encoder.zero_cache(B, cache, device='cuda')
            mask = streaming_att_mask(B, cache, chunk, valid, chunk, 'cuda')

            def step():
                ys, _, _ = model.forward_encoder_chunk(xs, offsets, *state,
                                                       mask)
                return torch.topk(model.ctc_activation(ys), 10, dim=-1)
            card = min(cuda_time_ms(step, reps=1) for _ in range(5))
            out[B] = dict(card_ms=card, enqueue_ms=host_ms(step))
            print(f'  batched chunk step B={B}: card {card:.4f} ms '
                  f'({card / B:.4f} ms a stream), host enqueue '
                  f'{out[B]["enqueue_ms"]:.4f} ms ({smi})', flush=True)
    return out


def batched_serving_check(model, tokenizer, smi):
    phase('9f batched serving: 8 streams over one BatchedChunkRunner vs '
          'each alone')
    from wenet_tpu_torch.models.transformer.streaming import StreamingConfig
    from wenet_tpu_torch.ops import flash_attention as fa
    from wenet_tpu_torch.runtime.batch_runner import BatchedChunkRunner
    n_streams, stagger_s = 8, 0.15
    rng = np.random.RandomState(SEED + 14)
    seconds = [STREAM_SECONDS[i % len(STREAM_SECONDS)]
               for i in range(n_streams)]
    utts = [speech_like(rng, s) for s in seconds]
    alone = [stream_utterance(streaming_decoder(model, 'cuda', tokenizer),
                              w)[:2] for w in utts]
    cfg = StreamingConfig(STREAM_OPTS['chunk_size'],
                          STREAM_OPTS['num_left_chunks'],
                          model.encoder.subsampling_rate,
                          model.encoder.right_context)
    runner = BatchedChunkRunner(model, cfg, max_batch=n_streams,
                                beam_size=STREAM_OPTS['beam_size'],
                                device='cuda')
    try:
        print(f'  warm-up ran batch sizes {runner.precompile(80)}')
        fa.reset_launches()
        (got, wall), busy, _ = busy_share(lambda: run_streams(
            lambda: streaming_decoder(model, 'cuda', tokenizer, runner),
            utts, stagger_s))
        launches = fa.LAUNCHES['relpos_attention_fwd']
        hist = dict(sorted(runner.batch_sizes.items()))
        steps = sum(hist.values())
        n_blocks = len(model.encoder.encoders)
        print(f'  {n_streams} streams ({", ".join(f"{s} s" for s in seconds)}'
              f'; starts {stagger_s} s apart): {steps} batched steps, '
              f'{launches} K1 launches; coalesced batch sizes {hist}')
        if launches != n_blocks * steps or not steps:
            raise RuntimeError(f'{launches} K1 launches over {steps} batched '
                               f'steps, expected {n_blocks} per step')
        if max(hist) < 2:
            raise RuntimeError('no two streams shared a step')
        worst = 0.0
        for i, ((g_part, g_final, _), (w_part, w_final)) in enumerate(
                zip(got, alone)):
            if len(g_part) != len(w_part):
                raise RuntimeError(f'stream {i}: {len(g_part)} partials '
                                   f'batched, {len(w_part)} alone')
            for j, (g, w) in enumerate(zip(g_part, w_part)):
                worst = max(worst, same_results(
                    g, w, f'stream {i} partial {j}', BATCH_SCORE_TOL))
            worst = max(worst, same_results(g_final, w_final,
                                            f'stream {i} final',
                                            BATCH_SCORE_TOL))
        print(f'  every partial and final of the {n_streams} streams equals '
              f'the stream decoded alone (sentences identical, scores within '
              f'{worst:.3g}: {100 * worst / BATCH_SCORE_TOL["atol"]:.0f}% of '
              f'the bar {BATCH_SCORE_TOL["atol"]})')
    finally:
        runner.close()
    (solo, solo_wall), solo_busy, _ = busy_share(lambda: run_streams(
        lambda: streaming_decoder(model, 'cuda', tokenizer), utts, stagger_s))
    audio = sum(seconds)
    rtf = [r[2]['wall_s'] / s for r, s in zip(got, seconds)]
    solo_rtf = [r[2]['wall_s'] / s for r, s in zip(solo, seconds)]
    print(f'  per-stream real-time factor, {n_streams} concurrent streams '
          f'fed in 200 ms pieces as fast as they decode (profiled runs): '
          f'batched mean {np.mean(rtf):.4f} (max {max(rtf):.4f}; '
          f'{audio:.1f} s of audio in {wall:.3f} s), unbatched mean '
          f'{np.mean(solo_rtf):.4f} (max {max(solo_rtf):.4f}; '
          f'{solo_wall:.3f} s) ({smi})')
    print(f'  device busy: batched {100 * busy:.1f}%, unbatched '
          f'{100 * solo_busy:.1f}%')
    steps_ms = batched_step_readings(model, smi)
    return launches, dict(batch_sizes=hist, steps=steps, rtf=rtf,
                          unbatched_rtf=solo_rtf, wall_s=wall,
                          unbatched_wall_s=solo_wall, busy=busy,
                          unbatched_busy=solo_busy, step=steps_ms,
                          max_score_gap=worst)


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def model_dir_check(model, tokenizer, utts, finals):
    phase('9g model directory: decoder_main, the HTTP main, WenetRecognizer')
    import threading
    import urllib.request
    import yaml
    from wenet_tpu_torch.bin import decoder_main, http_server_main
    from wenet_tpu_torch.dataset.audio import write_wav
    from wenet_tpu_torch.runtime import api
    d = tempfile.mkdtemp(prefix='chip_smoke_model_')
    units = os.path.join(d, 'units.txt')
    with open(units, 'w', encoding='utf-8') as f:
        for sym, i in sorted(tokenizer.symbol_table.items(),
                             key=lambda kv: kv[1]):
            f.write(f'{sym} {i}\n')
    with open(CONFIG) as f:
        configs = yaml.safe_load(f)
    # the yaml's cmvn file is the recipe's and stays absent: the stats
    # come from final.pt
    configs['tokenizer_conf']['symbol_table_path'] = units
    with open(os.path.join(d, 'train.yaml'), 'w') as f:
        yaml.safe_dump(configs, f)
    torch.save(model.state_dict(), os.path.join(d, 'final.pt'))
    scp = os.path.join(d, 'wav.scp')
    with open(scp, 'w') as f:
        for i, w in enumerate(utts):
            write_wav(os.path.join(d, f'{i}.wav'), w, SR)
            f.write(f'utt{i} {os.path.join(d, f"{i}.wav")}\n')
    result = os.path.join(d, 'text')
    t0 = time.perf_counter()
    decoder_main.main(['--model_dir', d, '--wav_scp', scp, '--result_file',
                       result, '--chunk_size', '16', '--beam_size', '10',
                       '--ctc_weight', str(STREAM_OPTS['ctc_weight']),
                       '--reverse_weight', str(STREAM_OPTS['reverse_weight']),
                       '--streaming_interval_ms', '200', '--device', 'cuda'])
    with open(result, encoding='utf-8') as f:
        lines = f.read().splitlines()
    want = [f'utt{i} {final[0][0]}' for i, final in enumerate(finals)]
    if lines != want:
        raise RuntimeError(f'decoder_main wrote {[x[:30] for x in lines]}, '
                           f'9c\'s finals are {[x[:30] for x in want]}')
    print(f'  decoder_main --device cuda ({time.perf_counter() - t0:.1f} s, '
          f'the model directory\'s load included): {len(lines)} result '
          f'lines equal to 9c\'s finals')
    # the HTTP main and the API decode at their defaults (ctc_weight 0.5,
    # reverse_weight 0): hold them to 9c's decoder at those options
    default = stream_utterance(streaming_decoder(
        model, 'cuda', tokenizer, ctc_weight=0.5, reverse_weight=0.0),
        utts[0])[1]
    made = []
    make = http_server_main.make_server
    http_server_main.make_server = lambda *a, **kw: made.append(
        make(*a, **kw)) or made[-1]
    port = free_port()
    serve = threading.Thread(target=http_server_main.main, args=(
        ['--model_dir', d, '--port', str(port), '--host', '127.0.0.1',
         '--device', 'cuda'],), daemon=True)
    try:
        serve.start()
        deadline = time.monotonic() + 300
        while not made and serve.is_alive() and time.monotonic() < deadline:
            time.sleep(0.05)
        if not made:
            raise RuntimeError('http_server_main did not start')
        with open(os.path.join(d, '0.wav'), 'rb') as f:
            req = urllib.request.Request(f'http://127.0.0.1:{port}/',
                                         data=f.read(), method='POST')
        with urllib.request.urlopen(req, timeout=300) as resp:
            ans = json.loads(resp.read())
    finally:
        http_server_main.make_server = make
        if made:
            made[0].shutdown()
        serve.join(timeout=60)
    if serve.is_alive():
        raise RuntimeError('http_server_main did not stop')
    same_results([(r['sentence'], r['score']) for r in ans['nbest']],
                 default, 'http_server_main', dict(atol=1e-4, rtol=0.0))
    rec = api.wenet_init(d, device='cuda')
    out = json.loads(rec.decode(np.round(utts[0] * 32768).astype(
        '<i2').tobytes(), 1))
    if out['type'] != 'final_result' or \
            out['nbest'][0]['sentence'] != default[0][0]:
        raise RuntimeError(f'WenetRecognizer: {str(out)[:200]}')
    print(f'  http_server_main on port {port}: one request answered with '
          f'the {len(ans["nbest"])}-best of the decoder at its options; '
          f'WenetRecognizer.decode: the same final ({len(default[0][0])} '
          'chars)')


def streaming_checks(smi):
    """Phases 9a-9g on one flagship model (the card's and a CPU copy);
    -> (K1 launches on 9c's streaming run, 9e's readings, K1 launches on
    9f's batched run, 9f's readings)."""
    model = flagship_model()
    cpu_model = copy.deepcopy(model).eval()
    model = model.cuda().eval()
    tokenizer = flagship_tokenizer()
    feats = fbank_check(model)
    chunk_check(model, cpu_model, feats[0])
    utts, finals, launches = decoder_check(model, cpu_model, tokenizer)
    rtf = http_check(model, tokenizer, utts, finals)
    readings = streaming_speed(model, tokenizer, smi)
    readings['http_rtf'] = rtf
    batched_launches, batched = batched_serving_check(model, tokenizer, smi)
    model_dir_check(model, tokenizer, utts, finals)
    return launches, readings, batched_launches, batched


# ---------------------------------------------------------------------------
# 10. the training entry point: the recipe's stages 1, 4 and 5
# ---------------------------------------------------------------------------
RECIPE_UTTS = (48, 8)  # train, cv utterances
RECIPE_SECONDS = (3.0, 12.0)
RECIPE_8K = 4  # train utterances written at 8 kHz, so that resample runs
ENTRY_DECODE = 4  # wavs decoder_main decodes on the card and on the CPU
RECIPE_TRAIN_SHARDS = 4


def write_shards(d, name, entries, n_shards):
    """`entries` in `n_shards` local tars (wav and txt members per key)
    and their shard list -> the list's path."""
    import tarfile
    tars = []
    for i in range(n_shards):
        tars.append(os.path.join(d, f'{name}_{i}.tar'))
        with tarfile.open(tars[-1], 'w') as tar:
            for e in entries[i::n_shards]:
                tar.add(e['wav'], arcname=e['key'] + '.wav')
                txt = os.path.join(d, 'txt.tmp')
                with open(txt, 'w', encoding='utf-8') as f:
                    f.write(e['txt'])
                tar.add(txt, arcname=e['key'] + '.txt')
    shard_list = os.path.join(d, f'{name}.list')
    with open(shard_list, 'w') as f:
        f.writelines(t + '\n' for t in tars)
    return shard_list


def write_recipe(d, tokenizer):
    """lang_char.txt, a train and a cv shard list (local tars; the
    trainer takes one --data_type for both) and the train wav.scp of
    speech-like wavs with random transcripts of the tokenizer's chars ->
    (dict, train list, cv list, wav.scp, train wav paths)."""
    from wenet_tpu_torch.dataset.audio import write_wav
    rng = np.random.RandomState(SEED + 10)
    units = os.path.join(d, 'lang_char.txt')
    with open(units, 'w', encoding='utf-8') as f:
        for sym, i in sorted(tokenizer.symbol_table.items(),
                             key=lambda kv: kv[1]):
            f.write(f'{sym} {i}\n')
    chars = [s for s, i in tokenizer.symbol_table.items() if i >= 3]
    entries = []
    for i in range(sum(RECIPE_UTTS)):
        seconds = rng.uniform(*RECIPE_SECONDS)
        wav, rate = speech_like(rng, seconds), SR
        if i < RECIPE_8K:
            wav, rate = wav[::2], SR // 2
        path = os.path.join(d, f'utt{i}.wav')
        write_wav(path, wav, rate)
        n = int(3 * seconds) + rng.randint(0, 6)
        entries.append({'key': f'utt{i}', 'wav': path,
                        'txt': ''.join(rng.choice(chars, size=n))})
    train, cv = entries[:RECIPE_UTTS[0]], entries[RECIPE_UTTS[0]:]
    scp = os.path.join(d, 'wav.scp')
    with open(scp, 'w') as f:
        f.writelines(f'{e["key"]} {e["wav"]}\n' for e in train)
    return (units, write_shards(d, 'train', train, RECIPE_TRAIN_SHARDS),
            write_shards(d, 'cv', cv, 1), scp, [e['wav'] for e in train])


def entry_first_step(args):
    """The entry point's first step (its first batch, initial weights,
    cmvn and step seeds) on the card against the CPU, held to 6c's bars.
    The decoder's and the feed-forward dropouts (nn.Dropout) draw from the
    device's RNG, whose streams differ between the card and the CPU, so
    they are set to 0 here; the rel-pos attention dropout (K1-train's
    hash) and the dynamic chunk (a host draw) stay."""
    from wenet_tpu_torch.bin import train
    from wenet_tpu_torch.models.transformer.attention import (
        RelPositionMultiHeadedAttention)
    from wenet_tpu_torch.utils.executor import to_device_batch
    from wenet_tpu_torch.utils.train_utils import (
        TrainState, init_optimizer_and_scheduler, make_train_step)
    run = train.build(args)
    it = iter(run.train_dataset)
    batch = next(it)
    it.close()
    cpu_model = copy.deepcopy(run.model).cpu()
    configs = run.configs
    kept = 0
    for model in (run.model, cpu_model):
        hash_dropouts = {id(m.dropout) for m in model.modules()
                         if isinstance(m, RelPositionMultiHeadedAttention)}
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                if id(m) in hash_dropouts:
                    kept += m.p > 0
                else:
                    m.p = 0.0
    opt, schedule = init_optimizer_and_scheduler(configs, cpu_model)
    cpu_step = make_train_step(cpu_model, opt, schedule, None,
                               configs['accum_grad'], configs['grad_clip'])
    outs = []
    for step, model, dev, state in (
            (run.train_step, run.model, 'cuda', run.state),
            (cpu_step, cpu_model, 'cpu', TrainState(cpu_model, opt))):
        _, m = step(state, to_device_batch(batch, dev), (args.seed, 0))
        outs.append(({k: float(v) for k, v in m.items()},
                     {n: p.grad.detach().cpu()
                      for n, p in model.named_parameters()}))
    (card, card_grads), (cpu, cpu_grads) = outs
    B, T = batch['feats'].shape[:2]
    for k in ('loss', 'loss_att', 'loss_ctc'):
        print(f'  first step, B={B} x T={T}, K1 dropout on {kept // 2} '
              f'blocks: {k} card {card[k]:.6f} cpu {cpu[k]:.6f}')
        if not abs(card[k] - cpu[k]) <= 1e-4 * abs(cpu[k]) + 1e-6:
            raise RuntimeError(f'entry first step: {k} differs from the '
                               'CPU beyond rtol 1e-4')
    worst = max((card_grads[n] - g).abs().max().item()
                for n, g in cpu_grads.items())
    if worst > 1e-3 or not all(torch.isfinite(g).all()
                               for g in card_grads.values()):
        raise RuntimeError(f'entry first step: grads differ from the CPU '
                           f'by {worst} (bar 1e-3) or are not finite')
    print(f'  first step: clipped grads of {len(cpu_grads)} parameters, '
          f'max |card - cpu| {worst:.3g} (bar 1e-3)')
    del run, cpu_model
    torch.cuda.empty_cache()


def trace_readings(path):
    """(kernel launches by K1 / K2 / K3 name, kernel time / the traced
    span) of a torch.profiler Chrome trace."""
    with open(path) as f:
        events = json.load(f)['traceEvents']
    timed = [e for e in events if e.get('ph') == 'X' and 'dur' in e]
    kernels = [e for e in timed if e.get('cat') == 'kernel']
    span = (max(e['ts'] + e['dur'] for e in timed) -
            min(e['ts'] for e in timed))
    counts = {key: sum(key in e['name'] for e in kernels)
              for key in ('relpos_fwd_', 'relpos_bwd_dq_',
                          'relpos_bwd_dkpv_')}
    return counts, sum(e['dur'] for e in kernels) / span


def train_entry_check(smi):
    phase('10 train entry: compute_cmvn_stats, train, average_model, '
          'decoder_main')
    import logging
    import re
    import shutil
    import yaml
    from wenet_tpu_torch.bin import (average_model, compute_cmvn_stats,
                                     decoder_main, train)
    from wenet_tpu_torch.ops import flash_attention as fa
    d = tempfile.mkdtemp(prefix='chip_smoke_recipe_')
    units, train_list, cv_list, scp, train_wavs = write_recipe(
        d, flagship_tokenizer())
    cmvn = os.path.join(d, 'global_cmvn')
    t0 = time.perf_counter()
    stats = compute_cmvn_stats.main(['--train_config', CONFIG, '--in_scp',
                                     scp, '--out_cmvn', cmvn])
    print(f'  stage 1: cmvn stats of {stats["frame_num"]} frames in '
          f'{time.perf_counter() - t0:.2f} s')
    exp = os.path.join(d, 'exp')
    argv = ['--config', CONFIG, '--train_data', train_list, '--cv_data',
            cv_list, '--data_type', 'shard', '--model_dir', exp,
            '--seed', str(SEED), '--device', 'cuda',
            '--override_config', f'tokenizer_conf.symbol_table_path {units}',
            '--override_config', f'cmvn_conf.cmvn_file {cmvn}',
            '--override_config', 'max_epoch 2',
            '--override_config', 'log_interval 1',
            '--profile_dir', os.path.join(d, 'profile'),
            '--profile_start_step', '1', '--profile_steps', '3']
    entry_first_step(train.get_parser().parse_args(argv))

    losses = []

    class Losses(logging.Handler):
        def emit(self, record):
            m = re.search(r'TRAIN \|.* \| loss (\S+) ', record.getMessage())
            if m:
                losses.append(float(m.group(1)))

    handler = Losses()
    logging.getLogger().addHandler(handler)
    logging.getLogger().setLevel(logging.INFO)
    records = []
    fa.reset_launches()
    t0 = time.perf_counter()
    try:
        summary = train.main(argv, on_step=records.append)
    finally:
        logging.getLogger().removeHandler(handler)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    wall = time.perf_counter() - t0
    epochs = summary['epochs']
    print(f'  stage 4: train.main, 2 epochs in {wall:.1f} s (model init, '
          f'cv and saves included; {smi})')
    for r, loss in zip(records, losses):
        print(f'    epoch {r["epoch"]} step {r["step"]}: B={r["batch"]} x '
              f'T={r["frames"]} ({r["audio_frames"] / 100:.1f} s of audio), '
              f'loss {loss:.4f}, data wait {1e3 * r["data_wait"]:.1f} ms, '
              f'step {1e3 * r["step_time"]:.1f} ms')
    for e in epochs:
        print(f'    epoch {e["epoch"]}: {e["steps"]} steps in '
              f'{e["train_seconds"]:.3f} s, '
              f'{e["steps"] / e["train_seconds"]:.3f} steps/s, '
              f'{e["audio_seconds"] / e["train_seconds"]:.1f} audio-sec/s; '
              f'data wait {e["data_wait_seconds"]:.3f} s; profiler start '
              f'and trace {e["profile_seconds"]:.3f} s (left out); cv '
              f'{e["cv_seconds"]:.3f} s (loss {e["cv"]["loss"]:.4f}); '
              f'checkpoint save {e["save_seconds"]:.3f} s ({smi})')
    firsts = {min(r['step'] for r in records if r['epoch'] == e['epoch'])
              for e in epochs}
    later = [r for r in records if r['step'] not in firsts]
    waits = [r['data_wait'] for r in later]
    steps = [r['step_time'] for r in later]
    print(f'    after each epoch\'s first step: data wait '
          f'{1e3 * np.mean(waits):.1f} ms a step (max '
          f'{1e3 * max(waits):.1f}) beside a step of '
          f'{1e3 * np.mean(steps):.1f} ms')
    if len(losses) != len(records) or not np.isfinite(losses).all():
        raise RuntimeError(f'train entry: losses {losses}')
    for e in (0, 1):
        if not os.path.exists(os.path.join(exp, f'epoch_{e}.pt')):
            raise RuntimeError(f'train entry: no epoch_{e}.pt')
    # the window opens after step 1 and closes after step 4, or at the end
    # of the epoch
    traced = sum(r['epoch'] == 0 and 1 < r['step'] <= 4 for r in records)
    counts, busy = trace_readings(summary['profile_trace'])
    print(f'    profiled steps 2-{traced + 1}: kernel launches {counts}; card '
          f'busy {100 * busy:.1f}% of the traced span ({smi})')
    n_blocks = flagship_configs()['encoder_conf']['num_blocks']
    if not traced or any(n != traced * n_blocks for n in counts.values()):
        raise RuntimeError(f'trace: {counts} over {traced} steps, expected '
                           f'{n_blocks} a step each')
    n_steps = len(records)
    for name in TRAIN_KERNELS:
        if launches[name] != n_blocks * n_steps:
            raise RuntimeError(f'{name}: {launches[name]} launches over '
                               f'{n_steps} steps, expected {n_blocks} a step')
    if launches['relpos_attention_fwd'] == 0:
        raise RuntimeError('cv ran without K1 (inference)')
    print(f'    launches: {launches} (K1 inference: cv)')

    t0 = time.perf_counter()
    avg = os.path.join(d, 'avg_2.pt')
    chosen = average_model.main(['--src_path', exp, '--dst_model', avg,
                                 '--num', '2', '--val_best'])
    print(f'  stage 5: average_model --num 2 --val_best of '
          f'{[os.path.basename(p) for p in chosen]} in '
          f'{time.perf_counter() - t0:.2f} s')
    if len(chosen) != 2 or not os.path.exists(avg):
        raise RuntimeError('average_model did not average two epochs')
    model_dir = os.path.join(d, 'model')
    os.makedirs(model_dir)
    shutil.copy(os.path.join(exp, 'train.yaml'), model_dir)
    shutil.copy(units, os.path.join(model_dir, 'units.txt'))
    shutil.copy(avg, os.path.join(model_dir, 'final.pt'))
    wavs = train_wavs[RECIPE_8K:RECIPE_8K + ENTRY_DECODE]
    wav_scp = os.path.join(d, 'decode.scp')
    with open(wav_scp, 'w') as f:
        f.writelines(f'utt{i} {w}\n' for i, w in enumerate(wavs))
    texts = {}
    for dev in ('cuda', 'cpu'):
        t0 = time.perf_counter()
        result = os.path.join(d, f'text_{dev}')
        decoder_main.main(['--model_dir', model_dir, '--wav_scp', wav_scp,
                           '--result_file', result, '--device', dev])
        with open(result, encoding='utf-8') as f:
            texts[dev] = f.read().splitlines()
        print(f'  decoder_main --device {dev}: {len(texts[dev])} results in '
              f'{time.perf_counter() - t0:.1f} s (load included)')
    if texts['cuda'] != texts['cpu'] or len(texts['cuda']) != ENTRY_DECODE:
        raise RuntimeError(f'decoder_main: card {texts["cuda"]} != cpu '
                           f'{texts["cpu"]}')
    print(f'  the averaged model\'s hypotheses on the card equal the CPU\'s '
          f'({sum(len(t.split(" ", 1)[-1]) for t in texts["cuda"])} chars)')
    shutil.rmtree(d)
    return launches


# ---------------------------------------------------------------------------
# 11. the recipe's decode stage: bin/recognize.py
# ---------------------------------------------------------------------------
RECOGNIZE_UTTS = 64
RECOGNIZE_SECONDS = (3.0, 12.0)
RECOGNIZE_ARGS = ['--batch_size', '16', '--beam_size', '10', '--ctc_weight',
                  '0.3', '--reverse_weight', '0.5']
RECOGNIZE_MODES = ['ctc_greedy_search', 'ctc_prefix_beam_search',
                   'attention_rescoring', 'attention']
RECOGNIZE_CPU = 16  # utterances decoded on the CPU too: the first batch
# the attention beam on the CPU: on random weights it runs every step
RECOGNIZE_CPU_ATTENTION = 4
CONTEXT_CHECK_UTTS = 8  # utterances of the Python plain context search
LM_WEIGHT = 0.5


def write_decode_recipe(d, tokenizer, model):
    """A model directory's files (train.yaml, units.txt, final.pt), 64
    speech-like wavs of 3-12 s with random transcripts of the vocabulary,
    data lists of all of them and of the first 16 and 4, and the reference
    text -> {name: path}, the entries, the audio seconds."""
    import yaml
    from wenet_tpu_torch.dataset.audio import write_wav
    rng = np.random.RandomState(SEED + 20)
    paths = {n: os.path.join(d, n) for n in (
        'units.txt', 'train.yaml', 'final.pt', 'all.list', 'cpu.list',
        'att.list', 'ref.txt')}
    with open(paths['units.txt'], 'w', encoding='utf-8') as f:
        for sym, i in sorted(tokenizer.symbol_table.items(),
                             key=lambda kv: kv[1]):
            f.write(f'{sym} {i}\n')
    with open(CONFIG) as f:
        configs = yaml.safe_load(f)
    configs['tokenizer_conf']['symbol_table_path'] = paths['units.txt']
    with open(paths['train.yaml'], 'w') as f:
        yaml.safe_dump(configs, f)
    torch.save(model.state_dict(), paths['final.pt'])
    chars = [s for s, i in tokenizer.symbol_table.items() if i >= 3]
    entries, seconds = [], 0.0
    for i in range(RECOGNIZE_UTTS):
        s = rng.uniform(*RECOGNIZE_SECONDS)
        seconds += s
        wav = os.path.join(d, f'utt{i:02d}.wav')
        write_wav(wav, speech_like(rng, s), SR)
        entries.append({'key': f'utt{i:02d}', 'wav': wav, 'txt': ''.join(
            rng.choice(chars, size=int(3 * s) + rng.randint(0, 6)))})
    for name, n in (('all.list', RECOGNIZE_UTTS), ('cpu.list', RECOGNIZE_CPU),
                    ('att.list', RECOGNIZE_CPU_ATTENTION)):
        with open(paths[name], 'w', encoding='utf-8') as f:
            f.writelines(json.dumps(e, ensure_ascii=False) + '\n'
                         for e in entries[:n])
    with open(paths['ref.txt'], 'w', encoding='utf-8') as f:
        f.writelines(f'{e["key"]} {e["txt"]}\n' for e in entries)
    return paths, entries, seconds


def recognize_main(paths, modes, out, data='all.list', device='cuda',
                   extra=()):
    """bin/recognize.main -> ({mode: {key: text}}, its summary: decode
    seconds through the Dataset, load excluded, and audio seconds)."""
    from wenet_tpu_torch.bin import recognize
    summary = recognize.main([
        '--config', paths['train.yaml'], '--test_data', paths[data],
        '--checkpoint', paths['final.pt'], *RECOGNIZE_ARGS, '--modes',
        *modes, '--result_dir', out, '--device', device, *extra])
    texts = {}
    for mode in modes:
        with open(os.path.join(out, mode, 'text'), encoding='utf-8') as f:
            texts[mode] = dict((line.split(' ', 1) + [''])[:2]
                               for line in f.read().splitlines())
    return texts, summary


def same_text(got, want, what):
    if got != want:
        diff = [k for k in want if got.get(k) != want[k]]
        raise RuntimeError(f'{what}: {len(diff)} of {len(want)} texts '
                           f'differ (first {diff[:3]}: '
                           f'{[got.get(k, "")[:12] for k in diff[:3]]} vs '
                           f'{[want[k][:12] for k in diff[:3]]})')


def same_nbest(got, want, what, logp):
    """Raise unless the C++ beam's (hyps, times, scores) equal the Python
    plain version's DecodeResult up to float32 near-ties: the C++ beam sums
    in float32, the plain version in float64, so two hypotheses whose
    scores lie within the bar, 1e-5 + 1e-6 of their size, may swap, and
    two alignments of one hypothesis whose Viterbi scores tie may put its
    timestamps on other frames.  Every hypothesis in both lists has a
    score within the bar; one in only one list ties the other list's last
    within the bar (the beam's edge); the two bests differ only where they
    tie.  -> the largest score difference, the number of swaps at the
    edge, the number of hypotheses whose times moved, and the largest gap
    between a moved token's log-probs (`logp`, (T, V)) at its two
    frames."""
    hyps, times, scores = got
    theirs = {tuple(h): (t, s) for h, t, s in zip(
        want.nbest, want.nbest_times, want.nbest_scores)}
    ours = {tuple(h): (t, s) for h, t, s in zip(hyps, times, scores)}

    def tie(a, b):
        return abs(a - b) <= 1e-5 + 1e-6 * abs(b)

    worst, swaps, moved, gap = 0.0, 0, 0, 0.0
    for h, (t, sc) in ours.items():
        if h in theirs:
            if not tie(sc, theirs[h][1]):
                raise RuntimeError(f'{what}: a hypothesis differs in score '
                                   f'({sc} vs {theirs[h][1]})')
            worst = max(worst, abs(sc - theirs[h][1]))
            if list(t) != list(theirs[h][0]):
                moved += 1
                gap = max([gap] + [abs(float(logp[a, u] - logp[b, u]))
                                   for u, a, b in zip(h, t, theirs[h][0])
                                   if a != b])
        elif not tie(sc, want.nbest_scores[-1]):
            raise RuntimeError(f'{what}: the C++ beam keeps a hypothesis '
                               f'the plain version does not ({sc})')
        else:
            swaps += 1
    for h, (_, sc) in theirs.items():
        if h not in ours and not tie(sc, scores[-1]):
            raise RuntimeError(f'{what}: the plain version keeps a '
                               f'hypothesis the C++ beam does not ({sc})')
    if hyps[0] != want.nbest[0] and not tie(scores[0], want.nbest_scores[0]):
        raise RuntimeError(f'{what}: the best hypotheses differ')
    return worst, swaps, moved, gap


def plain_search_check(what, cpp, plain, dense, keys, texts, tokenizer):
    """Hold the C++ searches `cpp` to the plain version's results `plain`
    on the log-probs `dense` (same_nbest) and, where `texts` ({key:
    recognize's text}) is given, each recognize text to the checked
    search's best.  On a mismatch, print both n-bests with their scores
    before raising, to show whether the searches parted at a float32
    near-tie.  -> a line of what held."""
    worst, swaps, moved, gap = 0.0, 0, 0, 0.0
    for b, (got, p) in enumerate(zip(cpp, plain)):
        try:
            w, n_swaps, n_moved, g = same_nbest(got, p,
                                                f'{what}, utterance {b}',
                                                dense[b])
        except RuntimeError:
            ours = [(len(h), float(s)) for h, s in zip(got[0], got[2])]
            theirs = [(len(h), float(s))
                      for h, s in zip(p.nbest, p.nbest_scores)]
            print(f'  {what}, utterance {b}: (length, score) of the C++ '
                  f'n-best {ours}; of the plain n-best {theirs}')
            raise
        worst, swaps = max(worst, w), swaps + n_swaps
        moved, gap = moved + n_moved, max(gap, g)
        if texts is not None and \
                tokenizer.detokenize(got[0][0])[0] != texts[keys[b]]:
            raise RuntimeError(f'{what}: the recognize text of {keys[b]} is '
                               'not the checked search\'s best')
    return (f'scores within {worst:.2g}, {swaps} near-tie swaps at the '
            f'beam\'s edge, {moved} of {len(cpp) * len(cpp[0][0])} '
            f'hypotheses with times on other frames of tied alignments '
            f'(the moved tokens\' log-probs at their two frames {gap:.2g} '
            'apart)')


def recognize_check(smi):
    phase('11 recognize: bin/recognize.py at full width, each mode alone and '
          'all four, context, LM, alignment')
    import shutil
    from wenet_tpu_torch.bin import alignment, recognize
    from wenet_tpu_torch.lm.arpa import read_arpa
    from wenet_tpu_torch.ops import flash_attention as fa
    from wenet_tpu_torch.runtime import native_beam
    from wenet_tpu_torch.utils.context_graph import (
        ContextGraph, ctc_prefix_beam_search_with_context)
    from wenet_tpu_torch.utils.ctc_utils import remove_duplicates_and_blank
    import logging
    # recognize logs every hypothesis at INFO: a handler now, so that its
    # basicConfig leaves the level alone
    logging.basicConfig()
    logging.getLogger().setLevel(logging.WARNING)
    d = tempfile.mkdtemp(prefix='chip_smoke_recognize_')
    tokenizer = flagship_tokenizer()
    cpu_model = flagship_model().eval()
    paths, entries, audio_s = write_decode_recipe(d, tokenizer, cpu_model)
    n_blocks = flagship_configs()['encoder_conf']['num_blocks']
    n_batches = -(-RECOGNIZE_UTTS // 16)
    print(f'  {RECOGNIZE_UTTS} wavs, {audio_s:.1f} s of audio, '
          f'{n_batches} batches of 16')

    # a first run (the card's and the libraries' set-up) outside the timing
    recognize_main(paths, ['ctc_greedy_search'], os.path.join(d, 'warm'),
                   'att.list')
    alone, launches, rates = {}, 0, {}
    for mode in RECOGNIZE_MODES:
        fa.reset_launches()
        texts, summary = recognize_main(paths, [mode],
                                        os.path.join(d, 'alone'))
        rates[mode] = {'recognize': summary['audio_seconds'] /
                       summary['seconds']}
        n = fa.LAUNCHES['relpos_attention_fwd']
        if n != n_blocks * n_batches:
            raise RuntimeError(f'recognize {mode}: {n} K1 launches, expected '
                               f'{n_blocks} x {n_batches} batches')
        launches += n
        alone[mode] = texts[mode]
        print(f'  recognize --modes {mode}: '
              f'{rates[mode]["recognize"]:.1f} audio-sec/s '
              f'({summary["audio_seconds"]:.1f} s of valid frames in '
              f'{summary["seconds"]:.3f} s, load excluded); K1 {n} launches '
              f'({smi})')
    together, summary = recognize_main(paths, RECOGNIZE_MODES,
                                       os.path.join(d, 'all'))
    print(f'  recognize with the four modes in one run: '
          f'{summary["seconds"]:.3f} s, '
          f'{summary["audio_seconds"] / summary["seconds"]:.1f} audio-sec/s')
    for mode in RECOGNIZE_MODES:
        same_text(alone[mode], together[mode],
                  f'{mode} alone vs beside the other three')
    nonempty = sum(bool(t) for m in together.values() for t in m.values())
    total = len(RECOGNIZE_MODES) * RECOGNIZE_UTTS
    print(f'  each mode alone == beside the other three; {nonempty} of '
          f'{total} hypotheses non-empty')
    if 2 * nonempty < total:
        raise RuntimeError(f'only {nonempty} of {total} hypotheses are '
                           'non-empty')

    # the Dataset alone, then each mode's loop over it on one runner
    # without recognize's writing (load left out); the card's busy share
    # and kernel time a batch of the rescoring
    args = recognize.get_parser().parse_args([
        '--config', paths['train.yaml'], '--test_data', paths['all.list'],
        '--checkpoint', paths['final.pt'], *RECOGNIZE_ARGS, '--result_dir',
        d, '--device', 'cuda'])
    _, _, blank_id, dataset, runner = recognize.build(args)
    kw = dict(beam_size=10, ctc_weight=0.3, reverse_weight=0.5,
              blank_id=blank_id)
    t0 = time.perf_counter()
    frames = sum(int(b['feats_lengths'].sum()) for b in dataset)
    print(f'  the Dataset alone (wav reading, fbank, padding; one prefetch '
          f'thread): {frames / 100 / (time.perf_counter() - t0):.1f} '
          'audio-sec/s')
    nbest = {}

    def loop(mode):
        for batch in dataset:
            res = runner.decode([mode], batch['feats'],
                                batch['feats_lengths'], **kw)[mode]
            if mode == 'ctc_prefix_beam_search':
                nbest.update(zip(batch['keys'], res))
        torch.cuda.synchronize()

    for mode in RECOGNIZE_MODES:
        t0 = time.perf_counter()
        loop(mode)
        rates[mode]['runner'] = frames / 100 / (time.perf_counter() - t0)
    print('  the runner\'s loop over the Dataset, audio-sec/s: ' +
          ', '.join(f'{m} {r["runner"]:.1f}' for m, r in rates.items()) +
          f' ({smi})')
    _, busy, wall = busy_share(lambda: loop('attention_rescoring'))
    print(f'  attention_rescoring, profiled: card busy {100 * busy:.1f}% of '
          f'{wall:.2f} s, {1e3 * busy * wall / n_batches:.1f} ms of kernels '
          f'in a batch of {1e3 * wall / n_batches:.1f} ms ({smi})')

    # card against the CPU: the first batch, the attention beam on four
    cpu, _ = recognize_main(paths, RECOGNIZE_MODES[:3],
                            os.path.join(d, 'cpu'), 'cpu.list', 'cpu')
    cpu_att, _ = recognize_main(paths, ['attention'],
                                os.path.join(d, 'cpu_att'), 'att.list', 'cpu')
    card_att, _ = recognize_main(paths, ['attention'],
                                 os.path.join(d, 'card_att'), 'att.list')
    for mode in RECOGNIZE_MODES[:3]:
        same_text(cpu[mode], {k: together[mode][k] for k in cpu[mode]},
                  f'{mode} card vs cpu')
    same_text(cpu_att['attention'], card_att['attention'],
              'attention card vs cpu')
    print(f'  card == CPU: {RECOGNIZE_CPU} utterances in three modes, '
          f'{RECOGNIZE_CPU_ATTENTION} in attention')

    # the C++ searches on the first batch's top-k from the card, each held
    # to the Python plain version on the same top-k
    batch = next(iter(dataset))
    with torch.inference_mode():
        feats = torch.as_tensor(batch['feats'], device='cuda')
        lens = torch.as_tensor(batch['feats_lengths'], device='cuda')
        eo, mask = runner.model.forward_encoder(feats, lens)
        vals, ids = runner.model.ctc_topk(eo, 10)
    n = CONTEXT_CHECK_UTTS
    vals, ids = vals[:n].float().cpu().numpy(), ids[:n].int().cpu().numpy()
    enc_lens = mask[:n, 0].sum(-1).cpu().numpy()
    dense = np.full(vals.shape[:2] + (4233,), -np.inf, np.float32)
    np.put_along_axis(dense, ids.astype(np.int64), vals, axis=-1)
    keys = batch['keys'][:n]

    # context biasing.  List A, three phrases of the best hypotheses (their
    # commonest two-char pieces, then chars).  List B, the three chars of
    # the n-best lists that the fewest best hypotheses hold: the boost
    # (random weights emit few distinct chars, so A's phrases are in most
    # hypotheses already)
    hyps = list(alone['ctc_prefix_beam_search'].values())
    pieces = {}
    for h in hyps:
        for i in range(len(h) - 1):
            pieces[h[i:i + 2]] = pieces.get(h[i:i + 2], 0) + 1
    phrases = {'A': (sorted(pieces, key=lambda p: (-pieces[p], p)) +
                     sorted({c for h in hyps for c in h}))[:3]}
    alternatives = {}
    for r in nbest.values():
        for h in r.nbest[1:]:
            for ch in set(tokenizer.detokenize(h)[0]):
                alternatives[ch] = alternatives.get(ch, 0) + 1
    held = {ch: sum(ch in h for h in hyps) for ch in alternatives}
    phrases['B'] = sorted(held, key=lambda ch: (held[ch], -alternatives[ch],
                                                ch))[:3]
    for name, listed in phrases.items():
        path = os.path.join(d, f'context_{name}.txt')
        with open(path, 'w', encoding='utf-8') as f:
            f.writelines(p + '\n' for p in listed)
        texts = recognize_main(
            paths, ['ctc_prefix_beam_search'], os.path.join(d, f'ctx_{name}'),
            extra=['--context_list_path', path])[0]['ctc_prefix_beam_search']
        graph = ContextGraph(path, tokenizer.symbol_table, context_score=6.0)
        t0 = time.perf_counter()
        cpp = native_beam.batch_search_topk(vals, ids, enc_lens, 10,
                                            blank_id, context_graph=graph)
        t_cpp = time.perf_counter() - t0
        t0 = time.perf_counter()
        plain = ctc_prefix_beam_search_with_context(dense, enc_lens, 10,
                                                    graph, blank_id)
        t_plain = time.perf_counter() - t0
        held_up = plain_search_check(f'context {name}', cpp, plain, dense,
                                     keys, texts, tokenizer)
        boosted = [sum(p in t for t in texts.values()) for p in listed]
        unboosted = [sum(p in h for h in hyps) for p in listed]
        print(f'  context {name} {listed}: the C++ beam on the card\'s top-k '
              f'== the plain version on {n} utterances ({held_up}; C++ '
              f'{1e3 * t_cpp:.0f} ms, Python {t_plain:.1f} s), the recognize '
              f'text its best; hypotheses with each phrase {boosted} with '
              f'the list, {unboosted} without')
        if name == 'B' and not any(b > u for b, u in zip(boosted,
                                                          unboosted)):
            raise RuntimeError('the context list boosted no phrase')
    graph_a = ContextGraph(os.path.join(d, 'context_A.txt'),
                           tokenizer.symbol_table, context_score=6.0)

    # the LM: a bigram ARPA of the hypotheses' chars, fused into the C++
    # search (as AsrDecoder does) and in recognize's n-best rescoring
    words = sorted({c for t in hyps for c in t})
    bigrams = sorted({t[i:i + 2] for t in hyps
                      for i in range(len(t) - 1)})[:200]
    rng = np.random.RandomState(SEED + 21)
    lines = ['\\data\\', f'ngram 1={len(words) + 3}',
             f'ngram 2={len(bigrams)}', '', '\\1-grams:', '-99\t<s>\t-0.5',
             '-1.5\t</s>', '-4.0\t<unk>']
    lines += [f'{-rng.uniform(1, 4):.3f}\t{w}\t{-rng.uniform(0, 1):.3f}'
              for w in words]
    lines += ['', '\\2-grams:'] + [
        f'{-rng.uniform(0, 1):.3f}\t{b[0]} {b[1]}' for b in bigrams]
    lines += ['', '\\end\\', '']
    with open(os.path.join(d, 'lm.arpa'), 'w', encoding='utf-8') as f:
        f.write('\n'.join(lines))
    lm = read_arpa(os.path.join(d, 'lm.arpa'))
    id2sym = {v: k for k, v in tokenizer.symbol_table.items()}
    cpp = native_beam.batch_search_topk(vals, ids, enc_lens, 10, blank_id,
                                        lm=lm, lm_weight=LM_WEIGHT,
                                        symbol_table=id2sym)
    plain = ctc_prefix_beam_search_with_context(
        dense, enc_lens, 10, None, blank_id, lm=lm, lm_weight=LM_WEIGHT,
        symbol_table=id2sym)
    held_up = plain_search_check('LM fusion', cpp, plain, dense, keys, None,
                                 tokenizer)
    fused_moved = sum(got[0][0] != nbest[k].nbest[0]
                      for got, k in zip(cpp, keys))
    print(f'  LM fused into the C++ beam on the card\'s top-k == the plain '
          f'version on {n} utterances ({held_up}); it changed {fused_moved} '
          f'of {n} bests')
    lm_text, _ = recognize_main(paths, ['ctc_prefix_beam_search'],
                                os.path.join(d, 'lm'), extra=[
                                    '--lm_path', os.path.join(d, 'lm.arpa'),
                                    '--lm_weight', str(LM_WEIGHT)])
    want, moved = {}, 0
    for key, r in nbest.items():
        fused = [s + LM_WEIGHT * lm.score_sequence([id2sym[t] for t in h])
                 for h, s in zip(r.nbest, r.nbest_scores)]
        best = r.nbest[int(np.argmax(fused))]
        want[key] = tokenizer.detokenize(best)[0]
        moved += best != r.nbest[0]
    same_text(lm_text['ctc_prefix_beam_search'], want,
              'recognize --lm_path vs plain n-best rescoring')
    print(f'  --lm_path (a bigram ARPA of {len(words)} chars): equal to a '
          f'plain n-best rescoring; it changed {moved} of '
          f'{len(nbest)} winners')

    # one stream through AsrDecoder with the context and the LM
    wav = speech_like(np.random.RandomState(SEED + 22), 6.5)
    streams = []
    for model, dev in ((copy.deepcopy(cpu_model).cuda().eval(), 'cuda'),
                       (cpu_model, 'cpu')):
        from wenet_tpu_torch.runtime.asr_decoder import (AsrDecoder,
                                                         DecodeOptions)
        from wenet_tpu_torch.runtime.feature_pipeline import (
            FeaturePipelineConfig)
        dec = AsrDecoder(model, tokenizer, DecodeOptions(**STREAM_OPTS),
                         FeaturePipelineConfig(num_mel_bins=80),
                         context_graph=graph_a, lm=lm, lm_weight=LM_WEIGHT,
                         device=dev)
        streams.append(stream_utterance(dec, wav))
    (card_p, card_f, _), (cpu_p, cpu_f, _) = streams
    for i, (g, w) in enumerate(zip(card_p, cpu_p)):
        same_results(g, w, f'AsrDecoder with context and LM, partial {i}')
    same_results(card_f, cpu_f, 'AsrDecoder with context and LM, final')
    print(f'  AsrDecoder with the context and the LM: {len(card_p)} partials '
          f'and the final card == CPU ({card_f[0][0][:12]!r}...)')

    # forced alignment of four utterances
    alis = [alignment.main(['--config', paths['train.yaml'], '--input_file',
                            paths['att.list'], '--checkpoint',
                            paths['final.pt'], '--result_file',
                            os.path.join(d, f'ali_{dev}.txt'), '--device',
                            dev]) for dev in ('cuda', 'cpu')]
    if alis[0] != alis[1]:
        raise RuntimeError('alignment: card and CPU differ')
    for e in entries[:RECOGNIZE_CPU_ATTENTION]:
        if remove_duplicates_and_blank(alis[0][e['key']]) != \
                tokenizer.tokenize(e['txt'])[1]:
            raise RuntimeError(f'alignment of {e["key"]} is not its label')
    print(f'  alignment: {len(alis[0])} utterances card == CPU, each '
          'collapsing to its label')

    wer = {}
    for mode in RECOGNIZE_MODES:
        hyp = os.path.join(d, 'all', mode, 'text')
        out = subprocess.run(
            [sys.executable, os.path.join(REPO, 'tools/compute_wer.py'),
             '--char=1', '--v=1', paths['ref.txt'], hyp],
            capture_output=True, text=True, check=True).stdout
        wer[mode] = [line for line in out.splitlines()
                     if line.startswith('Overall')][0]
        print(f'  compute_wer {mode}: {wer[mode]} (random weights: a '
              'reading, not a gate)')
    readings = {'rates': rates, 'busy': busy}
    shutil.rmtree(d)
    return launches, readings


# ---------------------------------------------------------------------------
# 12. the encoder zoo
# ---------------------------------------------------------------------------
ZOO = {  # name: (yaml, output_dim, K1 launches per decode)
    'transformer': ('examples/aishell/s0/conf/train_transformer.yaml',
                    4233, 0),
    'transformer_timit': ('examples/timit/s0/conf/train_transformer.yaml',
                          62, 0),
    'conformer_conv2d6': ('examples/openasr2021/s0/conf/'
                          'train_conformer_large_10h.yaml', 5002, 24),
    'e_branchformer': ('examples/aishell/s0/conf/train_ebranchformer.yaml',
                       4233, 16),
    'squeezeformer': ('examples/aishell/s0/conf/train_squeezeformer.yaml',
                      4233, 0),
    'efficient_conformer': ('examples/aishell/s0/conf/'
                            'train_u2pp_efficonformer.yaml', 4233, 8),
}
ZOO_DECODE = (16, 15.0)  # B x seconds of 12a's decodes
ZOO_K4_DECODE = (64, 15.0)  # the conv2d transformer above K4's gate
ZOO_TRAIN_STEP = (4, 8.0)  # 12c's card-against-CPU step
ZOO_GRAD_RTOL = 2e-4  # 12c's gradient bar beside 6c's 1e-3 (zoo_step_check)
ZOO_EXECUTOR = {  # 12d: name -> (B, seconds, the kernels counted a step)
    'e_branchformer': (16, 12.0, tuple(TRAIN_KERNELS)),
    'efficient_conformer': (16, 12.0, tuple(TRAIN_KERNELS)),
    'transformer': (64, 15.0, tuple(FLASH_TRAIN_KERNELS)),
}
ZOO_ENTRY = 'efficient_conformer'  # 12e: bin/train.py, recognize, streaming
ZOO_RECOGNIZE_UTTS = 16


def zoo_configs(name, dropout=True):
    """The zoo yaml's configs with its fbank's input_dim; dropout=False
    sets every dropout rate of the encoder and decoder to 0."""
    import yaml
    path, output_dim, _ = ZOO[name]
    with open(os.path.join(REPO, path)) as f:
        configs = yaml.safe_load(f)
    configs['input_dim'] = configs['dataset_conf']['fbank_conf'][
        'num_mel_bins']
    configs['output_dim'] = output_dim
    if not dropout:
        for conf in (configs['encoder_conf'], configs['decoder_conf']):
            for key in list(conf):
                if key.endswith('dropout_rate'):
                    conf[key] = 0.0
        if configs['encoder'] == 'squeezeformer':
            configs['encoder_conf']['dropout'] = 0.0
    return configs


def zoo_model(configs):
    """The configs' model on the CPU, weights and cmvn drawn from SEED."""
    from wenet_tpu_torch.utils.init_model import init_model
    model = init_model(configs, torch.Generator().manual_seed(SEED),
                       device='cpu')
    rng = np.random.RandomState(SEED)
    idim = configs['input_dim']
    cmvn = model.encoder.global_cmvn
    cmvn.mean.copy_(torch.from_numpy(rng.randn(idim).astype(np.float32)))
    cmvn.istd.copy_(torch.from_numpy(
        (0.5 + rng.rand(idim)).astype(np.float32)))
    return model


def zoo_features(rng, B, seconds, idim):
    """B rows of `seconds` of fbank-shaped features, the first full, the
    others from 2/3 of it."""
    T = int(seconds * 100)
    feats = rng.randn(B, T, idim).astype(np.float32)
    lens = rng.randint(2 * T // 3, T + 1, size=B).astype(np.int64)
    lens[0] = T
    return feats, lens


def zoo_train_batch(rng, B, seconds, idim, vocab):
    feats, lens = zoo_features(rng, B, seconds, idim)
    tl = rng.randint(10, 49, size=B)
    tgt = np.full((B, 48), -1, np.int64)
    for i, n in enumerate(tl):
        tgt[i, :n] = rng.randint(3, vocab - 3, size=n)
    return dict(feats=feats, feats_lengths=lens, target=tgt,
                target_lengths=tl.astype(np.int64))


def gate_open(B, h, T1, T2):
    """attention_core's flash gate at (B, h, T1, T2): `flash_eligible` of
    broadcast views of one element on the card (they hold no memory)."""
    from wenet_tpu_torch.models.transformer.attention import flash_eligible
    one = torch.empty(1, 1, 1, 1, device='cuda')
    return flash_eligible(one.expand(B, h, T1, 64), one.expand(B, h, T2, 64))


def rescoring_k4(configs, results, T, reverse_weight):
    """K4 launches of attention_rescoring's one decoder pass over the
    prefix beam's n-best `results` and T encoder frames: the (B·N, L + 1)
    hypothesis grid (L the longest hypothesis, padded to a multiple of 8)
    through each decoder layer's self-attention and cross-attention,
    where the gate admits them; the right decoder's layers too with a
    reverse weight."""
    n = max(len(r.nbest) for r in results)
    longest = max((len(h) for r in results for h in r.nbest), default=0)
    L = max(8, -(-longest // 8) * 8) + 1
    conf = configs['decoder_conf']
    layers = conf['num_blocks']
    if configs['decoder'] == 'bitransformer' and reverse_weight > 0.0:
        layers += conf['r_num_blocks']
    rows, h = len(results) * n, conf['attention_heads']
    return layers * (gate_open(rows, h, L, L) + gate_open(rows, h, L, T)), L


DECODER_TOKEN_TIE = 1e-4  # 12a: a decoder log-prob's card-CPU tie, a token
SEARCH_FLOAT_TIE = 1e-5  # a float32 search score's error, relative


def ctc_score(logp, tokens, n):
    """log P(tokens | the first n frames of logp (T, V)): the CTC forward
    sum over every alignment (blank 0), in float64."""
    import torch.nn.functional as F
    loss = F.ctc_loss(logp[:n, None].double(),
                      torch.tensor([tokens], dtype=torch.long),
                      torch.tensor([n]), torch.tensor([len(tokens)]),
                      reduction='none')
    return -float(loss[0])


def zoo_same_hypotheses(name, got, want, logp, clogp, lens):
    """Raise unless the card's hypotheses (`got`, from the card's CTC
    log-probs `logp`) equal the CPU's (`want`, `clogp`) in each mode, up
    to ties that the two sets of log-probs explain.  Random weights give
    near-flat posteriors, whose paths tie to float32's resolution, so a
    log-prob moved by 1e-5 may flip a choice; a path's score moves by at
    most bound = the sum over the utterance's frames of the largest
    |card - cpu| log-prob.  Greedy: a frame's argmax may differ only
    where the CPU's top two lie within twice that frame's largest
    difference.  Prefix beam: a tie at the beam's edge mid-search may
    send the two pruned searches to other hypotheses with other scores,
    so each best must hold under the other side's log-probs: its CTC
    forward score there (every alignment; the pruned search sums fewer)
    is at least the score its own search gave it, less the bound and
    SEARCH_FLOAT_TIE.  Rescoring:
    the best may differ only beside a prefix-beam n-best that differs,
    or where the fused scores lie within the bound plus
    DECODER_TOKEN_TIE a token.  -> {mode: utterances that differ}."""
    logp, lens = logp.cpu(), lens.cpu()
    diff = (logp - clogp).abs().amax(-1)  # (B, T)
    valid = torch.arange(diff.shape[1])[None, :] < lens[:, None]
    bound = (diff * valid).sum(-1)
    flips = {}
    for mode in MODES:
        flips[mode] = 0
        for b, (g, w) in enumerate(zip(got[mode], want[mode])):
            if g.tokens == w.tokens:
                continue
            n = int(lens[b])
            if mode == 'ctc_greedy_search':
                top = clogp[b].topk(2, dim=-1).values
                frames = (logp[b].argmax(-1) != clogp[b].argmax(-1)) \
                    & valid[b]
                ok = bool(frames.any()) and bool(
                    (top[frames, 0] - top[frames, 1] <=
                     2 * diff[b][frames]).all())
            elif mode == 'ctc_prefix_beam_search':
                ok = all(
                    ctc_score(other, r.nbest[0], n) >= r.nbest_scores[0] -
                    bound[b] - SEARCH_FLOAT_TIE * abs(r.nbest_scores[0])
                    for r, other in ((g, clogp[b]), (w, logp[b])))
            else:
                prefix = (got['ctc_prefix_beam_search'][b].nbest !=
                          want['ctc_prefix_beam_search'][b].nbest)
                ok = prefix or abs(g.score - w.score) <= bound[b] + \
                    DECODER_TOKEN_TIE * (len(g.tokens) + 1)
            if not ok:
                raise RuntimeError(
                    f'{name}: {mode} utterance {b} differs from the CPU '
                    f'beyond a tie (scores {g.score} / {w.score}, bound '
                    f'{float(bound[b]):.3g}): {g.tokens[:8]}... vs '
                    f'{w.tokens[:8]}...')
            flips[mode] += 1
    return flips


def zoo_decode_check(name, B, seconds, k1, k4, smi):
    """12a/b: AsrRunner.decode in MODES on the card against the CPU.  The
    encoder must launch K1 `k1` times and K4 `k4` times; the decode, those
    and the K4 launches the gate admits in the rescoring decoder (long
    hypotheses of random weights put its attention above the gate).
    -> (launches, audio-sec/s of the card's rescoring decode)."""
    from wenet_tpu_torch.models.runner import AsrRunner
    from wenet_tpu_torch.ops import flash_attention as fa
    configs = zoo_configs(name)
    model = zoo_model(configs)
    cpu_model = copy.deepcopy(model)
    runner = AsrRunner(model, 'cuda')
    feats, lens = zoo_features(np.random.RandomState(SEED + 30), B, seconds,
                               configs['input_dim'])
    # a right decoder's weight where the yaml has one (the reference reads
    # no right-to-left scores from a unidirectional decoder)
    kw = dict(beam_size=10, ctc_weight=0.3, reverse_weight=0.3 if configs[
        'decoder'] == 'bitransformer' else 0.0)
    fa.reset_launches()
    got = runner.decode(MODES, feats, lens, **kw)
    torch.cuda.synchronize()
    counted = {'K1': fa.LAUNCHES['relpos_attention_fwd'],
               'K4': fa.LAUNCHES['flash_attention_fwd']}
    want = AsrRunner(cpu_model, 'cpu').decode(MODES, feats, lens, **kw)
    with torch.inference_mode():
        x, n = torch.from_numpy(feats), torch.from_numpy(lens)
        fa.reset_launches()
        eo, em = runner.model.forward_encoder(x.cuda(), n.cuda())
        torch.cuda.synchronize()
        encoder = {'K1': fa.LAUNCHES['relpos_attention_fwd'],
                   'K4': fa.LAUNCHES['flash_attention_fwd']}
        logp = runner.model.ctc_logprobs(eo)
        ceo, cem = cpu_model.forward_encoder(x, n)
        clogp = cpu_model.ctc_logprobs(ceo)
    dec_k4, L = rescoring_k4(configs, got['ctc_prefix_beam_search'],
                             eo.shape[1], kw['reverse_weight'])
    if encoder != {'K1': k1, 'K4': k4} or counted != {'K1': k1,
                                                      'K4': k4 + dec_k4}:
        raise RuntimeError(
            f'{name} B={B}: launches {encoder} in the encoder, {counted} in '
            f'one decode; expected K1 {k1}, K4 {k4} in the encoder and '
            f'{dec_k4} more K4 in the rescoring decoder (hypotheses of '
            f'{L - 1} slots)')
    errs = []
    for what, a, b in (('encoder_out', eo, ceo), ('ctc log-probs', logp,
                                                   clogp)):
        if not torch.isfinite(a).all():
            raise RuntimeError(f'{name}: {what} on the card is not finite')
        errs.append((a.cpu() - b).abs().max().item())
        torch.testing.assert_close(a.cpu(), b, atol=1e-3, rtol=0,
                                   msg=f'{name}: {what}')
    if not torch.equal(em.cpu(), cem):
        raise RuntimeError(f'{name}: encoder masks differ')
    flips = zoo_same_hypotheses(name, got, want, logp, clogp,
                                cem[:, 0].sum(-1))
    # the rescoring decode's speed, after the checked run
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.decode(['attention_rescoring'], feats, lens, **kw)
    torch.cuda.synchronize()
    rate = lens.sum() / 100 / (time.perf_counter() - t0)
    chars = sum(len(r.tokens) for r in got['attention_rescoring'])
    print(f'  {name} ({ZOO[name][0].split("/")[1]}; '
          f'{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params, '
          f'{len(model.encoder.encoders)} blocks) B={B} x {seconds:.0f} s: '
          f'encoder_out {tuple(eo.shape)}, max |card - cpu| '
          f'{errs[0]:.3g} / log-probs {errs[1]:.3g} (bar 1e-3); '
          f'hypotheses equal the CPU\'s but at ties: '
          + ', '.join(f'{m} {flips[m]}/{B}' for m in MODES)
          + f' ({chars} tokens of rescoring text); launches K1 '
          f'{counted["K1"]}, K4 {counted["K4"]} '
          f'({encoder["K4"]} in the encoder, {dec_k4} in the rescoring '
          f'decoder at {L - 1} hypothesis slots); '
          f'rescoring decode {rate:.1f} audio-sec/s ({smi})', flush=True)
    del runner, model, cpu_model
    torch.cuda.empty_cache()
    return counted, float(rate), flips


def zoo_step_check(name):
    """12c: one forward + backward, card against CPU, every dropout 0."""
    from wenet_tpu_torch.utils.executor import to_device_batch
    configs = zoo_configs(name, dropout=False)
    model = zoo_model(configs)
    cpu_model = copy.deepcopy(model)
    model.cuda()
    B, seconds = ZOO_TRAIN_STEP
    b = zoo_train_batch(np.random.RandomState(SEED + 31), B, seconds,
                        configs['input_dim'], configs['output_dim'])
    outs = []
    for m, dev in ((model, 'cuda'), (cpu_model, 'cpu')):
        m.train()
        tb = to_device_batch(b, dev)
        out = m(tb['feats'], tb['feats_lengths'], tb['target'],
                tb['target_lengths'],
                generator=torch.Generator().manual_seed(SEED))
        out['loss'].backward()
        outs.append(out)
    for k in ('loss', 'loss_att', 'loss_ctc'):
        a, w = outs[0][k].item(), outs[1][k].item()
        if not abs(a - w) <= 1e-4 * abs(w) + 1e-6:
            raise RuntimeError(f'{name}: {k} card {a} cpu {w} beyond rtol '
                               '1e-4')
    # 6c's bar, 1e-3, plus 2e-4 of the tensor's largest gradient: at full
    # depth and B=4 x 8 s the largest gradients (printed below) sum float32
    # terms that cancel over 3200 frames, so 1e-3 is below float32's
    # resolution of their sums
    worst, worst_of_bar, largest = 0.0, 0.0, (0.0, '')
    cpu_params = dict(cpu_model.named_parameters())
    for pname, p in model.named_parameters():
        if p.grad is None or not torch.isfinite(p.grad).all():
            raise RuntimeError(f'{name}: {pname} has no finite gradient')
        want = cpu_params[pname].grad
        err = (p.grad.cpu() - want).abs().max().item()
        bar = 1e-3 + ZOO_GRAD_RTOL * want.abs().max().item()
        if err > bar:
            raise RuntimeError(f'{name}: {pname} grad differs from the CPU '
                               f'by {err} (bar {bar:.3g})')
        worst, worst_of_bar = max(worst, err), max(worst_of_bar, err / bar)
        largest = max(largest, (want.abs().max().item(), pname))
    print(f'  {name} train step B={B} x {seconds:.0f} s, dropout 0: loss '
          f'card {outs[0]["loss"].item():.6f} cpu {outs[1]["loss"].item():.6f}'
          f' (rtol 1e-4); {len(cpu_params)} grads, max |card - cpu| '
          f'{worst:.3g}, at most {100 * worst_of_bar:.0f}% of the bar '
          f'(1e-3 + {ZOO_GRAD_RTOL:g} x the largest |grad| of the tensor); '
          f'the largest |grad| {largest[0]:.3g} ({largest[1]})', flush=True)
    del model, cpu_model
    torch.cuda.empty_cache()


def zoo_executor_check(name, smi):
    """12d: five steps through Executor.train with the yaml's dropouts
    (and dynamic chunk); each step must launch each of the counted
    kernels once per attention layer that runs it.  -> launches."""
    from wenet_tpu_torch.ops import flash_attention as fa
    from wenet_tpu_torch.utils.executor import Executor
    from wenet_tpu_torch.utils.train_utils import (
        TrainState, init_optimizer_and_scheduler, make_cv_step,
        make_train_step)
    B, seconds, kernels = ZOO_EXECUTOR[name]
    configs = zoo_configs(name)
    model = zoo_model(configs).cuda()
    layers = sum(type(m).__name__ in ('RelPositionMultiHeadedAttention',
                                      'MultiHeadedAttention')
                 for m in model.encoder.modules())
    opt, schedule = init_optimizer_and_scheduler(configs, model)
    step_fn = make_train_step(model, opt, schedule, None,
                              configs.get('accum_grad', 1),
                              configs['grad_clip'])
    per_step = []

    def counted(state, batch, rng_seed):
        before = dict(fa.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch, rng_seed)
        torch.cuda.synchronize()
        per_step.append(({k: fa.LAUNCHES[k] - before[k] for k in before},
                         float(metrics['loss']), time.perf_counter() - t0))
        return state, metrics

    rng = np.random.RandomState(SEED + 32)
    batches = [zoo_train_batch(rng, B, seconds, configs['input_dim'],
                               configs['output_dim']) for _ in range(5)]
    run_conf = dict(configs, log_interval=1, save_interval=10 ** 6, epoch=0,
                    seed=SEED)
    fa.reset_launches()
    cv = [zoo_train_batch(rng, 4, seconds, configs['input_dim'],
                          configs['output_dim'])]
    state = Executor(device='cuda').train(
        counted, TrainState(model, opt), batches, cv, make_cv_step(model),
        None, run_conf, model_dir=tempfile.mkdtemp(prefix='chip_smoke_zoo_'))
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    for i, (n, loss, dt) in enumerate(per_step):
        got = {k: n[k] for k in kernels}
        if any(v != layers for v in got.values()) or not np.isfinite(loss):
            raise RuntimeError(f'{name} step {i + 1}: launches {got}, '
                               f'expected {layers} each; loss {loss}')
    times = [dt for _, _, dt in per_step[1:]]
    print(f'  {name} Executor.train, 5 steps of B={B} x {seconds:.0f} s '
          f'(yaml dropouts): losses '
          f'{", ".join(f"{l:.3f}" for _, l, _ in per_step)}; each step '
          f'{layers} launches of ' + ', '.join(k for k in kernels)
          + f'; {1e3 * np.mean(times):.0f} ms a step after the first '
          f'({B * seconds / np.mean(times):.0f} audio-sec/s; {smi})',
          flush=True)
    if state.step != 5:
        raise RuntimeError(f'{name}: Executor.train ran {state.step} steps')
    del model, state, opt
    torch.cuda.empty_cache()
    return launches


def zoo_entry_check(smi):
    """12e: the efficient conformer through bin/train.py (2 epochs on the
    written recipe), bin/recognize.py card against CPU, and AsrDecoder
    card against CPU partial by partial.  -> launches of the training
    and of recognize."""
    import shutil
    from wenet_tpu_torch.bin import compute_cmvn_stats, train
    from wenet_tpu_torch.ops import flash_attention as fa
    from wenet_tpu_torch.utils.checkpoint import load_model_dir
    config = os.path.join(REPO, ZOO[ZOO_ENTRY][0])
    tokenizer = flagship_tokenizer()
    d = tempfile.mkdtemp(prefix='chip_smoke_zoo_recipe_')
    units, train_list, cv_list, scp, train_wavs = write_recipe(d, tokenizer)
    cmvn = os.path.join(d, 'global_cmvn')
    compute_cmvn_stats.main(['--train_config', config, '--in_scp', scp,
                             '--out_cmvn', cmvn])
    exp = os.path.join(d, 'exp')
    argv = ['--config', config, '--train_data', train_list, '--cv_data',
            cv_list, '--data_type', 'shard', '--model_dir', exp,
            '--seed', str(SEED), '--device', 'cuda',
            '--override_config', f'tokenizer_conf.symbol_table_path {units}',
            '--override_config', f'cmvn_conf.cmvn_file {cmvn}',
            '--override_config', 'max_epoch 2',
            '--override_config', 'log_interval 1']
    fa.reset_launches()
    t0 = time.perf_counter()
    summary = train.main(argv)
    torch.cuda.synchronize()
    train_launches = dict(fa.LAUNCHES)
    steps = sum(e['steps'] for e in summary['epochs'])
    print(f'  bin/train.py {os.path.basename(config)}: 2 epochs, {steps} '
          f'steps in {time.perf_counter() - t0:.1f} s; cv losses '
          + ', '.join(f'{e["cv"]["loss"]:.4f}' for e in summary['epochs'])
          + f'; launches {train_launches} ({smi})', flush=True)
    n_relpos = ZOO[ZOO_ENTRY][2]
    for k in TRAIN_KERNELS:
        if train_launches[k] != n_relpos * steps:
            raise RuntimeError(f'bin/train.py: {k} {train_launches[k]} '
                               f'launches over {steps} steps, expected '
                               f'{n_relpos} a step')
    if not all(np.isfinite(e['cv']['loss']) for e in summary['epochs']):
        raise RuntimeError('bin/train.py: cv loss not finite')

    # bin/recognize.py on the second epoch's checkpoint, card and CPU
    paths = {'train.yaml': os.path.join(exp, 'train.yaml'),
             'final.pt': os.path.join(exp, 'epoch_1.pt'),
             'zoo.list': os.path.join(d, 'zoo.list')}
    with open(paths['zoo.list'], 'w', encoding='utf-8') as f:
        for i, w in enumerate(train_wavs[RECIPE_8K:RECIPE_8K +
                                         ZOO_RECOGNIZE_UTTS]):
            f.write(json.dumps({'key': f'z{i:02d}', 'wav': w, 'txt': ''})
                    + '\n')
    texts = {}
    for dev in ('cuda', 'cpu'):
        fa.reset_launches()
        texts[dev], rsum = recognize_main(
            paths, MODES, os.path.join(d, f'rec_{dev}'), 'zoo.list', dev)
        if dev == 'cuda':
            torch.cuda.synchronize()
            recognize_launches = fa.LAUNCHES['relpos_attention_fwd']
            if recognize_launches != n_relpos:  # one batch of 16
                raise RuntimeError(f'bin/recognize.py: {recognize_launches} '
                                   f'K1 launches, expected {n_relpos}')
            print(f'  bin/recognize.py --device cuda: {ZOO_RECOGNIZE_UTTS} '
                  f'utterances in {MODES}, {rsum["audio_seconds"]:.1f} s of '
                  f'audio in {rsum["seconds"]:.2f} s; K1 '
                  f'{recognize_launches} launches ({smi})', flush=True)
    for mode in MODES:
        same_text(texts['cuda'][mode], texts['cpu'][mode],
                  f'zoo recognize {mode}')
    rescored = texts['cuda']['attention_rescoring'].values()
    print(f'  recognize: card == CPU in {len(MODES)} modes '
          f'({sum(len(t) for t in rescored)} chars of rescoring text)',
          flush=True)

    # streaming: AsrDecoder over the trained model, card against CPU
    model_dir = os.path.join(d, 'model')
    os.makedirs(model_dir)
    shutil.copy(paths['train.yaml'], model_dir)
    shutil.copy(units, os.path.join(model_dir, 'units.txt'))
    shutil.copy(paths['final.pt'], os.path.join(model_dir, 'final.pt'))
    model, _, tok = load_model_dir(model_dir, 'cuda')
    cpu_model, _, _ = load_model_dir(model_dir, 'cpu')
    rng = np.random.RandomState(SEED + 33)
    fa.reset_launches()
    for seconds in (4.3, 6.1):
        wav = speech_like(rng, seconds)
        got = stream_utterance(streaming_decoder(model, 'cuda', tok), wav)
        want = stream_utterance(streaming_decoder(cpu_model, 'cpu', tok),
                                wav)
        if len(got[0]) != len(want[0]):
            raise RuntimeError('zoo AsrDecoder: partial counts differ')
        for i, (g, w) in enumerate(zip(got[0], want[0])):
            same_results(g, w, f'zoo AsrDecoder partial {i}')
        same_results(got[1], want[1], 'zoo AsrDecoder final')
        print(f'  AsrDecoder {seconds} s, chunk 16 (8 output frames a '
              f'chunk): {len(got[0])} partials and the final equal the '
              f'CPU\'s ({got[1][0][0][:12]!r}...); first partial '
              f'{got[2]["first_ms"]:.1f} ms, final {got[2]["final_ms"]:.1f}'
              f' ms ({smi})', flush=True)
    torch.cuda.synchronize()
    stream_launches = fa.LAUNCHES['relpos_attention_fwd']
    if stream_launches % n_relpos or not stream_launches:
        raise RuntimeError(f'zoo AsrDecoder: {stream_launches} K1 launches,'
                           f' not {n_relpos} a chunk step')
    shutil.rmtree(d)
    del model, cpu_model
    torch.cuda.empty_cache()
    return train_launches, recognize_launches + stream_launches


def zoo_check(smi):
    """Phase 12 -> ({kernel name: launches in the zoo's runs}, readings)."""
    phase('12 encoder zoo: six yamls at full width, decode, train, '
          'recognize, stream')
    t0 = time.perf_counter()
    launches = {name: 0 for name in ('relpos_attention_fwd',
                                     'flash_attention_fwd',
                                     *TRAIN_KERNELS, *FLASH_TRAIN_KERNELS)}
    rates, ties = {}, {}
    phase('12a-b decode, card vs CPU, launches')
    for name, (_, _, k1) in ZOO.items():
        counted, rates[name], ties[name] = zoo_decode_check(
            name, *ZOO_DECODE, k1, 0, smi)
        launches['relpos_attention_fwd'] += counted['K1']
        launches['flash_attention_fwd'] += counted['K4']
    counted, rates['transformer_B64'], ties['transformer_B64'] = \
        zoo_decode_check(
        'transformer', *ZOO_K4_DECODE, 0,
        zoo_configs('transformer')['encoder_conf']['num_blocks'], smi)
    launches['flash_attention_fwd'] += counted['K4']
    phase('12c one train step per yaml, card vs CPU')
    for name in ZOO:
        zoo_step_check(name)
    phase('12d five steps through Executor.train')
    for name in ZOO_EXECUTOR:
        got = zoo_executor_check(name, smi)
        for k in ZOO_EXECUTOR[name][2]:
            launches[k] += got[k]
    phase('12e the efficient conformer through bin/train.py, '
          'bin/recognize.py and AsrDecoder')
    train_launches, k1 = zoo_entry_check(smi)
    for k in TRAIN_KERNELS:
        launches[k] += train_launches[k]
    launches['relpos_attention_fwd'] += k1
    print(f'  phase 12 took {time.perf_counter() - t0:.1f} s', flush=True)
    return launches, {'audio_sec_per_s_rescoring': rates,
                      'hypotheses_at_ties': ties}


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
    flash_report = flash_kernel_check()
    flash_launches = whisper_check()
    whisper_speed(smi)
    flash_train_report = flash_train_kernel_check()
    flash_train_launches = whisper_train_check()
    whisper_train_speed(smi)
    (stream_launches, stream_readings, batched_launches,
     batched_readings) = streaming_checks(smi)
    entry_launches = train_entry_check(smi)
    recognize_launches, recognize_readings = recognize_check(smi)
    zoo_launches, zoo_readings = zoo_check(smi)
    foreign = [m for m in sys.modules
               if m == 'jax' or m.startswith('jax.') or m == 'wenet_tpu'
               or m.startswith('wenet_tpu.')]
    if foreign:
        raise RuntimeError(f'imported jax or the JAX package: {foreign[:5]}')
    kernels = [{
        'name': 'relpos_attention_fwd', 'route': 'cuda',
        'source': 'wenet_tpu_torch/csrc/relpos_attention.cu',
        'replaces': 'wenet_tpu/ops/flash_attention.py:548',
        'launches': launches + stream_launches + batched_launches +
        recognize_launches + zoo_launches['relpos_attention_fwd'], **report,
        'launches_zoo': zoo_launches['relpos_attention_fwd'],
        'zoo_decode': zoo_readings,
        'launches_decode': launches, 'launches_streaming': stream_launches,
        'launches_batched_serving': batched_launches,
        'launches_train_entry': entry_launches['relpos_attention_fwd'],
        'launches_recognize': recognize_launches,
        'streaming': stream_readings, 'batched_serving': batched_readings,
        'recognize': recognize_readings}]
    for name, (source, replaces) in TRAIN_KERNELS.items():
        kernels.append(dict(name=name, route='cuda', source=source,
                            replaces=replaces,
                            launches=train_launches[name] +
                            zoo_launches[name],
                            launches_train_entry=entry_launches[name],
                            launches_zoo=zoo_launches[name],
                            **train_report[name]))
    kernels.append(dict(name='flash_attention_fwd', route='cuda',
                        source='wenet_tpu_torch/csrc/flash_attention.cu',
                        replaces='wenet_tpu/ops/flash_attention.py:68',
                        launches=flash_launches +
                        zoo_launches['flash_attention_fwd'],
                        launches_zoo=zoo_launches['flash_attention_fwd'],
                        **flash_report))
    for name, (source, replaces) in FLASH_TRAIN_KERNELS.items():
        kernels.append(dict(name=name, route='cuda', source=source,
                            replaces=replaces,
                            launches=flash_train_launches[name] +
                            zoo_launches[name],
                            launches_zoo=zoo_launches[name],
                            **flash_train_report[name]))
    print(f'== done (at {time.perf_counter() - _T0:.0f} s)')
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
