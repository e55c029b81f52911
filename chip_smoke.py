"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --phases 20,13c # these units alone, after the build

The units that time a kernel (16a and 19c's kernels too), the
informational throughputs (5, 6d, 7c, 8c) and phases 20-22 run first,
alone on the card (ALONE; 21d's two ranks beside 21a-21c); the card-against-CPU phases then run in four child
processes side by side (LANES), their logs printed as each ends, and each
child refuses jax and the JAX package as the parent does.  A throughput a
lane's phase prints (9e, 9f, 11, 12, 14, 16b, 18b, 19a-c) is read beside
the other lanes (1.4-2.5x its seconds alone): it compares only with the
same reading of another run of this schedule.  Budget: the whole script 600 s, a new phase 60 s; a wait that
outlasts its phase's budget (PHASE_BUDGET_S) raises with the phase's name.

Phases, each of which raises on failure (non-zero exit):
  1. device   needs CUDA; prints the card's name and power limit; TF32 off
  2. build    compiles the attention kernels (K1 forward, K2 and K3
              backward, K4 masked forward, K5 and K6 its backward; nvcc,
              sm_90a, one process per source, all started together) and
              the port's C++ CTC prefix-beam searcher and lattice WFST
              decoder (g++) from the checkout's sources
  2b. fp32 error: each kernel's fp32 output at its main shape (K1 at
              (16,4,375,375,64) and at the batched chunk step
              (8,4,16,528,64); K1-train, K2, K3 at (16,4,299,299,64)
              with and without dropout 0.1, and at head dim 128,
              (16,2,299,299,128); K4-train, K5, K6 at
              (4,20,1500,1500,64) and (2,4,534,534,128); K4 and K4-train
              at (32,4,500,500,128))
              and its plain version's, on the same randn inputs, against
              the plain version in float64: max and rms; a kernel whose
              rms error is more than 3x its plain version's fails (wgmma
              does not round its fp32 sums to nearest); each kernel's time
  3. kernel   K1 (inference) against its plain PyTorch version, fp32 and
              bf16, at the encoder's shapes, ragged edges, a fully masked
              row, a peaked softmax, key tiles closed mid-row, a chunk
              step (T1 = 16, T2 = 80), the serving chunk step of 9c
              (one stream, 16 queries, 512 cache slots + 16 keys: 16 and
              256 valid slots, and a padded tail chunk), 9f's batched
              one (eight streams, each with its own p and cache fill:
              16-512 valid slots and a tail) and 20a's efficient
              conformer's after its stride ((8,8,8,264,32): every second
              slot and frame) and the encoder zoo's
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
  7c. whisper speed (informational): 16 + 16 layers (half of
              large-v3's depth, for the script's time), B=4 x 20-30 s,
              beam 5, a fixed eot bias (28 decoder steps), fp32 then
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
  8c. whisper train speed (informational): 4 + 4 layers (an eighth
              of large-v3's depth, for the script's time), B=2 x 30 s,
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
              32 written wavs of 3-12 s in a raw list, batch 16, beam 10,
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
  12. encoder zoo: six example yamls at their published widths,
              random weights from the seed (examples/{aishell,
              timit}/s0 train_transformer.yaml: conv2d abs-pos
              transformer; openasr2021 train_conformer_large_10h.yaml:
              conv2d6, 24 x 512; aishell train_ebranchformer.yaml,
              train_squeezeformer.yaml, train_u2pp_efficonformer.yaml).
              12a: at 6 encoder blocks, AsrRunner.decode of B=16 x 15 s
              in CTC greedy, CTC prefix beam and attention rescoring on
              the card against the CPU on the first half of the rows
              (encoder output and
              log-probs within 1e-3, identical hypotheses), the conv2d
              transformer also at B=64 x 15 s;
              12b: launches per decode: K1 once per rel-pos block (6 of
              E-Branchformer's and openasr's, 2 of the efficient
              conformer's, none of the transformers' or Squeezeformer's);
              K4 6 at B=64 and 0 at B=16.  12c: at full depth, one train
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
  13. the recipe's stages 6 and 7 on the flagship at full width (random
              weights from the seed; the CTC head scaled and the blank
              raised so that posteriors are peaked and mostly blank, as a
              trained head's are).  13a: a lexicon of 5000 words (every
              char, and words of 2-4 chars) and a 3-gram ARPA from counts
              over 750 seeded sentences (for the script's time), every
              word a unigram, through the port's
              pure-Python build_tlg (states, arcs, build seconds).  13b:
              decoder_main --fst_path TLG.txt --dict_path words.txt over
              eight wavs of 4-15 s on the card and on the CPU: words equal
              up to what the two devices' log-prob rows explain (best
              likelihoods within the summed row differences), 12 K1
              launches a chunk step, and on the card's rows (each frame's
              top-10 and blank) the C++ lattice decoder's one-best equal
              to the plain Python searcher's, as many utterances as 60 s
              of the Python searcher allow; RTF and the search's share.
              13c: bin/export_model (chunk 16, beam 10, max_hyp_len 64)
              of the flagship at 4 of its 12 blocks (EXPORT_DEPTH, for the
              script's time) on the card, loaded in the same process: 4
              K1 operator nodes in the chunk program and 4 launches an
              exported step; three exported steps against the eager ones (bar
              1e-5); encoder_full at (2, 1010) and (4, 410) frames and
              decoder_rescore against the eager model (2e-4);
              ExportedAsrDecoder on 9c's utterances equal to AsrDecoder
              partial by partial; the exported and the eager chunk step's
              card time and enqueue, the eager one also with K1 called
              directly (no op), and K1's wrapper host time both ways;
              then plain attention through export: the aishell
              transformer yaml at full width and 4 of its 12 blocks
              (random weights) through
              bin/export_model with max_hyp_len 128: the exported full
              encoder bit-equal to eager at B=16 x 15 s (below K4's gate)
              and within 2e-4 of eager at B=64 x 15 s (eager runs K4 at
              (64,4,374,374,64), the program the plain path), the
              decoder at 10 x 128 bit-equal, no K4 launch in the
              programs; both encoders' card times at B=16 and B=64
  14. the transducer at the full width of examples/aishell/rnnt/conf/
              train_u2pp_transducer.yaml (12 rel-pos blocks, 6 in 14a and
              14d, RNNT_DEPTH, for the script's time; LSTM
              predictor 2 x 256, join_dim 512, 4233 chars; random
              weights from the seed), fp32 with TF32 off.  14a:
              AsrRunner.decode at B=16 x 10-15 s of speech-like fbank in
              the CTC modes, rnnt_greedy_search, rnnt_beam_search (beam
              10) and attention rescoring on the card against the CPU
              (the encoder output within 2e-4; the rnnt searches held to
              the CPU's on the card's encoder output),
              the joint's output scaled and its blank raised
              (`shape_joint_blank`) and rnnt_n_steps 1 (random weights
              emit on every step otherwise): hypotheses equal up to the
              ties the two devices' joint and CTC log-probs explain
              (`rnnt_compare`), beam scores within the summed per-frame
              log-prob differences + 1e-5 of the score + 2e-4, a K1
              launch a block in a decode; emitted lengths, audio-sec/s per mode, each
              search's launches a frame.  14b: the RNN-T loss at B=4, T
              300-213, U 40-0, V 4233: loss within rtol 1e-5 and the
              gradient with respect to the logits within 1e-4 of the
              largest, card against CPU against float64; forward and
              backward card time (CUDA events), launches.  14c: one train
              step at B=4 x 12 s, dynamic chunk, dropouts 0, card against
              CPU (loss rtol 1e-4, grads 1e-3 + 2e-4 of the largest, 12c's
              bar), a launch of K1-train, K2 and K3 a block; the loss's share
              of the step's kernel time (profiled); a bf16 autocast step
              within 1e-2 of the fp32 loss.  14d: compute_cmvn_stats,
              bin/train.py (2 epochs on 10's written recipe, a profiler
              window; a launch of each training kernel a block and step),
              average_model --num 2 --val_best, bin/recognize.py in
              rnnt_greedy_search, rnnt_beam_search and
              attention_rescoring (audio-sec/s a mode over 16 wavs; card
              == CPU on 8 by 14a's tie rule, each text the runner's)
  15. whisper large-v3 through the recipe's entry points at full width,
              4 + 4 layers (the finetune yaml's num_blocks through
              --override_config; its log-mel front end and blank id as
              models/whisper/convert.py writes them), fp32 with TF32 off.
              15a: a rank file of 50257 ranks (the bytes, 600 merges
              learned from seeded zh/en lines, unreachable fillers)
              through the port's WhisperTokenizer: 51866 tokens,
              large-v3's special tokens, 200 seeded lines round trip;
              the encode rate.  15b: 24 wavs of 12-28 s with zh/en
              transcripts in tar shards, a random checkpoint (8b's
              weights), the entry point's first step card == CPU,
              bin/train.py for two epochs (accum_grad 1, a profiler
              window; K4-train, K5, K6 4 launches a step, counted),
              average_model --num 2 --val_best (its LoRA tensors).
              15c: the average's eot bias calibrated (7b's rule) on the
              16 decode wavs, bin/recognize.py --modes attention, beam
              5, B=4, without and with --timestamps on the card (16
              wavs; K4 4 launches a batch, counted) and the CPU (the
              first batch): text and segments identical; audio-sec/s and
              the card's busy share (train and decode)
  16. the paraformer at the full width of examples/aishell/paraformer/
              conf/train_paraformer.yaml (25 + 8 of its 50 + 16 blocks of
              512, PARAFORMER_DEPTH, for the script's time; 4 heads: d =
              128; LFR 7/6; CIF; random weights from the seed), fp32
              with TF32 off.  16a: K4 at the decode's (32,4,500,500,128)
              pad and K4-train, K5, K6 through the FlashAttention Function
              at a long-form step's (2,4,534,534,128) against their plain
              versions, fp32 and bf16: each one's share of its bar, kernel,
              plain, SDPA and bound times.  16b: AsrRunner.decode of B=32 x
              20-30 s in paraformer_greedy_search and paraformer_beam_search
              on the card (33 K4 launches: 25 encoder self-attentions, 8
              decoder cross-attentions over the 500-frame cap) against the
              CPU on 4 rows (the encoder within 1e-3; token counts equal
              unless the CPU's unfloored sum lies within 1e-4 of an
              integer; an argmax may differ where the CPU's top two lie
              within twice the position's log-prob difference; peak times
              equal up to a trace within 1e-4 of the threshold); decode
              audio-sec/s, busy share, the CIF predictor's launches and
              time.  16c: the recipe's stages 1, 4 and 5 (24 + 6 wavs of
              3-12 s, zh/en transcripts, a 4233-symbol dict and a
              seg_dict; compute_cmvn_stats's 80 bins tiled over LFR's 7
              frames as FunASR's am.mvn, converted), bin/train.py two
              epochs with the yaml's pipeline (dynamic batches of 8000
              frames, SpecAugment, the sampler) and the CIF threshold at
              0.9999 (at 1.0 the training CIF's last fire sits on the
              float32 rounding of an integer total), the first step card
              == CPU (loss terms rtol 1e-4, grads 1e-3), average_model; a
              long-form step of B=2 x 32 s: K4-train, K5, K6 25 launches
              each, and its loss and gradients with them equal to the
              same step with the flash gate closed (plain attention on
              the card; loss terms rtol 1e-4, grads 12c's bar).  16d: bin/recognize.py in both paraformer modes over
              16 wavs of 20-32 s, B=8, on the card (33 K4 launches a
              batch) and the first batch on the CPU: texts equal, or a
              row that differs explained by 16b's rule.  16e:
              SenseVoice-small (6 + 2 of its 50 + 20 blocks, CTC greedy, B=32
              x 20-30 s, K4 8 a decode) and FireRed-AED-L (4 + 2 of its 16
              + 16 blocks of 1280, its rel-pos attention plain as the JAX
              package's, the attention beam search, beam 3, B=4 x 2-3 s)
              on the card against the CPU on 4 rows
  17. SSL and k2.  17a: examples/librispeech/ssl/conf/train_bestrq.yaml as
              written (12 blocks of 256, 4 heads, 8192 codes of 16; random
              weights from the seed): one train step at B=8 x 6-12 s
              (padded to 64 frames, dropout 0) on the card against the CPU
              on one set of host draws (loss rtol 1e-4, grads 12c's bar;
              target codes equal outside a 1e-5 band of the best two
              distances, the band's frames counted), K1-train, K2 and K3
              12 launches a step; twenty Adam steps on the batch lower the
              loss; bin/train.py with `dataset: ssl` over two epochs of 24
              wav-only wavs of 3-12 s (the yaml's pipeline; audio-sec/s,
              busy share, 12 launches a step, the quantizer's buffers in
              both checkpoints).  17b: the flagship yaml as `model:
              k2_model` at 6 of its 12 blocks (K2_DEPTH, for the script's
              time) over a den.txt of 300 seeded transcripts
              (build_den_graph): one step card vs CPU at dropout 0, B=4 x
              12 s (losses rtol 1e-4, grads 12c's bar; 6 launches of each
              training kernel), the den score of its log-probs card vs CPU
              vs float64 (rtol 1e-5), the den's launches, time and share
              of the step (informational).  17c: 17b's model with the CTC
              head shaped (13's rule) through bin/recognize.py --modes
              hlg_onebest hlg_rescore attention_rescoring over 8 wavs of
              5-15 s and an HLG.txt from build_hlg (up to 20 chars the head
              ranks most as words, 20 two-char words, a bigram): card ==
              CPU up to ties the log-prob rows explain, K1 6 an encoder
              pass
  18. serving and training at scale: 18a eight WFST streams over one
              BatchedChunkRunner, 18b the int8 weight-only runner, 18c
              data-parallel decode over two replicas, 18d bin/train.py
              under torch.distributed.run (two gloo ranks with data=2 and
              zero2, one NCCL rank) against one process
  19. the rest of the encoder and attention zoo, fp32 with TF32 off,
              random weights from the seed.  19a: the flagship yaml at full
              width with MoE in every FFN (8 experts, top 2), 2 kv heads
              of 4, RMSNorm and no FFN biases in encoder and decoder:
              decode B=16 x 15 s card == CPU on 2 rows (12 K1), an
              AsrDecoder stream card == CPU partial by partial, four
              streams over BatchedChunkRunner each equal to itself alone
              within 2e-4, a train step at B=2 x 8 s card == CPU with K1's
              hash dropout (12c's bars; K1-train, K2, K3 12 each), B=16 x
              12 s timed on the card.  19b: train_transformer.yaml with
              RoPE, one kv head and gated FFNs: decode B=64 x 15 s (12 K4
              in the encoder), a stream, a step at B=2 x 24 s (T' = 599:
              K4-train, K5, K6 12 each; a gradient past 12c's bar is held
              to float64 within the bar plus the CPU's own error, see
              `ctc_grad_precision`), B=8 x 24 s timed.  19c: the same
              yaml with Shaw's attention and no positions: decode (K4 with
              the full bias), the step (K5's full dbias; rel_k_embed's
              gradient printed), K4 at (64,4,374,374,64) and K4-train / K5
              / K6 at (2,4,599,599,64) with the full bias against their
              plain versions, SDPA with the bias as a float mask.  19d: the
              flagship as ctl_model (dual_conformer, static chunk 16, 10
              negatives): a step card == CPU (24 launches of K1-train, K2,
              K3).  19e: the linear, conv2d2 and stack_n_frames front ends
              at 2 + 1 + 1 blocks: decode card == CPU (2 K1).  19c's
              kernels in fp32 and bf16
  20. the rest of the zoo served batched, and the options the port
              refused until now, fp32 with TF32 off, random weights from
              the seed.  20a: six staggered AsrDecoder streams over one
              BatchedChunkRunner for the E-Branchformer, Squeezeformer
              and efficient-conformer yamls and a Branchformer at the
              E-Branchformer yaml's widths, each partial and final equal
              to the stream alone within 2e-4, each stream's first 1.0 s
              equal to the CPU's, K1 once per rel-pos block a batched
              step.  20b, at 6 encoder blocks: the conformer without
              its macaron FFN (relu), without its conv module, with
              bias-free convs 4x wide inside; the decoder post-norm
              without cross attention, and without an output layer (a
              256-token vocabulary); Branchformer with static chunks,
              RMSNorm and no q/k/v or MLP biases; E-Branchformer with
              gated bias-free FFNs and no final norm; Squeezeformer
              pre-norm with static chunks; the efficient conformer
              post-norm with static chunks, and without positions or conv
              modules in its plain layers: each at its base's widths, a
              decode card == CPU (K1 once per rel-pos block in the
              encoder) and a train step card == CPU (K1-train, K2, K3
              once per rel-pos block; 12c's bars)
  21. the rest of queue 1, fp32 with TF32 off, random weights from the
              seed.  21a: the flagship yaml (12 blocks, its dropouts, K1's
              hash dropout) and train_conformer.yaml's BatchNorm at 6
              blocks, one train step each at B=16 x 12 s with
              gradient_checkpointing false, true and 'selective': loss
              and every gradient equal to false's (12c's bar the limit;
              the gap printed), BatchNorm buffers and the host
              generator's state equal; K1-train 24 launches a step with
              true (the recompute), 12 otherwise, K2 and K3 12; peak
              memory and step ms printed.  21b: bin/train.py on the
              flagship with on_device_frontend (10's written wavs, one
              shard; waveforms batched, fbank and SpecAugment / SpecSub
              in the step), NoamHoldAnnealing by ratios and the encoder
              recomputed: the first step card == CPU at dither 0 (6c's
              bars) and the masks equal, each logged lr
              build_schedule's, K1-train 24 and K2, K3 12 launches a
              step, the cv on host fbank.  21c: LoRA-GA on whisper
              large-v3 at 4 + 4 layers: estimate_gradient of one 30 s row
              card == CPU (12c's bar), over two batches of B=2 x 30 s on
              the card (K4-train, K5, K6 once per encoder layer a batch),
              reinit_lora('gradient') on the card and, from the same
              gradient, on the CPU: A's rows and B's columns the CPU's
              up to each singular vector's sign (within 1e-3 + 1e-5
              sigma_1 / its gap to the nearest singular value, relative;
              a subspace where two lie within 1e-3) and the compensated
              weights with the signs lined up, the loss unchanged (rtol
              1e-4), the SVDs' seconds.  21d: bin/train.py under torch.distributed.run, two
              gloo ranks on the card with --mesh data=1,model=2 over 19a's
              MoE-GQA conformer (each rank 4 of the 8 experts), started
              first and run beside 21a-21c: first-step losses and
              gradients equal one process's (12c's bars), final.pt one
              process's keys and shapes.  ZeRO-2 with the model axis needs
              data >= 2 and model >= 2: it is held on the CPU only
              (tests/test_torch_expert_parallel.py)
  22. head dim 128 in rel-pos training: K1-train (lse, dropout), K2 and
              K3 through the RelPosAttention Function at the flagship's
              step with two heads, (16,2,299,299,128) with a chunk mask
              and dropout 0.1 and at the pad mask without, fp32 and bf16,
              against their plain versions (TRAIN_TOL; each output's share
              of it), kernel and plain times, bounds, TFLOP/s, SDPA at the
              pad mask; then the flagship yaml with
              encoder_conf.attention_heads 2 (d_k = 128, 12 blocks, every
              dropout 0): one step at B=4 x 12 s through K1-train, K2
              and K3 (a launch of each a block) against the same step
              with their plain versions on the card (loss terms rtol
              1e-4, every gradient 12c's bar) and against the CPU (the
              same bars, past 12c's the float64 hold of 17b, past that
              only where the card's plain step misses as far: the
              subsampling conv's weight, ROADMAP.md queue 3)
The line before the last is the kernel report as JSON, the one before it
every phase's seconds; the last line is {"ok": true, "device": {...}}.
Imports nothing of jax or of the JAX package (wenet_tpu), and checks so
at the end.
"""

import contextlib
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
    # 20a's efficient conformer batched: its rel-pos layers after the
    # stride read every second slot of the 512-slot cache and of the
    # chunk (8 heads of d = 32)
    (8, 8, 8, 264, 32, 'zoo_batch8'),
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
                      (128, 16), (448, 16), (512, 16)],
           'zoo_batch8': [(8, 8), (128, 8), (256, 8), (184, 4), (32, 8),
                          (64, 8), (224, 8), (256, 8)]}
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
# seeded weights and features at 16 + 16 layers the beams end after 28
# decoder steps (the value `calibrate_eot_bias` found for them, with
# high=116; 17.129 gave 116 steps at 32 + 32 layers)
WHISPER_SPEED_EOT_BIAS = 14.792291
WHISPER_SPEED_LAYERS = 16  # 7c's depth (large-v3 has 32), for the time


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


# a lane's child counts from its parent's start (`start_lanes`)
_T0 = time.perf_counter() - float(os.environ.get('CHIP_SMOKE_AT', '0'))


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
    from wenet_tpu_torch.runtime import native_wfst
    t0 = time.perf_counter()
    native_wfst.build()
    print(f'C++ lattice WFST decoder built in '
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
    rng = np.random.RandomState(SEED + 3)
    errs = {name: 0.0 for name in TRAIN_KERNELS}
    main = {}  # dtype -> (times, bounds, TFLOP/s) at the main shape
    pad = {}  # dtype -> (times, SDPA forward / backward) at the pad shape
    zoo_main, zoo_pad = {}, {}  # the same at the zoo's d = 32 train shape
    for i, (B, h, T1, T2, d, mask_kind, rate) in enumerate(TRAIN_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            _, err, t, bounds, tflops, sdpa = relpos_train_case(
                rng, (B, h, T1, T2, d), mask_kind, rate, dtype)
            if dtype == torch.float32:
                for name in TRAIN_KERNELS:
                    errs[name] = max(errs[name], err[name])
            is_zoo = (B, h, T1, T2, d) == ZOO_TRAIN_SHAPE
            if i == 0:  # the main path's shape
                main[dtype] = t, bounds, tflops
            elif is_zoo and rate > 0.0:  # the zoo's, at its dropout
                zoo_main[dtype] = t, bounds, tflops
            if sdpa is not None:
                (zoo_pad if is_zoo else pad)[dtype] = t, sdpa
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
            times, bounds, tflops = main[dtype]
            pad_times, (sdpa_fwd, sdpa_bwd) = pad[dtype]
            entry.update({'ms' + key: times[name][0],
                          'bound_ms' + key: bounds[name][0],
                          'tflops' + key: tflops[name],
                          'ms_pad' + key: pad_times[name][0]})
            if dtype == torch.float32:
                entry.update(plain_ms=times[name][1], bound_by=bounds[name][1],
                             bound_ms_ffma=bounds[name][2])
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
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(state, batch, (SEED, 0))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # from the raw events, without user annotations (Optimizer.step...
        # repeat their kernels' time)
        rows = device_rows(prof)
        total = sum(ms for _, ms in rows.values())
        print(f'    kernel time in one profiled step: {total:.2f} ms; '
              f'{100 * total / (wall * 1e3):.0f}% of its {wall * 1e3:.1f} ms '
              f'wall, {100 * total / (dt * 1e3):.0f}% of an unprofiled step '
              f'(device busy; {smi})')
        for label, key in (('K1', 'relpos_fwd_'),
                           ('K2', 'relpos_bwd_dq_'),
                           ('K3', 'relpos_bwd_dkpv_')):
            ms = sum(ms for name, (_, ms) in rows.items() if key in name)
            print(f'    {label} {key}: {ms:.3f} ms, '
                  f'{100 * ms / max(total, 1e-9):.1f}% of kernel time')
        for name, (count, ms) in sorted(rows.items(),
                                        key=lambda r: -r[1][1])[:15]:
            print(f'    {ms:8.3f} ms {100 * ms / max(total, 1e-9):5.1f}% '
                  f'x{count:<4d} {name[:80]}')


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


def k4_case(rng, B, h, T1, T2, d, mask_kind, use_bias, dtype):
    """K4 at one shape and dtype against its plain version (FLASH_TOL),
    timed with its plain version, SDPA and the bound (fp32: 3xTF32, FFMA
    printed beside it); prints the line -> readings."""
    from wenet_tpu_torch.ops import flash_attention as fa
    q, k, v, mask, bias = flash_inputs(rng, B, h, T1, T2, d, mask_kind,
                                       use_bias, dtype)
    scale = 1.0 / d ** 0.5
    got = fa.flash_attention(q, k, v, mask, bias, scale)
    torch.cuda.synchronize()
    want, _ = fa.flash_fwd_reference(q.float(), k.float(), v.float(), mask,
                                     bias, scale)
    err = (got.float() - want).abs().max().item()
    tol = FLASH_TOL[dtype]
    of_bar = share_of_bar(got, want, tol)
    torch.testing.assert_close(got.float(), want, **tol)
    if not torch.isfinite(got).all():
        raise RuntimeError('K4 output is not finite')
    if mask_kind == 'masked_row' and got[0, :, 5].any():
        raise RuntimeError('K4: fully masked row is not zero')
    ms = cuda_time_ms(lambda: fa.flash_attention(q, k, v, mask, bias, scale))
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
    return dict(max_abs_err=err, share_of_bar=of_bar, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by, tflops=flops / ms / 1e9)


def flash_kernel_check():
    phase('7a K4 masked flash attention vs plain, SDPA and the bound')
    from wenet_tpu_torch.models.transformer import attention as A
    from wenet_tpu_torch.ops import flash_attention as fa
    rng = np.random.RandomState(SEED + 6)
    report, max_err, zoo = None, 0.0, {}
    for i, (B, h, T1, T2, d, mask_kind, use_bias) in enumerate(FLASH_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            r = k4_case(rng, B, h, T1, T2, d, mask_kind, use_bias, dtype)
            if dtype == torch.float32:
                max_err = max(max_err, r['max_abs_err'])
            if i == 0 and dtype == torch.float32:  # whisper's encoder
                report = {k: r[k] for k in ('ms', 'plain_ms', 'bound_ms',
                                            'bound_by', 'library_ms',
                                            'tflops')}
            elif i == 0:
                report.update(ms_bf16=r['ms'], bound_ms_bf16=r['bound_ms'],
                              library_ms_bf16=r['library_ms'],
                              tflops_bf16=r['tflops'])
            if (B, h, T1, T2, d) == ZOO_FLASH_SHAPE:
                key = '' if dtype == torch.float32 else '_bf16'
                zoo.update({k + key: r[k] for k in (
                    'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms',
                    'max_abs_err', 'share_of_bar', 'tflops')})

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
    phase('7c whisper large-v3 decode speed (informational, 16 + 16 '
          'layers)')
    from torch.profiler import ProfilerActivity, profile
    from wenet_tpu_torch.models.runner import AsrRunner
    from wenet_tpu_torch.utils.init_model import init_model
    n = WHISPER_SPEED_LAYERS
    configs = whisper_configs(n)
    t0 = time.perf_counter()
    gen = torch.Generator('cuda').manual_seed(SEED)
    model = init_model(configs, gen, device='cuda')
    shape_decoder_weights(model, gen)
    set_eot_bias(model, WHISPER_SPEED_EOT_BIAS)
    print(f'  {n} + {n} layers built on the card in '
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
WHISPER_TRAIN_SPEED_LAYERS = 4  # 8c's depth (large-v3 has 32)


def flash_train_case(rng, B, h, T1, T2, d, mask_kind, bias_shape, dtype):
    """K4-train, K5 and K6 at one shape and dtype through the
    `FlashAttention` Function against the plain versions chained as the
    Function chains them; each kernel's and its plain version's time,
    the bounds and SDPA's forward / backward; prints the lines ->
    (max_abs_err by kernel, share of the bar by kernel, (kernel ms, plain
    ms) by kernel, (bound ms, bound_by) by kernel, SDPA (forward ms,
    backward ms) or None, TFLOP/s of K4-train / K5 / K6, attended
    pairs)."""
    from wenet_tpu_torch.ops import flash_attention as fa
    errs, shares = {}, {}
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
        errs[name], shares[name] = err, of_bar
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
    tflops = [f * d * n_pairs / t[n][0] / 1e9 for f, n in
              zip((4, 6, 8), FLASH_TRAIN_KERNELS)]
    return errs, shares, t, bounds, sdpa, tflops, n_pairs


def flash_train_kernel_check():
    phase('8a K4-train, K5, K6 (masked flash attention backward) vs plain')
    rng = np.random.RandomState(SEED + 9)
    errs = {name: 0.0 for name in FLASH_TRAIN_KERNELS}
    report = None
    for i, (B, h, T1, T2, d, mask_kind, bias_shape) in enumerate(
            FLASH_TRAIN_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            errs_i, _, t, bounds, sdpa, tflops, n_pairs = flash_train_case(
                rng, B, h, T1, T2, d, mask_kind, bias_shape, dtype)
            if dtype == torch.float32:
                for name, err in errs_i.items():
                    errs[name] = max(errs[name], err)
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
    configs = finetune_configs(WHISPER_TRAIN_SPEED_LAYERS)
    t0 = time.perf_counter()
    model = whisper_train_model(
        configs, torch.Generator('cuda').manual_seed(SEED), 'cuda')
    print(f'  {WHISPER_TRAIN_SPEED_LAYERS} + {WHISPER_TRAIN_SPEED_LAYERS} '
          f'layers built on the card in '
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
# tests/test_torch_runtime.py).  The prefix beam and attention rescoring
# sum their scores in float64, so the gap is the rows' own difference
# (about 1e-5), not float32's steps of 1.22e-4 near |score| = 1500
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
                with urllib.request.urlopen(
                        req, timeout=budget_left()) as resp:
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
            c.join(timeout=budget_left())
        wall = time.perf_counter() - t0
        if any(c.is_alive() for c in clients):
            over_budget('the HTTP clients')
    finally:
        server.shutdown()
        server.server_close()
        serve.join(timeout=min(30.0, budget_left()))
    if errors or sorted(answers) != list(range(len(bodies))):
        raise RuntimeError(f'HTTP requests failed: {errors}, answers for '
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
    # one table for both lists: building it takes the host seconds
    table = prof.key_averages()
    rows = [e for e in table if e.device_type == DeviceType.CUDA]
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
    host = [e for e in table if e.device_type == DeviceType.CPU
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


def run_streams(make_decoder, utts, stagger_s, per_stream=None, *args):
    """Decode `utts` concurrently, stream i on a thread of its own that
    starts i * stagger_s after the first, each through a decoder from
    `make_decoder(*args)` (`make_decoder(per_stream[i], *args)` with
    `per_stream`) -> ([stream_utterance's result], wall seconds)."""
    import threading
    out, errors = [None] * len(utts), []

    def run(i):
        time.sleep(i * stagger_s)
        try:
            dec = (make_decoder(*args) if per_stream is None else
                   make_decoder(per_stream[i], *args))
            out[i] = stream_utterance(dec, utts[i])
        except Exception as e:  # reported and raised below
            errors.append(f'stream {i}: {e!r}')
    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(utts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=budget_left())
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        over_budget(f'{sum(t.is_alive() for t in threads)} streams')
    if errors:
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
        deadline = time.monotonic() + budget_left()
        while not made and serve.is_alive() and time.monotonic() < deadline:
            time.sleep(0.05)
        if not made:
            raise RuntimeError('http_server_main did not start')
        with open(os.path.join(d, '0.wav'), 'rb') as f:
            req = urllib.request.Request(f'http://127.0.0.1:{port}/',
                                         data=f.read(), method='POST')
        with urllib.request.urlopen(req, timeout=budget_left()) as resp:
            ans = json.loads(resp.read())
    finally:
        http_server_main.make_server = make
        if made:
            made[0].shutdown()
        serve.join(timeout=min(60.0, budget_left()))
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
    cmvn and step seeds; the on-device front end where the yaml has it)
    on the card against the CPU, held to 6c's bars -> (the run's configs,
    the batch, the tokenizer).  The decoder's and the feed-forward
    dropouts (nn.Dropout) draw from the device's RNG, whose streams
    differ between the card and the CPU, so they are set to 0 here; the
    rel-pos attention dropout (K1-train's hash) and the dynamic chunk (a
    host draw) stay."""
    from wenet_tpu_torch.bin import train
    from wenet_tpu_torch.models.transformer.attention import (
        RelPositionMultiHeadedAttention)
    from wenet_tpu_torch.utils.executor import to_device_batch
    from wenet_tpu_torch.utils.train_utils import (
        TrainState, frontend_conf_of, init_optimizer_and_scheduler,
        make_train_step)
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
                               configs['accum_grad'], configs['grad_clip'],
                               frontend_conf=frontend_conf_of(
                                   configs['dataset_conf']))
    outs = []
    for step, model, dev, state in (
            (run.train_step, run.model, 'cuda', run.state),
            (cpu_step, cpu_model, 'cpu', TrainState(cpu_model, opt))):
        _, m = step(state, to_device_batch(batch, dev), (args.seed, 0))
        outs.append(({k: float(v) for k, v in m.items()},
                     {n: p.grad.detach().cpu()
                      for n, p in model.named_parameters()
                      if p.grad is not None}))
    (card, card_grads), (cpu, cpu_grads) = outs
    if card_grads.keys() != cpu_grads.keys():
        raise RuntimeError('entry first step: the card and the CPU gave '
                           'gradients to other parameters')
    B, T = batch['feats'].shape[:2]
    # a loss the model has not (whisper's CTC at ctc_weight 0) is absent
    for k in [k for k in ('loss', 'loss_att', 'loss_ctc', 'loss_decoder',
                          'loss_quantity', 'loss_quantity_tp') if k in cpu]:
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
    tokenizer = run.tokenizer
    del run, cpu_model
    torch.cuda.empty_cache()
    return configs, batch, tokenizer


def logged_train(train, argv, on_step):
    """bin/train.main(argv, on_step=on_step) -> (its summary, the train
    losses it logged, step by step)."""
    import logging
    import re
    losses = []

    class Losses(logging.Handler):
        def emit(self, record):
            m = re.search(r'TRAIN \|.* \| loss (\S+) ', record.getMessage())
            if m:
                losses.append(float(m.group(1)))

    handler = Losses()
    logging.getLogger().addHandler(handler)
    logging.getLogger().setLevel(logging.INFO)
    try:
        return train.main(argv, on_step=on_step), losses
    finally:
        logging.getLogger().removeHandler(handler)


def trace_readings(path, keys=('relpos_fwd_', 'relpos_bwd_dq_',
                               'relpos_bwd_dkpv_')):
    """(kernel launches by the kernel names' parts `keys` (K1, K2, K3 by
    default), kernel time / the traced span) of a torch.profiler Chrome
    trace."""
    with open(path) as f:
        events = json.load(f)['traceEvents']
    timed = [e for e in events if e.get('ph') == 'X' and 'dur' in e]
    kernels = [e for e in timed if e.get('cat') == 'kernel']
    span = (max(e['ts'] + e['dur'] for e in timed) -
            min(e['ts'] for e in timed))
    counts = {key: sum(key in e['name'] for e in kernels) for key in keys}
    return counts, sum(e['dur'] for e in kernels) / span


def train_entry_check(smi):
    phase('10 train entry: compute_cmvn_stats, train, average_model, '
          'decoder_main')
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

    records = []
    fa.reset_launches()
    t0 = time.perf_counter()
    summary, losses = logged_train(train, argv, records.append)
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
RECOGNIZE_UTTS = 32  # two batches: each hold needs one, the loop over them two
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
ZOO_DECODE_BLOCKS = 6  # 12a-b's encoder blocks (of the yamls' 12-24)
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


def decode_with_encoder(runner, modes, feats, lens, **kw):
    """runner.decode(modes, feats, lens, **kw) -> (its results, the
    encoder output and mask it decoded from): one encoder pass serves the
    decode and the hold on the encoder."""
    model, seen = runner.model, []
    forward_encoder = model.forward_encoder

    def capture(*a, **k):
        seen.append(forward_encoder(*a, **k))
        return seen[-1]
    model.forward_encoder = capture
    try:
        got = runner.decode(modes, feats, lens, **kw)
    finally:
        del model.forward_encoder
    (eo, em), = seen
    return got, eo, em


def at_blocks(configs, n):
    """The encoder at `n` blocks, in place; Squeezeformer's reduction and
    recovery moved inside them (the efficient conformer's stride at block
    3 and groups 0-3 stay)."""
    configs['encoder_conf']['num_blocks'] = n
    if configs['encoder'] == 'squeezeformer':
        configs['encoder_conf'].update(reduce_idx=n // 3, recover_idx=n - 1)
    return configs


def zoo_decode_check(name, B, seconds, k4_blocks, smi):
    """12a/b: `decode_against_cpu` of the zoo yaml `name` at
    ZOO_DECODE_BLOCKS encoder blocks on the first half of the rows; K1
    once per rel-pos block, K4 once per block when `k4_blocks`."""
    configs = at_blocks(zoo_configs(name), ZOO_DECODE_BLOCKS)
    model = zoo_model(configs)
    k4 = ZOO_DECODE_BLOCKS if k4_blocks else 0
    return decode_against_cpu(f'{name} ({ZOO[name][0].split("/")[1]})',
                              configs, model, B, seconds,
                              rel_pos_blocks(model), k4, smi, B // 2)


def decode_against_cpu(label, configs, model, B, seconds, k1, k4, smi,
                       cpu_rows, seed=SEED + 30):
    """AsrRunner.decode in MODES of B rows of `seconds` on the card
    against the CPU on the first `cpu_rows` rows (the batch's first row
    is its longest, so their padded length is the card's).  The encoder
    must launch K1 `k1` times and K4 `k4` times; the decode, those and
    the K4 launches the gate admits in the rescoring decoder (long
    hypotheses of random weights put its attention above the gate).
    `model` is on the CPU; it is copied to the card and dropped.
    -> (launches, audio-sec/s of the card's rescoring decode, the
    hypotheses that differ at ties)."""
    from wenet_tpu_torch.models.runner import AsrRunner
    from wenet_tpu_torch.ops import flash_attention as fa
    cpu_model = copy.deepcopy(model)
    runner = AsrRunner(model, 'cuda')
    feats, lens = zoo_features(np.random.RandomState(seed), B, seconds,
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
    h = cpu_rows
    want, ceo, cem = decode_with_encoder(AsrRunner(cpu_model, 'cpu'), MODES,
                                         feats[:h], lens[:h], **kw)
    with torch.inference_mode():
        x, n = torch.from_numpy(feats), torch.from_numpy(lens)
        fa.reset_launches()
        eo, em = runner.model.forward_encoder(x.cuda(), n.cuda())
        torch.cuda.synchronize()
        encoder = {'K1': fa.LAUNCHES['relpos_attention_fwd'],
                   'K4': fa.LAUNCHES['flash_attention_fwd']}
        logp = runner.model.ctc_logprobs(eo)
        clogp = cpu_model.ctc_logprobs(ceo)
    dec_k4, L = rescoring_k4(configs, got['ctc_prefix_beam_search'],
                             eo.shape[1], kw['reverse_weight'])
    if encoder != {'K1': k1, 'K4': k4} or counted != {'K1': k1,
                                                      'K4': k4 + dec_k4}:
        raise RuntimeError(
            f'{label} B={B}: launches {encoder} in the encoder, {counted} in '
            f'one decode; expected K1 {k1}, K4 {k4} in the encoder and '
            f'{dec_k4} more K4 in the rescoring decoder (hypotheses of '
            f'{L - 1} slots)')
    errs = []
    for what, a, b in (('encoder_out', eo, ceo), ('ctc log-probs', logp,
                                                   clogp)):
        if not torch.isfinite(a).all():
            raise RuntimeError(f'{label}: {what} on the card is not finite')
        errs.append((a[:h].cpu() - b).abs().max().item())
        torch.testing.assert_close(a[:h].cpu(), b, atol=1e-3, rtol=0,
                                   msg=f'{label}: {what}')
    if not torch.equal(em[:h].cpu(), cem):
        raise RuntimeError(f'{label}: encoder masks differ')
    flips = zoo_same_hypotheses(label, {m: r[:h] for m, r in got.items()},
                                want, logp[:h], clogp, cem[:, 0].sum(-1))
    # the rescoring decode's speed, after the checked run
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.decode(['attention_rescoring'], feats, lens, **kw)
    torch.cuda.synchronize()
    rate = lens.sum() / 100 / (time.perf_counter() - t0)
    chars = sum(len(r.tokens) for r in got['attention_rescoring'])
    print(f'  {label}; '
          f'{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params, '
          f'{len(model.encoder.encoders)} blocks) B={B} x {seconds:.0f} s: '
          f'encoder_out {tuple(eo.shape)}, on the {h} rows the CPU '
          f'decodes max |card - cpu| '
          f'{errs[0]:.3g} / log-probs {errs[1]:.3g} (bar 1e-3); '
          f'hypotheses equal the CPU\'s but at ties: '
          + ', '.join(f'{m} {flips[m]}/{h}' for m in MODES)
          + f' ({chars} tokens of rescoring text); launches K1 '
          f'{counted["K1"]}, K4 {counted["K4"]} '
          f'({encoder["K4"]} in the encoder, {dec_k4} in the rescoring '
          f'decoder at {L - 1} hypothesis slots); '
          f'rescoring decode {rate:.1f} audio-sec/s ({smi})', flush=True)
    del runner, model, cpu_model
    torch.cuda.empty_cache()
    return counted, float(rate), flips


def zoo_step_check(name):
    """12c: `step_against_cpu` of the zoo yaml `name`, every dropout 0."""
    configs = zoo_configs(name, dropout=False)
    step_against_cpu(name, configs, zoo_model(configs), *ZOO_TRAIN_STEP)


def step_against_cpu(label, configs, model, B, seconds, seed=SEED + 31,
                     watch=(), exact=False):
    """One forward + backward of the loss on the card against the CPU
    (`model` on the CPU, copied to the card and dropped): every loss term
    within rtol 1e-4, every gradient within 1e-3 + 2e-4 of its tensor's
    largest (`hold_gradients`; with `exact`, a tensor past that bar is
    held to the float64 gradient within the bar plus the CPU's own
    error); the gradients of the parameters named in `watch` printed.
    -> (the card's kernel launches, the largest share of the gradient
    bar)."""
    from wenet_tpu_torch.ops import flash_attention as fa
    from wenet_tpu_torch.utils.executor import to_device_batch
    cpu_model = copy.deepcopy(model)
    model.cuda()
    b = zoo_train_batch(np.random.RandomState(seed), B, seconds,
                        configs['input_dim'], configs['output_dim'])

    def step(m, dev):
        m.train()
        m.zero_grad(set_to_none=True)
        tb = to_device_batch(b, dev)
        out = m(tb['feats'].to(next(m.parameters()).dtype),
                tb['feats_lengths'], tb['target'], tb['target_lengths'],
                generator=torch.Generator().manual_seed(SEED))
        out['loss'].backward()
        return out

    fa.reset_launches()
    outs = [step(model, 'cuda')]
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    outs.append(step(cpu_model, 'cpu'))
    for k in outs[1]:
        if outs[1][k] is None or k == 'th_accuracy':
            continue
        a, w = outs[0][k].item(), outs[1][k].item()
        if not abs(a - w) <= 1e-4 * abs(w) + 1e-6:
            raise RuntimeError(f'{label}: {k} card {a} cpu {w} beyond rtol '
                               '1e-4')
    worst, worst_of_bar, largest, held = hold_gradients(
        label, model, cpu_model, exact=(lambda: float64_grads(
            cpu_model, lambda m: step(m, 'cpu'))) if exact else None)
    cpu_params = dict(cpu_model.named_parameters())
    watched = [
        f'{n} {(p.grad.cpu() - cpu_params[n].grad).abs().max().item():.3g}'
        for n, p in model.named_parameters() if any(w in n for w in watch)]
    print(f'  {label} train step B={B} x {seconds:.0f} s: loss '
          f'card {outs[0]["loss"].item():.6f} cpu {outs[1]["loss"].item():.6f}'
          f' (rtol 1e-4); {len(cpu_params)} grads, max |card - cpu| '
          f'{worst:.3g}, at most {100 * worst_of_bar:.0f}% of the bar (1e-3 '
          f'+ {GRAD_SHARE:g} x the largest |grad| of the tensor'
          + (', or of it plus the CPU\'s own error from float64' if exact
             else '') +
          f'); the largest |grad| {largest[0]:.3g} ({largest[1]})'
          + (f'; held to float64: ' + '; '.join(
              f'{n} |card - cpu| {e:.3g}, |card - f64| {c64:.3g}, '
              f'|cpu - f64| {p64:.3g} (bar {bar:.3g})'
              for n, e, c64, p64, bar in held) if held else '')
          + (f'; watched |card - cpu|: {", ".join(watched)}' if watched
             else ''), flush=True)
    del model, cpu_model
    torch.cuda.empty_cache()
    return launches, worst_of_bar


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
    launches = {name: 0 for name in ('relpos_attention_fwd',
                                     'flash_attention_fwd',
                                     *TRAIN_KERNELS, *FLASH_TRAIN_KERNELS)}
    rates, ties = {}, {}
    phase('12a-b decode, card vs CPU, launches')
    for name in ZOO:
        counted, rates[name], ties[name] = zoo_decode_check(
            name, *ZOO_DECODE, False, smi)
        launches['relpos_attention_fwd'] += counted['K1']
        launches['flash_attention_fwd'] += counted['K4']
    counted, rates['transformer_B64'], ties['transformer_B64'] = \
        zoo_decode_check('transformer', *ZOO_K4_DECODE, True, smi)
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
    return launches, {'audio_sec_per_s_rescoring': rates,
                      'hypotheses_at_ties': ties}


# ---------------------------------------------------------------------------
# 13. the recipe's stages 6 and 7: export and TLG decoding
# ---------------------------------------------------------------------------
TLG_WORDS, TLG_SENTENCES = 5000, 750  # 13a's lexicon and LM text
TLG_UTTS = (8, 4.0, 15.0)  # 13b: wavs, shortest and longest seconds
PLAIN_SEARCH_BUDGET_S = 60.0  # 13b: the Python searcher's time budget
EXPORT_ARGS = ['--chunk_size', '16', '--beam', '10', '--max_hyp_len', '64',
               '--reverse_weight', str(STREAM_OPTS['reverse_weight'])]
# 13c gate 1: the exported chunk step against the eager one.  Both run K1
# through the same operator on the same inputs, so bit equality is
# expected; the graph's other ops may be decomposed otherwise (cuBLAS picks
# by call), which this bar, a few float32 ulps of the outputs, admits
EXPORT_EAGER_TOL = 1e-5
EXPORT_DEPTH = 4  # 13c's encoder blocks (of the yamls' 12), for the time


# 13's CTC head: the seed's random head gives posteriors near flat over
# 4233 units, on which every arc of the TLG stays inside the WFST beam
# (the C++ search then runs slower than real time on the card), and with a
# plain scale and blank raise the blank takes every path (no word is
# decoded; PERF.md, stages 6 and 7).  So the head is scaled and
# the blank's bias raised as a trained head's posteriors look: the blank
# leads every unit by BLANK_LEAD on half of a seeded utterance's frames,
# and the top unit leads the blank by UNIT_LEAD (enough to pay a word's
# LM cost) on UNIT_FRAMES of them
BLANK_LEAD, UNIT_LEAD, UNIT_FRAMES = 4.0, 16.0, 0.2


def shape_ctc_head(model):
    """Scale the CTC head and raise the blank's bias as above -> (scale,
    the shares of frames where the blank leads by BLANK_LEAD and where a
    unit leads it by UNIT_LEAD)."""
    from wenet_tpu_torch.runtime.feature_pipeline import (
        FeaturePipeline, FeaturePipelineConfig)
    lo = model.ctc.ctc_lo
    pipe = FeaturePipeline(FeaturePipelineConfig(num_mel_bins=80))
    feats = pipe.accept_waveform(speech_like(np.random.RandomState(
        SEED + 33), 10.0))
    x = torch.from_numpy(feats)[None].to(lo.weight.device)
    with torch.no_grad():
        out, _ = model.forward_encoder(x, torch.tensor([x.shape[1]],
                                                       device=x.device))

        def lead():  # the top unit's logit above the blank's, per frame
            logits = lo(out[0]).float()
            return logits[:, 1:].amax(-1) - logits[:, 0]
        gap = lead()
        q50, q80 = (float(torch.quantile(gap, q))
                    for q in (0.5, 1.0 - UNIT_FRAMES))
        scale = (UNIT_LEAD + BLANK_LEAD) / (q80 - q50)
        lo.weight.mul_(scale)
        lo.bias.mul_(scale)
        lo.bias[0] += scale * q50 + BLANK_LEAD
        gap = lead()
    return (scale, float((gap <= -BLANK_LEAD).float().mean()),
            float((gap >= UNIT_LEAD).float().mean()))


def write_arpa(path, sentences, vocab=(), order=3, discount=0.5):
    """A back-off ARPA n-gram from counts over `sentences` (lists of
    words), every word of `vocab` counted once more as a unigram (so that
    each can be decoded): absolute discounting, the discounted mass as
    each context's back-off weight."""
    import math
    counts = [dict() for _ in range(order)]
    for w in vocab:
        counts[0][(w,)] = 1
    for words in sentences:
        seq = ['<s>'] + list(words) + ['</s>']
        for n in range(1, order + 1):
            for i in range(len(seq) - n + 1):
                gram = tuple(seq[i:i + n])
                counts[n - 1][gram] = counts[n - 1].get(gram, 0) + 1
    total = sum(c for g, c in counts[0].items() if g != ('<s>',))
    ctx_total, ctx_types = {}, {}
    for n in range(1, order):
        for gram, c in counts[n].items():
            ctx_total[gram[:-1]] = ctx_total.get(gram[:-1], 0) + c
            ctx_types[gram[:-1]] = ctx_types.get(gram[:-1], 0) + 1
    lines = ['\\data\\'] + [f'ngram {n + 1}={len(counts[n])}'
                            for n in range(order)]
    for n in range(order):
        lines += ['', f'\\{n + 1}-grams:']
        for gram, c in sorted(counts[n].items()):
            if n == 0:
                p = -99.0 if gram == ('<s>',) else math.log10(c / total)
            else:
                p = math.log10((c - discount) / ctx_total[gram[:-1]])
            row = f'{p:.6f}\t{" ".join(gram)}'
            if n < order - 1 and gram in ctx_total:
                bo = discount * ctx_types[gram] / ctx_total[gram]
                row += f'\t{math.log10(bo):.6f}'
            lines.append(row)
    lines += ['', '\\end\\', '']
    with open(path, 'w', encoding='utf-8') as f:
        f.write('\n'.join(lines))


def write_units(path, tokenizer):
    with open(path, 'w', encoding='utf-8') as f:
        for sym, i in sorted(tokenizer.symbol_table.items(),
                             key=lambda kv: kv[1]):
            f.write(f'{sym} {i}\n')


def tlg_build(d, tokenizer):
    phase('13a TLG: lexicon and 3-gram from a seed, build_tlg')
    from wenet_tpu_torch.lm.build_graph import build_tlg
    rng = np.random.RandomState(SEED + 30)
    write_units(os.path.join(d, 'units.txt'), tokenizer)
    chars = [s for s, i in tokenizer.symbol_table.items() if i >= 3]
    # every char a word, so that any unit the head emits can be decoded
    words = set(chars)
    while len(words) < TLG_WORDS:
        words.add(''.join(rng.choice(chars, rng.randint(2, 5))))
    words = sorted(words)
    with open(os.path.join(d, 'lexicon.txt'), 'w', encoding='utf-8') as f:
        f.writelines(f'{w} {" ".join(w)}\n' for w in words)
    # Zipf-like word frequencies, as text has
    p = 1.0 / np.arange(1, len(words) + 1)
    p /= p.sum()
    write_arpa(os.path.join(d, 'lm.arpa'),
               [[words[i] for i in rng.choice(len(words),
                                              rng.randint(1, 12), p=p)]
                for _ in range(TLG_SENTENCES)], vocab=words)
    t0 = time.perf_counter()
    fst = build_tlg(os.path.join(d, 'units.txt'),
                    os.path.join(d, 'lexicon.txt'),
                    os.path.join(d, 'lm.arpa'), os.path.join(d, 'lang'))
    seconds = time.perf_counter() - t0
    states = len(fst.arcs.keys() | fst.finals.keys())
    arcs = sum(len(a) for a in fst.arcs.values())
    mb = os.path.getsize(os.path.join(d, 'lang', 'TLG.txt')) / 2 ** 20
    print(f'  {len(words)} words (the {len(chars)} chars, the rest of 2-4 of '
          f'them), a 3-gram '
          f'over {TLG_SENTENCES} seeded sentences (each word a unigram); '
          f'TLG {states} states, '
          f'{arcs} arcs ({mb:.1f} MiB of text), built in {seconds:.1f} s '
          f'(pure Python, the host)')
    return dict(words=len(words), states=states, arcs=arcs,
                build_s=seconds)


def write_model_dir(d, model, tokenizer, configs=None):
    """A model directory of `model`: train.yaml (the flagship yaml, or
    `configs`, with input and output dims), units.txt, final.pt."""
    import yaml
    os.makedirs(d, exist_ok=True)
    write_units(os.path.join(d, 'units.txt'), tokenizer)
    configs = copy.deepcopy(configs or flagship_configs())
    configs['tokenizer_conf']['symbol_table_path'] = os.path.join(
        d, 'units.txt')
    with open(os.path.join(d, 'train.yaml'), 'w') as f:
        yaml.safe_dump(configs, f)
    torch.save(model.state_dict(), os.path.join(d, 'final.pt'))


class SearchRecorder:
    """Records each chunk step's host rows under the run's `label` (a
    list per utterance: `AsrDecoder.reset` starts one) and the time in the
    searcher, while it is on (`with`)."""

    def __init__(self):
        from wenet_tpu_torch.runtime.asr_decoder import AsrDecoder
        self.cls = AsrDecoder
        self.rows = {'card': [], 'cpu': []}
        self.search_s = {'card': 0.0, 'cpu': 0.0}
        self.label = 'card'

    def __enter__(self):
        cls, rec = self.cls, self
        self.reset, self.search = cls.reset, cls._search

        def reset(dec):
            rec.reset(dec)
            rec.rows[rec.label].append([])

        def search(dec, host):
            rec.rows[rec.label][-1].append(host)
            t0 = time.perf_counter()
            out = rec.search(dec, host)
            rec.search_s[rec.label] += time.perf_counter() - t0
            return out
        cls.reset, cls._search = reset, search
        return self

    def __exit__(self, *exc):
        self.cls.reset, self.cls._search = self.reset, self.search

    def utterances(self, label):
        return [u for u in self.rows[label] if u]


def wfst_replay(path, words, utt_rows, python=False, top_k=None,
                skip=0.98):
    """Search an utterance's recorded rows step by step -> (text,
    likelihood, seconds, word ids): the C++ decoder, or the Python one,
    with blank frames skipped above `skip` and the rows cut to the Python
    searcher's candidates with `top_k`."""
    from wenet_tpu_torch.lm.fst import TextFst
    from wenet_tpu_torch.runtime.native_wfst import NativeCtcWfstBeamSearch
    from wenet_tpu_torch.runtime.wfst_beam_search import CtcWfstBeamSearch
    if python:
        fst = path if isinstance(path, TextFst) else TextFst.read(path)
        s = CtcWfstBeamSearch(fst, beam_size=10, blank_skip_thresh=skip)
    else:
        s = NativeCtcWfstBeamSearch(path, beam_size=10,
                                    blank_skip_thresh=skip)
    t0 = time.perf_counter()
    for host in utt_rows:
        if top_k is not None:
            host = top_k_rows(host, top_k)
        s.search(host)
    s.finalize_search()
    dt = time.perf_counter() - t0
    hyps = s.hypotheses
    best = hyps[0] if hyps else []
    text = ''.join(words.get(w, str(w)) for w in best)
    return text, (s.likelihood[0] if hyps else float('-inf')), dt, best


def top_k_rows(logp, k=10):
    """Each frame's top-k and the blank kept, the rest at -1e4: the
    candidates the Python searcher advances (its `top_k`), which the C++
    decoder, with no top-k of its own, then drops by its beam."""
    out = np.full_like(logp, -1e4)
    idx = np.argpartition(-logp, k - 1, axis=1)[:, :k]
    np.put_along_axis(out, idx, np.take_along_axis(logp, idx, 1), 1)
    out[:, 0] = logp[:, 0]
    return out


def tlg_decode_check(d, model, tokenizer, smi):
    phase('13b TLG decode: decoder_main --fst_path --dict_path, card vs '
          'CPU, the C++ searcher vs the Python one')
    from wenet_tpu_torch.bin import decoder_main
    from wenet_tpu_torch.dataset.audio import write_wav
    from wenet_tpu_torch.lm.fst import TextFst, read_symbol_table
    from wenet_tpu_torch.ops import flash_attention as fa
    rng = np.random.RandomState(SEED + 31)
    n, lo, hi = TLG_UTTS
    seconds = np.linspace(lo, hi, n)
    mdir = os.path.join(d, 'model')
    write_model_dir(mdir, model, tokenizer)
    scp = os.path.join(d, 'wav.scp')
    with open(scp, 'w') as f:
        for i, s in enumerate(seconds):
            write_wav(os.path.join(d, f'{i}.wav'), speech_like(rng, s), SR)
            f.write(f'utt{i} {os.path.join(d, f"{i}.wav")}\n')
    lang = os.path.join(d, 'lang')
    tlg, words_txt = (os.path.join(lang, 'TLG.txt'),
                      os.path.join(lang, 'words.txt'))
    args = ['--model_dir', mdir, '--wav_scp', scp, '--chunk_size', '16',
            '--beam_size', '10', '--fst_path', tlg, '--dict_path', words_txt]
    timed = []
    decode_utt = decoder_main.decode_utt

    def timed_utt(*a):
        out = decode_utt(*a)
        timed.append(out[1:])
        return out
    decoder_main.decode_utt = timed_utt
    texts = {}
    try:
        with SearchRecorder() as rec:
            for label, dev in (('cpu', 'cpu'), ('card', 'cuda')):
                rec.label = label
                timed.clear()
                result = os.path.join(d, f'text.{label}')
                if label == 'card':
                    torch.cuda.synchronize()
                    fa.reset_launches()
                decoder_main.main(args + ['--device', dev, '--result_file',
                                          result])
                if label == 'card':
                    torch.cuda.synchronize()
                    launches = fa.LAUNCHES['relpos_attention_fwd']
                    audio = sum(t[0] for t in timed)
                    wall = sum(t[1] for t in timed)
                with open(result, encoding='utf-8') as f:
                    texts[label] = [line.split(maxsplit=1)[1:] or ['']
                                    for line in f.read().splitlines()]
    finally:
        decoder_main.decode_utt = decode_utt
    card, cpu = rec.utterances('card'), rec.utterances('cpu')
    steps = sum(len(u) for u in card)
    n_blocks = len(model.encoder.encoders)
    if len(card) != n or len(cpu) != n or launches != n_blocks * steps:
        raise RuntimeError(f'{len(card)} / {len(cpu)} utterances recorded, '
                           f'{launches} K1 launches for {steps} chunk steps')
    words = read_symbol_table(words_txt)
    decoded = explained = n_words = 0
    worst = 0.0
    for i, (c_rows, p_rows) in enumerate(zip(card, cpu)):
        g, w = texts['card'][i][0], texts['cpu'][i][0]
        g_text, g_lik, _, g_words = wfst_replay(tlg, words, c_rows)
        w_text, w_lik, _, _ = wfst_replay(tlg, words, p_rows)
        if (g_text.lower(), w_text.lower()) != (g, w):
            raise RuntimeError(f'utterance {i}: the replayed search gives '
                               f'{g_text[:20]!r} / {w_text[:20]!r}, '
                               f'decoder_main {g[:20]!r} / {w[:20]!r}')
        # each path's cost moves by at most the summed row differences
        # between the two devices, and the float32 sums of the search by
        # SEARCH_FLOAT_TIE of it: a swap within that is a tie
        slack = (float(sum(np.abs(a - b).max()
                           for a, b in zip(c_rows, p_rows)))
                 + SEARCH_FLOAT_TIE * abs(w_lik))
        worst = max(worst, abs(g_lik - w_lik) / max(slack, 1e-30))
        if abs(g_lik - w_lik) > slack:
            raise RuntimeError(f'utterance {i}: best likelihoods {g_lik:.4f} '
                               f'on the card, {w_lik:.4f} on the CPU, more '
                               f'than the rows explain ({slack:.3g})')
        if g != w:
            explained += 1
        decoded += bool(g)
        n_words += len(g_words)
    rtf = wall / audio
    share = rec.search_s['card'] / wall
    print(f'  {n} wavs of {lo}-{hi} s: the card\'s words equal the CPU\'s in '
          f'{n - explained} (the rest within the rows\' differences), '
          f'{decoded} with words ({n_words} in all); best likelihoods '
          f'within {worst:.1%} of '
          f'what the two devices\' rows explain; {steps} chunk steps, '
          f'{launches} K1 launches ({n_blocks} a step); RTF {rtf:.4f} on the '
          f'card ({audio:.1f} s of audio in {wall:.2f} s), the WFST search '
          f'{share:.1%} of it ({smi})')
    # gate 2: the C++ one-best against the plain Python searcher on the
    # card's rows, cut to the Python searcher's candidates, as far as its
    # time budget goes.  No blank skipping: there the two differ by design
    # (the C++ decoder re-inserts a blank between frames it skips, as the
    # reference's decoder does, so a repeat across them is a new token; the
    # Python searcher, as the JAX package's, merges it)
    fst = TextFst.read(tlg)
    compared, py_s, cc_s = 0, 0.0, 0.0
    for i, rows in enumerate(card):
        py = wfst_replay(fst, words, rows, python=True, top_k=10, skip=1.0)
        cc = wfst_replay(tlg, words, rows, top_k=10, skip=1.0)
        if py[0] != cc[0] or abs(py[1] - cc[1]) > 1e-3 * max(1.0,
                                                              abs(py[1])):
            raise RuntimeError(f'utterance {i}: the C++ searcher gives '
                               f'{cc[0][:20]!r} ({cc[1]:.4f}), the Python '
                               f'one {py[0][:20]!r} ({py[1]:.4f})')
        compared += 1
        py_s += py[2]
        cc_s += cc[2]
        if py_s > PLAIN_SEARCH_BUDGET_S:
            break
    print(f'  the C++ one-best equals the Python searcher\'s on {compared} '
          f'of {n} utterances (the card\'s rows, each frame\'s top-10 and '
          f'blank, no blank skipping; likelihoods within 1e-3 relative): '
          f'C++ {cc_s:.3f} s, Python {py_s:.2f} s for them')
    return launches, dict(rtf=rtf, search_share=share, steps=steps,
                          plain_compared=compared)


def export_check(d, tokenizer, smi):
    phase('13c export: export_model, the exported chunk step, full encoder '
          'and decoder vs eager, ExportedAsrDecoder vs AsrDecoder')
    import yaml
    from wenet_tpu_torch.bin import export_model
    from wenet_tpu_torch.models.transformer.streaming import (
        streaming_att_mask)
    from wenet_tpu_torch.ops import flash_attention as fa
    from wenet_tpu_torch.runtime.exported_model import (ExportedAsrDecoder,
                                                        ExportedAsrModel)
    from wenet_tpu_torch.runtime.asr_decoder import DecodeOptions
    from wenet_tpu_torch.runtime.feature_pipeline import (
        FeaturePipelineConfig)
    # the flagship at EXPORT_DEPTH blocks (tracing takes time by layer),
    # its CTC head shaped as 13's model's
    configs = flagship_configs()
    configs['encoder_conf']['num_blocks'] = EXPORT_DEPTH
    model = flagship_model(configs).cuda().eval()
    shape_ctc_head(model)
    mdir = os.path.join(d, 'export_model')
    os.makedirs(mdir)
    out = os.path.join(d, 'export')
    with open(os.path.join(mdir, 'config.yaml'), 'w') as f:
        yaml.safe_dump(configs, f)
    torch.save(model.state_dict(), os.path.join(mdir, 'final.pt'))
    t0 = time.perf_counter()
    export_model.main(['--config', os.path.join(mdir, 'config.yaml'),
                       '--checkpoint', os.path.join(mdir, 'final.pt'),
                       '--output_dir', out, '--device', 'cuda', *EXPORT_ARGS])
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    em = ExportedAsrModel(out, device='cuda')
    load_s = time.perf_counter() - t0
    sizes = {f: os.path.getsize(os.path.join(out, f)) / 2 ** 20
             for f in sorted(os.listdir(out))}
    print(f'  export_model: {export_s:.1f} s, load {load_s:.1f} s; ' +
          ', '.join(f'{k} {v:.1f} MiB' for k, v in sizes.items()))
    op = 'wenet_tpu_torch.relpos_attention_fwd'
    nodes = sum(1 for nd in em.chunk_program.graph.nodes
                if nd.op == 'call_function' and op in str(nd.target))
    n_blocks = len(model.encoder.encoders)
    if nodes != n_blocks:
        raise RuntimeError(f'{nodes} K1 nodes in the chunk program')
    # gates 1 and 2: three chained steps from zero caches, the exported
    # program against the eager step on the same inputs
    rng = np.random.RandomState(SEED + 32)
    cache, chunk = 512, 16
    worst, equal = 0.0, True
    exp_cache = em.zero_cache()
    eager = model.encoder.zero_cache(1, cache, device='cuda')
    with torch.inference_mode():
        for step, valid in enumerate((0, 16, 32)):
            xs = torch.from_numpy(rng.randn(1, 67, 80).astype(
                np.float32)).cuda()
            mask = streaming_att_mask(1, cache, chunk, valid, chunk, 'cuda')
            torch.cuda.synchronize()
            fa.reset_launches()
            ys, logp, exp_cache = em.forward_chunk(xs, valid, exp_cache,
                                                   mask)
            torch.cuda.synchronize()
            launched = fa.LAUNCHES['relpos_attention_fwd']
            if launched != n_blocks:
                raise RuntimeError(f'an exported step launched K1 '
                                   f'{launched} times')
            e_ys, e_att, e_cnn = model.forward_encoder_chunk(
                xs, valid, *eager, mask)
            e_logp = model.ctc_activation(e_ys)
            eager = (e_att, e_cnn)
            for a, b in zip((ys, logp) + exp_cache,
                            (e_ys, e_logp) + e_att + (e_cnn,)):
                equal &= torch.equal(a, b)
                worst = max(worst, (a - b).abs().max().item())
    if worst > EXPORT_EAGER_TOL:
        raise RuntimeError(f'exported chunk step off the eager one by '
                           f'{worst:.3g}')
    print(f'  chunk program: {nodes} K1 nodes, {n_blocks} launches a step; '
          f'three steps {"bit-equal to" if equal else "within"} the eager '
          f'ones (max |diff| {worst:.3g}, bar {EXPORT_EAGER_TOL})')
    # gate 3: the full encoder at two (B, T) on the time constraint
    sub, base = 4, 10
    with torch.inference_mode():
        for B, t in ((2, 250), (4, 100)):
            T = sub * t + base
            feats, lens = features(rng, B, T, T // 2)
            feats = torch.from_numpy(feats).cuda()
            lens = torch.from_numpy(lens).cuda()
            fa.reset_launches()
            o, m, lp = em.forward_full(feats, lens)
            launched = fa.LAUNCHES['relpos_attention_fwd']
            e_o, e_m = model.forward_encoder(feats, lens)
            e_lp = model.ctc_activation(e_o)
            valid = e_m[:, 0, :, None]
            err = max((o - e_o).mul(valid).abs().max().item(),
                      (lp - e_lp).mul(valid).abs().max().item())
            if not torch.equal(m, e_m) or err > CHUNK_CPU_TOL or \
                    launched != n_blocks:
                raise RuntimeError(f'encoder_full at B={B}, T={T}: {err:.3g} '
                                   f'off eager, {launched} K1 launches')
            print(f'  encoder_full B={B} T={T} ({T / 100:.2f} s): within '
                  f'{err:.3g} of the eager encoder + CTC (bar '
                  f'{CHUNK_CPU_TOL}), {launched} K1 launches')
            if B == 2:
                enc_out = e_o[:1]
    # gate 4: the rescoring decoder, 10 x 64 hypotheses of random lengths
    beam, max_len = 10, 64
    hyps = torch.from_numpy(rng.randint(3, 4233, (beam, max_len))).cuda()
    hyps[:, 0] = model.sos
    lens = torch.from_numpy(rng.randint(1, max_len + 1, beam)).cuda()
    with torch.inference_mode():
        dec, r_dec = em.rescore(hyps, lens, enc_out)
        e_dec, e_r = model.forward_attention_decoder(
            hyps, lens, enc_out, STREAM_OPTS['reverse_weight'])
    err = max((dec - e_dec).abs().max().item(),
              (r_dec - e_r).abs().max().item())
    if err > CHUNK_CPU_TOL:
        raise RuntimeError(f'decoder_rescore off eager by {err:.3g}')
    print(f'  decoder_rescore ({beam} x {max_len}, {enc_out.shape[1]} '
          f'encoder frames): within {err:.3g} of the eager decoders')
    # gate 5: ExportedAsrDecoder against AsrDecoder on 9c's utterances
    urng = np.random.RandomState(SEED + 12)
    utts = [speech_like(urng, s) for s in STREAM_SECONDS]
    exp_dec = ExportedAsrDecoder(out, tokenizer, DecodeOptions(**STREAM_OPTS),
                                 FeaturePipelineConfig(num_mel_bins=80),
                                 device='cuda')
    want = [stream_utterance(streaming_decoder(model, 'cuda', tokenizer), w)
            for w in utts]
    stream_utterance(exp_dec, utts[0])  # warm up
    torch.cuda.synchronize()
    fa.reset_launches()
    got = [stream_utterance(exp_dec, w) for w in utts]
    torch.cuda.synchronize()
    launches = fa.LAUNCHES['relpos_attention_fwd']
    worst = 0.0
    for i, ((g_part, g_final, _), (w_part, w_final, _)) in enumerate(
            zip(got, want)):
        if len(g_part) != len(w_part):
            raise RuntimeError(f'utterance {i}: {len(g_part)} partials '
                               f'exported, {len(w_part)} eager')
        for j, (g, w) in enumerate(zip(g_part, w_part)):
            worst = max(worst, same_results(g, w, f'utterance {i} partial '
                                            f'{j} (exported)'))
        worst = max(worst, same_results(g_final, w_final,
                                        f'utterance {i} final (exported)'))
    print(f'  ExportedAsrDecoder on 9c\'s {len(utts)} utterances: every '
          f'partial and final equal to AsrDecoder\'s (scores within '
          f'{worst:.3g}); {launches} K1 launches')
    return launches, {}


# 13c (2): plain self-attention through export_model, at the aishell
# transformer's width: below K4's gate (B=16) and above it (B=64), 15 s rows
EXPORT_ZOO = 'transformer'
EXPORT_ZOO_ROWS = (16, 64)
EXPORT_ZOO_MAX_HYP = 128  # the decoder length the export used to refuse
EXPORT_PLAIN_TOL = 2e-4  # exported (plain path) against eager K4


def export_plain_check(d, smi):
    """13c (2): bin/export_model of the aishell transformer yaml at full
    width and EXPORT_DEPTH blocks (random weights from the seed) with
    max_hyp_len 128.  The
    exported full encoder equals eager bit for bit at B=16 x 15 s (both the
    plain path, below K4's gate) and lies within EXPORT_PLAIN_TOL of eager
    at B=64 x 15 s (eager launches K4, the program the plain path); the
    exported decoder equals eager; the programs launch no K4.  -> the
    readings, with the exported and eager encoder times at B=64."""
    import yaml
    from wenet_tpu_torch.bin import export_model
    from wenet_tpu_torch.ops import flash_attention as fa
    from wenet_tpu_torch.runtime.exported_model import ExportedAsrModel
    configs = zoo_configs(EXPORT_ZOO)
    configs['encoder_conf']['num_blocks'] = EXPORT_DEPTH
    model = zoo_model(configs).cuda().eval()
    model.requires_grad_(False)
    mdir = os.path.join(d, 'transformer')
    os.makedirs(mdir)
    with open(os.path.join(mdir, 'train.yaml'), 'w') as f:
        yaml.safe_dump(configs, f)
    torch.save(model.state_dict(), os.path.join(mdir, 'final.pt'))
    out = os.path.join(mdir, 'export')
    t0 = time.perf_counter()
    export_model.main(['--config', os.path.join(mdir, 'train.yaml'),
                       '--checkpoint', os.path.join(mdir, 'final.pt'),
                       '--output_dir', out, '--device', 'cuda',
                       '--chunk_size', '16', '--beam', '10', '--max_hyp_len',
                       str(EXPORT_ZOO_MAX_HYP)])
    export_s = time.perf_counter() - t0
    em = ExportedAsrModel(out, device='cuda')
    sub = model.encoder.subsampling_rate
    base = model.encoder.right_context + sub
    if em.meta['time_constraint'] != f'{sub}*t + {base}':
        raise RuntimeError(f'time constraint {em.meta["time_constraint"]}')
    T = sub * 373 + base  # 15.02 s: 374 frames out, as 12a's 15 s rows
    rng = np.random.RandomState(SEED + 33)
    n_blocks = len(model.encoder.encoders)
    readings = dict(export_s=export_s)
    with torch.inference_mode():
        for B in EXPORT_ZOO_ROWS:
            x = torch.from_numpy(rng.randn(B, T, configs['input_dim']).astype(
                np.float32)).cuda()
            lens = rng.randint(2 * T // 3, T + 1, size=B)
            lens[0] = T
            n = torch.from_numpy(lens).cuda()
            torch.cuda.synchronize()
            fa.reset_launches()
            o, m, lp = em.forward_full(x, n)
            torch.cuda.synchronize()
            exp_k4 = fa.LAUNCHES['flash_attention_fwd']
            fa.reset_launches()
            e_o, e_m = model.forward_encoder(x, n)
            e_lp = model.ctc_activation(e_o)
            torch.cuda.synchronize()
            eager_k4 = fa.LAUNCHES['flash_attention_fwd']
            t2 = e_o.shape[1]
            want_k4 = n_blocks if gate_open(B, 4, t2, t2) else 0
            valid = e_m[:, 0, :, None]
            err = max((o - e_o).mul(valid).abs().max().item(),
                      (lp - e_lp).mul(valid).abs().max().item())
            equal = torch.equal(o, e_o) and torch.equal(lp, e_lp)
            if exp_k4 or eager_k4 != want_k4 or not torch.equal(m, e_m):
                raise RuntimeError(f'13c plain export B={B}: K4 launches '
                                   f'{exp_k4} exported, {eager_k4} eager '
                                   f'(expected 0 and {want_k4}), or masks '
                                   'differ')
            if (want_k4 == 0 and not equal) or err > EXPORT_PLAIN_TOL:
                raise RuntimeError(f'13c plain export B={B}: exported off '
                                   f'eager by {err:.3g}')
            ms = {'exported': [], 'eager': []}
            for _ in range(2):  # interleaved, best of two
                ms['exported'].append(cuda_time_ms(
                    lambda: em.forward_full(x, n), reps=3, warmup=1))
                ms['eager'].append(cuda_time_ms(
                    lambda: model.ctc_activation(
                        model.forward_encoder(x, n)[0]), reps=3, warmup=1))
            readings[f'B{B}'] = dict(
                exported_ms=min(ms['exported']), eager_ms=min(ms['eager']),
                max_abs_err=err, bit_equal=equal, eager_k4=eager_k4)
            bar = EXPORT_PLAIN_TOL if want_k4 else 'equality'
            print(f'  encoder_full B={B} x T={T} ({t2} frames): exported '
                  f'{"bit-equal to" if equal else "within"} eager (max '
                  f'|diff| {err:.3g}, bar {bar}); '
                  f'K4 launches: eager {eager_k4}, exported {exp_k4}; card '
                  f'time exported {min(ms["exported"]):.3f} ms, eager '
                  f'{min(ms["eager"]):.3f} ms (CUDA events, best of 2; '
                  f'{smi})', flush=True)
            if B == EXPORT_ZOO_ROWS[0]:
                enc_out = e_o[:1]
        beam, max_len = 10, EXPORT_ZOO_MAX_HYP
        hyps = torch.from_numpy(rng.randint(
            3, configs['output_dim'], (beam, max_len))).cuda()
        hyps[:, 0] = model.sos
        hl = torch.from_numpy(rng.randint(1, max_len + 1, beam)).cuda()
        hl[0] = max_len
        fa.reset_launches()
        dec, _ = em.rescore(hyps, hl, enc_out)
        torch.cuda.synchronize()
        dec_k4 = fa.LAUNCHES['flash_attention_fwd']
        e_dec, _ = model.forward_attention_decoder(hyps, hl, enc_out, 0.0)
    err = (dec - e_dec).abs().max().item()
    if dec_k4 or not torch.equal(dec, e_dec):
        raise RuntimeError(f'13c decoder_rescore at {beam} x {max_len}: '
                           f'{err:.3g} off eager, {dec_k4} K4 launches')
    print(f'  decoder_rescore {beam} x {max_len} over {enc_out.shape[1]} '
          f'frames: bit-equal to eager, no K4 launch; export_model '
          f'{export_s:.1f} s')
    readings['decoder_bit_equal'] = True
    return readings


def tlg_check(smi):
    """Phase 13a-b on one flagship model -> (K1 launches of 13b's card
    decode, readings, the directory of 13a's TLG)."""
    phase('13 the recipe\'s stages 6 and 7: TLG decoding (13a-b)')
    model = flagship_model().cuda().eval()
    scale, blank, unit = shape_ctc_head(model)
    print(f'  the CTC head scaled by {scale:.2f} and the blank raised: on a '
          f'seeded utterance the blank leads by {BLANK_LEAD} on {blank:.0%} '
          f'of the frames, a unit leads it by {UNIT_LEAD} on {unit:.0%}')
    tokenizer = flagship_tokenizer()
    d = tempfile.mkdtemp(prefix='chip_smoke_stage67_')
    tlg = tlg_build(d, tokenizer)
    wfst_launches, wfst = tlg_decode_check(d, model, tokenizer, smi)
    return wfst_launches, dict(tlg=tlg, wfst=wfst), os.path.join(d, 'lang')


def export_stage_check(smi):
    """Phase 13c -> (K1 launches of the exported stream, readings)."""
    phase('13 the recipe\'s stage 7: export (13c)')
    d = tempfile.mkdtemp(prefix='chip_smoke_export_')
    export_launches, export = export_check(d, flagship_tokenizer(), smi)
    export['plain_attention'] = export_plain_check(d, smi)
    return export_launches, export


# ---------------------------------------------------------------------------
# 14. the transducer: examples/aishell/rnnt/conf/train_u2pp_transducer.yaml
# ---------------------------------------------------------------------------
RNNT_CONFIG = os.path.join(REPO, 'examples/aishell/rnnt/conf/'
                           'train_u2pp_transducer.yaml')
RNNT_DECODE = (16, 10.0, 15.0)  # 14a: B, shortest and longest seconds
# 14a's and 14d's encoder depth (the yaml has 12 blocks), for the time;
# 14c's step runs the yaml's 12, where its gradients were read
RNNT_DEPTH = 6
RNNT_BEAM = 10
RNNT_MODES = ['rnnt_greedy_search', 'rnnt_beam_search',
              'attention_rescoring']
# 14a: random weights emit on almost every step, with logits that vary
# little from frame to frame.  The joint's output is scaled and its blank
# raised (`shape_joint_blank`) so that a unit leads on as many frames as
# read Mandarin has chars (4 a second, of 25 frames).  A random
# predictor's state after a unit does not favour blank as a trained one's
# does, so a frame that emits once emits up to the greedy budget: 14a
# decodes with rnnt_n_steps=1, one unit a frame at most (the setting
# tools/parity_decode.py pins for random weights)
RNNT_GAP_SPREAD = 4.0
RNNT_UNITS_PER_S = 4.0
RNNT_N_STEPS = 1
# beam scores card against CPU: this (the torch bar) on top of what the
# devices' log-probs explain (`rnnt_compare`)
RNNT_SCORE_TOL = 2e-4
# the encoder output the rnnt searches are held on: the per-layer forward
# bar, as the searches are held to the CPU's on the card's encoder output
RNNT_ENCODER_TOL = 2e-4
RNNT_LOSS_SHAPE = ([300, 277, 251, 213], [40, 33, 19, 0])  # 14b T, U
RNNT_LOSS_RTOL = 1e-5
RNNT_GRAD_SHARE = 1e-4  # of the largest gradient
RNNT_STEP = (4, 12.0)  # 14c: B x seconds
RNNT_BF16_RTOL = 1e-2  # 14c: the bf16 autocast loss against fp32
RNNT_RECOGNIZE = (16, 8)  # 14d: wavs decoded on the card, and on the CPU


def rnnt_configs(dropout=True, depth=RNNT_DEPTH):
    """The rnnt yaml's configs (80-d fbank, the flagship's 4233 chars) at
    `depth` encoder blocks (None: the yaml's); dropout=False sets every
    dropout of the encoder, decoder, predictor and joint to 0."""
    import yaml
    with open(RNNT_CONFIG) as f:
        configs = yaml.safe_load(f)
    configs['input_dim'], configs['output_dim'] = 80, 4233
    if depth is not None:
        configs['encoder_conf']['num_blocks'] = depth
    if not dropout:
        for conf in (configs['encoder_conf'], configs['decoder_conf']):
            for key in conf:
                if key.endswith('dropout_rate'):
                    conf[key] = 0.0
        configs['predictor_conf'].update(embed_dropout=0.0, dropout=0.0)
        configs['joint_conf']['dropout_rate'] = 0.0
    return configs


def speech_features(rng, B, shortest, longest):
    """B speech-like utterances (the first `longest` seconds, the others
    from `shortest`) as 80-d fbank -> (feats (B, T, 80), lens)."""
    from wenet_tpu_torch.runtime.feature_pipeline import (
        FeaturePipeline, FeaturePipelineConfig)
    rows = []
    for b in range(B):
        seconds = longest if b == 0 else rng.uniform(shortest, longest)
        pipe = FeaturePipeline(FeaturePipelineConfig(num_mel_bins=80))
        rows.append(pipe.accept_waveform(speech_like(rng, seconds)))
    lens = np.asarray([len(r) for r in rows], np.int64)
    feats = np.zeros((B, lens.max(), 80), np.float32)
    for b, r in enumerate(rows):
        feats[b, :len(r)] = r
    return feats, lens


def shape_joint_blank(model):
    """Scale the joint's output layer until the top unit's lead over
    blank spreads over RNNT_GAP_SPREAD between the 10th and 90th
    percentiles of a seeded 10 s utterance's frames (at the predictor's
    first state), then raise the blank's bias so that a unit leads on
    RNNT_UNITS_PER_S / 25 of them; in eval mode, which it leaves the model
    in -> (the scale, the blank's shift)."""
    feats, lens = speech_features(np.random.RandomState(SEED + 40), 1, 10.0,
                                  10.0)
    model.eval()
    out = model.joint.ffn_out
    with torch.no_grad():
        eo, _ = model.forward_encoder(torch.from_numpy(feats),
                                      torch.from_numpy(lens))
        pred, _, _ = model._init_predictor(1, eo)

        def lead():
            logits = model.joint(eo, pred)[0, :, 0]
            return logits[:, 1:].amax(-1) - logits[:, 0]
        gap = lead()
        scale = RNNT_GAP_SPREAD / float(gap.quantile(0.9) - gap.quantile(0.1))
        out.weight.mul_(scale)
        out.bias.mul_(scale)
        shift = float(lead().quantile(1 - RNNT_UNITS_PER_S / 25))
        out.bias[0] += shift
    return scale, shift


def greedy_margins(model, enc, n, n_steps=64):
    """The greedy search of one utterance (enc (1, T, D), n frames)
    replayed step by step on the CPU -> [(emitted unit or None, top-1
    minus top-2 logit)] for each step."""
    T = enc.shape[1]
    joint = model.joint
    steps = []
    with torch.no_grad():
        encp = joint.project_enc(enc)
        out, state, padding = model._init_predictor(1, enc)
        pred = joint.project_pred(out)
        t = noblk = 0
        for _ in range(2 * T):
            if t >= n:
                break
            logits = joint(encp[:, t:t + 1], pred, pre_project=False)[
                0, 0, 0]
            top = logits.topk(2).values
            best = int(logits.argmax())
            emit = best != model.blank and noblk < n_steps
            steps.append((best if emit else None, float(top[0] - top[1])))
            if emit:
                out, state = model.predictor.forward_step(
                    torch.tensor([[best]]), padding, state)
                pred = joint.project_pred(out)
                noblk += 1
            else:
                t, noblk = t + 1, 0
    return steps


def greedy_tie(steps, got, want, bar):
    """Whether the CPU's greedy path (`steps`, giving `want`) and the
    card's tokens `got` part at a decision the two devices may take
    otherwise: between the CPU's emissions of the last common token and
    the first differing one, some step's top two logits lie within
    `bar`."""
    j = next((i for i, (g, w) in enumerate(zip(got, want)) if g != w),
             min(len(got), len(want)))
    emitted = [i for i, (u, _) in enumerate(steps) if u is not None]
    lo = emitted[j - 1] + 1 if j > 0 else 0
    hi = emitted[j] + 1 if j < len(emitted) else len(steps)
    return any(m <= bar for _, m in steps[lo:hi])


def same_beam(got, want, bound):
    """Raise unless two rnnt beam results agree up to what the two
    devices' log-probs explain: a hypothesis in both n-bests within
    `bound` (the summed per-frame log-prob differences and float32's
    resolution of the sum); one in only one of them within `bound` of the
    other's last (a pruning at the beam's edge); the bests equal unless
    their scores lie within `bound`.  -> (largest gap of a common
    hypothesis, hypotheses in one n-best only)."""
    theirs = dict(zip(map(tuple, want.nbest), want.nbest_scores))
    ours = dict(zip(map(tuple, got.nbest), got.nbest_scores))
    worst, edge = 0.0, 0
    for mine, other, last in ((ours, theirs, want.nbest_scores[-1]),
                              (theirs, ours, got.nbest_scores[-1])):
        for h, sc in mine.items():
            if h in other:
                worst = max(worst, abs(sc - other[h]))
                if abs(sc - other[h]) > bound:
                    raise RuntimeError(f'rnnt beam: a hypothesis scores '
                                       f'{sc} against {other[h]} (bound '
                                       f'{bound:.3g})')
            elif sc > last + bound:
                raise RuntimeError(f'rnnt beam: a hypothesis of one device '
                                   f'only scores {sc}, above the other\'s '
                                   f'last {last} + {bound:.3g}')
            else:
                edge += 1
    if got.tokens != want.tokens and abs(got.score - want.score) > bound:
        raise RuntimeError('rnnt beam: the best hypotheses differ')
    return worst, edge


RNNT_CHECK_MODES = MODES + ['rnnt_greedy_search', 'rnnt_beam_search']


def rnnt_compare(what, model, cpu_model, feats, lens, kw):
    """Decode the batch in RNNT_CHECK_MODES through AsrRunner.decode on
    the card (`model`) and raise unless it agrees with the CPU up to the
    ties the devices' log-probs explain.  The CTC modes and attention
    rescoring: against the CPU's own decode, by zoo_same_hypotheses.  The
    rnnt searches: against the CPU's searches over the card's encoder
    output (copied), whose card - CPU difference the encoder's checks
    bound (12a's 1e-3; a scaled joint multiplies it past any search bar,
    PERF.md): greedy identical but where the replayed CPU
    path has a near-tie at the parting decision (within twice the largest
    |card - CPU| joint log-prob at the predictor's first state, + 1e-5);
    the beam by `same_beam` with a bound of the utterance's summed
    per-frame largest joint or CTC log-prob difference (the fusion moves
    by no more) + SEARCH_FLOAT_TIE of the best score + RNNT_SCORE_TOL.
    The CPU decodes once: MODES on its own encoder output, the rnnt
    searches on the card's.
    -> (card results, the CPU's, K1 launches of the card's decode, {mode:
    utterances that part at ties}, readings: the largest joint log-prob
    difference, the largest beam score gap and its share of the
    bound)."""
    from wenet_tpu_torch.models.runner import AsrRunner, rnnt_decode
    from wenet_tpu_torch.ops import flash_attention as fa
    fa.reset_launches()
    got = AsrRunner(model, 'cuda').decode(RNNT_CHECK_MODES, feats, lens,
                                          **kw)
    torch.cuda.synchronize()
    k1 = fa.LAUNCHES['relpos_attention_fwd']
    want, ceo, cem = decode_with_encoder(AsrRunner(cpu_model, 'cpu'), MODES,
                                         feats, lens, **kw)
    x, n = torch.from_numpy(feats), torch.from_numpy(lens)
    with torch.inference_mode():
        eo, em = model.forward_encoder(x.cuda(), n.cuda())
        logp, clogp = model.ctc_logprobs(eo), cpu_model.ctc_logprobs(ceo)
        heo = eo.cpu()  # the card's encoder output, for the CPU searches
        first = [m._init_predictor(len(lens), e)[0]
                 for m, e in ((model, eo), (cpu_model, heo))]
        jl = model.joint(eo, first[0])[:, :, 0].float().log_softmax(-1)
        cjl = cpu_model.joint(heo, first[1])[:, :, 0].log_softmax(-1)
        hlogp = cpu_model.ctc_logprobs(heo)
    elens = cem[:, 0].sum(-1)
    if not torch.equal(em[:, 0].sum(-1).cpu(), elens):
        raise RuntimeError(f'{what}: encoder lengths differ')
    enc_err = float((heo - ceo).abs().max())
    if not enc_err <= RNNT_ENCODER_TOL:
        raise RuntimeError(f'{what}: encoder_out card - CPU {enc_err} (bar '
                           f'{RNNT_ENCODER_TOL})')
    flips = zoo_same_hypotheses(what, {m: got[m] for m in MODES}, want,
                                logp, clogp, elens)
    with torch.inference_mode():
        rnnt = rnnt_decode(cpu_model, heo, elens,
                           ['rnnt_greedy_search', 'rnnt_beam_search'],
                           kw['beam_size'], kw.get('rnnt_n_steps', 64))
    jdiff = (jl.cpu() - cjl).abs().amax(-1)  # (B, T)
    valid = torch.arange(jdiff.shape[1])[None] < elens[:, None]
    joint_err = float((jdiff * valid).max())
    fused = torch.maximum(jdiff, (logp.cpu() - hlogp).abs().amax(-1))
    beam_gap, beam_share = 0.0, 0.0
    flips.update(rnnt_greedy_search=0, rnnt_beam_search=0)
    for b in range(len(lens)):
        g = got['rnnt_greedy_search'][b].tokens
        w = rnnt['rnnt_greedy_search'][b].tokens
        if g != w:
            steps = greedy_margins(cpu_model, heo[b:b + 1], int(elens[b]),
                                   kw.get('rnnt_n_steps', 64))
            if not greedy_tie(steps, g, w, 2 * joint_err + 1e-5):
                raise RuntimeError(f'{what}: rnnt greedy utterance {b} '
                                   'differs from the CPU beyond a tie')
            flips['rnnt_greedy_search'] += 1
        best = rnnt['rnnt_beam_search'][b]
        bound = (float((fused[b] * valid[b]).sum()) + RNNT_SCORE_TOL +
                 SEARCH_FLOAT_TIE * abs(best.score))
        gap, edge = same_beam(got['rnnt_beam_search'][b], best, bound)
        beam_gap, beam_share = max(beam_gap, gap), max(beam_share,
                                                       gap / bound)
        flips['rnnt_beam_search'] += edge > 0
    return got, dict(want, **rnnt), k1, flips, {
        'enc_err': enc_err, 'joint_err': joint_err, 'beam_gap': beam_gap,
        'beam_share': beam_share}


def search_launches(fn):
    """(kernel launches, their device ms, the wall ms) of one call of
    `fn`, traced by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    return (sum(c for c, _ in rows.values()),
            sum(ms for _, ms in rows.values()), 1e3 * wall)


def rnnt_decode_check(smi):
    """14a: the rnnt yaml at full width, random weights from the seed and
    the joint's blank raised, decoded on the card against the CPU at B =
    16 x 10-15 s of speech-like fbank -> (K1 launches, readings)."""
    from wenet_tpu_torch.models.runner import AsrRunner
    configs = rnnt_configs()
    model = zoo_model(configs)
    scale, shift = shape_joint_blank(model)
    cpu_model = copy.deepcopy(model)
    model.cuda()
    B, lo, hi = RNNT_DECODE
    feats, lens = speech_features(np.random.RandomState(SEED + 41), B, lo, hi)
    kw = dict(beam_size=RNNT_BEAM, ctc_weight=0.3, reverse_weight=0.3,
              rnnt_n_steps=RNNT_N_STEPS)
    got, _, k1, flips, errs = rnnt_compare('14a', model, cpu_model, feats,
                                           lens, kw)
    n_blocks = configs['encoder_conf']['num_blocks']
    if k1 != n_blocks:
        raise RuntimeError(f'14a: {k1} K1 launches in one decode, expected '
                           f'{n_blocks} (one encoder pass)')
    greedy = [len(r.tokens) for r in got['rnnt_greedy_search']]
    beam = [len(r.tokens) for r in got['rnnt_beam_search']]
    audio = float(lens.sum()) / 100
    params = sum(p.numel() for p in model.parameters()) / 1e6
    print(f'  rnnt yaml ({params:.1f}M params) B={B} x {lo:.0f}-{hi:.0f} s ({audio:.1f} s of audio), '
          f'joint output x {scale:.1f}, blank bias + {shift:.3f}, '
          f'rnnt_n_steps {RNNT_N_STEPS}: emitted units greedy '
          f'{min(greedy)}-{max(greedy)} (mean {np.mean(greedy):.1f}), beam '
          f'best {min(beam)}-{max(beam)}; card == CPU but at ties: '
          + ', '.join(f'{m} {f}/{B}' for m, f in flips.items())
          + f'; the rnnt searches on the card\'s encoder output (encoder '
          f'card - CPU {errs["enc_err"]:.3g}, bar '
          f'{RNNT_ENCODER_TOL}): joint log-probs '
          f'within {errs["joint_err"]:.3g}, beam scores within '
          f'{errs["beam_gap"]:.3g}, {100 * errs["beam_share"]:.0f}% of '
          f'their bound; K1 {k1} launches a decode ({smi})', flush=True)
    runner = AsrRunner(model, 'cuda')
    rates = {}
    for mode in RNNT_MODES:
        runner.decode([mode], feats, lens, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.decode([mode], feats, lens, **kw)
        torch.cuda.synchronize()
        rates[mode] = audio / (time.perf_counter() - t0)
    print('  decode audio-sec/s: ' + ', '.join(
        f'{m} {r:.1f}' for m, r in rates.items()) + f' ({smi})', flush=True)
    per_frame = {}
    with torch.inference_mode():
        eo, em = model.forward_encoder(torch.from_numpy(feats).cuda(),
                                       torch.from_numpy(lens).cuda())
        el = em[:, 0].sum(-1)
        T = eo.shape[1]
        for name, fn in (
                ('rnnt_greedy_search',
                 lambda: model.greedy_search(eo, el, RNNT_N_STEPS)),
                ('rnnt_beam_search',
                 lambda: model.beam_search(eo, el, RNNT_BEAM))):
            n, dev_ms, wall_ms = search_launches(fn)
            per_frame[name] = n / T
            print(f'    {name} over T={T} frames: {n} launches '
                  f'({n / T:.1f} a frame), {dev_ms:.1f} ms of kernel time '
                  f'in {wall_ms:.1f} ms (profiled; {smi})', flush=True)
    del runner, model, cpu_model
    torch.cuda.empty_cache()
    return k1, {'audio_sec_per_s': rates, 'launches_per_frame': per_frame,
                'ties': flips}


def rnnt_loss_check(smi):
    """14b: the RNN-T loss at B=4, T up to 300, U up to 40 and the full
    vocabulary, ragged, one utterance without labels: card against the
    CPU and a float64 CPU run -> readings."""
    import torch.nn.functional as F
    from wenet_tpu_torch.ops.rnnt_loss import rnnt_loss, rnnt_loss_logits
    Ts, Us = RNNT_LOSS_SHAPE
    B, T, U, V = len(Ts), max(Ts), max(Us), 4233
    g = torch.Generator().manual_seed(SEED + 42)
    logits = 2 * torch.randn(B, T, U + 1, V, generator=g)
    labels = torch.randint(1, V, (B, U), generator=g)
    tl, ul = torch.tensor(Ts), torch.tensor(Us)

    def run(dev, double=False):
        x = logits.to(dev, torch.float64 if double else torch.float32,
                      copy=True).requires_grad_()
        args = (labels.to(dev), tl.to(dev), ul.to(dev))
        if double:
            per = rnnt_loss(F.log_softmax(x, -1), *args, reduction='none')
        else:
            per = rnnt_loss_logits(x, *args, reduction='none')
        per.mean().backward()
        return per.detach().cpu().double(), x.grad.cpu().double()

    card, cpu, f64 = run('cuda'), run('cpu'), run('cpu', double=True)
    worst = {}
    for name, (a, b) in (('card-cpu', (card, cpu)), ('card-f64', (card, f64)),
                         ('cpu-f64', (cpu, f64))):
        rel = float(((a[0] - b[0]).abs() / b[0].abs()).max())
        gshare = float((a[1] - b[1]).abs().max() / b[1].abs().max())
        worst[name] = (rel, gshare)
        if not (rel <= RNNT_LOSS_RTOL and gshare <= RNNT_GRAD_SHARE):
            raise RuntimeError(f'14b {name}: loss rtol {rel:.3g} (bar '
                               f'{RNNT_LOSS_RTOL}), grad {gshare:.3g} of the '
                               f'largest (bar {RNNT_GRAD_SHARE})')
    x = logits.to('cuda', copy=True).requires_grad_()
    args = (labels.cuda(), tl.cuda(), ul.cuda())
    fwd, bwd = [], []
    for _ in range(4):
        e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        e[0].record()
        loss = rnnt_loss_logits(x, *args)
        e[1].record()
        loss.backward()
        e[2].record()
        torch.cuda.synchronize()
        fwd.append(e[0].elapsed_time(e[1]))
        bwd.append(e[1].elapsed_time(e[2]))
    n, dev_ms, wall_ms = search_launches(
        lambda: rnnt_loss_logits(x, *args).backward())
    torch.cuda.reset_peak_memory_stats()
    rnnt_loss_logits(x, *args).backward()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'  RNN-T loss B={B}, T {Ts}, U {Us}, V={V} ((B, T, U+1, V) '
          f'{logits.numel() * 4 / 2 ** 30:.2f} GiB fp32): per-utterance '
          f'losses {[round(float(v), 3) for v in card[0]]}; '
          + '; '.join(f'{k}: loss rtol {r:.2e}, grad {s:.2e} of the largest'
                      for k, (r, s) in worst.items())
          + f' (bars {RNNT_LOSS_RTOL:g}, {RNNT_GRAD_SHARE:g}); forward '
          f'{min(fwd):.2f} ms, backward {min(bwd):.2f} ms (CUDA events, '
          f'best of 4); {n} launches a forward + backward, {dev_ms:.2f} ms '
          f'of kernel time in {wall_ms:.1f} ms (profiled); peak '
          f'{peak:.2f} GiB ({smi})', flush=True)
    del x, logits
    torch.cuda.empty_cache()
    return {'forward_ms': min(fwd), 'backward_ms': min(bwd),
            'launches': n, 'kernel_ms': dev_ms}


def rnnt_step_check(smi):
    """14c: one train step of the rnnt yaml at B=4 x 12 s, dynamic chunk,
    dropouts 0, the yaml's 12 encoder blocks: card against CPU (loss
    rtol 1e-4; grads 1e-3 + 2e-4 of the tensor's largest, 12c's bar), a
    launch of K1-train, K2 and K3 per encoder block; the RNN-T loss's share of the step's kernel time
    (profiled); a bf16 autocast step against fp32 -> launches."""
    from wenet_tpu_torch.ops import flash_attention as fa
    from wenet_tpu_torch.ops.rnnt_loss import rnnt_loss_logits
    from wenet_tpu_torch.utils.common import add_blank
    from wenet_tpu_torch.utils.executor import to_device_batch
    configs = rnnt_configs(dropout=False, depth=None)
    model = zoo_model(configs)
    cpu_model = copy.deepcopy(model)
    model.cuda()
    B, seconds = RNNT_STEP
    b = zoo_train_batch(np.random.RandomState(SEED + 43), B, seconds, 80,
                        configs['output_dim'])
    n_blocks = configs['encoder_conf']['num_blocks']
    outs, launches = [], {}

    def step(m, dev, dtype=None):
        m.train()
        m.zero_grad(set_to_none=True)
        tb = to_device_batch(b, dev)
        with torch.autocast(dev, dtype=dtype, enabled=dtype is not None):
            out = m(tb['feats'], tb['feats_lengths'], tb['target'],
                    tb['target_lengths'],
                    generator=torch.Generator().manual_seed(SEED))
        out['loss'].backward()
        return out

    for m, dev in ((model, 'cuda'), (cpu_model, 'cpu')):
        fa.reset_launches()
        outs.append(step(m, dev))
        if dev == 'cuda':
            torch.cuda.synchronize()
            launches = {k: fa.LAUNCHES[k] for k in TRAIN_KERNELS}
    if any(v != n_blocks for v in launches.values()):
        raise RuntimeError(f'14c: launches {launches} in one step, expected '
                           f'{n_blocks} each')
    for k in ('loss', 'loss_rnnt', 'loss_att', 'loss_ctc', 'th_accuracy'):
        a, w = outs[0][k].item(), outs[1][k].item()
        if not abs(a - w) <= 1e-4 * abs(w) + 1e-6:
            raise RuntimeError(f'14c: {k} card {a} cpu {w} beyond rtol 1e-4')
    worst, worst_of_bar, largest = 0.0, 0.0, (0.0, '')
    # the tensors past a flat 1e-3, each with its share of its largest
    # (a share over all tensors would be led by the key biases, whose
    # gradients are 0 but for rounding: softmax ignores a shift)
    above = []
    cpu_params = dict(cpu_model.named_parameters())
    for name, p in model.named_parameters():
        if p.grad is None or not torch.isfinite(p.grad).all():
            raise RuntimeError(f'14c: {name} has no finite gradient')
        want = cpu_params[name].grad
        err = (p.grad.cpu() - want).abs().max().item()
        bar = 1e-3 + ZOO_GRAD_RTOL * want.abs().max().item()
        if err > bar:
            raise RuntimeError(f'14c: {name} grad differs from the CPU by '
                               f'{err} (bar {bar:.3g})')
        worst, worst_of_bar = max(worst, err), max(worst_of_bar, err / bar)
        largest = max(largest, (want.abs().max().item(), name))
        if err > 1e-3:
            top = want.abs().max().item()
            above.append(f'{name} {err:.3g} ({err / top:.2e} of its largest '
                         f'{top:.3g})')
    print(f'  rnnt train step B={B} x {seconds:.0f} s, dynamic chunk, '
          f'dropout 0: loss card {outs[0]["loss"].item():.6f} cpu '
          f'{outs[1]["loss"].item():.6f}, loss_rnnt card '
          f'{outs[0]["loss_rnnt"].item():.6f} cpu '
          f'{outs[1]["loss_rnnt"].item():.6f} (rtol 1e-4); '
          f'{len(cpu_params)} grads, max |card - cpu| {worst:.3g} '
          f'({"within" if worst <= 1e-3 else "above"} 6c\'s 1e-3), at most '
          f'{100 * worst_of_bar:.0f}% of 12c\'s bar; the largest |grad| '
          f'{largest[0]:.3g} ({largest[1]}); above 1e-3: '
          f'{"; ".join(above) or "none"}; launches {launches}',
          flush=True)
    # the loss's share of the step's kernel time, both profiled
    tb = to_device_batch(b, 'cuda')
    _, step_ms, step_wall = search_launches(lambda: step(model, 'cuda'))
    with torch.no_grad():
        eo, em = model.encoder(tb['feats'], tb['feats_lengths'])
        ys = add_blank(tb['target'], model.blank, model.ignore_id)
        logits = model.joint(eo, model.predictor(ys))
    labels = tb['target'].masked_fill(tb['target'] < 0, model.blank)
    logits.requires_grad_()
    n, loss_ms, loss_wall = search_launches(
        lambda: rnnt_loss_logits(logits, labels, em[:, 0].sum(-1),
                                 tb['target_lengths']).backward())
    print(f'    the RNN-T loss alone at the step\'s lattice '
          f'{tuple(logits.shape)}: {loss_ms:.2f} ms of kernel time '
          f'({n} launches) in {loss_wall:.1f} ms, of the step\'s '
          f'{step_ms:.2f} ms of kernel time in {step_wall:.1f} ms: '
          f'{100 * loss_ms / step_ms:.1f}% of the kernel time, '
          f'{100 * loss_wall / step_wall:.1f}% of the wall time '
          f'(profiled; {smi})', flush=True)
    del logits
    bf16 = step(model, 'cuda', torch.bfloat16)
    rel = abs(bf16['loss'].item() - outs[0]['loss'].item()) / abs(
        outs[0]['loss'].item())
    if not np.isfinite(bf16['loss'].item()) or rel > RNNT_BF16_RTOL:
        raise RuntimeError(f'14c: bf16 loss {bf16["loss"].item()} against '
                           f'fp32 {outs[0]["loss"].item()} (bar '
                           f'{RNNT_BF16_RTOL})')
    print(f'    bf16 autocast step: loss {bf16["loss"].item():.6f}, '
          f'{rel:.2e} from fp32 (bar {RNNT_BF16_RTOL:g}), loss_rnnt '
          f'{bf16["loss_rnnt"].item():.6f}', flush=True)
    del model, cpu_model
    torch.cuda.empty_cache()
    return launches, {'loss_kernel_share': loss_ms / step_ms,
                      'loss_wall_share': loss_wall / step_wall,
                      'bf16_loss_rtol': rel}


def rnnt_recipe_check(smi):
    """14d: compute_cmvn_stats, bin/train.py (2 epochs on 10's written
    recipe, a profiler window), average_model, then bin/recognize.py in
    RNNT_MODES on the average: card == CPU by rnnt_compare's tie rule ->
    ({kernel: launches}, readings)."""
    from wenet_tpu_torch.bin import (average_model, compute_cmvn_stats,
                                     recognize, train)
    from wenet_tpu_torch.ops import flash_attention as fa
    from wenet_tpu_torch.utils.checkpoint import load_model
    tokenizer = flagship_tokenizer()
    d = tempfile.mkdtemp(prefix='chip_smoke_rnnt_')
    units, train_list, cv_list, scp, train_wavs = write_recipe(d, tokenizer)
    cmvn = os.path.join(d, 'global_cmvn')
    compute_cmvn_stats.main(['--train_config', RNNT_CONFIG, '--in_scp', scp,
                             '--out_cmvn', cmvn])
    exp = os.path.join(d, 'exp')
    argv = ['--config', RNNT_CONFIG, '--train_data', train_list,
            '--cv_data', cv_list, '--data_type', 'shard', '--model_dir', exp,
            '--seed', str(SEED), '--device', 'cuda',
            '--override_config', f'tokenizer_conf.symbol_table_path {units}',
            '--override_config', f'cmvn_conf.cmvn_file {cmvn}',
            '--override_config', 'max_epoch 2',
            '--override_config', 'log_interval 1',
            '--override_config', f'encoder_conf.num_blocks {RNNT_DEPTH}',
            '--profile_dir', os.path.join(d, 'profile'),
            '--profile_start_step', '1', '--profile_steps', '3']
    records = []
    fa.reset_launches()
    summary = train.main(argv, on_step=records.append)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    n_blocks = rnnt_configs()['encoder_conf']['num_blocks']
    for name in TRAIN_KERNELS:
        if launches[name] != n_blocks * len(records):
            raise RuntimeError(f'14d: {name} {launches[name]} launches over '
                               f'{len(records)} steps, expected {n_blocks} '
                               'a step')
    epochs = summary['epochs']
    if not all(np.isfinite(e['cv']['loss_rnnt']) for e in epochs):
        raise RuntimeError('14d: cv loss_rnnt not finite')
    counts, busy = trace_readings(summary['profile_trace'])
    train_rate = (sum(e['audio_seconds'] for e in epochs) /
                  sum(e['train_seconds'] for e in epochs))
    for e in epochs:
        print(f'  bin/train.py epoch {e["epoch"]}: {e["steps"]} steps in '
              f'{e["train_seconds"]:.2f} s, '
              f'{e["audio_seconds"] / e["train_seconds"]:.1f} audio-sec/s; '
              f'cv loss {e["cv"]["loss"]:.4f}, loss_rnnt '
              f'{e["cv"]["loss_rnnt"]:.4f} ({smi})', flush=True)
    print(f'    steps B x T: '
          + ', '.join(f'{r["batch"]}x{r["frames"]}' for r in records)
          + f'; profiled steps 2-4: launches {counts}, card busy '
          f'{100 * busy:.1f}% of the traced span; {launches}', flush=True)
    avg = os.path.join(d, 'avg_2.pt')
    chosen = average_model.main(['--src_path', exp, '--dst_model', avg,
                                 '--num', '2', '--val_best'])
    if len(chosen) != 2:
        raise RuntimeError('14d: average_model did not average two epochs')
    paths = {'train.yaml': os.path.join(exp, 'train.yaml'), 'final.pt': avg}
    n_all, n_cpu = RNNT_RECOGNIZE
    for name, n in (('rnnt.list', n_all), ('rnnt_cpu.list', n_cpu)):
        paths[name] = os.path.join(d, name)
        with open(paths[name], 'w', encoding='utf-8') as f:
            for i, w in enumerate(train_wavs[RECIPE_8K:RECIPE_8K + n]):
                f.write(json.dumps({'key': f'r{i:02d}', 'wav': w,
                                    'txt': ''}) + '\n')
    rates = {}
    for mode in RNNT_MODES:
        fa.reset_launches()
        _, rsum = recognize_main(paths, [mode], os.path.join(d, mode),
                                 'rnnt.list', 'cuda')
        torch.cuda.synchronize()
        if fa.LAUNCHES['relpos_attention_fwd'] != n_blocks:
            raise RuntimeError(f'14d recognize {mode}: '
                               f'{fa.LAUNCHES["relpos_attention_fwd"]} K1 '
                               f'launches for one batch')
        launches['relpos_attention_fwd'] += n_blocks
        rates[mode] = rsum['audio_seconds'] / rsum['seconds']
    print(f'  bin/recognize.py --device cuda, {n_all} wavs a mode: '
          + ', '.join(f'{m} {r:.1f} audio-sec/s' for m, r in rates.items())
          + f' ({smi})', flush=True)
    # the card's recognize in every mode at once; the CPU's reference is
    # rnnt_compare's one decode of the same batch
    fa.reset_launches()
    texts = recognize_main(paths, RNNT_MODES, os.path.join(d, 'all_cuda'),
                           'rnnt_cpu.list', 'cuda')[0]
    torch.cuda.synchronize()
    k1 = fa.LAUNCHES['relpos_attention_fwd']
    if k1 != n_blocks:
        raise RuntimeError(f'14d recognize {RNNT_MODES}: {k1} K1 launches '
                           'for one batch')
    launches['relpos_attention_fwd'] += k1
    args = recognize.get_parser().parse_args([
        '--config', paths['train.yaml'], '--test_data',
        paths['rnnt_cpu.list'], '--checkpoint', avg, *RECOGNIZE_ARGS,
        '--result_dir', d, '--device', 'cpu'])
    configs, tok, _, dataset, cpu_runner = recognize.build(args)
    (batch,) = list(dataset)
    card_model = load_model(configs, avg, 'cuda')
    got, want, _, flips, errs = rnnt_compare(
        '14d', card_model, cpu_runner.model, batch['feats'],
        batch['feats_lengths'].astype(np.int64),
        dict(beam_size=10, ctc_weight=0.3, reverse_weight=0.5))
    same = {}
    for mode in RNNT_MODES:
        entry = {k: tok.detokenize(r.tokens)[0]
                 for k, r in zip(batch['keys'], got[mode])}
        if entry != texts[mode]:
            raise RuntimeError(f'14d: recognize {mode} on the card wrote '
                               'other text than its runner decodes')
        same[mode] = sum(g.tokens == w.tokens
                         for g, w in zip(got[mode], want[mode]))
    # rescoring: card against the CPU's own decode, at the zoo's ties; the
    # rnnt searches are held to the CPU on the card's encoder output
    if n_cpu - same['attention_rescoring'] > flips['attention_rescoring']:
        raise RuntimeError('14d: recognize attention_rescoring differs from '
                           'the CPU beyond the ties')
    chars = {m: sum(len(t) for t in texts[m].values()) for m in RNNT_MODES}
    print(f'  recognize on {n_cpu} wavs: each text the card runner\'s; '
          f'equal to the CPU runner\'s '
          + ', '.join(f'{m} {same[m]}/{n_cpu}' for m in RNNT_MODES)
          + f'; ties {flips}; the rnnt searches = the CPU\'s on the card\'s '
          f'encoder output (encoder card - CPU {errs["enc_err"]:.3g}, beam '
          f'scores within {errs["beam_gap"]:.3g}); chars {chars}',
          flush=True)
    import shutil
    shutil.rmtree(d)
    return launches, {'train_audio_sec_per_s': train_rate,
                      'train_busy': busy, 'recognize_audio_sec_per_s': rates}


def transducer_check(smi):
    """Phase 14 -> ({kernel name: launches}, readings)."""
    phase('14 transducer (rnnt yaml, full width): decode, loss, train step, '
          'recipe')
    launches = {name: 0 for name in ('relpos_attention_fwd',
                                     *TRAIN_KERNELS)}
    phase('14a decode, card vs CPU')
    k1, decode = rnnt_decode_check(smi)
    launches['relpos_attention_fwd'] += k1
    phase('14b RNN-T loss, card vs CPU vs float64')
    loss = rnnt_loss_check(smi)
    phase('14c one train step, card vs CPU; bf16')
    step_launches, step = rnnt_step_check(smi)
    for k, v in step_launches.items():
        launches[k] += v
    phase('14d the recipe: cmvn, train, average, recognize')
    recipe_launches, recipe = rnnt_recipe_check(smi)
    for k in launches:
        launches[k] += recipe_launches[k]
    return launches, {'decode': decode, 'loss': loss, 'step': step,
                      'recipe': recipe}


# ---------------------------------------------------------------------------
# 15. whisper large-v3 through the recipe's entry points
# ---------------------------------------------------------------------------
WHISPER_RECIPE_LAYERS = 2  # encoder and decoder blocks, by --override_config
WHISPER_RECIPE_UTTS = (20, 4)  # train, cv wavs
WHISPER_RECIPE_SECONDS = (12.0, 28.0)
WHISPER_RECIPE_DECODE = (16, 4)  # wavs recognized on the card, and the CPU
WHISPER_RECIPE_BATCH = 4
WHISPER_RECIPE_BEAM = 5
WHISPER_RECIPE_MAX_TOKENS = 100  # the calibrated eot ends every beam by then
WHISPER_BASE_RANKS = 50257  # large-v3's text ranks: 51866 with the specials
WHISPER_RANK_MERGES = 600  # learned from the corpus; unreachable fillers after
WHISPER_TOKENIZER_LINES = 200
ZH_CHARS = [chr(c) for c in range(0x4e00, 0x4e00 + 600)]
EN_WORDS = ['the', 'speech', 'model', "it's", "we're", "don't", 'train',
            'data', 'hello', 'world', 'one', 'two', 'three', "they'll",
            'Recognition', 'GPU', 'test']


def zh_en_lines(rng, n):
    """`n` seeded transcripts: CJK chars, English words with contractions,
    numbers and punctuation."""
    tails = ['', '.', '?', '!', ', 12', ' 2024.', '，好。']
    return [''.join(rng.choice(ZH_CHARS, size=rng.randint(4, 17))) + ' ' +
            ' '.join(rng.choice(EN_WORDS, size=rng.randint(2, 7))) +
            tails[rng.randint(len(tails))] for _ in range(n)]


def learn_byte_ranks(lines, n_merges):
    """Byte-level BPE ranks: the 256 bytes, then `n_merges` merges of the
    most frequent adjacent pair (ties to the larger pair) over the pieces
    the whisper pattern splits `lines` into -> {bytes: rank}."""
    import collections
    from wenet_tpu_torch.text.whisper_tokenizer import pre_split
    words = collections.Counter()
    for line in lines:
        for piece in pre_split(line):
            words[tuple(bytes([b]) for b in piece.encode('utf-8'))] += 1
    ranks = {bytes([b]): b for b in range(256)}
    for _ in range(n_merges):
        pairs = collections.Counter()
        for w, c in words.items():
            for pair in zip(w, w[1:]):
                pairs[pair] += c
        if not pairs:
            break
        (a, b), _ = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
        ranks.setdefault(a + b, len(ranks))
        merged = collections.Counter()
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and w[i] == a and w[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += c
        words = merged
    return ranks


def whisper_tokenizer_check(d, smi):
    """15a: a rank file of large-v3's 50257 text ranks (the bytes, merges
    learned from a seeded zh/en corpus, unique fillers no text reaches:
    0xff never occurs in UTF-8) through the port's WhisperTokenizer:
    51866 tokens, large-v3's special tokens, decode(encode(line)) == line
    on 200 seeded lines -> (the rank file, the tokenizer)."""
    import base64
    from wenet_tpu_torch.models.whisper.convert import default_special_tokens
    from wenet_tpu_torch.text.whisper_tokenizer import WhisperTokenizer
    rng = np.random.RandomState(SEED + 40)
    t0 = time.perf_counter()
    ranks = learn_byte_ranks(zh_en_lines(rng, 300), WHISPER_RANK_MERGES)
    merges = len(ranks) - 256
    i = 0
    while len(ranks) < WHISPER_BASE_RANKS:
        ranks[b'\xff' + i.to_bytes(3, 'big')] = len(ranks)
        i += 1
    path = os.path.join(d, 'multilingual.tiktoken')
    with open(path, 'wb') as f:
        for tok, r in sorted(ranks.items(), key=lambda kv: kv[1]):
            f.write(base64.b64encode(tok) + b' ' + str(r).encode() + b'\n')
    learn_s = time.perf_counter() - t0
    tok = WhisperTokenizer(vocab_path=path)
    if tok.vocab_size() != WHISPER_V3['n_vocab']:
        raise RuntimeError(f'15a: vocab_size {tok.vocab_size()}')
    if tok.special_tokens != default_special_tokens(WHISPER_V3['n_vocab']):
        raise RuntimeError('15a: special tokens differ from large-v3\'s')
    lines = zh_en_lines(rng, WHISPER_TOKENIZER_LINES)
    t0 = time.perf_counter()
    ids = [tok.text2tokens(line) for line in lines]
    encode_s = time.perf_counter() - t0
    bad = [line for line, x in zip(lines, ids) if tok.tokens2text(x) != line]
    if bad:
        raise RuntimeError(f'15a: decode(encode(line)) != line: {bad[:2]}')
    n_ids = sum(len(x) for x in ids)
    n_chars = sum(len(line) for line in lines)
    print(f'  rank file: 256 bytes, {merges} merges, '
          f'{WHISPER_BASE_RANKS - 256 - merges} fillers ({learn_s:.1f} s); '
          f'vocab {tok.vocab_size()}, large-v3\'s special tokens; '
          f'{len(lines)} lines round trip ({n_chars} chars -> {n_ids} ids); '
          f'encode {len(lines) / encode_s:.0f} lines/s (host)', flush=True)
    return path, tok, dict(encode_lines_per_s=len(lines) / encode_s,
                           ids_per_char=n_ids / n_chars)


def whisper_recipe_yaml(d, rank_file):
    """finetune_whisper_largev3.yaml with whisper's log-mel front end and a
    blank id, as models/whisper/convert.py `build_config` writes them: as
    written the yaml sets no feats_type (both packages then make a 23-bin
    fbank for its 128-bin input), its log-mel conf names frame_shift and
    frame_length, which compute_log_mel_spectrogram does not take, and it
    has no ctc_conf.ctc_blank_id, which get_blank_id asserts."""
    import yaml
    from wenet_tpu_torch.models.whisper.convert import default_special_tokens
    with open(FINETUNE_CONFIG) as f:
        configs = yaml.safe_load(f)
    configs['dataset_conf'].update(
        feats_type='log_mel_spectrogram',
        log_mel_spectrogram_conf={'n_fft': 400, 'hop_length': 160,
                                  'num_mel_bins': WHISPER_V3['n_mels'],
                                  'padding': 0})
    configs['ctc_conf'] = {'ctc_blank_id': default_special_tokens(
        WHISPER_V3['n_vocab'])['no_speech']}
    path = os.path.join(d, 'finetune_whisper_largev3.yaml')
    with open(path, 'w') as f:
        yaml.safe_dump(configs, f)
    return path


def whisper_recipe_train(d, rank_file, smi):
    """15b: 24 wavs of 12-28 s with zh/en transcripts in local tar shards,
    a random checkpoint (8b's weights: the decoder shaped, lora_B drawn),
    the entry point's first step card == CPU, bin/train.py for two
    epochs (accum_grad 1, a profiler window), average_model --num 2
    --val_best -> (the run's train.yaml, the average, the wavs, launches,
    readings)."""
    from wenet_tpu_torch.bin import average_model, train
    from wenet_tpu_torch.dataset.audio import write_wav
    from wenet_tpu_torch.ops import flash_attention as fa
    from wenet_tpu_torch.utils.checkpoint import save_checkpoint
    rng = np.random.RandomState(SEED + 41)
    entries = []
    texts = zh_en_lines(rng, sum(WHISPER_RECIPE_UTTS))
    for i in range(sum(WHISPER_RECIPE_UTTS)):
        path = os.path.join(d, f'w{i:02d}.wav')
        write_wav(path, speech_like(rng, rng.uniform(
            *WHISPER_RECIPE_SECONDS)), SR)
        entries.append({'key': f'w{i:02d}', 'wav': path, 'txt': texts[i]})
    n_train = WHISPER_RECIPE_UTTS[0]
    train_list = write_shards(d, 'train', entries[:n_train], 4)
    cv_list = write_shards(d, 'cv', entries[n_train:], 1)
    yaml_path = whisper_recipe_yaml(d, rank_file)
    n = WHISPER_RECIPE_LAYERS
    model = whisper_train_model(finetune_configs(n),
                                torch.Generator().manual_seed(SEED), 'cpu')
    init = os.path.join(d, 'init.pt')
    save_checkpoint(model, init)
    del model
    exp = os.path.join(d, 'exp')
    argv = ['--config', yaml_path, '--train_data', train_list, '--cv_data',
            cv_list, '--data_type', 'shard', '--model_dir', exp,
            '--checkpoint', init, '--seed', str(SEED), '--device', 'cuda',
            '--override_config', f'encoder_conf.num_blocks {n}',
            '--override_config', f'decoder_conf.num_blocks {n}',
            '--override_config', f'tokenizer_conf.vocab_path {rank_file}',
            '--override_config', 'max_epoch 2',
            '--override_config', 'accum_grad 1',
            '--override_config', 'log_interval 1',
            '--profile_dir', os.path.join(d, 'profile'),
            '--profile_start_step', '1', '--profile_steps', '3']
    entry_first_step(train.get_parser().parse_args(argv))
    records = []
    fa.reset_launches()
    summary, losses = logged_train(train, argv, records.append)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    epochs = summary['epochs']
    for name in FLASH_TRAIN_KERNELS:
        if launches[name] != n * len(records):
            raise RuntimeError(f'15b: {name} {launches[name]} launches over '
                               f'{len(records)} steps, expected {n} a step')
    if launches['flash_attention_fwd'] == 0 or \
            launches['flash_attention_fwd'] % n:
        raise RuntimeError(f'15b: cv launched K4 '
                           f'{launches["flash_attention_fwd"]} times')
    if len(losses) != len(records) or not np.isfinite(losses).all() or \
            not all(np.isfinite(e['cv']['loss']) for e in epochs):
        raise RuntimeError(f'15b: losses {losses}')
    _, busy = trace_readings(summary['profile_trace'], keys=())
    rate = (sum(e['audio_seconds'] for e in epochs) /
            sum(e['train_seconds'] for e in epochs))
    for e in epochs:
        print(f'  bin/train.py epoch {e["epoch"]}: {e["steps"]} steps in '
              f'{e["train_seconds"]:.2f} s, '
              f'{e["audio_seconds"] / e["train_seconds"]:.1f} audio-sec/s, '
              f'data wait {e["data_wait_seconds"]:.2f} s; cv loss '
              f'{e["cv"]["loss"]:.4f} ({smi})', flush=True)
    print(f'    steps B x T: ' + ', '.join(
        f'{r["batch"]}x{r["frames"]}' for r in records) +
        f'; losses {[round(x, 3) for x in losses]}; each step {n} launches '
        f'of K4-train, K5, K6 (counted); K4 in cv '
        f'{launches["flash_attention_fwd"]}; card busy {100 * busy:.1f}% of '
        f'the profiled steps 2-4', flush=True)
    avg = os.path.join(d, 'avg_2.pt')
    chosen = average_model.main(['--src_path', exp, '--dst_model', avg,
                                 '--num', '2', '--val_best'])
    state = torch.load(avg, weights_only=True)
    lora = [k for k in state if k.endswith(('.lora_A', '.lora_B'))]
    if len(chosen) != 2 or len(lora) != 2 * 4 * n:
        raise RuntimeError(f'15b: average of {chosen} holds {len(lora)} LoRA '
                           'tensors')
    print(f'  average_model --num 2 --val_best: {len(lora)} LoRA tensors')
    return (os.path.join(exp, 'train.yaml'), avg,
            [e['wav'] for e in entries], launches,
            dict(train_audio_sec_per_s=rate, train_busy=busy,
                 steps=len(records)))


def whisper_recipe_recognize(d, config, avg, wavs, smi):
    """15c: the eot bias of the average calibrated (7b's rule) on the
    decode set, then bin/recognize.py --modes attention on the card (16
    wavs, B=4) and on the CPU (its first batch), without and with
    --timestamps: text and segments of the 8 equal, K4 4 launches a
    batch -> (K4 launches, readings)."""
    import re
    from wenet_tpu_torch.bin import recognize
    from wenet_tpu_torch.ops import flash_attention as fa
    n_card, n_cpu = WHISPER_RECIPE_DECODE
    lists = {}
    for name, k in (('card', n_card), ('cpu', n_cpu)):
        lists[name] = os.path.join(d, f'decode_{name}.list')
        with open(lists[name], 'w') as f:
            f.writelines(json.dumps({'key': f'd{i:02d}', 'wav': w,
                                     'txt': ''}) + '\n'
                         for i, w in enumerate(wavs[:k]))
    base = ['--config', config, '--beam_size', str(WHISPER_RECIPE_BEAM),
            '--modes', 'attention']
    args = recognize.get_parser().parse_args(base + [
        '--test_data', lists['card'], '--checkpoint', avg, '--batch_size',
        str(n_card), '--result_dir', d, '--device', 'cuda'])
    _, _, _, dataset, runner = recognize.build(args)
    (batch,) = list(dataset)
    with torch.inference_mode():
        eo, em = runner.model.forward_encoder(
            torch.from_numpy(batch['feats']).cuda(),
            torch.from_numpy(batch['feats_lengths']).cuda())
    infos = {'langs': batch['langs'], 'tasks': batch['tasks']}
    bias = calibrate_eot_bias(runner.model, eo, em, WHISPER_RECIPE_BEAM,
                              (infos, dict(infos, no_timestamp=False)),
                              high=WHISPER_RECIPE_MAX_TOKENS)
    eot = runner.model.eos
    del runner, eo, em
    torch.cuda.empty_cache()
    state = torch.load(avg, weights_only=True)
    state['decoder.output_layer.bias'][eot] = bias
    ckpt = os.path.join(d, 'avg_eot.pt')
    torch.save(state, ckpt)
    n = WHISPER_RECIPE_LAYERS
    batches = -(-n_card // WHISPER_RECIPE_BATCH)
    out, launches, readings = {}, 0, {}
    for ts in (False, True):
        extra = ['--timestamps'] if ts else []
        for dev in ('cuda', 'cpu'):
            res = os.path.join(d, f'{dev}_{int(ts)}')
            argv = base + extra + [
                '--test_data', lists['card' if dev == 'cuda' else 'cpu'],
                '--checkpoint', ckpt, '--batch_size',
                str(WHISPER_RECIPE_BATCH), '--result_dir', res,
                '--device', dev]
            fa.reset_launches()
            if dev == 'cuda':
                summary, busy, _ = busy_share(lambda: recognize.main(argv))
                torch.cuda.synchronize()
                k4 = fa.LAUNCHES['flash_attention_fwd']
                if k4 != n * batches:
                    raise RuntimeError(f'15c: K4 {k4} launches over {batches} '
                                       f'batches, expected {n} a batch')
                launches += k4
                rate = summary['audio_seconds'] / summary['seconds']
                readings['timestamps' if ts else 'text'] = dict(
                    audio_sec_per_s=rate, busy=busy)
            else:
                recognize.main(argv)
            files = {}
            for name in ('text', 'segments') if ts else ('text',):
                with open(os.path.join(res, 'attention', name),
                          encoding='utf-8') as f:
                    files[name] = f.read()
            out[dev, ts] = files
        for name, card in out['cuda', ts].items():
            # the lists' order: the CPU's utterances lead the card's, and
            # a decoded text may hold a line break of its own
            cpu = out['cpu', ts][name]
            rest = re.match(r'd(\d\d) ', card[len(cpu):])
            if not card.startswith(cpu) or (
                    len(card) > len(cpu) and
                    (rest is None or int(rest.group(1)) < n_cpu)):
                raise RuntimeError(f'15c: {name} (timestamps {ts}) on the '
                                   'card differs from the CPU\'s')
        text = out['cuda', ts]['text']
        chars = len(text) - sum(len(f'd{i:02d} \n') for i in range(n_card))
        segs = len(re.findall(r'^d\d\d \d', out['cuda', ts].get(
            'segments', ''), re.M))
        r = readings['timestamps' if ts else 'text']
        print(f'  bin/recognize.py --modes attention'
              f'{" --timestamps" if ts else ""}: {n_card} texts '
              f'({chars} chars{f", {segs} segments" if ts else ""}), the '
              f'first {n_cpu} equal to the CPU\'s (text'
              f'{" and segments" if ts else ""}); K4 {n} launches a batch; '
              f'{r["audio_sec_per_s"]:.1f} audio-sec/s, card busy '
              f'{100 * r["busy"]:.1f}% (profiled; {smi})', flush=True)
    readings['eot_bias'] = bias
    return launches, readings


def whisper_recipe_check(smi):
    """Phase 15 -> ({kernel name: launches}, readings)."""
    phase('15 whisper large-v3 through the recipe (4 + 4 layers): '
          'tokenizer, train, average, recognize')
    import shutil
    d = tempfile.mkdtemp(prefix='chip_smoke_whisper_recipe_')
    phase('15a the whisper tokenizer')
    rank_file, _, tok_readings = whisper_tokenizer_check(d, smi)
    phase('15b bin/train.py, average_model')
    config, avg, wavs, launches, train = whisper_recipe_train(d, rank_file,
                                                              smi)
    phase('15c bin/recognize.py, card vs CPU, with and without timestamps')
    k4, decode = whisper_recipe_recognize(d, config, avg, wavs, smi)
    launches = {name: launches[name] for name in (
        'flash_attention_fwd', *FLASH_TRAIN_KERNELS)}
    launches['flash_attention_fwd'] += k4
    shutil.rmtree(d)
    return launches, dict(tokenizer=tok_readings, train=train, decode=decode)


PARAFORMER_CONFIG = os.path.join(REPO, 'examples/aishell/paraformer/conf/'
                                 'train_paraformer.yaml')
PARAFORMER_VOCAB = 4233  # aishell's lang_char.txt
# phase 16's paraformer blocks, encoder and decoder (the yaml's 50 + 16),
# for the script's time
PARAFORMER_DEPTH = (25, 8)
PARAFORMER_K4_SHAPE = (32, 4, 500, 500, 128, 'pad', False)  # 16b's decode
PARAFORMER_TRAIN_SHAPE = (2, 4, 534, 534, 128, 'pad', None)  # 2 x 32 s
PARAFORMER_DECODE = (32, 20.0, 30.0)  # 16b: B, shortest, longest seconds
PARAFORMER_DECODE_CPU = 4  # 16b: the rows decoded on the CPU too
PARAFORMER_MODES = ['paraformer_greedy_search', 'paraformer_beam_search']
PARAFORMER_LONG_STEP = (2, 31.9, 32.05)  # 16c: B, seconds (534 LFR frames)
# 16c's CIF threshold: in training the alphas are scaled to integrate to
# the label count, so at the yaml's 1.0 the last token fires or not on
# the float32 rounding of that total, which differs between the card and
# the CPU; 0.9999 puts the fire 1e-4 clear of it (ROADMAP.md queue 3)
PARAFORMER_TRAIN_THRESHOLD = 0.9999
TOKEN_SUM_BAND = 1e-4  # ⌊token sum⌋ may move where the sum is this near
PEAK_TIE = 1e-4  # a CIF peak trace this near its threshold may move
PARAFORMER_RECIPE_UTTS = (24, 6)  # train, cv wavs
PARAFORMER_RECIPE_SECONDS = (3.0, 12.0)
PARAFORMER_RECOGNIZE = (16, 8)  # 16d: wavs on the card, and the CPU
PARAFORMER_RECOGNIZE_SECONDS = (20.0, 30.0)
EN_PIECES = {'hello': 'he@@ llo', 'world': 'wor@@ ld', 'speech': 'spe@@ ech'}
# 16e: FunASR SenseVoice-small's and FireRed-AED-L's published widths at
# a reduced depth
SENSEVOICE_SMALL = dict(output_size=512, attention_heads=4, linear_units=2048,
                        num_blocks=50, tp_blocks=20, kernel_size=11,
                        sanm_shfit=0, dropout_rate=0.1,
                        positional_dropout_rate=0.1,
                        attention_dropout_rate=0.1)
SENSEVOICE_VOCAB = 25055
SENSEVOICE_DEPTH = (6, 2)  # num_blocks, tp_blocks (of 50, 20)
FIRERED_AED_L = dict(d_model=1280, n_head=20, d_inner=5120, n_layers_enc=16,
                     n_layers_dec=16, kernel_size=33, odim=7832)
FIRERED_DEPTH = (4, 2)  # encoder, decoder blocks (of 16, 16)
REDUCED_DECODE = {'sensevoice': (32, 20.0, 30.0), 'firered': (4, 2.0, 3.0)}
REDUCED_CPU = 4


def paraformer_configs(**model_conf):
    """The paraformer yaml at its widths (512, 4 heads: d = 128) and
    PARAFORMER_DEPTH blocks (of 50 + 16), with input_dim (80 mel bins x
    lfr_m 7) and the aishell vocabulary's output_dim."""
    import yaml
    with open(PARAFORMER_CONFIG) as f:
        configs = yaml.safe_load(f)
    configs['input_dim'], configs['output_dim'] = 80 * 7, PARAFORMER_VOCAB
    configs['model_conf'].update(model_conf)
    at_depth(configs, PARAFORMER_DEPTH)
    return configs


def at_depth(configs, depth):
    """Set the encoder's and decoder's blocks to `depth`'s (encoder,
    decoder), in place (a SAN-M decoder's cross-attention blocks too)."""
    configs['encoder_conf']['num_blocks'] = depth[0]
    configs['decoder_conf']['num_blocks'] = depth[1]
    if 'att_layer_num' in configs['decoder_conf']:
        configs['decoder_conf']['att_layer_num'] = depth[1]


def set_lfr_cmvn(cmvn, feats, lens):
    """The global cmvn of the LFR features of (feats, lens)."""
    from wenet_tpu_torch.models.paraformer.layers import lfr
    x, n = lfr(torch.from_numpy(feats), torch.from_numpy(lens))
    valid = torch.arange(x.shape[1])[None, :] < n[:, None]
    rows = x[valid].double()
    with torch.no_grad():
        cmvn.mean.copy_(rows.mean(0).float())
        cmvn.istd.copy_((1.0 / rows.std(0).clamp(min=1e-3)).float())


def paraformer_kernel_check():
    """16a: K4 at the decode's shape, K4-train, K5 and K6 at the
    long-form step's, fp32 and bf16 -> readings by kernel."""
    phase('16a K4, K4-train, K5, K6 at head dim 128 (paraformer shapes)')
    rng = np.random.RandomState(SEED + 61)
    report = {'flash_attention_fwd': {}}
    report.update({n: {} for n in FLASH_TRAIN_KERNELS})
    shape = '(' + ','.join(map(str, PARAFORMER_K4_SHAPE[:5])) + ') pad'
    for dtype in (torch.float32, torch.bfloat16):
        key = '' if dtype == torch.float32 else '_bf16'
        r = k4_case(rng, *PARAFORMER_K4_SHAPE, dtype)
        report['flash_attention_fwd'].update(
            {k + key: v for k, v in r.items()}, shape=shape)
    shape = '(' + ','.join(map(str, PARAFORMER_TRAIN_SHAPE[:5])) + ') pad'
    for dtype in (torch.float32, torch.bfloat16):
        key = '' if dtype == torch.float32 else '_bf16'
        errs, shares, t, bounds, sdpa, tflops, _ = flash_train_case(
            rng, *PARAFORMER_TRAIN_SHAPE, dtype)
        for i, n in enumerate(FLASH_TRAIN_KERNELS):
            report[n].update({
                'max_abs_err' + key: errs[n], 'share_of_bar' + key: shares[n],
                'ms' + key: t[n][0], 'plain_ms' + key: t[n][1],
                'bound_ms' + key: bounds[n][0], 'bound_by' + key: bounds[n][1],
                'library_ms' + key: sdpa[0 if i == 0 else 1],
                'tflops' + key: tflops[i]}, shape=shape)
    return report


def sanm_blocks(model):
    """(encoder blocks, decoder blocks): the K4 launches of a decode above
    the gate are their sum (each encoder block's self-attention, each
    decoder block's cross-attention, whose queries are the encoder-frame
    cap), of a training step the first (the decoder's queries are the
    labels, below it)."""
    return (len(model.encoder.encoders0) + len(model.encoder.encoders),
            len(model.decoder.decoders))


def token_sums(model, feats, lens):
    """The unfloored token counts of a decode: the CIF alphas' sum with
    the tail slot."""
    cif = model.predictor.predictor
    with torch.inference_mode():
        enc, mask = model._forward_encoder_lfr(feats, lens)
        alphas = cif.compute_alphas(enc, mask)
        return cif.tail_process_fn(enc, alphas, mask)[1].sum(-1).cpu()


def paraformer_same(what, got, want, card, cpu):
    """Raise unless the card's paraformer results (`got`, from
    forward_paraformer's `card` dict, rows cut to the CPU's) equal the
    CPU's (`want`, `cpu`), up to what float32 noise explains: a row's
    token count ⌊sum⌋ may differ where the CPU's sum lies within
    TOKEN_SUM_BAND of an integer (the row is then not compared further);
    a position's argmax may differ where the CPU's top two log-probs lie
    within twice that position's largest |card - cpu| log-prob; the
    greedy search's peak times may differ from the first frame whose CPU
    trace lies within PEAK_TIE of the peak threshold; a beam score lies
    within the summed largest log-prob differences + 2e-4.  -> counts of
    the rows in the band, the flipped argmaxes and the moved peaks."""
    n = len(want[PARAFORMER_MODES[0]])
    lp_c = card['decoder_out'][:n].float().cpu()
    lp_p = cpu['decoder_out'].float()
    lens_c = card['decoder_out_lens'][:n].cpu()
    lens_p = cpu['decoder_out_lens']
    sums = cpu['token_sums']
    U = min(lp_c.shape[1], lp_p.shape[1])
    diff = (lp_c[:, :U] - lp_p[:, :U]).abs().amax(-1)
    band = flips = moved = 0
    for b in range(n):
        k = int(lens_p[b])
        if int(lens_c[b]) != k:
            if abs(float(sums[b]) - round(float(sums[b]))) > TOKEN_SUM_BAND:
                raise RuntimeError(f'{what}: row {b} has {int(lens_c[b])} '
                                   f'tokens on the card, {k} on the CPU '
                                   f'(sum {float(sums[b]):.6f})')
            band += 1
            continue
        bound = float(diff[b, :k].sum()) + 2e-4
        for mode in PARAFORMER_MODES:
            g, w = got[mode][b], want[mode][b]
            if list(g.tokens) != list(w.tokens):
                pos = [i for i in range(k) if g.tokens[i] != w.tokens[i]]
                top = lp_p[b, pos].topk(2, dim=-1).values
                if not bool((top[:, 0] - top[:, 1] <=
                             2 * diff[b, pos]).all()):
                    raise RuntimeError(f'{what}: {mode} row {b} differs at '
                                       f'{pos[:5]} beyond a tie')
                flips += len(pos) if mode == PARAFORMER_MODES[0] else 0
            elif mode == 'paraformer_beam_search' and \
                    abs(g.score - w.score) > bound:
                raise RuntimeError(f'{what}: beam score {g.score} vs '
                                   f'{w.score} (bound {bound:.3g})')
        g, w = got[PARAFORMER_MODES[0]][b], want[PARAFORMER_MODES[0]][b]
        if g.times != w.times:
            i = next(i for i, (x, y) in enumerate(zip(g.times, w.times))
                     if x != y)
            trace = cpu['peaks'][b]
            near = [f for f in (g.times[i], w.times[i])
                    if abs(float(trace[f]) - (1 - 1e-4)) <= PEAK_TIE]
            if not near:
                raise RuntimeError(f'{what}: row {b} peak times differ at '
                                   f'token {i}: {g.times[i]} vs '
                                   f'{w.times[i]}')
            moved += 1
    return dict(band=band, flips=flips, moved_peaks=moved)


def paraformer_forward(model, feats, lens):
    """forward_paraformer and the CIF peak trace (host), with the token
    sums."""
    with torch.inference_mode():
        res = model.forward_paraformer(feats, lens)
        res['peaks'] = model.forward_cif_peaks(
            res['tp_alphas'].float().cpu(),
            res['decoder_out_lens'].cpu())
    res['token_sums'] = token_sums(model, feats, lens)
    return res


def paraformer_decode_check(smi):
    """16b: the paraformer yaml at full width decodes B=32 x 20-30 s in
    both paraformer modes on the card (a K4 launch a block) against the
    CPU on 4 rows; speed, busy share and the CIF loop's launches and
    time."""
    phase('16b paraformer decode, B=32 x 20-30 s, card vs CPU')
    from wenet_tpu_torch.models.runner import AsrRunner, paraformer_decode
    from wenet_tpu_torch.ops import flash_attention as fa
    from wenet_tpu_torch.utils.init_model import init_model
    configs = paraformer_configs()
    t0 = time.perf_counter()
    model = init_model(configs, torch.Generator('cuda').manual_seed(
        SEED + 62), device='cuda').eval()
    B, shortest, longest = PARAFORMER_DECODE
    feats, lens = speech_features(np.random.RandomState(SEED + 63), B,
                                  shortest, longest)
    set_lfr_cmvn(model.encoder.global_cmvn, feats, lens)
    enc, dec = configs['encoder_conf'], configs['decoder_conf']
    print(f'  {enc["num_blocks"]} + {dec["num_blocks"]} blocks of '
          f'{enc["output_size"]} ({enc["attention_heads"]} heads, d = '
          f'{enc["output_size"] // enc["attention_heads"]}) built on the '
          f'card in {time.perf_counter() - t0:.1f} s '
          f'({sum(p.numel() for p in model.parameters()) / 1e6:.1f}M '
          f'parameters); features {tuple(feats.shape)}', flush=True)
    runner = AsrRunner(model, 'cuda')
    x, n_x = torch.from_numpy(feats).cuda(), torch.from_numpy(lens).cuda()
    runner.decode(PARAFORMER_MODES, x, n_x)  # warm-up
    torch.cuda.synchronize()
    fa.reset_launches()
    got = runner.decode(PARAFORMER_MODES, x, n_x)
    torch.cuda.synchronize()
    k4 = fa.LAUNCHES['flash_attention_fwd']
    blocks = sanm_blocks(model)
    if k4 != sum(blocks):
        raise RuntimeError(f'16b: K4 launched {k4} times in a decode, '
                           f'expected {sum(blocks)}')
    card = paraformer_forward(model, x, n_x)
    n = PARAFORMER_DECODE_CPU
    cpu_model = copy.deepcopy(model).cpu()
    xc, nc = torch.from_numpy(feats[:n]), torch.from_numpy(lens[:n])
    with torch.inference_mode():
        want = paraformer_decode(cpu_model, xc, nc, PARAFORMER_MODES)
    cpu = paraformer_forward(cpu_model, xc, nc)
    enc_err = max((card['encoder_out'][b, :int(l)].cpu() -
                   cpu['encoder_out'][b, :int(l)]).abs().max().item()
                  for b, l in enumerate(cpu['encoder_out_mask'][:, 0].sum(-1)))
    if enc_err > 1e-3:
        raise RuntimeError(f'16b: encoder output {enc_err} from the CPU')
    ties = paraformer_same('16b', {m: got[m][:n] for m in got}, want, card,
                           cpu)
    lens_c = card['decoder_out_lens'].cpu()
    sums = card['token_sums']
    near = int(((sums - sums.round()).abs() <= TOKEN_SUM_BAND).sum())
    print(f'  {B} rows: tokens {int(lens_c.min())}-{int(lens_c.max())} a '
          f'row; K4 {k4} launches a decode ({blocks[0]} encoder, '
          f'{blocks[1]} cross-attention)'
          f'; encoder output within {enc_err:.3g} of the CPU; {n} rows '
          f'card == CPU ({ties["band"]} in the token-count band, '
          f'{ties["flips"]} argmax ties, {ties["moved_peaks"]} moved peaks);'
          f' {near} of {B} card rows within {TOKEN_SUM_BAND} of an integer '
          'token sum', flush=True)
    # speed: the decode end to end, its busy share, the CIF loop
    audio = float(lens.sum()) / 100
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        runner.decode(PARAFORMER_MODES, x, n_x)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps
    _, busy, _ = busy_share(lambda: runner.decode(PARAFORMER_MODES, x, n_x))
    with torch.inference_mode():
        enc, mask = model._forward_encoder_lfr(x, n_x)
        cif = model.predictor.predictor
        cap = enc.shape[1]

        def cif_loop():
            return cif(enc, None, mask, cap)
        cif_loop()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cif_loop()
        torch.cuda.synchronize()
        cif_wall = time.perf_counter() - t0
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            cif_loop()
            torch.cuda.synchronize()
        rows = device_rows(prof)
    cif_launches = sum(c for c, _ in rows.values())
    cif_device = sum(ms for _, ms in rows.values())
    print(f'  decode B={B}: {1e3 * wall:.1f} ms, {audio / wall:.1f} '
          f'audio-sec/s, card busy {100 * busy:.1f}%; the CIF predictor '
          f'({cap} frames + the tail) {1e3 * cif_wall:.1f} ms wall, '
          f'{cif_launches} launches, {cif_device:.2f} ms of kernels ({smi})',
          flush=True)
    del runner, model, cpu_model
    torch.cuda.empty_cache()
    return k4, dict(audio_sec_per_s=audio / wall, ms=1e3 * wall, busy=busy,
                    cif_ms=1e3 * cif_wall, cif_launches=cif_launches,
                    cif_kernel_ms=cif_device, encoder_err=enc_err, **ties)


def paraformer_units(d, rng):
    """lang_char.txt of 4233 symbols (the specials, CJK chars and the
    seg_dict's pieces), seg_dict, and a transcript maker."""
    pieces = sorted({p for v in EN_PIECES.values() for p in v.split()})
    chars = [chr(0x4e00 + i) for i in range(PARAFORMER_VOCAB - 3 -
                                            len(pieces))]
    units = os.path.join(d, 'lang_char.txt')
    with open(units, 'w', encoding='utf-8') as f:
        for i, s in enumerate(['<blank>', '<unk>', '<sos/eos>'] + chars +
                              pieces):
            f.write(f'{s} {i}\n')
    seg = os.path.join(d, 'seg_dict')
    with open(seg, 'w', encoding='utf-8') as f:
        f.writelines(f'{w}\t{p}\n' for w, p in EN_PIECES.items())

    def text(seconds):
        n = int(3 * seconds) + rng.randint(0, 4)
        return (''.join(rng.choice(chars[:600], size=n)) + ' ' +
                rng.choice(list(EN_PIECES)))
    return units, seg, text


def paraformer_recipe(d):
    """16c's files: wavs of 3-12 s with zh/en transcripts (train and cv
    lists), the dict and seg_dict, a 560-dim cmvn (the 80-bin stats of
    compute_cmvn_stats tiled over the 7 stacked frames, written as
    FunASR's am.mvn and converted), and the yaml with them (the CIF
    threshold 0.9999, two epochs, every step logged) -> (yaml, train
    list, cv list)."""
    import yaml
    from wenet_tpu_torch.bin import compute_cmvn_stats
    from wenet_tpu_torch.dataset.audio import write_wav
    from wenet_tpu_torch.models.paraformer.convert import (
        convert_funasr_cmvn)
    rng = np.random.RandomState(SEED + 64)
    units, seg, text = paraformer_units(d, rng)
    entries = []
    for i in range(sum(PARAFORMER_RECIPE_UTTS)):
        seconds = rng.uniform(*PARAFORMER_RECIPE_SECONDS)
        path = os.path.join(d, f'p{i:02d}.wav')
        write_wav(path, speech_like(rng, seconds), SR)
        entries.append({'key': f'p{i:02d}', 'wav': path,
                        'txt': text(seconds)})
    n_train = PARAFORMER_RECIPE_UTTS[0]
    lists = []
    for name, part in (('train', entries[:n_train]),
                       ('cv', entries[n_train:])):
        lists.append(os.path.join(d, f'{name}.list'))
        with open(lists[-1], 'w', encoding='utf-8') as f:
            f.writelines(json.dumps(e, ensure_ascii=False) + '\n'
                         for e in part)
    with open(PARAFORMER_CONFIG) as f:
        configs = yaml.safe_load(f)
    at_depth(configs, PARAFORMER_DEPTH)
    configs['tokenizer_conf'].update(symbol_table_path=units,
                                     seg_dict_path=seg)
    configs['predictor_conf'] = {'threshold': PARAFORMER_TRAIN_THRESHOLD}
    configs['cmvn_conf']['cmvn_file'] = os.path.join(d, 'global_cmvn')
    configs.update(max_epoch=2, log_interval=1)
    path = os.path.join(d, 'train_paraformer.yaml')
    with open(path, 'w') as f:
        yaml.safe_dump(configs, f)
    scp = os.path.join(d, 'wav.scp')
    with open(scp, 'w') as f:
        f.writelines(f'{e["key"]} {e["wav"]}\n' for e in entries[:n_train])
    stats = compute_cmvn_stats.main(['--train_config', path, '--in_scp', scp,
                                     '--out_cmvn', os.path.join(d, 'mel')])
    count = stats['frame_num']
    mean = np.asarray(stats['mean_stat']) / count
    std = np.sqrt(np.maximum(np.asarray(stats['var_stat']) / count -
                             mean ** 2, 1e-20))

    def vec(v):
        return '[ ' + ' '.join(f'{x:.6f}' for x in np.tile(v, 7)) + ' ]'
    with open(os.path.join(d, 'am.mvn'), 'w') as f:
        f.write(f'<Nnet>\n<AddShift> 560 560\n<LearnRateCoef> 0 '
                f'{vec(-mean)}\n<Rescale> 560 560\n<LearnRateCoef> 0 '
                f'{vec(1.0 / std)}\n</Nnet>\n')
    convert_funasr_cmvn(os.path.join(d, 'am.mvn'),
                        os.path.join(d, 'global_cmvn'))
    return path, lists[0], lists[1]


def paraformer_long_step(args, smi):
    """16c: one train step of B=2 x 32 s (534 LFR frames: the encoder's
    self-attention above the gate) on the entry point's model, optimizer
    and step -> {kernel: launches}, readings."""
    from wenet_tpu_torch.bin import train
    from wenet_tpu_torch.ops import flash_attention as fa
    from wenet_tpu_torch.utils.executor import to_device_batch
    run = train.build(args)
    B, shortest, longest = PARAFORMER_LONG_STEP
    rng = np.random.RandomState(SEED + 65)
    feats, lens = speech_features(rng, B, shortest, longest)
    L = 100
    target = rng.randint(3, PARAFORMER_VOCAB - 10, (B, L))
    tl = np.asarray([L, L - 17])
    target = np.where(np.arange(L)[None] < tl[:, None], target, -1)
    batch = to_device_batch(dict(feats=feats, feats_lengths=lens,
                                 target=target, target_lengths=tl), 'cuda')
    T = -(-feats.shape[1] // 6)
    run.train_step(run.state, batch, (args.seed, 0))  # warm-up
    torch.cuda.synchronize()
    fa.reset_launches()
    t0 = time.perf_counter()
    _, metrics = run.train_step(run.state, batch, (args.seed, 0))
    loss = float(metrics['loss'])
    wall = time.perf_counter() - t0
    launches = {n: fa.LAUNCHES[n] for n in FLASH_TRAIN_KERNELS}
    blocks = sanm_blocks(run.model)[0]
    for name, count in launches.items():
        if count != blocks:
            raise RuntimeError(f'16c long-form step: {name} launched {count} '
                               f'times, expected {blocks} (one a SAN-M '
                               'encoder block)')
    if not np.isfinite(loss):
        raise RuntimeError(f'16c long-form step: loss {loss}')
    audio = float(lens.sum()) / 100
    print(f'  long-form step B={B} x {tuple(feats.shape)[1]} frames ({T} LFR '
          f'frames): loss {loss:.4f}, {1e3 * wall:.1f} ms, '
          f'{audio / wall:.1f} audio-sec/s; K4-train, K5, K6 {blocks} '
          f'launches each ({smi})', flush=True)
    of_bar = gate_off_hold(run.model, batch, args.seed, blocks)
    del run
    torch.cuda.empty_cache()
    return launches, dict(long_step_ms=1e3 * wall,
                          long_step_audio_sec_per_s=audio / wall,
                          long_step_grad_share_vs_plain=of_bar)


def gate_off_hold(model, batch, seed, blocks):
    """16c: the long-form batch's loss and gradients through K4-train, K5
    and K6 (`blocks` launches each) against the same forward and backward
    with the flash gate closed (plain attention on the card), the device
    RNG and the host generator seeded alike: every loss term within rtol
    1e-4, every gradient within 1e-3 + GRAD_SHARE x its largest (12c's
    bar) -> the largest share of that bar."""
    from wenet_tpu_torch.models.transformer import attention as A
    from wenet_tpu_torch.ops import flash_attention as fa

    def step(gate_open):
        saved = dict(A.FLASH_GATE)
        if not gate_open:
            A.FLASH_GATE.update(min_len=1 << 40, score_elems=1 << 62)
        try:
            model.train()
            model.zero_grad(set_to_none=True)
            torch.manual_seed(seed)
            out = model(batch['feats'], batch['feats_lengths'],
                        batch['target'], batch['target_lengths'],
                        generator=torch.Generator().manual_seed(seed))
            out['loss'].backward()
        finally:
            A.FLASH_GATE.update(saved)
        losses = {k: v.item() for k, v in out.items()
                  if torch.is_tensor(v) and v.numel() == 1
                  and k != 'th_accuracy'}
        return losses, {n: p.grad.detach().clone()
                        for n, p in model.named_parameters()
                        if p.grad is not None}
    fa.reset_launches()
    losses, grads = step(True)
    torch.cuda.synchronize()
    for name in FLASH_TRAIN_KERNELS:
        if fa.LAUNCHES[name] != blocks:
            raise RuntimeError(f'16c hold: {name} launched '
                               f'{fa.LAUNCHES[name]} times, expected '
                               f'{blocks}')
    plain_losses, plain_grads = step(False)
    for k, w in plain_losses.items():
        if not abs(losses[k] - w) <= 1e-4 * abs(w) + 1e-6:
            raise RuntimeError(f'16c hold: {k} with the kernels '
                               f'{losses[k]}, plain attention {w}, beyond '
                               'rtol 1e-4')
    if set(grads) != set(plain_grads):
        raise RuntimeError('16c hold: the two steps reach different '
                           'parameters')
    worst, worst_name = 0.0, ''
    for name, w in plain_grads.items():
        g = grads[name]
        if not torch.isfinite(g).all():
            raise RuntimeError(f'16c hold: {name} has no finite gradient')
        bar = 1e-3 + GRAD_SHARE * w.abs().max().item()
        share = (g - w).abs().max().item() / bar
        if share > 1.0:
            raise RuntimeError(f'16c hold: {name} grad differs from plain '
                               f'attention by {share * bar:.3g} (bar '
                               f'{bar:.3g})')
        worst, worst_name = max((worst, worst_name), (share, name))
    print(f'    the step with K4-train, K5, K6 against plain attention on '
          f'the card: loss {losses["loss"]:.6f} / '
          f'{plain_losses["loss"]:.6f} (rtol 1e-4); {len(grads)} grads at '
          f'most {100 * worst:.0f}% of 12c\'s bar ({worst_name})',
          flush=True)
    model.zero_grad(set_to_none=True)
    return worst


def paraformer_train_check(d, smi):
    """16c: the recipe's stages 1 (cmvn), 4 (bin/train.py, two epochs) and
    5 (average_model) on the yaml at full width: the entry point's first
    step card == CPU, finite losses, the long-form step's launches."""
    phase('16c paraformer bin/train.py (full width), average_model')
    from wenet_tpu_torch.bin import average_model, train
    config, train_list, cv_list = paraformer_recipe(d)
    exp = os.path.join(d, 'exp')
    argv = ['--config', config, '--train_data', train_list, '--cv_data',
            cv_list, '--model_dir', exp, '--seed', str(SEED),
            '--device', 'cuda', '--profile_dir', os.path.join(d, 'profile'),
            '--profile_start_step', '1', '--profile_steps', '2']
    args = train.get_parser().parse_args(argv)
    entry_first_step(args)
    records = []
    summary, losses = logged_train(train, argv, records.append)
    epochs = summary['epochs']
    if len(losses) != len(records) or not np.isfinite(losses).all() or \
            not all(np.isfinite(e['cv']['loss']) for e in epochs):
        raise RuntimeError(f'16c: losses {losses}')
    _, busy = trace_readings(summary['profile_trace'], keys=())
    rate = (sum(e['audio_seconds'] for e in epochs) /
            sum(e['train_seconds'] for e in epochs))
    for e in epochs:
        print(f'  bin/train.py epoch {e["epoch"]}: {e["steps"]} steps in '
              f'{e["train_seconds"]:.2f} s, '
              f'{e["audio_seconds"] / e["train_seconds"]:.1f} audio-sec/s, '
              f'data wait {e["data_wait_seconds"]:.2f} s; cv loss '
              f'{e["cv"]["loss"]:.4f} ({smi})', flush=True)
    print('    steps B x T: ' + ', '.join(
        f'{r["batch"]}x{r["frames"]}' for r in records) +
        f'; losses {[round(x, 3) for x in losses]}; card busy '
        f'{100 * busy:.1f}% of the profiled steps 2-3', flush=True)
    avg = os.path.join(d, 'avg_2.pt')
    chosen = average_model.main(['--src_path', exp, '--dst_model', avg,
                                 '--num', '2', '--val_best'])
    if len(chosen) != 2:
        raise RuntimeError(f'16c: average of {chosen}')
    launches, long_step = paraformer_long_step(args, smi)
    return (os.path.join(exp, 'train.yaml'), avg, launches,
            dict(train_audio_sec_per_s=rate, train_busy=busy,
                 steps=len(records), **long_step))


def paraformer_recognize_check(d, config, avg, smi):
    """16d: bin/recognize.py in both paraformer modes on the average over
    16 written wavs of 20-32 s in batches of 8 (each batch's longest 32
    s: 534 LFR frames, so the encoder and the cross-attention take K4),
    on the card, and on the CPU over the first batch: the texts equal, or
    a row that differs explained by 16b's rule on that batch -> (K4
    launches, readings)."""
    phase('16d paraformer bin/recognize.py, card vs CPU')
    from wenet_tpu_torch.bin import recognize
    from wenet_tpu_torch.dataset.audio import write_wav
    from wenet_tpu_torch.models.runner import paraformer_decode
    from wenet_tpu_torch.ops import flash_attention as fa
    n_card, n_cpu = PARAFORMER_RECOGNIZE
    rng = np.random.RandomState(SEED + 68)
    lists = {'card': os.path.join(d, 'decode.list'),
             'cpu': os.path.join(d, 'decode_cpu.list')}
    lines = []
    for i in range(n_card):
        path = os.path.join(d, f'd{i:02d}.wav')
        seconds = PARAFORMER_LONG_STEP[2] if i % n_cpu == 0 else \
            rng.uniform(*PARAFORMER_RECOGNIZE_SECONDS)
        write_wav(path, speech_like(rng, seconds), SR)
        lines.append(json.dumps({'key': f'd{i:02d}', 'wav': path,
                                 'txt': ''}) + '\n')
    for name, k in (('card', n_card), ('cpu', n_cpu)):
        with open(lists[name], 'w') as f:
            f.writelines(lines[:k])
    texts, argv = {}, {}
    for name, dev in (('card', 'cuda'), ('cpu', 'cpu')):
        res = os.path.join(d, f'recognize_{name}')
        argv[name] = ['--config', config, '--test_data', lists[name],
                      '--checkpoint', avg, '--batch_size', str(n_cpu),
                      '--result_dir', res, '--device', dev,
                      '--modes', *PARAFORMER_MODES]
        if name == 'card':
            fa.reset_launches()
            summary, busy, _ = busy_share(lambda: recognize.main(
                argv['card']))
            k4 = fa.LAUNCHES['flash_attention_fwd']
            rate = summary['audio_seconds'] / summary['seconds']
            batches = n_card // n_cpu
            configs = paraformer_configs()
            want_k4 = (configs['encoder_conf']['num_blocks'] +
                       configs['decoder_conf']['num_blocks'])
            if k4 != want_k4 * batches:
                raise RuntimeError(f'16d: K4 {k4} launches over {batches} '
                                   f'batches, expected {want_k4} a batch')
        else:
            recognize.main(argv['cpu'])
        for mode in PARAFORMER_MODES:
            with open(os.path.join(res, mode, 'text'),
                      encoding='utf-8') as f:
                texts[name, mode] = dict(line.rstrip('\n').partition(' ')[::2]
                                        for line in f)
    differ = sorted({k for m in PARAFORMER_MODES
                     for k, v in texts['cpu', m].items()
                     if texts['card', m][k] != v})
    ties = {}
    if differ:
        # the CPU's batch, the card's first, through 16b's rule
        _, _, _, dataset, runner = recognize.build(
            recognize.get_parser().parse_args(argv['cpu']))
        batch = next(iter(dataset))
        x, n = (torch.from_numpy(batch[k])
                for k in ('feats', 'feats_lengths'))
        cpu = paraformer_forward(runner.model, x, n)
        with torch.inference_mode():
            want = paraformer_decode(runner.model, x, n, PARAFORMER_MODES)
        card_model = copy.deepcopy(runner.model).cuda()
        card = paraformer_forward(card_model, x.cuda(), n.cuda())
        with torch.inference_mode():
            got = paraformer_decode(card_model, x.cuda(), n.cuda(),
                                    PARAFORMER_MODES)
        ties = paraformer_same('16d', got, want, card, cpu)
        del card_model
    nonempty = sum(bool(v) for v in texts['card', PARAFORMER_MODES[0]]
                   .values())
    if nonempty < n_card // 2:
        raise RuntimeError(f'16d: {nonempty} of {n_card} texts non-empty')
    print(f'  bin/recognize.py --modes {" ".join(PARAFORMER_MODES)}: '
          f'{n_card} texts ({nonempty} non-empty), the first {n_cpu} equal '
          f'to the CPU\'s but {differ} {ties}; K4 {k4} launches; '
          f'{rate:.1f} audio-sec/s, card busy {100 * busy:.1f}% '
          f'(profiled; {smi})', flush=True)
    return k4, dict(audio_sec_per_s=rate, busy=busy, differ=len(differ))


def reduced_configs(name):
    """16e: SenseVoice-small (models/sensevoice/convert.py's config of
    FunASR's encoder) and FireRed-AED-L at their published widths,
    reduced depth."""
    if name == 'sensevoice':
        from wenet_tpu_torch.models.sensevoice.convert import build_config
        enc = dict(SENSEVOICE_SMALL, selfattention_layer_type='sanm',
                   pos_enc_class='SinusoidalPositionEncoder')
        enc['num_blocks'], enc['tp_blocks'] = SENSEVOICE_DEPTH
        configs = build_config({'encoder_conf': enc}, 'bpe.model')
        configs['output_dim'] = SENSEVOICE_VOCAB
        configs['cmvn'] = 'global_cmvn'
        return configs
    f = FIRERED_AED_L
    return {
        'input_dim': 80, 'output_dim': f['odim'],
        'encoder': 'firered_conformer',
        'encoder_conf': {'output_size': f['d_model'],
                         'attention_heads': f['n_head'],
                         'linear_units': f['d_inner'],
                         'num_blocks': FIRERED_DEPTH[0],
                         'cnn_module_kernel': f['kernel_size'],
                         'dropout_rate': 0.1},
        'decoder': 'transformer',
        'decoder_conf': {'attention_heads': f['n_head'],
                         'linear_units': f['d_inner'],
                         'num_blocks': FIRERED_DEPTH[1]},
        'model': 'firered', 'model_conf': {'ctc_weight': 0.0},
        'cmvn': 'global_cmvn',
        'tokenizer_conf': {'special_tokens': {'sos': 3, 'eos': 4}},
    }


def reduced_decode_check(smi):
    """16e: SenseVoice-small (CTC greedy, K4 once a SAN-M block at B=32 x
    20-30 s) and FireRed-AED-L (the attention beam search, beam 3; its
    rel-pos attention is plain, as the JAX package's) at a reduced depth,
    card vs CPU on 4 rows -> (K4 launches, readings)."""
    phase('16e SenseVoice-small and FireRed-AED-L (reduced depth), card '
          'vs CPU')
    from wenet_tpu_torch.models.runner import AsrRunner
    from wenet_tpu_torch.ops import flash_attention as fa
    from wenet_tpu_torch.utils.init_model import init_model
    total_k4, readings = 0, {}
    for name, mode in (('sensevoice', 'ctc_greedy_search'),
                       ('firered', 'attention')):
        configs = reduced_configs(name)
        model = init_model(configs, torch.Generator('cuda').manual_seed(
            SEED + 66), device='cuda').eval()
        B, shortest, longest = REDUCED_DECODE[name]
        feats, lens = speech_features(np.random.RandomState(SEED + 67), B,
                                      shortest, longest)
        cmvn = model.global_cmvn if name == 'sensevoice' else \
            model.encoder.global_cmvn
        if name == 'sensevoice':
            set_lfr_cmvn(cmvn, feats, lens)
        else:
            rows = torch.from_numpy(np.concatenate(
                [f[:n] for f, n in zip(feats, lens)])).double()
            with torch.no_grad():
                cmvn.mean.copy_(rows.mean(0).float())
                cmvn.istd.copy_((1 / rows.std(0)).float())
        n = REDUCED_CPU
        cpu_model = copy.deepcopy(model).cpu()
        x, n_x = torch.from_numpy(feats).cuda(), torch.from_numpy(lens).cuda()
        fa.reset_launches()
        t0 = time.perf_counter()
        got = AsrRunner(model, 'cuda').decode([mode], x, n_x, beam_size=3)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k4 = fa.LAUNCHES['flash_attention_fwd']
        want_k4 = sum(SENSEVOICE_DEPTH) if name == 'sensevoice' else 0
        if k4 != want_k4:
            raise RuntimeError(f'16e {name}: K4 {k4} launches, expected '
                               f'{want_k4}')
        total_k4 += k4
        want = AsrRunner(cpu_model, 'cpu').decode(
            [mode], feats[:n], lens[:n], beam_size=3)
        with torch.inference_mode():
            eo, em = model.forward_encoder(x[:n], n_x[:n])
            ceo, cem = cpu_model.forward_encoder(torch.from_numpy(
                feats[:n]), torch.from_numpy(lens[:n]))
            err = max((eo[b, :int(l)].cpu() - ceo[b, :int(l)]).abs().max()
                      .item() for b, l in enumerate(cem[:, 0].sum(-1)))
            logp, clogp = (m.ctc_logprobs(e).float().cpu()
                           for m, e in ((model, eo), (cpu_model, ceo)))
        if err > 1e-3:
            raise RuntimeError(f'16e {name}: encoder output {err} from the '
                               'CPU')
        flips = 0
        for b, (g, w) in enumerate(zip(got[mode][:n], want[mode])):
            if list(g.tokens) == list(w.tokens):
                continue
            if mode == 'ctc_greedy_search':
                valid = torch.arange(logp.shape[1]) < int(cem[b, 0].sum())
                diff = (logp[b] - clogp[b]).abs().amax(-1)
                frames = (logp[b].argmax(-1) != clogp[b].argmax(-1)) & valid
                top = clogp[b].topk(2, dim=-1).values
                ok = bool((top[frames, 0] - top[frames, 1] <=
                           2 * diff[frames]).all())
            else:
                ok = abs(g.score - w.score) <= DECODER_TOKEN_TIE * (
                    len(g.tokens) + 1)
            if not ok:
                raise RuntimeError(f'16e {name}: {mode} row {b} differs '
                                   'from the CPU beyond a tie')
            flips += 1
        audio = float(lens.sum()) / 100
        print(f'  {name}: {sum(p.numel() for p in model.parameters()) / 1e6:.1f}'
              f'M parameters, {mode} B={B}: {1e3 * wall:.1f} ms, '
              f'{audio / wall:.1f} audio-sec/s; K4 {k4} launches; encoder '
              f'within {err:.3g} of the CPU; {n} rows card == CPU '
              f'({flips} ties); hypothesis lengths '
              f'{[len(r.tokens) for r in got[mode][:n]]} ({smi})', flush=True)
        readings[name] = dict(audio_sec_per_s=audio / wall, encoder_err=err,
                              ties=flips)
        del model, cpu_model
        torch.cuda.empty_cache()
    return total_k4, readings


def paraformer_check(smi):
    """Phase 16b-e (16a, `paraformer_kernel_check`, times its kernels
    alone) -> ({kernel name: launches}, readings)."""
    phase('16 paraformer (examples/aishell/paraformer), SenseVoice-small, '
          'FireRed')
    import shutil
    k4, decode = paraformer_decode_check(smi)
    d = tempfile.mkdtemp(prefix='chip_smoke_paraformer_')
    config, avg, launches, train = paraformer_train_check(d, smi)
    k4_rec, recognize = paraformer_recognize_check(d, config, avg, smi)
    k4_red, reduced = reduced_decode_check(smi)
    shutil.rmtree(d)
    launches['flash_attention_fwd'] = k4 + k4_rec + k4_red
    return launches, dict(decode=decode, train=train, recognize=recognize,
                          reduced=reduced)


# --- 17: SSL pretraining (BEST-RQ) and k2 (LF-MMI, HLG) --------------------
BESTRQ_CONFIG = os.path.join(REPO, 'examples/librispeech/ssl/conf/'
                             'train_bestrq.yaml')
BESTRQ_STEP = (8, 6.0, 12.0)  # 17a: B, shortest and longest seconds
BESTRQ_RECIPE_UTTS = (24, 4)  # train, cv wav-only wavs
BESTRQ_RECIPE_SECONDS = (3.0, 12.0)
BESTRQ_FIT = (20, 1e-3)  # 17a: steps on one batch, Adam's lr
CODE_BAND = 1e-5  # a frame's best two code distances this near may swap
GRAD_SHARE = 2e-4  # 12c's bar: 1e-3 + this share of a tensor's largest
K2_STEP = (4, 12.0)  # 17b: B x seconds
K2_DEN_TEXTS = 300  # transcripts of 17b's den graph
DEN_RTOL = 1e-5
HLG_UTTS = (8, 5.0, 15.0)  # 17c: wavs, shortest and longest seconds
# 17c's lexicon (the chars the head ranks most often, and words of two of
# them) and bigram text: the plain Python searcher visits every arc of
# every active state, so the graph stays small (42 words under a 3-gram,
# 4212 states, took 384 s over 17c's wavs, measured on one H100)
HLG_CHARS, HLG_TWO_CHAR_WORDS, HLG_SENTENCES = 20, 20, 100
HLG_MODES = ['hlg_onebest', 'hlg_rescore', 'attention_rescoring']
HLG_ARGS = ['--batch_size', '8', '--beam_size', '10', '--ctc_weight', '0.3',
            '--reverse_weight', '0.5', '--lm_scale', '0.7',
            '--decoder_scale', '0.1', '--r_decoder_scale', '0.7']


def bestrq_configs(num_blocks=None, dropout=True):
    """The BEST-RQ yaml as written (80-bin fbank, output_dim 1: the SSL
    heads do not read it); dropout=False sets the encoder's dropouts to 0;
    `num_blocks` cuts its depth."""
    import yaml
    with open(BESTRQ_CONFIG) as f:
        configs = yaml.safe_load(f)
    configs['input_dim'], configs['output_dim'] = 80, 1
    if not dropout:
        for key in configs['encoder_conf']:
            if key.endswith('dropout_rate'):
                configs['encoder_conf'][key] = 0.0
    if num_blocks:
        configs['encoder_conf']['num_blocks'] = num_blocks
    return configs


def ssl_model(configs):
    """The configs' SSL model on the CPU, weights and buffers from SEED."""
    from wenet_tpu_torch.utils.init_model import init_model
    return init_model(configs, torch.Generator().manual_seed(SEED),
                      device='cpu')


def pad_to(feats, multiple):
    """feats (B, T, F) zero-padded to a multiple of `multiple` frames, as
    the yaml's pad_conf pads a batch."""
    T = -(-feats.shape[1] // multiple) * multiple
    return np.pad(feats, ((0, 0), (0, T - feats.shape[1]), (0, 0)))


def code_band(model, cpu_model, x, lens):
    """The target codes of the unmasked features on the card and the CPU,
    over the valid stacks: {frames, in_band (the best two distances, in
    float64 on the CPU's projection, within CODE_BAND), differ,
    differ_outside (of the band)}."""
    from wenet_tpu_torch.utils.mask import make_pad_mask
    codes, z = [], None
    with torch.no_grad():
        for m, dev in ((model, 'cuda'), (cpu_model, 'cpu')):
            xs, ls = x.to(dev), lens.to(dev)
            stacked = m._stack_features(xs, make_pad_mask(ls, xs.shape[1]))
            codes.append(m._nearest_embedding_idx(stacked).cpu())
            if dev == 'cpu':
                z = stacked.double() @ m.projection.double()
                z = z / (z.norm(dim=-1, keepdim=True) + 1e-8)
        book = cpu_model.embeddings.double()  # (C, G, d)
        B, n, _ = z.shape
        lat = z.reshape(B * n, book.shape[1], -1)
        dist = (lat.pow(2).sum(-1, keepdim=True) -
                2 * torch.einsum('ngd,cgd->ngc', lat, book) +
                book.permute(1, 0, 2).pow(2).sum(-1)[None])
        top2 = dist.topk(2, dim=-1, largest=False).values
        in_band = (top2[..., 1] - top2[..., 0] <= CODE_BAND).reshape(
            B, n, -1)
    stride = cpu_model.stride
    valid = (torch.arange(n)[None, :] + 1) * stride <= lens[:, None]
    differ = (codes[0] != codes[1]) & valid[..., None]
    return dict(frames=int(valid.sum()) * codes[0].shape[-1],
                in_band=int((in_band & valid[..., None]).sum()),
                differ=int(differ.sum()),
                differ_outside=int((differ & ~in_band).sum()))


def bestrq_step_pair(model, cpu_model, feats, lens):
    """One BEST-RQ forward and backward on the card (`model`) and on the
    CPU, on the same host draws (from SEED) and padded batch -> ([card
    out, cpu out] as floats, the codes' band readings)."""
    x, ls = torch.from_numpy(feats), torch.from_numpy(lens)
    n_win = (x.shape[1] - model.stack_frames) // model.stride + 1
    draws = model.host_draws(x.shape[0], n_win,
                             torch.Generator().manual_seed(SEED))
    outs = []
    for m, dev in ((model, 'cuda'), (cpu_model, 'cpu')):
        m.train()
        m.zero_grad(set_to_none=True)
        out = m(x.to(dev), ls.to(dev), draws=draws,
                generator=torch.Generator().manual_seed(SEED))
        out['loss'].backward()
        outs.append({k: float(v) for k, v in out.items()})
    torch.cuda.synchronize()
    return outs, code_band(model, cpu_model, x, ls)


@contextlib.contextmanager
def float64_casts():
    """Within: `Tensor.float` leaves a float64 tensor in float64 (the
    losses' and the attention's float32 casts), for float64 references."""
    to_float = torch.Tensor.float
    torch.Tensor.float = (lambda t, *a, **k: t if t.dtype == torch.float64
                          else to_float(t, *a, **k))
    try:
        yield
    finally:
        torch.Tensor.float = to_float


def float64_grads(model, run):
    """The parameter gradients of `run(m)` (a forward and backward on the
    CPU) on a float64 copy of `model` under `float64_casts`: the exact
    gradients a float32 one is held to."""
    m = copy.deepcopy(model).double()
    with float64_casts():
        run(m)
    return {n: p.grad for n, p in m.named_parameters() if p.grad is not None}


def hold_gradients(what, model, cpu_model, exact=None):
    """Every parameter's gradient on the card within 1e-3 + GRAD_SHARE x
    its largest of the CPU's (12c's bar), finite.  Where a tensor misses
    it and `exact` is given (a function -> `float64_grads`), the card is
    held to the float64 gradient instead: within the bar plus the CPU's
    own float32 error there (17b: on one large accumulation, the first
    subsampling conv's weight, the CPU's float32 sits at 43% of the bar
    from float64 and cuDNN's at 105%; ROADMAP.md queue 3) -> (the worst
    gap, its share of its bar, the largest gradient and its name,
    [(name, |card - cpu|, |card - float64|, |cpu - float64|, bar)] of the
    tensors so held)."""
    worst, worst_of_bar, largest = 0.0, 0.0, (0.0, '')
    cpu_params = dict(cpu_model.named_parameters())
    held, grads64 = [], None
    for name, p in model.named_parameters():
        want = cpu_params[name].grad
        if p.grad is None or want is None or \
                not torch.isfinite(p.grad).all():
            raise RuntimeError(f'{what}: {name} has no finite gradient')
        got = p.grad.cpu()
        err = (got - want).abs().max().item()
        top = want.abs().max().item()
        bar = 1e-3 + GRAD_SHARE * top
        if err > bar:
            if exact is None:
                raise RuntimeError(f'{what}: {name} grad differs from the '
                                   f'CPU by {err} (bar {bar:.3g})')
            grads64 = grads64 if grads64 is not None else exact()
            g64 = grads64[name]
            card64 = (got.double() - g64).abs().max().item()
            cpu64 = (want.double() - g64).abs().max().item()
            held.append((name, err, card64, cpu64, bar))
            if card64 > bar + cpu64:
                raise RuntimeError(
                    f'{what}: {name} grad differs from the CPU by {err} and '
                    f'from float64 by {card64}, beyond the bar {bar:.3g} + '
                    f'the CPU\'s own {cpu64:.3g}')
            err, bar = card64, bar + cpu64
        worst, worst_of_bar = max(worst, err), max(worst_of_bar, err / bar)
        largest = max(largest, (top, name))
    return worst, worst_of_bar, largest, held


def bestrq_step_check(smi):
    """17a: one train step of the yaml at full width (12 blocks of 256, 8192
    codes) on the card against the CPU at dropout 0, B=8 x 6-12 s padded
    to 64 frames, one set of host draws: loss rtol 1e-4, gradients 12c's
    bar, codes equal outside CODE_BAND, 12 launches of K1-train, K2 and
    K3; then BESTRQ_FIT steps of Adam on the batch must lower the loss ->
    (launches, readings)."""
    phase('17a BEST-RQ train step (examples/librispeech/ssl), card vs CPU')
    from wenet_tpu_torch.ops import flash_attention as fa
    configs = bestrq_configs(dropout=False)
    cpu_model = ssl_model(configs)
    model = copy.deepcopy(cpu_model).cuda()
    B, shortest, longest = BESTRQ_STEP
    feats, lens = speech_features(np.random.RandomState(SEED + 70), B,
                                  shortest, longest)
    feats = pad_to(feats, configs['dataset_conf']['pad_conf'][
        'pad_to_multiple'])
    n_blocks = configs['encoder_conf']['num_blocks']
    fa.reset_launches()
    outs, band = bestrq_step_pair(model, cpu_model, feats, lens)
    launches = {k: fa.LAUNCHES[k] for k in TRAIN_KERNELS}
    if any(v != n_blocks for v in launches.values()):
        raise RuntimeError(f'17a: launches {launches} in one step, '
                           f'expected {n_blocks} each')
    for k in ('loss', 'features_l2', 'num_codes'):
        a, w = outs[0][k], outs[1][k]
        if not abs(a - w) <= 1e-4 * abs(w) + 1e-6:
            raise RuntimeError(f'17a: {k} card {a} cpu {w} beyond rtol 1e-4')
    worst, of_bar, largest, _ = hold_gradients('17a', model, cpu_model)
    if band['differ_outside']:
        raise RuntimeError(f'17a: {band["differ_outside"]} target codes '
                           f'differ outside the {CODE_BAND} band: {band}')
    print(f'  BEST-RQ step B={B} x {feats.shape[1]} frames (pad 64), '
          f'dropout 0: loss card {outs[0]["loss"]:.6f} cpu '
          f'{outs[1]["loss"]:.6f} (rtol 1e-4), codes_acc card '
          f'{outs[0]["codes_acc"]:.4f} cpu {outs[1]["codes_acc"]:.4f}, '
          f'num_codes {outs[0]["num_codes"]:.0f}; grads max |card - cpu| '
          f'{worst:.3g}, at most {100 * of_bar:.0f}% of 12c\'s bar (largest '
          f'{largest[0]:.3g}, {largest[1]}); target codes: '
          f'{band["frames"]} frames, {band["in_band"]} within the '
          f'{CODE_BAND} band, {band["differ"]} differ card vs CPU (all '
          f'inside it); launches {launches} ({smi})', flush=True)
    del cpu_model
    # BESTRQ_FIT steps of Adam on this batch and these draws
    steps, lr = BESTRQ_FIT
    opt = torch.optim.Adam([p for p in model.parameters()
                            if p.requires_grad], lr=lr)
    x, ls = torch.from_numpy(feats).cuda(), torch.from_numpy(lens).cuda()
    n_win = (x.shape[1] - model.stack_frames) // model.stride + 1
    draws = model.host_draws(B, n_win, torch.Generator().manual_seed(SEED))
    losses = []
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        out = model(x, ls, draws=draws,
                    generator=torch.Generator().manual_seed(SEED + i))
        out['loss'].backward()
        opt.step()
        losses.append(float(out['loss']))
    fit = {k: fa.LAUNCHES[k] for k in TRAIN_KERNELS}
    if not losses[-1] < losses[0] or not np.isfinite(losses).all():
        raise RuntimeError(f'17a: {steps} steps on one batch: losses '
                           f'{losses}')
    if any(v != n_blocks * (1 + steps) for v in fit.values()):
        raise RuntimeError(f'17a: launches {fit} over {1 + steps} steps')
    print(f'  {steps} Adam steps (lr {lr}) on the batch: loss '
          f'{losses[0]:.4f} -> {losses[-1]:.4f}; launches since the '
          f'step {fit}', flush=True)
    del model, opt
    torch.cuda.empty_cache()
    return fit, dict(loss=outs[0]['loss'], codes=band, grad_gap=worst,
                     fit_losses=(losses[0], losses[-1]))


def bestrq_recipe(d):
    """17a's files: wav-only data lists (no txt) of BESTRQ_RECIPE_UTTS
    speech-like wavs of 3-12 s and the yaml with two epochs, every step
    logged -> (yaml, train list, cv list, the train audio seconds)."""
    import yaml
    from wenet_tpu_torch.dataset.audio import write_wav
    rng = np.random.RandomState(SEED + 71)
    entries, seconds = [], 0.0
    for i in range(sum(BESTRQ_RECIPE_UTTS)):
        s = rng.uniform(*BESTRQ_RECIPE_SECONDS)
        seconds += s if i < BESTRQ_RECIPE_UTTS[0] else 0.0
        path = os.path.join(d, f's{i:02d}.wav')
        write_wav(path, speech_like(rng, s), SR)
        entries.append({'key': f's{i:02d}', 'wav': path})
    lists = []
    n = BESTRQ_RECIPE_UTTS[0]
    for name, part in (('train', entries[:n]), ('cv', entries[n:])):
        lists.append(os.path.join(d, f'{name}.list'))
        with open(lists[-1], 'w') as f:
            f.writelines(json.dumps(e) + '\n' for e in part)
    configs = bestrq_configs()
    del configs['input_dim'], configs['output_dim']
    configs.update(max_epoch=2, log_interval=1)
    path = os.path.join(d, 'train_bestrq.yaml')
    with open(path, 'w') as f:
        yaml.safe_dump(configs, f)
    return path, lists[0], lists[1], seconds


def bestrq_train_check(smi):
    """17a: bin/train.py with `dataset: ssl` over two epochs of the wav-only
    list (the yaml's pipeline: dither, shuffle, sort, dynamic batches of
    18000 frames, pad 64), a profiler window: finite losses and cv, 12
    launches of K1-train, K2 and K3 a step, 12 of K1 a cv batch, both
    epoch checkpoints with the quantizer's buffers as initialized ->
    (launches, readings)."""
    phase('17a BEST-RQ bin/train.py (dataset: ssl, wav-only list)')
    import shutil
    from wenet_tpu_torch.bin import train
    from wenet_tpu_torch.ops import flash_attention as fa
    n_blocks = bestrq_configs()['encoder_conf']['num_blocks']
    d = tempfile.mkdtemp(prefix='chip_smoke_bestrq_')
    config, train_list, cv_list, _ = bestrq_recipe(d)
    exp = os.path.join(d, 'exp')
    argv = ['--config', config, '--train_data', train_list, '--cv_data',
            cv_list, '--model_dir', exp, '--seed', str(SEED), '--device',
            'cuda', '--profile_dir', os.path.join(d, 'profile'),
            '--profile_start_step', '1', '--profile_steps', '1']
    records = []
    fa.reset_launches()
    summary, losses = logged_train(train, argv, records.append)
    launches = dict(fa.LAUNCHES)
    epochs = summary['epochs']
    steps = len(records)
    if not steps or len(losses) != steps or not np.isfinite(losses).all() \
            or not all(np.isfinite(e['cv']['loss']) for e in epochs):
        raise RuntimeError(f'17a bin/train.py: losses {losses}, '
                           f'{steps} steps')
    for k in TRAIN_KERNELS:
        if launches[k] != n_blocks * steps:
            raise RuntimeError(f'17a bin/train.py: {k} {launches[k]} '
                               f'launches over {steps} steps')
    k1 = launches['relpos_attention_fwd']
    if k1 % n_blocks or k1 < n_blocks * len(epochs):
        raise RuntimeError(f'17a bin/train.py: K1 {k1} launches in cv, '
                           f'not {n_blocks} a cv batch')
    init = None
    for e in epochs:
        state = torch.load(os.path.join(exp, f'epoch_{e["epoch"]}.pt'),
                           map_location='cpu', weights_only=True)
        if init is not None and not all(torch.equal(state[k], init[k])
                                        for k in ('projection',
                                                  'embeddings')):
            raise RuntimeError('17a: the quantizer buffers moved')
        init = state
    _, busy = trace_readings(summary['profile_trace'], keys=())
    audio = sum(e['audio_seconds'] for e in epochs)
    rate = audio / sum(e['train_seconds'] for e in epochs)
    for e in epochs:
        print(f'  epoch {e["epoch"]}: {e["steps"]} steps in '
              f'{e["train_seconds"]:.2f} s, '
              f'{e["audio_seconds"] / e["train_seconds"]:.1f} audio-sec/s, '
              f'data wait {e["data_wait_seconds"]:.2f} s; cv loss '
              f'{e["cv"]["loss"]:.4f}, codes_acc '
              f'{e["cv"]["codes_acc"]:.4f} ({smi})', flush=True)
    print('    steps B x T: ' + ', '.join(
        f'{r["batch"]}x{r["frames"]}' for r in records) +
        f'; losses {[round(x, 3) for x in losses]}; card busy '
        f'{100 * busy:.1f}% of the profiled step 2; launches {launches}',
        flush=True)
    shutil.rmtree(d)
    return launches, dict(train_audio_sec_per_s=rate, train_busy=busy,
                          steps=steps)


def den_transcripts(rng, n, vocab):
    """`n` unit sequences of 8-30 units, Zipf-like over ids 3..vocab-1."""
    p = 1.0 / np.arange(1, vocab - 2)
    p /= p.sum()
    return [list(3 + rng.choice(vocab - 3, rng.randint(8, 31), p=p))
            for _ in range(n)]


def build_den(d, n_texts=K2_DEN_TEXTS):
    """17b's den.txt in `d`: build_den_graph over `n_texts` seeded
    transcripts of the flagship's 4233 units -> (its DenseFsa, readings:
    states, arcs, eps depth, build seconds)."""
    from wenet_tpu_torch.lm.build_graph import build_den_graph
    from wenet_tpu_torch.lm.fst import TextFst
    from wenet_tpu_torch.ops.fsa import fst_to_dense_arcs
    t0 = time.perf_counter()
    build_den_graph(den_transcripts(np.random.RandomState(SEED + 72),
                                    n_texts, 4233), 4232, outdir=d)
    build_s = time.perf_counter() - t0
    fsa = fst_to_dense_arcs(TextFst.read(os.path.join(d, 'den.txt')))
    return fsa, dict(states=fsa.num_states, emit_arcs=len(fsa.emit_src),
                     eps_arcs=len(fsa.eps_src), eps_depth=fsa.eps_depth,
                     build_s=build_s)


def den_scores(fsa, logp, lens):
    """The den forward score of log-probs `logp` (B, T, V) and `lens` on
    the card, the CPU and in float64 on the CPU, each gradient finite ->
    the largest relative gaps; raises beyond DEN_RTOL."""
    from wenet_tpu_torch.ops.fsa import fsa_forward_score
    scores = {}
    for name, dev, dtype in (('card', 'cuda', torch.float32),
                             ('cpu', 'cpu', torch.float32),
                             ('f64', 'cpu', torch.float64)):
        x = logp.detach().to(dev, dtype).requires_grad_()
        s = fsa_forward_score(x, lens.to(dev), fsa)
        s.sum().backward()
        if not torch.isfinite(x.grad).all():
            raise RuntimeError(f'17b: den gradient on {name} not finite')
        scores[name] = s.detach().cpu().double()

    def rel(a, b):
        return float(((scores[a] - scores[b]).abs() /
                      scores[b].abs()).max())

    out = dict(card_cpu_rtol=rel('card', 'cpu'),
               card_f64_rtol=rel('card', 'f64'),
               cpu_f64_rtol=rel('cpu', 'f64'))
    if max(out['card_cpu_rtol'], out['card_f64_rtol']) > DEN_RTOL:
        raise RuntimeError(f'17b: den score card / cpu / float64 beyond '
                           f'rtol {DEN_RTOL}: {out}')
    return out


K2_DEPTH = 6  # 17b-c's encoder blocks (the flagship's 12), for the time


def k2_configs(lfmmi_dir, dropout=True):
    """The flagship yaml as `model: k2_model` at K2_DEPTH encoder
    blocks."""
    configs = flagship_configs(dropout)
    configs['model'] = 'k2_model'
    configs['model_conf']['lfmmi_dir'] = lfmmi_dir
    configs['encoder_conf']['num_blocks'] = K2_DEPTH
    return configs


def k2_step_check(d, smi):
    """17b: the flagship yaml as `model: k2_model` over a den.txt the phase
    builds: one step card vs CPU at dropout 0, B=4 x 12 s, dynamic chunk
    (loss terms rtol 1e-4, grads 12c's bar), 12 launches of K1-train, K2
    and K3; the den score of the step's log-probs card vs CPU vs float64
    (rtol 1e-5); the LF-MMI loss's time, launches and share of the step
    (informational) -> (the card model, launches, readings)."""
    phase('17b k2 model (LF-MMI) at the flagship width, card vs CPU')
    from wenet_tpu_torch.ops import flash_attention as fa
    from wenet_tpu_torch.ops.fsa import fsa_forward_score
    from wenet_tpu_torch.utils.executor import to_device_batch
    configs = k2_configs(d, dropout=False)
    cpu_model = zoo_model(configs)
    model = copy.deepcopy(cpu_model).cuda()
    B, seconds = K2_STEP
    b = zoo_train_batch(np.random.RandomState(SEED + 73), B, seconds, 80,
                        configs['output_dim'])
    outs = []

    def step(m, dev):
        m.train()
        m.zero_grad(set_to_none=True)
        tb = to_device_batch(b, dev)
        out = m(tb['feats'].to(next(m.parameters()).dtype),
                tb['feats_lengths'], tb['target'], tb['target_lengths'],
                generator=torch.Generator().manual_seed(SEED))
        out['loss'].backward()
        return out

    fsa, den = build_den(d)
    fa.reset_launches()
    outs.append(step(model, 'cuda'))
    torch.cuda.synchronize()
    launches = {k: fa.LAUNCHES[k] for k in TRAIN_KERNELS}
    outs.append(step(cpu_model, 'cpu'))
    outs = [{k: float(v) for k, v in out.items() if v is not None}
            for out in outs]
    n_blocks = configs['encoder_conf']['num_blocks']
    if any(v != n_blocks for v in launches.values()):
        raise RuntimeError(f'17b: launches {launches}, expected {n_blocks}')
    for k in ('loss', 'loss_ctc', 'loss_att', 'th_accuracy'):
        a, w = outs[0][k], outs[1][k]
        if not abs(a - w) <= 1e-4 * abs(w) + 1e-6:
            raise RuntimeError(f'17b: {k} card {a} cpu {w} beyond rtol 1e-4')
    worst, of_bar, largest, held = hold_gradients(
        '17b', model, cpu_model,
        exact=lambda: float64_grads(cpu_model, lambda m: step(m, 'cpu')))
    print(f'  k2 step B={B} x {seconds:.0f} s, dropout 0: loss card '
          f'{outs[0]["loss"]:.6f} cpu {outs[1]["loss"]:.6f}, LF-MMI card '
          f'{outs[0]["loss_ctc"]:.6f} cpu {outs[1]["loss_ctc"]:.6f}, '
          f'loss_att card {outs[0]["loss_att"]:.6f} cpu '
          f'{outs[1]["loss_att"]:.6f} (rtol 1e-4); grads max |card - cpu| '
          f'{worst:.3g}, at most {100 * of_bar:.0f}% of 12c\'s bar (largest '
          f'{largest[0]:.3g}, {largest[1]}); held to float64 instead: '
          + ('; '.join(f'{n} |card - cpu| {e:.3g}, |card - f64| {c64:.3g}, '
                       f'|cpu - f64| {p64:.3g} (bar {bar:.3g})'
                       for n, e, c64, p64, bar in held) or 'none') +
          f'; launches {launches}', flush=True)
    del cpu_model
    # the den score of the step's own log-probs, card vs CPU vs float64
    tb = to_device_batch(b, 'cuda')
    with torch.no_grad():
        model.eval()
        eo, em = model.encoder(tb['feats'], tb['feats_lengths'])
        logp = model.ctc.log_softmax(eo).float()
        lens = em[:, 0].sum(-1)
    den.update(den_scores(fsa, logp.cpu(), lens.cpu()))
    print(f'  den graph of {K2_DEN_TEXTS} seeded transcripts over 4233 '
          f'units: {den["states"]} states, {den["emit_arcs"]} emit and '
          f'{den["eps_arcs"]} eps arcs, eps depth {den["eps_depth"]}, built '
          f'in {den["build_s"]:.1f} s; den score of the step\'s log-probs '
          f'{tuple(logp.shape)}: card vs CPU {den["card_cpu_rtol"]:.2e}, '
          f'card vs float64 {den["card_f64_rtol"]:.2e}, CPU vs float64 '
          f'{den["cpu_f64_rtol"]:.2e} (rtol {DEN_RTOL})', flush=True)
    # the LF-MMI denominator's time and launches beside the whole step
    model.train()
    x = logp.detach().requires_grad_()
    n_fwd, fwd_ms, fwd_wall = search_launches(
        lambda: fsa_forward_score(x, lens, fsa))
    n_all, all_ms, all_wall = search_launches(
        lambda: fsa_forward_score(x, lens, fsa).sum().backward())
    _, step_ms, step_wall = search_launches(lambda: step(model, 'cuda'))
    T = logp.shape[1]
    print(f'    the den forward at {tuple(logp.shape)}: {n_fwd} launches '
          f'({n_fwd / T:.1f} a frame, eps depth {fsa.eps_depth}), '
          f'{fwd_ms:.2f} ms of kernels in {fwd_wall:.1f} ms; forward + '
          f'backward {n_all} launches, {all_ms:.2f} ms of kernels in '
          f'{all_wall:.1f} ms; the whole step {step_ms:.2f} ms of kernels in '
          f'{step_wall:.1f} ms: the den {100 * all_wall / step_wall:.1f}% '
          f'of the step\'s wall (profiled; {smi})', flush=True)
    model.eval()
    return model, configs, launches, dict(
        den=den, den_fwd_launches=n_fwd, den_fwd_wall_ms=fwd_wall,
        den_fwd_bwd_launches=n_all, den_fwd_bwd_wall_ms=all_wall,
        den_fwd_bwd_kernel_ms=all_ms, step_wall_ms=step_wall,
        step_kernel_ms=step_ms, grad_gap=worst,
        grads_held_to_float64=[h[0] for h in held])


def k2_grad_precision(smi):
    """On demand, not run by `main` (python3 -c "import chip_smoke as c;
    smi = c.device(); c.build(); c.k2_grad_precision(smi)"): 17b's step,
    and the same step with the plain CTC loss (no lfmmi_dir), on the CPU
    in float32 and on the card with cuDNN as set, deterministic and off,
    each against the CPU's float64 gradients: the three tensors nearest
    12c's bar per run, as shares of it."""
    phase('x k2 gradient precision: CPU fp32 and the card vs float64')
    from wenet_tpu_torch.utils.executor import to_device_batch
    d = tempfile.mkdtemp(prefix='chip_smoke_k2_precision_')
    build_den(d)
    B, seconds = K2_STEP
    for kind, lfmmi_dir in (('k2', d), ('asr', '')):
        configs = k2_configs(lfmmi_dir, dropout=False)
        cpu_model = zoo_model(configs)
        b = zoo_train_batch(np.random.RandomState(SEED + 73), B, seconds,
                            80, configs['output_dim'])

        def step(m, dev):
            m.train()
            m.zero_grad(set_to_none=True)
            tb = to_device_batch(b, dev)
            m(tb['feats'].to(next(m.parameters()).dtype),
              tb['feats_lengths'], tb['target'], tb['target_lengths'],
              generator=torch.Generator().manual_seed(SEED))[
                  'loss'].backward()

        exact = float64_grads(cpu_model, lambda m: step(m, 'cpu'))
        step(cpu_model, 'cpu')

        def report(label, m):
            rows = []
            for n, g in exact.items():
                err = (m.get_parameter(n).grad.double().cpu() -
                       g).abs().max().item()
                top = g.abs().max().item()
                rows.append((err / (1e-3 + GRAD_SHARE * top), err, top, n))
            print(f'  {kind} {label}: ' + '; '.join(
                f'{share:.3f} of the bar ({err:.3g}, largest {top:.3g}, '
                f'{n})' for share, err, top, n in sorted(rows)[-3:]) +
                f' ({smi})', flush=True)

        report('CPU fp32', cpu_model)
        for label, det, on in (('card, cuDNN as set', False, True),
                               ('card, cuDNN deterministic', True, True),
                               ('card, cuDNN off', False, False)):
            torch.backends.cudnn.deterministic = det
            torch.backends.cudnn.enabled = on
            try:
                m = copy.deepcopy(cpu_model).cuda()
                step(m, 'cuda')
                torch.cuda.synchronize()
                report(label, m)
            finally:
                torch.backends.cudnn.deterministic = False
                torch.backends.cudnn.enabled = True
            del m
        del cpu_model
        torch.cuda.empty_cache()


def hlg_lang(d, tokenizer, logp, lens):
    """17c's lexicon: the HLG_CHARS chars most often in the top 5 of the
    frames the searcher reads (the blank below its skip threshold, 0.98),
    so that the graph holds what the head emits, each a word, and up to
    HLG_TWO_CHAR_WORDS words of two of them; a bigram over HLG_SENTENCES
    seeded sentences; HLG.txt by build_hlg -> readings."""
    from collections import Counter
    from wenet_tpu_torch.lm.build_graph import build_hlg
    rng = np.random.RandomState(SEED + 74)
    write_units(os.path.join(d, 'units.txt'), tokenizer)
    id2sym = {i: s for s, i in tokenizer.symbol_table.items()}
    valid = torch.arange(logp.shape[1])[None] < lens[:, None]
    read = valid & (logp[..., 0].exp() < 0.98)
    counts = Counter(i for i in logp.topk(5, dim=-1).indices[read]
                     .flatten().tolist() if i >= 3)
    chars = sorted(id2sym[i] for i, _ in counts.most_common(HLG_CHARS))
    if not chars:
        raise RuntimeError('17c: the shaped head ranks no unit')
    words = set(chars)
    while len(words) < len(chars) + min(HLG_TWO_CHAR_WORDS,
                                        len(chars) ** 2):
        words.add(''.join(rng.choice(chars, 2)))
    words = sorted(words)
    with open(os.path.join(d, 'lexicon.txt'), 'w', encoding='utf-8') as f:
        f.writelines(f'{w} {" ".join(w)}\n' for w in words)
    write_arpa(os.path.join(d, 'lm.arpa'),
               [list(rng.choice(words, rng.randint(1, 10)))
                for _ in range(HLG_SENTENCES)], vocab=words, order=2)
    t0 = time.perf_counter()
    fst = build_hlg(os.path.join(d, 'units.txt'),
                    os.path.join(d, 'lexicon.txt'),
                    os.path.join(d, 'lm.arpa'), os.path.join(d, 'hlg'))
    seconds = time.perf_counter() - t0
    os.replace(os.path.join(d, 'hlg', 'TLG.txt'),
               os.path.join(d, 'hlg', 'HLG.txt'))
    return dict(words=len(words), chars=len(chars),
                arcs=sum(len(a) for a in fst.arcs.values()),
                states=len(fst.arcs.keys() | fst.finals.keys()),
                build_s=seconds)


def hlg_explained(model, cpu_model, feats, lens, hlg, word, what):
    """A row whose text differs card vs CPU must be a tie the two
    log-prob rows explain (`tlg_decode_check`'s rule): its best search
    costs on the two devices' rows within the summed per-frame largest
    row differences -> the rows' readings."""
    from wenet_tpu_torch.models.k2.model import hlg_search
    searches = []
    for m, dev in ((model, 'cuda'), (cpu_model, 'cpu')):
        x = torch.from_numpy(feats).to(dev)
        ls = torch.from_numpy(lens).to(dev)
        with torch.no_grad():
            eo, em = m.forward_encoder(x, ls)
            logp = m.ctc_activation(eo).float().cpu()
        searches.append((hlg_search(m, x, ls, hlg, word), logp))
    (card, card_lp), (cpu, cpu_lp) = searches
    out = []
    for b in range(len(lens)):
        n = int(cpu.enc_lens[b])
        bound = float((card_lp[b, :n] - cpu_lp[b, :n]).abs().amax(-1).sum())
        c0 = card.nbest[b][0][0] if card.nbest[b] else 0.0
        c1 = cpu.nbest[b][0][0] if cpu.nbest[b] else 0.0
        if abs(c0 - c1) > bound + 1e-5 * abs(c1):
            raise RuntimeError(f'{what}: row {b}: best costs card {c0} cpu '
                               f'{c1} beyond the rows\' {bound:.3g}')
        out.append((abs(c0 - c1), bound))
    return out


def hlg_recognize_check(d, model, configs, smi):
    """17c: 17b's model (the CTC head shaped, 13's rule) through
    bin/recognize.py in hlg_onebest, hlg_rescore and attention_rescoring
    over HLG_UTTS speech-like wavs of 5-15 s and a small HLG.txt built by
    the port's build_hlg, on the card and on the CPU: texts equal up to the
    ties the two log-prob sets explain; 12 K1 launches an encoder pass
    (24 a batch: the hlg modes share one, attention rescoring has its own)
    -> (K1 launches, readings)."""
    phase('17c HLG decoding through bin/recognize.py, card vs CPU')
    import yaml
    from wenet_tpu_torch.bin import recognize
    from wenet_tpu_torch.dataset.audio import write_wav
    from wenet_tpu_torch.ops import flash_attention as fa
    from wenet_tpu_torch.runtime.feature_pipeline import (
        FeaturePipeline, FeaturePipelineConfig)
    tokenizer = flagship_tokenizer()
    scale, blank_share, unit_share = shape_ctc_head(model)
    n, shortest, longest = HLG_UTTS
    rng = np.random.RandomState(SEED + 75)
    chars = [s for s, i in tokenizer.symbol_table.items() if i >= 3]
    entries, wavs = [], []
    for i in range(n):
        s = longest if i == 0 else rng.uniform(shortest, longest)
        wav = speech_like(rng, s)
        path = os.path.join(d, f'h{i}.wav')
        write_wav(path, wav, SR)
        wavs.append(wav)
        entries.append({'key': f'h{i}', 'wav': path, 'txt': ''.join(
            rng.choice(chars, size=int(3 * s)))})
    data = os.path.join(d, 'hlg.list')
    with open(data, 'w', encoding='utf-8') as f:
        f.writelines(json.dumps(e, ensure_ascii=False) + '\n'
                     for e in entries)
    rows = [FeaturePipeline(FeaturePipelineConfig(
        num_mel_bins=80)).accept_waveform(w) for w in wavs]
    lens = np.asarray([len(r) for r in rows], np.int64)
    feats = np.zeros((n, lens.max(), 80), np.float32)
    for i, r in enumerate(rows):
        feats[i, :len(r)] = r
    with torch.no_grad():
        eo, em = model.forward_encoder(torch.from_numpy(feats).cuda(),
                                       torch.from_numpy(lens).cuda())
        logp = model.ctc_activation(eo).float().cpu()
    lang = hlg_lang(d, tokenizer, logp, em[:, 0].sum(-1).cpu())
    configs = copy.deepcopy(configs)
    configs['tokenizer_conf']['symbol_table_path'] = os.path.join(
        d, 'units.txt')
    config = os.path.join(d, 'train.yaml')
    with open(config, 'w') as f:
        yaml.safe_dump(configs, f)
    ckpt = os.path.join(d, 'final.pt')
    torch.save(model.state_dict(), ckpt)
    hlg, word = (os.path.join(d, 'hlg', 'HLG.txt'),
                 os.path.join(d, 'hlg', 'words.txt'))
    argv = ['--config', config, '--test_data', data, '--checkpoint', ckpt,
            '--hlg', hlg, '--word', word, *HLG_ARGS, '--modes', *HLG_MODES]
    texts, summaries = {}, {}
    for dev in ('cuda', 'cpu'):
        fa.reset_launches()
        out = os.path.join(d, dev)
        summaries[dev] = recognize.main(argv + ['--result_dir', out,
                                                '--device', dev])
        if dev == 'cuda':
            k1 = fa.LAUNCHES['relpos_attention_fwd']
        texts[dev] = {}
        for mode in HLG_MODES:
            with open(os.path.join(out, mode, 'text'),
                      encoding='utf-8') as f:
                texts[dev][mode] = dict((line.split(' ', 1) + [''])[:2]
                                        for line in f.read().splitlines())
    batches = -(-n // 8)
    n_blocks = configs['encoder_conf']['num_blocks']
    if k1 != 2 * n_blocks * batches:
        raise RuntimeError(f'17c: K1 launched {k1} times over {batches} '
                           f'batches, expected {n_blocks} an encoder pass, '
                           'two passes a batch')
    differ = {m: [k for k in texts['cpu'][m]
                  if texts['cuda'][m].get(k) != texts['cpu'][m][k]]
              for m in HLG_MODES}
    ties = []
    if any(differ.values()):
        cpu_model = copy.deepcopy(model).cpu()
        ties = hlg_explained(model, cpu_model, feats, lens, hlg, word, '17c')
        del cpu_model
    empty = sum(not t for t in texts['cuda']['hlg_onebest'].values())
    words = [len(t) for t in texts['cuda']['hlg_rescore'].values()]
    print(f'  CTC head x{scale:.2f}, blank leads on {100 * blank_share:.0f}% '
          f'of frames; HLG of {lang["words"]} words ({lang["chars"]} chars '
          f'the head ranks most, the rest of two), a bigram over '
          f'{HLG_SENTENCES} sentences: {lang["states"]} states, '
          f'{lang["arcs"]} arcs, built in {lang["build_s"]:.1f} s', flush=True)
    for dev in ('cuda', 'cpu'):
        s = summaries[dev]
        print(f'  recognize {dev}: {n} wavs in {s["seconds"]:.2f} s, '
              f'{s["audio_seconds"] / s["seconds"]:.1f} audio-sec/s over '
              f'{len(HLG_MODES)} modes ({smi})', flush=True)
    print(f'    card == CPU: differing rows {differ} (explained: {ties}); '
          f'{empty} empty one-best hypotheses of {n}; rescored lengths '
          f'{words}; K1 {k1} launches', flush=True)
    return k1, dict(lang=lang, differ={m: len(v) for m, v in
                                       differ.items()},
                    audio_sec_per_s={dev: s['audio_seconds'] / s['seconds']
                                     for dev, s in summaries.items()})


def ssl_k2_check(smi):
    """Phase 17 -> ({kernel: {'ssl': launches, 'k2': launches}}, readings)."""
    phase('17 SSL (examples/librispeech/ssl BEST-RQ) and k2 (LF-MMI, HLG)')
    import shutil
    fit, step = bestrq_step_check(smi)
    entry, train = bestrq_train_check(smi)
    d = tempfile.mkdtemp(prefix='chip_smoke_k2_')
    model, configs, k2_launches, k2 = k2_step_check(d, smi)
    k1_hlg, hlg = hlg_recognize_check(d, model, configs, smi)
    shutil.rmtree(d)
    del model
    torch.cuda.empty_cache()
    names = ['relpos_attention_fwd', *TRAIN_KERNELS]
    launches = {k: {'ssl': fit.get(k, 0) + entry.get(k, 0),
                    'k2': k2_launches.get(k, 0)} for k in names}
    launches['relpos_attention_fwd']['k2'] += k1_hlg
    return launches, dict(bestrq_step=step, bestrq_train=train, k2=k2,
                          hlg=hlg)


# ---------------------------------------------------------------------------
# 18. serving and training at scale: WFST over the batch runner, int8
# weight-only and data-parallel decode, multi-rank training
# ---------------------------------------------------------------------------
WFST_BATCH_STREAMS = 8  # 18a: streams over one runner, 4-9 s each
QUANT_DECODE = (16, 1500, 600)  # 18b: B x frames (15 s), shortest frames
QUANT_CPU_ROWS = 2  # 18b: the rows also decoded on the CPU
QUANT_MODES = ['ctc_greedy_search', 'attention_rescoring']
QUANT_AGREE = 0.9  # 18b: greedy frames int8 = fp (tests/test_smoke_core.py)
MESH_DECODE = (15, 1500, 600)  # 18c: a ragged B over two replicas
MESH_MODES = ['ctc_greedy_search', 'ctc_prefix_beam_search',
              'attention_rescoring']
PARALLEL_UTTS = (16, 2)  # 18d: train (8 a rank: two steps of 4), cv
PARALLEL_GRAD_RTOL = 2e-4  # 12c's gradient bar: 1e-3 + this x the largest

# one rank of 18d: bin/train.py's main, with its first step's metrics, the
# gradients it applied (after DDP's all-reduce and the clip) and the
# kernels' launch counts written to OUT/rank{RANK}.*
PARALLEL_RANK = r'''
import json, os, sys
import torch
out, argv = sys.argv[1], sys.argv[2:]
rank = int(os.environ.get('RANK', '0'))
# fp32 as the one-process reference runs it (chip_smoke's `device`)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from wenet_tpu_torch.bin import train
from wenet_tpu_torch.ops import flash_attention as fa
from wenet_tpu_torch.utils import train_utils
from wenet_tpu_torch.parallel.mesh import gather_model_shard
first, runs = {}, []
real_apply, real_make = train_utils.apply_gradients, train.make_train_step
real_build = train.build


def build(args):
    runs.append(real_build(args))
    return runs[-1]


def apply_gradients(state, *args, **kw):
    out = real_apply(state, *args, **kw)
    if 'grads' not in first:  # as applied: averaged over data, clipped
        layout = runs[0].layout  # shards gathered over `model`
        mesh = layout.mesh
        first['grads'] = {
            n: (gather_model_shard(p.grad.detach(), layout.sharded[n],
                                   mesh.model_group, mesh.model)
                if n in layout.sharded else p.grad.detach()).cpu().clone()
            for n, p in state.model.named_parameters() if p.grad is not None}
    return out


def make_train_step(*args, **kw):
    step = real_make(*args, **kw)

    def recorded(state, batch, rng):
        state, metrics = step(state, batch, rng)
        first.setdefault('metrics', {k: float(v) for k, v in metrics.items()})
        return state, metrics
    return recorded


train_utils.apply_gradients = apply_gradients
train.make_train_step = make_train_step
train.build = build
steps = []
fa.reset_launches()
summary = train.main(argv, on_step=lambda r: steps.append(r['batch']))
torch.cuda.synchronize()
with open(os.path.join(out, f'rank{rank}.json'), 'w') as f:
    json.dump(dict(launches=dict(fa.LAUNCHES), rows=steps,
                   steps=[e['steps'] for e in summary['epochs']],
                   metrics=first['metrics']), f)
if rank == 0:
    torch.save(first['grads'], os.path.join(out, 'grads0.pt'))
'''


def wfst_row_gap(rows, other):
    """The summed per-frame differences of two runs' host rows: the most
    a search path's score can move between them."""
    if len(rows) != len(other):
        raise RuntimeError(f'{len(rows)} steps against {len(other)}')
    return float(sum(np.abs(a - b).max(axis=-1).sum()
                     for a, b in zip(rows, other)))


def shaped_flagship():
    """13's flagship model on the card: the seed's weights with the CTC
    head scaled and its blank raised (`shape_ctc_head`)."""
    model = flagship_model().cuda().eval()
    shape_ctc_head(model)
    return model


def wfst_batch_check(lang, model, tokenizer, smi):
    phase('18a WFST streams over one BatchedChunkRunner vs each alone')
    from wenet_tpu_torch.lm.fst import read_symbol_table
    from wenet_tpu_torch.models.transformer.streaming import StreamingConfig
    from wenet_tpu_torch.ops import flash_attention as fa
    from wenet_tpu_torch.runtime.asr_decoder import AsrDecoder, DecodeOptions
    from wenet_tpu_torch.runtime.batch_runner import BatchedChunkRunner
    from wenet_tpu_torch.runtime.feature_pipeline import (
        FeaturePipelineConfig)
    rng = np.random.RandomState(SEED + 40)
    seconds = list(np.linspace(4.0, 9.0, WFST_BATCH_STREAMS))
    utts = [speech_like(rng, s) for s in seconds]
    words_txt = read_symbol_table(os.path.join(lang, 'words.txt'))

    def decoder(rows, runner=None):
        """A WFST decoder that keeps the host rows it searches in
        `rows`."""
        dec = AsrDecoder(model, tokenizer, DecodeOptions(**STREAM_OPTS),
                         FeaturePipelineConfig(num_mel_bins=80),
                         tlg_fst=os.path.join(lang, 'TLG.txt'),
                         word_table=words_txt, batch_runner=runner,
                         device='cuda')
        search = dec._search

        def recorded(host):
            rows.append(np.array(host, copy=True))
            return search(host)
        dec._search = recorded
        return dec
    rows = {'alone': [[] for _ in utts], 'batched': [[] for _ in utts]}
    alone = [stream_utterance(decoder(rows['alone'][i]), w)[:2]
             for i, w in enumerate(utts)]
    cfg = StreamingConfig(STREAM_OPTS['chunk_size'],
                          STREAM_OPTS['num_left_chunks'],
                          model.encoder.subsampling_rate,
                          model.encoder.right_context)
    runner = BatchedChunkRunner(model, cfg, max_batch=WFST_BATCH_STREAMS,
                                beam_size=STREAM_OPTS['beam_size'],
                                device='cuda')
    try:
        runner.precompile(80)
        runner.batch_sizes.clear()
        torch.cuda.synchronize()
        fa.reset_launches()
        got, wall = run_streams(decoder, utts, 0.1, rows['batched'], runner)
        torch.cuda.synchronize()
        launches = fa.LAUNCHES['relpos_attention_fwd']
    finally:
        runner.close()
    hist = dict(sorted(runner.batch_sizes.items()))
    steps = sum(hist.values())
    n_blocks = len(model.encoder.encoders)
    if launches != n_blocks * steps or max(hist) < 2:
        raise RuntimeError(f'18a: {launches} K1 launches over {steps} '
                           f'batched steps {hist}')
    worst = share = 0.0
    words = 0
    for i, ((g_part, g_final, _), (w_part, w_final)) in enumerate(
            zip(got, alone)):
        if len(g_part) != len(w_part):
            raise RuntimeError(f'18a stream {i}: {len(g_part)} partials '
                               f'batched, {len(w_part)} alone')
        # a path's score moves by at most the rows' summed differences
        explained = wfst_row_gap(rows['batched'][i], rows['alone'][i])
        for j, (g, w) in enumerate(zip(g_part + [g_final],
                                       w_part + [w_final])):
            tol = dict(atol=BATCH_SCORE_TOL['atol'] + explained,
                       rtol=SEARCH_FLOAT_TIE)
            gap = same_results(g, w, f'18a stream {i} result {j}', tol)
            worst = max(worst, gap)
            share = max(share, gap / (tol['atol'] + SEARCH_FLOAT_TIE * max(
                [abs(x) for _, x in w] or [0.0])))
        words += len(g_final[0][0]) if g_final else 0
    if not words:
        raise RuntimeError('18a: no stream decoded a word')
    audio = sum(seconds)
    print(f'  {WFST_BATCH_STREAMS} WFST streams ({seconds[0]:.1f}-'
          f'{seconds[-1]:.1f} s, 13a\'s TLG) over one runner: every partial '
          f'and final equal to the stream alone: words identical, scores '
          f'within {worst:.3g} ({100 * worst / BATCH_SCORE_TOL["atol"]:.0f}% '
          f'of 9f\'s {BATCH_SCORE_TOL["atol"]}; {100 * share:.0f}% of that '
          f'bar plus the summed row differences and {SEARCH_FLOAT_TIE} of the '
          f'score); {words} chars of final words; {steps} batched steps '
          f'{hist}, {launches} K1 launches ({n_blocks} a step); '
          f'{audio:.1f} s of audio in {wall:.2f} s ({smi})')
    return launches, dict(batch_sizes=hist, steps=steps, max_score_gap=worst,
                          wall_s=wall, audio_s=audio)


def greedy_ties(logp, cpu_logp, ids, cpu_ids, lens):
    """Frames whose greedy ids differ between the card's and the CPU's
    log-probs -> (count, how many are ties: the CPU's top two within
    twice the frame's largest card-CPU difference)."""
    differ = ties = 0
    for b, n in enumerate(lens):
        for t in np.nonzero(ids[b, :n] != cpu_ids[b, :n])[0]:
            differ += 1
            top2 = np.sort(cpu_logp[b, t])[-2:]
            gap = float(np.abs(logp[b, t] - cpu_logp[b, t]).max())
            ties += int(top2[1] - top2[0] <= 2 * gap)
    return differ, ties


def quant_check(model, smi):
    phase('18b int8 weight-only runner (flagship, B=16 x 15 s): card vs '
          'CPU, against float')
    from torch.nn.utils import parametrize
    from wenet_tpu_torch.models.runner import AsrRunner
    from wenet_tpu_torch.ops import flash_attention as fa
    from wenet_tpu_torch.ops.quant import quantized_bytes
    B, T, shortest = QUANT_DECODE
    feats, lens = features(np.random.RandomState(SEED + 41), B, T, shortest)
    fp_bytes, q_bytes = quantized_bytes(model)
    card = AsrRunner(copy.deepcopy(model), 'cuda', quantize=True)
    cpu = AsrRunner(copy.deepcopy(model).cpu(), 'cpu', quantize=True)
    n_int8 = 0
    cpu_mods = dict(cpu.model.named_modules())
    for name, m in card.model.named_modules():
        if not parametrize.is_parametrized(m, 'weight'):
            continue
        n_int8 += 1
        w = m.parametrizations.weight
        c = cpu_mods[name].parametrizations.weight
        if w.original.dtype != torch.int8 or not (
                torch.equal(w.original.cpu(), c.original) and
                torch.equal(w[0].scale.cpu(), c[0].scale)):
            raise RuntimeError(f'18b: {name}: the int8 tensor or its scale '
                               'differs between the card and the CPU')
    kw = dict(beam_size=10, ctc_weight=0.3, reverse_weight=0.3)
    torch.cuda.synchronize()
    fa.reset_launches()
    got = card.decode(QUANT_MODES, feats, lens, **kw)
    torch.cuda.synchronize()
    launches = fa.LAUNCHES['relpos_attention_fwd']
    n_blocks = len(model.encoder.encoders)
    if launches != n_blocks:
        raise RuntimeError(f'18b: {launches} K1 launches in one decode, '
                           f'expected {n_blocks}')
    fp = AsrRunner(copy.deepcopy(model), 'cuda')
    x, n = torch.from_numpy(feats), torch.from_numpy(lens)
    with torch.inference_mode():
        out = {}
        for name, r in (('int8', card), ('fp', fp)):
            eo, em = r.model.forward_encoder(x.cuda().to(r.dtype or
                                                         torch.float32),
                                             n.cuda())
            out[name] = r.model.ctc_logprobs(eo).float().cpu().numpy()
            enc_lens = em[:, 0, :].sum(-1).cpu().numpy()
        rows = slice(0, QUANT_CPU_ROWS)
        ceo, cem = cpu.model.forward_encoder(x[rows].to(cpu.dtype), n[rows])
        cpu_logp = cpu.model.ctc_logprobs(ceo).float().numpy()
    ids, fp_ids = out['int8'].argmax(-1), out['fp'].argmax(-1)
    agree = [float(np.mean(ids[b, :k] == fp_ids[b, :k]))
             for b, k in enumerate(enc_lens)]
    if min(agree) < QUANT_AGREE:
        raise RuntimeError(f'18b: int8 greedy frames agree with fp on '
                           f'{min(agree):.3f} of a row (bar {QUANT_AGREE})')
    differ, ties = greedy_ties(out['int8'][rows], cpu_logp, ids[rows],
                               cpu_logp.argmax(-1), enc_lens[rows])
    if differ != ties:
        raise RuntimeError(f'18b: {differ - ties} greedy frames differ '
                           'between the card and the CPU beyond a tie')
    want = cpu.decode(QUANT_MODES[:1], feats[rows], lens[rows], **kw)
    for g, w in zip(got['ctc_greedy_search'], want['ctc_greedy_search']):
        if g.tokens != w.tokens and not differ:
            raise RuntimeError('18b: card and CPU greedy hypotheses differ '
                               'with no differing frame')
    bf16 = AsrRunner(copy.deepcopy(model), 'cuda', dtype=torch.bfloat16)
    times = {'int8': [], 'bf16': []}
    for _ in range(3):  # interleaved, best of three
        for name, r in (('int8', card), ('bf16', bf16)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.decode(QUANT_MODES, feats, lens, **kw)
            torch.cuda.synchronize()
            times[name].append(1e3 * (time.perf_counter() - t0))
    ms = {k: min(v) for k, v in times.items()}
    print(f'  {n_int8} int8 tensors, equal to the CPU\'s bit for bit (and '
          f'their float32 scales); weights {fp_bytes / 2 ** 20:.1f} MiB '
          f'float32, {q_bytes / 2 ** 20:.1f} MiB with int8; {launches} K1 '
          f'launches (bf16) a decode; greedy frames int8 = fp on '
          f'{min(agree):.4f} of a row at least (bar {QUANT_AGREE}); card vs '
          f'CPU on {QUANT_CPU_ROWS} rows: {differ} greedy frames differ, '
          f'{ties} of them ties')
    print(f'  decode {QUANT_MODES} at B={B} x {T / 100:.0f} s (informational, '
          f'best of 3): int8 {ms["int8"]:.1f} ms, bf16 {ms["bf16"]:.1f} ms '
          f'({smi})')
    del card, cpu, fp, bf16
    torch.cuda.empty_cache()
    return launches, dict(fp_bytes=fp_bytes, int8_bytes=q_bytes,
                          int8_tensors=n_int8, agree_min=min(agree),
                          card_cpu_frames=differ, ties=ties,
                          int8_ms=ms['int8'], bf16_ms=ms['bf16'])


def mesh_decode_check(model, smi):
    phase('18c AsrRunner(mesh=[cuda:0, cuda:0]) at B=15 vs one device')
    from wenet_tpu_torch.models.runner import AsrRunner
    from wenet_tpu_torch.ops import flash_attention as fa
    B, T, shortest = MESH_DECODE
    feats, lens = features(np.random.RandomState(SEED + 42), B, T, shortest)
    kw = dict(beam_size=10, ctc_weight=0.3, reverse_weight=0.3)
    one = AsrRunner(model, 'cuda')
    two = AsrRunner(model, mesh=['cuda:0', 'cuda:0'])
    want = one.decode(MESH_MODES, feats, lens, **kw)
    torch.cuda.synchronize()
    fa.reset_launches()
    t0 = time.perf_counter()
    got = two.decode(MESH_MODES, feats, lens, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.LAUNCHES['relpos_attention_fwd']
    n_blocks = len(model.encoder.encoders)
    for m in MESH_MODES:
        if [r.tokens for r in got[m]] != [r.tokens for r in want[m]]:
            raise RuntimeError(f'18c {m}: the two-replica hypotheses differ '
                               'from one device\'s')
    if launches != 2 * n_blocks:
        raise RuntimeError(f'18c: {launches} K1 launches, expected two '
                           f'shards x {n_blocks}')
    print(f'  B={B} (8 + 7 rows, the last repeated and trimmed): every '
          f'hypothesis of {MESH_MODES} equal to one device\'s; {launches} '
          f'K1 launches; {1e3 * wall:.1f} ms ({smi})')
    return launches, dict(wall_ms=1e3 * wall)


def parallel_recipe(d, tokenizer):
    """16 train and 2 cv utterances (3-6 s) as raw data lists, their units
    and cmvn stats -> the argv bin/train.py takes for them, without and
    with `sharding_conf.zero2` and a checkpoint after each step (the
    flagship yaml with every dropout and augmentation off, static batches
    of 4, one epoch)."""
    from wenet_tpu_torch.bin import compute_cmvn_stats
    from wenet_tpu_torch.dataset.audio import write_wav
    rng = np.random.RandomState(SEED + 43)
    write_units(os.path.join(d, 'units.txt'), tokenizer)
    chars = [s for s, i in tokenizer.symbol_table.items() if i >= 3]
    lists = []
    for name, n in zip(('train', 'cv'), PARALLEL_UTTS):
        lines = []
        for i in range(n):
            s = rng.uniform(3.0, 6.0)
            path = os.path.join(d, f'{name}{i}.wav')
            write_wav(path, speech_like(rng, s), SR)
            txt = ''.join(rng.choice(chars, size=int(3 * s)))
            lines.append(json.dumps({'key': f'{name}{i}', 'wav': path,
                                     'txt': txt}, ensure_ascii=False))
        lists.append(os.path.join(d, f'{name}.list'))
        with open(lists[-1], 'w', encoding='utf-8') as f:
            f.write('\n'.join(lines) + '\n')
    scp = os.path.join(d, 'wav.scp')
    with open(lists[0], encoding='utf-8') as f, open(scp, 'w') as g:
        g.writelines(f'{e["key"]} {e["wav"]}\n'
                     for e in map(json.loads, f))
    cmvn = os.path.join(d, 'global_cmvn')
    compute_cmvn_stats.main(['--train_config', CONFIG, '--in_scp', scp,
                             '--out_cmvn', cmvn])
    import yaml
    with open(CONFIG) as f:
        configs = yaml.safe_load(f)
    configs['tokenizer_conf']['symbol_table_path'] = os.path.join(
        d, 'units.txt')
    configs['cmvn_conf']['cmvn_file'] = cmvn
    configs.update(max_epoch=1, log_interval=1)
    dc = configs['dataset_conf']
    dc.update(speed_perturb=False, spec_aug=False, spec_sub=False,
              shuffle=False, batch_conf={'batch_type': 'static',
                                         'batch_size': 4})
    dc['fbank_conf']['dither'] = 0.0
    for conf in (configs['encoder_conf'], configs['decoder_conf']):
        for k in conf:
            if k.endswith('dropout_rate'):
                conf[k] = 0.0
    paths = []
    # the zero2 run also writes a checkpoint after each step (step_1.pt)
    for name, extra in (('train', {}), ('zero2', dict(
            sharding_conf={'zero2': True}, save_interval=1))):
        paths.append(os.path.join(d, f'{name}.yaml'))
        with open(paths[-1], 'w') as f:
            yaml.safe_dump(dict(configs, **extra), f)
    return [['--config', p, '--train_data', lists[0], '--cv_data', lists[1],
             '--seed', str(SEED), '--device', 'cuda'] for p in paths]


def start_ranks(d, name, launcher, argv):
    """bin/train.py's ranks through torch.distributed.run (`launcher`
    its options) with PARALLEL_RANK as each rank's script, started ->
    what `finish_ranks` waits on."""
    out = os.path.join(d, name)
    os.makedirs(out)
    script = os.path.join(d, 'rank_train.py')
    with open(script, 'w') as f:
        f.write(PARALLEL_RANK)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.environ.get('PYTHONPATH', '')]), OMP_NUM_THREADS='2')
    cmd = [sys.executable, '-m', 'torch.distributed.run', '--standalone',
           *launcher, script, out, *argv, '--model_dir',
           os.path.join(d, f'exp_{name}')]
    # a session of its own: `stop_ranks` stops the launcher's ranks too
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    return name, out, proc, time.perf_counter()


def stop_ranks(started):
    """Stop `start_ranks`' launcher and every rank it started (its
    session), if any still runs."""
    import signal
    proc = started[2]
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def finish_ranks(started):
    """Wait for `start_ranks`' ranks, at most to the end of the phase's
    budget -> (each rank's record, wall seconds)."""
    name, out, proc, t0 = started
    try:
        try:
            log, _ = proc.communicate(timeout=budget_left())
        except subprocess.TimeoutExpired:
            over_budget(f'{name}: the ranks')
    finally:
        stop_ranks(started)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        print(log[-8000:])
        raise RuntimeError(f'{name}: the ranks exited with '
                           f'{proc.returncode}')
    ranks = []
    for r in range(len(os.listdir(out))):
        path = os.path.join(out, f'rank{r}.json')
        if os.path.exists(path):
            with open(path) as f:
                ranks.append(json.load(f))
    return ranks, wall


def parallel_train_check(smi):
    phase('18d bin/train.py at the flagship width: two ranks on the card '
          '(gloo, --mesh data=2, zero2) and torchrun with NCCL')
    import shutil
    from wenet_tpu_torch.bin import train
    from wenet_tpu_torch.parallel.mesh import pad_batch
    from wenet_tpu_torch.utils.executor import to_device_batch
    from wenet_tpu_torch.utils.train_utils import (
        TrainState, init_optimizer_and_scheduler, make_train_step)
    d = tempfile.mkdtemp(prefix='chip_smoke_parallel_')
    argv, zero2_argv = parallel_recipe(d, flagship_tokenizer())
    # the two runs side by side on the card
    started = [start_ranks(d, 'gloo', ['--nproc_per_node', '2'],
                           zero2_argv + ['--mesh', 'data=2',
                                         '--dist_backend', 'gloo']),
               start_ranks(d, 'nccl', ['--nproc_per_node', '1'], argv)]
    # meanwhile, the one-process step on the two shards' first batches,
    # padded and concatenated, and on the one shard's first batch (the
    # NCCL run)
    try:
        args = train.get_parser().parse_args(
            argv + ['--model_dir', os.path.join(d, 'exp_one')])
        run = train.build(args)
        init = copy.deepcopy(run.model.state_dict())
        want = {}
        for name, shards in (('gloo', 2), ('nccl', 1)):
            batches = []
            for r in range(shards):
                tr, _ = train.datasets(args, run.configs, run.tokenizer,
                                       shards, r)
                tr.set_epoch(0)
                it = iter(tr)
                batches.append(next(it))
                it.close()
            dims = [max(len(b['feats_lengths']) for b in batches),
                    max(b['feats'].shape[1] for b in batches),
                    max(b['target'].shape[1] for b in batches)]
            batches = [pad_batch(b, *dims) for b in batches]
            batch = {k: np.concatenate([b[k] for b in batches])
                     for k in ('feats', 'feats_lengths', 'target',
                               'target_lengths')}
            run.model.load_state_dict(init)
            opt, schedule = init_optimizer_and_scheduler(run.configs,
                                                         run.model)
            step = make_train_step(run.model, opt, schedule, None, 1,
                                   run.configs['grad_clip'])
            _, m = step(TrainState(run.model, opt), to_device_batch(batch,
                                                                    'cuda'),
                        (SEED, 0))
            want[name] = (dims, {k: float(v) for k, v in m.items()},
                          {n: p.grad.detach().cpu().clone()
                           for n, p in run.model.named_parameters()},
                          {k: v.detach().cpu().clone()
                           for k, v in run.model.state_dict().items()})
    except BaseException:
        for r in started:
            stop_ranks(r)
        raise
    try:
        (gloo, gloo_s), (nccl, nccl_s) = (finish_ranks(r) for r in started)
    finally:
        for r in started:
            stop_ranks(r)
    n_blocks = flagship_configs()['encoder_conf']['num_blocks']
    launches = {k: 0 for k in ['relpos_attention_fwd', *TRAIN_KERNELS]}
    for name, ranks, n in (('gloo', gloo, 2), ('nccl', nccl, 1)):
        if len(ranks) != n or len({tuple(r['steps']) for r in ranks}) != 1:
            raise RuntimeError(f'18d {name}: {len(ranks)} rank records, '
                               f'steps {[r["steps"] for r in ranks]}')
        for r in ranks:
            steps = sum(r['steps'])
            for k in TRAIN_KERNELS:
                if r['launches'][k] != n_blocks * steps:
                    raise RuntimeError(f'18d {name}: {k} launched '
                                       f'{r["launches"][k]} times over '
                                       f'{steps} steps')
                launches[k] += r['launches'][k]
            launches['relpos_attention_fwd'] += r['launches'][
                'relpos_attention_fwd']  # cv
    for name, ranks in (('gloo', gloo), ('nccl', nccl)):
        dims, metrics, _, _ = want[name]
        for r in ranks:
            for k in ('loss', 'loss_att', 'loss_ctc'):
                if not abs(r['metrics'][k] - metrics[k]) <= \
                        1e-4 * abs(metrics[k]):
                    raise RuntimeError(f'18d {name}: first step {k} '
                                       f'{r["metrics"][k]} against '
                                       f'{metrics[k]} in one process')
    _, metrics, grads, weights = want['gloo']
    got = torch.load(os.path.join(d, 'gloo', 'grads0.pt'),
                     map_location='cpu')
    worst = 0.0
    for k, g in grads.items():
        bar = 1e-3 + PARALLEL_GRAD_RTOL * g.abs().max().item()
        err = (got[k] - g).abs().max().item()
        worst = max(worst, err / bar)
        if err > bar:
            raise RuntimeError(f'18d gloo: gradient of {k} off the one-'
                               f'process step by {err:.3g} (bar {bar:.3g})')
    saved = torch.load(os.path.join(d, 'exp_gloo', 'step_1.pt'),
                       map_location='cpu')
    w_err = max((saved[k].float() - v.float()).abs().max().item()
                for k, v in weights.items())
    if saved.keys() != weights.keys() or w_err > 1e-6:
        raise RuntimeError(f'18d gloo: step_1.pt off the one-process '
                           f'weights by {w_err:.3g} (or other keys)')
    print(f'  two ranks (gloo, zero2): {gloo[0]["steps"]} steps each, rows '
          f'{[r["rows"] for r in gloo]}; first step padded to '
          f'{want["gloo"][0]} a rank: loss {gloo[0]["metrics"]["loss"]:.6f}'
          f' against {metrics["loss"]:.6f} in one process on the '
          f'concatenated batch, gradients within {100 * worst:.0f}% of 12c\'s'
          f' bar, step_1.pt within {w_err:.3g} of its weights (keys and '
          f'shapes a one-process checkpoint\'s); {gloo_s:.1f} s')
    print(f'  torchrun --nproc_per_node 1 (NCCL): {nccl[0]["steps"]} steps, '
          f'first loss {nccl[0]["metrics"]["loss"]:.6f} against '
          f'{want["nccl"][1]["loss"]:.6f} in one process; {nccl_s:.1f} s; '
          f'launches a rank: {nccl[0]["launches"]} ({smi})')
    del run
    torch.cuda.empty_cache()
    shutil.rmtree(d)
    return launches, dict(gloo_s=gloo_s, nccl_s=nccl_s, grad_share=worst,
                          weight_err=w_err)


def scale_check(lang, smi):
    """Phase 18 -> ({kernel: launches}, readings): K1 in 18a-18c and in
    18d's cv, K1-train, K2 and K3 in 18d's steps, summed over its ranks."""
    phase('18 serving and training at scale: WFST over the batch runner, '
          'int8 and data-parallel decode, multi-rank training')
    model = shaped_flagship()
    tokenizer = flagship_tokenizer()
    k1_wfst, wfst = wfst_batch_check(lang, model, tokenizer, smi)
    k1_quant, quant = quant_check(model, smi)
    k1_mesh, mesh = mesh_decode_check(model, smi)
    del model
    torch.cuda.empty_cache()
    train_launches, parallel = parallel_train_check(smi)
    launches = dict(train_launches)
    launches['relpos_attention_fwd'] += k1_wfst + k1_quant + k1_mesh
    return launches, dict(wfst_batch=wfst, quant=quant, mesh=mesh,
                          parallel=parallel, k1=dict(wfst=k1_wfst,
                                                     quant=k1_quant,
                                                     mesh=k1_mesh))


# ---------------------------------------------------------------------------
# 19. the rest of the encoder and attention zoo
# ---------------------------------------------------------------------------
TRANSFORMER_CONFIG = os.path.join(REPO, 'examples/aishell/s0/conf/'
                                  'train_transformer.yaml')
# U2++-MoE: MoE in place of every FFN (the JAX package's 8 experts, top
# 2), GQA, RMSNorm, no FFN biases, in encoder and decoder
MOE_OPTIONS = dict(n_kv_head=2, mlp_type='moe', n_expert=8,
                   n_expert_activated=2, mlp_bias=False,
                   layer_norm_type='rms_norm')
OPTIONS = {  # 19a-19d: yaml, encoder_conf, decoder_conf, top-level overrides
    'moe_gqa_conformer': (CONFIG, MOE_OPTIONS, MOE_OPTIONS, {}),
    'rope_mqa_transformer': (TRANSFORMER_CONFIG, dict(
        pos_enc_layer_type='rope_pos',
        selfattention_layer_type='rope_abs_selfattn', n_kv_head=1,
        mlp_type='gated'), {}, {}),
    'shaw_transformer': (TRANSFORMER_CONFIG, dict(
        pos_enc_layer_type='no_pos',
        selfattention_layer_type='shaw_rel_selfattn'), {}, {}),
    'ctl': (CONFIG, dict(static_chunk_size=16, use_dynamic_chunk=False), {},
            dict(model='ctl_model', encoder='dual_conformer')),
}
OPTIONS_DECODE = {  # B x seconds on the card, rows decoded on the CPU too
    'moe_gqa_conformer': (16, 15.0, 2),
    'rope_mqa_transformer': (64, 15.0, 2),  # T' = 374: K4 by the 24M gate
    'shaw_transformer': (64, 15.0, 2),
}
# the card-against-CPU train step (MoE runs 8x the FFN work on the host),
# then the larger batch on the card alone; 24 s: T' = 599 >= 512, K4-train
OPTIONS_STEP = {'moe_gqa_conformer': ((2, 8.0), (16, 12.0)),
                'rope_mqa_transformer': ((2, 24.0), (8, 24.0)),
                'shaw_transformer': ((2, 24.0), (8, 24.0)),
                'ctl': ((2, 8.0), None)}
CTL_NEGATIVES = 10
INPUT_LAYERS = {  # 19e: the flagship at 2 + 1 layers with each front end
    'linear': {}, 'conv2d2': {},
    # stacked frames need output_size = 2 x 80 (heads of d = 32)
    'stack_n_frames': dict(output_size=160, attention_heads=5)}
INPUT_LAYER_DECODE = (4, 6.0, 2)  # B x seconds, rows on the CPU
SHAW_K4_SHAPE = (64, 4, 374, 374, 64)  # 19c's decode: K4 with a full bias
SHAW_K5_SHAPE = (2, 4, 599, 599, 64)  # 19c's step: K5's full dbias
OPTIONS_STREAM_SECONDS = 4.0
# the batched streams' seconds (19a takes four, 20a eight)
STREAM_UTTS_SECONDS = (3.0, 4.0, 5.0, 3.5, 2.5, 4.5, 3.2, 2.8)


def options_configs(name, dropout=True):
    """19a-19d's yaml with its overrides, input 80-d fbank, 4233 chars.
    dropout: True, the yaml's; False, every rate 0; 'hash', only the
    encoder's attention dropout (K1's counter hash, the same draw on the
    card and the CPU), nn.Dropout at 0."""
    import yaml
    path, enc, dec, top = OPTIONS[name]
    with open(path) as f:
        configs = yaml.safe_load(f)
    configs['input_dim'], configs['output_dim'] = 80, 4233
    configs['encoder_conf'].update(enc)
    configs['decoder_conf'].update(dec)
    configs.update(top)
    if name == 'ctl':
        configs['model_conf']['n_negatives'] = CTL_NEGATIVES
    if dropout is not True:
        for conf in (configs['encoder_conf'], configs['decoder_conf']):
            for key in conf:
                if key.endswith('dropout_rate') and not (
                        dropout == 'hash' and conf is configs['encoder_conf']
                        and key == 'attention_dropout_rate'):
                    conf[key] = 0.0
    return configs


def input_layer_configs(layer):
    """19e: the flagship at 2 + 1 + 1 blocks with front end `layer`."""
    configs = flagship_configs()
    configs['encoder_conf'].update(num_blocks=2, input_layer=layer,
                                   **INPUT_LAYERS[layer])
    heads = configs['encoder_conf']['attention_heads']
    configs['decoder_conf'].update(num_blocks=1, r_num_blocks=1,
                                   attention_heads=heads)
    return configs


def options_step_speed(label, configs, B, seconds, smi):
    """Three train steps (forward + backward, no update) at B x seconds
    on the card only: ms a step (the second and third, synchronized) ->
    (ms, the kernels' launches over the three steps)."""
    from wenet_tpu_torch.ops import flash_attention as fa
    from wenet_tpu_torch.utils.executor import to_device_batch
    model = zoo_model(configs).cuda().train()
    b = to_device_batch(zoo_train_batch(np.random.RandomState(SEED + 93), B,
                                        seconds, 80, 4233), 'cuda')
    times = []
    fa.reset_launches()
    for _ in range(3):
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model(b['feats'], b['feats_lengths'], b['target'],
                    b['target_lengths'],
                    generator=torch.Generator().manual_seed(SEED))
        out['loss'].backward()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        if not torch.isfinite(out['loss']):
            raise RuntimeError(f'{label}: the loss is not finite')
    launches = dict(fa.LAUNCHES)
    ms = float(np.mean(times[1:]))
    per_step = {k: v // 3 for k, v in launches.items() if v}
    print(f'  {label} train step B={B} x {seconds:.0f} s on the card: '
          f'{ms:.1f} ms (steps 2-3; forward + backward), '
          f'{B * seconds / ms * 1e3:.1f} audio-sec/s, peak '
          f'{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB; '
          f'launches a step {per_step} '
          f'({smi})', flush=True)
    del model, b, out
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return ms, launches


def sdpa_bias_train(q, k, v, mask, bias, scale, do):
    """SDPA forward and backward with where(mask, bias·scale, -inf) as a
    float attn_mask that requires grad (its gradient is dbias·scale):
    the one PyTorch call that computes K4-train, K5 with dbias and K6
    together -> (forward ms, backward ms), or None where SDPA refuses a
    gradient of its mask."""
    import torch.nn.functional as F
    x = [t.detach().requires_grad_() for t in (q, k, v)]
    m = torch.where(mask, bias * scale, -float('inf')).to(q.dtype).detach()
    m.requires_grad_()
    try:
        with torch.enable_grad():
            o = F.scaled_dot_product_attention(*x, attn_mask=m, scale=scale)
            torch.autograd.grad(o, x + [m], do, retain_graph=True)
    except RuntimeError as e:
        print(f'    SDPA refused a float mask with a gradient: {e}'[:200])
        return None

    def forward():
        with torch.enable_grad():
            return F.scaled_dot_product_attention(*x, attn_mask=m,
                                                  scale=scale)
    return (cuda_time_ms(forward),
            cuda_time_ms(lambda: torch.autograd.grad(o, x + [m], do,
                                                     retain_graph=True)))


def shaw_kernel_check():
    """19c's kernel shapes against the plain versions, fp32 and bf16: K4
    with the full (B, h, T1, T2) bias at the decode's shape, K4-train, K5
    (its full dbias) and K6 at the train step's; SDPA with the bias as a
    float attn_mask beside them -> {kernel: readings, bf16's keyed
    '_bf16'}."""
    phase('19c kernels at the Shaw transformer\'s shapes, fp32 and bf16')
    rng = np.random.RandomState(SEED + 90)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        key = '' if dtype == torch.float32 else '_bf16'
        B, h, T, _, d = SHAW_K4_SHAPE
        k4 = k4_case(rng, B, h, T, T, d, 'pad', (B, h, T, T), dtype)
        out.setdefault('flash_attention_fwd', {'shape': SHAW_K4_SHAPE}
                       ).update({k + key: v for k, v in k4.items()})
        B, h, T, _, d = SHAW_K5_SHAPE
        errs, shares, t, bounds, _, tflops, _ = flash_train_case(
            rng, B, h, T, T, d, 'pad', (B, h, T, T), dtype)
        q, k, v, mask, bias = flash_inputs(rng, B, h, T, T, d, 'pad',
                                           (B, h, T, T), dtype)
        do = torch.randn_like(q)
        sdpa = sdpa_bias_train(q, k, v, mask, bias, 1.0 / d ** 0.5, do)
        if sdpa is not None:
            print(f'    SDPA with the bias as a float attn_mask (its '
                  f'gradient too): forward {sdpa[0]:.4f} ms, backward (dq, '
                  f'dk, dv, dmask together) {sdpa[1]:.4f} ms', flush=True)
        for i, name in enumerate(FLASH_TRAIN_KERNELS):
            out.setdefault(name, {'shape': SHAW_K5_SHAPE}).update({
                k + key: v for k, v in dict(
                    max_abs_err=errs[name], share_of_bar=shares[name],
                    ms=t[name][0], plain_ms=t[name][1],
                    bound_ms=bounds[name][0], bound_by=bounds[name][1],
                    tflops=tflops[i],
                    library_ms=None if sdpa is None else sdpa[i > 0]
                ).items()})
    return out


def options_stream_check(label, model, cpu_model, reverse_weight, k1):
    """One AsrDecoder stream (200 ms pieces) on the card against the CPU,
    partial by partial; `k1` K1 launches a chunk step -> (K1 launches,
    chunk steps)."""
    from wenet_tpu_torch.ops import flash_attention as fa
    tokenizer = flagship_tokenizer()
    wav = speech_like(np.random.RandomState(SEED + 94),
                      OPTIONS_STREAM_SECONDS)
    want = stream_utterance(streaming_decoder(
        cpu_model, 'cpu', tokenizer, reverse_weight=reverse_weight), wav)
    dec = streaming_decoder(model, 'cuda', tokenizer,
                            reverse_weight=reverse_weight)
    steps = [0]
    advance = dec._advance_one_chunk

    def counted(chunk):
        steps[0] += 1
        return advance(chunk)
    dec._advance_one_chunk = counted
    fa.reset_launches()
    got = stream_utterance(dec, wav)
    torch.cuda.synchronize()
    launches = fa.LAUNCHES['relpos_attention_fwd']
    if launches != k1 * steps[0] or not steps[0]:
        raise RuntimeError(f'{label} stream: {launches} K1 launches over '
                           f'{steps[0]} chunk steps, expected {k1} a step')
    if len(got[0]) != len(want[0]):
        raise RuntimeError(f'{label} stream: {len(got[0])} partials on the '
                           f'card, {len(want[0])} on the CPU')
    worst = max(same_results(g, w, f'{label} partial {j}')
                for j, (g, w) in enumerate(zip(got[0], want[0])))
    worst = max(worst, same_results(got[1], want[1], f'{label} final'))
    print(f'  {label} AsrDecoder, {OPTIONS_STREAM_SECONDS} s in 200 ms '
          f'pieces: {steps[0]} chunk steps, {launches} K1 launches; '
          f'{len(got[0])} partials and the final equal to the CPU\'s '
          f'(scores within {worst:.3g}); RTF '
          f'{got[2]["wall_s"] / OPTIONS_STREAM_SECONDS:.4f}', flush=True)
    return launches, steps[0]


def options_batched_check(label, model, n_streams=4, k1=None,
                          cpu_prefix_s=0.0, **opts):
    """`n_streams` AsrDecoders (STREAM_OPTS with `opts` set) over one
    BatchedChunkRunner on the card, each partial and final equal to the
    stream alone within 2e-4 (9f's BATCH_SCORE_TOL); each batched step
    launches K1 `k1` times (by default once per block); with
    `cpu_prefix_s`, each stream's first seconds decoded alone on the card
    equal the CPU's (9c's SCORE_TOL) -> (K1 launches, batched steps, the
    coalesced batch sizes).""" 
    from wenet_tpu_torch.models.transformer.streaming import StreamingConfig
    from wenet_tpu_torch.ops import flash_attention as fa
    from wenet_tpu_torch.runtime.batch_runner import BatchedChunkRunner
    tokenizer = flagship_tokenizer()
    rng = np.random.RandomState(SEED + 95)
    utts = [speech_like(rng, s) for s in STREAM_UTTS_SECONDS[:n_streams]]
    alone = [stream_utterance(streaming_decoder(model, 'cuda', tokenizer,
                                                **opts), w)[:2]
             for w in utts]
    cfg = StreamingConfig(STREAM_OPTS['chunk_size'],
                          STREAM_OPTS['num_left_chunks'],
                          model.encoder.subsampling_rate,
                          model.encoder.right_context)
    runner = BatchedChunkRunner(model, cfg, max_batch=n_streams,
                                beam_size=STREAM_OPTS['beam_size'],
                                device='cuda')
    try:
        runner.precompile(80)
        fa.reset_launches()
        got, wall = run_streams(lambda: streaming_decoder(
            model, 'cuda', tokenizer, runner, **opts), utts, 0.1)
        torch.cuda.synchronize()
        launches = fa.LAUNCHES['relpos_attention_fwd']
        hist = dict(sorted(runner.batch_sizes.items()))
    finally:
        runner.close()
    steps = sum(hist.values())
    k1 = len(model.encoder.encoders) if k1 is None else k1
    if launches != k1 * steps or not steps or max(hist) < 2:
        raise RuntimeError(f'{label} batched: {launches} K1 launches over '
                           f'{steps} steps of sizes {hist}')
    worst = 0.0
    for i, ((g_part, g_final, _), (w_part, w_final)) in enumerate(
            zip(got, alone)):
        if len(g_part) != len(w_part):
            raise RuntimeError(f'{label} stream {i}: {len(g_part)} partials '
                               f'batched, {len(w_part)} alone')
        for j, (g, w) in enumerate(zip(g_part + [g_final],
                                       w_part + [w_final])):
            what = (f'stream {i} partial {j}' if j < len(g_part) else
                    f'stream {i} final')
            worst = max(worst, same_results(g, w, what, BATCH_SCORE_TOL))
    print(f'  {label} batched serving: {n_streams} streams, {steps} batched '
          f'steps of sizes {hist}, {launches} K1 launches; every partial and '
          f'final equal to the stream alone (scores within {worst:.3g}, bar '
          f'{BATCH_SCORE_TOL["atol"]}); {wall:.2f} s', flush=True)
    if cpu_prefix_s:
        cpu_prefix_check(label, model, utts, cpu_prefix_s, **opts)
    return launches, steps, hist


def cpu_prefix_check(label, model, utts, seconds, **opts):
    """The first `seconds` of each of `utts` decoded alone on the card and
    on a CPU copy of `model`: every partial and the final equal (9c's
    SCORE_TOL)."""
    tokenizer = flagship_tokenizer()
    cpu_model = copy.deepcopy(model).cpu().eval()
    n = int(seconds * SR)
    worst = 0.0
    for i, w in enumerate(utts):
        got, want = (stream_utterance(streaming_decoder(
            m, dev, tokenizer, **opts), w[:n])[:2]
            for m, dev in ((model, 'cuda'), (cpu_model, 'cpu')))
        if len(got[0]) != len(want[0]):
            raise RuntimeError(f'{label} stream {i} prefix: '
                               f'{len(got[0])} partials on the card, '
                               f'{len(want[0])} on the CPU')
        for j, (g, c) in enumerate(zip(got[0] + [got[1]],
                                       want[0] + [want[1]])):
            what = f'{label} stream {i} prefix, result {j}'
            worst = max(worst, same_results(g, c, what))
    print(f'  {label}: the first {seconds} s of each of the {len(utts)} '
          f'streams equal on the card and the CPU (partials and final, '
          f'scores within {worst:.3g}; bar {SCORE_TOL})', flush=True)


# 2b: the fp32 error of every kernel against float64.  kernel -> (shape,
# mask kind, dropout rate), each kernel's main shape (PERF.md section 6);
# the train kernels run with and without dropout
FP32_ERROR_CASES = [
    ('K1', (16, 4, 375, 375, 64), 'pad', 0.0),
    ('K1 batched step', (8, 4, 16, 528, 64), 'batch8', 0.0),
    ('K1-train, K2, K3', (16, 4, 299, 299, 64), 'pad', 0.0),
    ('K1-train, K2, K3', (16, 4, 299, 299, 64), 'chunk', 0.1),
    ('K4-train, K5, K6', (4, 20, 1500, 1500, 64), 'pad', 0.0),
    ('K4, K4-train', (32, 4, 500, 500, 128), 'pad', 0.0),
    ('K4-train, K5, K6', (2, 4, 534, 534, 128), 'pad', 0.0),
    ('K1-train, K2, K3', (16, 2, 299, 299, 128), 'pad', 0.0),
    ('K1-train, K2, K3', (16, 2, 299, 299, 128), 'chunk', 0.1),
]
FP32_ERROR_RATIO = 3.0  # a kernel's rms error from float64 over plain's
FP32_ERROR_ID = {  # the kernels' names in 2b's readings
    'relpos_attention_fwd_train': 'K1-train',
    'relpos_attention_bwd_dq': 'K2', 'relpos_attention_bwd_dkpv': 'K3',
    'flash_attention_fwd_train': 'K4-train',
    'flash_attention_bwd_dq': 'K5', 'flash_attention_bwd_dkv': 'K6'}


def error_from(got, exact):
    """(max, rms) of |got - exact| in float64."""
    err = (got.double() - exact).abs()
    return err.max().item(), err.pow(2).mean().sqrt().item()


def fp32_error_case(rng, label, shape, mask_kind, rate):
    """One row of FP32_ERROR_CASES -> [(kernel, output, kernel's (max,
    rms), plain's (max, rms), kernel ms)]: each kernel and its plain
    version in fp32 on the same randn inputs (fp32 lse and delta rounded
    from float64 for the backward kernels, the same for both), against the
    plain version in float64."""
    from wenet_tpu_torch.ops import flash_attention as fa
    B, h, T1, T2, d = shape
    scale = 1.0 / d ** 0.5
    seed = SEED + 201
    rows = []

    def hold(kernel, names, got, plain, exact, fn):
        ms = cuda_time_ms(fn, reps=10)
        for name, g, p, e in zip(names, got, plain, exact):
            rows.append((kernel, name, error_from(g, e), error_from(p, e),
                         ms))

    def f64(ts):
        return [t.double() if t is not None and t.is_floating_point() else t
                for t in ts]

    if label.startswith('K1'):
        x, mask = kernel_inputs(rng, B, h, T1, T2, d, mask_kind,
                                torch.float32)
        if label != 'K1-train, K2, K3':
            with float64_casts():
                exact = fa.relpos_fwd_reference(*f64(x), mask, scale)[0]
            hold('K1', ['out'], [fa.relpos_fwd(*x, mask, scale)[0]],
                 [fa.relpos_fwd_reference(*x, mask, scale)[0]], [exact],
                 lambda: fa.relpos_fwd(*x, mask, scale))
            return rows
        train = dict(dropout_rate=rate, seed=seed)
        with float64_casts():
            out64, lse64 = fa.relpos_fwd_reference(*f64(x), mask, scale,
                                                   True, **train)
        hold('K1-train', ['out', 'lse'],
             fa.relpos_fwd(*x, mask, scale, True, **train),
             fa.relpos_fwd_reference(*x, mask, scale, True, **train),
             [out64, lse64],
             lambda: fa.relpos_fwd(*x, mask, scale, True, **train))
        do = torch.from_numpy(rng.randn(B, h, T1, d).astype(
            np.float32)).cuda()
        delta64 = (do.double() * out64).sum(-1)
        ins = (*x, mask, do, lse64.float(), delta64.float(), scale)
        with float64_casts():
            ex = [fa.relpos_bwd_dq_reference(*f64(x), mask, do.double(),
                                             lse64, delta64, scale, **train),
                  fa.relpos_bwd_dkpv_reference(*f64(x), mask, do.double(),
                                               lse64, delta64, scale,
                                               **train)]
        for kernel, names, fn, ref, e in (
                ('K2', ['dq1', 'dq2'], fa.relpos_bwd_dq,
                 fa.relpos_bwd_dq_reference, ex[0]),
                ('K3', ['dk', 'dp', 'dv'], fa.relpos_bwd_dkpv,
                 fa.relpos_bwd_dkpv_reference, ex[1])):
            hold(kernel, names, fn(*ins, **train), ref(*ins, **train), e,
                 lambda: fn(*ins, **train))
        return rows
    q, k, v, mask, _ = flash_inputs(rng, B, h, T1, T2, d, mask_kind, False,
                                    torch.float32)
    with float64_casts():
        out64, lse64 = fa.flash_fwd_reference(*f64((q, k, v)), mask, None,
                                              scale, True)
    if label == 'K4, K4-train':
        hold('K4', ['out'], [fa.flash_fwd(q, k, v, mask, None, scale)[0]],
             [fa.flash_fwd_reference(q, k, v, mask, None, scale)[0]],
             [out64], lambda: fa.flash_fwd(q, k, v, mask, None, scale))
    hold('K4-train', ['out', 'lse'],
         fa.flash_fwd(q, k, v, mask, None, scale, True),
         fa.flash_fwd_reference(q, k, v, mask, None, scale, True),
         [out64, lse64],
         lambda: fa.flash_fwd(q, k, v, mask, None, scale, True))
    if label == 'K4, K4-train':
        return rows
    do = torch.from_numpy(rng.randn(B, h, T1, d).astype(np.float32)).cuda()
    delta64 = (do.double() * out64).sum(-1)
    ins = (q, k, v, mask, None, do, lse64.float(), delta64.float(), scale)
    with float64_casts():
        args64 = (*f64((q, k, v)), mask, None, do.double(), lse64, delta64,
                  scale)
        dq64 = fa.flash_bwd_dq_reference(*args64)[0]
        dkv64 = fa.flash_bwd_dkv_reference(*args64)
    hold('K5', ['dq'], fa.flash_bwd_dq(*ins)[:1],
         fa.flash_bwd_dq_reference(*ins)[:1], [dq64],
         lambda: fa.flash_bwd_dq(*ins))
    hold('K6', ['dk', 'dv'], fa.flash_bwd_dkv(*ins),
         fa.flash_bwd_dkv_reference(*ins), dkv64,
         lambda: fa.flash_bwd_dkv(*ins))
    return rows


def fp32_error_check(smi):
    """Phase 2b -> {kernel: [readings]}: every kernel's fp32 output at its
    main shape against float64, beside its plain version's (max and rms
    of the error), and its time (CUDA events) at that shape.  A kernel
    whose rms error is more than FP32_ERROR_RATIO times its plain
    version's fails, after every reading is printed: wgmma does not
    round its fp32 sums to nearest, so a sum kept in its accumulator over
    a whole tile loop drifts (PERF.md section 6)."""
    phase('2b fp32 error against float64: K1-K6 and their plain versions')
    rng = np.random.RandomState(SEED + 200)
    report, worst = {}, []
    for label, shape, mask_kind, rate in FP32_ERROR_CASES:
        where = f'({",".join(map(str, shape))}) {mask_kind}' + (
            f' + dropout {rate}' if rate else '')
        for kernel, name, (kmax, krms), (pmax, prms), ms in fp32_error_case(
                rng, label, shape, mask_kind, rate):
            ratio = krms / prms
            print(f'  {kernel} {name} at {where}: max {kmax:.3g} rms '
                  f'{krms:.3g}; plain max {pmax:.3g} rms {prms:.3g}; '
                  f'{ratio:.2f}x plain\'s rms; kernel {ms:.4f} ms',
                  flush=True)
            report.setdefault(kernel, []).append(dict(
                shape=where, output=name, max_err=kmax, rms_err=krms,
                plain_max_err=pmax, plain_rms_err=prms, ratio=ratio,
                ms=ms))
            if ratio > FP32_ERROR_RATIO:
                worst.append(f'{kernel} {name} at {where} {ratio:.2f}x')
        torch.cuda.empty_cache()
    if worst:
        raise RuntimeError(f'fp32 rms error from float64 above '
                           f'{FP32_ERROR_RATIO}x the plain version\'s: '
                           f'{worst}')
    return report


def ctc_grad_precision(smi, draws=4):
    """Not run by `main`: 19b's step (B=2 x 24 s, T' = 599) over `draws`
    data draws (the first is 19b's own), the whole loss's gradients of
    the CPU and of the card in float32, the card with K4-train, K5 and K6
    and with the plain attention path, against `float64_grads`: each
    one's largest share of 12c's bar, and of that bar plus the CPU's own
    error (`hold_gradients`' float64 test)."""
    import wenet_tpu_torch.models.transformer.attention as A
    from wenet_tpu_torch.utils.executor import to_device_batch
    configs = options_configs('rope_mqa_transformer', 'hash')
    base = zoo_model(configs)

    def step(m, b, dev):
        m.train()
        m.zero_grad(set_to_none=True)
        tb = to_device_batch(b, dev)
        out = m(tb['feats'].to(next(m.parameters()).dtype),
                tb['feats_lengths'], tb['target'], tb['target_lengths'],
                generator=torch.Generator().manual_seed(SEED))
        out['loss'].backward()

    def grads(b, dev):
        m = copy.deepcopy(base).to(dev)
        step(m, b, dev)
        return {n: p.grad.double().cpu() for n, p in m.named_parameters()}

    gate = dict(A.FLASH_GATE)
    for seed in range(SEED + 92, SEED + 92 + draws):
        b = zoo_train_batch(np.random.RandomState(seed), 2, 24.0, 80, 4233)
        ref = float64_grads(base, lambda m: step(m, b, 'cpu'))
        runs = {'cpu': grads(b, 'cpu'), 'card, K4-train/K5/K6': grads(
            b, 'cuda')}
        A.FLASH_GATE.update(min_len=10 ** 9, score_elems=10 ** 18)
        try:
            runs['card, plain attention'] = grads(b, 'cuda')
        finally:
            A.FLASH_GATE.update(gate)
        line = []
        for label, gr in runs.items():
            bar = {n: 1e-3 + GRAD_SHARE * r.abs().max().item()
                   for n, r in ref.items()}
            own = {n: (runs['cpu'][n] - r).abs().max().item()
                   for n, r in ref.items()}
            gap = {n: (gr[n] - r).abs().max().item() for n, r in ref.items()}
            share, name = max((gap[n] / bar[n], n) for n in ref)
            held, hname = max((gap[n] / (bar[n] + own[n]), n) for n in ref)
            line.append(f'{label} {share:.2f} ({name}), of the bar + the '
                        f'CPU\'s own {held:.2f} ({hname})')
        print(f'  19b step, draw {seed - SEED - 92}, the whole loss against '
              f'float64, the largest share of 12c\'s bar: ' + '; '.join(line)
              + f' ({smi})', flush=True)


def zoo_options_check(smi):
    """Phase 19 but 19c's kernel timing (`shaw_kernel_check`, alone) ->
    ({kernel: launches on phase 19's paths}, readings)."""
    phase('19 the rest of the encoder and attention zoo: MoE + GQA, RoPE + '
          'MQA, Shaw, CTL, input layers')
    launches = {name: 0 for name in ('relpos_attention_fwd',
                                     'flash_attention_fwd',
                                     *TRAIN_KERNELS, *FLASH_TRAIN_KERNELS)}
    readings = {}

    def add(counted):
        for k in launches:
            launches[k] += counted.get(k, 0)

    for name in ('moe_gqa_conformer', 'rope_mqa_transformer',
                 'shaw_transformer', 'ctl'):
        sub = {'moe_gqa_conformer': '19a', 'rope_mqa_transformer': '19b',
               'shaw_transformer': '19c', 'ctl': '19d'}[name]
        phase(f'{sub} {name}')
        configs = options_configs(name)
        n_blocks = configs['encoder_conf']['num_blocks']
        conformer = configs['encoder'] in ('conformer', 'dual_conformer')
        r = readings[name] = {}
        if name in OPTIONS_DECODE:
            B, seconds, rows = OPTIONS_DECODE[name]
            model = zoo_model(configs)
            cpu_model = copy.deepcopy(model)
            k1, k4 = (n_blocks, 0) if conformer else (0, n_blocks)
            counted, rate, ties = decode_against_cpu(
                f'{sub} {name} ({os.path.basename(OPTIONS[name][0])} + '
                'overrides', configs, model, B, seconds, k1, k4, smi, rows,
                seed=SEED + 91)
            launches['relpos_attention_fwd'] += counted['K1']
            launches['flash_attention_fwd'] += counted['K4']
            r.update(decode_launches=counted, decode_audio_sec_per_s=rate,
                     hypotheses_at_ties=ties)
            if name != 'shaw_transformer':
                # `model` is on the card since the decode
                reverse = 0.3 if conformer else 0.0
                k1s, steps = options_stream_check(
                    f'{sub} {name}', model, cpu_model, reverse,
                    n_blocks if conformer else 0)
                launches['relpos_attention_fwd'] += k1s
                r['stream_steps'] = steps
                if conformer:
                    k1b, steps, hist = options_batched_check(
                        f'{sub} {name}', model)
                    launches['relpos_attention_fwd'] += k1b
                    r.update(batched_steps=steps, batch_sizes=hist)
            del model, cpu_model
            torch.cuda.empty_cache()
        (B, seconds), speed = OPTIONS_STEP[name]
        step_configs = options_configs(name, 'hash')
        # at T' = 599 the CTC term's float32 gradient, the CPU's too, sits
        # past 12c's bar from float64 (`ctc_grad_precision`): the
        # transformers' tensors past it are held to float64
        counted, share = step_against_cpu(
            f'{sub} {name}', step_configs, zoo_model(step_configs), B,
            seconds, seed=SEED + 92, watch=('rel_k_embed',),
            exact=not conformer)
        per_pass = n_blocks * (2 if name == 'ctl' else 1)
        kernels = TRAIN_KERNELS if conformer else FLASH_TRAIN_KERNELS
        if any(counted[k] != per_pass for k in kernels):
            raise RuntimeError(f'{sub} {name}: train step launches '
                               f'{counted}, expected {per_pass} of each of '
                               f'{list(kernels)}')
        add(counted)
        r.update(step_launches={k: counted[k] for k in kernels},
                 step_grad_share=share)
        if speed is not None:
            ms, counted = options_step_speed(f'{sub} {name}', step_configs,
                                             *speed, smi)
            add(counted)
            r.update(step_ms=ms, step_shape=speed)
    phase('19e input layers: linear, conv2d2, stack_n_frames')
    for layer in INPUT_LAYERS:
        configs = input_layer_configs(layer)
        counted, rate, ties = decode_against_cpu(
            f'19e {layer} (flagship at 2 + 1 + 1 blocks', configs,
            zoo_model(configs), *INPUT_LAYER_DECODE[:2], 2, 0, smi,
            INPUT_LAYER_DECODE[2], seed=SEED + 96)
        launches['relpos_attention_fwd'] += counted['K1']
        launches['flash_attention_fwd'] += counted['K4']
        readings[layer] = dict(decode_launches=counted,
                               hypotheses_at_ties=ties)
    missing = [k for k, n in launches.items() if not n]
    if missing:
        raise RuntimeError(f'phase 19 launched no {missing}')
    print(f'  phase 19 launches: {launches}', flush=True)
    return launches, readings


# ---------------------------------------------------------------------------
# 20. batched serving of the rest of the zoo, and the options the port
# refused until now
# ---------------------------------------------------------------------------
# 20a's Branchformer, which no example yaml sets: the E-Branchformer yaml
# with `encoder: branchformer`, less the options a Branchformer has no use
# for (it has no FFN and no merge conv)
BRANCHFORMER_LACKS = ('linear_units', 'merge_conv_kernel')
ZOO_SERVED = ('branchformer', 'e_branchformer', 'squeezeformer',
              'efficient_conformer')  # 20a
ZOO_SERVED_STREAMS = 6
ZOO_SERVED_CPU_S = 1.0  # 20a: each stream's prefix decoded on the CPU too
# 20b's encoder blocks of each family's base (at_blocks): the efficient
# conformer's first four are grouped, its options act on the rest
REFUSED_DEPTH = 6
# 20b: (base: 'flagship' or a zoo name, encoder_conf, decoder_conf,
# top-level overrides), each family at its base's widths
REFUSED = {
    'conformer_no_macaron_relu': (
        'flagship', dict(macaron_style=False, activation_type='relu'), {},
        {}),
    'conformer_no_cnn_module': ('flagship', dict(use_cnn_module=False), {},
                                {}),
    'conformer_conv_bias_inner': (
        'flagship', dict(conv_bias=False, conv_inner_factor=4), {}, {}),
    'decoder_post_norm_no_src': (
        'flagship', {}, dict(normalize_before=False, src_attention=False),
        {}),
    # without an output layer the decoder's log-probs are its 256 hidden
    # units: the vocabulary must fit in them
    'decoder_no_output_layer': ('flagship', {}, dict(use_output_layer=False),
                                dict(output_dim=256)),
    'branchformer_base_options': (
        'branchformer', dict(static_chunk_size=16, layer_norm_type='rms_norm',
                             cmvn_norm_var=False, query_bias=False,
                             key_bias=False, mlp_bias=False), {}, {}),
    'e_branchformer_gated_mlp': (
        'e_branchformer', dict(mlp_type='gated', mlp_bias=False,
                               final_norm=False), {}, {}),
    'squeezeformer_pre_norm_static': (
        'squeezeformer', dict(normalize_before=True, static_chunk_size=16,
                              cmvn_norm_var=False), {}, {}),
    'efficient_post_norm_static': (
        'efficient_conformer', dict(normalize_before=False,
                                    static_chunk_size=16,
                                    use_dynamic_chunk=False), {}, {}),
    'efficient_no_pos_no_cnn': (
        'efficient_conformer', dict(pos_enc_layer_type='no_pos',
                                    use_cnn_module=False), {}, {}),
}
REFUSED_DECODE = (2, 6.0, 1)  # 20b: B x seconds on the card, rows on the CPU
REFUSED_STEP = (2, 6.0)  # 20b: the card-against-CPU train step


def served_configs(name, dropout=True):
    """20a's encoders: the zoo yaml `name`, or for 'branchformer' the
    E-Branchformer yaml's (`BRANCHFORMER_LACKS`)."""
    if name != 'branchformer':
        return zoo_configs(name, dropout)
    configs = zoo_configs('e_branchformer', dropout)
    configs['encoder'] = 'branchformer'
    for key in BRANCHFORMER_LACKS:
        del configs['encoder_conf'][key]
    return configs


def refused_configs(name):
    """20b's family `name` on its base's configs at REFUSED_DEPTH encoder
    blocks, every dropout 0."""
    base, enc, dec, top = REFUSED[name]
    configs = (flagship_configs(dropout=False) if base == 'flagship' else
               served_configs(base, dropout=False))
    at_blocks(configs, REFUSED_DEPTH)
    configs['encoder_conf'].update(enc)
    configs['decoder_conf'].update(dec)
    configs.update(top)
    return configs


def rel_pos_blocks(model):
    """The encoder's attentions that run K1 (the rel-pos ones)."""
    from wenet_tpu_torch.models.transformer.attention import (
        RelPositionMultiHeadedAttention)
    return sum(type(m) is RelPositionMultiHeadedAttention
               for m in model.encoder.modules())


def zoo_served_check(smi):
    """Phase 20 -> ({kernel: launches on phase 20's paths}, readings):
    20a six streams (ZOO_SERVED_STREAMS) over one BatchedChunkRunner for
    each of Branchformer, E-Branchformer, Squeezeformer and the efficient
    conformer at full width, each equal to itself alone within 2e-4 and
    its first 1.0 s (ZOO_SERVED_CPU_S) to the CPU's, K1 once per rel-pos
    block a batched step; 20b each option family of the
    refused options at its base's widths: a decode card against CPU and
    a train step card against CPU (K1-train, K2, K3 once per rel-pos
    block)."""
    phase('20 batched serving of the rest of the zoo; the options the port '
          'refused until now')
    launches = {name: 0 for name in ('relpos_attention_fwd',
                                     'flash_attention_fwd', *TRAIN_KERNELS)}
    readings = {}
    phase(f'20a {ZOO_SERVED_STREAMS} streams batched, each against itself '
          'alone')
    for name in ZOO_SERVED:
        configs = served_configs(name)
        model = zoo_model(configs).cuda().eval()
        k1 = rel_pos_blocks(model)
        n, steps, hist = options_batched_check(
            f'20a {name} ({len(model.encoder.encoders)} blocks, '
            f'{configs["encoder_conf"].get("output_size", 256)} wide)',
            model, ZOO_SERVED_STREAMS, k1, cpu_prefix_s=ZOO_SERVED_CPU_S,
            reverse_weight=0.3 if configs['decoder'] == 'bitransformer'
            else 0.0)
        launches['relpos_attention_fwd'] += n
        readings[name] = dict(k1_per_step=k1, batched_steps=steps,
                              batch_sizes=hist, k1_launches=n)
        del model
        torch.cuda.empty_cache()
    phase('20b the refused options: decode and train step, card vs CPU')
    for name in REFUSED:
        configs = refused_configs(name)
        model = zoo_model(configs)
        k1 = rel_pos_blocks(model)
        counted, rate, ties = decode_against_cpu(
            f'20b {name} ({REFUSED[name][0]} widths', configs,
            copy.deepcopy(model), *REFUSED_DECODE[:2], k1, 0, smi,
            REFUSED_DECODE[2], seed=SEED + 120)
        launches['relpos_attention_fwd'] += counted['K1']
        launches['flash_attention_fwd'] += counted['K4']
        step, share = step_against_cpu(f'20b {name}', configs, model,
                                       *REFUSED_STEP, seed=SEED + 121)
        if any(step[k] != k1 for k in TRAIN_KERNELS):
            raise RuntimeError(f'20b {name}: train step launches {step}, '
                               f'expected {k1} of each of '
                               f'{list(TRAIN_KERNELS)}')
        for k in TRAIN_KERNELS:
            launches[k] += step[k]
        readings[name] = dict(decode_launches=counted,
                              decode_audio_sec_per_s=rate,
                              hypotheses_at_ties=ties,
                              step_launches={k: step[k]
                                             for k in TRAIN_KERNELS},
                              step_grad_share=share)
    missing = [k for k, n in launches.items()
               if not n and k != 'flash_attention_fwd']
    if missing:
        raise RuntimeError(f'phase 20 launched no {missing}')
    print(f'  phase 20 launches: {launches}', flush=True)
    return launches, readings


# ---------------------------------------------------------------------------
# 21. the rest of queue 1: recomputation, the on-device front end, LoRA-GA,
# expert parallelism
# ---------------------------------------------------------------------------
BN_CONFIG = os.path.join(REPO, 'examples/aishell/s0/conf/'
                         'train_conformer.yaml')
REMAT_STEP = (16, 12.0, 6.0)  # 21a: B x seconds, the shortest row
REMAT_BN_BLOCKS = 6  # 21a: train_conformer.yaml's BatchNorm, 6 of 12 blocks
REMAT_MODES = (False, True, 'selective')
FRONTEND_BATCH_SAMPLES = 320000  # 21b: 20 s of waveform a dynamic batch
# 21b's schedule: warmup and hold as ratios of max_steps
FRONTEND_SCHEDULE = ('NoamHoldAnnealing',
                     {'warmup_ratio': 0.2, 'hold_ratio': 0.2,
                      'max_steps': 10})
LORA_GA_BATCH = (2, 3000, 2800)  # 21c: B x frames (30 s), the shortest
SVD_GAP = 1e-3  # 21c: singular values closer (relative) span a subspace
# 21c: a singular vector, card against CPU up to its sign, within
# SVD_RTOL + SVD_NOISE x sigma_1 / its gap to the nearest singular value
# (Wedin's bound on two float32 solvers' backward errors; the top vector
# of a 1280 x 1280 gradient, well apart from the next, reads 1.3e-4
# between cuSOLVER on an H100 and LAPACK)
SVD_RTOL, SVD_NOISE = 1e-3, 1e-5


def remat_configs(label, mode):
    """21a's yaml (the flagship, or train_conformer.yaml's BatchNorm at
    REMAT_BN_BLOCKS blocks), with `gradient_checkpointing` `mode` in the
    encoder and the decoder."""
    import yaml
    if label == 'flagship':
        configs = flagship_configs()
    else:
        with open(BN_CONFIG) as f:
            configs = yaml.safe_load(f)
        configs['input_dim'], configs['output_dim'] = 80, 4233
        configs['encoder_conf']['num_blocks'] = REMAT_BN_BLOCKS
    configs['encoder_conf']['gradient_checkpointing'] = mode
    configs['decoder_conf']['gradient_checkpointing'] = bool(mode)
    return configs


def remat_step(model, b):
    """One forward + backward of `model` on the card in train mode, torch's
    and the host generator seeded with SEED -> (losses, the host
    generator's state after it, kernel launches, peak GiB allocated,
    ms)."""
    from wenet_tpu_torch.ops import flash_attention as fa
    from wenet_tpu_torch.utils.executor import to_device_batch
    tb = to_device_batch(b, 'cuda')
    model.train()
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    torch.manual_seed(SEED)
    gen = torch.Generator().manual_seed(SEED)
    t0 = time.perf_counter()
    out = model(tb['feats'], tb['feats_lengths'], tb['target'],
                tb['target_lengths'], generator=gen)
    out['loss'].backward()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    return ({k: v.item() for k, v in out.items() if v is not None},
            gen.get_state(), dict(fa.LAUNCHES),
            torch.cuda.max_memory_allocated() / 2 ** 30, ms)


def recompute_check():
    """21a -> (the K1-train, K2, K3 launches, readings)."""
    phase('21a gradient_checkpointing at full width: the flagship and '
          'train_conformer.yaml\'s BatchNorm, false / true / selective')
    from wenet_tpu_torch.utils.init_model import init_model
    B, seconds, shortest = REMAT_STEP
    launches = {k: 0 for k in TRAIN_KERNELS}
    readings = {}
    for label in ('flagship', 'batch_norm'):
        base = init_model(remat_configs(label, False),
                          torch.Generator('cuda').manual_seed(SEED),
                          device='cuda')
        with torch.no_grad():  # a cmvn that is not the identity
            g = torch.Generator('cuda').manual_seed(SEED)
            base.encoder.global_cmvn.mean.normal_(generator=g)
            base.encoder.global_cmvn.istd.uniform_(0.5, 1.5, generator=g)
        state = base.state_dict()
        n_blocks = len(base.encoder.encoders)
        b = train_batch(np.random.RandomState(SEED + 70), B, seconds,
                        shortest)
        want, rows = None, {}
        for mode in REMAT_MODES:
            model = init_model(remat_configs(label, mode), device='meta')
            model.to_empty(device='cuda')
            model.load_state_dict(state, strict=True)
            if mode is False:  # a step to warm the card up, not held
                remat_step(model, b)
                model.load_state_dict(state, strict=True)
            losses, gen_state, counts, peak, ms = remat_step(model, b)
            grads = {n: p.grad for n, p in model.named_parameters()}
            buffers = {n: t.detach().clone()
                       for n, t in model.named_buffers()}
            k1 = 2 * n_blocks if mode is True else n_blocks
            expect = dict.fromkeys(TRAIN_KERNELS, n_blocks)
            expect['relpos_attention_fwd_train'] = k1
            got = {k: counts[k] for k in TRAIN_KERNELS}
            if got != expect:
                raise RuntimeError(f'21a {label} {mode}: launches {got}, '
                                   f'expected {expect}')
            for k in TRAIN_KERNELS:
                launches[k] += got[k]
            row = dict(step_ms=ms, peak_gib=peak, launches=got)
            if want is None:
                want = (losses, gen_state, grads, buffers)
            else:
                gap = max(abs(losses[k] - v) for k, v in want[0].items())
                errs = torch.stack([(grads[n] - g).abs().max()
                                    for n, g in want[2].items()]).cpu()
                bars = 1e-3 + GRAD_SHARE * torch.stack(
                    [g.abs().max() for g in want[2].values()]).cpu()
                worst = errs.max().item()
                worst_share = (errs / bars).max().item()
                if gap > 1e-4 * abs(want[0]['loss']) + 1e-6 or \
                        worst_share > 1.0:
                    raise RuntimeError(
                        f'21a {label} {mode}: loss gap {gap}, gradient gap '
                        f'{worst} ({100 * worst_share:.0f}% of 12c\'s bar) '
                        'against the step without recomputation')
                stats = [n for n in buffers if n.endswith(
                    ('running_mean', 'running_var', 'num_batches_tracked'))]
                if label == 'batch_norm' and not stats:
                    raise RuntimeError('21a: no BatchNorm buffers')
                off = [n for n in stats
                       if not torch.equal(buffers[n], want[3][n])]
                if off:
                    raise RuntimeError(f'21a {label} {mode}: BatchNorm '
                                       f'buffers {off[:3]} differ from the '
                                       'step without recomputation')
                if not torch.equal(gen_state, want[1]):
                    raise RuntimeError(f'21a {label} {mode}: the host '
                                       'generator moved otherwise')
                row.update(loss_gap=gap, grad_gap=worst,
                           grad_share=worst_share,
                           bn_buffers_equal=len(stats))
            rows[str(mode)] = row
            print(f'  {label} ({n_blocks} blocks), B={B} x {seconds:.0f} s, '
                  f'gradient_checkpointing {mode}: step {ms:.1f} ms, peak '
                  f'{peak:.2f} GiB allocated, launches '
                  + ' '.join(f'{k[17:]}={v}' for k, v in got.items())
                  + ('' if 'loss_gap' not in row else
                     f'; against false: loss gap {row["loss_gap"]:.3g}, '
                     f'largest gradient gap {row["grad_gap"]:.3g} '
                     f'({100 * row["grad_share"]:.1f}% of 12c\'s bar), '
                     f'{row["bn_buffers_equal"]} BatchNorm buffers equal, '
                     'the host generator where false leaves it'),
                  flush=True)
            del model, grads
        readings[label] = rows
        del want
        torch.cuda.empty_cache()
    return launches, readings


def frontend_recipe(d):
    """21b's recipe: 10's written wavs (`write_recipe`) and cmvn stats; the
    flagship yaml with the on-device front end, the encoder recomputed,
    FRONTEND_SCHEDULE, dynamic batches of FRONTEND_BATCH_SAMPLES samples,
    one epoch over the first train shard -> (argv, argv with dither 0)."""
    import yaml
    from wenet_tpu_torch.bin import compute_cmvn_stats
    units, train_list, cv_list, scp, _ = write_recipe(d, flagship_tokenizer())
    with open(scp) as f:  # the first shard's wavs (`write_shards`)
        lines = f.readlines()[::RECIPE_TRAIN_SHARDS]
    scp = os.path.join(d, 'shard0.scp')
    with open(scp, 'w') as f:
        f.writelines(lines)
    cmvn = os.path.join(d, 'global_cmvn')
    compute_cmvn_stats.main(['--train_config', CONFIG, '--in_scp', scp,
                             '--out_cmvn', cmvn])
    with open(train_list) as f:
        first_shard = f.readline()
    small = os.path.join(d, 'train_shard0.list')
    with open(small, 'w') as f:
        f.write(first_shard)
    with open(CONFIG) as f:
        configs = yaml.safe_load(f)
    configs['tokenizer_conf']['symbol_table_path'] = units
    configs['cmvn_conf']['cmvn_file'] = cmvn
    configs.update(max_epoch=1, log_interval=1,
                   scheduler=FRONTEND_SCHEDULE[0],
                   scheduler_conf=dict(FRONTEND_SCHEDULE[1]))
    configs['encoder_conf']['gradient_checkpointing'] = True
    dc = configs['dataset_conf']
    dc['on_device_frontend'] = True
    dc['batch_conf']['max_frames_in_batch'] = FRONTEND_BATCH_SAMPLES
    argvs = []
    for name, dither in (('frontend', dc['fbank_conf']['dither']),
                         ('frontend_d0', 0.0)):
        dc['fbank_conf']['dither'] = dither
        path = os.path.join(d, f'{name}.yaml')
        with open(path, 'w') as f:
            yaml.safe_dump(configs, f)
        argvs.append(['--config', path, '--train_data', small, '--cv_data',
                      cv_list, '--data_type', 'shard', '--seed', str(SEED),
                      '--device', 'cuda', '--model_dir',
                      os.path.join(d, f'exp_{name}')])
    return argvs


def frontend_check(smi):
    """21b -> (launches of K1 and the training kernels, readings)."""
    phase('21b the on-device front end through bin/train.py: waveforms in '
          'the batch, fbank and SpecAugment on the card')
    import logging
    import re
    import shutil
    from wenet_tpu_torch.bin import train
    from wenet_tpu_torch.ops import flash_attention as fa
    from wenet_tpu_torch.utils.executor import to_device_batch
    from wenet_tpu_torch.utils.scheduler import build_schedule
    from wenet_tpu_torch.utils.train_utils import (frontend_conf_of,
                                                   frontend_seed,
                                                   make_frontend)
    d = tempfile.mkdtemp(prefix='chip_smoke_frontend_')
    argv, argv_d0 = frontend_recipe(d)
    # the first step, card against CPU, at dither 0
    configs, batch, tokenizer = entry_first_step(
        train.get_parser().parse_args(argv_d0))
    if batch['feats'].shape[2] != 1:
        raise RuntimeError(f'21b: the train batch is {batch["feats"].shape}'
                           ', not waveforms')
    fe = make_frontend(frontend_conf_of(configs['dataset_conf']))
    feats = [fe(to_device_batch(batch, dev), torch.Generator().manual_seed(
        frontend_seed(SEED, 0, 0)))['feats'].cpu() for dev in ('cuda', 'cpu')]
    masked = [f == 0 for f in feats]
    if not torch.equal(*masked) or not masked[0].any():
        raise RuntimeError('21b: the SpecAugment / SpecSub masks differ '
                           'between the card and the CPU')
    fbank_gap = (feats[0] - feats[1]).abs().max().item()
    print(f'  front end of the first batch {tuple(batch["feats"].shape)} -> '
          f'{tuple(feats[0].shape)}: masks equal card / CPU '
          f'({int(masked[0].sum())} zeros), features within {fbank_gap:.3g}')
    # bin/train.py at the yaml's dither
    lrs, records = [], []

    class Lrs(logging.Handler):
        def emit(self, record):
            m = re.search(r'TRAIN \|.* lr (\S+) ', record.getMessage())
            if m:
                lrs.append(float(m.group(1)))

    handler = Lrs()
    logging.getLogger().addHandler(handler)
    logging.getLogger().setLevel(logging.INFO)
    fa.reset_launches()
    t0 = time.perf_counter()
    try:
        summary = train.main(argv, on_step=records.append)
    finally:
        logging.getLogger().removeHandler(handler)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    n_steps = len(records)
    n_blocks = flagship_configs()['encoder_conf']['num_blocks']
    want = build_schedule(*FRONTEND_SCHEDULE,
                          configs['optim_conf']['lr'])
    expect = [want(s) for s in range(n_steps)]
    # the log prints six decimals
    if not n_steps or len(lrs) != n_steps or not np.allclose(
            lrs, expect, rtol=0, atol=5e-7):
        raise RuntimeError(f'21b: logged lr {lrs} against the schedule\'s '
                           f'{expect}')
    expect_launches = dict.fromkeys(TRAIN_KERNELS, n_blocks * n_steps)
    expect_launches['relpos_attention_fwd_train'] *= 2
    got = {k: launches[k] for k in TRAIN_KERNELS}
    if got != expect_launches or not launches['relpos_attention_fwd']:
        raise RuntimeError(f'21b: launches {launches} over {n_steps} steps, '
                           f'expected {expect_launches} and K1 in cv')
    cv = summary['epochs'][0]['cv']
    train_set, cv_set = train.datasets(train.get_parser().parse_args(argv),
                                       configs, tokenizer)
    dims = []
    for ds in (train_set, cv_set):
        it = iter(ds)
        dims.append(next(it)['feats'].shape[2])
        it.close()
    if dims != [1, 80] or not np.isfinite(cv['loss']):
        raise RuntimeError(f'21b: train / cv feature dims {dims}, cv {cv}')
    audio_s = sum(r['audio_frames'] for r in records) / SR
    print(f'  bin/train.py, one epoch: {n_steps} steps of B='
          f'{[r["batch"] for r in records]} waveforms, {audio_s:.1f} s of '
          f'audio in {wall:.1f} s (init, cv and save included; {smi}); lr '
          f'{[float(f"{x:.4g}") for x in lrs]} = {FRONTEND_SCHEDULE[0]}\'s; '
          f'cv loss {cv["loss"]:.4f} on host fbank (80 bins; the train '
          f'batches carry 1); launches {launches}', flush=True)
    shutil.rmtree(d)
    return launches, dict(steps=n_steps, fbank_gap=fbank_gap, wall_s=wall,
                          lr=lrs)


def svd_bars(G, r):
    """The top 2r singular vectors' bars (`SVD_RTOL`, `SVD_NOISE`) and
    relative gaps to their nearest neighbour (among the top 2r + 1
    singular values of G)."""
    s = torch.linalg.svdvals(G.float()).double().cpu()[:2 * r + 1]
    step = s[:-1] - s[1:]  # sigma_i - sigma_(i+1)
    near = torch.minimum(step, torch.cat([step[:1], step[:-1]]))[:2 * r]
    return (SVD_RTOL + SVD_NOISE * s[0] / near.clamp(min=1e-30),
            near / s[:2 * r])


def lora_ga_check(smi):
    """21c -> (the K4-train, K5, K6 launches, readings)."""
    phase('21c LoRA-GA at whisper large-v3 width (4 + 4 layers): '
          'estimate_gradient and reinit_lora on the card against the CPU')
    from wenet_tpu_torch.models.finetune.lora import (LoRALinear,
                                                      estimate_gradient,
                                                      reinit_lora)
    from wenet_tpu_torch.ops import flash_attention as fa
    from wenet_tpu_torch.utils.executor import to_device_batch
    configs = finetune_configs(4)
    n_layers = configs['encoder_conf']['num_blocks']
    B, frames, shortest = LORA_GA_BATCH
    rng = np.random.RandomState(SEED + 71)
    model = whisper_train_model(configs, torch.Generator().manual_seed(SEED),
                                'cpu')
    with torch.no_grad():  # LoRA-GA starts from B = 0
        for name, p in model.named_parameters():
            if name.endswith('lora_B'):
                p.zero_()
    cpu_model = copy.deepcopy(model)
    model.cuda()
    batches = [whisper_train_batch(rng, B, frames, shortest)
               for _ in range(2)]
    # (1) the probe of one row, card against CPU
    one = {k: v[:1] for k, v in batches[0].items()}
    got = estimate_gradient(model, [to_device_batch(one, 'cuda')])
    t0 = time.perf_counter()
    want = estimate_gradient(cpu_model, [to_device_batch(one, 'cpu')])
    cpu_s = time.perf_counter() - t0
    worst_grad = 0.0
    for n, g in want.items():
        err = (got[n].cpu() - g).abs().max().item()
        share = err / (1e-3 + GRAD_SHARE * g.abs().max().item())
        worst_grad = max(worst_grad, share)
        if share > 1.0 or not torch.isfinite(got[n]).all():
            raise RuntimeError(f'21c: the probe\'s {n} differs from the CPU '
                               f'by {err:.3g}, {100 * share:.0f}% of 12c\'s '
                               'bar')
    del got
    # (2) the probe over two batches on the card
    fa.reset_launches()
    t0 = time.perf_counter()
    grads = estimate_gradient(model, [to_device_batch(b, 'cuda')
                                      for b in batches])
    torch.cuda.synchronize()
    probe_s = time.perf_counter() - t0
    launches = {k: fa.LAUNCHES[k] for k in FLASH_TRAIN_KERNELS}
    if any(n != 2 * n_layers for n in launches.values()) or \
            fa.LAUNCHES['flash_attention_fwd']:
        raise RuntimeError(f'21c: launches {dict(fa.LAUNCHES)}, expected '
                           f'{n_layers} of each training kernel a batch')

    def loss(m, dev):
        m.eval()
        tb = to_device_batch(batches[0], dev)
        with torch.no_grad():
            return m(tb['feats'], tb['feats_lengths'], tb['target'],
                     tb['target_lengths'])['loss'].item()

    before = loss(model, 'cuda')
    # (3) the reinit on the card, and on the CPU from the same gradient
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reinit_lora(model, grads, 'gradient')
    torch.cuda.synchronize()
    svd_card_s = time.perf_counter() - t0
    cpu_grads = {n: g.cpu() for n, g in grads.items()
                 if n.endswith('.weight')}
    t0 = time.perf_counter()
    reinit_lora(cpu_model, cpu_grads, 'gradient')
    svd_cpu_s = time.perf_counter() - t0
    after = loss(model, 'cuda')
    if not abs(after - before) <= 1e-4 * abs(before):
        raise RuntimeError(f'21c: loss {before} before the reinit, {after} '
                           'after it (rtol 1e-4)')
    cpu_layers = dict(cpu_model.named_modules())
    worst_share, worst_vec, smallest_gap = 0.0, 0.0, np.inf
    subspaces, layers, worst_w = 0, 0, 0.0
    for name, m in model.named_modules():
        if not isinstance(m, LoRALinear):
            continue
        layers += 1
        r = m.lora_A.shape[0]
        c = cpu_layers[name]
        A, Bm = m.lora_A.detach().cpu(), m.lora_B.detach().cpu()
        cA, cB = c.lora_A.detach(), c.lora_B.detach()
        bars, gaps = svd_bars(grads[name + '.weight'], r)
        smallest_gap = min(smallest_gap, gaps.min().item())
        if gaps[r - 1] < SVD_GAP or gaps[r] < SVD_GAP:
            raise RuntimeError(f'21c {name}: singular values {r} and '
                               f'{r + 1} within {SVD_GAP}: A and B are not '
                               'defined')
        if gaps.min() < SVD_GAP:  # hold the spanned subspaces
            subspaces += 1
            errs = torch.tensor(
                [((x.T @ x) - (y.T @ y)).abs().max().item() /
                 (y.T @ y).abs().max().item()
                 for x, y in ((A, cA), (Bm.T, cB.T))])
            bar = torch.full_like(errs, float(bars.max()))
            sa = sb = None
        else:
            sa = torch.sign((A * cA).sum(1, keepdim=True))
            sb = torch.sign((Bm * cB).sum(0, keepdim=True))
            errs = torch.cat([(A * sa - cA).norm(dim=1) / cA.norm(dim=1),
                              (Bm * sb - cB).norm(dim=0) / cB.norm(dim=0)])
            bar = bars.float()
        share = (errs / bar).max().item()
        worst_share = max(worst_share, share)
        worst_vec = max(worst_vec, errs.max().item())
        if share > 1.0:
            raise RuntimeError(f'21c {name}: A / B off the CPU\'s by '
                               f'{errs.tolist()} (relative, up to sign; '
                               f'bars {bar.tolist()})')
        if sa is not None:  # the compensated weight, signs lined up
            w0 = m.weight.detach().cpu() + m.scaling * (Bm @ A)
            aligned = w0 - m.scaling * ((Bm * sb) @ (A * sa))
            err_w = (aligned - c.weight.detach()).abs().max().item()
            worst_w = max(worst_w, err_w)
            bar_w = 1e-6 + m.scaling * (Bm @ A).abs().max().item() * \
                bar.max().item()
            if err_w > bar_w:
                raise RuntimeError(f'21c {name}: the compensated weight '
                                   f'differs from the CPU\'s by {err_w}')
    print(f'  estimate_gradient of one 30 s row: card = CPU within '
          f'{100 * worst_grad:.1f}% of 12c\'s bar (the CPU {cpu_s:.1f} s); '
          f'over two batches of B={B} x 30 s on the card {probe_s:.2f} s, '
          f'launches {launches} ({n_layers} a batch each)', flush=True)
    print(f'  reinit_lora(\'gradient\') over {layers} layers: SVDs and '
          f'compensation {svd_card_s:.3f} s on the card, {svd_cpu_s:.2f} s '
          f'on the CPU (information; {smi}); A\'s rows and B\'s columns the '
          f'CPU\'s up to sign within {worst_vec:.3g} relative, '
          f'{100 * worst_share:.0f}% of their bars ({subspaces} layers held '
          f'as subspaces; smallest relative gap of a top-2r singular value '
          f'{smallest_gap:.3g}); the compensated weights within '
          f'{worst_w:.3g}; loss {before:.6f} -> {after:.6f} across the '
          f'reinit', flush=True)
    del model, cpu_model, grads
    torch.cuda.empty_cache()
    return launches, dict(svd_card_s=svd_card_s, svd_cpu_s=svd_cpu_s,
                          probe_s=probe_s, grad_share=worst_grad,
                          vector_err=worst_vec, vector_share=worst_share,
                          smallest_gap=smallest_gap)


def expert_parallel_recipe(d):
    """18d's recipe (`parallel_recipe`) with 19a's MoE-GQA options in
    encoder and decoder and `model_axis` (min_dim 512: only the experts
    are cut) -> the argv of bin/train.py."""
    import yaml
    argv, _ = parallel_recipe(d, flagship_tokenizer())
    with open(argv[1]) as f:
        configs = yaml.safe_load(f)
    configs['encoder_conf'].update(MOE_OPTIONS)
    configs['decoder_conf'].update(MOE_OPTIONS)
    configs['sharding_conf'] = {'model_axis': True, 'min_dim': 512}
    path = os.path.join(d, 'moe.yaml')
    with open(path, 'w') as f:
        yaml.safe_dump(configs, f)
    return ['--config', path] + argv[2:]


def expert_parallel_start():
    """21d's ranks, started: two gloo ranks of bin/train.py on the card
    with --mesh data=1,model=2 -> (dir, argv, what `finish_ranks` waits
    on)."""
    d = tempfile.mkdtemp(prefix='chip_smoke_experts_')
    argv = expert_parallel_recipe(d)
    return d, argv, start_ranks(d, 'experts', ['--nproc_per_node', '2'],
                                argv + ['--mesh', 'data=1,model=2',
                                        '--dist_backend', 'gloo'])


def expert_parallel_check(started):
    """21d -> (the K1-train, K2, K3 launches of both ranks, readings)."""
    phase('21d expert parallelism: two gloo ranks on the card, --mesh '
          'data=1,model=2, 19a\'s MoE-GQA conformer (8 experts)')
    import shutil
    from wenet_tpu_torch.bin import train
    from wenet_tpu_torch.utils.executor import to_device_batch
    d, argv, ranks_started = started
    try:
        args = train.get_parser().parse_args(
            argv + ['--model_dir', os.path.join(d, 'exp_one')])
        run = train.build(args)
        tr, _ = train.datasets(args, run.configs, run.tokenizer)
        tr.set_epoch(0)
        it = iter(tr)
        batch = next(it)
        it.close()
        _, metrics = run.train_step(run.state, to_device_batch(batch,
                                                               'cuda'),
                                    (SEED, 0))
        want = {k: float(v) for k, v in metrics.items()}
        grads = {n: p.grad.detach().cpu().clone()
                 for n, p in run.model.named_parameters()}
        shapes = {k: tuple(v.shape) for k, v in
                  run.model.state_dict().items()}
        n_experts = sum('.experts_' in k for k in shapes)
        n_blocks = len(run.model.encoder.encoders)
        del run
        torch.cuda.empty_cache()
    except BaseException:
        stop_ranks(ranks_started)
        raise
    ranks, wall = finish_ranks(ranks_started)
    if len(ranks) != 2 or len({tuple(r['steps']) for r in ranks}) != 1:
        raise RuntimeError(f'21d: {len(ranks)} rank records')
    launches = dict.fromkeys(TRAIN_KERNELS, 0)
    for r in ranks:
        steps = sum(r['steps'])
        for k in TRAIN_KERNELS:
            if r['launches'][k] != n_blocks * steps:
                raise RuntimeError(f'21d: {k} launched {r["launches"][k]} '
                                   f'times over {steps} steps')
            launches[k] += r['launches'][k]
        for k in ('loss', 'loss_att', 'loss_ctc'):
            if not abs(r['metrics'][k] - want[k]) <= 1e-4 * abs(want[k]):
                raise RuntimeError(f'21d: first step {k} {r["metrics"][k]} '
                                   f'against {want[k]} in one process')
    got = torch.load(os.path.join(d, 'experts', 'grads0.pt'),
                     map_location='cpu')
    if got.keys() != grads.keys():
        raise RuntimeError('21d: the ranks\' gradients have other keys')
    worst = 0.0
    for k, g in grads.items():
        err = (got[k] - g).abs().max().item()
        share = err / (1e-3 + GRAD_SHARE * g.abs().max().item())
        worst = max(worst, share)
        if share > 1.0:
            raise RuntimeError(f'21d: gradient of {k} off the one-process '
                               f'step by {err:.3g}')
    final = torch.load(os.path.join(d, 'exp_experts', 'final.pt'),
                       map_location='cpu')
    got_shapes = {k: tuple(v.shape) for k, v in final.items()}
    if got_shapes != shapes:
        raise RuntimeError('21d: final.pt has other keys or shapes than one '
                           'process\'s model')
    print(f'  two ranks, each with 4 of the 8 experts of every MoE layer '
          f'({n_experts} expert tensors cut): {ranks[0]["steps"]} steps each; '
          f'first loss {ranks[0]["metrics"]["loss"]:.6f} / '
          f'{ranks[1]["metrics"]["loss"]:.6f} against {want["loss"]:.6f} in '
          f'one process, gradients (the experts gathered) within '
          f'{100 * worst:.1f}% of 12c\'s bar; final.pt the one-process keys '
          f'and shapes; {wall:.1f} s; launches a rank {ranks[0]["launches"]}',
          flush=True)
    shutil.rmtree(d)
    return launches, dict(wall_s=wall, grad_share=worst,
                          steps=ranks[0]['steps'])


def queue1_check(smi):
    """Phase 21: 21d's ranks start first and run beside 21a-21c -> ({21a,
    21b, 21c, 21d: launches}, {...: readings})."""
    started = expert_parallel_start()
    try:
        out = {'21a': recompute_check(), '21b': frontend_check(smi),
               '21c': lora_ga_check(smi)}
    except BaseException:
        stop_ranks(started[2])
        raise
    out['21d'] = expert_parallel_check(started)
    return ({k: v[0] for k, v in out.items()},
            {k: v[1] for k, v in out.items()})


# ---------------------------------------------------------------------------
# The schedule: which process runs which phase, and each phase's budget
# ---------------------------------------------------------------------------
# Every top-level phase is one or more units: a function of the run's
# context (the card's name, the loaded kernels, what an earlier unit of the
# same process handed on) whose return value is named by UNITS.  A name
# that starts with '_' stays in the process (a model, a graph); the others
# are the run's results, read by `kernels_line`.  The units that time a
# kernel, and the informational throughputs (5, 6d, 7c, 8c), run first,
# in this process, alone on the card; the rest run in LANES, one child
# process each (`--lane`), side by side: they are card-against-CPU holds,
# mostly on the host's cores, and their kernel launches are counted in the
# child that makes them.  The throughputs such a phase prints (9e, 9f, 11,
# 12, 14, 16b, 18b, 19a-c, ...) are read beside the other lanes (1.4-2.5x
# their seconds alone): they compare with the same reading of another run
# of this schedule, not with one taken alone.
# --- 22: head dim 128 in rel-pos training -----------------------------------
# the flagship yaml's train step with encoder_conf.attention_heads 2, so
# d_k = 256 / 2 = 128: K1-train, K2 and K3 at B=16 x 12 s (T' = 299)
FLAGSHIP_D128_SHAPE = (16, 2, 299, 299, 128)
FLAGSHIP_D128_STEP = (4, 12.0)  # 22: B x seconds of the card-vs-CPU step


def relpos_train_case(rng, shape, mask_kind, rate, dtype):
    """K1-train, K2 and K3 at one shape and dtype through the
    `RelPosAttention` Function against the plain versions chained as the
    Function chains them, in fp32 on the same inputs: the forward (K1's
    output and lse are held to it), delta = rowsum(do·out) of the
    Function's own output, K1's (as the Function and the JAX package's
    `_relpos_vjp_bwd` take it), plain K2 and K3, and dp summed over the
    batch, so that K2 and K3 are held on the delta they were given; each
    kernel's and its plain version's time (CUDA events) on the same lse
    and delta, its bound (fp32: 3xTF32, FFMA beside it) and TFLOP/s, and
    without dropout at the pad mask SDPA's forward / backward ->
    ({kernel: share of TRAIN_TOL}, {kernel: max abs error}, {kernel: (ms,
    plain ms)}, {kernel: (bound ms, bound_by, FFMA bound ms)}, {kernel:
    TFLOP/s}, SDPA (ms, ms) or None).  6a and 22 run it."""
    from wenet_tpu_torch.ops import flash_attention as fa
    B, h, T1, T2, d = shape
    x, mask = kernel_inputs(rng, B, h, T1, T2, d, mask_kind, dtype)
    do = torch.from_numpy(
        rng.randn(B, h, T1, d).astype(np.float32)).cuda().to(dtype)
    scale = 1.0 / d ** 0.5
    seed = int(rng.randint(0, 1 << 32, dtype=np.int64))
    leaves = [t.detach().requires_grad_() for t in x]
    out = fa.flash_attention_relpos(*leaves, mask, scale, rate, seed)
    out.backward(do)
    _, lse = fa.relpos_fwd(*x, mask, scale, True, rate, seed)
    torch.cuda.synchronize()
    x32 = [t.float() for t in x]
    want, want_lse = fa.relpos_fwd_reference(*x32, mask, scale, True, rate,
                                             seed)

    def chained(out_for_delta):
        args = (mask, do.float(), want_lse,
                (do.float() * out_for_delta.float()).sum(-1), scale, rate,
                seed)
        g = list(fa.relpos_bwd_dq_reference(*x32, *args) +
                 fa.relpos_bwd_dkpv_reference(*x32, *args))
        g[3] = g[3].sum(0, keepdim=True)
        return g
    want_grads = chained(out.detach())
    grads = [t.grad for t in leaves]
    if dtype == torch.bfloat16:
        # delta from the reference's own output rounded to bf16 would hold
        # K2 and K3 to where K1's bf16 output rounds the other way, which
        # alone reads up to 105% of the bar on a peaked softmax with exact
        # kernels (tests/test_torch_relpos_bwd_precision.py)
        old = chained(want.to(dtype))
        print('    bf16 dk / dp share of the bar, delta from the rounded '
              'reference -> from K1 (the Function\'s): ' + ', '.join(
                  f'{n} {100 * share_of_bar(g, o, TRAIN_TOL[dtype]):.0f}% -> '
                  f'{100 * share_of_bar(g, w, TRAIN_TOL[dtype]):.0f}%'
                  for n, g, o, w in zip(('dk', 'dp'), grads[2:4], old[2:4],
                                        want_grads[2:4])), flush=True)
    pairs = {'relpos_attention_fwd_train': [(out, want), (lse, want_lse)],
             'relpos_attention_bwd_dq': list(zip(grads[:2], want_grads[:2])),
             'relpos_attention_bwd_dkpv': list(zip(grads[2:],
                                                   want_grads[2:]))}
    shares, errs = {}, {}
    for name, checks in pairs.items():
        shares[name] = errs[name] = 0.0
        for out_name, (got, w) in zip(TRAIN_OUTPUTS[name], checks):
            if not torch.isfinite(got).all():
                raise RuntimeError(f'{name}: {out_name} is not finite')
            torch.testing.assert_close(got.float(), w.float(),
                                       **TRAIN_TOL[dtype],
                                       msg=f'{name}: {out_name}')
            shares[name] = max(shares[name],
                               share_of_bar(got, w, TRAIN_TOL[dtype]))
            errs[name] = max(errs[name],
                             (got.float() - w.float()).abs().max().item())
    if mask_kind == 'masked_row' and (out[0, :, 5].any() or
                                      grads[0][0, :, 5].any()):
        raise RuntimeError('fully masked row is not zero')
    delta = (do.float() * want).sum(-1)
    targs = (mask, do, want_lse, delta, scale, rate, seed)
    t = {
        'relpos_attention_fwd_train': (
            cuda_time_ms(lambda: fa.relpos_fwd(*x, mask, scale, True, rate,
                                               seed)),
            cuda_time_ms(lambda: fa.relpos_fwd_reference(
                *x, mask, scale, True, rate, seed))),
        'relpos_attention_bwd_dq': (
            cuda_time_ms(lambda: fa.relpos_bwd_dq(*x, *targs)),
            cuda_time_ms(lambda: fa.relpos_bwd_dq_reference(*x, *targs))),
        'relpos_attention_bwd_dkpv': (
            cuda_time_ms(lambda: fa.relpos_bwd_dkpv(*x, *targs)),
            cuda_time_ms(lambda: fa.relpos_bwd_dkpv_reference(*x, *targs))),
    }
    n_pairs = attended_pairs(mask, B, h, T1, T2)
    common = nbytes(*x, mask, do, want_lse, delta)
    work = {'relpos_attention_fwd_train': (6 * d * n_pairs,
                                           nbytes(*x, mask, out, lse)),
            'relpos_attention_bwd_dq': (10 * d * n_pairs,
                                        common + nbytes(*grads[:2])),
            'relpos_attention_bwd_dkpv': (12 * d * n_pairs,
                                          common + nbytes(*grads[2:]))}
    bounds = {n: (*bound(*w, dtype, tf32_split=True), bound(*w)[0])
              for n, w in work.items()}
    tflops = {n: w[0] / t[n][0] / 1e9 for n, w in work.items()}
    sdpa = None
    if rate == 0.0 and mask_kind == 'pad':
        sdpa = relpos_sdpa_train(x, mask, do, scale, out, grads)
    where = f'({",".join(map(str, shape))}) {mask_kind} dropout {rate}'
    print(f'  {where} {str(dtype)[6:]}: max_abs_err ' + ', '.join(
        f'{n[17:]} {errs[n]:.3g} ({100 * v:.0f}% of TRAIN_TOL)'
        for n, v in shares.items()) + f'; {n_pairs / 1e6:.2f}M attended '
        'pairs', flush=True)
    print('    kernel / plain / bound ms: ' + ', '.join(
        f'{n[17:]} {a:.4f} / {b:.4f} / {bounds[n][0]:.4f} ({bounds[n][1]}'
        + (f', FFMA {bounds[n][2]:.4f}' if dtype == torch.float32 else '')
        + f'; {tflops[n]:.1f} TFLOP/s)' for n, (a, b) in t.items()),
        flush=True)
    return shares, errs, t, bounds, tflops, sdpa


@contextlib.contextmanager
def plain_relpos():
    """Within: rel-pos attention on CUDA tensors runs the plain versions of
    K1-K3 (cuBLAS products on the card) in place of the kernels."""
    from wenet_tpu_torch.ops import flash_attention as fa
    saved = fa.relpos_fwd, fa.relpos_bwd_dq, fa.relpos_bwd_dkpv
    fa.relpos_fwd = fa.relpos_fwd_reference
    fa.relpos_bwd_dq = fa.relpos_bwd_dq_reference
    fa.relpos_bwd_dkpv = fa.relpos_bwd_dkpv_reference
    try:
        yield
    finally:
        fa.relpos_fwd, fa.relpos_bwd_dq, fa.relpos_bwd_dkpv = saved


def relpos_step_check(label, configs, B, seconds):
    """A rel-pos model's step (22's: every dropout 0) three times: on
    the card through
    K1-train, K2 and K3, on the card through their plain versions, and on
    the CPU.  The kernels' step equals the card's plain one (every loss
    term within rtol 1e-4, every gradient within 12c's bar): what the
    kernels alone change.  Against the CPU the loss terms within rtol
    1e-4 and every gradient within 12c's bar, a tensor past it held to
    float64 as 17b holds it; a tensor past that too must miss it as far
    with plain attention on the card (within 12c's bar of the plain
    step's gradient), so that the miss is the card's and not the
    kernels' (the subsampling conv's weight at B=4 x 12 s: ROADMAP.md
    queue 3) -> (the kernels' launches in the step, the largest share of
    12c's bar against the card's plain step)."""
    from wenet_tpu_torch.ops import flash_attention as fa
    from wenet_tpu_torch.utils.executor import to_device_batch
    cpu_model = flagship_model(configs)
    card = copy.deepcopy(cpu_model).cuda()
    b = zoo_train_batch(np.random.RandomState(SEED + 31), B, seconds,
                        configs['input_dim'], configs['output_dim'])

    def step(m, dev):
        m.train()
        m.zero_grad(set_to_none=True)
        tb = to_device_batch(b, dev)
        out = m(tb['feats'].to(next(m.parameters()).dtype),
                tb['feats_lengths'], tb['target'], tb['target_lengths'],
                generator=torch.Generator().manual_seed(SEED))
        out['loss'].backward()
        losses = {k: v.item() for k, v in out.items()
                  if v is not None and k != 'th_accuracy'}
        return losses, {n: p.grad.detach().cpu()
                        for n, p in m.named_parameters()}
    fa.reset_launches()
    kernels = step(card, 'cuda')
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    with plain_relpos():
        plain = step(card, 'cuda')
    cpu = step(cpu_model, 'cpu')
    for what, (losses, _) in (('the card\'s plain step', plain),
                              ('the CPU', cpu)):
        for k, w in losses.items():
            if not abs(kernels[0][k] - w) <= 1e-4 * abs(w) + 1e-6:
                raise RuntimeError(f'22: {k} {kernels[0][k]} against '
                                   f'{what}\'s {w}, beyond rtol 1e-4')
    grads64, of_plain, of_cpu, missed = None, 0.0, 0.0, []
    for name, g in kernels[1].items():
        if not torch.isfinite(g).all():
            raise RuntimeError(f'22: {name} has no finite gradient')
        w, pg = cpu[1][name], plain[1][name]
        bar = 1e-3 + GRAD_SHARE * w.abs().max().item()
        share = (g - pg).abs().max().item() / bar
        if share > 1.0:
            raise RuntimeError(f'22: {name} grad with the kernels differs '
                               f'from the card\'s plain step by '
                               f'{share * bar:.3g} (bar {bar:.3g})')
        of_plain = max(of_plain, share)
        err = (g - w).abs().max().item()
        if err > bar:  # 17b's hold: the bar plus the CPU's own error
            if grads64 is None:
                grads64 = float64_grads(cpu_model,
                                        lambda m: step(m, 'cpu'))
            e64 = grads64[name]
            card64 = (g.double() - e64).abs().max().item()
            cpu64 = (w.double() - e64).abs().max().item()
            plain64 = (pg.double() - e64).abs().max().item()
            if card64 > bar + cpu64:
                if plain64 <= bar + cpu64:
                    raise RuntimeError(
                        f'22: {name} grad misses the float64 hold ('
                        f'{card64:.3g} > {bar:.3g} + {cpu64:.3g}) where '
                        f'the card\'s plain step ({plain64:.3g}) does not')
                missed.append(f'{name} |card - f64| {card64:.3g}, plain on '
                              f'the card {plain64:.3g}, |cpu - f64| '
                              f'{cpu64:.3g}, bar {bar:.3g}')
                continue
            err, bar = card64, bar + cpu64
        of_cpu = max(of_cpu, err / bar)
    print(f'  {label}, train step B={B} x {seconds:.0f} s: loss card {kernels[0]["loss"]:.6f}, plain '
          f'attention on the card {plain[0]["loss"]:.6f}, cpu '
          f'{cpu[0]["loss"]:.6f} (rtol 1e-4); {len(kernels[1])} grads, at '
          f'most {100 * of_plain:.0f}% of 12c\'s bar from the card\'s '
          f'plain step, {100 * of_cpu:.0f}% from the CPU (17b\'s float64 '
          f'hold past 12c\'s bar); missing that hold as far with plain '
          f'attention on the card: ' + ('; '.join(missed) or 'none'),
          flush=True)
    del card, cpu_model
    torch.cuda.empty_cache()
    return launches, of_plain


def subsampling_grad_precision(smi):
    """Not run by `main`: `relpos_step_check` of the flagship as written
    (four heads of d = 64) at 22's size, to show that its subsampling
    conv's weight gradient misses 12c's bar and the float64 hold on the
    card with d = 64 too, and with plain attention on the card alike
    (ROADMAP.md queue 3)."""
    phase('the flagship\'s subsampling-conv gradient at B=4 x 12 s, '
          f'4 heads ({smi})')
    relpos_step_check('flagship, 4 heads of d = 64',
                      flagship_configs(dropout=False), *FLAGSHIP_D128_STEP)


def head_dim_128_check(smi):
    """Phase 22 -> ({kernel: launches}, readings): K1-train, K2 and K3 at
    the flagship's step with two heads (d = 128) against their plain
    versions, fp32 and bf16, timed; then that step (12 blocks, B=4 x 12
    s, dropout 0) on the card against the card's plain versions and the
    CPU (`relpos_step_check`), a launch of each kernel a block."""
    phase('22 K1-train, K2, K3 at head dim 128, and the flagship step with '
          'two heads')
    rng = np.random.RandomState(SEED + 220)
    report = {n: {} for n in TRAIN_KERNELS}
    for mask_kind, rate in (('chunk', 0.1), ('pad', 0.0)):
        for dtype in (torch.float32, torch.bfloat16):
            key = '' if dtype == torch.float32 else '_bf16'
            shares, _, t, bounds, tflops, sdpa = relpos_train_case(
                rng, FLAGSHIP_D128_SHAPE, mask_kind, rate, dtype)
            for n in TRAIN_KERNELS:
                if sdpa is None:  # the main shape: chunk + dropout 0.1
                    report[n].update({
                        'ms' + key: t[n][0], 'plain_ms' + key: t[n][1],
                        'bound_ms' + key: bounds[n][0],
                        'bound_by' + key: bounds[n][1],
                        'tflops' + key: tflops[n],
                        'share_of_bar' + key: shares[n]})
                    if dtype == torch.float32:
                        report[n]['bound_ms_ffma'] = bounds[n][2]
                else:
                    report[n].update({
                        'ms_pad' + key: t[n][0],
                        'library_ms' + key: sdpa[
                            0 if n == 'relpos_attention_fwd_train' else 1]})
            torch.cuda.empty_cache()
    configs = flagship_configs(dropout=False)
    configs['encoder_conf']['attention_heads'] = 2
    blocks = configs['encoder_conf']['num_blocks']
    launches, of_bar = relpos_step_check('flagship, 2 heads of d = 128',
                                         configs, *FLAGSHIP_D128_STEP)
    for n in TRAIN_KERNELS:
        if launches[n] != blocks:
            raise RuntimeError(f'22: {n} launched {launches[n]} times in the '
                               f'step, expected {blocks} (one a block)')
    shape = '(' + ','.join(map(str, FLAGSHIP_D128_SHAPE)) + ')'
    return ({n: launches[n] for n in TRAIN_KERNELS},
            dict(kernels=report, step_grad_share=of_bar,
                 shape=f'{shape} chunk, dropout 0.1; ms_pad and SDPA at the '
                 'pad mask, no dropout'))


UNITS = {  # unit: (top-level phase, fn(context), names of its results)
    '2b': ('2b', lambda c: fp32_error_check(c['smi']), ('fp32_errors',)),
    '3': ('3', lambda c: kernel_check(), ('report',)),
    '4': ('4', lambda c: slice_check(c['fa']), ('_runner', 'launches')),
    '5': ('5', lambda c: speed(c.pop('_runner'), c['smi']), ()),
    '6a': ('6', lambda c: train_kernel_check(), ('train_report',)),
    '6b': ('6', lambda c: mask_check(), ()),
    '6c': ('6', lambda c: train_check(), ('train_launches',)),
    '6d': ('6', lambda c: train_speed(c['smi']), ()),
    '7a': ('7', lambda c: flash_kernel_check(), ('flash_report',)),
    '7b': ('7', lambda c: whisper_check(), ('flash_launches',)),
    '7c': ('7', lambda c: whisper_speed(c['smi']), ()),
    '8a': ('8', lambda c: flash_train_kernel_check(),
           ('flash_train_report',)),
    '8b': ('8', lambda c: whisper_train_check(), ('flash_train_launches',)),
    '8c': ('8', lambda c: whisper_train_speed(c['smi']), ()),
    '9': ('9', lambda c: streaming_checks(c['smi']),
          ('stream_launches', 'stream_readings', 'batched_launches',
           'batched_readings')),
    '10': ('10', lambda c: train_entry_check(c['smi']), ('entry_launches',)),
    '11': ('11', lambda c: recognize_check(c['smi']),
           ('recognize_launches', 'recognize_readings')),
    '12': ('12', lambda c: zoo_check(c['smi']),
           ('zoo_launches', 'zoo_readings')),
    '13ab': ('13', lambda c: tlg_check(c['smi']),
             ('wfst_launches', 'wfst_readings', '_lang')),
    '13c': ('13', lambda c: export_stage_check(c['smi']),
            ('export_launches', 'export_readings')),
    '14': ('14', lambda c: transducer_check(c['smi']),
           ('rnnt_launches', 'rnnt_readings')),
    '15': ('15', lambda c: whisper_recipe_check(c['smi']),
           ('whisper_launches', 'whisper_readings')),
    '16a': ('16', lambda c: paraformer_kernel_check(), ('para_kernels',)),
    '16be': ('16', lambda c: paraformer_check(c['smi']),
             ('para_launches', 'para_readings')),
    '17': ('17', lambda c: ssl_k2_check(c['smi']),
           ('ssl_k2_launches', 'ssl_k2_readings')),
    '18': ('18', lambda c: scale_check(c['_lang'], c['smi']),
           ('scale_launches', 'scale_readings')),
    '19ck': ('19', lambda c: shaw_kernel_check(), ('opt_kernels',)),
    '19': ('19', lambda c: zoo_options_check(c['smi']),
           ('opt_launches', 'opt_readings')),
    '20': ('20', lambda c: zoo_served_check(c['smi']),
           ('served_launches', 'served_readings')),
    '21': ('21', lambda c: queue1_check(c['smi']),
           ('q1_launches', 'q1_readings')),
    '22': ('22', lambda c: head_dim_128_check(c['smi']),
           ('d128_launches', 'd128_readings')),
}
# alone on the card, in this order: the kernels' times, the throughputs,
# and this slice's phase, held to its own budget (PHASE_BUDGET_S)
ALONE = ['2b', '3', '4', '5', '6a', '6b', '6d', '7a', '7c', '8a', '8c', '16a',
         '19ck', '20', '21', '22']
# then these side by side, each lane's units in order (18 reads 13a's
# TLG), balanced by their seconds beside each other (PERF.md, chip_smoke's
# phases)
LANES = [['12', '16be', '10', '7b'], ['14', '11', '8b'],
         ['13ab', '18', '19', '9'], ['15', '17', '13c', '6c']]
# each top-level phase's budget: a wait inside it (a server's clients, a
# stream's thread, a rank) that outlasts it raises with the phase's name,
# and a lane may take the sum of its phases' budgets.  About three times
# each phase's seconds beside the other lanes (PERF.md, chip_smoke's
# phases), so that a slow host passes and a hang fails before the script's
# 1200 s
PHASE_BUDGET_S = {'2b': 45, '3': 60, '4': 45, '5': 30, '6': 120, '7': 120,
                  '8': 120, '9': 240, '10': 150, '11': 240, '12': 300,
                  '13': 360, '14': 360, '15': 240, '16': 240, '17': 240,
                  '18': 240, '19': 240, '20': 180, '21': 180, '22': 60}
SCRIPT_BUDGET_S = 1150.0  # the lanes are stopped by then, whatever is left
_BUDGET = {'phase': None, 'deadline': None}


def budget_left():
    """Seconds left of the running phase's budget (at least 1); a phase
    called on its own (not through `run_unit`) has the largest budget."""
    if _BUDGET['deadline'] is None:
        return float(max(PHASE_BUDGET_S.values()))
    return max(1.0, _BUDGET['deadline'] - time.monotonic())


def over_budget(what):
    """Raise: `what` still runs at the end of the running phase's budget."""
    name = _BUDGET['phase']
    raise TimeoutError(f'phase {name}: {what} still running at the end of '
                       f'the phase\'s budget of '
                       f'{PHASE_BUDGET_S.get(name, budget_left()):.0f} s')


def run_unit(unit, context, seconds):
    """Run `unit` under its phase's budget -> its results by name (those
    named '_...' go into `context` only); its seconds go into `seconds`
    (unit -> s) and are printed."""
    top, fn, names = UNITS[unit]
    _BUDGET.update(phase=top, deadline=time.monotonic() +
                   PHASE_BUDGET_S[top])
    t0 = time.perf_counter()
    try:
        out = fn(context)
    finally:
        _BUDGET.update(phase=None, deadline=None)
    seconds[unit] = time.perf_counter() - t0
    print(f'  phase {unit} took {seconds[unit]:.1f} s', flush=True)
    got = dict(zip(names, (out,) if len(names) == 1 else out or (),
                   strict=True))
    context.update(got)
    return {k: v for k, v in got.items() if not k.startswith('_')}


def refuse_foreign():
    """Raise if jax or the JAX package (wenet_tpu) was imported."""
    foreign = [m for m in sys.modules
               if m == 'jax' or m.startswith('jax.') or m == 'wenet_tpu'
               or m.startswith('wenet_tpu.')]
    if foreign:
        raise RuntimeError(f'imported jax or the JAX package: {foreign[:5]}')


def run_lane(units, out_path):
    """`--lane`: the units in order in this process; their results and
    seconds go to `out_path` as JSON."""
    from wenet_tpu_torch.ops import flash_attention as fa
    smi = device()
    fa.build()  # built by the parent: loads the libraries
    context, results, seconds = dict(smi=smi, fa=fa), {}, {}
    for unit in units:
        results.update(run_unit(unit, context, seconds))
    refuse_foreign()
    results['peak_reserved_gib'] = torch.cuda.max_memory_reserved() / 2 ** 30
    with open(out_path, 'w') as f:
        json.dump(dict(results=results, seconds=seconds), f)


def start_lanes(d):
    """Start each of LANES as a child process -> [(units, process, log
    path, result path)]."""
    # this process's intra-op threads (the cores it may run on), shared
    threads = max(1, torch.get_num_threads() // len(LANES))
    print(f'  {len(LANES)} lanes of {threads} threads', flush=True)
    env = dict(os.environ, OMP_NUM_THREADS=str(threads),
               CHIP_SMOKE_AT=str(time.perf_counter() - _T0))
    started = []
    for i, units in enumerate(LANES):
        log, out = (os.path.join(d, f'lane{i}.{ext}') for ext in
                    ('log', 'json'))
        with open(log, 'w') as f:
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), '--lane',
                 ','.join(units), out], cwd=REPO, env=env, stdout=f,
                stderr=subprocess.STDOUT)
        started.append((units, proc, log, out))
    return started


def finish_lanes(started, deadline):
    """Wait for the lanes -> (merged results, unit seconds, each lane's
    wall seconds and peak reserved memory).  A lane that fails or outlasts
    its phases' budgets (or the script's) stops every lane and raises,
    after printing its log."""
    t0 = time.perf_counter()
    results, seconds, walls = {}, {}, []
    try:
        for units, proc, log, out in started:
            budget = sum(PHASE_BUDGET_S[UNITS[u][0]] for u in units)
            left = min(budget - (time.perf_counter() - t0),
                       deadline - time.monotonic())
            try:
                rc = proc.wait(timeout=max(1.0, left))
            except subprocess.TimeoutExpired:
                rc = None
            with open(log, errors='replace') as f:
                text = f.read()
            print(f'== lane {",".join(units)} (exit {rc}, '
                  f'{time.perf_counter() - t0:.0f} s after the lanes '
                  f'started)\n' + text, end='' if text.endswith('\n')
                  else '\n', flush=True)
            if rc is None:
                running = [u for u in units if f'phase {u} took' not in text]
                raise TimeoutError(f'lane {",".join(units)}: phase '
                                   f'{running[0] if running else units[-1]} '
                                   'still running at the end of the lane\'s '
                                   f'budget of {budget} s')
            if rc != 0:
                raise RuntimeError(f'lane {",".join(units)} failed '
                                   f'(exit {rc})')
            with open(out) as f:
                got = json.load(f)
            walls.append(dict(units=units, wall_s=time.perf_counter() - t0,
                              peak_reserved_gib=got['results'].pop(
                                  'peak_reserved_gib')))
            results.update(got['results'])
            seconds.update(got['seconds'])
    finally:
        for _, proc, _, _ in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return results, seconds, walls


def phase_seconds(seconds):
    """Unit seconds -> each top-level phase's (the sum of its units')."""
    out = {}
    for unit, s in seconds.items():
        top = UNITS[unit][0] if unit in UNITS else unit
        out[top] = out.get(top, 0.0) + s
    return {k: round(v, 1) for k, v in out.items()}


def kernels_line(r):
    """The kernel report (the contract's line) from the merged results."""
    zoo, rnnt, scale = r['zoo_launches'], r['rnnt_launches'], r['scale_launches']
    opt, served, para = (r['opt_launches'], r['served_launches'],
                         r['para_launches'])
    whisper, errors = r['whisper_launches'], r['fp32_errors']
    q1, d128 = r['q1_launches'], r['d128_launches']
    remat, frontend, lora_ga, experts = (q1[k] for k in ('21a', '21b', '21c',
                                                         '21d'))
    ssl, k2 = ({k: v[part] for k, v in r['ssl_k2_launches'].items()}
               for part in ('ssl', 'k2'))
    k1 = 'relpos_attention_fwd'
    kernels = [{
        'name': k1, 'route': 'cuda',
        'source': 'wenet_tpu_torch/csrc/relpos_attention.cu',
        'replaces': 'wenet_tpu/ops/flash_attention.py:548',
        'launches': r['launches'] + r['stream_launches'] +
        r['batched_launches'] + r['recognize_launches'] + zoo[k1] +
        r['wfst_launches'] + r['export_launches'] + rnnt[k1] + ssl[k1] +
        k2[k1] + scale[k1] + opt[k1] + served[k1] + frontend[k1],
        **r['report'], 'launches_frontend_cv': frontend[k1],
        'fp32_error': errors['K1'],
        'launches_zoo_served': served[k1], 'zoo_served': r['served_readings'],
        'launches_zoo': zoo[k1], 'zoo_decode': r['zoo_readings'],
        'launches_decode': r['launches'],
        'launches_streaming': r['stream_launches'],
        'launches_batched_serving': r['batched_launches'],
        'launches_train_entry': r['entry_launches'][k1],
        'launches_recognize': r['recognize_launches'],
        'streaming': r['stream_readings'],
        'batched_serving': r['batched_readings'],
        'recognize': r['recognize_readings'],
        'launches_wfst': r['wfst_launches'],
        'launches_export': r['export_launches'],
        'stage67': dict(r['wfst_readings'], export=r['export_readings']),
        'launches_transducer': rnnt[k1], 'transducer': r['rnnt_readings'],
        'launches_ssl': ssl[k1], 'launches_k2': k2[k1],
        'ssl_k2': r['ssl_k2_readings'],
        'launches_scale': scale[k1], 'scale': r['scale_readings'],
        'launches_zoo_options': opt[k1], 'zoo_options': r['opt_readings']}]
    for name, (source, replaces) in TRAIN_KERNELS.items():
        kernels.append(dict(name=name, route='cuda', source=source,
                            replaces=replaces,
                            launches=r['train_launches'][name] + zoo[name] +
                            rnnt[name] + ssl[name] + k2[name] +
                            scale[name] + opt[name] + served[name] +
                            remat[name] + frontend[name] + experts[name] +
                            d128[name],
                            launches_head_dim_128=d128[name],
                            head_dim_128=dict(
                                r['d128_readings']['kernels'][name],
                                shape=r['d128_readings']['shape'],
                                step_grad_share=r['d128_readings'][
                                    'step_grad_share']),
                            launches_zoo_served=served[name],
                            launches_remat=remat[name],
                            launches_frontend=frontend[name],
                            launches_expert_parallel=experts[name],
                            fp32_error=errors[FP32_ERROR_ID[name]],
                            launches_train_entry=r['entry_launches'][name],
                            launches_zoo=zoo[name],
                            launches_transducer=rnnt[name],
                            launches_ssl=ssl[name], launches_k2=k2[name],
                            launches_scale=scale[name],
                            launches_zoo_options=opt[name],
                            **r['train_report'][name]))
    k4 = 'flash_attention_fwd'
    kernels.append(dict(name=k4, route='cuda',
                        source='wenet_tpu_torch/csrc/flash_attention.cu',
                        replaces='wenet_tpu/ops/flash_attention.py:68',
                        launches=r['flash_launches'] + zoo[k4] +
                        whisper[k4] + para[k4] + opt[k4] + served[k4],
                        launches_zoo_served=served[k4],
                        fp32_error=errors['K4'],
                        launches_zoo_options=opt[k4],
                        shaw=r['opt_kernels'][k4],
                        launches_zoo=zoo[k4],
                        launches_whisper_recipe=whisper[k4],
                        whisper_recipe=r['whisper_readings'],
                        launches_paraformer=para[k4],
                        paraformer=dict(r['para_kernels'][k4],
                                        **r['para_readings']),
                        **r['flash_report']))
    for name, (source, replaces) in FLASH_TRAIN_KERNELS.items():
        kernels.append(dict(name=name, route='cuda', source=source,
                            replaces=replaces,
                            launches=r['flash_train_launches'][name] +
                            zoo[name] + whisper[name] + para[name] +
                            opt[name] + lora_ga[name],
                            launches_zoo_options=opt[name],
                            launches_lora_ga=lora_ga[name],
                            fp32_error=errors[FP32_ERROR_ID[name]],
                            shaw=r['opt_kernels'][name],
                            launches_zoo=zoo[name],
                            launches_whisper_recipe=whisper[name],
                            launches_paraformer=para[name],
                            paraformer=r['para_kernels'][name],
                            **r['flash_train_report'][name]))
    return kernels


def main(argv=None):
    """With no arguments every phase (ALONE here, then LANES side by
    side), then the phases' seconds, the kernel report and the contract's
    last line.  `--phases 11,13c` runs those units alone in this process
    (after the build) and prints their seconds; `--lane UNITS OUT` is a
    lane's child process."""
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ['--lane']:
        return run_lane(argv[1].split(','), argv[2])
    seconds = {}
    t0 = time.perf_counter()
    smi = device()
    seconds['1'] = time.perf_counter() - t0
    build()
    seconds['2'] = time.perf_counter() - t0 - seconds['1']
    from wenet_tpu_torch.ops import flash_attention as fa
    context, results = dict(smi=smi, fa=fa), {}
    if argv[:1] == ['--phases']:
        for unit in argv[1].split(','):
            run_unit(unit, context, seconds)
        refuse_foreign()
        print(json.dumps({'phase_seconds': phase_seconds(seconds)}))
        return
    if argv:
        raise SystemExit(f'chip_smoke: unknown arguments {argv}')
    for unit in ALONE:
        results.update(run_unit(unit, context, seconds))
    context.clear()
    torch.cuda.empty_cache()
    phase(f'lanes: {" | ".join(",".join(units) for units in LANES)}')
    d = tempfile.mkdtemp(prefix='chip_smoke_lanes_')
    deadline = time.monotonic() - (time.perf_counter() - _T0) + \
        SCRIPT_BUDGET_S
    lane_results, lane_seconds, walls = finish_lanes(start_lanes(d), deadline)
    results.update(lane_results)
    seconds.update(lane_seconds)
    refuse_foreign()
    kernels = kernels_line(results)
    total = time.perf_counter() - _T0
    print(f'== done (at {total:.0f} s)')
    print(json.dumps({'phase_seconds': phase_seconds(seconds),
                      'unit_seconds': {k: round(v, 1)
                                       for k, v in seconds.items()},
                      'lanes': walls, 'total_s': round(total, 1),
                      'card': smi}))
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
