"""Websocket server over a model directory.  Counterpart of
wenet_tpu/bin/websocket_server_main.py, on --device (default cuda).

    python -m wenet_tpu_torch.bin.websocket_server_main \\
        --model_dir exp/u2pp --port 10086 --batch_serving --max_batch 8

With --batch_serving the connections' chunk steps go through one
`BatchedChunkRunner`, which steps up to --max_batch streams as one batch;
before serving it runs one step at every batch size (skipped with
--no_precompile).  --context_path names a file of phrases, one a line,
that bias every connection's prefix beam by --context_score a token."""

import argparse
import logging
import time


def get_args(argv=None):
    parser = argparse.ArgumentParser(description='websocket asr server')
    parser.add_argument('--port', type=int, default=10086)
    parser.add_argument('--host', default='0.0.0.0')
    parser.add_argument('--model_dir', required=True,
                        help='dir with train.yaml + final checkpoint')
    parser.add_argument('--chunk_size', type=int, default=16)
    parser.add_argument('--num_left_chunks', type=int, default=-1)
    parser.add_argument('--beam_size', type=int, default=10)
    parser.add_argument('--ctc_weight', type=float, default=0.5)
    parser.add_argument('--rescoring_weight', type=float, default=1.0,
                        help='only 1 (any other value raises)')
    parser.add_argument('--reverse_weight', type=float, default=0.0)
    parser.add_argument('--blank_scale', type=float, default=1.0)
    parser.add_argument('--blank_threshold', type=float, default=0.8)
    parser.add_argument('--context_path', default=None)
    parser.add_argument('--context_score', type=float, default=6.0)
    parser.add_argument('--batch_serving', action='store_true',
                        help='coalesce concurrent sessions into one '
                             'batched chunk step')
    parser.add_argument('--max_batch', type=int, default=8)
    parser.add_argument('--no_precompile', action='store_true',
                        help='skip the warm-up step at every batch size '
                             '(batch serving only)')
    parser.add_argument('--device', default='cuda')
    return parser.parse_args(argv)


def build_factory(args):
    """-> (a factory of connection decoders over the model directory's
    model, the batch runner they share or None)."""
    from wenet_tpu_torch.models.transformer.streaming import StreamingConfig
    from wenet_tpu_torch.runtime.asr_decoder import AsrDecoder, DecodeOptions
    from wenet_tpu_torch.runtime.endpoint import CtcEndpointConfig
    from wenet_tpu_torch.runtime.feature_pipeline import (
        FeaturePipelineConfig)
    from wenet_tpu_torch.utils.checkpoint import load_model_dir
    t0 = time.monotonic()
    model, configs, tokenizer = load_model_dir(args.model_dir, args.device)
    context_graph = None
    if args.context_path:
        from wenet_tpu_torch.utils.context_graph import ContextGraph
        context_graph = ContextGraph(args.context_path,
                                     tokenizer.symbol_table,
                                     context_score=args.context_score)
    logging.info('server: model loaded (%.1fs)', time.monotonic() - t0)
    opts = DecodeOptions(chunk_size=args.chunk_size,
                         num_left_chunks=args.num_left_chunks,
                         ctc_weight=args.ctc_weight,
                         rescoring_weight=args.rescoring_weight,
                         reverse_weight=args.reverse_weight,
                         beam_size=args.beam_size)
    ep = CtcEndpointConfig(blank_scale=args.blank_scale,
                           blank_threshold=args.blank_threshold)
    feat_cfg = FeaturePipelineConfig.from_configs(configs)

    batch_runner = None
    if args.batch_serving:
        from wenet_tpu_torch.runtime.batch_runner import BatchedChunkRunner
        cfg = StreamingConfig(
            decoding_chunk_size=args.chunk_size,
            num_decoding_left_chunks=args.num_left_chunks,
            subsampling_rate=model.encoder.subsampling_rate,
            right_context=model.encoder.right_context)
        batch_runner = BatchedChunkRunner(model, cfg,
                                          max_batch=args.max_batch,
                                          beam_size=args.beam_size,
                                          blank_id=ep.blank,
                                          device=args.device)
        if not args.no_precompile:
            sizes = batch_runner.precompile(idim=feat_cfg.num_mel_bins)
            logging.info('server: one step at batch sizes %s (%.1fs)',
                         sizes, time.monotonic() - t0)

    def decoder_factory():
        return AsrDecoder(model, tokenizer, opts, feat_cfg, ep,
                          context_graph=context_graph,
                          batch_runner=batch_runner, device=args.device)

    return decoder_factory, batch_runner


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    from wenet_tpu_torch.runtime.websocket.server import WebSocketServer
    args = get_args(argv)
    factory, batch_runner = build_factory(args)
    try:
        WebSocketServer(args.host, args.port, factory).start()
    finally:
        if batch_runner is not None:
            batch_runner.close()


if __name__ == '__main__':
    main()
