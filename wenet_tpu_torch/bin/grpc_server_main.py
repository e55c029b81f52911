"""gRPC server over a model directory.  Counterpart of
wenet_tpu/bin/grpc_server_main.py, on --device (default cuda).

    python -m wenet_tpu_torch.bin.grpc_server_main --model_dir exp/u2pp \
        --port 10087
"""

import argparse
import logging


def get_args(argv=None):
    parser = argparse.ArgumentParser(description='grpc asr server')
    parser.add_argument('--port', type=int, default=10087)
    parser.add_argument('--workers', type=int, default=4)
    parser.add_argument('--model_dir', required=True)
    parser.add_argument('--chunk_size', type=int, default=16)
    parser.add_argument('--num_left_chunks', type=int, default=-1)
    parser.add_argument('--beam_size', type=int, default=10)
    parser.add_argument('--ctc_weight', type=float, default=0.5)
    parser.add_argument('--reverse_weight', type=float, default=0.0)
    parser.add_argument('--device', default='cuda')
    return parser.parse_args(argv)


def build_factory(args):
    """A factory of stream decoders over the model directory's model."""
    from wenet_tpu_torch.runtime.asr_decoder import AsrDecoder, DecodeOptions
    from wenet_tpu_torch.runtime.feature_pipeline import (
        FeaturePipelineConfig)
    from wenet_tpu_torch.utils.checkpoint import load_model_dir
    model, configs, tokenizer = load_model_dir(args.model_dir, args.device)
    opts = DecodeOptions(chunk_size=args.chunk_size,
                         num_left_chunks=args.num_left_chunks,
                         ctc_weight=args.ctc_weight,
                         reverse_weight=args.reverse_weight,
                         beam_size=args.beam_size)
    feat_cfg = FeaturePipelineConfig.from_configs(configs)

    def factory():
        return AsrDecoder(model, tokenizer, opts, feat_cfg,
                          device=args.device)

    return factory


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    from wenet_tpu_torch.runtime.grpc.server import make_server
    args = get_args(argv)
    server = make_server(build_factory(args), args.port, args.workers)
    server.start()
    logging.info('grpc server listening on %d', args.port)
    server.wait_for_termination()


if __name__ == '__main__':
    main()
