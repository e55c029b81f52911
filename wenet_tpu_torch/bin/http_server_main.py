"""HTTP ASR server: POST a wav (or raw 16 kHz s16le samples), get the
final result as JSON.  Counterpart of `make_handler` and `make_server` of
wenet_tpu/bin/http_server_main.py, on the standard library's
`ThreadingHTTPServer`, which answers each request on a thread of its
own: every request builds a fresh decoder with `decoder_factory` (an
`AsrDecoder` over one model that all requests share on the card).

    server = make_server(lambda: AsrDecoder(model, tokenizer, opts), 10088)
    server.serve_forever()

or from a model directory (train.yaml, units.txt, final.pt), on --device
(default cuda):

    python -m wenet_tpu_torch.bin.http_server_main --model_dir exp/u2pp \
        --port 10088
"""

import argparse
import json
import logging
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from wenet_tpu_torch.dataset.audio import read_wav

logger = logging.getLogger(__name__)


def make_handler(decoder_factory):
    class Handler(BaseHTTPRequestHandler):

        def do_POST(self):
            length = int(self.headers.get('Content-Length', 0))
            body = self.rfile.read(length)
            try:
                pcm = read_wav(bytes(body))[0][0]  # the first channel
            except ValueError:  # not a wav: raw 16 kHz s16le
                pcm = np.frombuffer(body[:len(body) // 2 * 2],
                                    '<i2').astype(np.float32) / 32768.0
            dec = decoder_factory()
            dec.accept_waveform(pcm)
            dec.set_input_finished()
            dec.decode()
            dec.rescoring()
            nbest = [{'sentence': r.sentence, 'score': r.score}
                     for r in dec.result]
            data = json.dumps({'status': 'ok', 'type': 'final_result',
                               'nbest': nbest},
                              ensure_ascii=False).encode('utf-8')
            self.send_response(200)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, fmt, *fmt_args):
            logger.info(fmt, *fmt_args)

    return Handler


def make_server(decoder_factory, port: int,
                host: str = '') -> ThreadingHTTPServer:
    """A threading server on (host, port); host '' listens on every
    interface, port 0 takes a free port (`server.server_address`)."""
    return ThreadingHTTPServer((host, port), make_handler(decoder_factory))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--model_dir', required=True)
    p.add_argument('--port', type=int, default=10088)
    p.add_argument('--host', default='')
    p.add_argument('--chunk_size', type=int, default=16)
    p.add_argument('--beam_size', type=int, default=10)
    p.add_argument('--device', default='cuda')
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from wenet_tpu_torch.bin.decoder_main import build_decoder, decoder_args
    from wenet_tpu_torch.runtime.asr_decoder import AsrDecoder
    # the model is loaded once; each request's decoder shares it
    proto = build_decoder(decoder_args(
        model_dir=args.model_dir, chunk_size=args.chunk_size,
        beam_size=args.beam_size, device=args.device))

    def factory():
        return AsrDecoder(proto.model, proto.tokenizer, proto.opts,
                          proto.feature_pipeline.config,
                          post_processor=proto.post_processor,
                          device=args.device)

    server = make_server(factory, args.port, args.host)
    logger.info('http server listening on :%d', server.server_address[1])
    try:
        server.serve_forever()
    finally:
        server.server_close()
