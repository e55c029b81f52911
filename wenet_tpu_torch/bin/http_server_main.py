"""HTTP ASR server: POST a wav (or raw 16 kHz s16le samples), get the
final result as JSON.  Counterpart of `make_handler` and `make_server` of
wenet_tpu/bin/http_server_main.py, on the standard library's
`ThreadingHTTPServer`, which answers each request on a thread of its
own: every request builds a fresh decoder with `decoder_factory` (an
`AsrDecoder` over one model that all requests share on the card).  The
`--model_dir` entry point is not ported.

    server = make_server(lambda: AsrDecoder(model, tokenizer, opts), 10088)
    server.serve_forever()
"""

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
