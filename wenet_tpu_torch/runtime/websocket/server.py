"""Websocket ASR server speaking the reference JSON protocol.
Counterpart of wenet_tpu/runtime/websocket/server.py.  Protocol:
  client -> text {"signal": "start", "nbest": N,
                  "continuous_decoding": bool}
         -> binary int16 pcm frames (16 kHz)
         -> text {"signal": "end"}
  server -> {"status": "ok", "type": "server_ready"}
         -> {"status": "ok", "type": "partial_result", "nbest": "..."}
         -> {"status": "ok", "type": "final_result", "nbest": "..."}
         -> {"status": "ok", "type": "speech_end"}
(nbest is a JSON-serialized array of {sentence, word_pieces}.)  Each
connection's decoder runs on the event loop's executor threads, so many
connections decode at once; with a batch runner their chunk steps share
one batched step.  `websockets` is imported when the server starts.
"""

import asyncio
import json
import logging
from typing import Optional

import numpy as np

from wenet_tpu_torch.runtime.asr_decoder import AsrDecoder, DecodeState

logger = logging.getLogger(__name__)


def serialize_result(results, enable_timestamp: bool = False) -> str:
    nbest = []
    for r in results:
        obj = {'sentence': r.sentence}
        if enable_timestamp:
            obj['word_pieces'] = [
                {'word': w.word, 'start': w.start, 'end': w.end}
                for w in r.word_pieces
            ]
        nbest.append(obj)
    return json.dumps(nbest, ensure_ascii=False)


class ConnectionHandler:
    """One websocket connection."""

    def __init__(self, ws, decoder_factory):
        self.ws = ws
        self.decoder_factory = decoder_factory
        self.decoder: Optional[AsrDecoder] = None
        self.nbest = 1
        self.continuous_decoding = False
        self.timestamp = False

    async def send(self, obj):
        await self.ws.send(json.dumps(obj, ensure_ascii=False))

    async def on_speech_start(self, msg):
        self.nbest = int(msg.get('nbest', 1))
        self.continuous_decoding = bool(
            msg.get('continuous_decoding', False))
        self.timestamp = bool(msg.get('enable_timestamp', False))
        self.decoder = self.decoder_factory()
        await self.send({'status': 'ok', 'type': 'server_ready'})

    async def on_speech_data(self, data: bytes):
        assert self.decoder is not None, 'no start signal received'
        if len(data) % 2:  # partial int16 frame: drop the dangling byte
            data = data[:-1]
        pcm = np.frombuffer(data, '<i2')
        if pcm.size == 0:
            return True
        loop = asyncio.get_running_loop()
        # 0-based index of the binary data chunk this decode (and any
        # result it emits) answers, echoed as `chunk_idx` so that latency
        # harnesses can pair results with sends even when silent chunks
        # produce no message (reference clients ignore the field)
        self._chunk_idx = getattr(self, '_chunk_idx', -1) + 1
        self.decoder.accept_waveform(pcm)
        state = await loop.run_in_executor(None, self.decoder.decode)
        if state == DecodeState.END_POINT:
            await loop.run_in_executor(None, self.decoder.rescoring)
            await self.send({
                'status': 'ok', 'type': 'final_result',
                'chunk_idx': self._chunk_idx,
                'nbest': serialize_result(
                    self.decoder.result[:self.nbest], self.timestamp)})
            if self.continuous_decoding:
                self.decoder.reset_continuous_decoding()
            else:
                await self.send({'status': 'ok', 'type': 'speech_end'})
                return False
        elif self.decoder.result:
            await self.send({
                'status': 'ok', 'type': 'partial_result',
                'chunk_idx': self._chunk_idx,
                'nbest': serialize_result(
                    self.decoder.result[:self.nbest], False)})
        return True

    async def on_speech_end(self):
        assert self.decoder is not None
        loop = asyncio.get_running_loop()
        self.decoder.set_input_finished()
        await loop.run_in_executor(None, self.decoder.decode)
        await loop.run_in_executor(None, self.decoder.rescoring)
        await self.send({
            'status': 'ok', 'type': 'final_result',
            'chunk_idx': getattr(self, '_chunk_idx', -1),
            'nbest': serialize_result(self.decoder.result[:self.nbest],
                                      self.timestamp)})
        await self.send({'status': 'ok', 'type': 'speech_end'})

    async def run(self):
        """Per-connection loop.  Malformed frames answer with a
        `failed` status and keep the CONNECTION alive; unexpected
        errors tear down only this connection: sibling sessions and
        the accept loop are unaffected."""
        try:
            async for message in self.ws:
                if isinstance(message, (bytes, bytearray)):
                    if self.decoder is None:
                        await self.send({
                            'status': 'failed',
                            'message': 'binary frame before start'})
                        continue
                    keep = await self.on_speech_data(bytes(message))
                    if not keep:
                        break
                else:
                    try:
                        msg = json.loads(message)
                    except (ValueError, TypeError):
                        await self.send({'status': 'failed',
                                         'message': 'malformed json'})
                        continue
                    signal = (msg.get('signal')
                              if isinstance(msg, dict) else None)
                    if signal == 'start':
                        await self.on_speech_start(msg)
                    elif signal == 'end':
                        if self.decoder is None:
                            await self.send({
                                'status': 'failed',
                                'message': 'end before start'})
                            continue
                        await self.on_speech_end()
                        break
                    else:
                        await self.send({'status': 'failed',
                                         'message': 'unknown signal'})
        except Exception as e:  # noqa: BLE001
            logger.exception('connection error: %s', e)


class WebSocketServer:

    def __init__(self, host: str, port: int, decoder_factory):
        self.host = host
        self.port = port
        self.decoder_factory = decoder_factory

    async def serve(self):
        import websockets
        # ping_timeout: a saturated host can starve the event loop past
        # the 20 s websockets default, which would tear every live
        # connection down with 1011 "keepalive ping timeout"; keep pings
        # flowing but give peers a generous window to answer
        async with websockets.serve(self._handle, self.host, self.port,
                                    max_size=None,
                                    ping_interval=20, ping_timeout=300):
            logger.info('listening on %s:%d', self.host, self.port)
            await asyncio.Future()

    async def _handle(self, ws):
        await ConnectionHandler(ws, self.decoder_factory).run()

    def start(self):
        asyncio.run(self.serve())
