"""gRPC bidirectional streaming ASR service, wire-compatible with the
reference's wenet.ASR/Recognize.  Counterpart of
wenet_tpu/runtime/grpc/server.py.

The service is registered with a generic handler (no grpc_python_plugin
is needed); the messages come from the protoc-generated `wenet_pb2`.
`grpc` and `google.protobuf` are imported when a server or a stream
starts, not with this module."""

import logging
from concurrent import futures
from typing import Iterator

import numpy as np

from wenet_tpu_torch.runtime.asr_decoder import DecodeState

logger = logging.getLogger(__name__)


def _pb2():
    from wenet_tpu_torch.runtime.grpc import wenet_pb2
    return wenet_pb2


def _result_to_nbest(results, n):
    pb = _pb2()
    out = []
    for r in results[:n]:
        ob = pb.Response.OneBest(sentence=r.sentence)
        for w in r.word_pieces:
            ob.wordpieces.append(
                pb.Response.OnePiece(word=w.word, start=w.start, end=w.end))
        out.append(ob)
    return out


class AsrServicer:
    """wenet.ASR/Recognize: a decode_config message, then audio messages
    of int16 samples; every decode answers with a partial result or, at
    an endpoint, a final one."""

    def __init__(self, decoder_factory):
        self.decoder_factory = decoder_factory

    def Recognize(self, request_iterator: Iterator, context):
        pb = _pb2()
        decoder = None
        nbest = 1
        continuous = False
        finalized = False
        for req in request_iterator:
            if req.WhichOneof('RequestPayload') == 'decode_config':
                nbest = max(req.decode_config.nbest_config, 1)
                continuous = req.decode_config.continuous_decoding_config
                decoder = self.decoder_factory()
                yield pb.Response(status=pb.Response.ok,
                                  type=pb.Response.server_ready)
                continue
            if decoder is None:
                raise ValueError('decode_config must come first')
            decoder.accept_waveform(np.frombuffer(req.audio_data, '<i2'))
            state = decoder.decode()
            if state == DecodeState.END_POINT:
                decoder.rescoring()
                yield pb.Response(
                    status=pb.Response.ok, type=pb.Response.final_result,
                    nbest=_result_to_nbest(decoder.result, nbest))
                if continuous:
                    decoder.reset_continuous_decoding()
                else:
                    # this endpoint closed the utterance: no second final
                    finalized = True
                    break
            elif decoder.result:
                yield pb.Response(
                    status=pb.Response.ok, type=pb.Response.partial_result,
                    nbest=_result_to_nbest(decoder.result, nbest))
        if decoder is not None and not finalized:
            decoder.set_input_finished()
            decoder.decode()
            decoder.rescoring()
            yield pb.Response(
                status=pb.Response.ok, type=pb.Response.final_result,
                nbest=_result_to_nbest(decoder.result, nbest))
        yield pb.Response(status=pb.Response.ok,
                          type=pb.Response.speech_end)


def make_server(decoder_factory, port: int, workers: int = 4):
    """A gRPC server on [::]:port with `workers` threads (not started)."""
    import grpc
    pb = _pb2()
    servicer = AsrServicer(decoder_factory)
    handler = grpc.method_handlers_generic_handler('wenet.ASR', {
        'Recognize': grpc.stream_stream_rpc_method_handler(
            servicer.Recognize,
            request_deserializer=pb.Request.FromString,
            response_serializer=pb.Response.SerializeToString),
    })
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=workers))
    server.add_generic_rpc_handlers((handler,))
    server.add_insecure_port(f'[::]:{port}')
    return server


def recognize_stream(channel, pcm_chunks, nbest: int = 1,
                     continuous: bool = False):
    """Send one stream of int16 byte chunks over a grpc channel -> the
    responses."""
    pb = _pb2()
    stub = channel.stream_stream(
        '/wenet.ASR/Recognize',
        request_serializer=pb.Request.SerializeToString,
        response_deserializer=pb.Response.FromString)

    def gen():
        yield pb.Request(decode_config=pb.Request.DecodeConfig(
            nbest_config=nbest, continuous_decoding_config=continuous))
        for chunk in pcm_chunks:
            yield pb.Request(audio_data=chunk)

    return list(stub(gen()))
