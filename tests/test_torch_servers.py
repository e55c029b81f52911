"""The port's model-directory entry points and servers against the JAX
package's, at a tiny width, on one model directory that the tests write
(train.yaml, units.txt, a JSON cmvn file and final.pt from the JAX
package's `save_torch_checkpoint`): `load_model_dir` and its checkpoint
formats, `decoder_main`, the HTTP main, `WenetRecognizer`, and the
websocket and gRPC servers (with `--batch_serving` for the websocket one).

Bars: result files, JSON answers and protocol messages identical (they
hold sentences and timestamps, no scores); the HTTP answer's scores
within 2e-4, its rescored first within 2e-3 absolute / 1e-5 relative (as
tests/test_torch_runtime.py holds the final)."""

import asyncio
import json
import os
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
import yaml

from test_torch_runtime import SYMS, _wave
from torch_port_utils import IDIM, jax_model, tiny_config

CHUNK = ['--chunk_size', '4', '--num_left_chunks', '2', '--beam_size', '3']


@pytest.fixture(autouse=True)
def jax_host_settings(monkeypatch):
    """The JAX package's feature pipeline on its numpy fbank (the one the
    port copies), and no persistent compile cache from its mains."""
    monkeypatch.setattr('wenet_tpu.runtime.native_fbank.available',
                        lambda: False)
    monkeypatch.setenv('WENET_TPU_NO_COMPILE_CACHE', '1')


@pytest.fixture(scope='module')
def model_dir(tmp_path_factory):
    """A model directory as training leaves it.  Its cmvn file holds other
    stats than the checkpoint's: the JAX package reads the file, then the
    checkpoint overwrites them; the port reads the checkpoint's alone."""
    from wenet_tpu.utils.checkpoint import save_torch_checkpoint
    d = tmp_path_factory.mktemp('model_dir')
    cfg = tiny_config()
    _, variables = jax_model(cfg, seed=21)
    save_torch_checkpoint(variables, str(d / 'final.pt'))
    (d / 'units.txt').write_text(''.join(f'{k} {v}\n'
                                         for k, v in SYMS.items()))
    (d / 'global_cmvn').write_text(json.dumps({
        'mean_stat': [3.0] * IDIM, 'var_stat': [40.0] * IDIM,
        'frame_num': 2}))
    for key in ('input_dim', 'output_dim'):
        del cfg[key]  # as a training yaml: from fbank_conf and the units
    cfg.update({
        'tokenizer': 'char',
        'tokenizer_conf': dict(cfg['tokenizer_conf'],
                               symbol_table_path=str(d / 'units.txt'),
                               non_lang_syms_path=None,
                               split_with_space=False),
        'cmvn_conf': {'cmvn_file': str(d / 'global_cmvn'),
                      'is_json_cmvn': True},
        'dataset_conf': {'fbank_conf': {'num_mel_bins': IDIM,
                                        'frame_shift': 10,
                                        'frame_length': 25, 'dither': 0.0}},
    })
    with open(d / 'train.yaml', 'w') as f:
        yaml.safe_dump(cfg, f)
    return str(d)


def _jax_model_dir(model_dir):
    """What the JAX package's server mains load from a model directory."""
    from wenet_tpu.cli.model import _find_checkpoint
    from wenet_tpu.utils.config import load_config
    from wenet_tpu.utils.init_model import init_model, init_variables
    from wenet_tpu.utils.init_tokenizer import init_tokenizer
    configs = load_config(os.path.join(model_dir, 'train.yaml'))
    tokenizer = init_tokenizer(configs)
    configs.setdefault('input_dim', configs['dataset_conf'].get(
        'fbank_conf', {}).get('num_mel_bins', 80))
    configs.setdefault('output_dim', tokenizer.vocab_size())
    model, configs = init_model(None, configs)
    variables, _ = init_variables(model, configs,
                                  checkpoint=_find_checkpoint(model_dir))
    return model, variables, tokenizer, configs


def test_load_model_dir_matches_jax(model_dir, tmp_path):
    """final.pt loads strict with the checkpoint's cmvn stats, which the
    JAX package ends with too; a TorchScript final.zip of the same weights
    loads the same; an orbax final/ directory raises."""
    from wenet_tpu_torch.utils.checkpoint import (find_checkpoint,
                                                  load_model_dir,
                                                  state_dict_from_jax)
    model, configs, tokenizer = load_model_dir(model_dir, 'cpu')
    assert not model.training
    assert (configs['input_dim'], configs['output_dim']) == (IDIM, len(SYMS))
    assert tokenizer.symbol_table == SYMS
    _, jvars, _, _ = _jax_model_dir(model_dir)
    want = state_dict_from_jax(jvars)
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert not torch.allclose(got['encoder.global_cmvn.mean'],
                              torch.full((IDIM,), 1.5))  # not the file's

    # a TorchScript archive holding the same state dict
    holder = torch.nn.Module()
    for key, val in torch.load(os.path.join(model_dir, 'final.pt')).items():
        *path, leaf = key.split('.')
        m = holder
        for seg in path:
            if not hasattr(m, seg):
                m.add_module(seg, torch.nn.Module())
            m = getattr(m, seg)
        m.register_buffer(leaf, val)
    zdir = tmp_path / 'zip'
    zdir.mkdir()
    for name in ('train.yaml', 'units.txt'):
        (zdir / name).write_bytes(open(os.path.join(model_dir, name),
                                       'rb').read())
    torch.jit.save(torch.jit.script(holder), str(zdir / 'final.zip'))
    assert find_checkpoint(str(zdir)).endswith('final.zip')
    zmodel, _, _ = load_model_dir(str(zdir), 'cpu')
    for k, v in zmodel.state_dict().items():
        assert torch.equal(v, got[k]), k

    (zdir / 'final').mkdir()  # an orbax checkpoint comes first
    with pytest.raises(NotImplementedError, match='save_torch_checkpoint'):
        load_model_dir(str(zdir), 'cpu')


def test_load_checkpoint_reference_layouts(tmp_path):
    """A checkpoint as torch training leaves it (a `state_dict` key,
    `module.` prefixes, a persisted `pe` table) and one of a batch-norm
    conv module from the JAX package's `save_torch_checkpoint` (no
    `num_batches_tracked`) load strict into the port's model."""
    from wenet_tpu.utils.checkpoint import save_torch_checkpoint
    from wenet_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                  state_dict_from_jax)
    from wenet_tpu_torch.utils.init_model import init_model
    cfg = tiny_config(cnn_module_norm='batch_norm')
    _, variables = jax_model(cfg, seed=3)
    want = state_dict_from_jax(variables)
    save_torch_checkpoint(variables, str(tmp_path / 'jax.pt'))
    assert not any(k.endswith('num_batches_tracked')
                   for k in torch.load(tmp_path / 'jax.pt'))
    torch.save({'state_dict': {
        **{'module.' + k: v for k, v in want.items()},
        'module.encoder.embed.pos_enc.pe': torch.zeros(1, 50, 64)},
        'epoch': 3}, tmp_path / 'ddp.pt')
    for name in ('jax.pt', 'ddp.pt'):
        model = init_model(cfg, device='cpu')
        assert load_checkpoint(model, str(tmp_path / name)) == {}
        got = model.state_dict()
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (name, k)


def _wav_scp(tmp_path, seeds=((3, 1.6), (4, 2.3))):
    from wenet_tpu_torch.dataset.audio import write_wav
    lines = []
    for i, (seed, seconds) in enumerate(seeds):
        path = tmp_path / f'utt{i}.wav'
        write_wav(path, _wave(seed, seconds), 16000)
        lines.append(f'utt{i} {path}\n')
    scp = tmp_path / 'wav.scp'
    scp.write_text(''.join(lines))
    return str(scp)


def test_decoder_main_matches_jax(model_dir, tmp_path):
    from wenet_tpu.bin import decoder_main as jax_main
    from wenet_tpu_torch.bin import decoder_main
    scp = _wav_scp(tmp_path)
    args = ['--model_dir', model_dir, '--wav_scp', scp, *CHUNK,
            '--reverse_weight', '0.3']
    jax_main.main(args + ['--result_file', str(tmp_path / 'jax.txt')])
    decoder_main.main(args + ['--result_file', str(tmp_path / 'port.txt'),
                              '--device', 'cpu'])
    want = (tmp_path / 'jax.txt').read_text(encoding='utf-8')
    assert (tmp_path / 'port.txt').read_text(encoding='utf-8') == want
    lines = want.splitlines()
    assert [line.split()[0] for line in lines] == ['utt0', 'utt1']
    assert all(len(line.split()) == 2 for line in lines)  # text decoded


def test_decoder_main_raises_for_what_is_not_ported(model_dir, tmp_path):
    """--dict_path without --fst_path raises, and so does a TLG that is not
    there; WFST decoding (tests/test_torch_wfst.py) and --lm_path
    (tests/test_torch_recognize.py) are ported."""
    from wenet_tpu_torch.bin import decoder_main
    scp = _wav_scp(tmp_path, ((3, 0.5),))
    for extra, error in ((['--dict_path', 'words.txt'], ValueError),
                         (['--fst_path', str(tmp_path / 'TLG.txt')],
                          RuntimeError)):
        with pytest.raises(error):
            decoder_main.main(['--model_dir', model_dir, '--wav_scp', scp,
                               '--device', 'cpu', *extra])
    # FLAC is read since the port has its decoder: a malformed stream
    # raises as a bad wav does
    flac = tmp_path / 'a.flac'
    flac.write_bytes(b'fLaC' + bytes(64))
    with pytest.raises(ValueError, match='flac'):
        decoder_main.main(['--model_dir', model_dir, '--wav_path', str(flac),
                           '--device', 'cpu'])


def test_rescoring_weight_other_than_one_raises(model_dir):
    """The rescoring weighs the attention score by 1, as the JAX package
    does: another weight raises rather than change nothing."""
    from wenet_tpu_torch.bin import websocket_server_main
    from wenet_tpu_torch.runtime.asr_decoder import DecodeOptions
    assert DecodeOptions(rescoring_weight=1.0).rescoring_weight == 1.0
    with pytest.raises(NotImplementedError, match='rescoring_weight'):
        DecodeOptions(rescoring_weight=0.5)
    with pytest.raises(NotImplementedError, match='rescoring_weight'):
        websocket_server_main.build_factory(websocket_server_main.get_args(
            ['--model_dir', model_dir, '--rescoring_weight', '0.5',
             '--device', 'cpu']))


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _http_main_answer(monkeypatch, module, argv, body):
    """Run `module.main(argv)` on a thread, POST `body` once, stop the
    server -> the JSON answer."""
    made = []
    make = module.make_server
    monkeypatch.setattr(module, 'make_server',
                        lambda *a, **kw: made.append(make(*a, **kw)) or
                        made[-1])
    port = _free_port()
    serve = threading.Thread(target=module.main,
                             args=(argv + ['--port', str(port)],),
                             daemon=True)
    serve.start()
    deadline = time.monotonic() + 120
    while not made and time.monotonic() < deadline:
        time.sleep(0.05)
    assert made, 'the server did not start'
    try:
        req = urllib.request.Request(f'http://127.0.0.1:{port}/', data=body,
                                     method='POST')
        with urllib.request.urlopen(req, timeout=120) as resp:
            return json.loads(resp.read())
    finally:
        made[0].shutdown()
        serve.join(timeout=30)
        assert not serve.is_alive()


def test_http_main_matches_jax(model_dir, tmp_path, monkeypatch):
    from wenet_tpu.bin import http_server_main as jax_http
    from wenet_tpu_torch.bin import http_server_main
    from wenet_tpu_torch.dataset.audio import write_wav
    write_wav(tmp_path / 'a.wav', _wave(5, 1.8), 16000)
    body = (tmp_path / 'a.wav').read_bytes()
    argv = ['--model_dir', model_dir, '--chunk_size', '4', '--beam_size',
            '3']
    want = _http_main_answer(monkeypatch, jax_http, argv, body)
    got = _http_main_answer(monkeypatch, http_server_main,
                            argv + ['--device', 'cpu', '--host', '127.0.0.1'],
                            body)
    assert got['status'] == want['status'] == 'ok'
    assert got['type'] == want['type'] == 'final_result'
    assert [r['sentence'] for r in got['nbest']] == \
        [r['sentence'] for r in want['nbest']]
    g = [r['score'] for r in got['nbest']]
    w = [r['score'] for r in want['nbest']]
    np.testing.assert_allclose(g[1:], w[1:], atol=2e-4, rtol=0)
    np.testing.assert_allclose(g[:1], w[:1], atol=2e-3, rtol=1e-5)
    assert got['nbest'][0]['sentence']


def _recognizer_run(rec, pcm):
    """nbest 2, timestamps, continuous decoding; 0.3 s pieces, the last
    with last=1 -> the JSON answers."""
    rec.set_nbest(2)
    rec.set_timestamp(1)
    rec.set_continuous_decoding(1)
    piece = 4800
    out = []
    for lo in range(0, len(pcm), piece):
        last = int(lo + piece >= len(pcm))
        out.append(rec.decode(pcm[lo:lo + piece].tobytes(), last))
    return out


@pytest.mark.parametrize('max_utterance_ms', [20000, 1200])
def test_wenet_recognizer_matches_jax(model_dir, monkeypatch,
                                      max_utterance_ms):
    """The default endpoint rules, and rule 3 cut to 1.2 s in both
    packages, so that continuous decoding closes segments mid-stream."""
    from wenet_tpu.runtime import api as jax_api
    from wenet_tpu.runtime import endpoint as jax_endpoint
    from wenet_tpu_torch.runtime import api, endpoint
    for mod in (jax_endpoint, endpoint):
        def init(self, config=None, frame_shift_in_ms=40, mod=mod,
                 orig=mod.CtcEndpoint.__init__):
            orig(self, config or mod.CtcEndpointConfig(
                rule3=mod.CtcEndpointRule(False, 0, max_utterance_ms)),
                frame_shift_in_ms)
        monkeypatch.setattr(mod.CtcEndpoint, '__init__', init)
    pcm = np.round(np.concatenate([_wave(6, 2.5), np.zeros(16000),
                                   _wave(7, 1.5)]) * 32768).astype('<i2')
    jrec = jax_api.wenet_init(model_dir)
    want = _recognizer_run(jrec, pcm)
    rec = api.wenet_init(model_dir, device='cpu')
    got = _recognizer_run(rec, pcm)
    assert got == want
    finals = [json.loads(m)['type'] for m in got].count('final_result')
    assert finals == (1 if max_utterance_ms > 5000 else 4)
    final = json.loads(got[-1])
    assert final['type'] == 'final_result'
    assert final['nbest'][0]['sentence']
    assert final['nbest'][0]['word_pieces']
    # a context phrase (which raised before biasing was ported) biases
    # the decoder the next reset builds, as in the JAX package
    for r, mod in ((rec, api), (jrec, jax_api)):
        mod.wenet_add_context(r, 'ab')
        mod.wenet_reset(r)
    assert api.wenet_decode(rec, pcm[:16000].tobytes()) == \
        jax_api.wenet_decode(jrec, pcm[:16000].tobytes())


def _jax_factory(model_dir):
    from wenet_tpu.runtime.asr_decoder import AsrDecoder, DecodeOptions
    from wenet_tpu.runtime.feature_pipeline import FeaturePipelineConfig
    model, variables, tokenizer, configs = _jax_model_dir(model_dir)
    opts = DecodeOptions(chunk_size=4, num_left_chunks=2, beam_size=3)
    feat = FeaturePipelineConfig.from_configs(configs)
    return lambda: AsrDecoder(model, variables, tokenizer, opts, feat)


def _ws_args(model_dir, *extra):
    from wenet_tpu_torch.bin.websocket_server_main import get_args
    return get_args(['--model_dir', model_dir, *CHUNK, '--device', 'cpu',
                     *extra])


async def _ws_serve(handler_cls, factory, clients):
    """Serve `factory`'s decoders with `handler_cls` on 127.0.0.1:0 and run
    the coroutines `clients(uri)` -> their results."""
    import websockets

    async def handle(ws):
        await handler_cls(ws, factory).run()

    async with websockets.serve(handle, '127.0.0.1', 0) as server:
        port = server.sockets[0].getsockname()[1]
        return await clients(f'ws://127.0.0.1:{port}')


def _transcribe_all(waves):
    from wenet_tpu_torch.runtime.websocket.client import transcribe_streaming

    async def clients(uri):
        return await asyncio.gather(*[
            transcribe_streaming(uri, w, chunk_ms=200, nbest=2)
            for w in waves])
    return clients


def test_websocket_round_trip_matches_jax(model_dir):
    pytest.importorskip('websockets')
    from wenet_tpu.runtime.websocket.server import (
        ConnectionHandler as JaxHandler)
    from wenet_tpu_torch.bin.websocket_server_main import build_factory
    from wenet_tpu_torch.runtime.websocket.server import ConnectionHandler
    waves = [_wave(8, 1.9)]
    want = asyncio.run(_ws_serve(JaxHandler, _jax_factory(model_dir),
                                 _transcribe_all(waves)))
    factory, runner = build_factory(_ws_args(model_dir))
    assert runner is None
    got = asyncio.run(_ws_serve(ConnectionHandler, factory,
                                _transcribe_all(waves)))
    assert got == want
    types = [m['type'] for m in got[0]]
    assert types[0] == 'server_ready' and types[-1] == 'speech_end'
    assert 'partial_result' in types and 'final_result' in types


def test_websocket_batch_serving_matches_unbatched(model_dir):
    """Two concurrent clients of a --batch_serving server get the messages
    the unbatched server sends them."""
    pytest.importorskip('websockets')
    from wenet_tpu_torch.bin.websocket_server_main import build_factory
    from wenet_tpu_torch.runtime.websocket.server import ConnectionHandler
    waves = [_wave(8, 1.9), _wave(9, 2.4)]
    factory, _ = build_factory(_ws_args(model_dir))
    want = asyncio.run(_ws_serve(ConnectionHandler, factory,
                                 _transcribe_all(waves)))
    factory, runner = build_factory(_ws_args(
        model_dir, '--batch_serving', '--max_batch', '2'))
    try:
        got = asyncio.run(_ws_serve(ConnectionHandler, factory,
                                    _transcribe_all(waves)))
    finally:
        runner.close()
    assert got == want
    assert runner.batch_sizes[2] > 0  # the two streams shared steps
    for msgs in got:
        assert msgs[-2]['type'] == 'final_result'


def test_websocket_malformed_frames(model_dir):
    websockets = pytest.importorskip('websockets')
    from wenet_tpu_torch.bin.websocket_server_main import build_factory
    from wenet_tpu_torch.runtime.websocket.server import ConnectionHandler
    factory, _ = build_factory(_ws_args(model_dir))

    async def client(uri):
        out = []
        async with websockets.connect(uri) as ws:
            for frame in (b'\x01\x02\x03\x04',  # binary before start
                          '{not json',
                          json.dumps({'signal': 'end'}),  # end before start
                          json.dumps({'signal': 'bogus'})):
                await ws.send(frame)
                out.append(json.loads(await ws.recv()))
            # a proper session still works on the same connection
            await ws.send(json.dumps({'signal': 'start', 'nbest': 1}))
            out.append(json.loads(await ws.recv()))
            pcm = (np.random.RandomState(0).randn(6400) * 3000).astype('<i2')
            await ws.send(pcm.tobytes() + b'\x00')  # a dangling byte
            await ws.send(json.dumps({'signal': 'end'}))
            while True:
                msg = json.loads(await ws.recv())
                out.append(msg)
                if msg.get('type') == 'speech_end':
                    break
        return out

    out = asyncio.run(_ws_serve(ConnectionHandler, factory, client))
    assert [m['status'] for m in out[:4]] == ['failed'] * 4
    assert out[4]['type'] == 'server_ready'
    types = [m.get('type') for m in out[4:]]
    assert 'final_result' in types and types[-1] == 'speech_end'


def test_websocket_disconnect_and_sibling_survival(model_dir):
    """One client disconnects mid-utterance and another sends garbage; a
    concurrent well-behaved session still completes."""
    websockets = pytest.importorskip('websockets')
    from wenet_tpu_torch.bin.websocket_server_main import build_factory
    from wenet_tpu_torch.runtime.websocket.client import transcribe_streaming
    from wenet_tpu_torch.runtime.websocket.server import ConnectionHandler
    factory, _ = build_factory(_ws_args(model_dir))
    rng = np.random.RandomState(1)

    async def clients(uri):
        async def dropper():
            ws = await websockets.connect(uri)
            await ws.send(json.dumps({'signal': 'start'}))
            await ws.recv()
            await ws.send((rng.randn(3200) * 3000).astype('<i2').tobytes())
            await ws.close(code=1001)  # going away, mid-utterance

        async def vandal():
            ws = await websockets.connect(uri)
            await ws.send('\x00\xff garbage')
            await ws.recv()
            await ws.close()

        async def honest():
            return await transcribe_streaming(
                uri, (0.2 * rng.randn(12000)).astype(np.float32),
                chunk_ms=200)

        return (await asyncio.gather(dropper(), vandal(), honest()))[2]

    msgs = asyncio.run(_ws_serve(ConnectionHandler, factory, clients))
    types = [m.get('type') for m in msgs]
    assert types[0] == 'server_ready'
    assert 'final_result' in types
    assert types[-1] == 'speech_end'


def _grpc_run(server_mod, factory, chunks):
    """Serve `factory` with `server_mod.make_server` on 127.0.0.1 and send
    one stream -> its responses as (type, [(sentence, pieces)])."""
    import grpc
    server = server_mod.make_server(factory, 0)
    port = server.add_insecure_port('127.0.0.1:0')
    server.start()
    try:
        with grpc.insecure_channel(f'127.0.0.1:{port}') as ch:
            responses = server_mod.recognize_stream(ch, chunks, nbest=2)
    finally:
        server.stop(0)
    return [(r.status, r.type, [(b.sentence, [(w.word, w.start, w.end)
                                              for w in b.wordpieces])
                                for b in r.nbest]) for r in responses]


def test_grpc_round_trip_matches_jax(model_dir):
    pytest.importorskip('grpc')
    from wenet_tpu.runtime.grpc import server as jax_server
    from wenet_tpu_torch.bin.grpc_server_main import build_factory, get_args
    from wenet_tpu_torch.runtime.grpc import server
    pcm = np.round(_wave(10, 2.2) * 32768).astype('<i2')
    chunks = [pcm[i:i + 3200].tobytes() for i in range(0, len(pcm), 3200)]
    want = _grpc_run(jax_server, _jax_factory(model_dir), chunks)
    factory = build_factory(get_args(['--model_dir', model_dir, *CHUNK,
                                      '--device', 'cpu']))
    got = _grpc_run(server, factory, chunks)
    assert got == want
    from wenet_tpu_torch.runtime.grpc import wenet_pb2
    assert got[0][1] == wenet_pb2.Response.server_ready
    assert got[-1][1] == wenet_pb2.Response.speech_end
    assert got[-2][1] == wenet_pb2.Response.final_result and got[-2][2]


def test_grpc_bad_stream_then_good(model_dir):
    """An RPC that sends audio before decode_config fails alone; the
    server keeps serving the next (well-formed) stream."""
    grpc = pytest.importorskip('grpc')
    from wenet_tpu_torch.bin.grpc_server_main import build_factory, get_args
    from wenet_tpu_torch.runtime.grpc import wenet_pb2
    from wenet_tpu_torch.runtime.grpc.server import (make_server,
                                                     recognize_stream)
    server = make_server(build_factory(get_args(
        ['--model_dir', model_dir, *CHUNK, '--device', 'cpu'])), 0)
    port = server.add_insecure_port('127.0.0.1:0')
    server.start()
    try:
        with grpc.insecure_channel(f'127.0.0.1:{port}') as ch:
            bad = wenet_pb2.Request(audio_data=b'\x00\x01' * 100)
            with pytest.raises(grpc.RpcError):
                list(ch.stream_stream(
                    '/wenet.ASR/Recognize',
                    request_serializer=wenet_pb2.Request.SerializeToString,
                    response_deserializer=wenet_pb2.Response.FromString)(
                        iter([bad])))
            pcm = (np.random.RandomState(0).randn(12000) * 3000).astype('<i2')
            responses = recognize_stream(
                ch, [pcm[i:i + 3200].tobytes()
                     for i in range(0, len(pcm), 3200)])
            types = [r.type for r in responses]
            assert types[0] == wenet_pb2.Response.server_ready
            assert types[-1] == wenet_pb2.Response.speech_end
    finally:
        server.stop(0)
