"""Websocket client (simulated streaming).  Counterpart of
wenet_tpu/runtime/websocket/client.py; `websockets` is imported when a
stream starts."""

import asyncio
import json
import time
from typing import List, Optional

import numpy as np


async def transcribe_streaming(url: str, wav: np.ndarray,
                               sample_rate: int = 16000,
                               chunk_ms: int = 320, nbest: int = 1,
                               continuous_decoding: bool = False,
                               real_time: bool = False,
                               on_message=None,
                               on_send=None) -> List[dict]:
    """Send a waveform chunk by chunk; returns all parsed messages.

    on_send(chunk_index) fires immediately after each binary pcm frame
    is sent (protocol-level latency measurement)."""
    import websockets
    pcm = np.clip(np.asarray(wav) * 32768.0, -32768,
                  32767).astype('<i2') \
        if np.asarray(wav).dtype != np.int16 else np.asarray(wav)
    chunk = sample_rate * chunk_ms // 1000
    messages: List[dict] = []
    # generous handshake/keepalive windows: the websockets defaults
    # (open_timeout=10, ping_timeout=20) tear the stream down when the
    # server host is briefly saturated (many clients time-slicing its
    # cores) even though the session would complete fine
    async with websockets.connect(url, max_size=None,
                                  open_timeout=120,
                                  ping_interval=20,
                                  ping_timeout=300) as ws:
        await ws.send(json.dumps({
            'signal': 'start', 'nbest': nbest,
            'continuous_decoding': continuous_decoding}))
        ready = json.loads(await ws.recv())
        messages.append(ready)

        async def reader():
            try:
                async for m in ws:
                    obj = json.loads(m)
                    messages.append(obj)
                    if on_message:
                        on_message(obj)
                    if obj.get('type') == 'speech_end':
                        return
            except Exception:  # noqa: BLE001
                return

        rtask = asyncio.create_task(reader())
        for n, i in enumerate(range(0, len(pcm), chunk)):
            await ws.send(pcm[i:i + chunk].tobytes())
            if on_send:
                on_send(n)
            if real_time:
                await asyncio.sleep(chunk_ms / 1000)
        await ws.send(json.dumps({'signal': 'end'}))
        await asyncio.wait_for(rtask, timeout=600)
    return messages


def main():
    import argparse
    from wenet_tpu_torch.dataset.audio import read_wav
    parser = argparse.ArgumentParser()
    parser.add_argument('--hostname', default='127.0.0.1')
    parser.add_argument('--port', type=int, default=10086)
    parser.add_argument('--wav_path', required=True)
    parser.add_argument('--nbest', type=int, default=1)
    parser.add_argument('--continuous_decoding', action='store_true')
    parser.add_argument('--simulate_streaming', action='store_true')
    args = parser.parse_args()
    wav, sr = read_wav(args.wav_path)
    if sr != 16000:
        raise SystemExit(f'{args.wav_path}: {sr} Hz; resampling is not '
                         'ported, give 16 kHz audio')
    t0 = time.time()
    msgs = asyncio.run(
        transcribe_streaming(
            f'ws://{args.hostname}:{args.port}', wav[0],
            nbest=args.nbest,
            continuous_decoding=args.continuous_decoding,
            real_time=args.simulate_streaming,
            on_message=lambda m: print(m)))
    dt = time.time() - t0
    dur = wav.shape[1] / 16000
    print(f'RTF: {dt / dur:.4f} ({dt:.2f}s for {dur:.2f}s audio)')


if __name__ == '__main__':
    main()
