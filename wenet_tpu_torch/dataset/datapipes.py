"""Iterator datapipes: composable generator stages.  Counterpart of
wenet_tpu/dataset/datapipes.py: plain-python generators and a thread
prefetcher, no torch; sharding partitions by (host, worker).

Every random stage draws from a numpy Generator that `make_rng()` gives
it afresh at the start of each pass (the Dataset seeds it from the run's
seed, the epoch and the stage), where the JAX package draws from the
global `random` and an unseeded `random.Random`.
"""

import json
import logging
import queue
import tarfile
import threading
from typing import Callable, Iterable, Iterator, List, Optional

import numpy as np

logger = logging.getLogger(__name__)


class DataPipe:
    """Lazily re-iterable pipeline stage."""

    def __init__(self, source: Iterable):
        self.source = source

    def __iter__(self):
        return iter(self.source)

    # -- combinators ---------------------------------------------------
    def map(self, fn: Callable, *args, **kwargs) -> 'DataPipe':
        return _Gen(lambda: (fn(x, *args, **kwargs) for x in self))

    def map_random(self, fn: Callable,
                   make_rng: Callable[[], np.random.Generator], *args,
                   **kwargs) -> 'DataPipe':
        """`map` with `rng=` a generator made afresh for each pass."""

        def gen():
            rng = make_rng()
            for x in self:
                yield fn(x, *args, rng=rng, **kwargs)

        return _Gen(gen)

    def map_ignore_error(self, fn: Callable, *args,
                         log_error: bool = True, **kwargs) -> 'DataPipe':
        """`map` that drops (and logs) the samples `fn` raises on."""

        def gen():
            for x in self:
                try:
                    yield fn(x, *args, **kwargs)
                except Exception as ex:  # noqa: BLE001
                    if log_error:
                        logger.warning('skip sample: %s', ex)

        return _Gen(gen)

    def filter(self, fn: Callable, *args, **kwargs) -> 'DataPipe':
        return _Gen(lambda: (x for x in self if fn(x, *args, **kwargs)))

    def shuffle(self, make_rng: Callable[[], np.random.Generator],
                buffer_size: int = 10000) -> 'DataPipe':
        """Shuffle within a buffer of `buffer_size`, yielding half of it
        each time it fills."""

        def gen():
            rng = make_rng()
            buf: List = []
            for x in self:
                buf.append(x)
                if len(buf) >= buffer_size:
                    rng.shuffle(buf)
                    while len(buf) > buffer_size // 2:
                        yield buf.pop()
            rng.shuffle(buf)
            yield from buf

        return _Gen(gen)

    def sort(self, buffer_size: int = 500,
             key_func: Optional[Callable] = None) -> 'DataPipe':
        """Sort each run of `buffer_size` elements by `key_func`."""

        def gen():
            buf: List = []
            for x in self:
                buf.append(x)
                if len(buf) >= buffer_size:
                    buf.sort(key=key_func)
                    yield from buf
                    buf = []
            buf.sort(key=key_func)
            yield from buf

        return _Gen(gen)

    def batch(self, batch_size: int, drop_last: bool = False,
              wrapper: Optional[Callable] = None) -> 'DataPipe':

        def gen():
            buf: List = []
            for x in self:
                buf.append(x)
                if len(buf) == batch_size:
                    yield wrapper(buf) if wrapper else buf
                    buf = []
            if buf and not drop_last:
                yield wrapper(buf) if wrapper else buf

        return _Gen(gen)

    def dynamic_batch(self, window_class: Callable,
                      wrapper: Optional[Callable] = None) -> 'DataPipe':
        """Batches whose boundaries `window_class(x, len(batch))` sets."""

        def gen():
            buf: List = []
            for x in self:
                if window_class(x, len(buf)) and buf:
                    yield wrapper(buf) if wrapper else buf
                    buf = [x]
                else:
                    buf.append(x)
            if buf:
                yield wrapper(buf) if wrapper else buf

        return _Gen(gen)

    def bucket_by_sequence_length(self, elem_length_fn: Callable,
                                  bucket_boundaries: List[int],
                                  bucket_batch_sizes: List[int]
                                  ) -> 'DataPipe':
        """Batches of `bucket_batch_sizes[i]` elements of the length
        bucket i that `bucket_boundaries` (upper bounds) define."""
        assert len(bucket_batch_sizes) == len(bucket_boundaries) + 1

        def bucket_id(L):
            for i, b in enumerate(bucket_boundaries):
                if L <= b:
                    return i
            return len(bucket_boundaries)

        def gen():
            buckets: List[List] = [[] for _ in bucket_batch_sizes]
            for x in self:
                i = bucket_id(elem_length_fn(x))
                buckets[i].append(x)
                if len(buckets[i]) >= bucket_batch_sizes[i]:
                    yield buckets[i]
                    buckets[i] = []
            for b in buckets:
                if b:
                    yield b

        return _Gen(gen)

    def prefetch(self, buffer_size: int = 2) -> 'DataPipe':
        """Run the pipeline in a thread, `buffer_size` elements ahead."""
        outer = self

        def gen():
            q: queue.Queue = queue.Queue(maxsize=max(buffer_size, 1))
            DONE = object()
            err: List = []
            stop = threading.Event()

            def worker():
                try:
                    for x in outer:
                        # bounded put so an abandoned consumer can't pin
                        # this thread, and the upstream shuffle and sort
                        # buffers, forever
                        while not stop.is_set():
                            try:
                                q.put(x, timeout=0.5)
                                break
                            except queue.Full:
                                continue
                        if stop.is_set():
                            return
                except Exception as e:  # noqa: BLE001
                    err.append(e)
                finally:
                    # DONE must be DELIVERED (a dropped sentinel hangs
                    # the consumer at end of stream) — same bounded
                    # put as items so an abandoned consumer still
                    # releases us via the stop flag
                    while not stop.is_set():
                        try:
                            q.put(DONE, timeout=0.5)
                            break
                        except queue.Full:
                            continue

            t = threading.Thread(target=worker, daemon=True)
            t.start()
            try:
                while True:
                    x = q.get()
                    if x is DONE:
                        break
                    yield x
                if err:
                    raise err[0]
            finally:
                # consumer done or abandoned: release the worker
                stop.set()
                while True:
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        break

        return _Gen(gen)

    def repeat(self, count: int = -1) -> 'DataPipe':

        def gen():
            n = 0
            while count < 0 or n < count:
                yield from self
                n += 1

        return _Gen(gen)

    def shard(self, num_shards: int, shard_id: int,
              partition: bool = True) -> 'DataPipe':
        """Round-robin element sharding; partition=False (cv) replicates."""
        if not partition or num_shards <= 1:
            return self

        def gen():
            for i, x in enumerate(self):
                if i % num_shards == shard_id:
                    yield x

        return _Gen(gen)


class _Gen(DataPipe):

    def __init__(self, gen_fn: Callable[[], Iterator]):
        self.gen_fn = gen_fn

    def __iter__(self):
        return self.gen_fn()


def text_line_source(data_list_files: List[str]) -> DataPipe:
    """{'file_name', 'line'} for each non-empty line of the list files."""

    def gen():
        for path in data_list_files:
            with open(path, encoding='utf8') as f:
                for line in f:
                    line = line.strip()
                    if line:
                        yield {'file_name': path, 'line': line}

    return _Gen(gen)


def parse_json_line(sample: dict) -> dict:
    """A raw list's JSON line -> its sample dict."""
    obj = json.loads(sample['line'])
    obj.setdefault('file_name', sample.get('file_name'))
    return obj


def _open_shard_stream(url: str):
    """Local path, file://, http(s):// (stdlib urllib), or any other
    scheme via a `wget -q -O -` pipe (HDFS/OSS/S3 gateways).  Returns
    (stream, process-or-None)."""
    from urllib.parse import urlparse
    pr = urlparse(url)
    if pr.scheme in ('', 'file'):
        return open(pr.path if pr.scheme == 'file' else url, 'rb'), None
    if pr.scheme in ('http', 'https'):
        import urllib.request
        # timeout so one hung server can't stall the input pipeline
        return urllib.request.urlopen(url, timeout=120), None
    import subprocess
    proc = subprocess.Popen(['wget', '-q', '-T', '120', '-O', '-', url],
                            stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL)
    return proc.stdout, proc


def tar_source(shard_list: Iterable[dict]) -> DataPipe:
    """UIO tar-shard reader: open each shard (local path or URL line),
    stream-decode the tar and group members by key prefix."""

    def gen():
        for sample in shard_list:
            url = sample['line'] if isinstance(sample, dict) else sample
            proc = None
            try:
                stream, proc = _open_shard_stream(url)
            except Exception as ex:  # noqa: BLE001
                logger.warning('failed to open shard %s: %s', url, ex)
                continue
            try:
                # streaming mode ('r|*'): works over non-seekable
                # sources (http/pipe) and reads local files
                # sequentially, which is all the loop below needs
                with tarfile.open(fileobj=stream, mode='r|*') as tar:
                    prev_prefix = None
                    example = {}
                    valid = True
                    for member in tar:
                        name = member.name
                        pos = name.rfind('.')
                        if pos <= 0:
                            continue
                        prefix, postfix = name[:pos], name[pos + 1:]
                        if prev_prefix is not None and \
                                prefix != prev_prefix:
                            example['key'] = prev_prefix
                            if valid:
                                yield example
                            example = {}
                            valid = True
                        try:
                            fobj = tar.extractfile(member)
                            data = fobj.read() if fobj else b''
                            if postfix == 'txt':
                                example['txt'] = \
                                    data.decode('utf8').strip()
                            elif postfix in ('wav', 'flac', 'mp3'):
                                example['wav_bytes'] = data
                                example['wav_format'] = postfix
                            else:
                                example[postfix] = data
                        except Exception as ex:  # noqa: BLE001
                            # one corrupt member invalidates only this
                            # sample, not the rest of the shard
                            valid = False
                            logger.warning('bad tar member %s in %s: %s',
                                           name, url, ex)
                        prev_prefix = prefix
                    if prev_prefix is not None:
                        example['key'] = prev_prefix
                        if valid:
                            yield example
            except Exception as ex:  # noqa: BLE001
                logger.warning('error reading shard %s: %s', url, ex)
            finally:
                stream.close()
                if proc is not None:
                    # stream IS proc.stdout and was just closed —
                    # communicate() would raise 'read of closed file';
                    # just reap the child
                    proc.wait()

    return _Gen(gen)
