"""Host-side reader prefetch: overlap disk IO, image decode and resize with
device compute.

A copy of deva_tpu/utils/prefetch.py (host-only), so that the port imports
nothing of deva_tpu. Upstream DEVA hides reader latency behind DataLoader
worker processes; here each reader gets a bounded background thread: while
the device propagates frame t, the host decodes frames t+1..t+depth.
Threads (not processes) suffice: the readers release the GIL inside the
image decoder and numpy, and the consumer waits on the device anyway.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator


class Prefetcher:
    """Iterate an indexable reader with `depth` items decoded ahead.

    with Prefetcher(reader) as pf:
        for data in pf: ...

    Exceptions inside the worker re-raise at the consuming site (per-video
    fault barriers keep their semantics).
    """

    def __init__(self, reader, depth: int = 2, start: int = 0,
                 stop: int = None):
        self.reader = reader
        self.start = start
        self.stop = len(reader) if stop is None else stop
        self.q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop_evt = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)

    def _work(self):
        try:
            for i in range(self.start, self.stop):
                if self._stop_evt.is_set():
                    return
                item = self.reader[i]
                while not self._stop_evt.is_set():
                    try:
                        self.q.put((i, item, None), timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surfaced to the consumer
            self.q.put((None, None, e))

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop_evt.set()
        # drain so the worker's blocked put can observe the stop event
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
        return False

    def __iter__(self) -> Iterator:
        for _ in range(self.start, self.stop):
            i, item, err = self.q.get()
            if err is not None:
                raise err
            yield item
