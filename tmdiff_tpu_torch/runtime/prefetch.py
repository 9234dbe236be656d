"""Background batch prefetching and device staging for the train loop (port
of tmdiff_tpu/runtime/prefetch.py).

`Prefetcher` assembles host batches on a worker thread while the device
runs the previous step. `DeviceFeeder` puts each item on the device one item
ahead: on a CUDA device, its numpy arrays are copied into pinned host memory
and sent with non-blocking copies on a side stream, so that step k+1's
host-to-device copy overlaps step k's kernels. When it hands an item out,
the consumer's stream waits for the side stream and each staged tensor is
recorded on the consumer's stream, so the caching allocator does not reuse
its memory while kernels queued there may still read it. Items come out in
the source's order, and a finite source yields every item (the JAX
package's feeder drops the last one, ADVICE.md: `prefetch.py:95`).

Spans (utils/profiling.py, while its recorder is on): `feed.produce` on
the Prefetcher's thread, around each `next` of its source; in the
consumer's `next(feeder)`, `feed.handoff` (the item's hand-over across
streams), then for the item after it `feed.source` (waiting for it from
the Prefetcher or the source) and `feed.stage` (pinning it and issuing its
copies).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from tmdiff_tpu_torch.utils import profiling

_END = object()


class Prefetcher:
    def __init__(self, iterator: Iterator, depth: int = 2):
        self._it = iterator
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Queue `item` unless closed; False once closed."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            it = iter(self._it)
            while True:
                with profiling.span("feed.produce"):
                    item = next(it, _END)
                if item is _END:
                    break
                if not self._put(item):
                    return
        except Exception as exc:  # raised to the consumer at its next item
            self._put(exc)
            return
        self._put(StopIteration())

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, StopIteration):
            self._q.put(item)  # every later call ends too
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item

    def close(self, timeout: float = 5.0):
        self._stop.set()
        self._thread.join(timeout)


class DeviceFeeder:
    """Prefetcher (depth > 0) plus one-ahead staging on `device` (CUDA
    unless given). Arrays anywhere in an item (a dict, tuple or list) become
    tensors on the device; anything else passes through."""

    def __init__(self, iterator: Iterator, device=None, depth: int = 2):
        self.device = torch.device("cuda" if device is None else device)
        self._src = Prefetcher(iterator, depth) if depth > 0 else iterator
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._pending = None

    def _to_device(self, obj):
        if isinstance(obj, np.ndarray):
            host = torch.from_numpy(np.ascontiguousarray(obj))
            if self._stream is None:
                return host.to(self.device)
            return host.pin_memory().to(self.device, non_blocking=True)
        if isinstance(obj, dict):
            return {k: self._to_device(v) for k, v in obj.items()}
        if isinstance(obj, (tuple, list)):
            return type(obj)(self._to_device(v) for v in obj)
        return obj

    def _stage(self):
        """Start the next item's copies; None once the source is exhausted."""
        with profiling.span("feed.source"):
            item = next(self._src, _END)
        if item is _END:
            return None
        with profiling.span("feed.stage"):
            if self._stream is None:
                return self._to_device(item)
            with torch.cuda.stream(self._stream):
                return self._to_device(item)

    def _hand_out(self, obj):
        if isinstance(obj, torch.Tensor):
            obj.record_stream(torch.cuda.current_stream(self.device))
        elif isinstance(obj, dict):
            for v in obj.values():
                self._hand_out(v)
        elif isinstance(obj, (tuple, list)):
            for v in obj:
                self._hand_out(v)

    def __iter__(self):
        return self

    def __next__(self):
        out = self._pending if self._pending is not None else self._stage()
        if out is None:
            raise StopIteration
        with profiling.span("feed.handoff"):
            if self._stream is not None:
                torch.cuda.current_stream(self.device).wait_stream(self._stream)
                self._hand_out(out)
        # start the next item's copies now, beside the kernels the caller is
        # about to queue on `out`; None once the source has run out, and the
        # call after this one ends the iteration
        self._pending = self._stage()
        return out

    def close(self):
        if isinstance(self._src, Prefetcher):
            self._src.close()
