"""Double-buffered staging: the one-producer prefetch discipline of the
streamed fold (exec/streaming.py).  A copy of ``baikaldb_tpu/utils/prefetch.py``.

A daemon thread stages item i+1 through a ``Queue(maxsize=1)`` while the
caller consumes item i, so host I/O overlaps compute; steady-state
residency is two staged items (the one consuming + the one prefetched),
plus the one the stager is working on.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Tuple


def staged(items: Iterable, stage: Callable,
           name: str = "prefetch") -> Iterator[Tuple[object, object]]:
    """Yield ``(item, stage(item))`` in order, staging one item ahead on a
    daemon thread.  A staging exception is re-raised in the consumer at
    the failed item's position (BaseException included: panic failpoints
    must reach the consumer, not die with the thread).  Abandoning the
    iterator mid-way stops the stager and drains the queue."""
    it = iter(items)
    q: queue.Queue = queue.Queue(maxsize=1)   # + the one consuming = 2
    stop = threading.Event()

    def put(entry) -> bool:
        while not stop.is_set():
            try:
                q.put(entry, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def run():
        try:
            for item in it:
                if stop.is_set():
                    return
                if not put((item, stage(item))):
                    return
            put(_DONE)
        # not swallowed: the exception object IS the queue item the
        # consumer re-raises (panic failpoints derive from BaseException)
        except BaseException as e:  # tpulint: disable=BAREEXC
            put(e)

    t = threading.Thread(target=run, name=name, daemon=True)
    t.start()
    try:
        while True:
            entry = q.get()
            if entry is _DONE:
                return
            if isinstance(entry, BaseException):
                raise entry
            yield entry
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        t.join(timeout=10.0)


_DONE = object()
