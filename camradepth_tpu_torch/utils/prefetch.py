"""Background-thread prefetch for host-side input pipelines.

The package's own copy of ``camradepth_tpu/utils/prefetch.py``.
``prefetch_iter`` runs the source iterator and a ``prepare`` transform
(such as the host-to-device copy) on a worker thread, keeping up to
``depth`` items ready ahead of the consumer, so host work overlaps device
compute. Semantics:

- items arrive in source order, exactly once;
- an exception on the worker re-raises on the consumer thread at the point
  the failing item would have been consumed (a worker raise never hangs
  the consumer);
- the consumer may stop early: the producer is unblocked and the thread
  exits promptly instead of blocking forever on a full queue.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")
U = TypeVar("U")

_END = object()


def prefetch_iter(
    src: Iterable[T],
    depth: int,
    prepare: Callable[[T], U],
) -> Iterator[U]:
    """Yield ``prepare(item)`` for each item of ``src``, computed up to
    ``depth`` (>= 1) items ahead on a worker thread."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put_until_stop(out) -> bool:
        # every put is stop-checked: an untimed put on a full queue would
        # park this thread forever once the consumer has left
        while not stop.is_set():
            try:
                q.put(out, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in src:
                if not put_until_stop((None, prepare(item))):
                    return
            put_until_stop((None, _END))
        except BaseException as e:  # noqa: BLE001 — re-raised by the consumer
            put_until_stop((e, None))

    t = threading.Thread(target=worker, daemon=True, name="prefetch_iter")
    t.start()
    try:
        while True:
            err, item = q.get()
            if err is not None:
                raise err
            if item is _END:
                return
            yield item
    finally:
        stop.set()
