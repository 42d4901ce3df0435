"""Background prefetch for the IL data pipeline.

The reference hides trajectory-store reads behind 3 DataLoader workers
(reference vlnce_baselines/dagger_trainer.py:539, recollect_trainer.py:86).
Here the equivalent is a single daemon producer thread per epoch that runs
store read + decode + collate ahead of the consumer, feeding a bounded queue
so host decode overlaps the train step on the card (a copy of
vlnce_tpu/data/prefetch.py). The thread hands over numpy arrays; the
consumer pins and uploads them, so no CUDA call is made off the main thread.
"""

import queue
import threading

_ITEM, _END, _ERROR = 0, 1, 2


class PrefetchIterator:
    """Iterate ``iterable`` on a background thread through a bounded queue.

    - Re-iterable: each ``__iter__`` starts a fresh producer over
      ``iter(iterable)`` (so a re-iterable source supports multiple epochs;
      a generator source is consumed once, like any iterator).
    - ``depth`` bounds how many items are decoded ahead; ``depth <= 0``
      degrades to inline iteration (no thread).
    - Exceptions raised by the source are re-raised in the consumer at the
      position they occurred.
    - Breaking out of iteration stops the producer promptly (the generator's
      ``finally`` signals it and drains the queue).
    """

    def __init__(self, iterable, depth: int = 3):
        self._iterable = iterable
        self._depth = int(depth)

    def __len__(self):
        return len(self._iterable)

    def __iter__(self):
        if self._depth <= 0:
            yield from self._iterable
            return

        q: queue.Queue = queue.Queue(maxsize=self._depth)
        stop = threading.Event()

        def _put(msg) -> bool:
            """Blocking put that aborts when the consumer has gone away."""
            while not stop.is_set():
                try:
                    q.put(msg, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def _produce():
            try:
                for item in self._iterable:
                    if not _put((_ITEM, item)):
                        return
            except BaseException as exc:  # noqa: BLE001 — relayed to consumer
                _put((_ERROR, exc))
                return
            _put((_END, None))

        worker = threading.Thread(target=_produce, daemon=True, name="prefetch")
        worker.start()
        try:
            while True:
                kind, payload = q.get()
                if kind == _ITEM:
                    yield payload
                elif kind == _END:
                    return
                else:
                    raise payload
        finally:
            stop.set()
            # unblock a producer waiting on a full queue
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            worker.join(timeout=1.0)
