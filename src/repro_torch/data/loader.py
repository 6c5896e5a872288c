"""Host-sharded, prefetching data loader with straggler re-issue.

Every batch is addressed by (step, shard), so the stream is
deterministic:
  * resume from a checkpoint replays the exact stream (start_step),
  * a slow host's shard can be re-issued to a healthy one (the trainer's
    watchdog calls ``reissue``),
  * an elastic rescale changes n_shards and keeps step addressing.

A background thread keeps ``prefetch_depth`` batches ready.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Callable, Iterator

BatchFn = Callable[[int, int, int], dict]  # (step, shard, n_shards)


class ShardedLoader:
    def __init__(
        self,
        batch_fn: BatchFn,
        *,
        shard: int = 0,
        n_shards: int = 1,
        start_step: int = 0,
        prefetch_depth: int = 2,
    ):
        self.batch_fn = batch_fn
        self.shard = shard
        self.n_shards = n_shards
        self._step = start_step
        self._extra: "queue.Queue[dict]" = queue.Queue()
        self._q: "queue.Queue[tuple[int, dict]]" = queue.Queue(
            maxsize=prefetch_depth
        )
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.batch_fn(step, self.shard, self.n_shards)
            # put blocks while the queue is full: bounded memory
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        return self

    def __next__(self) -> tuple[int, dict]:
        if not self._extra.empty():
            return (-1, self._extra.get())
        if self._stop.is_set():
            raise StopIteration
        return self._q.get()

    def reissue(self, step: int, failed_shard: int):
        """Straggler mitigation: produce another host's shard locally; the
        batch comes next out of this loader, with step id -1."""
        self._extra.put(self.batch_fn(step, failed_shard, self.n_shards))

    def close(self):
        self._stop.set()
        with contextlib.suppress(queue.Empty):  # unblock the worker
            while True:
                self._q.get_nowait()
        self._thread.join(timeout=2.0)
