"""Host-side prefetching input pipeline.

Port of ``video_r2_tpu/data/prefetch.py``. A thread-pool prefetcher by
default: cv2 and PIL release the GIL while they decode and draw, so threads
overlap host preprocessing with the card's work without pickling anything,
and batches land as numpy ready for one host-to-device copy.

use_processes=True forks worker processes at construction (the callable and
its captured state are inherited by fork, never pickled), ships (seq,
indices) over an mp.Queue and gets numpy results back (pickled once). It is
for hosts with many cores, where the numpy glue between the GIL-releasing
calls serializes threads.

Contract: `make_batch` runs host code only (numpy, cv2, PIL, the tokenizer)
and must never touch torch's CUDA state. The parent process holds a CUDA
context, and a forked child inherits it in a state CUDA does not support:
any CUDA call there fails or hangs (the rule torch's DataLoader states for
its workers). The eval backend's `_prepare` (host fetch_video and the
tokenizer) keeps to it.
"""

from __future__ import annotations

import queue
import threading
import traceback
from typing import Callable, Iterable, Sequence


class WorkerError(RuntimeError):
    """A make_batch exception raised in a worker process, re-raised on the
    consumer with the child traceback attached (the original exception may
    not survive pickling)."""


def _proc_worker(make_batch, job_q, res_q):
    import pickle

    while True:
        job = job_q.get()
        if job is None:
            return
        seq, idx = job
        try:
            out = make_batch(idx)
        except BaseException as e:  # noqa: BLE001 — crosses a process boundary
            out = WorkerError(
                f"prefetch worker failed on {idx!r}: {e!r}\n"
                + traceback.format_exc())
        # pre-pickle SYNCHRONOUSLY: mp.Queue.put pickles later in the
        # queue's feeder thread, where a failure prints to the child's
        # stderr and silently DROPS the item — the consumer would hang
        # forever on this seq. Doing it here makes the failure catchable
        # (and the queue then only pickles a bytes blob).
        try:
            blob = pickle.dumps(out, protocol=pickle.HIGHEST_PROTOCOL)
        except Exception as e:
            blob = pickle.dumps(WorkerError(
                f"prefetch worker result for {idx!r} not picklable: {e!r}"))
        res_q.put((seq, blob))


class PrefetchLoader:
    """Runs `make_batch(indices)` on worker threads (default) or forked
    worker processes for each element of `batch_indices`, yielding results
    in order, up to `prefetch` ahead."""

    def __init__(self, batch_indices: Iterable[Sequence[int]],
                 make_batch: Callable[[Sequence[int]], object],
                 num_workers: int = 2, prefetch: int = 2,
                 use_processes: bool = False):
        self._make_batch = make_batch
        # `prefetch` bounds COMPLETED batches ahead of the consumer, not just
        # queued jobs — without it a fast host fills _pending with the whole
        # dataset's prepared arrays while the device lags
        self._max_ahead = max(prefetch, 1)
        self._stop = threading.Event()
        self._total: int | None = None
        self._next_emit = 0
        self._pending: dict[int, object] = {}
        self._cv = threading.Condition()
        self._indices = batch_indices
        self._procs: list = []
        self._submitted = 0
        self._received = 0
        self._fatal: WorkerError | None = None
        if use_processes:
            import multiprocessing as mp

            ctx = mp.get_context("fork")   # inherit make_batch, no pickling
            self._job_q = ctx.Queue()
            self._res_q = ctx.Queue()
            self._procs = [ctx.Process(target=_proc_worker,
                                       args=(make_batch, self._job_q,
                                             self._res_q), daemon=True)
                           for _ in range(max(num_workers, 1))]
            for p in self._procs:
                p.start()
            self._feeder = threading.Thread(target=self._feed_procs,
                                            daemon=True)
            self._collector = threading.Thread(target=self._collect_procs,
                                               daemon=True)
            self._feeder.start()
            self._collector.start()
            return
        self._jobs: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._feeder = threading.Thread(target=self._feed, daemon=True)
        self._workers = [threading.Thread(target=self._work, daemon=True)
                         for _ in range(num_workers)]
        self._feeder.start()
        for w in self._workers:
            w.start()

    # -- process mode -------------------------------------------------------
    def _feed_procs(self):
        n = 0
        for idx in self._indices:
            if self._stop.is_set():
                return
            with self._cv:  # backpressure on SUBMITTED jobs: results are
                # bounded by the same window (each job yields one result)
                while (n >= self._next_emit + self._max_ahead
                       + len(self._procs) and not self._stop.is_set()):
                    self._cv.wait(timeout=0.1)
            if self._stop.is_set():
                return
            self._job_q.put((n, idx))
            n += 1
            with self._cv:
                self._submitted = n
        with self._cv:
            self._total = n
            self._cv.notify_all()
        for _ in self._procs:
            self._job_q.put(None)

    def _collect_procs(self):
        import pickle

        while not self._stop.is_set():
            try:
                seq, blob = self._res_q.get(timeout=0.2)
            except queue.Empty:
                with self._cv:
                    if (self._total is not None
                            and self._next_emit >= self._total):
                        return
                    outstanding = self._submitted - self._received
                # a worker killed mid-job (segfault, OOM-kill) loses its
                # (seq, result) forever — detect the nonzero exitcode and
                # surface instead of letting __next__ wait on that seq
                # eternally (torch DataLoader's 'worker exited
                # unexpectedly'). Normal exits (code 0, after the None
                # sentinel) are fine: peers may still be finishing.
                dead = [p for p in self._procs
                        if not p.is_alive() and p.exitcode not in (0, None)]
                if dead and outstanding > 0:
                    with self._cv:
                        self._fatal = WorkerError(
                            f"{len(dead)} prefetch worker(s) died "
                            f"(exitcodes {[p.exitcode for p in dead]}) with "
                            f"{outstanding} job(s) outstanding")
                        self._cv.notify_all()
                    return
                continue
            with self._cv:
                self._pending[seq] = pickle.loads(blob)
                self._received += 1
                self._cv.notify_all()

    def _feed(self):
        n = 0
        for idx in self._indices:
            if self._stop.is_set():
                return
            self._jobs.put((n, idx))
            n += 1
        with self._cv:
            self._total = n
            self._cv.notify_all()
        for _ in self._workers:
            self._jobs.put(None)

    def _work(self):
        while not self._stop.is_set():
            job = self._jobs.get()
            if job is None:
                return
            seq, idx = job
            with self._cv:  # backpressure: stay <= prefetch ahead
                while (seq >= self._next_emit + self._max_ahead
                       and not self._stop.is_set()):
                    self._cv.wait(timeout=0.1)
            if self._stop.is_set():
                return
            try:
                batch = self._make_batch(idx)
            except Exception as e:  # surface errors to the consumer
                batch = e
            with self._cv:
                self._pending[seq] = batch
                self._cv.notify_all()

    def __iter__(self):
        return self

    def __next__(self):
        with self._cv:
            while True:
                if self._total is not None and self._next_emit >= self._total:
                    raise StopIteration
                if self._next_emit in self._pending:
                    batch = self._pending.pop(self._next_emit)
                    self._next_emit += 1
                    self._cv.notify_all()  # wake backpressured workers
                    break
                if self._fatal is not None:
                    raise self._fatal      # dead worker: seq never arrives
                self._cv.wait(timeout=0.1)
        if isinstance(batch, Exception):
            raise batch
        return batch

    def poll(self):
        """Non-blocking __next__: the next in-order batch if it is already
        prepared, else None (StopIteration when exhausted). Lets a consumer
        that has other work (e.g. a decode step) admit input only when ready
        instead of stalling on host preprocessing."""
        with self._cv:
            if self._total is not None and self._next_emit >= self._total:
                raise StopIteration
            if self._next_emit not in self._pending:
                if self._fatal is not None:
                    raise self._fatal      # dead worker: seq never arrives
                return None
            batch = self._pending.pop(self._next_emit)
            self._next_emit += 1
            self._cv.notify_all()  # wake backpressured workers
        if isinstance(batch, Exception):
            raise batch
        return batch

    def close(self):
        self._stop.set()
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(timeout=2.0)
