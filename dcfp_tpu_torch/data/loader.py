"""Batching + prefetch + multi-process decode (port of
``dcfp_tpu/data/loader.py``: the same batches for the same seed, rank
and world).

Replaces the reference's DataLoader/DistributedSampler machinery
(engine.py:73-115):

* one loader per *process* feeds that process's shard of the global
  batch (``rank``/``world`` stride-split the epoch permutation exactly
  like torch's DistributedSampler; single-process jobs keep the whole
  batch and shard at device_put).  They are the mesh's data rank and
  data axis size: the ranks of one spatial group pass the same pair and
  so decode the same items with the same augmentation, each keeping its
  band of rows later (``engine/trainer.expand_batch``);
* host-side decode/augment runs in ``num_workers`` OS processes feeding
  a reorder buffer (the reference's ``workers=4`` DataLoader,
  engine.py:81-93) — workers run numpy and ``cv2`` only and never touch
  CUDA, so they are safe next to the parent's CUDA context, and are
  forked with OpenCV's threads at 0, so none inherits its thread pool
  (:func:`_start_all`);
  ``num_workers<=1`` degrades to one prefetch thread;
* batches are deterministic in (seed, epoch, batch_index, rank) — the
  SAME batches come out for any ``num_workers``, and a restarted job
  regenerates the identical stream (the reference's per-worker torch
  seeds cannot do either);
* a stopped pool is terminated and joined: no worker outlives its loader.
"""

from __future__ import annotations

import itertools
import multiprocessing as mp
import os
import queue
import signal
import sys
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np


def collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack a list of sample dicts; 'img_meta' stays a list
    (reference datasets/Base.py:264-270 base_convert)."""
    out: Dict[str, Any] = {}
    metas = [s.pop("img_meta", None) for s in samples]
    keys = samples[0].keys()
    for k in keys:
        v0 = samples[0][k]
        if isinstance(v0, dict):
            out[k] = {kk: np.stack([s[k][kk] for s in samples])
                      for kk in v0}
        else:
            out[k] = np.stack([s[k] for s in samples])
    if any(m is not None for m in metas):
        out["img_meta"] = metas
    return out


def _make_batch(dataset, seed: int, epoch: int, b: int, rank: int,
                idxs) -> Dict[str, Any]:
    """Deterministic batch: augmentation randomness is reseeded from
    (seed, epoch, batch, rank), so any worker — or a restarted job —
    produces the identical batch."""
    dataset.rng = np.random.default_rng((seed, epoch, b, rank))
    return collate([dataset[int(i)] for i in idxs])


def _epoch_order(dataset, seed: int, epoch: int, rank: int, world: int
                 ) -> np.ndarray:
    """Shared epoch permutation, stride-split across processes
    (DistributedSampler semantics: same permutation everywhere, rank r
    takes every world-th element; like torch's sampler the permutation
    is padded from its own head to a multiple of world so EVERY rank
    gets the same number of samples — unequal counts would desync epoch
    boundaries and resample indices across processes)."""
    order = np.random.default_rng((seed, epoch)).permutation(len(dataset))
    if world <= 1:
        return order
    total = -(-len(order) // world) * world
    if total != len(order):
        # torch repeats the permutation as many times as needed, so this
        # also covers world > len(dataset)
        reps = -(-total // len(order))
        order = np.tile(order, reps)[:total]
    return order[rank::world]


def _default_signals() -> None:
    """A forked worker inherits the parent's Python signal handlers: the
    train loop's SIGTERM handler would keep it alive through its pool's
    ``terminate``.  Workers take the defaults back."""
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    signal.signal(signal.SIGINT, signal.default_int_handler)


def _decode_worker(dataset, seed: int, rank: int, idx_q, res_q):
    """Worker process main: resolve (epoch, batch, idxs) tickets.
    Calls dataset.pre_processing on epoch change so the (seeded,
    process-consistent) resample index regenerates (train.py:237)."""
    _default_signals()
    current_epoch = -1
    while True:
        item = idx_q.get()
        if item is None:
            return
        epoch, b, serial, idxs = item

        def make():
            nonlocal current_epoch
            if epoch != current_epoch:
                dataset.pre_processing(epoch)
                current_epoch = epoch
            return _make_batch(dataset, seed, epoch, b, rank, idxs)

        _safe_put(res_q, serial, make)


def _safe_put(res_q, serial, thunk, what: str = "decode worker"):
    """Resolve one ticket and enqueue the batch — or the failure.
    mp.Queue.put pickles in a background feeder thread, so an
    unpicklable exception would fail silently there and strand the
    consumer waiting on this serial forever — verify picklability HERE
    and degrade to a plain RuntimeError."""
    try:
        res_q.put((serial, thunk()))
    except Exception as e:  # surface to the consumer
        import pickle
        try:
            pickle.dumps(e)
        except Exception:
            e = RuntimeError(f"{what} failed: {type(e).__name__}: {e}")
        res_q.put((serial, e))


def _start_all(procs) -> None:
    """Start the decode processes with OpenCV's thread count at 0.

    OpenCV's pthreads pool is not fork-safe: a child forked while one of
    the parent's pool threads still holds the pool's lock (as it may just
    after a parallel cv2 call, such as ``connectedComponents`` in a
    resampled crop) waits for it forever in its own first parallel cv2
    call; the loader's stall check then fails the run after
    ``DCFP_DECODE_STALL_TIMEOUT``.  With 0 threads at the fork the pool
    is shut down first and the children run cv2
    sequentially, each being one of several decode processes; the
    parent's count comes back after.  Only cv2 imported by the parent
    matters: a child that imports it builds its own pool."""
    cv2 = sys.modules.get("cv2")
    threads = cv2.getNumThreads() if cv2 is not None else None
    if cv2 is not None:
        cv2.setNumThreads(0)
    try:
        for p in procs:
            p.start()
    finally:
        if cv2 is not None:
            cv2.setNumThreads(threads)


def _fork_ctx():
    """Decode-worker start method.  Default fork: it keeps the dataset
    state CoW-shared and skips re-import, and workers only run
    numpy/cv2 so the parent's CUDA context is not touched.  fork
    from a threaded parent can in principle deadlock the child (Python
    3.12 warns); `_pool_consume` detects that as a stall, and
    ``DCFP_DECODE_START_METHOD=spawn`` (or forkserver) selects the
    thread-safe method — workers re-import, so first batch costs ~1 s
    more per worker."""
    method = os.environ.get("DCFP_DECODE_START_METHOD")
    if not method:
        method = ("fork" if "fork" in mp.get_all_start_methods()
                  else "spawn")
    return mp.get_context(method)


def _end(procs, timeout: float = 10.0):
    """Terminate and join a decode pool: no worker outlives it."""
    for p in procs:
        p.terminate()
    for p in procs:
        p.join(timeout)
        if p.is_alive():
            p.kill()
            p.join(timeout)


def _pool_consume(procs, res_q, refill, n_expected=None, stop_event=None,
                  finite=False):
    """Ordered consumer over a decode-process pool, shared by
    TrainLoader and EvalLoader: a reorder buffer restores ticket order,
    dead workers (OOM, segfault — they never enqueue their serial) are
    detected by liveness polling, and a pool that is alive but
    producing nothing for ``DCFP_DECODE_STALL_TIMEOUT`` seconds
    (default 600) raises instead of spinning forever — fork() from a
    threaded parent can deadlock a child before its first ticket.

    ``refill`` is called once per yielded batch to keep the inflight
    window full (no-op for finite pools that enqueue everything
    upfront).  ``finite`` pools have workers that exit 0 after draining
    the sentinel, so only nonzero exits are deaths there; an infinite
    pool's workers never exit voluntarily."""
    stall = float(os.environ.get("DCFP_DECODE_STALL_TIMEOUT", "600"))
    buffer: Dict[int, Any] = {}
    want = 0
    last_progress = time.monotonic()
    while n_expected is None or want < n_expected:
        while want not in buffer:
            try:
                s, payload = res_q.get(timeout=30)
                last_progress = time.monotonic()
            except queue.Empty:
                if stop_event is not None and stop_event.is_set():
                    # cross-thread stop() terminated the workers
                    # deliberately — a clean shutdown, not a death
                    return
                dead = [p for p in procs if not p.is_alive()
                        and (not finite or p.exitcode not in (0, None))]
                if dead:
                    raise RuntimeError(
                        f"{len(dead)} decode worker(s) died (exitcodes "
                        f"{[p.exitcode for p in dead]})")
                if finite and all(not p.is_alive() for p in procs):
                    raise RuntimeError(
                        f"decode pool exited without producing batch "
                        f"{want}")
                if time.monotonic() - last_progress > stall:
                    alive = sum(p.is_alive() for p in procs)
                    raise RuntimeError(
                        f"decode pool made no progress for {stall:.0f}s "
                        f"with {alive} live worker(s) — likely a worker "
                        "wedged before its first ticket (fork from a "
                        "threaded parent can deadlock the child); retry "
                        "with num_workers<=1 or raise "
                        "DCFP_DECODE_STALL_TIMEOUT")
                continue
            buffer[s] = payload
        payload = buffer.pop(want)
        want += 1
        if isinstance(payload, Exception):
            raise payload
        refill()
        yield payload


class TrainLoader:
    """Infinite shuffled batch iterator with epoch hook, prefetch, and
    optional multi-process decode.

    ``batch_size`` is the PER-PROCESS batch (global // world).  Calls
    ``dataset.pre_processing(epoch)`` at each epoch boundary (reference
    train.py:237) so resample indexes regenerate — the index is
    PRNG-seeded, so all ranks and workers derive the same one with no
    broadcast (reference Base.py:51-57 needed dist.broadcast).
    """

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 prefetch: int = 2, drop_last: bool = True,
                 num_workers: int = 0, rank: int = 0, world: int = 1,
                 use_processes: Optional[bool] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.rank = rank
        self.world = world
        # auto: decode processes only help when there are cores for them
        # — on a single-core host they just add fork + IPC overhead, so
        # fall back to the prefetch thread there
        self.use_processes = (num_workers > 1 and (os.cpu_count() or 1) > 1
                              if use_processes is None else use_processes)
        self._stop = threading.Event()
        self._procs: List = []

    # -- ticket stream -------------------------------------------------------
    def _tickets(self) -> Iterator:
        """(epoch, batch_index, sample_idxs) forever."""
        for epoch in itertools.count():
            self.dataset.pre_processing(epoch)
            order = _epoch_order(self.dataset, self.seed, epoch,
                                 self.rank, self.world)
            n_full = len(order) // self.batch_size
            for b in range(n_full):
                yield (epoch, b,
                       order[b * self.batch_size:(b + 1) * self.batch_size])

    def _gen(self) -> Iterator[Dict[str, Any]]:
        for epoch, b, idxs in self._tickets():
            yield _make_batch(self.dataset, self.seed, epoch, b,
                              self.rank, idxs)

    # -- single prefetch thread ----------------------------------------------
    def _thread_iter(self):
        q: queue.Queue = queue.Queue(maxsize=max(self.prefetch, 1))

        def worker():
            try:
                for batch in self._gen():
                    if self._stop.is_set():
                        return
                    q.put(batch)
            except Exception as e:
                q.put(e)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            item = q.get()
            if isinstance(item, Exception):
                raise item
            yield item

    # -- multi-process decode pool -------------------------------------------
    def _mp_iter(self):
        ctx = _fork_ctx()
        idx_q = ctx.Queue()
        inflight = self.num_workers + max(self.prefetch, 1)
        res_q = ctx.Queue(maxsize=inflight)
        self._procs = [
            ctx.Process(target=_decode_worker,
                        args=(self.dataset, self.seed, self.rank, idx_q,
                              res_q), daemon=True)
            for _ in range(self.num_workers)]
        _start_all(self._procs)

        tickets = self._tickets()
        serial = itertools.count()  # monotone reorder key across epochs

        def refill():
            e, b, idxs = next(tickets)
            idx_q.put((e, b, next(serial), idxs))

        for _ in range(inflight):
            refill()
        try:
            yield from _pool_consume(self._procs, res_q, refill,
                                     stop_event=self._stop)
        finally:
            self.stop()

    def __iter__(self):
        if self.use_processes and self.num_workers > 1:
            return self._mp_iter()
        if self.prefetch > 0:
            return self._thread_iter()
        return self._gen()

    def stop(self):
        self._stop.set()
        _end(self._procs)
        self._procs = []


def _eval_decode_worker(dataset, idx_q, res_q):
    """Eval pool worker: resolve (serial, sample_idxs) tickets to
    collated batches (no augmentation randomness to reseed)."""
    _default_signals()
    while True:
        item = idx_q.get()
        if item is None:
            return
        serial, idxs = item
        _safe_put(res_q, serial,
                  lambda: collate([dataset[int(i)] for i in idxs]),
                  what="eval decode worker")


class EvalLoader:
    """Batch iterator over a val/test split (batch 1 by default —
    evaluation shapes vary per image), with a prefetch thread so host
    image decode overlaps device inference.
    ``num_workers > 1`` decodes in OS processes instead (the reference's
    test DataLoader workers, engine.py:95-115) — batches still come out
    in order via a reorder buffer.

    ``rank``/``world`` stride-split the split across processes for
    multi-process eval (each process accumulates a partial confusion
    matrix; ``allreduce_confusion`` sums them — reference
    evaluate.py:370-372)."""

    def __init__(self, dataset, batch_size: int = 1, prefetch: int = 2,
                 rank: int = 0, world: int = 1, num_workers: int = 0,
                 use_processes: Optional[bool] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.prefetch = prefetch
        self.rank = rank
        self.world = world
        self.num_workers = num_workers
        self.use_processes = (num_workers > 1 and (os.cpu_count() or 1) > 1
                              if use_processes is None else use_processes)

    def _indices(self):
        return range(self.rank, len(self.dataset), self.world)

    def _chunks(self):
        idxs = list(self._indices())
        for start in range(0, len(idxs), self.batch_size):
            yield idxs[start:start + self.batch_size]

    def _gen(self):
        for chunk in self._chunks():
            yield collate([self.dataset[int(i)] for i in chunk])

    def _mp_iter(self):
        ctx = _fork_ctx()
        idx_q = ctx.Queue()
        res_q = ctx.Queue(maxsize=self.num_workers + max(self.prefetch, 1))
        procs = [ctx.Process(target=_eval_decode_worker,
                             args=(self.dataset, idx_q, res_q), daemon=True)
                 for _ in range(self.num_workers)]
        _start_all(procs)
        total = 0
        # tickets are tiny index lists — enqueue the whole finite split
        # upfront, then one exit sentinel per worker
        for serial, chunk in enumerate(self._chunks()):
            idx_q.put((serial, chunk))
            total += 1
        for _ in procs:
            idx_q.put(None)
        try:
            yield from _pool_consume(procs, res_q, lambda: None,
                                     n_expected=total, finite=True)
        finally:
            _end(procs)

    def __iter__(self):
        if self.use_processes and self.num_workers > 1:
            yield from self._mp_iter()
            return
        if self.prefetch <= 0:
            yield from self._gen()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        done = object()

        def worker():
            try:
                for batch in self._gen():
                    q.put(batch)
                q.put(done)
            except Exception as e:  # surface decode errors to the consumer
                q.put(e)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, Exception):
                raise item
            yield item

    def __len__(self):
        n = len(range(self.rank, len(self.dataset), self.world))
        return (n + self.batch_size - 1) // self.batch_size
