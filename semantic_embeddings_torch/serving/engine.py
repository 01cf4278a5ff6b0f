"""Dynamic micro-batching engine for the serving runtime.

Counterpart of the JAX package's ``serving/engine.py``.
Concurrent requests are coalesced into one device call: a dispatcher thread
drains the request queue until either ``max_batch`` images are pending or
``timeout_ms`` has passed since the first queued request, pads the pack to
the smallest batch *bucket* that holds it (a few fixed shapes, so cuDNN
picks its algorithms once per bucket, in :meth:`BatchingEngine.warmup`),
runs the model once, fetches the outputs to the host once, and hands each
request its rows through a future.
"""

from __future__ import annotations

import collections
import queue
import threading
import time

import numpy as np
import torch


class _Pending:
    __slots__ = ("array", "future", "t_enqueue")

    def __init__(self, array, future):
        self.array = array
        self.future = future
        self.t_enqueue = time.perf_counter()


class Future:
    """Minimal thread-safe future."""

    def __init__(self):
        self._event = threading.Event()
        self._value = None
        self._error = None

    def set_result(self, value):
        self._value = value
        self._event.set()

    def set_exception(self, err):
        self._error = err
        self._event.set()

    def result(self, timeout=None):
        if not self._event.wait(timeout):
            raise TimeoutError("request did not complete in time")
        if self._error is not None:
            # A device-call error reaches every waiter of the pack: raise a
            # per-waiter copy chained to the original, so that concurrent
            # waiters do not share (and mutate) one traceback.
            err = self._error
            try:
                copy = type(err)(*err.args)
            except Exception:  # noqa: BLE001 - exotic constructor signature
                copy = RuntimeError(f"{type(err).__name__}: {err}")
            raise copy from err
        return self._value


class EngineOverloaded(RuntimeError):
    """Raised by submit() when the pending-image queue is full (the HTTP
    layer answers 503, so that callers back off instead of timing out)."""


def default_buckets(max_batch, multiple=1):
    """``multiple`` times powers of two below ``max_batch``, then
    ``max_batch`` itself.  ``multiple`` > 1 is the multi-device case: every
    call splits its batch evenly over the device replicas, so the smallest
    bucket is one image each."""
    buckets, b = [], multiple
    while b < max_batch:
        buckets.append(b)
        b *= 2
    buckets.append(max_batch)
    return buckets


def _map(fn, tree):
    """``fn`` applied to every leaf of a tuple / list / dict tree."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _concat(trees):
    """One tree of arrays from trees of equal structure, concatenated along
    the leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _concat([t[k] for t in trees]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_concat([t[i] for t in trees]) for i in range(len(first)))
    return np.concatenate(trees)


def to_host(tree):
    """Numpy copies of a tree of tensors (and arrays).

    CUDA tensors are copied into pinned host memory without blocking, then
    one event a card, recorded after the copies on its current stream, is
    waited on: the copies queue behind the model's kernels on that stream
    (the kernels' launches go to the current stream of the calling
    thread), so the results handed back are complete.
    """
    cards = set()

    def start(t):
        if isinstance(t, torch.Tensor):
            t = t.detach()
            if t.is_cuda:
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
                cards.add(t.device)
                return host
            return t.cpu()
        return np.asarray(t)

    copies = _map(start, tree)
    for card in cards:  # the copies queue on each card's current stream
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(card))
        done.synchronize()
    return _map(lambda t: t.numpy() if isinstance(t, torch.Tensor) else t, copies)


class BatchingEngine:
    """Coalesces concurrent inference requests into bucketed device calls.

    ``fn``: maps a numpy ``(B, *input_tail)`` batch of ``dtype`` to a tree
    (tensor, tuple, list or dict) of tensors or arrays with leading batch
    dimension ``B``; it is called only with ``B in buckets``, and copies
    the batch to the device itself.  A list of such callables, one a
    device replica of the model (``serve_model --gpus``), splits every pack
    evenly over them: each is called on its share before any output is
    fetched, and the outputs are concatenated in order.  The buckets are
    then multiples of their number.

    ``dtype`` (default float32): the wire/buffer dtype handed to ``fn``;
    uint8 with device-side normalization (``serve_model --device_preproc``).

    ``max_queue``: cap on pending images, beyond which submit() raises
    :class:`EngineOverloaded` (HTTP 503) instead of queueing unbounded work.
    Default: 16 full batches.
    """

    def __init__(self, fn, input_tail, max_batch=256, timeout_ms=2.0, buckets=None,
                 max_queue=None, dtype=np.float32):
        self._fns = list(fn) if isinstance(fn, (list, tuple)) else [fn]
        self.input_tail = tuple(input_tail)
        self.dtype = np.dtype(dtype)
        self.max_batch = int(max_batch)
        self.timeout_s = float(timeout_ms) / 1e3
        n_dev = len(self._fns)
        if self.max_batch % n_dev:
            raise ValueError(f"max_batch {self.max_batch} must be a multiple of the "
                             f"{n_dev} device replicas")
        self.buckets = (sorted(buckets) if buckets
                        else default_buckets(self.max_batch, multiple=n_dev))
        if self.buckets[-1] < self.max_batch:
            raise ValueError("largest bucket must cover max_batch")
        if any(b % n_dev for b in self.buckets):
            raise ValueError(f"every bucket must divide over the {n_dev} device replicas")
        self.max_queue = int(max_queue) if max_queue is not None else 16 * self.max_batch
        self._n_pending = 0
        self._queue = queue.Queue()
        self._stop = threading.Event()
        self._thread = None
        self._lock = threading.Lock()
        self._stats = dict(requests=0, images=0, batches=0, padded_images=0, errors=0)
        self._latencies = collections.deque(maxlen=1024)

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="sed-batcher")
        self._thread.start()
        return self

    def stop(self):
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=10)
            self._thread = None
        # fail whatever is still queued
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            with self._lock:
                self._n_pending -= item.array.shape[0]
            item.future.set_exception(RuntimeError("engine stopped"))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- request API -------------------------------------------------------

    def submit(self, x):
        """Enqueues an ``(n, *input_tail)`` array (cast to the engine dtype);
        returns a Future resolving to the tree of the request's outputs
        (leading dimension n)."""
        x = np.asarray(x, dtype=self.dtype)
        if x.shape[1:] != self.input_tail:
            raise ValueError(
                f"bad input shape {x.shape}; expected (n, "
                f"{', '.join(map(str, self.input_tail))})")
        if not 1 <= x.shape[0] <= self.max_batch:
            raise ValueError(f"request batch {x.shape[0]} outside [1, {self.max_batch}]")
        with self._lock:
            if self._n_pending + x.shape[0] > self.max_queue:
                raise EngineOverloaded(
                    f"{self._n_pending} images already pending "
                    f"(max_queue {self.max_queue}); retry later")
            self._n_pending += x.shape[0]
        fut = Future()
        self._queue.put(_Pending(x, fut))
        return fut

    def predict(self, x, timeout=None):
        """Synchronous submit + wait."""
        if self._thread is None:
            raise RuntimeError("engine not started")
        return self.submit(x).result(timeout)

    def _call(self, batch):
        """The outputs of a bucket-sized batch on the host: one call a device
        replica on its share, every call issued before any fetch."""
        if len(self._fns) == 1:
            return to_host(self._fns[0](batch))
        shares = np.split(batch, len(self._fns))
        outs = [fn(share) for fn, share in zip(self._fns, shares)]
        return _concat([to_host(out) for out in outs])

    def warmup(self, buckets=None):
        """Runs every batch bucket once on zeros, so that no live request
        pays for the first call of a shape (cuDNN's algorithm choice, the
        CUDA kernels' build and load).  Runs inline on the caller's thread,
        before serving traffic.  Returns per-bucket seconds."""
        timings = {}
        for b in sorted(buckets) if buckets else self.buckets:
            x = np.zeros((b,) + self.input_tail, dtype=self.dtype)
            t0 = time.perf_counter()
            self._call(x)
            timings[int(b)] = round(time.perf_counter() - t0, 3)
        return timings

    def stats(self):
        with self._lock:
            out = dict(self._stats)
            out["pending_images"] = self._n_pending
            out["max_queue"] = self.max_queue
            lats = sorted(self._latencies)
        if lats:
            out["latency_ms_p50"] = round(1e3 * lats[len(lats) // 2], 3)
            out["latency_ms_p99"] = round(1e3 * lats[int(len(lats) * 0.99)], 3)
        out["avg_batch"] = round(out["images"] / max(out["batches"], 1), 2)
        return out

    # -- dispatcher --------------------------------------------------------

    def _bucket_for(self, n):
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _loop(self):
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            pack = [first]
            total = first.array.shape[0]
            deadline = time.perf_counter() + self.timeout_s
            while total < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if total + nxt.array.shape[0] > self.max_batch:
                    self._queue.put(nxt)  # would overflow: the next pack's
                    break
                pack.append(nxt)
                total += nxt.array.shape[0]
            self._run_pack(pack, total)

    def _run_pack(self, pack, total):
        bucket = self._bucket_for(total)
        batch = np.zeros((bucket,) + self.input_tail, dtype=self.dtype)
        off = 0
        for item in pack:
            n = item.array.shape[0]
            batch[off:off + n] = item.array
            off += n
        with self._lock:
            self._n_pending -= total
        try:
            out = self._call(batch)  # the whole pack, fetched once
        except Exception as e:  # noqa: BLE001 - delivered to every waiter
            with self._lock:
                self._stats["errors"] += len(pack)
            for item in pack:
                item.future.set_exception(e)
            return
        now = time.perf_counter()
        off = 0
        for item in pack:
            n = item.array.shape[0]
            item.future.set_result(_map(lambda a, lo=off, n=n: a[lo:lo + n], out))
            off += n
        with self._lock:
            self._stats["requests"] += len(pack)
            self._stats["images"] += total
            self._stats["batches"] += 1
            self._stats["padded_images"] += bucket - total
            for item in pack:
                self._latencies.append(now - item.t_enqueue)
