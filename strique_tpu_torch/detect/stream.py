"""Bucket-stream scheduler: full, shape-homogeneous device batches from a
ragged read stream.

The port's counterpart of ``strique_tpu/detect/stream.py``.  The
reference's dispatcher (reference scripts/STRique.py:733-830) hands
each worker one read at a time, so batching is not its concern.  Here a
device batch is only efficient when it is (a) full and (b) shape-
homogeneous -- a short read grouped with a long one pads to the long
read's signal bucket and pays its full alignment cost.

``StreamScheduler`` queues decoded reads by
``(target, strand, signal_bucket(len))`` and flushes a queue when it
holds a full batch.  Flushed batches ride the counter's submit / middle
/ mod / finish pipeline ``depth`` deep (device compute overlaps the
host's prep of the next batch).  A global cap bounds memory and
latency: when the total queued reads exceed it, the longest queue
flushes early.  End-of-stream flushes the remainders, merged across
buckets where the cost model says so (:func:`plan_merged_batches`).

Results surface through a callback in completion order -- the same
unordered-collector contract as the reference (:778-802).

The tail-merge plan uses the reference's non-wave cost formula on every
device, so on the CPU the plan, and with it the TSV's row order, equals
the reference's.  The reference's TPU wave branch has no card
counterpart yet: a card model would first have to show, on the card, a
stream where its plan differs and wins.
"""
from __future__ import annotations

import os
import sys
import traceback
from collections import deque

from ..utils import trace
from ..utils.logging import LogLevel, log
from .counter import signal_bucket

# Close-time merge cost model of the reference's non-wave route (units:
# align-kernel column-time at width 32).  A batch of n reads at pad
# bucket ``b`` costs b x the per-call width factor plus a flat per-batch
# charge for dispatch overheads (strique_tpu/detect/stream.py:27-35).
FIXED_BATCH_COST = 8192


def _batch_cost(bucket: int, n: int) -> float:
    """The reference's non-wave cost of an n-read batch at ``bucket``."""
    full, rem = divmod(n, 32)
    factor = float(full)
    if rem:
        factor += 0.17 + 0.026 * max(8, -(-rem // 8) * 8)
    return bucket * factor + FIXED_BATCH_COST


def plan_merged_batches(groups: list[tuple[int, int]]) -> list[list[int]]:
    """Partition per-bucket tail groups into merged batches.

    ``groups``: (bucket, count) pairs.  Reads of a smaller bucket may pad
    up into a larger one when that beats a separate partial batch (an
    11-read 12k flush + an 8-read 14k flush is worse than one 19-read 14k
    batch).  Only bucket-ascending contiguous ranges can merge (cost is
    set by the range's max bucket).  Returns one list of original
    ``groups`` indices per merged batch; exact interval DP over the
    bucket-ascending order, O(k^2) for k buckets.
    """
    order = sorted(range(len(groups)), key=lambda i: groups[i][0])
    k = len(order)
    if k == 0:
        return []
    best = [0.0] * (k + 1)  # best[j] = min cost of covering order[:j]
    cut = [0] * (k + 1)
    for j in range(1, k + 1):
        best[j] = float("inf")
        n = 0
        for i in range(j - 1, -1, -1):  # batch = order[i:j], bucket = order[j-1]
            n += groups[order[i]][1]
            c = best[i] + _batch_cost(groups[order[j - 1]][0], n)
            if c < best[j]:
                best[j], cut[j] = c, i
    out = []
    j = k
    while j > 0:
        i = cut[j]
        out.append([order[t] for t in range(i, j)])
        j = i
    out.reverse()
    return out


class StreamScheduler:
    """Groups (target, strand, signal) submissions into full device batches.

    on_result(ctx, out) fires once per submitted read, where ``out`` is
    the counter's 7-tuple or ``None`` when that read failed.  A batch
    failure triggers a per-read retry, so a poisoned read never voids
    its batchmates (per-read fault isolation, reference STRique.py:764-768).
    """

    def __init__(self, counter, on_result, batch_size: int = 64,
                 depth: int = 2, max_queued: int | None = None):
        self.counter = counter
        self.on_result = on_result
        self.batch_size = max(int(batch_size), 1)
        self.depth = max(int(depth), 1)
        self.max_queued = max_queued if max_queued is not None else 4 * self.batch_size
        self.queues: dict[tuple, list] = {}
        self.n_queued = 0
        # staged pipeline: submitted batches await their middle phase
        # (bounds D2H + Viterbi dispatch) in ``inflight``, then their mod
        # phase in ``ready``, then their finish in ``modq`` -- so a
        # batch's Viterbi runs on the card while later batches are still
        # aligning; with a mod model the mod phase queues batch k's mod
        # decode while later batches align (counter.detect_mod_submit, a
        # no-op without one).
        self.inflight: deque = deque()
        self.ready: deque = deque()
        self.modq: deque = deque()
        # async submission: detect_submit (host prep + upload + align
        # launch) runs on a dedicated thread so later batches prep while
        # this thread waits on an earlier batch's results.  One thread
        # keeps submission (and so device-queue) order; both threads
        # queue onto the device's default stream, so the events a submit
        # records order the main thread's waits.  Created lazily on the
        # first flush, shut down by close().  STRIQUE_ASYNC_SUBMIT=0
        # restores inline submits.
        self._async_submit = os.environ.get("STRIQUE_ASYNC_SUBMIT", "1") != "0"
        self._submit_pool = None
        self._batches = 0  # batches flushed: each batch's number in its spans

    # -- submission ----------------------------------------------------------
    def add(self, ctx, target_name: str, strand: str, raw,
            prep_token: dict | None = None) -> None:
        """``prep_token``: share one dict across the add() calls of a read
        that intersects several targets -- the first batch to prep it
        caches the preprocessed buffers in the token and later batches
        reuse them (counter.detect_submit ``preps``)."""
        key = (target_name, strand, signal_bucket(len(raw)))
        self.queues.setdefault(key, []).append((ctx, raw, prep_token))
        self.n_queued += 1
        if len(self.queues[key]) >= self.batch_size:
            self._flush(key, "stream.flush.full")
        elif self.n_queued > self.max_queued:
            self._flush(max(self.queues, key=lambda k: len(self.queues[k])), "stream.flush.cap")

    def close(self) -> None:
        """Flush all partial queues (bucket-merged) and drain in-flight batches.

        Remainder queues of one (target, strand) merge across pad buckets
        when the cost model says padding short reads up to a longer
        bucket beats separate partial batches (:func:`plan_merged_batches`).
        """
        with trace.span("stream.close"):
            self._close()

    def _close(self) -> None:
        by_ts: dict[tuple, list] = {}
        for (target_name, strand, bucket) in self.queues:
            by_ts.setdefault((target_name, strand), []).append(bucket)
        for (target_name, strand), buckets in sorted(
                by_ts.items(), key=lambda kv: -sum(len(self.queues[(*kv[0], b)]) for b in kv[1])):
            keys = [(target_name, strand, b) for b in sorted(buckets)]
            groups = [(b, len(self.queues[(target_name, strand, b)])) for b in sorted(buckets)]
            for batch_idxs in plan_merged_batches(groups):
                items = []
                for gi in batch_idxs:
                    items.extend(self.queues.pop(keys[gi]))
                self.n_queued -= len(items)
                self._submit(target_name, strand, items, "stream.flush.close")
        while self.inflight:
            self._advance_one()
        while self.ready:
            self._mod_one()
        while self.modq:
            self._drain_one()
        if self._submit_pool is not None:
            self._submit_pool.shutdown(wait=True)
            self._submit_pool = None

    # -- internals -----------------------------------------------------------
    def _flush(self, key, cause: str) -> None:
        target_name, strand, _bucket = key
        items = self.queues.pop(key)
        self.n_queued -= len(items)
        self._submit(target_name, strand, items, cause)

    def _detect_submit(self, batch: int, target_name, raws, strand, preps):
        with trace.span("stream.submit", batch) as sp:
            if sp:
                sp.attrs["reads"] = len(raws)
            return self.counter.detect_submit(target_name, raws, strand, preps=preps)

    def _submit(self, target_name: str, strand: str, items: list, cause: str) -> None:
        """Submit a flushed batch; ``cause``: the flush counter it adds to."""
        raws = [it[1] for it in items]
        toks = [it[2] for it in items]
        preps = toks if any(t is not None for t in toks) else None
        batch = self._batches
        self._batches += 1
        trace.count(cause)
        trace.count("stream.reads", len(items))
        if self._async_submit:
            if self._submit_pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._submit_pool = ThreadPoolExecutor(max_workers=1)
            state = self._submit_pool.submit(
                self._detect_submit, batch, target_name, raws, strand, preps)
        else:
            try:
                state = self._detect_submit(batch, target_name, raws, strand, preps)
            except KeyboardInterrupt:
                raise
            except Exception:
                log("Factory: Unexpected error in batch submit, retrying reads "
                    "individually.\n"
                    + "".join(traceback.format_exception(*sys.exc_info())), LogLevel.Warning)
                state = None
        self.inflight.append((target_name, strand, items, state, batch))
        while len(self.inflight) > self.depth:
            self._advance_one()
        while len(self.ready) > self.depth:
            self._mod_one()
        while len(self.modq) > self.depth:
            self._drain_one()

    def _advance_one(self) -> None:
        target_name, strand, items, state, batch = self.inflight.popleft()
        if state is not None:
            try:
                if hasattr(state, "result"):  # async submit future
                    with trace.span("stream.wait", batch):
                        state = state.result()
                with trace.span("stream.middle", batch):
                    state = self.counter.detect_middle(state)
            except KeyboardInterrupt:
                raise
            except Exception:
                log("Factory: Unexpected error in batch bounds phase, retrying "
                    "reads individually.\n"
                    + "".join(traceback.format_exception(*sys.exc_info())), LogLevel.Warning)
                state = None
        self.ready.append((target_name, strand, items, state, batch))

    def _mod_one(self) -> None:
        target_name, strand, items, state, batch = self.ready.popleft()
        if state is not None:
            try:
                with trace.span("stream.mod", batch):
                    state = self.counter.detect_mod_submit(state)
            except KeyboardInterrupt:
                raise
            except Exception:
                log("Factory: Unexpected error in batch mod phase, retrying "
                    "reads individually.\n"
                    + "".join(traceback.format_exception(*sys.exc_info())), LogLevel.Warning)
                state = None
        self.modq.append((target_name, strand, items, state, batch))

    def _drain_one(self) -> None:
        target_name, strand, items, state, batch = self.modq.popleft()
        with trace.span("stream.finish", batch):
            if self._finish(state, items):
                return
        with trace.span("stream.retry", batch):
            trace.count("stream.retries", len(items))
            self._retry(target_name, strand, items)

    def _finish(self, state, items) -> bool:
        """Finish a batch and hand its results on; False if it failed."""
        outs = None
        if state is not None:
            try:
                outs = self.counter.detect_finish(state)
            except KeyboardInterrupt:
                raise
            except Exception:
                log("Factory: Unexpected error in batch, retrying reads "
                    "individually.\n"
                    + "".join(traceback.format_exception(*sys.exc_info())), LogLevel.Warning)
        if outs is None:
            return False
        for i, it in enumerate(items):
            self.on_result(it[0], outs[i])
        return True

    def _retry(self, target_name: str, strand: str, items: list) -> None:
        # per-read retry: one poisoned read costs only itself, matching the
        # reference's fault-isolation contract (scripts/STRique.py:764-768)
        for ctx, raw, _tok in items:
            out = None
            try:
                out = self.counter.detect(target_name, raw, strand)
            except KeyboardInterrupt:
                raise
            except Exception:
                log("Factory: Unexpected error in read retry, proceeding with "
                    "remaining reads.\n"
                    + "".join(traceback.format_exception(*sys.exc_info())), LogLevel.Warning)
            self.on_result(ctx, out)
