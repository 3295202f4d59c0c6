"""Host-side pipeline runner.

Replaces the reference's fork-based ``mt_dispatcher`` worker pool
(reference scripts/STRique.py:733-830).  In the TPU design a single
process owns the device; parallelism comes from (a) a thread pool that
overlaps fast5 IO + CPU preprocessing with device compute, and (b) data
parallelism over reads across chips (:mod:`strique_tpu.parallel.mesh`).

Per-read fault isolation matches the reference: any exception in a
worker is logged and the pipeline continues (reference :764-768).

The port's own copy of ``strique_tpu/parallel/dispatcher.py``
(tests/test_torch_copies.py pins the two equal); its one device-side
import, the stream scheduler, is the port's.  In the port the
counter's device list (``parallel/mesh.py``) carries the data
parallelism over cards: nothing here changes with it.
"""
from __future__ import annotations

import sys
import traceback
from concurrent.futures import ThreadPoolExecutor

from ..utils.logging import LogLevel, log


def run_pipeline(sam_lines, detector, writer, io_threads: int = 1,
                 batch_size: int = 1) -> int:
    """Stream SAM lines through detection into the writer.

    ``batch_size > 1`` groups lines and uses the detector's batched path
    (one device invocation per read group).  With ``io_threads > 1`` the
    per-read path overlaps fast5 IO + preprocessing across threads.
    Output order follows completion order (like the reference's
    collector).
    """
    n_processed = 0

    import time

    t_start = time.perf_counter()

    def log_rate(n):
        dt = time.perf_counter() - t_start
        if n and dt > 0:
            log(f"Factory: Processed {n} alignments in {dt:.1f}s "
                f"({n / dt:.2f} reads/s).", LogLevel.Info)

    if batch_size > 1:
        # bucket-stream mode: reads queue by (target, strand, jit bucket)
        # and flush as FULL shape-homogeneous device batches — a ragged
        # SAM stream no longer pays half-empty, mixed-length windows
        # (see detect/stream.py)
        from ..detect.stream import StreamScheduler

        line_left: dict[int, int] = {}
        line_rows: dict[int, list] = {}

        def on_result(ctx, out):
            nonlocal n_processed
            line_id, qname, target_name, strand = ctx
            if out is not None:
                line_rows[line_id].append((qname, target_name, strand, *out))
            line_left[line_id] -= 1
            if line_left[line_id] == 0:
                rows = line_rows.pop(line_id)
                del line_left[line_id]
                n_processed += 1
                if rows:
                    writer.write_line(target_counts=rows)

        sched = StreamScheduler(detector.counter, on_result, batch_size=batch_size)

        def feed(line_id, job):
            nonlocal n_processed
            if job is None:
                n_processed += 1
                return
            sr, target_names, raw = job
            line_left[line_id] = len(target_names)
            line_rows[line_id] = []
            # a read intersecting several targets shares one prep token:
            # the first batch to prep it caches the preprocessed buffers,
            # later batches memcpy instead of re-running the native pass
            token = {} if len(target_names) > 1 else None
            for t in target_names:
                sched.add((line_id, sr.QNAME, t, sr.strand), t, sr.strand, raw,
                          prep_token=token)

        def decode(line):
            try:
                return detector.decode_line(line)
            except KeyboardInterrupt:
                raise
            except Exception:
                log("Factory: Unexpected error decoding alignment, proceeding.\n"
                    + "".join(traceback.format_exception(*sys.exc_info())), LogLevel.Warning)
                return None

        if io_threads > 1:
            # bounded prefetch window overlaps fast5 IO with device batches
            pending = []
            with ThreadPoolExecutor(max_workers=io_threads) as pool:
                line_id = 0
                for line in sam_lines:
                    pending.append((line_id, pool.submit(decode, line)))
                    line_id += 1
                    if len(pending) >= io_threads * 8:
                        lid, fut = pending.pop(0)
                        feed(lid, fut.result())
                for lid, fut in pending:
                    feed(lid, fut.result())
        else:
            for line_id, line in enumerate(sam_lines):
                feed(line_id, decode(line))
        sched.close()
        log_rate(n_processed)
        return n_processed

    def work(line):
        try:
            return detector.detect(line)
        except KeyboardInterrupt:
            raise
        except Exception:
            log("Factory: Unexpected error in worker, proceeding with remaining reads.\n"
                + "".join(traceback.format_exception(*sys.exc_info())), LogLevel.Warning)
            return None

    if io_threads <= 1:
        for line in sam_lines:
            result = work(line)
            n_processed += 1
            if result:
                writer.write_line(**result)
        log_rate(n_processed)
        return n_processed

    with ThreadPoolExecutor(max_workers=io_threads) as pool:
        # bounded in-flight window to cap memory
        window = io_threads * 4
        pending = []
        for line in sam_lines:
            pending.append(pool.submit(work, line))
            if len(pending) >= window:
                fut = pending.pop(0)
                result = fut.result()
                n_processed += 1
                if result:
                    writer.write_line(**result)
        for fut in pending:
            result = fut.result()
            n_processed += 1
            if result:
                writer.write_line(**result)
    log_rate(n_processed)
    return n_processed
