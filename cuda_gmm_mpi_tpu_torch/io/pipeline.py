"""Pipelined ingestion: a worker thread reads the streamed blocks from disk.

The streaming model (models/streaming.py) copies block j+1 to the card
while the card computes block j, but from a chunk array held in host
memory: host memory is O(N). This module moves the pipeline one stage back
to the disk (the JAX package's ``io/pipeline.py``). A
:class:`PipelinedBlockSource` wraps an :class:`~.readers.FileSource` and
serves the streaming loop one block at a time: a worker thread reads the
block's rows (``read_range``, one bounded read each; the readers' metadata
cache makes a CSV range read seek to its rows), casts them to the compute
dtype and centres them, into a bounded queue (``ingest_queue_depth``). So
host memory is O(queue depth x block), never O(N).

The worker touches numpy only: the main thread copies each block into the
pinned staging buffer and onto the card.

Bit-identity: block j of the local data shard d is chunk ``d * blocks + j``
of this rank's slice, and its rows are cast and centred with the
element-wise recipe the resident path applies to its whole slice, so a
pipelined fit equals a resident one bit for bit, on one device and on a
data mesh. Each rank's source covers only its ``host_chunk_bounds`` rows.

:func:`streamed_moments` replaces the load -> ``validate_finite`` ->
``global_moments`` prologue with one pass of range reads: the same
per-chunk partials, the same reduction, one (collective) verdict on the
non-finite rows.

Order: one worker reads the blocks in ascending order and the consumer asks
for them in the same order, so delivery is deterministic; a request out of
order (a resumed pass) restarts the worker at that block. The ``read_slow``
fault (testing/faults.py) delays a read on the worker, which moves the
consumer's wait and nothing else.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional

import numpy as np

from ..testing import faults


class PipelinedBlockSource:
    """The streaming loop's block source, read from a file on a worker.

    ``shape``, ``dtype``, ``num_blocks`` and ``get_block(j)`` are what
    ``StreamingGMMModel`` reads: ``get_block(j)`` returns ``([B, D], [B])``
    when ``local_data_size == 1`` and ``([S, B, D], [S, B])`` otherwise,
    cast to the compute dtype and centred. ``num_chunks`` is this rank's
    chunk count from ``host_chunk_bounds`` (a multiple of
    ``local_data_size``), ``start``/``stop`` its rows; chunk slots past the
    rows are zeros of weight 0, as ``chunk_events`` pads.

    Counters for the ``ingest_summary`` record and the tests:
    ``last_wait_s`` (the consumer's wait for the latest block),
    ``prefetch_wait_s`` (their sum), ``blocks_read``, ``bytes_read``,
    ``peak_resident`` (most blocks ever queued) and ``delivered_order``.
    """

    def __init__(self, source, *, start: int, stop: int, chunk_size: int,
                 num_chunks: int, local_data_size: int = 1,
                 shift: Optional[np.ndarray] = None, dtype=np.float64,
                 queue_depth: int = 4):
        if num_chunks % max(local_data_size, 1):
            raise ValueError(
                f"num_chunks {num_chunks} not divisible by the local "
                f"data-axis extent {local_data_size}; derive slices with "
                "parallel.distributed.host_chunk_bounds")
        self.source = source
        self.start, self.stop = int(start), int(stop)
        self.chunk_size = int(chunk_size)
        self.num_chunks = int(num_chunks)
        self.local_data_size = max(int(local_data_size), 1)
        self.num_blocks = self.num_chunks // self.local_data_size
        self._shift = None if shift is None else np.asarray(shift)
        self._dtype = np.dtype(dtype)
        self.queue_depth = max(int(queue_depth), 1)
        self._n_dims = int(source.shape[1])
        self.last_wait_s = 0.0
        self.prefetch_wait_s = 0.0
        self.blocks_read = 0
        self.bytes_read = 0
        self.peak_resident = 0
        self.delivered_order: list = []  # capped at 65536 entries
        self._summary_emitted = False
        self._gen = 0
        self._next = 0  # the block the live worker serves next
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._lock = threading.Lock()

    @property
    def shape(self):
        return (self.num_chunks, self.chunk_size, self._n_dims)

    @property
    def dtype(self):
        return self._dtype

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def total_weight(self) -> float:
        """This rank's real events (its weight sum: a file carries no
        weights)."""
        return float(self.stop - self.start)

    # -- the worker ---------------------------------------------------------

    def _read_chunk(self, c: int, out_x: np.ndarray, out_w: np.ndarray):
        """Fill chunk slot ``c``: range read, cast, centre (the resident
        path's element-wise recipe), weight 1 per row."""
        m = self.stop - self.start
        a = min(c * self.chunk_size, m)
        b = min((c + 1) * self.chunk_size, m)
        if b > a:
            raw = self.source.read_range(self.start + a, self.start + b)
            self.bytes_read += int(raw.nbytes)
            rows = raw.astype(self._dtype, copy=False)
            if self._shift is not None:
                rows = rows - self._shift[None, :]
            out_x[:b - a] = rows
            out_w[:b - a] = 1.0

    def _read_block(self, j: int):
        cfg = faults.take("read_slow", block=j)
        if cfg is not None:
            time.sleep(float(cfg.get("ms", 0)) / 1e3)
        S, B = self.local_data_size, self.chunk_size
        x = np.zeros((S, B, self._n_dims), self._dtype)
        w = np.zeros((S, B), self._dtype)
        for d in range(S):
            self._read_chunk(d * self.num_blocks + j, x[d], w[d])
        if S == 1:
            return x[0], w[0]
        return x, w

    def _run(self, gen: int, q: queue.Queue, start_block: int):
        """Read blocks ``start_block..num_blocks-1`` in order into ``q``;
        return when the pass ends, a newer generation supersedes this one
        or the source closes. A read error is delivered in the queue, so
        the consumer raises it on its own thread."""
        for j in range(start_block, self.num_blocks):
            try:
                payload = (j, self._read_block(j), None)
            except BaseException as e:  # noqa: BLE001 -- re-raised there
                payload = (j, None, e)
            while True:
                if self._gen != gen or self._closed or self._queue is not q:
                    return
                try:
                    q.put(payload, timeout=0.1)
                    break
                except queue.Full:
                    continue
            with self._lock:
                self.peak_resident = max(self.peak_resident, q.qsize())
            if payload[2] is not None:
                return

    def _restart(self, start_block: int):
        with self._lock:
            self._gen += 1
            gen = self._gen
            q = queue.Queue(maxsize=self.queue_depth)
            self._queue = q
            self._next = start_block
            self._thread = threading.Thread(
                target=self._run, args=(gen, q, start_block),
                name=f"gmm-ingest-{id(self) & 0xffff:x}", daemon=True)
        self._thread.start()

    # -- the consumer -------------------------------------------------------

    def get_block(self, j: int):
        """Block j's (events, weights); waits only while the worker has not
        read it yet (``last_wait_s``)."""
        if self._closed:
            raise RuntimeError("PipelinedBlockSource is closed")
        if not 0 <= j < self.num_blocks:
            raise IndexError(f"block {j} out of range [0, {self.num_blocks})")
        if self._queue is None or self._next != j:
            # First block, a new pass, or a seek (a resumed pass).
            self._restart(j)
        q, gen = self._queue, self._gen
        t0 = time.perf_counter()
        while True:
            try:
                jj, data, err = q.get(timeout=0.1)
            except queue.Empty:
                if self._closed:
                    raise RuntimeError("PipelinedBlockSource closed while "
                                       "waiting for a block") from None
                if self._gen != gen:
                    return self.get_block(j)
                continue
            break
        if jj != j:
            raise RuntimeError(f"prefetch order violated: got block {jj}, "
                               f"expected {j}")
        self.last_wait_s = time.perf_counter() - t0
        self.prefetch_wait_s += self.last_wait_s
        if err is not None:
            raise err
        self._next = j + 1
        self.blocks_read += 1
        if len(self.delivered_order) < 65536:
            self.delivered_order.append(j)
        return data

    def reseek(self, *, start: int, stop: int, num_chunks: int,
               local_data_size: Optional[int] = None) -> None:
        """Rebind the source to a new ``host_chunk_bounds`` range (an
        elastic refit over the survivors): the live worker's generation is
        superseded and the next ``get_block`` starts a pass over the new
        rows. The counters go on accumulating."""
        if self._closed:
            raise RuntimeError("PipelinedBlockSource is closed")
        S = int(local_data_size if local_data_size is not None
                else self.local_data_size)
        if int(num_chunks) % max(S, 1):
            raise ValueError(
                f"num_chunks {num_chunks} not divisible by the local "
                f"data-axis extent {S}; derive slices with "
                "parallel.distributed.host_chunk_bounds")
        with self._lock:
            self._gen += 1
            self._queue = None
            self._next = 0
            self.start, self.stop = int(start), int(stop)
            self.num_chunks = int(num_chunks)
            self.local_data_size = max(S, 1)
            self.num_blocks = self.num_chunks // self.local_data_size

    def close(self):
        """Stop and join the worker and emit ``ingest_summary`` once
        (idempotent)."""
        if self._closed:
            return
        self._closed = True
        with self._lock:
            self._gen += 1
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=30.0)
        self._emit_summary()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass

    def emit_start(self, rec, *, em_mode: str = "full") -> None:
        """One ``ingest_start`` record on an active recorder ``rec``."""
        if not getattr(rec, "active", False):
            return
        rec.emit(
            "ingest_start",
            source=str(getattr(self.source, "path", "<source>")),
            rows=int(self.stop - self.start),
            queue_depth=int(self.queue_depth),
            row_start=int(self.start), row_stop=int(self.stop),
            blocks=int(self.num_blocks),
            chunk_size=int(self.chunk_size),
            mode=str(em_mode),
        )

    def _emit_summary(self) -> None:
        if self._summary_emitted:
            return
        from ..telemetry import current as current_recorder

        rec = current_recorder()
        if not rec.active:
            return
        self._summary_emitted = True
        rec.emit(
            "ingest_summary",
            blocks_read=int(self.blocks_read),
            peak_resident_blocks=int(self.peak_resident),
            prefetch_wait_s=round(float(self.prefetch_wait_s), 6),
            bytes=int(self.bytes_read),
            queue_depth=int(self.queue_depth),
        )


def streamed_moments(source, start: int, stop: int, chunk_size: int,
                     num_chunks: int, *, validate: bool = True,
                     collective: bool = False, dtype=None, index: int = 0,
                     count: int = 1, group=None):
    """(mean [D], var [D]) float64 and the input check in one pass of range
    reads: the per-chunk partials ``global_moments`` builds from a resident
    slice (``moment_part`` per chunk, the same grid and reduction over
    ``index`` of ``count`` slices in ``group``), with the non-finite rows
    counted alongside and one verdict at the end (collective over the
    world with ``collective``), so the result is the resident prologue's
    bit for bit."""
    from ..parallel.distributed import moment_part, reduce_moment_parts
    from ..validation import finite_row_stats, raise_if_nonfinite

    d = int(source.shape[1])
    parts = np.zeros((num_chunks, 1 + 2 * d), np.float64)
    n_bad, first_bad = 0, -1
    m = stop - start
    for j in range(num_chunks):
        a, b = min(j * chunk_size, m), min((j + 1) * chunk_size, m)
        if b <= a:
            continue
        block = np.ascontiguousarray(source.read_range(start + a, start + b))
        if validate:
            nb, fb = finite_row_stats(block, start + a, dtype=dtype)
            if nb:
                n_bad += nb
                if first_bad < 0:
                    first_bad = fb
        parts[j] = moment_part(block)
    if validate:
        raise_if_nonfinite(n_bad, first_bad, collective=collective)
    return reduce_moment_parts(parts, index=index, count=count, group=group)
