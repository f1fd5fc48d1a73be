"""Streaming CSV → device ingest — the chunk-parallel MultiFileParseTask
path.

Reference: h2o3_tpu/io/stream.py (lazy byte Vecs over external files,
water/fvec/FileVec.java:1, feeding MultiFileParseTask chunk-at-a-time,
water/parser/ParseDataset.java:253, with cloud-wide categorical
interning, ParseDataset.java:356-440). A three-stage pipeline:

1. SPLIT (producer thread): the quote-aware splitter (io/chunking.py)
   reads fixed-size byte windows cut at record boundaries and strips
   repeated per-file headers, fanning windows to the tokenizer pool. A
   bounded queue gives backpressure, so at most workers+2 raw windows
   exist on the host at once.
2. TOKENIZE (``workers`` threads): each worker runs the native tokenizer
   (h2o3_tpu_torch/native/csv_parser.cpp, single-threaded per window —
   the worker pool IS the parallelism knob) plus per-column dtype
   narrowing into NumericBlocks / categorical code blocks. ctypes and
   numpy release the GIL, so threads scale across host cores.
3. MERGE + TRANSFER (caller thread): windows merge strictly in order
   into per-column BlockAccumulators (frame/column.py) — global
   categorical interning, int/float narrowing reconciliation, and one
   host-to-device copy per block. On the card a block is staged in
   pinned memory and copied with ``non_blocking=True`` on a side CUDA
   stream; a ``torch.cuda.Event`` marks each chunk's copies, and the
   merge waits on chunk N-2's event before it stages chunk N (the
   reference's depth-2 window of async ``jax.device_put``), so tokenize
   and transfer overlap. On the CPU the copy is plain.

Because the merge stage is the SAME code consuming the SAME windows in
the SAME order, the parallel path is bit-identical to the sequential
one (workers=1). The reference's telemetry, cancellation points and
memory-governor admission are not ported (ROADMAP A #9, #13).
"""

from __future__ import annotations

import collections
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from h2o3_tpu_torch.frame.column import (BlockAccumulator, block_values_f64,
                                         narrow_numeric_block)
from h2o3_tpu_torch.frame.frame import Frame, _no_key
from h2o3_tpu_torch.io import chunking
from h2o3_tpu_torch.io.chunking import iter_line_chunks
from h2o3_tpu_torch.native import parse_csv_bytes
from h2o3_tpu_torch.parallel import device as dev_mod

# chunks whose device blocks may still be in flight before the merge
# stage waits on the oldest — the double-buffer depth
_TRANSFER_DEPTH = 2

_DONE = object()


def _tokenize_window(window: bytes, is_first: bool):
    """Pure per-chunk stage: native tokenize + per-column narrowing.

    Runs on worker threads; touches no shared state. Returns
    (names_or_None, entries, nrows) where entries are positional
    per-column tuples — ('cat', int32 codes, window-local domain) or
    ('num', NumericBlock) — that the in-order merge maps to global
    column names.
    """
    cols, domains = parse_csv_bytes(window, header=is_first, decode=False,
                                    nthreads=1)
    names = list(cols.keys()) if is_first else None
    entries = []
    for nm, arr in cols.items():
        if nm in domains:
            entries.append(("cat", arr.astype(np.int32, copy=False),
                            domains[nm]))
        else:
            entries.append(("num",
                            narrow_numeric_block(np.asarray(arr,
                                                            np.float64))))
    nrows = len(next(iter(cols.values()))) if cols else 0
    return names, entries, nrows


class _Transfer:
    """Host → device copies of one ingest. On a CUDA device each block is
    staged in pinned memory and copied asynchronously on a side stream;
    ``ticket`` closes one chunk's copies with an event (and keeps their
    pinned buffers alive until it has passed); ``close`` orders the
    caller's stream after the side stream, so the assembly may read the
    blocks. On the CPU ``put`` is a plain tensor."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.pinned: List[torch.Tensor] = []
        self.made: List[torch.Tensor] = []

    def put(self, arr: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(arr)
        if not self.cuda:
            return host
        host = host.pin_memory()
        with torch.cuda.stream(self.stream):
            out = host.to(self.device, non_blocking=True)
        self.pinned.append(host)
        self.made.append(out)
        return out

    def ticket(self):
        """(event, pinned buffers) of the copies since the last ticket,
        or None on the CPU or when nothing was copied."""
        if not self.cuda or not self.pinned:
            return None
        ev = torch.cuda.Event()
        ev.record(self.stream)
        held, self.pinned = self.pinned, []
        return ev, held

    def close(self) -> None:
        if self.cuda:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_stream(self.stream)
            for t in self.made:
                t.record_stream(cur)
        self.made = []


class _MergeState:
    """The in-order merge stage: owns the per-column accumulators.

    One instance per parse; fed window results strictly in window order
    by both the sequential and parallel drivers, so the resulting
    frames/domains/dtypes are identical regardless of worker count.
    """

    def __init__(self, col_types: Optional[Dict[str, str]],
                 transfer: _Transfer):
        self.col_types = col_types or {}
        self.transfer = transfer
        self.accs: Dict[str, BlockAccumulator] = {}
        self.names: List[str] = []
        self.total = 0

    def merge(self, names: Optional[List[str]], entries, nrows: int):
        if names is not None and not self.names:
            self.names = names
            self.accs = {nm: BlockAccumulator(nm, self.transfer.device,
                                              self.transfer.put)
                         for nm in names}
        self.total += nrows
        for nm, entry in zip(self.names, entries):
            acc = self.accs[nm]
            if entry[0] == "cat":
                acc.add_categorical(entry[1], entry[2])
            elif self.col_types.get(nm) == "categorical":
                acc.add_categorical(np.zeros(0, np.int32), [],
                                    raw_numeric=block_values_f64(entry[1]))
            else:
                acc.add_numeric_block(entry[1])


class _TransferWindow:
    """Double-buffered transfer stage: bounds the chunks whose copies
    may be in flight to ~_TRANSFER_DEPTH, so the async copies overlap
    tokenize without unbounded pinned staging."""

    def __init__(self):
        self._tickets = collections.deque()

    def add(self, ticket) -> None:
        if ticket is not None:
            self._tickets.append(ticket)
        while len(self._tickets) > _TRANSFER_DEPTH:
            self._wait_one()

    def drain(self) -> None:
        while self._tickets:
            self._wait_one()

    def _wait_one(self) -> None:
        event, _held = self._tickets.popleft()
        event.synchronize()


def _consume(state: _MergeState, result, window: _TransferWindow) -> None:
    """Shared merge step for both drivers: in-order accumulator merge,
    transfer ticketing."""
    names, entries, nrows = result
    state.merge(names, entries, nrows)
    window.add(state.transfer.ticket())


def _run_sequential(paths: List[str], chunk_bytes: int, state: _MergeState,
                    window: _TransferWindow) -> None:
    for chunk, is_first in iter_line_chunks(paths, chunk_bytes):
        _consume(state, _tokenize_window(chunk, is_first), window)


def _run_parallel(paths: List[str], chunk_bytes: int, state: _MergeState,
                  nworkers: int, window: _TransferWindow) -> None:
    """Producer → tokenizer pool → in-order merge. The bounded queue is
    the backpressure: at most nworkers+2 windows (raw bytes or parsed
    blocks) live on the host at once."""
    q: "queue.Queue" = queue.Queue(maxsize=nworkers + 2)
    stop = threading.Event()
    pool = ThreadPoolExecutor(max_workers=nworkers,
                              thread_name_prefix="parse-tok")

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _producer():
        try:
            for chunk, is_first in iter_line_chunks(paths, chunk_bytes):
                if stop.is_set():
                    return
                if not _put(pool.submit(_tokenize_window, chunk,
                                        is_first)):
                    return
        except BaseException as e:          # surface read errors in merge
            _put(e)
        finally:
            _put(_DONE)

    prod = threading.Thread(target=_producer, name="parse-split",
                            daemon=True)
    prod.start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                break
            if isinstance(item, BaseException):
                raise item
            _consume(state, item.result(), window)
    finally:
        stop.set()
        while True:                          # unblock a stuck producer
            try:
                q.get_nowait()
            except queue.Empty:
                break
        prod.join(timeout=10.0)
        pool.shutdown(wait=True, cancel_futures=True)


def stream_import_csv(path, destination_frame: Optional[str] = None,
                      chunk_bytes: Optional[int] = None,
                      col_types: Optional[Dict[str, str]] = None,
                      workers: Optional[int] = None,
                      device: dev_mod.DeviceLike = None) -> Frame:
    """Chunk-parallel native parse with overlapped async host-to-device
    copies, onto ``device`` (CUDA unless the caller names another).

    ``workers`` (default: H2O3TPU_PARSE_WORKERS / host cores) sizes the
    tokenizer pool; workers=1 runs the sequential path. Both paths
    produce bit-identical frames (data, dtypes, domains, NA masks).
    ``destination_frame`` needs the DKV and raises
    ``NotImplementedError``.
    """
    _no_key(destination_frame)
    device = dev_mod.resolve_device(device)
    paths = chunking.expand_paths(path)
    if not paths or not all(os.path.exists(f) for f in paths):
        raise FileNotFoundError(str(path))
    nworkers = chunking.resolve_workers(workers)
    cbytes = chunking.resolve_chunk_bytes(chunk_bytes)
    transfer = _Transfer(device)
    state = _MergeState(col_types, transfer)
    window = _TransferWindow()
    try:
        if nworkers == 1:
            _run_sequential(paths, cbytes, state, window)
        else:
            _run_parallel(paths, cbytes, state, nworkers, window)
    finally:
        window.drain()
        transfer.close()
    return Frame.from_blocks(state.accs, state.names, state.total)
