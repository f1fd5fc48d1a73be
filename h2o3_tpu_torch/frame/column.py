"""Column — one typed device column with an NA mask and a domain.

Reference: h2o3_tpu/frame/column.py (``Column``, ``column_from_numpy``
and the block half: ``block_int_dtype``, ``NumericBlock``,
``narrow_numeric_block``, ``block_values_f64``, ``BlockAccumulator``).
Numeric columns are float32 on the device and categorical columns int32
codes plus a host-side ``domain`` list, each with a bool NA mask;
padding rows are marked NA. String and UUID columns stay on the host
(``strings``, no device data), as the reference keeps them.

The reference narrows a numeric column's device dtype (int8/16/32 or
float32); the port keeps float32 on the device, whose values are the
reference's ``numeric_view()`` (a float32 cast of the narrowed data)
bit for bit. Every column also keeps its float64 host view (NaN at NA;
codes for categoricals), which the host-side paths read — the bin-edge
sketch, the response, the weights — so none of them fetches from the
device. It is the reference's host view bit for bit: the exact input
values for ``column_from_numpy``, the narrowed values for a streamed
column.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

T_NUM, T_CAT, T_STR = "numeric", "categorical", "string"
T_UUID = "uuid"      # host-side 128-bit ids (C16Chunk role), never in math


@dataclasses.dataclass
class Column:
    name: str
    type: str                        # T_NUM | T_CAT | T_STR | T_UUID
    data: Optional[torch.Tensor]     # padded: float32 values | int32 codes;
    #                                  None for T_STR / T_UUID
    na_mask: Optional[torch.Tensor]  # padded bool, True = missing
    nrows: int                       # logical (unpadded) length
    domain: Optional[List[str]] = None
    host: Optional[np.ndarray] = None    # float64 [nrows], NaN at NA
    strings: Optional[np.ndarray] = None  # host objects for T_STR/T_UUID
    # computes ``host`` at the first ``host_view()`` where it was not
    # built with the column (a device merge's output)
    host_fn: Optional[Callable[[], np.ndarray]] = None

    @property
    def is_categorical(self) -> bool:
        return self.type == T_CAT

    @property
    def is_uuid(self) -> bool:
        return self.type == T_UUID

    @property
    def cardinality(self) -> int:
        return len(self.domain) if self.domain else 0

    def numeric_view(self) -> torch.Tensor:
        """float32 view with NaN at NA positions — the math-path input."""
        return torch.where(self.na_mask, torch.nan,
                           self.data.to(torch.float32))

    def host_view(self) -> np.ndarray:
        """READ-ONLY float64 host view of the logical rows, NaN at NA
        (the objects of a string or UUID column)."""
        if self.type in (T_STR, T_UUID):
            return self.strings[: self.nrows]
        if self.host is None and self.host_fn is not None:
            self.host, self.host_fn = self.host_fn(), None
        return self.host

    def to_numpy(self) -> np.ndarray:
        """Owned copy of ``host_view()``."""
        return self.host_view().copy()


def _intern(values: np.ndarray):
    """Strings → (sorted domain, int32 codes with -1 for missing) — the
    interning of the reference parser (lexicographic domain)."""
    missing = np.array([v is None or (isinstance(v, float) and np.isnan(v))
                        for v in values], dtype=bool)
    codes = np.full(values.shape[0], -1, np.int32)
    if (~missing).any():
        uniq, inv = np.unique(values[~missing].astype(str),
                              return_inverse=True)
        codes[~missing] = inv.astype(np.int32)
        return [str(u) for u in uniq], codes
    return [], codes


def factorize_numeric(values: np.ndarray):
    """Numeric values → (sorted domain of their string forms, int32 codes,
    -1 for NaN): a numeric column forced categorical."""
    v = np.asarray(values)
    ok = np.isfinite(v.astype(np.float64))
    codes = np.full(v.shape[0], -1, np.int32)
    uniq, inv = np.unique(v[ok], return_inverse=True)
    codes[ok] = inv.astype(np.int32)
    return [str(u) for u in uniq], codes


def column_from_numpy(name: str, values: np.ndarray, nrows_padded: int,
                      device: torch.device,
                      domain: Optional[List[str]] = None) -> Column:
    """Build a Column from host data.

    Strings intern into a sorted domain (or map through ``domain``,
    unseen and missing → NA); integer codes with a ``domain`` are
    categorical (negative or non-finite → NA); anything else is numeric,
    stored as float32 with non-finite values NA."""
    values = np.asarray(values)
    n = values.shape[0]
    pad = nrows_padded - n
    if values.dtype == object or values.dtype.kind in "US":
        if domain is None:
            domain, codes = _intern(values)
        else:
            lut = {lvl: i for i, lvl in enumerate(domain)}
            codes = np.asarray([lut.get(v, -1) if v is not None else -1
                                for v in values], np.int32)
        na = codes < 0
        data = np.where(na, 0, codes).astype(np.int32)
        ctype = T_CAT
    elif domain is not None:
        na = (values < 0) | ~np.isfinite(values.astype(np.float64))
        data = np.where(na, 0, values).astype(np.int32)
        ctype = T_CAT
    else:
        vals64 = values.astype(np.float64)
        na = ~np.isfinite(vals64)
        data = np.where(na, 0.0, vals64).astype(np.float32)
        ctype = T_NUM
    # numeric: the exact float64 input values, not their float32 copy
    host = np.where(na, np.nan,
                    vals64 if ctype == T_NUM else data.astype(np.float64))
    data_p = np.pad(data, (0, pad))
    na_p = np.pad(na, (0, pad), constant_values=True)   # padding is NA
    return Column(name=name, type=ctype,
                  data=torch.from_numpy(data_p).to(device),
                  na_mask=torch.from_numpy(na_p).to(device),
                  nrows=n, domain=domain, host=host)


# ---------------------------------------------------------------------------
# Block assembly — the chunk-parallel ingest building blocks.
#
# Reference: h2o3_tpu/frame/column.py (water/fvec/NewChunk.compress picks
# a codec per chunk): a NumericBlock carries one window's narrowed values
# + NA mask + the integrality/range facts, and a BlockAccumulator (per
# column) ships each block to the device, interns categorical domains
# globally, and reconciles the per-block narrowing into the final column
# dtype. The tokenize stage (pure, runs on worker threads) builds blocks;
# the in-order merge stage (caller thread) owns the accumulator, so the
# parallel and sequential ingest paths are bit-identical by construction.
# ---------------------------------------------------------------------------


def block_int_dtype(lo: float, hi: float):
    """Narrowest int dtype holding [lo, hi] (int8/int16/int32)."""
    if -128 <= lo and hi <= 127:
        return np.int8
    if -32768 <= lo and hi <= 32767:
        return np.int16
    return np.int32


@dataclasses.dataclass
class NumericBlock:
    """One window's worth of a numeric column, already narrowed."""
    clean: np.ndarray           # NA positions zero-filled
    na: np.ndarray              # bool mask, True = missing
    dtype: object               # narrow storage dtype for this block
    lo: float                   # block min of clean (0.0 when empty)
    hi: float                   # block max of clean (0.0 when empty)
    is_int: bool                # every value integral and |v| < 2**31


def narrow_numeric_block(values: np.ndarray,
                         na: Optional[np.ndarray] = None) -> NumericBlock:
    """Per-chunk codec selection (the NewChunk.compress role). With
    na=None the mask is derived from non-finite values (the CSV tokenizer
    path)."""
    if na is None:
        na = ~np.isfinite(values)
    else:
        na = np.asarray(na, bool)
    clean = np.where(na, 0, values) if na.any() else values
    # range check in float64: np.abs on int64 extremes would overflow
    clean64 = clean.astype(np.float64, copy=False)
    is_int = bool(np.all(clean == np.round(clean)) and
                  np.all(np.abs(clean64) < 2**31))
    lo = float(clean64.min()) if clean.size else 0.0
    hi = float(clean64.max()) if clean.size else 0.0
    if is_int and clean.size:
        bd = block_int_dtype(lo, hi)
    elif is_int:
        bd = np.int8
    else:
        bd = np.float32
    return NumericBlock(clean=clean, na=na, dtype=bd,
                        lo=lo, hi=hi, is_int=is_int)


def block_values_f64(nb: NumericBlock) -> np.ndarray:
    """Reconstruct the block's float64 values with NaN at NAs (the
    categorical-promotion input)."""
    vals = nb.clean.astype(np.float64)
    if nb.na.any():
        vals[nb.na] = np.nan
    return vals


class BlockAccumulator:
    """Per-column accumulator: per-window NARROWED device blocks + the
    global categorical domain.

    Each window's slice goes to the device at the window-local narrow
    dtype (int8/int16 when the block's values fit), its NA mask as packed
    bits only for blocks that have NAs: through ``put`` (a copy from
    pinned memory on the ingest's side stream, ``io/stream.py``), or a
    plain copy when none is given. The narrowed host block is kept too:
    ``finish`` builds the float64 host view from it, and a column
    promoted to categorical mid-stream re-reads its earlier windows from
    it (the reference fetches them back from the device).

    Order contract: add_* calls MUST arrive in window order (the merge
    stage serializes them) — domain interning is append-only and block
    codes are final the moment they are pushed.
    """

    def __init__(self, name: str, device: torch.device, put=None):
        self.name = name
        self.device = device
        self.put = put or (lambda a: torch.from_numpy(a).to(device))
        self.parts: List[torch.Tensor] = []          # device blocks
        self.bit_parts: List[Optional[torch.Tensor]] = []
        self.host_parts: List[np.ndarray] = []       # narrowed host blocks
        self.na_parts: List[np.ndarray] = []
        self.sizes: List[int] = []
        self.levels: Dict[str, int] = {}             # global domain
        self.order: List[str] = []
        self.is_cat = False
        self._all_int, self._lo, self._hi = True, np.inf, -np.inf

    def _push(self, clean: np.ndarray, na: np.ndarray, dtype):
        narrow = np.ascontiguousarray(clean.astype(dtype, copy=False))
        self.parts.append(self.put(narrow))
        self.bit_parts.append(self.put(np.packbits(na)) if na.any()
                              else None)
        self.host_parts.append(narrow)
        self.na_parts.append(na)
        self.sizes.append(len(clean))

    def add_numeric_block(self, nb: NumericBlock):
        """Merge one pre-narrowed window block (tokenize-stage output)."""
        if self.is_cat:
            # numeric window inside a categorical column: values become
            # their string levels (the reference re-types the column)
            self.add_categorical(np.zeros(0, np.int32), [],
                                 raw_numeric=block_values_f64(nb))
            return
        # per-chunk integrality/range tracking for the FINAL dtype
        if self._all_int and nb.is_int:
            if nb.clean.size:
                self._lo = min(self._lo, nb.lo)
                self._hi = max(self._hi, nb.hi)
        else:
            self._all_int = False
        self._push(nb.clean, nb.na, nb.dtype)

    def add_categorical(self, codes: np.ndarray, domain: List[str],
                        raw_numeric: Optional[np.ndarray] = None):
        if not self.is_cat and self.parts:
            # column promoted to categorical mid-stream: earlier numeric
            # blocks are re-expressed as levels from their host copies
            old = list(zip(self.host_parts, self.na_parts))
            self.parts, self.bit_parts, self.sizes = [], [], []
            self.host_parts, self.na_parts = [], []
            self.is_cat = True
            for part, na_old in old:
                vals = part.astype(np.float64)
                vals[na_old] = np.nan
                self.add_categorical(np.zeros(0, np.int32), [],
                                     raw_numeric=vals)
        self.is_cat = True
        if raw_numeric is not None:
            strs = np.array([None if np.isnan(v) else
                             (f"{v:g}") for v in raw_numeric], object)
            codes = np.empty(len(strs), np.int32)
            for i, s in enumerate(strs):
                if s is None:
                    codes[i] = -1
                else:
                    k = self.levels.get(s)
                    if k is None:
                        k = self.levels[s] = len(self.order)
                        self.order.append(s)
                    codes[i] = k
            remapped = codes
        else:
            lut = np.empty(max(len(domain), 1), np.int32)
            for j, lvl in enumerate(domain):
                k = self.levels.get(lvl)
                if k is None:
                    k = self.levels[lvl] = len(self.order)
                    self.order.append(lvl)
                lut[j] = k
            remapped = np.where(codes >= 0, lut[np.maximum(codes, 0)], -1)
        na = remapped < 0
        clean = np.where(na, 0, remapped)
        # interning is append-only, so block codes are final; narrow by
        # the block's max level index (upcast to int32 at assembly)
        self._push(clean, na,
                   block_int_dtype(0, float(clean.max(initial=0))))

    def final_dtype(self):
        """The column's dtype in the reference: int32 codes, the
        narrowest int of an all-integer column, float32 otherwise."""
        if self.is_cat:
            return np.int32
        if self._all_int:
            return block_int_dtype(self._lo, self._hi)
        return np.float32

    def finish(self, n: int, npad: int) -> Column:
        """The column: the device blocks upcast, concatenated and padded
        on the device (float32 values or int32 codes), the NA mask
        unpacked from the blocks' bits there, and the float64 host view
        of the reference's final dtype (a block's values cast to it)."""
        dev = self.device
        final = self.final_dtype()
        dtype = torch.int32 if self.is_cat else torch.float32
        data = torch.zeros(npad, dtype=dtype, device=dev)
        na = torch.ones(npad, dtype=torch.bool, device=dev)
        at = 0
        for part, bits, sz in zip(self.parts, self.bit_parts, self.sizes):
            data[at:at + sz] = part.to(dtype)
            if bits is None:
                na[at:at + sz] = False
            else:
                idx = torch.arange(sz, device=dev)
                na[at:at + sz] = ((bits[idx >> 3].to(torch.int32)
                                   >> (7 - (idx & 7))) & 1).bool()
            at += sz
        host = np.empty(n, np.float64)
        at = 0
        for part, m in zip(self.host_parts, self.na_parts):
            host[at:at + len(part)] = part.astype(final).astype(np.float64)
            host[at:at + len(part)][m] = np.nan
            at += len(part)
        self.parts, self.bit_parts, self.sizes = [], [], []
        self.host_parts, self.na_parts = [], []
        if self.is_cat:
            return Column(name=self.name, type=T_CAT, data=data,
                          na_mask=na, nrows=n, domain=list(self.order),
                          host=host)
        return Column(name=self.name, type=T_NUM, data=data, na_mask=na,
                      nrows=n, host=host)

