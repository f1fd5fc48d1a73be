"""Frame — a named list of device columns of one padded row count.

Reference: h2o3_tpu/frame/frame.py (``Frame.from_numpy``,
``Frame.from_numpy_partitioned``, ``Frame.from_blocks``, ``col``,
``names``, ``nrows_padded``, ``valid_weights``, ``__getitem__``,
``summary``). A frame built with a
``key`` (or imported with a ``destination_frame``) is stored in the DKV
under it, and the entry points that take a frame take its key too
(``resolve_frame``). A frame built without one has ``key`` None and
stays out of the store: dropping it frees its device memory (the
reference keys every frame and spills cold ones, which waits for the
Cleaner, ROADMAP A #13). No durability hooks, no derived-matrix
caches.

A frame built by ``from_numpy`` holds all its rows on one device. A
frame built by ``from_numpy_partitioned`` on a sharded mesh holds, on
each rank's device, only that rank's padded rows ``span = [lo, hi)``;
every column's exact float64 host view still covers all rows.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from h2o3_tpu_torch.core.kv import DKV
from h2o3_tpu_torch.frame import partition as part_mod
from h2o3_tpu_torch.frame.column import (T_STR, T_UUID, Column,
                                         column_from_numpy,
                                         factorize_numeric)
from h2o3_tpu_torch.parallel import device as dev_mod
from h2o3_tpu_torch.parallel import mesh as mesh_mod


class Frame:
    def __init__(self, columns: List[Column], nrows: int,
                 device: torch.device, *, npad: Optional[int] = None,
                 mesh: Optional[mesh_mod.Mesh] = None,
                 span: Optional[Tuple[int, int]] = None, block: int = 8):
        self._cols: Dict[str, Column] = {c.name: c for c in columns}
        self._order: List[str] = [c.name for c in columns]
        self.nrows = nrows
        self.device = device
        self.nrows_padded = nrows if npad is None else npad
        self.mesh = mesh             # None: all rows on one device
        self.span = (0, self.nrows_padded) if span is None else span
        self.block = block
        self.key: Optional[str] = None
        # a partitioned frame's whole-column (mean, sigma) by name, with
        # the column they were taken from (``frame/rollups.py``)
        self.mean_sigma: Dict[str, Tuple[Column, Tuple[float, float]]] = {}

    def _keyed(self, key: Optional[str]) -> "Frame":
        """Store this frame in the DKV under ``key`` (None: no key)."""
        if key is not None:
            self.key = str(key)
            DKV.put(self.key, self)
        return self

    @staticmethod
    def from_numpy(arrays: Dict[str, np.ndarray],
                   categorical: Sequence[str] = (),
                   domains: Optional[Dict[str, List[str]]] = None,
                   strings: Sequence[str] = (),
                   uuids: Sequence[str] = (),
                   device: dev_mod.DeviceLike = None,
                   block: int = 8, pad_to: Optional[int] = None,
                   key: Optional[str] = None) -> "Frame":
        """Build a Frame from host columns on ``device`` (CUDA unless the
        caller names another). ``categorical`` forces listed numeric
        columns to categorical; ``domains`` supplies level lists for
        integer-coded categorical columns; other string columns intern;
        ``strings`` and ``uuids`` keep listed columns as host-side string
        or UUID columns (no interning, never on the device). ``pad_to``
        pads to at least that many rows (cross-validation pads its fold
        frames to the parent frame's shape). A ``key`` stores the frame
        in the DKV under it."""
        device = dev_mod.resolve_device(device)
        names = list(arrays.keys())
        n = len(next(iter(arrays.values()))) if names else 0
        npad = mesh_mod.padded_rows(n, mesh_mod.LOCAL, block)
        if pad_to is not None:
            npad = max(npad, int(pad_to))
        cols = []
        for name in names:
            v = np.asarray(arrays[name])
            if name in strings or name in uuids:
                cols.append(Column(
                    name=name, type=T_UUID if name in uuids else T_STR,
                    data=None, na_mask=None, nrows=n,
                    strings=v.astype(object)))
                continue
            dom = (domains or {}).get(name)
            if name in categorical and dom is None and \
                    v.dtype.kind not in "OUS":
                dom, v = factorize_numeric(v)
            cols.append(column_from_numpy(name, v, npad, device,
                                          domain=dom))
        return Frame(cols, n, device, npad=npad, block=block)._keyed(key)

    @staticmethod
    def from_numpy_partitioned(local_cols: Dict[str, np.ndarray],
                               nrows: int, categorical: Sequence[str] = (),
                               domains: Optional[Dict[str, List[str]]] = None,
                               block: int = 8,
                               mesh: Optional[mesh_mod.Mesh] = None
                               ) -> "Frame":
        """Collective partitioned ingest: every rank calls this at the
        same point with ONLY its ``mesh.owned_rows(nrows, mesh, block)``
        slice of each column, and its device gets only its own padded
        rows. The decisions ``from_numpy`` makes from all rows (string
        and numeric-categorical domains) are agreed in one exchange
        (``frame/partition.py``), and every rank gets the full float64
        host views from one batched all-gather, so the frame equals
        ``from_numpy`` of the concatenated rows: the same domains and
        host views, and the same device bytes for the rank's rows. The
        device is the mesh's; world 1 is ``from_numpy``."""
        mesh = mesh or mesh_mod.get_mesh()
        device = dev_mod.resolve_device(mesh.device)
        nrows = int(nrows)
        npad = mesh_mod.padded_rows(nrows, mesh, block)
        lo, hi = mesh_mod.partition_bounds(npad, mesh)
        n_local = max(min(hi, nrows) - lo, 0)   # this rank's logical rows
        names = list(local_cols.keys())
        facts = {}
        for name in names:
            v = np.asarray(local_cols[name])
            if v.shape[0] != n_local:
                raise ValueError(
                    f"column {name!r}: got {v.shape[0]} rows; rank "
                    f"{mesh.rank} owns logical rows [{min(lo, nrows)}, "
                    f"{min(hi, nrows)})")
            if (domains or {}).get(name) is not None:
                continue                  # coded already: nothing to agree
            if v.dtype == object or v.dtype.kind in "US":
                facts[name] = part_mod.local_str_levels(v)
            elif name in categorical:
                facts[name] = part_mod.local_num_levels(v)
        per_rank = part_mod.allgather_objects(facts, mesh)
        cols = []
        for name in names:
            v = np.asarray(local_cols[name])
            dom = (domains or {}).get(name)
            if name in facts:
                merged = [f[name] for f in per_rank]
                if isinstance(facts[name], list):
                    dom = part_mod.merge_str_levels(merged)
                else:
                    levels = part_mod.merge_num_levels(merged)
                    dom = [str(u) for u in levels]
                    ok = np.isfinite(v.astype(np.float64))
                    v = np.where(ok, np.searchsorted(
                        levels, v.astype(levels.dtype)), -1).astype(np.int32)
            cols.append(column_from_numpy(name, v, hi - lo, device,
                                          domain=dom))
        hosts = part_mod.allgather_rows({c.name: c.host for c in cols}, mesh)
        cols = [dataclasses.replace(c, nrows=nrows, host=hosts[c.name])
                for c in cols]
        return Frame(cols, nrows, device, npad=npad, mesh=mesh,
                     span=(lo, hi), block=block)

    @staticmethod
    def from_blocks(accs: Dict[str, "object"], names: List[str],
                    nrows: int, key: Optional[str] = None,
                    block: int = 1) -> "Frame":
        """Assemble ``frame.column.BlockAccumulator`` columns into a
        Frame — the block-assembly tail of the streamed-CSV ingest
        (``io/stream.py``). Each accumulator's add_* calls already
        arrived in window order; ``finish`` assembles and pads on the
        accumulators' device. A ``key`` stores the frame in the DKV."""
        npad = mesh_mod.padded_rows(nrows, mesh_mod.LOCAL, block)
        cols = [accs[nm].finish(nrows, npad) for nm in names]
        device = accs[names[0]].device if names else \
            dev_mod.resolve_device(None)
        return Frame(cols, nrows, device, npad=npad,
                     block=block)._keyed(key)

    @property
    def names(self) -> List[str]:
        return list(self._order)


    @property
    def ncols(self) -> int:
        return len(self._order)

    @property
    def partitioned(self) -> bool:
        """True when this rank's device holds only its own rows."""
        return mesh_mod.is_sharded(self.mesh)

    def col(self, name_or_idx: Union[str, int]) -> Column:
        if isinstance(name_or_idx, int):
            name_or_idx = self._order[name_or_idx]
        return self._cols[name_or_idx]

    def __getitem__(self, sel) -> "Frame":
        """A frame of the selected columns (names or indices), sharing
        their Column objects; unkeyed."""
        if isinstance(sel, (str, int)):
            sel = [sel]
        return Frame([self.col(s) for s in sel], self.nrows, self.device,
                     npad=self.nrows_padded, mesh=self.mesh,
                     span=self.span, block=self.block)

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def summary(self) -> Dict[str, dict]:
        """Each column's rollups (``frame/rollups.rollups``) with its
        type and, for a categorical, its cardinality."""
        from h2o3_tpu_torch.frame.rollups import rollups
        out = {}
        for n in self._order:
            c = self.col(n)
            s = dict(rollups(c))
            s["type"] = c.type
            if c.domain:
                s["cardinality"] = len(c.domain)
            out[n] = s
        return out

    def add_column(self, col: Column) -> None:
        """Append ``col``, or replace the column of its name. It must
        hold the frame's rows and padding (this rank's padded rows on
        the device); the column's cached ``mean_sigma`` is dropped."""
        lo, hi = self.span
        if col.nrows != self.nrows or (
                col.data is not None and col.data.shape[0] != hi - lo):
            raise ValueError(
                f"column {col.name!r}: {col.nrows} rows padded to "
                f"{None if col.data is None else col.data.shape[0]}; the "
                f"frame has {self.nrows} rows padded to {hi - lo}")
        self._cols[col.name] = col
        self.mean_sigma.pop(col.name, None)
        if col.name not in self._order:
            self._order.append(col.name)

    def valid_weights(self) -> torch.Tensor:
        """1.0 for logical rows, 0.0 for padding rows, over the rows on
        this rank's device."""
        return mesh_mod.valid_mask(self.nrows, self.span, self.device)

    @property
    def local_nrows(self) -> int:
        """Logical (unpadded) rows on this rank's device."""
        lo, hi = self.span
        return max(min(hi, self.nrows) - lo, 0)

    def local_rows(self, host: np.ndarray, fill=0) -> np.ndarray:
        """This rank's padded rows ``span`` of a full host column
        ``host`` [nrows]; padding rows hold ``fill``."""
        lo, hi = self.span
        part = np.asarray(host)[lo:lo + self.local_nrows]
        return np.pad(part, (0, hi - lo - part.shape[0]),
                      constant_values=fill)

    @property
    def one_device_rows(self) -> int:
        """The padded row count ``from_numpy`` gives this frame's rows on
        one device (this frame's own count unless it is partitioned)."""
        if not self.partitioned:
            return self.nrows_padded
        return mesh_mod.padded_rows(self.nrows, mesh_mod.LOCAL, self.block)

    def uniform_rows(self, gen: torch.Generator) -> torch.Tensor:
        """A U[0, 1) draw from ``gen`` a padded row of this rank, as one
        device draws it: ``torch.rand`` over the one-device padded rows,
        of which a rank of a sharded mesh keeps its own logical rows (its
        padding rows get 1.0). Every rank draws the same vector, so ``gen``
        stays in step on every rank and with one device."""
        u = torch.rand(self.one_device_rows, generator=gen,
                       device=self.device)
        if not self.partitioned:
            return u
        lo, hi = self.span
        out = torch.ones(hi - lo, dtype=u.dtype, device=self.device)
        out[:self.local_nrows] = u[lo:lo + self.local_nrows]
        return out

    def __repr__(self) -> str:
        return (f"<Frame {self.nrows}x{self.ncols} on {self.device} "
                f"{self._order[:8]}>")


def raw_columns(frame: Frame, names: Sequence[str]) -> Dict[str, np.ndarray]:
    """Host columns of ``names``: a categorical's level strings as an
    object array (None at NA), any other column's ``to_numpy()``.

    Reference: h2o3_tpu/models/generic.py ``_frame_raw_columns``."""
    out = {}
    for n in names:
        c = frame.col(n)
        if c.is_categorical:
            codes = c.host_view()                # float codes, NaN at NA
            dom = np.asarray(c.domain or [], dtype=object)
            ok = ~np.isnan(codes) & (codes >= 0) & (codes < len(dom))
            vals = np.empty(c.nrows, dtype=object)
            vals[ok] = dom[codes[ok].astype(np.int64)]
            out[n] = vals
        else:
            out[n] = c.to_numpy()
    return out


def resolve_frame(fr, what: str) -> Frame:
    """``fr`` itself, or the Frame the DKV holds under the key ``fr``;
    raises ``ValueError`` naming ``what`` for a key with no frame."""
    if isinstance(fr, Frame):
        return fr
    got = DKV.get(str(fr))
    if not isinstance(got, Frame):
        raise ValueError(f"{what}: no frame under the key {fr!r}")
    return got
