"""Persist — byte-storage drivers and the binary Frame/Model codecs.

Reference: h2o3_tpu/io/persist.py (water/persist/PersistManager.java
with the Persist{FS,Hex,EagerHTTP} drivers; water/fvec/persist/
FramePersist.java; the SaveModel/LoadModel handlers over Iced
serialization). A driver resolves a URI scheme to read and write byte
blobs: ``file://`` and bare paths, ``hex://`` (the node's ice
directory, ``H2O3_TPU_ICE_DIR`` or ``<tmp>/h2o3_tpu_ice``), and
``http(s)://`` read-only through ``urllib``.

A frame is one npz of dtype-narrowed columns plus a JSON header, the
reference's layout byte for byte in meaning: each package loads the
other's frames. A model is pickled with every tensor lowered to host
numpy and every generator to its state, so ``load_model`` puts it on
any device (the card by default).

Not ported: ``s3://``, ``gs://`` and ``hdfs://`` (the reference's
``_ArrowFsDriver``) need pyarrow, which the card's machine lacks; they
raise ``NotImplementedError`` naming it and ROADMAP A #10. No durability mirror and no
cloud checkpoint (ROADMAP A #13).
"""

from __future__ import annotations

import contextlib
import contextvars
import io
import json
import os
import pickle
import tempfile
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from h2o3_tpu_torch.core.kv import DKV
from h2o3_tpu_torch.frame.column import T_CAT, T_STR, T_UUID
from h2o3_tpu_torch.parallel import device as dev_mod


# ------------------------------------------------------------------ drivers

class PersistDriver:
    scheme = ""

    def read(self, uri: str) -> bytes:
        raise NotImplementedError

    def write(self, uri: str, data: bytes) -> None:
        raise NotImplementedError

    def exists(self, uri: str) -> bool:
        raise NotImplementedError

    def delete(self, uri: str) -> None:
        raise NotImplementedError

    def list(self, uri: str) -> List[str]:
        raise NotImplementedError


class _FileDriver(PersistDriver):
    scheme = "file"

    def _path(self, uri: str) -> str:
        return uri[7:] if uri.startswith("file://") else uri

    def read(self, uri: str) -> bytes:
        with open(self._path(uri), "rb") as f:
            return f.read()

    def write(self, uri: str, data: bytes) -> None:
        p = self._path(uri)
        os.makedirs(os.path.dirname(os.path.abspath(p)), exist_ok=True)
        tmp = p + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, p)   # atomic publish

    def exists(self, uri: str) -> bool:
        return os.path.exists(self._path(uri))

    def delete(self, uri: str) -> None:
        p = self._path(uri)
        if os.path.exists(p):
            os.remove(p)

    def list(self, uri: str) -> List[str]:
        p = self._path(uri)
        if not os.path.isdir(p):
            return []
        return sorted(os.path.join(p, f) for f in os.listdir(p))


class _IceDriver(_FileDriver):
    """hex:// — the node's ice (spill/checkpoint) directory, read from
    ``H2O3_TPU_ICE_DIR`` at each call."""

    scheme = "hex"

    @property
    def root(self) -> str:
        return os.environ.get(
            "H2O3_TPU_ICE_DIR",
            os.path.join(tempfile.gettempdir(), "h2o3_tpu_ice"))

    def _path(self, uri: str) -> str:
        rel = uri[6:] if uri.startswith("hex://") else uri
        return os.path.join(self.root, rel)


class _HTTPDriver(PersistDriver):
    """Read-only HTTP(S) ingest (water/persist/PersistEagerHTTP)."""

    scheme = "http"

    def read(self, uri: str) -> bytes:
        from urllib.request import urlopen
        with urlopen(uri, timeout=60) as r:
            return r.read()

    def exists(self, uri: str) -> bool:
        from urllib.request import Request, urlopen
        try:
            with urlopen(Request(uri, method="HEAD"), timeout=30) as r:
                return 200 <= r.status < 400
        except Exception:   # noqa: BLE001 - unreachable means absent
            return False

    def write(self, uri: str, data: bytes) -> None:
        raise IOError("HTTP persist is read-only")

    def delete(self, uri: str) -> None:
        raise IOError("HTTP persist is read-only")

    def list(self, uri: str) -> List[str]:
        return [uri]


class _ArrowFsDriver(PersistDriver):
    """s3://, gs:// and hdfs://: the reference reaches them through
    pyarrow's filesystems, which the port does not have."""

    def __init__(self, scheme: str):
        self.scheme = scheme

    def _raise(self, uri: str):
        raise NotImplementedError(
            f"{self.scheme}:// needs pyarrow's filesystems, which the port "
            f"does not use; not ported (ROADMAP A #10 leaves it out): {uri}")

    read = write = exists = delete = list = \
        lambda self, uri, *a: self._raise(uri)


class PersistManager:
    """Scheme → driver dispatch (water/persist/PersistManager.java)."""

    def __init__(self):
        self._drivers: Dict[str, PersistDriver] = {}
        fd = _FileDriver()
        self.register(fd)
        self.register(_IceDriver())
        http = _HTTPDriver()
        self._drivers["http"] = http
        self._drivers["https"] = http
        for scheme in ("s3", "gs", "gcs", "hdfs"):
            self._drivers[scheme] = _ArrowFsDriver(scheme)
        self._default = fd

    def register(self, driver: PersistDriver) -> None:
        self._drivers[driver.scheme] = driver

    def driver_for(self, uri: str) -> PersistDriver:
        if "://" in uri:
            scheme = uri.split("://", 1)[0].lower()
            d = self._drivers.get(scheme)
            if d is None:
                raise IOError(
                    f"no persist driver for scheme '{scheme}://' — register "
                    "one via persist_manager.register() (built in: "
                    "file/hex/http)")
            return d
        return self._default

    def read(self, uri: str) -> bytes:
        return self.driver_for(uri).read(uri)

    def write(self, uri: str, data: bytes) -> None:
        self.driver_for(uri).write(uri, data)

    def exists(self, uri: str) -> bool:
        return self.driver_for(uri).exists(uri)

    def delete(self, uri: str) -> None:
        self.driver_for(uri).delete(uri)

    def list(self, uri: str) -> List[str]:
        return self.driver_for(uri).list(uri)


persist_manager = PersistManager()


# ------------------------------------------------------------------ frames

_FRAME_MAGIC = "h2o3tpu-frame-v1"


def narrowed(values: np.ndarray, na: np.ndarray) -> np.ndarray:
    """A numeric column as the reference stores it (frame/column.py
    ``column_from_numpy``): NA zero-filled, int8/int16/int32 for an
    integral range below 2^31, float32 otherwise."""
    clean = np.where(na, 0.0, values)
    n = clean.shape[0]
    if np.all(clean == np.round(clean)) and np.all(np.abs(clean) < 2**31):
        lo, hi = (clean.min(), clean.max()) if n else (0, 0)
        if -128 <= lo and hi <= 127:
            return clean.astype(np.int8)
        if -32768 <= lo and hi <= 32767:
            return clean.astype(np.int16)
        return clean.astype(np.int32)
    return clean.astype(np.float32)


def frame_to_bytes(frame) -> bytes:
    """The frame's logical rows as one byte blob: the reference's header
    and arrays (``c{i}`` the values, ``m{i}`` the NA mask) from the
    columns' host views."""
    header = {"magic": _FRAME_MAGIC, "nrows": frame.nrows,
              "names": list(frame.names), "types": {}, "domains": {}}
    arrays = {}
    for i, name in enumerate(frame.names):
        c = frame.col(name)
        header["types"][name] = c.type
        if c.domain is not None:
            header["domains"][name] = list(c.domain)
        if c.type in (T_STR, T_UUID):
            s = c.strings[: c.nrows]
            mask = np.array([x is None for x in s], dtype=bool)
            arrays[f"c{i}"] = np.where(mask, "", s).astype("U")
            arrays[f"m{i}"] = mask
            continue
        host = c.host_view()
        na = np.isnan(host)
        arrays[f"c{i}"] = (np.where(na, 0, host).astype(np.int32)
                           if c.type == T_CAT else narrowed(host, na))
        arrays[f"m{i}"] = na
    buf = io.BytesIO()
    np.savez_compressed(buf, __header__=np.frombuffer(
        json.dumps(header).encode(), dtype=np.uint8), **arrays)
    return buf.getvalue()


def save_frame(frame, uri: str) -> str:
    """Binary frame export (FramePersist.saveTo)."""
    persist_manager.write(uri, frame_to_bytes(frame))
    return uri


def frame_from_bytes(data: bytes, key: Optional[str] = None,
                     device: dev_mod.DeviceLike = None):
    """Inverse of ``frame_to_bytes`` (the reference's blobs too), through
    ``Frame.from_numpy`` on ``device`` (the card unless named)."""
    from h2o3_tpu_torch.frame.frame import Frame
    npz = np.load(io.BytesIO(data), allow_pickle=False)
    header = json.loads(bytes(npz["__header__"]).decode())
    if header.get("magic") != _FRAME_MAGIC:
        raise IOError("blob is not an h2o3-tpu frame export")
    cols: Dict[str, np.ndarray] = {}
    domains: Dict[str, List[str]] = {}
    cats: List[str] = []
    strs: List[str] = []
    uuids: List[str] = []
    for i, name in enumerate(header["names"]):
        t = header["types"][name]
        if t in (T_STR, T_UUID):
            s = npz[f"c{i}"].astype(object)
            # frames saved before masks existed have no m{i}: all valid
            if f"m{i}" in npz.files:
                s[npz[f"m{i}"]] = None
            cols[name] = s
            (uuids if t == T_UUID else strs).append(name)
        elif t == T_CAT:
            codes = npz[f"c{i}"].astype(np.int32)
            if f"m{i}" in npz.files:
                codes = np.where(npz[f"m{i}"], -1, codes)
            cols[name] = codes
            domains[name] = header["domains"][name]
            cats.append(name)
        else:   # numeric (incl. time columns, stored as epoch numerics)
            v = npz[f"c{i}"].astype(np.float64)
            cols[name] = np.where(npz[f"m{i}"], np.nan, v)
    return Frame.from_numpy(cols, categorical=cats, domains=domains,
                            strings=strs, uuids=uuids, key=key,
                            device=device)


def load_frame(uri: str, key: Optional[str] = None,
               device: dev_mod.DeviceLike = None):
    """Binary frame import (FramePersist.loadFrom)."""
    return frame_from_bytes(persist_manager.read(uri), key=key,
                            device=device)


# ------------------------------------------------------------------ models

_LOAD_DEVICE: contextvars.ContextVar = contextvars.ContextVar(
    "h2o3_torch_load_device", default=torch.device("cpu"))


def _tensor(values: np.ndarray, dtype: str, requires_grad: bool):
    """A pickled tensor back on the loading device."""
    t = torch.from_numpy(np.array(values)).to(
        _LOAD_DEVICE.get(), getattr(torch, dtype))
    return t.requires_grad_() if requires_grad else t


def _generator(state: np.ndarray):
    """A pickled CPU generator back from its state."""
    g = torch.Generator()
    g.set_state(torch.from_numpy(np.array(state)))
    return g


class _DeviceLoweringPickler(pickle.Pickler):
    """Pickle with every tensor lowered to host numpy (its dtype kept by
    name), every CPU generator to its state and every weak reference to
    None: a saved model holds no device memory and loads on any
    device."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            t = obj.detach().cpu()
            if t.dtype == torch.bfloat16:
                return (_bf16_tensor, (t.view(torch.int16).numpy(),
                                       obj.requires_grad))
            return (_tensor, (t.numpy(), str(t.dtype).split(".")[1],
                              obj.requires_grad))
        if isinstance(obj, weakref.ref):
            # a binning's weak reference to its training frame: the frame
            # does not travel with the model
            return (_no_ref, ())
        if isinstance(obj, torch.Generator):
            if obj.device.type != "cpu":
                raise pickle.PicklingError(
                    "a CUDA generator cannot be saved: carry its state "
                    "(the model's _gen_state) instead")
            return (_generator, (obj.get_state().numpy(),))
        return NotImplemented


def _no_ref():
    return None


def _bf16_tensor(bits: np.ndarray, requires_grad: bool):
    t = torch.from_numpy(np.array(bits)).view(torch.bfloat16).to(
        _LOAD_DEVICE.get())
    return t.requires_grad_() if requires_grad else t


def model_to_bytes(model) -> bytes:
    """Device-lowered model binary — the codec under ``save_model``."""
    buf = io.BytesIO()
    _DeviceLoweringPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(model)
    return buf.getvalue()


def save_model(model, uri: str) -> str:
    """Full binary model save (the REST SaveModel role): unlike a MOJO
    it keeps the params, metrics and output, and a checkpoint restart
    continues from it."""
    persist_manager.write(uri, model_to_bytes(model))
    return uri


@contextlib.contextmanager
def _loading_onto(device: torch.device):
    tok = _LOAD_DEVICE.set(device)
    try:
        yield
    finally:
        _LOAD_DEVICE.reset(tok)


def model_from_bytes(data: bytes, device: dev_mod.DeviceLike = None):
    """Inverse of ``model_to_bytes`` with every tensor on ``device`` (the
    card unless named); the model is stored in the DKV under its key."""
    with _loading_onto(dev_mod.resolve_device(device)):
        model = pickle.loads(data)
    DKV.put(model.key, model)
    return model


def load_model(uri: str, device: dev_mod.DeviceLike = None):
    """Binary model load (the REST LoadModel role)."""
    return model_from_bytes(persist_manager.read(uri), device=device)
