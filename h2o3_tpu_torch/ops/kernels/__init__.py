"""CUDA kernel loader — build, load and count the hand-written kernels.

Reference: h2o3_tpu/ops/pallas/__init__.py, the Pallas policy layer. The
port has no policy table and no knob: a CUDA tensor goes to its kernel
or the call raises; a CPU tensor goes to the kernel's plain version.

Build route: each ``csrc/<name>.cu`` (plain C interface, no PyTorch
headers) compiles with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3
-shared -Xcompiler -fPIC`` into ``build/lib<name>-<digest>.so`` at first
use and loads through ``ctypes``. The digest covers the source, every
shared header ``csrc/*.cuh`` and the flags, so an edited source or header
rebuilds and a stale library is never loaded. ``build()`` starts one
``nvcc`` per source, all at once.

Launch counts: every wrapper adds one to ``LAUNCHES[name]`` right after
its kernel launched, and nowhere else, so a run can show that its main
path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

import torch

CSRC = Path(__file__).with_name("csrc")
BUILD = Path(__file__).with_name("build")

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas=-v"]
# per-source extra flags: the split scan must round its gain exactly as
# the plain float32 version does, so no fused multiply-adds
EXTRA = {"treekernel": ["-fmad=false"]}

LAUNCHES: Dict[str, int] = {"tree_hist": 0, "tree_split": 0,
                            "tree_partition": 0, "histogram": 0,
                            "shard_hist": 0, "shard_partition": 0}

_LIBS: Dict[str, ctypes.CDLL] = {}


def count(name: str) -> None:
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                       "PATH); the CUDA kernels cannot be built")


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _cmd(name: str, out: Path) -> List[str]:
    return ([nvcc()] + ARCH + FLAGS + EXTRA.get(name, [])
            + ["-o", str(out), str(CSRC / f"{name}.cu")])


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += b"\0" + header.name.encode() + b"\0" + header.read_bytes()
    flags = " ".join(ARCH + FLAGS + EXTRA.get(name, [])).encode()
    digest = hashlib.sha256(src + b"\0" + flags).hexdigest()[:16]
    return BUILD / f"lib{name}-{digest}.so"


def build(names: Optional[List[str]] = None) -> Dict[str, str]:
    """Compile the named sources (all by default) that have no library
    yet, one ``nvcc`` per source, all started together. Returns each
    built source's compiler log (the ``-Xptxas=-v`` register/shared
    memory report); raises with the log if any build fails."""
    names = sources() if names is None else names
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _cmd(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)     # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(
            f"{n}:\n{logs[n]}" for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it first if
    needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def bind(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """Load ``csrc/<name>.cu`` and declare its launchers: each takes the
    listed ctypes argument types and returns an int cudaError_t; the
    library's ``h2o3_cuda_error_string`` turns one into text."""
    lib = load(name)
    lib.h2o3_cuda_error_string.argtypes = [ctypes.c_int]
    lib.h2o3_cuda_error_string.restype = ctypes.c_char_p
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


# ------------------------------------------------- shared wrapper checks


def on_cuda(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain version for device "
                     f"{t.device}")


def need(t: Optional[torch.Tensor], dtype, shape, name: str, device):
    """``t``'s data pointer (None stays None) after checking its device,
    type, shape and contiguity; raises on anything the kernel does not
    take."""
    if t is None:
        return None
    if t.device != device or t.dtype != dtype or not t.is_contiguous() \
            or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: want contiguous {dtype} {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            f"{'' if t.is_contiguous() else ' (non-contiguous)'}")
    return t.data_ptr()


def launched(lib: ctypes.CDLL, rc: int, name: str) -> None:
    """Raise if the launch was refused; else count it."""
    if rc != 0:
        msg = lib.h2o3_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel failed to launch: {msg} ({rc})")
    count(name)


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream(device) -> int:
    """The raw handle of ``device``'s current CUDA stream, read without
    building a ``torch.cuda.Stream`` (which costs a wrapper several µs a
    call)."""
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    return torch._C._cuda_getCurrentRawStream(index)


def bin_dtype(bins: torch.Tensor) -> int:
    """1 for int8 bins, 0 for int32; raises on any other type."""
    if bins.dtype not in (torch.int8, torch.int32):
        raise ValueError(f"bins must be int8 or int32, got {bins.dtype}")
    return int(bins.dtype == torch.int8)


# The slab histogram's plan (csrc/hist_slab.cuh). One block of
# SLAB_THREADS threads per SM, whose slab copies and row queues may take
# SLAB_BYTES of shared memory: the 227 KB (232,448 B) of dynamic shared
# memory a block may take. An SM holds SM_SMEM_BYTES (228 KB) for its
# blocks, plus 1 KB the runtime keeps per block. SLAB_WAVES blocks per
# SM slot over a launch.
SLAB_BYTES = 232_448
SLAB_THREADS = 1024
SM_SMEM_BYTES = 233_472
SLAB_WAVES = 1
SLAB_QUEUE = 32                 # kSlabQueue: row offsets queued per warp
SLAB_LIST_CHUNKS = 2            # kSlabListChunks: past it, rows are sorted
SLAB_MAX_NODES = 65_535         # a row's node is a 16-bit key (kSlabSkip)


class SlabPlan(NamedTuple):
    """The launch of one slab histogram: a (row blocks, feature groups)
    grid of ``threads``-thread blocks, each walking the ``n_chunks`` node
    chunks in turn and taking ``smem`` bytes: ``replicas`` copies of a
    slab of at most ``chunk_nodes`` nodes × ``group_feats`` features × B
    bins × 3 floats, then ``queue`` bytes of row queues. ``listed``: the
    block sorts its rows by chunk first, into scratch the caller gives it
    (a 16-bit key and a 32-bit list entry a row)."""
    rows_per_block: int
    row_blocks: int
    n_chunks: int
    n_groups: int
    chunk_nodes: int
    group_feats: int
    replicas: int
    threads: int
    smem: int
    queue: int
    listed: bool

    def tiles(self, n_rows: int, n_feat: int, n_nodes: int):
        """Every (block, chunk) tile (r0, r1, c0, c1, f0, f1): the rows
        [r0, r1), nodes [c0, c1) and features [f0, f1), as the kernel
        computes them from its block index and chunk."""
        for x in range(self.row_blocks):
            r0 = x * self.rows_per_block
            r1 = min(n_rows, r0 + self.rows_per_block)
            for z in range(self.n_groups):
                for c in range(self.n_chunks):
                    yield (r0, r1, c * n_nodes // self.n_chunks,
                           (c + 1) * n_nodes // self.n_chunks,
                           z * n_feat // self.n_groups,
                           (z + 1) * n_feat // self.n_groups)


def slab_geometry(n_rows: int, n_feat: int, n_nodes: int, n_bins: int, *,
                  sms: int, budget: Optional[int] = None,
                  threads: Optional[int] = None) -> SlabPlan:
    """Plan a slab histogram launch (csrc/hist_slab.cuh) on a card of
    ``sms`` SMs, the slab copies and the warps' row queues within
    ``budget`` bytes of shared memory a block (SLAB_BYTES by default;
    ``threads`` SLAB_THREADS). Features split into balanced groups only
    when one node's F*B*12 bytes exceed the room beside the queues; nodes
    into the fewest balanced chunks whose slab fits; a slab of at most
    half the room is held min(warps, room // slab) times; and the row
    blocks fill every SM slot about SLAB_WAVES times over, each walking
    every node chunk."""
    budget = SLAB_BYTES if budget is None else budget
    threads = SLAB_THREADS if threads is None else threads
    queue = threads // 32 * SLAB_QUEUE * 4
    room = budget - queue
    cell = n_bins * 12
    if n_nodes > SLAB_MAX_NODES:
        raise ValueError(f"slab histogram: {n_nodes} nodes exceed "
                         f"{SLAB_MAX_NODES}")
    if cell > room:
        raise ValueError(f"slab histogram: one feature's {n_bins} bins "
                         f"({cell} B) exceed the {room} B left of the "
                         f"{budget} B budget beside the row queues")
    n_groups = -(-n_feat // (room // cell))
    group_feats = -(-n_feat // n_groups)
    per_node = group_feats * cell
    n_chunks = max(1, -(-n_nodes // (room // per_node)))
    chunk_nodes = -(-n_nodes // n_chunks)
    slab = max(chunk_nodes, 1) * per_node
    replicas = min(threads // 32, room // slab) if 2 * slab <= room else 1
    smem = replicas * slab + queue
    per_sm = max(1, min(2048 // threads, SM_SMEM_BYTES // (smem + 1024)))
    want = max(1, -(-sms * per_sm * SLAB_WAVES // n_groups))
    # at least kSlabRows (8) rows a thread
    rows_per_block = max(threads * 8, -(-n_rows // want))
    return SlabPlan(rows_per_block, -(-n_rows // rows_per_block), n_chunks,
                    n_groups, chunk_nodes, group_feats, replicas, threads,
                    smem, queue,
                    SLAB_LIST_CHUNKS < n_chunks
                    and 2 * n_chunks <= threads // 32 * SLAB_QUEUE)


def scratch(plan: SlabPlan, n_rows: int, device):
    """The (keys, list) scratch a listed plan sorts its rows into (a key
    a row; a list entry a row and feature group), else (None, None).
    Freed after the launch is enqueued: the caching allocator hands it
    out again only to work ordered after the kernel on the same stream."""
    if not plan.listed:
        return None, None
    return (torch.empty(n_rows, dtype=torch.int16, device=device),
            torch.empty(n_rows * plan.n_groups, dtype=torch.int32,
                        device=device))


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
