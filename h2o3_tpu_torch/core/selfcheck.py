"""Self-benchmarks — the device capability probes of ``/3/SelfBench``.

Reference: h2o3_tpu/core/selfcheck.py (water/init/{Linpack,
MemoryBandwidth,NetworkBench}.java: every node measures its GFLOPS,
memory bandwidth and network throughput so health pages can flag a slow
node). Here, on the server's device:

- float32 matmul GFLOPS with TF32 off (``tf32`` says so in the output)
  and bf16 matmul GFLOPS (the Linpack role);
- a device-memory read: one sum over a float32 vector (MemoryBandwidth);
- host→device and device→host copies to and from pinned host memory
  on a card (NetworkBench: the PCIe link);
- an all-reduce round trip, only when the process's mesh has more than
  one rank (``parallel/mesh.get_mesh().world_size > 1``).

On a CUDA device every probe is timed between two synchronizations
(``torch.cuda.synchronize``), so the clock reads the device's work.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from h2o3_tpu_torch.parallel import device as dev_mod


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(fn, dev: torch.device, reps: int) -> float:
    """Seconds of one ``fn()`` call, the mean of ``reps`` after a warm
    call, between synchronizations."""
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(dev)
    return (time.perf_counter() - t0) / reps


def run_self_bench(sizes: Optional[Dict[str, int]] = None,
                   device: dev_mod.DeviceLike = None) -> Dict[str, object]:
    """The probes on ``device`` (CUDA unless named; raises without a
    card). ``sizes`` overrides the matmul side (``matmul``, 4096), the
    read vector's elements (``membw``, 64 Mi) and the copy's elements
    (``transfer``, 16 Mi)."""
    from h2o3_tpu_torch.parallel.mesh import get_mesh
    dev = dev_mod.resolve_device(device)
    sizes = sizes or {}
    M = int(sizes.get("matmul", 4096))
    V = int(sizes.get("membw", 64 * 1024 * 1024))
    T = int(sizes.get("transfer", 16 * 1024 * 1024))
    out: Dict[str, object] = {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "backend": dev.type, "tf32": False}

    # Linpack role: f32 (TF32 off) and bf16 matmul GFLOPS
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dtype, name in ((torch.float32, "matmul_f32_gflops"),
                            (torch.bfloat16, "matmul_bf16_gflops")):
            a = torch.ones((M, M), dtype=dtype, device=dev)
            b = torch.ones((M, M), dtype=dtype, device=dev)
            dt = _timed(lambda: a @ b, dev, 5)
            out[name] = round(2 * M ** 3 / dt / 1e9, 1)
            del a, b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev

    # MemoryBandwidth role: a big-vector reduce reads V*4 bytes
    v = torch.ones((V,), dtype=torch.float32, device=dev)
    dt = _timed(lambda: v.sum(), dev, 10)
    out["hbm_read_gbps"] = round(V * 4 / dt / 1e9, 1)
    del v

    # NetworkBench role: host→device and device→host throughput
    host = torch.from_numpy(np.ones((T,), np.float32))
    if dev.type == "cuda":
        host = host.pin_memory()
    _sync(dev)
    t0 = time.perf_counter()
    d = host.to(dev, non_blocking=True)
    _sync(dev)
    out["h2d_gbps"] = round(T * 4 / (time.perf_counter() - t0) / 1e9, 2)
    back = torch.empty((T,), dtype=torch.float32,
                       pin_memory=dev.type == "cuda")
    t0 = time.perf_counter()
    back.copy_(d, non_blocking=True)
    _sync(dev)
    out["d2h_gbps"] = round(T * 4 / (time.perf_counter() - t0) / 1e9, 2)

    # the reduce-tree role, only across more than one rank
    mesh = get_mesh()
    if mesh.world_size > 1:
        from h2o3_tpu_torch.parallel.map_reduce import all_reduce
        x = torch.ones((1024,), dtype=torch.float32, device=dev)
        dt = _timed(lambda: all_reduce(x, mesh), dev, 10)
        out["psum_us"] = round(dt * 1e6, 1)
    return out
