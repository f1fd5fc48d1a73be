"""The weighted Gram — X'WX, X'Wz and sum(w) of a design matrix.

Reference: h2o3_tpu/ops/gram.py ``gram`` (hex/gram/Gram.java, the
GLMIterationTask accumulation), a blocked ``dot_general`` scan over row
blocks outside any Pallas kernel. Here one ``torch.addmm`` per row block
accumulates into float32 [P, P] (cuBLAS SGEMM on the card): the block
bounds the temporary w·X, which is as large as its rows of X. The sums
run in cuBLAS's order, not the reference's 8192-row blocks, so they
agree within the float32 summation bound; on one card they are the same
from run to run.

TF32 is held off for every product here and in the GLM solvers
(``exact_f32``): a TF32 Gram would lose ten bits of every product, which
the float64 check of ``chip_smoke.py`` phase 22 would catch.

Not ported: ``gram_model_sharded`` (the model-axis ring over a
(data, model) mesh) and the data-parallel reduction; GLM on a frame
partitioned over a sharded mesh raises (ROADMAP A #12).
"""

from __future__ import annotations

import contextlib

import torch

BLOCK_ROWS = 1 << 20


@contextlib.contextmanager
def exact_f32():
    """float32 matrix products in full float32: TF32 off for the block,
    whatever the process set (restored after)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def gram(X, w, z):
    """(X'WX [P, P], X'Wz [P], sum w) in float32 over the rows of X
    [N, P] (intercept column appended by the caller); ``w`` is 0 on
    padding rows, ``z`` the working response."""
    N, P = X.shape
    xtx = torch.zeros((P, P), dtype=torch.float32, device=X.device)
    xtz = torch.zeros((P,), dtype=torch.float32, device=X.device)
    wz = w * z
    with exact_f32():
        for lo in range(0, N, BLOCK_ROWS):
            Xb = X[lo:lo + BLOCK_ROWS]
            xtx.addmm_((Xb * w[lo:lo + BLOCK_ROWS, None]).T, Xb)
            xtz.addmv_(Xb.T, wz[lo:lo + BLOCK_ROWS])
    return xtx, xtz, w.sum()
