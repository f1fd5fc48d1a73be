"""GLRM — generalized low-rank models by alternating minimization.

Reference: h2o3_tpu/models/glrm.py (hex/glrm/GLRM.java): X ≈ A·Y over the
observed cells of ``frame/datainfo.py``'s design (all factor levels), A
[N, k] the row factors and Y [k, P] the archetypes. Each half-step is a
ridge solve per row of A, then per column of Y, over that row's (column's)
observed cells; L1 is a soft threshold after the solve, NonNegative a
projection, Quadratic the ridge itself. Padding rows and the cells of an
NA source value weigh 0 (``cell_mask``). The loop stops when the
objective (the squared error over the observed cells) falls by less than
1e-6 of itself.

The reference forms [N, k, P] products for the per-row and per-column
systems (10.6 GB at 1M rows, k = 10, P = 265). Here the same sums come
from GEMMs (TF32 held off) without them: with M the mask and
YY[p, k·j] = Y[k, p]·Y[j, p], the rows' systems are G = M @ YY
([N, k²]) and b = (M∘X) @ Y'; with AA[n, k·j] = A[n, k]·A[n, j], the
columns' systems are AA' @ M ([k², P]) and A' @ (M∘X). Each batch of
k × k systems (SPD plus λI) is solved by ``torch.linalg.solve`` (LU with
partial pivoting, as the reference's ``jnp.linalg.solve``). The sums
run in another float32 order than the reference's einsums.

``init="SVD"`` takes the top eigenvectors of the design's Gram (their
signs are LAPACK's, JAX's or cuSOLVER's; A follows Y's sign); Random is
0.1·N(0, 1) from ``draw_init_y`` (the port's own draw, a CPU
``torch.Generator``, kept apart so a test can feed in the reference's
``jax.random`` draw). ``loss`` and ``recover_svd`` are accepted and
inert, as in the reference (the loss is quadratic). Not ported: GLRM on a
frame partitioned over a sharded mesh (ROADMAP A #12); MOJO export
(A #10).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.frame.datainfo import build_datainfo, stats_of
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.metrics import ModelMetrics
from h2o3_tpu_torch.models.model import Model, ModelBuilder, ModelCategory
from h2o3_tpu_torch.models.pca import eig_desc, weighted_gram
from h2o3_tpu_torch.ops.gram import exact_f32
from h2o3_tpu_torch.parallel.device import fetch

DEFAULT_SEED = 0x6124       # the reference's seed when ``seed`` < 0
STOP_REL = 1e-6             # the loop stops below this relative fall
LAM_MIN = 1e-6              # the ridge of a half-step without Quadratic


def draw_init_y(seed: int, k: int, P: int) -> torch.Tensor:
    """Random init's N(0, 1) draw [k, P], float32 from a CPU generator
    (scaled by 0.1 where it is used)."""
    return torch.randn((k, P), dtype=torch.float32,
                       generator=torch.Generator().manual_seed(seed))


def prox(M: torch.Tensor, reg: str, gamma: float) -> torch.Tensor:
    if reg == "l1":
        return torch.sign(M) * torch.clamp_min(M.abs() - gamma, 0.0)
    if reg == "nonnegative":
        return torch.clamp_min(M, 0.0)
    return M            # none / quadratic (the ridge of the solve)


def _pairs(F: torch.Tensor) -> torch.Tensor:
    """[n, k] → [n, k²]: the products F[i, a]·F[i, b] at a·k + b."""
    return (F[:, :, None] * F[:, None, :]).reshape(F.shape[0], -1)


def _ridge_solve(G: torch.Tensor, b: torch.Tensor, lam: float):
    """Solve each (G_i + λI) a_i = b_i: G [n, k·k], b [n, k]."""
    k = b.shape[1]
    G = G.view(-1, k, k) + lam * torch.eye(k, dtype=G.dtype,
                                           device=G.device)
    return torch.linalg.solve(G, b[..., None])[..., 0]


def solve_A(MX, mask, Y, lam: float) -> torch.Tensor:
    """The row factors [N, k]: each row's ridge over its observed cells,
    (Y M_r Y' + λI) a_r = Y M_r x_r; ``MX`` is mask ∘ X."""
    with exact_f32():
        G = mask @ _pairs(Y.T)
        b = MX @ Y.T
    return _ridge_solve(G, b, lam)


def solve_Y(MX, mask, A, lam: float) -> torch.Tensor:
    """The archetypes [k, P]: each column's ridge over its observed
    cells, (A' M_p A + λI) y_p = A' M_p x_p."""
    with exact_f32():
        G = (_pairs(A).T @ mask).T
        b = (A.T @ MX).T
    return _ridge_solve(G.contiguous(), b.contiguous(), lam).T


def als_step(X, MX, mask, Y, *, regx: str, regy: str, gx: float,
             gy: float):
    """One alternating step: (A, Y, the float32 objective on the
    device)."""
    A = prox(solve_A(MX, mask, Y, gx if regx == "quadratic" else LAM_MIN),
             regx, gx)
    Y = prox(solve_Y(MX, mask, A, gy if regy == "quadratic" else LAM_MIN),
             regy, gy)
    with exact_f32():
        R = torch.addmm(X, A, Y, alpha=-1.0)      # X - A·Y
    R.mul_(mask)
    return A, Y, (R * R).sum()


def cell_mask(frame: Frame, di) -> torch.Tensor:
    """[Npad, P] observation mask: 0 on padding rows and on the cells of
    an NA source value (a categorical's whole block)."""
    mask = frame.valid_weights()[:, None].repeat(1, di.P)
    ptr = 0
    for i, name in enumerate(di.names):
        width = len(di.domains[i] or []) if di.is_cat[i] else 1
        mask[:, ptr:ptr + width] *= (~frame.col(name).na_mask)[:, None]
        ptr += width
    return mask


class GLRMModel(Model):
    algo = "glrm"

    def __init__(self, params, output, Y, di_stats, features, transform):
        super().__init__(params, output)
        self.Y = Y                       # [k, P] archetypes
        self.di_stats = di_stats
        self.features = features
        self.transform = transform

    def _factorize(self, frame: Frame):
        """(DataInfo, A) of ``frame``: the masked row solve against the
        archetypes, NA cells left out."""
        di = build_datainfo(frame, self.features,
                            standardize=(self.transform == "standardize"),
                            use_all_factor_levels=True,
                            stats_override=self.di_stats)
        mask = cell_mask(frame, di)
        return di, solve_A(di.X * mask, mask, self.Y.to(mask.device),
                           LAM_MIN)

    def _score_raw(self, frame: Frame) -> Dict[str, np.ndarray]:
        A = fetch(self._factorize(frame)[1])[:frame.nrows]
        return {f"Arch{i + 1}": A[:, i] for i in range(A.shape[1])}

    def reconstruct(self, frame: Frame) -> Frame:
        """A·Y of ``frame``'s rows, one column a design column."""
        di, A = self._factorize(frame)
        with exact_f32():
            R = fetch(A @ self.Y.to(A.device))[:frame.nrows]
        return Frame.from_numpy({n: R[:, i]
                                 for i, n in enumerate(di.coef_names)},
                                device=frame.device)

    def model_performance(self, frame: Frame, mask_weights=None):
        return self.training_metrics


class GLRMEstimator(ModelBuilder):
    """h2o-py H2OGeneralizedLowRankEstimator surface."""

    algo = "glrm"
    label = "GLRM"

    DEFAULTS = dict(
        k=1, loss="Quadratic", regularization_x="None",
        regularization_y="None", gamma_x=0.0, gamma_y=0.0,
        max_iterations=50, transform="none", init="SVD", seed=-1,
        ignored_columns=None, recover_svd=False,
    )
    PORTED = frozenset(DEFAULTS)

    def _fit(self, frame: Frame, x: Sequence[str], y: Optional[str],
             validation_frame: Optional[Frame] = None) -> Model:
        p = self.params
        transform = str(p["transform"]).lower()
        di = build_datainfo(frame, x, standardize=(transform == "standardize"),
                            use_all_factor_levels=True)
        k = min(int(p["k"]), di.P)
        X = di.X
        mask = cell_mask(frame, di)
        MX = X * mask
        regx = str(p["regularization_x"]).lower()
        regy = str(p["regularization_y"]).lower()
        gx, gy = float(p["gamma_x"]), float(p["gamma_y"])
        if str(p["init"]).upper() == "SVD":
            Y = eig_desc(weighted_gram(X, frame.valid_weights())[0])[1][
                :, :k].T
        else:
            seed = int(p["seed"]) if int(p["seed"]) >= 0 else DEFAULT_SEED
            Y = 0.1 * draw_init_y(seed, k, di.P).to(X.device)
        prev = obj = np.inf
        it = 0
        for it in range(1, int(p["max_iterations"]) + 1):
            _, Y, obj_d = als_step(X, MX, mask, Y, regx=regx, regy=regy,
                                   gx=gx, gy=gy)
            obj = float(obj_d)
            if prev - obj < STOP_REL * max(abs(prev), 1.0):
                break
            prev = obj
        output = {"category": ModelCategory.DIMREDUCTION, "response": None,
                  "names": list(x), "domain": None,
                  "archetypes": fetch(Y).tolist(),
                  "coef_names": di.coef_names,
                  "objective": obj, "iterations": it}
        model = GLRMModel(p, output, Y, stats_of(di), list(x), transform)
        nobs = float(mask.sum())
        model.training_metrics = ModelMetrics(
            "GLRM", frame.nrows, obj / max(nobs, 1.0), objective=obj)
        return model
