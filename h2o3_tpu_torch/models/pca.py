"""PCA and SVD — dimensionality reduction through the Gram.

Reference: h2o3_tpu/models/pca.py (hex/pca/PCA.java, hex/svd/SVD.java).
GramSVD (and Power and GLRM, which take the same route in the reference)
forms the weighted Gram X'WX of ``frame/datainfo.py``'s design with
``ops/gram.gram`` (one float32 GEMM a row block, TF32 held off), scales
it by 1 / (Σw − 1) and takes ``torch.linalg.eigh`` of the [P, P] result
in float32, descending. Randomized (Halko et al.) multiplies the weighted
design by a Gaussian Ω [P, k + 4], orthonormalizes by QR,
``max_iterations`` power steps Q ← qr(X (X'Q)), then takes the SVD of
Q'X. SVD is the unscaled Gram's eigenpairs: V, and d = √λ; its scores are
u = XV / d.

Eigenvectors have no sign: LAPACK, JAX and cuSOLVER may each give a
column either way, and the port adds no sign rule. Ω is the port's own
draw (``draw_omega``, a CPU ``torch.Generator``), kept apart from its use
so a test can feed in the reference's ``jax.random`` draw.

Accepted and inert, as in the reference: PCA's ``compute_metrics`` and
``impute_missing`` (numerics are mean-imputed). Not ported: PCA/SVD on a
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
from h2o3_tpu_torch.ops.gram import exact_f32, gram
from h2o3_tpu_torch.parallel.device import fetch

DEFAULT_SEED = 0x9CA        # the reference's Randomized seed when < 0
OVERSAMPLE = 4              # Randomized's extra columns


def weighted_gram(X, w):
    """X'WX [P, P] and Σw of the design ``X`` (no intercept)."""
    xtx, _, wsum = gram(X, w, torch.zeros_like(w))
    return xtx, wsum


def eig_desc(A: torch.Tensor):
    """Eigenvalues (descending) and their eigenvectors (columns) of the
    symmetric ``A``, in its dtype."""
    evals, evecs = torch.linalg.eigh(A)       # ascending
    return evals.flip(0), evecs.flip(1)


def draw_omega(seed: int, P: int, k: int) -> torch.Tensor:
    """Randomized PCA's Gaussian test matrix Ω [P, k], float32 from a
    CPU generator (the same Ω on every device)."""
    return torch.randn((P, k), dtype=torch.float32,
                       generator=torch.Generator().manual_seed(seed))


def randomized_range(Xw, omega, iters: int) -> torch.Tensor:
    """An orthonormal basis Q [N, k] of the range of ``Xw`` (Halko):
    qr(Xw Ω), then ``iters`` power steps Q ← qr(Xw (Xw'Q))."""
    with exact_f32():
        Q = torch.linalg.qr(Xw @ omega).Q
        for _ in range(iters):
            Q = torch.linalg.qr(Xw @ (Xw.T @ Q)).Q
    return Q


class _Projection(Model):
    """A model scoring the design's projection onto its columns ``V``."""

    def __init__(self, params, output, V, di_stats, features,
                 transform: str, use_all_levels: bool):
        super().__init__(params, output)
        self.V = V                  # [P, k]: eigen- or singular vectors
        self.di_stats = di_stats
        self.features = features
        self.transform = transform
        self.use_all_levels = use_all_levels

    def _project(self, frame: Frame) -> np.ndarray:
        X = build_datainfo(frame, self.features,
                           standardize=(self.transform == "standardize"),
                           use_all_factor_levels=self.use_all_levels,
                           stats_override=self.di_stats).X
        with exact_f32():
            return fetch(X @ self.V.to(X.device))[:frame.nrows]

    def model_performance(self, frame: Frame, mask_weights=None):
        return self.training_metrics


class PCAModel(_Projection):
    algo = "pca"

    def _score_raw(self, frame: Frame) -> Dict[str, np.ndarray]:
        s = self._project(frame)
        return {f"PC{i + 1}": s[:, i] for i in range(s.shape[1])}


class SVDModel(_Projection):
    algo = "svd"

    def _score_raw(self, frame: Frame) -> Dict[str, np.ndarray]:
        sv = np.asarray(self.output["d"], np.float32)
        u = self._project(frame) / np.maximum(sv[None, :], 1e-12)
        return {f"u{i + 1}": u[:, i] for i in range(u.shape[1])}


class PCAEstimator(ModelBuilder):
    """h2o-py H2OPrincipalComponentAnalysisEstimator surface."""

    algo = "pca"
    label = "PCA"

    DEFAULTS = dict(
        k=1, transform="standardize", pca_method="GramSVD",
        max_iterations=20, seed=-1, use_all_factor_levels=False,
        compute_metrics=True, impute_missing=True, ignored_columns=None,
    )
    PORTED = frozenset(DEFAULTS)

    def _fit(self, frame: Frame, x: Sequence[str], y: Optional[str],
             validation_frame: Optional[Frame] = None) -> Model:
        p = self.params
        transform = str(p["transform"]).lower()
        di = build_datainfo(
            frame, x, standardize=(transform == "standardize"),
            use_all_factor_levels=bool(p["use_all_factor_levels"]))
        w = frame.valid_weights()
        k = min(int(p["k"]), di.P)
        if str(p["pca_method"]).lower() in ("gramsvd", "power", "glrm"):
            xtx, wsum = weighted_gram(di.X, w)
            evals, evecs = eig_desc(xtx / torch.clamp_min(wsum - 1.0, 1.0))
            evals = np.maximum(fetch(evals), 0.0)
            V = evecs[:, :k]
            sdev = np.sqrt(evals)
        else:                       # randomized
            seed = int(p["seed"]) if int(p["seed"]) >= 0 else DEFAULT_SEED
            omega = draw_omega(seed, di.P, k + OVERSAMPLE).to(w.device)
            Q = randomized_range(di.X * w[:, None], omega,
                                 int(p["max_iterations"]))
            with exact_f32():
                B = Q.T @ di.X                      # [k + 4, P]
            _, s, Vh = torch.linalg.svd(B, full_matrices=False)
            V = Vh.T[:, :k].contiguous()
            n_eff = float(w.sum())
            sdev = fetch(s) / np.sqrt(max(n_eff - 1.0, 1.0))
            evals = sdev ** 2
        tot = float(evals.sum()) or 1.0
        prop = evals[:k] / tot
        output = {"category": ModelCategory.DIMREDUCTION, "response": None,
                  "names": list(x), "domain": None,
                  "std_deviation": sdev[:k].tolist(),
                  "eigenvectors": fetch(V).tolist(),
                  "coef_names": di.coef_names,
                  "pct_variance": prop.tolist(),
                  "cum_pct_variance": np.cumsum(prop).tolist()}
        model = PCAModel(p, output, V, stats_of(di), list(x), transform,
                         bool(p["use_all_factor_levels"]))
        model.training_metrics = ModelMetrics(
            "PCA", frame.nrows, 0.0,
            pct_variance_explained=float(np.cumsum(prop)[-1]))
        return model


class SVDEstimator(ModelBuilder):
    """h2o-py H2OSingularValueDecompositionEstimator surface: every
    ``svd_method`` takes the Gram route, as in the reference."""

    algo = "svd"
    label = "SVD"

    DEFAULTS = dict(
        nv=1, transform="none", svd_method="GramSVD", max_iterations=20,
        seed=-1, use_all_factor_levels=True, ignored_columns=None,
    )
    PORTED = frozenset(DEFAULTS)

    def _fit(self, frame: Frame, x: Sequence[str], y: Optional[str],
             validation_frame: Optional[Frame] = None) -> Model:
        p = self.params
        transform = str(p["transform"]).lower()
        di = build_datainfo(
            frame, x, standardize=(transform == "standardize"),
            use_all_factor_levels=bool(p["use_all_factor_levels"]))
        k = min(int(p["nv"]), di.P)
        # X'X's eigenvectors are the right singular vectors; σ = √λ
        evals, evecs = eig_desc(weighted_gram(di.X, frame.valid_weights())[0])
        evals = np.maximum(fetch(evals), 0.0)
        V = evecs[:, :k]
        d = np.sqrt(evals[:k])
        output = {"category": ModelCategory.DIMREDUCTION, "response": None,
                  "names": list(x), "domain": None,
                  "d": d.tolist(), "v": fetch(V).tolist(),
                  "coef_names": di.coef_names}
        model = SVDModel(p, output, V, stats_of(di), list(x), transform,
                         bool(p["use_all_factor_levels"]))
        model.training_metrics = ModelMetrics("SVD", frame.nrows, 0.0)
        return model
