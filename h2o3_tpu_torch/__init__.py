"""h2o3_tpu_torch — the PyTorch/CUDA port of h2o3_tpu, on one NVIDIA H100.

The JAX package ``h2o3_tpu`` is the reference; this package mirrors its
module names (``frame/``, ``ops/``, ``models/``) and never imports it or
JAX. Its TPU kernels are hand-written CUDA kernels under
``ops/kernels/csrc``, each with a plain PyTorch version beside it.

    import h2o3_tpu_torch as h2o
    fr = h2o.import_file("airlines.csv")                     # on the card
    fr = h2o.Frame.from_numpy({...}, domains={...})        # or from numpy
    m = h2o.GBMEstimator(ntrees=10, max_depth=6).train(fr, y="label")
    preds = m.predict(fr)
    rf = h2o.DRFEstimator(ntrees=10, max_depth=10).train(fr, y="label")
    up = h2o.UpliftDRFEstimator(treatment_column="treatment").train(
        fr, y="visit")

Entry points default to ``torch.device("cuda")`` and raise when no card
is present; pass ``device="cpu"`` to run the plain versions on the CPU.
"""

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.io.parser import import_file
from h2o3_tpu_torch.models.drf import DRFEstimator
from h2o3_tpu_torch.models.gbm import GBMEstimator
from h2o3_tpu_torch.models.uplift import UpliftDRFEstimator

__all__ = ["Frame", "import_file", "DRFEstimator", "GBMEstimator",
           "UpliftDRFEstimator"]
