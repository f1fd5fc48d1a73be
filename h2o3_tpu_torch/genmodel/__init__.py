"""h2o3_tpu_torch.genmodel — offline MOJO scoring (the h2o-genmodel twin).

The port's copy of h2o3_tpu/genmodel: the MOJO format (``mojo.py``: a
zip of ``meta.json`` and ``arrays.npz``), the numpy-only readers
(``readers.py``), the typed wrapper (``easy.py``), the export of a port
model (``export.py``), the reference-layout MOJOs (``refmojo.py``) and
the POJO sources (``pojo.py``, ``pojo_java.py``). A MOJO either package
writes loads and scores in the other: the format is the same.
"""

from h2o3_tpu_torch.genmodel.easy import EasyPredictModelWrapper  # noqa: F401
from h2o3_tpu_torch.genmodel.mojo import read_mojo, write_mojo     # noqa: F401
from h2o3_tpu_torch.genmodel.readers import MojoModel              # noqa: F401


def load_mojo(path: str) -> MojoModel:
    """Load a MOJO zip for offline scoring (MojoModel.load)."""
    return MojoModel.load(path)
