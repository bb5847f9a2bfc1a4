"""The reference imports its metrics as ``from emage_evaltools.mertic import FGD, BC,
L1div, LVDFace, MSEFace`` (module name misspelt); scripts written against it can import
``pantomatrix_tpu_torch.eval.mertic`` unchanged."""
from .metrics import BC, FGD, L1div, LVDFace, MSEFace  # noqa: F401

__all__ = ["BC", "FGD", "L1div", "LVDFace", "MSEFace"]
