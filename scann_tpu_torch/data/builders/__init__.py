"""Dataset builders (port of ``scann_tpu/data/builders``): download and
parse the six reference datasets into the on-disk ``.npy`` schema, plus an
offline synthetic builder. Nothing is downloaded on import.

The registry mirrors the reference dispatch table (``preprocess_data.py:11-18``).
"""

from scann_tpu_torch.data.builders.mp2018 import process_mp2018
from scann_tpu_torch.data.builders.qm9 import process_qm9
from scann_tpu_torch.data.builders.qm9_std_jctc import process_qm9_std_jctc
from scann_tpu_torch.data.builders.synthetic_builder import process_synthetic
from scann_tpu_torch.data.builders.trajectories import (
    process_fullerene,
    process_ptgp,
    process_smfe,
)

BUILDERS = {
    "qm9": process_qm9,
    "qm9_std_jctc": process_qm9_std_jctc,
    "mp2018": process_mp2018,
    "fullerene": process_fullerene,
    "ptgp": process_ptgp,
    "smfe": process_smfe,
    "synthetic": process_synthetic,
}

__all__ = ["BUILDERS"] + [f.__name__ for f in BUILDERS.values()]
