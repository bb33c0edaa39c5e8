"""Offline synthetic dataset builder (no downloads) for the preprocess CLI
(port of ``scann_tpu/data/builders/synthetic_builder.py``)."""

import os

from scann_tpu_torch.data.synthetic import make_synthetic_dataset


def process_synthetic(save_path: str = "", n_structures: int = 512):
    """Write ``synthetic/synthetic_data_energy.npy`` under ``save_path``:
    the JAX builder's molecules, record for record. The neighbour file that
    ``make_synthetic_dataset`` also writes is at the default cutoffs; the
    CLI featurizes again at the cutoffs it is given."""
    energy, _ = make_synthetic_dataset(os.path.join(save_path, "synthetic"), name="synthetic",
                                       n_structures=n_structures, seed=0, with_ring=True)
    return energy
