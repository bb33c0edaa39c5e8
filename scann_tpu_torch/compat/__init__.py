from scann_tpu_torch.compat.from_jax import params_from_jax  # noqa: F401
from scann_tpu_torch.compat.h5_loader import load_h5_params  # noqa: F401
