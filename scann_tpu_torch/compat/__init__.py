from scann_tpu_torch.compat.from_jax import params_from_jax, params_to_flax  # noqa: F401
from scann_tpu_torch.compat.h5_loader import (  # noqa: F401
    load_h5_optimizer,
    load_h5_params,
    save_h5_weights,
)
