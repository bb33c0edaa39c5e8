from scann_tpu_torch.models.scann import (  # noqa: F401
    ScannModel,
    init_params,
    param_shapes,
    scann_forward,
)
