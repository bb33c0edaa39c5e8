from scann_tpu_torch.ops.activations import mrelu, swish  # noqa: F401
from scann_tpu_torch.ops.rbf import gaussian_expansion, make_centers  # noqa: F401
from scann_tpu_torch.ops.attention import (  # noqa: F401
    gather_neighbor_states,
    global_attention_core,
    local_attention_core,
)
