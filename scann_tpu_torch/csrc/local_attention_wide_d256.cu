// Kernel #5's wide build (local_attention_wide.cu, N > 64) for widths past
// 128 (D up to 256): 8 values of a row a lane in the warp LayerNorms
// (SCANN_WIDTH_256), the context one thread a column. Built at the first wide
// launch of a wider model. Entry points: local_attention_wide_d256_launch and
// local_attention_wide_d256_bf16_launch (with their error strings), with the
// narrow entry points' arguments.

#define SCANN_WIDTH_256
#define SCANN_LOCAL_ATTENTION_WIDE
#include "local_attention.cu"
