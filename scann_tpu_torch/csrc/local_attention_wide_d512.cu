// Kernel #5's wide build for widths past 256 (D up to 512), N > 16: the wide
// build past 128 columns (local_attention_wide_d256.cu, wide_d256_block)
// with 16 values of a row a lane in the warp LayerNorms (SCANN_WIDTH_512),
// each atom in sub-chunks of 16 rows in two operand buffers, the keys in L2
// and the context a thread's two columns over all N. Built at the first
// wide launch of a model that wide. Entry points:
// local_attention_wide_d512_launch and local_attention_wide_d512_bf16_launch
// (with their error strings), with the d256 entry points' arguments.

#define SCANN_WIDTH_256
#define SCANN_WIDTH_512
#define SCANN_LOCAL_ATTENTION_WIDE
#include "local_attention.cu"
