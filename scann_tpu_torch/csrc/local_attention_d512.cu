// Kernel #5 (local_attention.cu) for widths past 256 (D up to 512), N <= 16:
// the narrow build past 128 columns (local_attention_d256.cu, d256_block)
// with 16 values of a row a lane in the warp LayerNorms (SCANN_WIDTH_512),
// chunks of 16 rows and atom blocks down to 4. Built at the first launch of
// a model that wide. Entry points: local_attention_d512_launch and
// local_attention_d512_bf16_launch (with their error strings), with the
// d256 entry points' arguments.

#define SCANN_WIDTH_256
#define SCANN_WIDTH_512
#include "local_attention.cu"
