// Kernel #5 (local_attention.cu) for widths past 128 (D up to 256), N <= 64:
// 8 values of a row a lane in the warp LayerNorms (SCANN_WIDTH_256), atom
// blocks down to 8. Built at the first launch of a wider model, so the build
// of widths up to 128 is the one it always was. Entry points:
// local_attention_d256_launch and local_attention_d256_bf16_launch (with
// their error strings), with the narrow entry points' arguments.

#define SCANN_WIDTH_256
#include "local_attention.cu"
