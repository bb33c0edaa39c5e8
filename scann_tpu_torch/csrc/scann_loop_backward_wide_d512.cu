// Kernel #4's wide build for widths past 256 (D, G, O up to 512), f32 operands
// (its bf16 build is scann_loop_backward_wide_d512_bf16.cu), in all three
// schedules: the build past 128 columns (scann_loop_backward_wide_d256.cu)
// with 16 values of a row a lane in the warp LayerNorms (SCANN_WIDTH_512), 16
// < N <= 256, one atom at a time in sub-chunks of 16 rows with the largest
// atom block that fits (8 at D = 384; 2 at D = 512, 1 at its widest lists).
// Built at the first training launch of a model that wide. Entry points:
// scann_loop_backward_wide_d512_launch, _error_string and _max_clusters, with
// the narrow entry points' arguments.

#define SCANN_WIDTH_256
#define SCANN_WIDTH_512
#define SCANN_LOOP_BACKWARD_WIDE
#include "scann_loop_backward.cu"
