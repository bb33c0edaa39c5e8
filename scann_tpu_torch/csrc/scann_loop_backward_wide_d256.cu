// Kernel #4's wide build (scann_loop_backward_wide.cu) for widths past 128
// (D, G, O up to 256), f32 operands (its bf16 build is
// scann_loop_backward_wide_d256_bf16.cu), in all three schedules: 8 values
// of a row a lane in the warp LayerNorms (SCANN_WIDTH_256), 32 < N <= 256,
// one atom at a time in sub-chunks of 64 rows where that plan fits (D =
// 136), else 32 (atom blocks of 4 at (80, 96) and D = 256), every add into
// a gradient row or a partial a reduction the warp does not wait for, up
// to 8 blocks a structure (6 at a batch of 16, where 4 left half the card
// idle; scann_loop_backward.cu says why). Built at the first training
// launch of a wider model. Entry points:
// scann_loop_backward_wide_d256_launch, _error_string and _max_clusters,
// with the narrow entry points' arguments.

#define SCANN_WIDTH_256
#define SCANN_LOOP_BACKWARD_WIDE
#include "scann_loop_backward.cu"
