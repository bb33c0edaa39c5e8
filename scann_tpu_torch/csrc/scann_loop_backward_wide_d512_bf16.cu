// Kernel #4's wide build for widths past 256 (D, G, O up to 512), the bf16
// operand mode, built as its own library so that nvcc compiles it in parallel
// with the f32 one, in all three schedules: the build past 128 columns
// (scann_loop_backward_wide_d256_bf16.cu) with 16 values of a row a lane in
// the warp LayerNorms (SCANN_WIDTH_512), 16 < N <= 256, one atom at a time in
// sub-chunks of 16 rows with the largest atom block that fits (8 at D = 384; 2
// at D = 512, 1 at its widest lists). Built at the first training launch of a
// model that wide. Entry points: scann_loop_backward_wide_d512_bf16_launch,
// _error_string and _max_clusters, with the narrow entry points' arguments.

#define SCANN_WIDTH_256
#define SCANN_WIDTH_512
#define SCANN_LOOP_BACKWARD_WIDE
#define SCANN_LOOP_BACKWARD_BF16
#include "scann_loop_backward.cu"
