// Kernel #4's wide build (scann_loop_backward_wide.cu) for widths past 128
// (D, G, O up to 256), f32 operands (its bf16 build is
// scann_loop_backward_wide_d256_bf16.cu), in all three schedules: 8 values
// of a row a lane in the warp LayerNorms (SCANN_WIDTH_256), 32 < N <= 256,
// one atom at a time in sub-chunks of kWideChunkRows = 32 rows (atom blocks
// of 4 at D = 256). Built at the first training launch of a wider model.
// Entry points: scann_loop_backward_wide_d256_launch, _error_string and
// _max_clusters, with the narrow entry points' arguments.

#define SCANN_WIDTH_256
#define SCANN_LOOP_BACKWARD_WIDE
#include "scann_loop_backward.cu"
