// Kernel #4's tall build (scann_loop_backward_tall.cu) for widths past 128
// (D, G, O up to 256), f32 operands (its bf16 build is
// scann_loop_backward_tall_d256_bf16.cu), in all three schedules: 8 values
// of a row a lane in the warp LayerNorms (SCANN_WIDTH_256), N <= 32, chunks
// of the wrapper's plan (32 rows with atom blocks of 8 at D = 256). Built at
// the first training launch of a wider model. Entry points:
// scann_loop_backward_tall_d256_launch, _error_string and _max_clusters,
// with the narrow entry points' arguments.

#define SCANN_WIDTH_256
#define SCANN_LOOP_BACKWARD_TALL
#include "scann_loop_backward.cu"
