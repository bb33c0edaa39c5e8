// Kernel #4's tall build (scann_loop_backward_tall.cu) for widths past 128
// (D, G, O up to 256), f32 operands (its bf16 build is
// scann_loop_backward_tall_d256_bf16.cu), in all three schedules: 8 values
// of a row a lane in the warp LayerNorms (SCANN_WIDTH_256), N <= 32, chunks
// of the wrapper's plan (32 rows with atom blocks of 8 at D = 256), every
// add into a gradient row or a partial a reduction the warp does not wait
// for, up to 8 blocks a structure (scann_loop_backward.cu says why: at
// MP2018 (64, 96, 32) the adds into the gradient rows cost a quarter of the
// time on an NVIDIA H100 80GB HBM3 at 700 W). Built at the first training
// launch of a wider model. Entry points: scann_loop_backward_tall_d256_launch,
// _error_string and _max_clusters, with the narrow entry points' arguments.

#define SCANN_WIDTH_256
#define SCANN_LOOP_BACKWARD_TALL
#include "scann_loop_backward.cu"
