// Kernel #4 (scann_loop_backward.cu) for wide neighbour lists (N >
// kMaxChunkRows) in the bf16 operand mode, in all three schedules: the same
// source, built as its own library at the first bf16 wide launch, so that
// nvcc compiles it in parallel with the other builds; the wide f32 build's
// plan of 64-row sub-chunks without the resident buffer
// (scann_loop_backward_wide.cu), with one TF32 pass a product. Entry points:
// scann_loop_backward_wide_bf16_launch,
// scann_loop_backward_wide_bf16_error_string and
// scann_loop_backward_wide_bf16_max_clusters, with the narrow entry points'
// arguments.

#define SCANN_LOOP_BACKWARD_WIDE
#define SCANN_LOOP_BACKWARD_BF16
#include "scann_loop_backward.cu"
