// Kernel #4 (scann_loop_backward.cu) for tall structures (N <= kMaxChunkRows,
// M past the narrow build's shared-memory plan) in the bf16 operand mode, in
// all three schedules: the same source, built as its own library at the
// first bf16 tall launch, so that nvcc compiles it in parallel with the other
// builds. Entry points: scann_loop_backward_tall_bf16_launch,
// scann_loop_backward_tall_bf16_error_string and
// scann_loop_backward_tall_bf16_max_clusters, with the narrow entry points'
// arguments.

#define SCANN_LOOP_BACKWARD_TALL
#define SCANN_LOOP_BACKWARD_BF16
#include "scann_loop_backward.cu"
