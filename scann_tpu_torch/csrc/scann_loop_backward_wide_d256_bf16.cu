// Kernel #4's wide build for widths past 128 (scann_loop_backward_wide_d256.cu)
// in the bf16 operand mode, in all three schedules: the same source and
// design (its reductions and blocks a structure), built as its own library
// at the first bf16 training launch of a wider model, so that nvcc compiles
// it in parallel with the f32 one. Entry points:
// scann_loop_backward_wide_d256_bf16_launch, _error_string and
// _max_clusters, with the narrow entry points' arguments.

#define SCANN_WIDTH_256
#define SCANN_LOOP_BACKWARD_WIDE
#define SCANN_LOOP_BACKWARD_BF16
#include "scann_loop_backward.cu"
