// Kernel #4 (scann_loop_backward.cu) in the bf16 operand mode: the same
// source, built as its own library so that nvcc compiles its instantiation
// in parallel with the f32 one, the longest build of the port. Entry points:
// scann_loop_backward_bf16_launch, scann_loop_backward_bf16_error_string and
// scann_loop_backward_bf16_max_clusters, with scann_loop_backward_launch's
// arguments.

#define SCANN_LOOP_BACKWARD_BF16
#include "scann_loop_backward.cu"
