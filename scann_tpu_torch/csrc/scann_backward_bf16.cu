// Kernel #2 (scann_backward.cu) in the bf16 operand mode: the same source,
// built as its own library so that nvcc compiles its instantiation in
// parallel with the f32 one. Entry points: scann_backward_bf16_launch and
// scann_backward_bf16_error_string, with scann_backward_launch's arguments.

#define SCANN_BACKWARD_BF16
#include "scann_backward.cu"
