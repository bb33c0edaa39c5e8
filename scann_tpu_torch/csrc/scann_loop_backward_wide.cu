// Kernel #4 (scann_loop_backward.cu) for wide neighbour lists (N >
// kMaxChunkRows), f32 operands (its bf16 build is
// scann_loop_backward_wide_bf16.cu), in all three schedules: the same source,
// built as its own library at the first wide launch, so the narrow builds are
// the ones they always were. Entry points: scann_loop_backward_wide_launch,
// scann_loop_backward_wide_error_string and
// scann_loop_backward_wide_max_clusters, with the narrow entry points'
// arguments.

#define SCANN_LOOP_BACKWARD_WIDE
#include "scann_loop_backward.cu"
