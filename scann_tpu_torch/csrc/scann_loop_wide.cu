// Kernel #3 (scann_loop.cu) for wide neighbour lists (N > kFwdMaxChunkRows),
// in both operand modes: the same source, built as its own library at the first wide launch, so the
// narrow build is the one it always was. Entry points:
// scann_loop_forward_wide_launch, scann_loop_forward_wide_error_string and
// scann_loop_forward_wide_max_clusters, with the narrow entry points'
// arguments.

#define SCANN_LOOP_WIDE
#include "scann_loop.cu"
