// Kernel #3 (scann_loop.cu) for tall structures (N <= kFwdMaxChunkRows, M past
// the narrow build's shared-memory plan), in both operand modes: the same
// source, built as its own library at the first tall launch, so the narrow
// build is the one it always was. The centers live in global memory (L2), not
// in shared memory.
// Entry points: scann_loop_forward_tall_launch,
// scann_loop_forward_tall_error_string and
// scann_loop_forward_tall_max_clusters, with the narrow entry points'
// arguments.

#define SCANN_LOOP_TALL
#include "scann_loop.cu"
