// Kernel #4 (scann_loop_backward.cu) for wide neighbour lists (N >
// kMaxChunkRows), f32 operands (its bf16 build is
// scann_loop_backward_wide_bf16.cu), in all three schedules: the same source,
// built as its own library at the first wide launch, so the narrow builds are
// the ones they always were. One atom at a time in sub-chunks of 64 rows
// (kWideChunkRows) in the shared memory that the resident [M, max(D, G)]
// buffer left: its three roles take the tall build's global homes (L2), the
// block's rows of one atom follow them in the same scratch, and the reverse
// walk forms each row once in every schedule; the note in
// scann_loop_backward.cu says what bounds the build and what the design does
// about it. Entry points: scann_loop_backward_wide_launch,
// scann_loop_backward_wide_error_string and
// scann_loop_backward_wide_max_clusters, with the narrow entry points'
// arguments.

#define SCANN_LOOP_BACKWARD_WIDE
#include "scann_loop_backward.cu"
