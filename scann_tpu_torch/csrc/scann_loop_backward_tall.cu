// Kernel #4 (scann_loop_backward.cu) for tall structures (N <= kMaxChunkRows,
// M past the narrow build's shared-memory plan), f32 operands (its bf16 build
// is scann_loop_backward_tall_bf16.cu), in all three
// schedules: the same source, built as its own library at the first tall
// launch, so the narrow builds are the ones they always were. The resident
// [M, max(D, G)] buffer's three roles move to global memory (L2), and the
// shared memory it leaves holds chunks of up to 64 rows (kTallChunkRows,
// atom blocks of 16 at D = 128) and the build's own gather, scatter,
// softmax passes and small weight gradients (under kTall); the note in
// scann_loop_backward.cu says what bounds the build and what the design
// does about it. Entry
// points: scann_loop_backward_tall_launch,
// scann_loop_backward_tall_error_string and
// scann_loop_backward_tall_max_clusters, with the narrow entry points'
// arguments.

#define SCANN_LOOP_BACKWARD_TALL
#include "scann_loop_backward.cu"
