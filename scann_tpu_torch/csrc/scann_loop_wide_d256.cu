// Kernel #3's wide build (scann_loop_wide.cu) for widths past 128 (D, G, O up
// to 256), in both operand modes: 8 values of a row a lane in the warp
// LayerNorms (SCANN_WIDTH_256), 32 < N <= 256 (kTallMaxN), the context one
// thread a column. Built at the first wide launch of a wider model. Entry
// points: scann_loop_forward_wide_d256_launch, _error_string and
// _max_clusters, with the narrow entry points' arguments.

#define SCANN_WIDTH_256
#define SCANN_LOOP_WIDE
#include "scann_loop.cu"
