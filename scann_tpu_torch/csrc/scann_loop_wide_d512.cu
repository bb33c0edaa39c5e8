// Kernel #3's wide build (scann_loop_wide.cu) for widths past 256 (D, G, O
// up to 512), in both operand modes: the build past 128 columns
// (scann_loop_wide_d256.cu) with 16 values of a row a lane in the warp
// LayerNorms (SCANN_WIDTH_512), 16 < N <= 256 (kTallMaxN), each atom in
// sub-chunks of 16 rows (kFwdWideW32Rows) in two operand buffers, the
// context a thread's two columns. Built at the first wide launch of a model
// that wide. Entry points: scann_loop_forward_wide_d512_launch,
// _error_string and _max_clusters, with the narrow entry points' arguments.

#define SCANN_WIDTH_256
#define SCANN_WIDTH_512
#define SCANN_LOOP_WIDE
#include "scann_loop.cu"
