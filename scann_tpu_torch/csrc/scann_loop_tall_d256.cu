// Kernel #3's tall build (scann_loop_tall.cu) for widths past 128 (D, G, O up
// to 256), in both operand modes: 8 values of a row a lane in the warp
// LayerNorms (SCANN_WIDTH_256), N <= 32 (kTallMaxN: two chunk buffers of
// more rows do not fit at D = 256; the wide build takes the rest). Built at
// the first tall launch of a wider model. Entry points:
// scann_loop_forward_tall_d256_launch, _error_string and _max_clusters, with
// the narrow entry points' arguments.

#define SCANN_WIDTH_256
#define SCANN_LOOP_TALL
#include "scann_loop.cu"
