// Kernel #3's tall build (scann_loop_tall.cu) for widths past 256 (D, G, O
// up to 512), in both operand modes: the build past 128 columns
// (scann_loop_tall_d256.cu) with 16 values of a row a lane in the warp
// LayerNorms (SCANN_WIDTH_512), N <= 16 (kTallMaxN: two chunk buffers of
// more rows do not fit at D = 512; the wide build takes the rest), chunks of
// 16 rows. Built at the first tall launch of a model that wide. Entry
// points: scann_loop_forward_tall_d512_launch, _error_string and
// _max_clusters, with the narrow entry points' arguments.

#define SCANN_WIDTH_256
#define SCANN_WIDTH_512
#define SCANN_LOOP_TALL
#include "scann_loop.cu"
