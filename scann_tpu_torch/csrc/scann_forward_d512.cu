// Kernel #1 (scann_forward.cu) for widths past 256 (D, G, O up to 512), in
// both operand modes: the build past 128 columns (scann_forward_d256.cu:
// its TF32 planes and its cluster of blocks a molecule) with 16 values of a
// row a lane in the warp LayerNorms (SCANN_WIDTH_512), chunks of 16 rows,
// and the query and scratch rows of each molecule in global memory (launch
// pointer 51), so that only the centers stay resident in shared memory
// (scann_forward.cu says why). Built at the first launch of a model that
// wide. Entry points: scann_forward_d512_launch, _error_string and
// _max_clusters, with the d256 entry points' arguments and pointer 51.

#define SCANN_WIDTH_256
#define SCANN_WIDTH_512
#include "scann_forward.cu"
