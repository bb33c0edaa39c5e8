// Kernel #1 (scann_forward.cu) for widths past 128 (D, G, O up to 256), in
// both operand modes: the same source with 8 values of a row a lane in the
// warp LayerNorms (SCANN_WIDTH_256, kLaneValues of scann_common.cuh), built
// as its own library at the first launch of a wider model, so the build of
// widths up to 128 is the one it always was. Entry points:
// scann_forward_d256_launch and scann_forward_d256_error_string, with the
// narrow entry points' arguments.

#define SCANN_WIDTH_256
#include "scann_forward.cu"
