// Kernel #5 (local_attention.cu) for wide neighbour lists (N >
// kFwdMaxChunkRows): the same source, built as its own library at the first
// wide launch, so the narrow build is the one it always was. Entry points:
// local_attention_wide_launch and local_attention_wide_bf16_launch (with
// their error strings), with the narrow entry points' arguments.

#define SCANN_LOCAL_ATTENTION_WIDE
#include "local_attention.cu"
