// Native dataset packer: CSR ragged neighbor lists -> padded bucket tensors.
//
// The port's own copy of the JAX package's native/packer.cc (same C
// interface), built by scann_tpu_torch/data/native.py and called by
// data/pipeline.pack_bucket and structure_sizes; pack_bucket_plain and
// structure_sizes_plain there are the numpy version of the same fill.
//
// The hot host-side loop of the data pipeline (the reference does this per
// batch in Python, scann/utils/datagenerator.py:69-121; we do it once per
// dataset). For ~130k QM9 structures the Python triple loop takes minutes;
// this runs in tens of milliseconds.
//
// Layout contract (int64 offsets, int32/float32 data, C-contiguous):
//   atom_offsets  [S+1]  - prefix sum of atom counts per structure
//   nbr_offsets   [total_atoms+1] - prefix sum of neighbor counts per atom
//   nbr_index     [total_nbrs]    - neighbor atom index within the structure
//   nbr_weight    [total_nbrs]    - chosen weight column (raw or normalized)
//   nbr_dist      [total_nbrs]
//   atomic        [total_atoms]   - atomic numbers
//
// Output arrays are pre-allocated by the caller (zero-filled) with shapes
//   out_atomic [S, M], out_atom_mask [S, M], out_nbr_idx [S, M, N],
//   out_nbr_mask/weight/dist [S, M, N]
// for the S structures listed in `rows` (bucket membership).

#include <cstdint>

extern "C" {

void pack_bucket(
    const int32_t* rows, int64_t n_rows,          // structure ids in this bucket
    const int64_t* atom_offsets,
    const int64_t* nbr_offsets,
    const int32_t* atomic,
    const int32_t* nbr_index,
    const float* nbr_weight,
    const float* nbr_dist,
    int64_t M, int64_t N,
    int32_t* out_atomic,       // [n_rows, M]
    float* out_atom_mask,      // [n_rows, M]
    int32_t* out_nbr_idx,      // [n_rows, M, N]
    float* out_nbr_mask,       // [n_rows, M, N]
    float* out_nbr_weight,     // [n_rows, M, N]
    float* out_nbr_dist        // [n_rows, M, N]
) {
  for (int64_t r = 0; r < n_rows; ++r) {
    const int64_t s = rows[r];
    const int64_t a0 = atom_offsets[s];
    const int64_t a1 = atom_offsets[s + 1];
    // clamp to the bucket dims: callers guarantee fit, but never overrun
    const int64_t na = (a1 - a0) < M ? (a1 - a0) : M;
    int32_t* atom_row = out_atomic + r * M;
    float* amask_row = out_atom_mask + r * M;
    for (int64_t a = 0; a < na; ++a) {
      atom_row[a] = atomic[a0 + a];
      amask_row[a] = 1.0f;
    }
    for (int64_t a = 0; a < na; ++a) {
      const int64_t n0 = nbr_offsets[a0 + a];
      const int64_t n1 = nbr_offsets[a0 + a + 1];
      const int64_t kn = (n1 - n0) < N ? (n1 - n0) : N;
      const int64_t base = (r * M + a) * N;
      for (int64_t k = 0; k < kn; ++k) {
        out_nbr_idx[base + k] = nbr_index[n0 + k];
        out_nbr_mask[base + k] = 1.0f;
        out_nbr_weight[base + k] = nbr_weight[n0 + k];
        out_nbr_dist[base + k] = nbr_dist[n0 + k];
      }
    }
  }
}

// Structure sizes for bucket selection: per structure (n_atoms, max_nbrs).
void structure_sizes(
    const int64_t* atom_offsets, int64_t n_struct,
    const int64_t* nbr_offsets,
    int32_t* out_n_atoms,      // [n_struct]
    int32_t* out_max_nbrs      // [n_struct]
) {
  for (int64_t s = 0; s < n_struct; ++s) {
    const int64_t a0 = atom_offsets[s];
    const int64_t a1 = atom_offsets[s + 1];
    out_n_atoms[s] = static_cast<int32_t>(a1 - a0);
    int64_t mx = 0;
    for (int64_t a = a0; a < a1; ++a) {
      const int64_t c = nbr_offsets[a + 1] - nbr_offsets[a];
      if (c > mx) mx = c;
    }
    out_max_nbrs[s] = static_cast<int32_t>(mx);
  }
}

}  // extern "C"
