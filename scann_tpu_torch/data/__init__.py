"""Host-side data handling for the PyTorch port: element tables, the
structure type and parsers, and Voronoi featurization (numpy and scipy
only)."""
