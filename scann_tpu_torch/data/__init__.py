"""Host-side data handling for the PyTorch port: element tables, the
structure type and parsers, Voronoi featurization and the dataset packer
(numpy, scipy and the port's own C++ in ``native/``, built with g++ at
first use)."""
