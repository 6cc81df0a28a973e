"""HDF5 input and output in the reference schema."""
