"""Device ops of the port: the two CUDA kernels (gather_rows, binned_sgd) and
the plain tensor ops around them."""
