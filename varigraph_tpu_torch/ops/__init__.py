"""k-mer sketch, the k-mer table and the CUDA join."""
