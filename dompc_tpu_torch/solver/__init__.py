"""Solvers (PyTorch port): the interior-point NLP solver, the bordered
block-diagonal KKT factorization and the CUDA band-QR chain sweeps."""
