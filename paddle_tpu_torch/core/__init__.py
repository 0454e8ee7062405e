"""Core IR machinery of the PyTorch port: dtypes, the op registry and
the block interpreter."""
