"""Models of the PyTorch port: GBM on the shared tree machinery."""
