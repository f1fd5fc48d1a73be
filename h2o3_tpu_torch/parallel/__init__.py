"""Device layer of the PyTorch port (single device; no mesh)."""
