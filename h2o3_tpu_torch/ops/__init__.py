"""Tree ops of the PyTorch port: plain torch versions and CUDA kernels."""
