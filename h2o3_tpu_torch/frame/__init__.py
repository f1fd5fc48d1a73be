"""Frames, columns and binning of the PyTorch port."""
