"""Cloud formation of the PyTorch port (``cloud.py``)."""
