"""File ingest of the PyTorch port: CSV (eager and streamed)."""
