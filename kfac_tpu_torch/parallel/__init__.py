"""Process topology of the PyTorch port (one process, so far)."""
