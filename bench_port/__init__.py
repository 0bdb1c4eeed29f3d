"""The benchmark of the PyTorch port (see run.py)."""
