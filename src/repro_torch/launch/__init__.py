"""Launch drivers (PyTorch port)."""
