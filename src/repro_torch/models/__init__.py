"""Dense-family models of the PyTorch port."""
