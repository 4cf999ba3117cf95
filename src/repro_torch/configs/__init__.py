"""Architecture configs of the models the PyTorch port serves (own copies)."""
