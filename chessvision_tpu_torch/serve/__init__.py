"""HTTP serving of the PyTorch port."""
