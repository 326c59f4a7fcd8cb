"""Training engine of the PyTorch port: the single-pair train step and the
optimizer."""
