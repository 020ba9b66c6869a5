"""Grid (Stam stable-fluids) solver of the PyTorch port."""
