"""Fused block kernels and attention for the PyTorch port."""
