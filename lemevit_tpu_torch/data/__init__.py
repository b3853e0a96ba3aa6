"""Synthetic data, normalisation, batch augmentation and loaders."""
