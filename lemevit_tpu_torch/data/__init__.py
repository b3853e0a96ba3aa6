"""Synthetic data, normalisation and batching for evaluation."""
