"""Evaluation metrics and checkpoint loading."""
