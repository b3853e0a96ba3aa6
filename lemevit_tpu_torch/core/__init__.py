"""Layers shared by the model and its blocks."""
