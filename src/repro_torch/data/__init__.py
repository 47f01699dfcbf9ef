"""Synthetic training data for the port (numpy only)."""

from .pipeline import DataLoader, SyntheticTextDataset, make_batch_specs

__all__ = ["SyntheticTextDataset", "DataLoader", "make_batch_specs"]
