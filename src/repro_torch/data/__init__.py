"""Synthetic training data for the port (numpy only)."""

from .pipeline import DataLoader, SyntheticTextDataset

__all__ = ["SyntheticTextDataset", "DataLoader"]
