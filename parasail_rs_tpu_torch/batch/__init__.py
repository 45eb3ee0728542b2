"""Batch scheduling: length-binned dispatch for dense device tiles."""

from .scheduler import Bin, merge_bins, plan_bins

__all__ = ["Bin", "merge_bins", "plan_bins"]
