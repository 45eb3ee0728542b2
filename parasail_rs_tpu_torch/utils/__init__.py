"""Small shared utilities."""

from .shapes import pad_to, round_up

__all__ = ["pad_to", "round_up"]
