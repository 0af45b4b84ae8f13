"""Partitioning of the SNN tick fabric over a world of ranks (DESIGN.md §15)."""
