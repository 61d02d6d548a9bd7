"""Data parallelism over ranks (one process per card)."""
