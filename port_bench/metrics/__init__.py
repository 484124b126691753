"""Readers of the per-layer metrics, one metric a file."""
