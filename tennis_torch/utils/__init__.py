"""Checkpoint and experiment-directory conventions of the port."""
