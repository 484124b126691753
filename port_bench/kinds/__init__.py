"""Drivers of the entry points of the program, one kind a file."""
