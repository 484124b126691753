"""Training steps of the port."""
