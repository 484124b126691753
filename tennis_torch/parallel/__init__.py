"""Training steps of the port and its data-parallel world: one process
per GPU, joined by ``torch.distributed``."""
