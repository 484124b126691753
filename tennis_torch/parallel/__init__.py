"""Training steps of the port and its ``(data, model)`` world: one process
per GPU, joined by ``torch.distributed``; the tensor-parallel sharding
rules."""
