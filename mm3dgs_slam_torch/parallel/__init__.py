"""The sharded map over `torch.distributed` ranks (JAX counterpart: parallel/)."""
