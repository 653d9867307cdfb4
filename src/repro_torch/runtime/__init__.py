"""repro_torch.runtime — partitioning rules and placements, train/serve steps
on one device or a device mesh, and the fault-tolerant training loop."""
