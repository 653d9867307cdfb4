"""repro_torch.runtime — partitioning rules, train/serve steps and the
fault-tolerant training loop, on one device."""
