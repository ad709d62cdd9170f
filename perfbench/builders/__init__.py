"""Arena builders, one module per kind, found by the name a workload gives."""
