"""The port's benchmark: served retrieval through repro_torch, cell by cell."""
