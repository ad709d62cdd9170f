"""Traffic generators, one module per kind; mixes are the JSON files beside them."""
