"""Several scenario instances on one card: a stacked batch (`batch`) and
the spatial form of the slot store (`spatial`)."""
