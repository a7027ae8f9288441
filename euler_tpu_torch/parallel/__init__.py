"""Several scenario instances on one card (`batch`), the slot store's
spatial form and row blocks (`spatial`), and ranks on
`torch.distributed`: the data axis (`mesh`), K1 per row shard and K2
per data rank (`cuda_shard`), and spawned ranks with the dry run
(`dryrun`)."""
