"""Several scenario instances on one card (`batch`), the slot store's
spatial form and the frame on row blocks (`spatial`), and ranks on
`torch.distributed`: the data axis (`mesh`), K1 per row shard and K2
per data rank (`cuda_shard`), the sharded solve (`halo`), the frame's
global MG solve on blocks (`spatial_mg`), the collectives of blocks,
ranks or threads of one process (`comm`), and spawned ranks with the
dry run (`dryrun`)."""
