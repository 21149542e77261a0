"""Multi-device training on torch.distributed: the (segment, tile) mesh
and its steps (`mesh`), the collectives (`comm`), the Gaussian-row-sharded
step (`gauss_shard`), and rank functions that run pieces of them for a
check (`checks`)."""
