"""Chain-sharded runtime on ``torch.distributed``: mesh, chain blocks,
collectives, the model axis and multi-process initialisation."""

from mjhmc_tpu_torch.parallel.mesh import chain_sharding, make_chain_mesh, shard_chain_pytree

__all__ = ["make_chain_mesh", "shard_chain_pytree", "chain_sharding"]
