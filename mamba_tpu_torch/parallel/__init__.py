"""Chain sharding over several devices (SURVEY.md §2.7).

The reference's only parallelism is chains over OS processes via pmap
(src/utils.jl:91-98).  Here each rank of a ``torch.distributed`` process
group runs the engine on its share of the chains, named by a
``DeviceMesh`` axis ``chains``; on an optional data axis each rank holds
and evaluates only its slice of the inputs and sites that ``site_specs``
shards, and the samplers sum the density's parts over the data group (the
sequence-parallel analog)."""

from .mesh import (chain_sharding, distributed_init, global_mesh,
                   make_mesh, shard_chain_tree)

__all__ = ["make_mesh", "chain_sharding", "shard_chain_tree",
           "distributed_init", "global_mesh"]
