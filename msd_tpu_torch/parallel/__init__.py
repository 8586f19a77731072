"""Parallelism of the port over ``torch.distributed``: the (data, model)
mesh and its collectives (``comm``), megatron parameter sharding
(``sharding``), the GPipe pipeline (``pipeline``) and sequence-parallel
prefills (``sequence``)."""
