"""Device meshes and what runs over them: the fleet rollout's trajectory
mesh, named meshes with the reference's logical sharding rules, the
shard runner and its collectives (``sharding``), the parameter and cache
sharding rules (``param_sharding``) and the LLHR-planned pipelined
forward (``pipeline``)."""
