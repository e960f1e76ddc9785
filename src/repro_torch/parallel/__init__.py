"""Device meshes of the port: the fleet rollout's trajectory axis
(``sharding``).  The model-sharding helpers come with the training slice."""
