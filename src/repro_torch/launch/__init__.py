"""Launch helpers of the port: the named meshes a run is laid over
(``mesh``)."""
