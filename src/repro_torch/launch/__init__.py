"""Launch helpers of the port: the named meshes a run is laid over
(``mesh``), the op-level profiler (``op_analysis``), the roofline on the
H100 SXM's constants and each kernel's work (``roofline``), and the
meta-device dry run of every (arch x shape x mesh) cell (``specs``,
``dryrun``)."""
