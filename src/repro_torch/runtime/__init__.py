"""Host-facing runtime layers of the port: the scenario engine, the
fleet rollout, the serving loop (the LM batcher, the periodic replanner
and its SLO ladder), the chaos harness, fault tolerance and the
streaming gateway.  Import the submodules directly."""
