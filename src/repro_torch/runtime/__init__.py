"""Host-facing runtime layers of the port: the scenario engine, the
fleet rollout and the LM serving loop.  Import the submodules directly."""
