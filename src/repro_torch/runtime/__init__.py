"""Host-facing runtime layers of the port: the scenario engine and the
fleet rollout.  Import the submodules directly."""
