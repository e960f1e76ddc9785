"""The paper's planner in PyTorch: channel and cost models, the batched
P1/P2/P3 primitives (``batch``) and the planning tick and fleet rollout
(``rollout``).  Import the submodules directly."""
