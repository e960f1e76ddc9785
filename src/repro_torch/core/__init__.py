"""The paper's planner in PyTorch: channel and cost models, the batched
P1/P2/P3 primitives (``batch``), the planning tick and fleet rollout
(``rollout``), and the scalar planner (``power``, ``positions``,
``placement``, ``planner``).  Import the submodules directly."""
