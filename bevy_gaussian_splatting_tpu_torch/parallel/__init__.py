"""Multi-rank rendering and training on ``torch.distributed``: the bounded
band exchange (``exchange.py``), sharded rendering and training over a
mesh of process groups (``render.py``), initialization, the host-aware
mesh, spawned worlds and the multi-host dry run (``distributed.py``), and
the scaling models and the measured work ratio (``scaling.py``).  NCCL
where each rank has its own card, gloo on the CPU and where ranks share a
card; the backend is always the caller's choice."""
