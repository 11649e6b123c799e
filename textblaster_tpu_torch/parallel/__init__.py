"""Parallelism of the port: a ``data`` mesh of devices in one process
(:mod:`.mesh`), and a gang of processes, each running its own row stripe,
joined over ``torch.distributed`` (:mod:`.multihost`).  Still to port: the
negotiated per-phase rounds (``run_local_shard``), then membership,
elastic stripes and autoscale (``parallel/autoscale.py``)."""
