"""Parallelism of the port: a ``data`` mesh of devices in one process
(:mod:`.mesh`)."""
