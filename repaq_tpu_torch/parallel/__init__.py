"""Multi-GPU data parallelism over chunks (``--mesh_devices``)."""
