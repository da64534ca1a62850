"""Data paths: synthetic workloads, id compaction and DSGD blocking, on the
host (numpy) and on the solver's device (``device_blocking``, torch)."""
