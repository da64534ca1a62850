"""Host-side data path: synthetic workloads, id compaction and DSGD
blocking (numpy)."""
