"""Engine-agnostic math contract: ratings batches, schedules and updaters,
factor initializers, synthetic workload generators."""
