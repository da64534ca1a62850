"""User-facing solvers and the trained model object."""
