"""Formal solvers: weights, the two sweep kernels and the regular sweep."""
