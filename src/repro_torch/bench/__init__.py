"""Runners of the port's workloads (counterparts of ``benchmarks/``, kept
inside the package so that it imports nothing from outside it)."""
