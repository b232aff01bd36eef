"""Planner, executor and solver of the port (counterparts of repro.core)."""
