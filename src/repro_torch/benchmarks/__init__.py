"""Benchmarks of the port, runnable with ``python -m``."""
