"""Runtime of the port: fault-tolerant training loop."""
