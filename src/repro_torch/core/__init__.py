"""Step factories of the serving path."""
