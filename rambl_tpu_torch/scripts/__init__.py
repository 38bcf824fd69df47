"""Bench scripts of the port (counterparts of the JAX package's scripts/)."""
