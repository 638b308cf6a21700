"""Carrying the JAX package's weights and calibrations into the port."""
