"""The plain float64 reference, and frozen copies of the port's NumPy
oracle, plan, geometry, time and synthetic helpers.  Imports nothing of
the port and nothing of JAX."""
