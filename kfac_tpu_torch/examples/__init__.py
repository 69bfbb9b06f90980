"""Training scripts of the port (counterparts of ``examples/``)."""
