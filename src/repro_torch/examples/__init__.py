"""Examples of the port: the counterparts of the repository's ``examples/``."""
