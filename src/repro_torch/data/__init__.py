"""Data path of the port: the synthetic corpus and the bucketed loader."""
