"""Host-side planning pieces of the port (cost model)."""
