"""Checkpoints of the port: ``store``, the JAX package's manifest v2 (each
package restores the other's checkpoints)."""
