"""Analytical model + selector (copied from the JAX package; numpy only)."""
