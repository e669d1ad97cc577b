"""Compute ops for the LBM framework (pure JAX, jit-friendly)."""
