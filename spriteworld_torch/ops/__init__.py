"""Tensor ops: shape tables, geometry, resampling, rasterization."""
