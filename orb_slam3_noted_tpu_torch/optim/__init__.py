"""Optimisation backend: robust kernels, reprojection factors, pose opt."""
