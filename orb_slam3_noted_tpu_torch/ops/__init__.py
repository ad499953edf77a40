"""Feature frontend: pyramid, FAST, rBRIEF, matching, and the CUDA kernels."""
