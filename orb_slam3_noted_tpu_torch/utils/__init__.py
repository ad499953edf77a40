"""Utilities: synthetic scenes, timing, numpy interchange."""
