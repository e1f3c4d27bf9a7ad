"""Utilities: color maps and device resolution."""
