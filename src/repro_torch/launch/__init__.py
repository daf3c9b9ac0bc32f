"""Launchers: the serving and training entry points, the decode and
fleet profilers, and the roofline analysis (H100 constants)."""
