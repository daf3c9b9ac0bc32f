"""Launchers: the single-engine serving entry point."""
