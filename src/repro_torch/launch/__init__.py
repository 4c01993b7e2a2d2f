"""Launchers of the model zoo (port of ``repro.launch``): serving only."""
