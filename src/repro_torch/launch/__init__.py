"""Launchers of the model zoo (port of ``repro.launch``): serving
(:mod:`.serve`) and training (:mod:`.train`)."""
