"""Launchers (the port of ``repro.launch``): the train and serve entry points."""
