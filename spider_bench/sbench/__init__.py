"""The benchmark of repro_torch on the card: cells found by name, run once each.

``run.py`` beside this package is the command; ``harness.run_cell`` runs one
cell and returns its result line.  Configurations, traffic mixes, limits and
metric readers are files found by the names in ``BENCHMARK.json``
(``layout``); the traffic kinds that read a mix are ``kinds/<kind>.py``.
"""
