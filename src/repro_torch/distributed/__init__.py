"""Fault tolerance for the training launcher (``fault.py``) and the plan
leaves' logical-axis specs (``sharding.py``); the mesh waits (ROADMAP)."""
