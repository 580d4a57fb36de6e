"""Fault tolerance for the training launcher (the mesh code waits, ROADMAP)."""
