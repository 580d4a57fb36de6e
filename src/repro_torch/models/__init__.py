"""Models on the analog backend (the ECG classifier so far)."""
