"""Per-layer metric `peak_gib.long` (see `harness.readers.peak_gib`)."""
from harness import readers


def read(rec):
    return readers.peak_gib(rec)
