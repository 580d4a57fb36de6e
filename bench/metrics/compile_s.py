"""Per-layer metric `compile_s` (see `harness.readers.compile_s`)."""
from harness import readers


def read(rec):
    return readers.compile_s(rec)
