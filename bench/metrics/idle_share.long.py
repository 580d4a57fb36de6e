"""Per-layer metric `idle_share.long` (see `harness.readers.idle_share`)."""
from harness import readers


def read(rec):
    return readers.idle_share(rec)
