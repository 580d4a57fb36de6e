"""Per-layer metric `split_roofline.long` (see `harness.readers.split_roofline`)."""
from harness import readers


def read(rec):
    return readers.split_roofline(rec)
