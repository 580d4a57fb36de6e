"""Per-layer metric `mfu.long` (see `harness.readers.mfu_prefill`)."""
from harness import readers


def read(rec):
    return readers.mfu_prefill(rec)
