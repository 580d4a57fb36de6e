"""Per-layer metric `serve.prefill_ms.long` (see `harness.readers.prefill_ms`)."""
from harness import readers


def read(rec):
    return readers.prefill_ms(rec)
