"""The device mesh (``sharding.py``: logical-axis specs, the active mesh,
the explicit collectives), the GPipe pipeline (``pipeline.py``) and fault
tolerance for the training launcher (``fault.py``)."""
