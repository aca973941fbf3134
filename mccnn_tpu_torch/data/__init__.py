"""Host-side numpy helpers the serving path needs (see ``datasets.py``)."""
