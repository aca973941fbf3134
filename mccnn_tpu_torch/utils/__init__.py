"""Host-side utilities (port of ``mccnn_tpu/utils``)."""
