"""Host-side numpy data pipeline (port of ``mccnn_tpu/data``): datasets,
augmentation, sampling protocols, synthetic clouds."""
