"""Model-level serving steps: the W8A8 DiT (``dit_int8``)."""
