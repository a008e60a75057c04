"""Model-level code: the decoder LM (``lm``) and the W8A8 DiT (``dit_int8``)."""
from .lm import LM

__all__ = ["LM"]
