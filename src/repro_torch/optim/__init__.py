from .adamw import AdamW, global_norm
from .schedules import make as make_schedule

__all__ = ["AdamW", "global_norm", "make_schedule"]
