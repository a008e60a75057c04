"""Train / serve step builders (``steps``), the train driver (``train``),
meshes (``mesh``), the H100's roofline (``roofline``) and the op-level step
analyzer (``op_analysis``). The dry run (``dryrun``) is an entry point,
``python -m repro_torch.launch.dryrun``, and is not imported here."""
from . import op_analysis, roofline

__all__ = ["op_analysis", "roofline"]
