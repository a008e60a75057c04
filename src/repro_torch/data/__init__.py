from .synthetic import DataCfg, batch_for, host_slice

__all__ = ["DataCfg", "batch_for", "host_slice"]
