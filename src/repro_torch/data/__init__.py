from .pipeline import DataConfig, SyntheticCorpus, host_sharded_loader

__all__ = ["DataConfig", "SyntheticCorpus", "host_sharded_loader"]
