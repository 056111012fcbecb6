from sparkdl_torch.runtime.dtypes import FLOAT32, DtypePolicy, default_policy

__all__ = ["DtypePolicy", "FLOAT32", "default_policy"]
