"""HorovodRunner's counterpart: :class:`TorchRunner` starts one process
per card (or per CPU rank), joins them in a ``torch.distributed``
process group and returns rank 0's result."""

from sparkdl_torch.runner.torch_runner import HorovodRunner, TorchRunner

__all__ = ["TorchRunner", "HorovodRunner"]
