"""Placement of a runner's batches: the port of ``sparkdl_tpu.partition``,
so far its one-device case only.

:class:`SingleDevicePartitioner` puts everything on one
``torch.device``: it is what each executor of a
:class:`~sparkdl_torch.serving.replicas.ReplicaPool` runs on (the pool
scales by replicating single-device partitioners, never by splitting a
batch). Meshes, rule tables and ZeRO sharding (the reference's
``DataParallelPartitioner``/``SPMDPartitioner``, ``rules``,
``mesh_factory`` and ``zero``) are ROADMAP A8.
"""

from sparkdl_torch.partition.partitioner import SingleDevicePartitioner

__all__ = ["SingleDevicePartitioner"]
