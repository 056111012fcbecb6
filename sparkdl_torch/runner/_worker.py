"""Worker-process entry point for TorchRunner's local-process backend.

Launched as ``python -m sparkdl_torch.runner._worker <payload> <rank>
<np> <coordinator> <result_path> <platform>``. The payload carries the
user fn and kwargs (cloudpickle where installed); the parent pins this
process's card through ``CUDA_VISIBLE_DEVICES`` before exec. The worker
joins the process group, runs the pre-flight health probe, then the fn;
rank 0 writes the result.
"""

from __future__ import annotations

import pickle
import sys
import traceback


def main(argv: list[str]) -> int:
    payload_path, rank_s, np_s, coordinator, result_path, platform = argv
    rank, nprocs = int(rank_s), int(np_s)

    from sparkdl_torch.runner.backends import _pickler, init_rank

    with open(payload_path, "rb") as f:
        payload = _pickler().load(f)
    init_rank(coordinator, nprocs, rank, platform)

    import torch.distributed as dist

    # pre-flight health probe + optional trace server: fail fast if the
    # card or the collective path is bad, before the fn builds anything
    from sparkdl_torch.observability.health import preflight, preflight_env_opts

    try:
        try:
            preflight(rank=rank, **preflight_env_opts())
        except RuntimeError:
            return 2
        try:
            # deterministic rank-crash sites (reliability/faults.py): the
            # plan rides the inherited SPARKDL_TORCH_FAULT_PLAN, so a
            # parent can arm "worker.rank" or "worker.rank.<r>"
            from sparkdl_torch.reliability.faults import fault_point

            fault_point("worker.rank")
            fault_point(f"worker.rank.{rank}")
            result = payload["fn"](**payload["kwargs"])
        except Exception:
            traceback.print_exc()
            return 1
        if rank == 0:
            with open(result_path, "wb") as f:
                try:
                    pickle.dump(("ok", result), f)
                except Exception as e:  # unpicklable user return value
                    f.seek(0)
                    f.truncate()
                    pickle.dump(("unpicklable", repr(e)), f)
        return 0
    finally:
        sys.stdout.flush()
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
