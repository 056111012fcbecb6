"""Reliability pieces the port's feed needs: named fault-injection sites
(``faults.py``, ``fault_point``) and the per-process retry budget
(``retry.py``), copied from ``sparkdl_tpu.reliability``.
"""
