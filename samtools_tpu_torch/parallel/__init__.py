"""Sharded runs: the device mesh and its reductions (mesh.py), and the
process group of a run over several processes (dist.py)."""
