"""Several devices (parallel/mesh.py) and several processes (parallel/dist.py)."""
