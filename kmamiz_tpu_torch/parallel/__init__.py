"""Device-mesh sharding of the span-window pipeline (parallel/mesh.py)."""
