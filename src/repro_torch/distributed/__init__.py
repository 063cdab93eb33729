"""Placement of row-sharded arrays on a ``launch.mesh.Mesh``."""
