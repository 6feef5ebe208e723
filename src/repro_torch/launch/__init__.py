"""Launch helpers: device meshes."""

from .mesh import Mesh, make_mesh_for  # noqa: F401
