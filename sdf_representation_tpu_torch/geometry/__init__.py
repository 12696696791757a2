from .mesh_io import Mesh, load_mesh, save_mesh

__all__ = ["Mesh", "load_mesh", "save_mesh"]
