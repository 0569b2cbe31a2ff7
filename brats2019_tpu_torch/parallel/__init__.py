from .mesh import MeshEnv, make_mesh  # noqa: F401
