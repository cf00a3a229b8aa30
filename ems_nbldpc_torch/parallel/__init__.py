from .mesh import make_mesh, sharded_batch_step  # noqa: F401
