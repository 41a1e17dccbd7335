from .mesh import (DATA_AXIS, make_mesh, make_sharded_train_step,  # noqa: F401
                   replicate, shard_batch)
