from .mesh import (DATA_AXIS, SAMPLE_AXIS, Mesh, initialize_distributed,
                   make_hybrid_mesh, make_mesh, make_parallel_pass_predict,
                   make_parallel_sample_predict, make_parallel_train_step,
                   make_sharded_scorer, resolve_device_count, shard_rows)

__all__ = ["DATA_AXIS", "SAMPLE_AXIS", "Mesh", "initialize_distributed",
           "make_mesh", "make_hybrid_mesh", "shard_rows",
           "resolve_device_count", "make_parallel_train_step",
           "make_sharded_scorer", "make_parallel_pass_predict",
           "make_parallel_sample_predict"]
