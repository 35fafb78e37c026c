from pinot_tpu_torch.parallel.mesh import ShardedTable, build_sharded_table, execute_sharded, make_mesh

__all__ = ["ShardedTable", "build_sharded_table", "execute_sharded", "make_mesh"]
