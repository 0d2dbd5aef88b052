from deva_tpu_torch.parallel.mesh import (init_from_env, is_multiprocess,
                                          make_mesh, replicate, shard_batch)
from deva_tpu_torch.parallel.object_sharding import ObjectShards
from deva_tpu_torch.parallel.sharded_attention import (attend_mem_sharded,
                                                       pad_tokens)

__all__ = ["init_from_env", "is_multiprocess", "make_mesh", "replicate",
           "shard_batch", "ObjectShards", "attend_mem_sharded", "pad_tokens"]
