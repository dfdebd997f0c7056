"""Multi-device training on `torch.distributed`: rank meshes, process
groups, the sharded train steps and the collective audit."""

from gpode_tpu_torch.parallel.shard_map_step import (
    make_shard_map_shooting_step, shard_map_noise_fn)
from gpode_tpu_torch.parallel.train import (make_sharded_shooting_step,
                                            sharded_noise_fn)

# `--parallel`: each style's step builder and noise
STYLES = {"gspmd": (make_sharded_shooting_step, sharded_noise_fn),
          "shard_map": (make_shard_map_shooting_step, shard_map_noise_fn)}
