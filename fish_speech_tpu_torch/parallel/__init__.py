"""Parallel serving: the LM sharded over a (dp, tp) mesh of ranks.

Counterpart of `fish_speech_tpu/parallel/`. JAX annotates shardings on a
`jax.sharding.Mesh` and XLA inserts the collectives; here each rank is a
process holding its shard, the collectives are explicit
(`torch.distributed` over a (dp, tp) `DeviceMesh`), and rank 0 drives
the other ranks' engines (`parallel/driver.py`): tensor-parallel heads
and FFN, data-parallel decode rows. `distributed.py` sets up the world,
`mesh.py` holds the shard specs and the model's collectives, and
`dryrun.py` runs worlds of ranks on one host.
"""

from fish_speech_tpu_torch.parallel.distributed import make_mesh  # noqa: F401
from fish_speech_tpu_torch.parallel.mesh import (  # noqa: F401
    lm_param_specs,
    shard_gen_state,
    shard_lm_params,
)
