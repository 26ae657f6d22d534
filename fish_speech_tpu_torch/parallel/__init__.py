"""Parallel serving and training: the LM sharded over a (dp, tp) mesh of
ranks.

Counterpart of `fish_speech_tpu/parallel/`. JAX annotates shardings on a
`jax.sharding.Mesh` and XLA inserts the collectives; here each rank is a
process holding its shard, the collectives are explicit
(`torch.distributed` over a (dp, tp) `DeviceMesh`), and rank 0 drives
the other ranks' engines (`parallel/driver.py`): tensor-parallel heads
and FFN, data-parallel decode rows. Training runs the same shards under
autograd (`train/`): the collectives are autograd functions, and the
step sums the gradients over dp. `distributed.py` sets up the world,
whose ranks are numbered host by host (each rank's local id on its host
picks its card, tp groups stay within a host and dp crosses hosts, each
host feeds its own rows of a batch), `mesh.py` holds the shard specs and
the model's collectives, and `dryrun.py` runs worlds of spawned ranks,
laid out as one host or as several equal ones.
"""

from fish_speech_tpu_torch.parallel.distributed import make_mesh  # noqa: F401
from fish_speech_tpu_torch.parallel.mesh import (  # noqa: F401
    lm_param_specs,
    shard_gen_state,
    shard_lm_params,
)
