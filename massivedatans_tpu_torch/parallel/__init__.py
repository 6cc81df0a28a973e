from massivedatans_tpu_torch.parallel.launch import (  # noqa: F401
    Rank,
    run_sharded,
    spawn_ranks,
)
from massivedatans_tpu_torch.parallel.sharded import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    gather_state,
    make_mesh,
    mesh_model_axis,
    shard_problem,
    shard_state,
)
