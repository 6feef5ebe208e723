from .engine import (  # noqa: F401
    EngineConfig,
    EngineTelemetry,
    StreamEngine,
    StreamEngineBase,
    init_telemetry,
    make_batch_step,
    host_lanes,
    make_micro_step,
    pad_request,
    require_whole_tiles,
)
from .sharded import (  # noqa: F401
    ShardedStreamEngine,
    ShardedWindow,
    init_sharded_window,
    make_sharded_batch_step,
    shard_metrics,
    shard_stats,
    shard_view,
    window_axis,
)
from .window import (  # noqa: F401
    WindowState,
    init_window,
    push_with_overflow,
    select_write_slots,
    window_from_numpy,
    window_to_numpy,
)
