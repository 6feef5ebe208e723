from .engine import (  # noqa: F401
    EngineConfig,
    EngineTelemetry,
    StreamEngine,
    StreamEngineBase,
    init_telemetry,
    make_batch_step,
    make_micro_step,
    pad_request,
)
from .window import (  # noqa: F401
    WindowState,
    init_window,
    push_with_overflow,
    select_write_slots,
    window_from_numpy,
    window_to_numpy,
)
