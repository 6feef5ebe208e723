from .compact import (  # noqa: F401
    PairBuffer,
    PairCandidates,
    concat_candidates,
    merge_candidates,
    tile_candidates,
)
from .gate import (  # noqa: F401
    StripSummary,
    gate_ub,
    init_strip_summary,
    refresh_strip_summary,
    strip_gate,
    summarize_strips,
)
from .kernel import sssj_join_candidates_kernel_call  # noqa: F401
from .ops import (  # noqa: F401
    JoinCandidates,
    NEG_UID,
    sssj_join_candidates,
    suffix_chunk_norms,
)
from .ref import sssj_join_ref  # noqa: F401
