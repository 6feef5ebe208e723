from .compact import (  # noqa: F401
    PairBuffer,
    PairCandidates,
    compact_pairs,
    concat_candidates,
    merge_candidates,
    tile_candidates,
    tile_emit_counts,
)
from .gate import (  # noqa: F401
    StripSummary,
    gate_ub,
    init_strip_summary,
    refresh_strip_summary,
    strip_gate,
    summarize_strips,
)
from .kernel import (  # noqa: F401
    sssj_join_candidates_kernel_call,
    sssj_join_kernel_call,
)
from .ops import (  # noqa: F401
    JoinCandidates,
    NEG_UID,
    sssj_join_candidates,
    sssj_join_scores,
    sssj_join_tiles,
    suffix_chunk_norms,
)
from .ref import sssj_join_ref  # noqa: F401
