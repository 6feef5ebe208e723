"""The LM stack: the attention archs' forward pass and decode in PyTorch.

Counterpart of ``repro.models`` for the ``attn_dense`` and ``attn_moe``
archs with GQA attention; MLA, hybrid and xLSTM blocks and ``mtp_logits``
are not ported yet.
"""

from .attention import AttnCache, init_attn_cache  # noqa: F401
from .convert import (  # noqa: F401
    caches_from_numpy,
    caches_to_numpy,
    params_from_numpy,
    params_to_numpy,
)
from .lm import (  # noqa: F401
    GroupPlan,
    init_lm,
    init_lm_caches,
    lm_decode_step,
    lm_forward,
    make_plan,
    param_count,
)
