"""The LM stack: the ported archs' forward pass and decode in PyTorch.

Counterpart of ``repro.models`` for the ``attn_dense`` and ``attn_moe``
archs with GQA attention, the ``hybrid`` arch (Mamba2 layers and a shared
attention block) and the ``xlstm`` arch (mLSTM and sLSTM blocks); MLA
blocks and ``mtp_logits`` are not ported yet.
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
from .ssm import (  # noqa: F401
    SSMCache,
    init_mamba2,
    init_ssm_cache,
    mamba2,
    mamba2_decode,
)
from .xlstm import (  # noqa: F401
    MLSTMCache,
    SLSTMCache,
    init_mlstm_block,
    init_mlstm_cache,
    init_slstm_block,
    init_slstm_cache,
    mlstm_block,
    slstm_block,
)
