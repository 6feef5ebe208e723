"""The LM stack's forward pass: dense-attention causal LMs in PyTorch.

Counterpart of ``repro.models`` for the ``attn_dense`` archs; MoE, MLA,
hybrid and xLSTM blocks and the decode path are not ported yet.
"""

from .convert import params_from_numpy, params_to_numpy  # noqa: F401
from .lm import GroupPlan, init_lm, lm_forward, make_plan, param_count  # noqa: F401
