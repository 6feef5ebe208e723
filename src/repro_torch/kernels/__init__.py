"""Hand-written Hopper kernels (``csrc/``), their loader (``_build``) and
the packages that wrap them (``sssj_join``, ``flash_attention``)."""

from .sssj_join.ops import sssj_join_scores  # noqa: F401
from .flash_attention.ops import flash_attention  # noqa: F401
