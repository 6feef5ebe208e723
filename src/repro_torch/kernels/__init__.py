"""Hand-written Hopper kernels (``csrc/``), their loader (``_build``) and
the join package that wraps them (``sssj_join``)."""

from .sssj_join.ops import sssj_join_scores  # noqa: F401
