"""Hand-written Hopper kernels (``csrc/``), their loader (``_build``) and
the join package that wraps them (``sssj_join``)."""
