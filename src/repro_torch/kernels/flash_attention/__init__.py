from .kernel import flash_attention_kernel_call, flash_attention_plain  # noqa: F401
from .ops import flash_attention  # noqa: F401
from .ref import attention_ref  # noqa: F401
