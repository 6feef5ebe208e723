"""xlstm-350m — [ssm] 24L d_model=1024 4H (GQA kv=4) d_ff=0 vocab=50304 —
sLSTM + mLSTM blocks  [arXiv:2405.04517; unverified].

``d_ff = 0``: all FFN capacity lives inside the m/sLSTM blocks (mLSTM
pre-up-projection factor 2, sLSTM post-up GeGLU factor 4/3).
Sub-quadratic (recurrent state) ⇒ runs long_500k.
"""

from .base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    xlstm=XLSTMConfig(
        slstm_every=8, mlstm_proj_factor=2.0, slstm_proj_factor=4.0 / 3.0,
        conv_width=4,
    ),
    notes="7:1 mLSTM:sLSTM blocks (sLSTM at positions 7, 15, 23)",
)
