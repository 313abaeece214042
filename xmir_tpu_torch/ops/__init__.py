"""The port's kernels. Importing the package registers the forward kernels'
custom ops (``xmir::vit_attention``, ``xmir::biased_attention``,
``xmir::window_attention``, ``xmir::ln_qkv``, ``xmir::ln_dense``,
``xmir::convnext_tail``), which a program saved by ``torch.export`` calls:
import ``xmir_tpu_torch.ops`` before ``torch.export.load``."""
from . import convnext_block, ln_dense, vit_attn, window_attn  # noqa: F401  (register the ops)
