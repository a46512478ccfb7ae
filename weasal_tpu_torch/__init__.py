"""PyTorch/CUDA port of weasal_tpu for NVIDIA Hopper.

The inference path: level-0 arrays -> device pyramid (kernel A, radius
search) -> KPFCNN_mprm (kernel B, KPConv forward) -> class probabilities.
Entry point: `eval_step`. See README.md, section "PyTorch/CUDA port".
"""

from weasal_tpu_torch.config import Config, VaihingenWLConfig
from weasal_tpu_torch.infer import eval_step
from weasal_tpu_torch.interop import from_jax_variables
from weasal_tpu_torch.models.architectures import KPFCNN_mprm

__all__ = ["Config", "VaihingenWLConfig", "KPFCNN_mprm", "eval_step",
           "from_jax_variables"]
