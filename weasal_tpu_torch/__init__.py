"""PyTorch/CUDA port of weasal_tpu for NVIDIA Hopper.

Inference: level-0 arrays -> device pyramid (kernel A, radius search) ->
KPFCNN_mprm or KPFCNN (kernel B, KPConv forward) -> class probabilities;
entry point `eval_step`. Training: the same forward in training mode,
the stage's loss (weak labels, or pseudo labels with the contrast loss),
a backward through kernels C (KPConv backward) and D (max-pool
backward), and an SGD update; entry point `train_step` with
`init_opt_state`. The training loop (datasets, potential sampler,
resident input, validation, checkpoints): `ModelTrainer`, driven by
`python -m weasal_tpu_torch.train_Vaihingen3D_WeakLabel` and
`python -m weasal_tpu_torch.train_Vaihingen3D_PseudoLabel` (and their
DALES twins `train_DALES_WeakLabel`, `train_DALES_PseudoLabel`), which
also run the active-learning iterations; voting and acquisition:
`ModelTester` (`python -m weasal_tpu_torch.test_models`); pseudo-label
refinement: `python -m weasal_tpu_torch.pseudoLabel_refinement`. The
fused device pyramid is the default input; `config.device_pyramid =
False` (`--host_pyramid`) builds the pyramids on the host, the JAX
package's default. The classifier `KPCNN` (configured by
`ShapeClsConfig`) takes host-built classification batches. See
README.md, section "PyTorch/CUDA port".
"""

from weasal_tpu_torch.config import (Config, DALESPLConfig, DALESWLConfig,
                                     ShapeClsConfig, VaihingenPLConfig,
                                     VaihingenPLDeformConfig,
                                     VaihingenWLConfig)
from weasal_tpu_torch.infer import eval_step
from weasal_tpu_torch.interop import from_jax_opt_state, from_jax_variables
from weasal_tpu_torch.models.architectures import KPCNN, KPFCNN, KPFCNN_mprm
from weasal_tpu_torch.train.optim import init_opt_state
from weasal_tpu_torch.train.step import train_step
from weasal_tpu_torch.train.tester import ModelTester
from weasal_tpu_torch.train.trainer import ModelTrainer

__all__ = ["Config", "VaihingenWLConfig", "VaihingenPLConfig",
           "VaihingenPLDeformConfig",
           "DALESWLConfig", "DALESPLConfig", "ShapeClsConfig", "KPCNN",
           "KPFCNN", "KPFCNN_mprm", "eval_step",
           "train_step", "init_opt_state", "ModelTrainer", "ModelTester",
           "from_jax_variables", "from_jax_opt_state"]
