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
`python -m weasal_tpu_torch.train_Vaihingen3D_PseudoLabel`, which also
run the active-learning iterations; voting and acquisition:
`ModelTester` (`python -m weasal_tpu_torch.test_models`); pseudo-label
refinement: `python -m weasal_tpu_torch.pseudoLabel_refinement`. See
README.md, section "PyTorch/CUDA port".
"""

from weasal_tpu_torch.config import (Config, VaihingenPLConfig,
                                     VaihingenWLConfig)
from weasal_tpu_torch.infer import eval_step
from weasal_tpu_torch.interop import from_jax_opt_state, from_jax_variables
from weasal_tpu_torch.models.architectures import KPFCNN, KPFCNN_mprm
from weasal_tpu_torch.train.optim import init_opt_state
from weasal_tpu_torch.train.step import train_step
from weasal_tpu_torch.train.tester import ModelTester
from weasal_tpu_torch.train.trainer import ModelTrainer

__all__ = ["Config", "VaihingenWLConfig", "VaihingenPLConfig", "KPFCNN",
           "KPFCNN_mprm", "eval_step",
           "train_step", "init_opt_state", "ModelTrainer", "ModelTester",
           "from_jax_variables", "from_jax_opt_state"]
