"""The plain reference of the benchmark: single-device plain PyTorch and
numpy (the models, the losses, the optimizer, the resident level-0
assembly, the pyramid's subsampling and radius search), with autograd
for every gradient. It began as a copy of weasal_tpu_torch's plain path,
cut to one process and no kernels.

Nothing here imports the program, JAX or the JAX package. The copy
changes only when a benchmark PR changes it, so a later change to the
program cannot move what the program is held to.
"""
