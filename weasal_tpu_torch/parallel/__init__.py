"""Data parallelism of the port (parallel/ddp.py), the counterpart of
weasal_tpu/parallel/."""
