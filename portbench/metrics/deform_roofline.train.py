"""% of the deformable chains' device time a training step
(`deform_conv_ms.train`) that their bound accounts for: the work that
the program's `deform.*` counters give over the window's steps, its bytes
at 3.35 TB/s, its aggregate and GEMM products at the TF32 peak, its
influence, mask and minimum operations at the f32 peak
(yardstick/deform_work.py). A program without the marks or the counters
gives nothing."""

from portbench.yardstick.deform_work import roofline


def read(record):
    return roofline(record)
