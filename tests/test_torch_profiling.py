"""The port's device trace and its readers (weasal_tpu_torch/utils/
profiling.py), on the CPU.

The readers take a hand-written Chrome trace in torch.profiler's format:
host ranges of `record_function`, CUDA runtime launches on two threads
and two processes, kernels, a copy and a fill tied to them by correlation
id, a CUDA graph replay whose kernels share its launch's id, overlapping
kernels, a split-K sum after its tile kernel and an NCCL kernel. Their
durations, self times, families and busy share are computed by hand
below. `device_trace` around a CPU training step writes a trace that the
readers read (no device events on the CPU). JAX-free.
"""

import os

import numpy as np
import pytest
import torch

from weasal_tpu_torch.data.batching import calibrate_shape_plan
from weasal_tpu_torch.data import demo as port_demo
from weasal_tpu_torch.data.level0 import assemble_level0
from weasal_tpu_torch.models.architectures import KPFCNN_mprm
from weasal_tpu_torch.train.optim import init_opt_state
from weasal_tpu_torch.train.step import train_step
from weasal_tpu_torch.utils import profiling
from tests._torch_ddp_worker import TinyConfig
from tests._warm_torch import cpu_torch

GEMM = "void tf32x3_gemm_kernel<true, false, 128>(float const*, int)"
SPLITK = "void splitk_sum_kernel(float const*, float*, long long)"


def _x(cat, name, ts, dur, corr=None, pid=1, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
         "ts": ts, "dur": dur, "args": {"External id": 1}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def _kernel(name, ts, dur, corr, cat="kernel"):
    return _x(cat, name, ts, dur, corr, pid=0, tid=7)


# (name, start, end) of every device event, by start
DEVICE = [
    ("void search_kernel<4>(float const*, int)", 200, 210),
    ("void at::native::elementwise_kernel<128, 4>(int)", 205, 215),
    ("void aggregate_kernel(float const*, float const*)", 215, 235),
    (GEMM, 240, 270),
    (f"splitk_sum_kernel after {GEMM}", 272, 275),
    ("void maxpool_bwd_kernel(float const*, int const*)", 400, 405),
    ("Memcpy HtoD (Pinned -> Device)", 410, 414),
    ("void inverse_build_kernel(BuildArgs)", 520, 528),
    ("Memset (Device)", 530, 531),
    ("void inverse_sum_kernel(SumArgs)", 560, 566),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage)",
     710, 722),
    ("void other_process_kernel()", 800, 802),
]


def _trace():
    return {"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
         "args": {"name": "python"}},
        # one graph replay: three kernels and a split-K sum share the
        # cudaGraphLaunch's id; a kernel on another stream overlaps
        _x("user_annotation", "train_step_k", 100, 50),
        _x("cuda_runtime", "cudaGraphLaunch", 110, 5, corr=7),
        _x("cuda_runtime", "cudaLaunchKernel", 112, 2, corr=15),
        # another process's launch inside the range's time
        _x("cuda_runtime", "cudaLaunchKernel", 120, 2, corr=20, pid=2),
        _kernel(DEVICE[0][0], 200, 10, 7),
        _kernel(DEVICE[1][0], 205, 10, 15),
        _kernel(DEVICE[2][0], 215, 20, 7),
        _kernel(GEMM, 240, 30, 7),
        _kernel(SPLITK, 272, 3, 7),
        {"ph": "s", "cat": "ac2g", "name": "ac2g", "pid": 1, "tid": 1,
         "ts": 110, "id": 7},
        # a second replay: a kernel and a copy node
        _x("user_annotation", "train_step_k", 300, 40),
        _x("cuda_runtime", "cudaGraphLaunch", 305, 4, corr=9),
        _kernel(DEVICE[5][0], 400, 5, 9),
        _kernel(DEVICE[6][0], 410, 4, 9, cat="gpu_memcpy"),
        # an eager step: its backward launches from another thread
        _x("user_annotation", "step_core", 500, 100),
        _x("cuda_runtime", "cudaLaunchKernel", 510, 2, corr=11),
        _x("cuda_runtime", "cudaMemsetAsync", 540, 2, corr=13),
        _x("cuda_runtime", "cudaLaunchKernel", 550, 2, corr=12, tid=2),
        _kernel(DEVICE[7][0], 520, 8, 11),
        _kernel(DEVICE[8][0], 530, 1, 13, cat="gpu_memset"),
        _kernel(DEVICE[9][0], 560, 6, 12),
        # a range that launched nothing, and launches outside any range
        _x("user_annotation", "eval_step", 650, 10),
        _x("cuda_driver", "cuLaunchKernel", 700, 2, corr=14),
        _kernel(DEVICE[10][0], 710, 12, 14),
        _kernel(DEVICE[11][0], 800, 2, 20),
        # the device side of a range, never a device event
        _x("gpu_user_annotation", "train_step_k", 200, 75, pid=0, tid=7),
    ]}


@pytest.fixture
def trace_dir(tmp_path):
    import json
    with open(tmp_path / "trace_hand.json", "w") as f:
        json.dump(_trace(), f)
    return str(tmp_path)


def test_readers_give_the_hand_computed_durations(trace_dir):
    assert profiling.module_times_us(trace_dir, "train_step_k") == [75, 14]
    assert profiling.module_times_us(trace_dir, "step_core") == [46]
    # every range that launched on the card, in start order
    assert profiling.module_times_us(trace_dir) == [75, 14, 46]
    assert profiling.module_times_us(trace_dir, "eval_step") == []
    assert [r[0] for r in profiling.host_ranges(trace_dir)] == [
        "train_step_k", "train_step_k", "step_core", "eval_step"]


def test_self_times_families_and_busy_share(trace_dir):
    got = profiling.op_self_times_us(trace_dir)
    assert got == pytest.approx({n: end - start
                                 for n, start, end in DEVICE})
    rows = profiling.kernel_rows(trace_dir)
    assert [r[1] for r in rows] == [1] * len(DEVICE)
    assert [r[0] for r in rows][:2] == [GEMM, DEVICE[2][0]]
    # the union of the intervals: 111 us of events, 5 of them overlapping
    assert profiling.busy_us(trace_dir) == pytest.approx(106.0)
    assert profiling.busy_us(trace_dir, window=(205, 412)) == \
        pytest.approx(70.0)
    per_step = profiling.stage_breakdown(trace_dir, steps=2)
    want = {"B GEMM y@W (3xTF32)": 16.5, "B aggregate": 10.0,
            "collective": 6.0, "A radius_search": 5.0, "elementwise": 5.0,
            "inverse lists": 4.0, "C, D dX row sums": 3.0,
            "D maxpool_bwd": 2.5, "copies, fills": 2.5, "other": 1.0}
    assert per_step == pytest.approx(want)
    assert list(per_step)[:3] == ["B GEMM y@W (3xTF32)", "B aggregate",
                                  "collective"]
    families = dict((f, n) for f, n, _ in profiling.kernel_families(rows))
    assert families["B GEMM y@W (3xTF32)"] == 2
    assert families["copies, fills"] == 2


@pytest.mark.parametrize("name,family", [
    ("void bin_supports_kernel(float const*, int)", "A radius_search"),
    ("void search_kernel<16>(float const*, float const*)",
     "A radius_search"),
    ("void (anonymous namespace)::warp_search_kernel(float const*, int)",
     "A radius_search"),
    ("void aggregate_kernel(float const*, float const*)", "B aggregate"),
    ("void tf32x3_gemm_kernel<true, false, (CoreMode)0>(float const*)",
     "B GEMM y@W (3xTF32)"),
    ("void bf16_gemm_kernel<128>(__nv_bfloat16 const*)",
     "B GEMM y@W (bf16)"),
    ("void cast_transpose_bf16_kernel(float const*)", "B bf16 cast of W"),
    ("void tf32x3_gemm_kernel<true, true, (CoreMode)0>(float const*)",
     "C GEMM g@W^T (3xTF32)"),
    ("void tf32x3_gemm_kernel<false, false, (CoreMode)1>(float const*)",
     "C GEMM y^T@g (3xTF32)"),
    ("void dx_contrib_kernel(float const*, float const*)",
     "C dX contributions"),
    ("void maxpool_bwd_kernel(float const*, int const*)", "D maxpool_bwd"),
    ("void inverse_build_kernel(BuildArgs)", "inverse lists"),
    ("void inverse_sum_kernel(SumArgs)", "C, D dX row sums"),
    ("void list_sum_kernel(SumArgs)", "row sums (gathers, voxels)"),
    ("void run_sum_kernel(SumArgs)", "row sums (gathers, voxels)"),
    (f"splitk_sum_kernel after {GEMM}", "B GEMM y@W (3xTF32)"),
    ("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
     "collective"),
    ("sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n_tilesize128x128x32",
     "cuBLAS/CUTLASS GEMMs"),
    ("Memcpy DtoD (Device -> Device)", "copies, fills"),
    ("some_unknown_kernel", "other"),
])
def test_categorize_op_maps_the_port_kernels(name, family):
    assert profiling.categorize_op(name) == family


def test_device_trace_around_a_cpu_step_is_readable(tmp_path):
    """A training step (`train_step` on the CPU, TinyConfig) inside
    `device_trace`: trace_<tag>.json holds the step's `step_core` range;
    on the CPU it holds no device events, so the device readers give
    nothing. Disabled, the window writes nothing."""
    cfg = TinyConfig()
    rng = np.random.default_rng(3)
    with cpu_torch():
        plan = calibrate_shape_plan(
            [port_demo.demo_sphere(rng, cfg, density=6.0)["points"]
             for _ in range(2)], cfg, region_budget=(8, 64), rng=rng)
        arrays = assemble_level0(
            [port_demo.thin_payload(port_demo.demo_sphere(rng, cfg,
                                                          density=6.0),
                                    plan.num_points[0], rng)
             for _ in range(2)], plan, cfg.num_classes, rng)
        model = KPFCNN_mprm(cfg, tuple(range(cfg.num_classes)), (),
                            generator=torch.Generator().manual_seed(0))
        state = init_opt_state(model)
        out = str(tmp_path / "traces")
        with profiling.device_trace(out, tag="step") as prof:
            loss, _, _ = train_step(model, state, arrays, cfg, plan,
                                    cfg.learning_rate, device="cpu")
        assert prof is not None and np.isfinite(float(loss))
        with profiling.device_trace(str(tmp_path / "off"),
                                    enabled=False) as off:
            assert off is None
    assert os.listdir(out) == ["trace_step.json"]
    assert not (tmp_path / "off").exists()
    assert [r[0] for r in profiling.host_ranges(out)] == ["step_core"]
    assert profiling.op_self_times_us(out) == {}
    assert profiling.module_times_us(out, "step_core") == []
    assert profiling.stage_breakdown(out, steps=1) == {}
    with pytest.raises(RuntimeError):
        profiling.op_self_times_us(str(tmp_path / "off"))
