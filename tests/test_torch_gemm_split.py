"""The numeric design of the GEMM core of kernels B and C, on the CPU.

The core (weasal_tpu_torch/csrc/kpconv_common.cuh) runs the KPConv
products y @ W, g @ W^T and y^T @ g on the tensor cores through the 3xTF32
split: each f32 operand is cut into big = tf32(a) and small = tf32(a - big)
by `cvt.rna.tf32.f32` (round to 10 explicit mantissa bits, half away from
zero), and a @ b is summed as small_a big_b + big_a small_b + big_a big_b
into f32 accumulators, one MMA of depth 8 after another. This file
emulates that arithmetic in numpy and holds it, at the main path's depths,
to the kernels' tolerance against an f64 product: rtol 1e-4, atol 1e-5 x
the output's largest magnitude (the tolerance of chip_smoke.py and
tests/test_torch_cuda.py). It also shows that single-pass TF32 misses that
tolerance, which is why the core does not use it.

The tensor cores add each MMA's products to the accumulator with
truncation (round toward zero), which makes a sum drift toward zero: the
emulation models that, taking each MMA's 8 products exactly (a TF32
product fits in f32) and rounding their sum with the accumulator toward
zero. As the core does, each 32-deep stage runs four chains from zero
(its small products with the first big product, then each other big
product alone), and each chain's result goes into the running f32 sum,
rounded to nearest, after `untruncate` adds its last bit (half an ulp on
average, what the truncation took). It shows that this leaves no drift
at the f32 level, where one truncating accumulator over the depth, or one
chain of a stage's twelve MMAs, does drift.

compute_dtype "bfloat16" (kernels B and C's bf16 variants): the forward's
y @ bf(W) runs on a bf16 core, wgmma of depth 16 with f32 accumulators,
one chain of 4 MMAs a 64-deep stage, added untruncated into round-to-
nearest stage sums (emulated by `bf16_core_product`: its drift on
positive operands stays far below one truncating accumulator's); C's
g @ bf(W)^T and bf(y)^T @ g, one operand exact in bf16 and so in TF32,
run the TF32 core in two passes (its small half is zero: the third
product adds only zeros), held to f64 at the kernels' tolerance.
"""

import numpy as np
import pytest

STAGE_STEPS = 4  # steps of depth 8 in one 32-deep stage of the core


def rna_tf32(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 on finite f32 values: the low 13 mantissa bits
    rounded half away from zero, then cleared."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split_tf32(x: np.ndarray):
    """(big, small), both TF32 values, with x = big + small + r and
    |r| <= 2^-22 |x|."""
    x = np.asarray(x, dtype=np.float32)
    big = rna_tf32(x)
    return big, rna_tf32(x - big)


def round_toward_zero(exact: np.ndarray) -> np.ndarray:
    """f64 values to f32, rounded toward zero."""
    r = exact.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(exact)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def untruncate(x: np.ndarray) -> np.ndarray:
    """The core's `untruncate`: one integer add of the last bit of each
    f32 value, moving it one ulp away from zero when that bit is 1."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return (bits + (bits & np.uint32(1))).view(np.float32)


def _slabs(a: np.ndarray, b: np.ndarray, steps: int,
           width: int = 8) -> np.ndarray:
    """[steps, m, n] exact products of each `width`-deep step, the depth
    padded with zeros as the core's tiles are."""
    m, depth = a.shape
    pad = steps * width - depth
    a = np.pad(a.astype(np.float64), ((0, 0), (0, pad)))
    b = np.pad(b.astype(np.float64), ((0, pad), (0, 0)))
    return np.einsum("msk,skn->smn", a.reshape(m, steps, width),
                     b.reshape(steps, width, b.shape[1]))


def _rn_add(total: np.ndarray, x: np.ndarray) -> np.ndarray:
    return (total.astype(np.float64) + x).astype(np.float32)


def mma_product(pairs, depth: int, stage_steps: int = STAGE_STEPS):
    """sum over `pairs` of a @ b with one truncating chain a stage: per
    8-deep step one MMA per pair in order, each adding its 8 exact
    products to the stage accumulator with truncation; every
    `stage_steps` steps the stage's sum goes into the running sum,
    rounded to nearest (the core's arrangement before its chains were cut
    to one big product, and with stage_steps = depth one accumulator)."""
    m, n = pairs[0][0].shape[0], pairs[0][1].shape[1]
    steps = -(-depth // 8)
    slabs = [_slabs(a, b, steps) for a, b in pairs]
    total = np.zeros((m, n), dtype=np.float32)
    acc = np.zeros((m, n), dtype=np.float32)
    for s in range(steps):
        if s % stage_steps == 0:
            total = _rn_add(total, acc)
            acc = np.zeros((m, n), dtype=np.float32)
        for slab in slabs:
            acc = round_toward_zero(acc.astype(np.float64) + slab[s])
    return _rn_add(total, acc)


def core_product(a: np.ndarray, b: np.ndarray,
                 exact: str = "") -> np.ndarray:
    """a @ b as the core sums it: per 32-deep stage the small products of
    its 4 steps and the first big product in one truncating chain from
    zero, then each other big product from zero; each chain's result,
    untruncated, added to the running sum rounded to nearest. exact "a"
    or "b": that operand is a TF32 value (a bf16 one), its small half
    zero, and the core skips its small products (two passes)."""
    a_big, a_small = split_tf32(a)
    b_big, b_small = split_tf32(b)
    steps = -(-a.shape[1] // 32) * 4
    small = []
    if exact != "a":
        small.append(_slabs(a_small, b_big, steps))
    if exact != "b":
        small.append(_slabs(a_big, b_small, steps))
    big = _slabs(a_big, b_big, steps)
    total = np.zeros(big.shape[1:], dtype=np.float32)
    for stage in range(0, steps, STAGE_STEPS):
        acc = np.zeros_like(total)
        for s in range(stage, stage + STAGE_STEPS):
            for slab in small:
                acc = round_toward_zero(acc.astype(np.float64) + slab[s])
        for s in range(stage, stage + STAGE_STEPS):
            start = acc if s == stage else np.zeros_like(total)
            acc = round_toward_zero(start.astype(np.float64) + big[s])
            total = _rn_add(total, untruncate(acc))
    return total


def tf32x3(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return core_product(a, b)


def bf16(x: np.ndarray) -> np.ndarray:
    """f32 values rounded to the nearest bf16 (ties to even), as f32."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    rounded = bits + np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1))
    return (rounded & np.uint32(0xFFFF0000)).view(np.float32)


BF16_STAGE_STEPS = 4  # wgmmas of depth 16 in one 64-deep stage


def bf16_core_product(a: np.ndarray, b: np.ndarray,
                      stage_steps: int = BF16_STAGE_STEPS) -> np.ndarray:
    """a @ b of bf16 values as the bf16 core sums it: per 64-deep stage
    one truncating chain from zero of its 4 MMAs of depth 16 (each adding
    its 16 exact products), whose result, untruncated, goes into the
    running sum rounded to nearest; with stage_steps = the depth's steps,
    one truncating accumulator."""
    steps = -(-a.shape[1] // 64) * 4
    slabs = _slabs(a, b, steps, width=16)
    total = np.zeros(slabs.shape[1:], dtype=np.float32)
    acc = np.zeros_like(total)
    for s in range(steps):
        start = acc if s % stage_steps else np.zeros_like(total)
        acc = round_toward_zero(start.astype(np.float64) + slabs[s])
        if (s + 1) % stage_steps == 0 or s + 1 == steps:
            total = _rn_add(total, untruncate(acc))
    return total


def stage_chained_tf32x3(a: np.ndarray, b: np.ndarray,
                         stage_steps: int = STAGE_STEPS) -> np.ndarray:
    """3xTF32 with each stage's twelve MMAs in one truncating chain (or,
    with stage_steps = depth, one accumulator over the depth)."""
    a_big, a_small = split_tf32(a)
    b_big, b_small = split_tf32(b)
    return mma_product([(a_small, b_big), (a_big, b_small), (a_big, b_big)],
                       a.shape[1], stage_steps)


def tf32x1(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return mma_product([(rna_tf32(a), rna_tf32(b))], a.shape[1])


def within_kernel_tolerance(got: np.ndarray, ref: np.ndarray) -> bool:
    atol = 1e-5 * float(np.abs(ref).max())
    return bool(np.all(np.abs(got.astype(np.float64) - ref)
                       <= atol + 1e-4 * np.abs(ref)))


# (f32 bits in, TF32 bits out): exact values, below and above half an
# ulp of TF32, ties (away from zero, where ties-to-even would round down),
# negative values, a carry into the exponent and a subnormal.
RNA_CASES = [
    (0x3F800000, 0x3F800000),
    (0x3F800FFF, 0x3F800000),
    (0x3F801000, 0x3F802000),
    (0xBF801000, 0xBF802000),
    (0x3F803000, 0x3F804000),
    (0x3F801001, 0x3F802000),
    (0xC0A02FFF, 0xC0A02000),
    (0x3FFFF000, 0x40000000),
    (0x00001000, 0x00002000),
    (0x00000000, 0x00000000),
]


@pytest.mark.parametrize("bits_in,bits_out", RNA_CASES,
                         ids=[f"{a:08x}" for a, _ in RNA_CASES])
def test_rna_tf32_bit_patterns(bits_in, bits_out):
    x = np.array([bits_in], dtype=np.uint32).view(np.float32)
    assert int(rna_tf32(x).view(np.uint32)[0]) == bits_out


def test_split_keeps_22_bits():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(100_000)
         * np.exp2(rng.integers(-60, 60, 100_000))).astype(np.float32)
    big, small = split_tf32(x)
    for part in (big, small):
        assert np.all(part.view(np.uint32) & np.uint32(0x1FFF) == 0)
    rest = x.astype(np.float64) - big.astype(np.float64) - small
    assert np.all(np.abs(rest) <= np.exp2(-22) * np.abs(x.astype(np.float64)))


def _operands(product: str, depth: int, seed: int):
    """Operands of one main-path product, cut to a few output rows and
    columns: y is an aggregate of activations (>= 0), W a zero-mean init
    of scale depth^-1/2, g a zero-mean output gradient."""
    rng = np.random.default_rng(seed)
    if product == "y@W":
        a = np.abs(rng.standard_normal((48, depth)))
        b = rng.standard_normal((depth, 32)) / np.sqrt(depth)
    else:  # y^T @ g over the rows: the depth is the number of rows
        a = np.abs(rng.standard_normal((depth, 48))).T
        b = rng.standard_normal((depth, 32))
    return a.astype(np.float32), b.astype(np.float32)


# Depths of the main path (full-width Vaihingen WL model, 3 spheres):
# Kp*Cin = 15 x 256 and 15 x 512 for y @ W, 3 x 5712 rows for y^T @ g
PRODUCTS = [("y@W", 3840), ("y@W", 7680), ("y^T@g", 17136)]


@pytest.mark.parametrize("product,depth", PRODUCTS)
def test_tf32x3_meets_the_kernel_tolerance(product, depth):
    a, b = _operands(product, depth, seed=depth)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    assert within_kernel_tolerance(tf32x3(a, b), ref)


@pytest.mark.parametrize("product,depth", PRODUCTS)
def test_single_pass_tf32_misses_the_kernel_tolerance(product, depth):
    a, b = _operands(product, depth, seed=depth)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    assert not within_kernel_tolerance(tf32x1(a, b), ref)


@pytest.mark.parametrize("depth", [960, 7680])
def test_stage_sums_stop_the_truncation_drift(depth):
    # positive operands: every truncation errs the same way
    rng = np.random.default_rng(depth + 1)
    a = np.abs(rng.standard_normal((48, depth))).astype(np.float32)
    b = np.abs(rng.standard_normal((depth, 32))).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    staged = float(((tf32x3(a, b) - ref) / ref).mean())
    one_chain = float(((stage_chained_tf32x3(a, b, stage_steps=depth) - ref)
                       / ref).mean())
    assert abs(staged) < 1e-6
    assert one_chain < -5e-6


# (f32 bits in, bits out): the last bit 0 stays, 1 moves one ulp away from
# zero, a carry into the exponent, zeros and the smallest subnormal
UNTRUNCATE_CASES = [
    (0x3F800000, 0x3F800000),
    (0x3F800001, 0x3F800002),
    (0xBF800001, 0xBF800002),
    (0x3FFFFFFF, 0x40000000),
    (0x00000000, 0x00000000),
    (0x80000000, 0x80000000),
    (0x00000001, 0x00000002),
]


@pytest.mark.parametrize("bits_in,bits_out", UNTRUNCATE_CASES,
                         ids=[f"{a:08x}" for a, _ in UNTRUNCATE_CASES])
def test_untruncate_bit_patterns(bits_in, bits_out):
    x = np.array([bits_in], dtype=np.uint32).view(np.float32)
    assert int(untruncate(x).view(np.uint32)[0]) == bits_out
    # the same as adding half an ulp away from zero, rounded to nearest even
    half_ulp = np.float64(np.spacing(np.abs(x[0]))) / 2 * np.sign(x[0])
    assert np.float32(np.float64(x[0]) + half_ulp) == untruncate(x)[0]


@pytest.mark.parametrize("operands", ["positive", "mixed"])
@pytest.mark.parametrize("depth", [960, 7680])
def test_single_big_product_chains_leave_no_drift(depth, operands):
    # The mean signed error to f64, relative to the mean |output|: a chain
    # of a stage's twelve MMAs drifts toward zero by ~2e-7 (about what the
    # card measured for that arrangement); chains of one big product with
    # their truncation undone stay at the f32 rounding noise
    rng = np.random.default_rng(depth + 2)
    a = np.abs(rng.standard_normal((48, depth))).astype(np.float32)
    b = rng.standard_normal((depth, 32)).astype(np.float32)
    if operands == "positive":
        b = np.abs(b)
    ref = a.astype(np.float64) @ b.astype(np.float64)

    def drift(got):
        err = (got.astype(np.float64) - ref) * np.sign(ref)
        return float(err.mean() / np.abs(ref).mean())

    assert drift(stage_chained_tf32x3(a, b)) < -1e-7
    assert abs(drift(tf32x3(a, b))) < 1.5e-8


# ------------------------------------------- compute_dtype "bfloat16"

def test_bf16_rounding_is_torchs():
    import torch
    x = np.random.default_rng(9).standard_normal(4096).astype(np.float32)
    x[:4] = [1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -(1.0 + 2.0 ** -8), 0.0]
    want = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(bf16(x), want)


@pytest.mark.parametrize("depth", [960, 7680])
def test_bf16_core_stage_sums_stop_the_truncation_drift(depth):
    # positive bf16 operands of y @ W: the chains of one stage's 4 MMAs,
    # untruncated into round-to-nearest sums, keep the mean relative
    # error far below one truncating accumulator's
    rng = np.random.default_rng(depth + 3)
    a = bf16(np.abs(rng.standard_normal((48, depth))).astype(np.float32))
    b = bf16(np.abs(rng.standard_normal((depth, 32))).astype(np.float32))
    ref = a.astype(np.float64) @ b.astype(np.float64)
    staged = float(((bf16_core_product(a, b) - ref) / ref).mean())
    one_acc = float(((bf16_core_product(a, b, stage_steps=depth) - ref)
                     / ref).mean())
    assert abs(staged) < 5e-8       # measured -3.1e-8 and -2.3e-8
    assert one_acc < -1e-6          # -1.2e-6 and -1.1e-5
    assert within_kernel_tolerance(bf16_core_product(a, b), ref)


# C's two products in bf16 mode: dr = g @ bf(W)^T (depth Cout) and
# dW = bf(y)^T @ g (depth the rows), the bf16 operand exact in TF32
@pytest.mark.parametrize("product,depth", [("g@W^T", 256),
                                           ("y^T@g", 17136)])
def test_two_pass_split_with_a_bf16_operand_meets_the_tolerance(product,
                                                                 depth):
    rng = np.random.default_rng(depth + 4)
    if product == "g@W^T":
        a = rng.standard_normal((48, depth)).astype(np.float32)
        b = bf16(rng.standard_normal((depth, 32)).astype(np.float32)
                 / np.float32(np.sqrt(depth)))
        exact = "b"
    else:
        a = bf16(np.abs(rng.standard_normal((depth, 48))).T.astype(
            np.float32))
        b = rng.standard_normal((depth, 32)).astype(np.float32)
        exact = "a"
    np.testing.assert_array_equal(rna_tf32(a if exact == "a" else b),
                                  a if exact == "a" else b)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    two = core_product(a, b, exact=exact)
    assert within_kernel_tolerance(two, ref)
    # the skipped products are zeros: the same sums as all three passes
    np.testing.assert_array_equal(two, core_product(a, b))
