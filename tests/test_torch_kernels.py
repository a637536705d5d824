"""The port's hand-written kernels against their plain PyTorch versions.

The kernel contract (dtypes, shapes, strides, devices) is checked in
Python before any pointer reaches a kernel, and that part runs on the
CPU.  The kernels themselves are compiled and run only on a CUDA card:
the ``cuda`` tests skip elsewhere.  This file imports neither ``jax``
nor ``veles_tpu``, so on a machine with the card and without JAX it
runs on its own:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_kernels.py -m cuda -q

Tolerances: float32 max abs 1e-4 (the kernels sum in another order than
the plain version, with TF32 off); bfloat16 2e-2 (V is drawn from
U(-1, 1), so an output lies in [-1, 1] where one bf16 ulp is <= 2^-7).
The backward's gradients are not bounded by 1, so their tolerance is
relative as well as absolute, element by element within atol + rtol·|plain|:
float32 1e-4 + 1e-4; bfloat16 2e-3 + 2^-7.  A bf16 gradient is rounded
once on output, so two sums that differ in the last f32 bit may land one
bf16 ulp (at most 2^-7 relative) apart; p and ds, which both versions
round to bf16 before their products, add far less.  The absolute 2e-3
is about a sixth of a typical |dq| at s = 2048, small enough that a
dropped K or Q tile is reported (``test_bwd_tolerance_reports_planted
_faults``).  The bfloat16 backward runs on the tensor cores, float32
on the FMA body: a profile of the launches names the kernels that ran.
"""

import numpy
import pytest
import torch

from veles_tpu_torch.ops import attention as port
from veles_tpu_torch.ops.util import on_gpu

F32_TOL = 1e-4
BF16_TOL = 2e-2
BWD_F32_TOL = (1e-4, 1e-4)              # (atol, rtol)
BWD_BF16_TOL = (2e-3, 2 ** -7)


def _arrays(shapes, seed, uniform_last=False):
    rng = numpy.random.default_rng(seed)
    out = [rng.standard_normal(s).astype(numpy.float32) for s in shapes]
    if uniform_last:
        out[-1] = rng.uniform(-1.0, 1.0, shapes[-1]).astype(numpy.float32)
    return out


@pytest.fixture
def launches():
    port.reset_launches()
    yield port.launches
    port.reset_launches()


# -- the contract, checked before any launch --------------------------------

@pytest.mark.parametrize("bad,message", [
    (dict(dtype=torch.float16), "float32 or bfloat16"),
    (dict(d=160), "head_dim"),
    (dict(ndim=3), "(b, s, h, d)"),
    (dict(stride=True), "unit stride"),
])
def test_kernel_contract_is_checked_before_launch(bad, message):
    """What the kernels do not take is refused in Python, before any
    pointer is handed to them."""
    d = bad.get("d", 8)
    x = torch.zeros((1, 4, 2, d), dtype=bad.get("dtype", torch.float32))
    if bad.get("ndim"):
        x = x[0]
    if bad.get("stride"):
        x = torch.zeros((1, 4, 2, 2 * d))[..., ::2]
    with pytest.raises((TypeError, ValueError), match=message.replace(
            "(", r"\(").replace(")", r"\)")):
        port._check_bshd("flash_fwd", x, x, x)


def test_kernel_contract_refuses_mismatched_operands():
    x = torch.zeros((2, 4, 2, 8))
    with pytest.raises(ValueError, match="disagree"):
        port._check_bshd("decode_attn", x, torch.zeros((2, 4, 3, 8)))
    with pytest.raises(TypeError, match="differ in dtype"):
        port._check_bshd("decode_attn", x, x.to(torch.bfloat16))


def test_backward_contract_is_checked_before_launch():
    x = torch.zeros((2, 5, 3, 8))
    lse = torch.zeros((2, 3, 5))
    port._bwd_check(x, x, x, x, lse, lse)
    with pytest.raises(ValueError, match="lse"):
        port._bwd_check(x, x, x, x, lse[:, :, :4], lse)
    with pytest.raises(ValueError, match="delta"):
        port._bwd_check(x, x, x, x, lse, lse.transpose(1, 2).contiguous())
    with pytest.raises(ValueError, match="rows"):
        port._bwd_check(x, x, x, x[:, :4], lse, lse)
    with pytest.raises(TypeError, match="dtype"):
        port._bwd_check(x, x, x, x.to(torch.bfloat16), lse, lse)


def _within(got, want, tol):
    return bool(((got.float() - want.float()).abs()
                 <= tol[0] + tol[1] * want.float().abs()).all())


@pytest.mark.parametrize("fault", ["delta_sign", "last_k_tile",
                                   "last_q_tile"])
def test_bwd_tolerance_reports_planted_faults(fault):
    """The bf16 backward tolerance is tight enough to see a kernel that
    flips delta's sign, or skips the last K tile of dq or the last Q
    tile of dk/dv (64 rows, the kernels' tile), on the plain version's
    own outputs."""
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in
                   _arrays([(1, 256, 2, 64)] * 4, seed=26, uniform_last=True))
    o, lse = port._mha_ref(q, k, v, True)
    delta = port._delta(o, do)
    want = port._bwd_ref(q, k, v, o, lse, do, True, delta=delta)
    cut = q.shape[1] - 64
    if fault == "delta_sign":
        bad = port._bwd_ref(q, k, v, o, lse, do, True, delta=-delta)[0]
        assert not _within(bad, want[0], BWD_BF16_TOL)
    elif fault == "last_k_tile":
        bad = port._bwd_ref(q, k[:, :cut], v[:, :cut], o, lse, do, True,
                            delta=delta)[0]
        assert not _within(bad, want[0], BWD_BF16_TOL)
    else:
        _dq, dk, dv = port._bwd_ref(q[:, :cut], k, v, o[:, :cut],
                                    lse[..., :cut], do[:, :cut], True,
                                    delta=delta[..., :cut])
        assert not _within(dk, want[1], BWD_BF16_TOL)
        assert not _within(dv, want[2], BWD_BF16_TOL)


def test_on_gpu_refuses_mixed_devices():
    cpu = torch.zeros(2)
    assert on_gpu(cpu, cpu) is False
    with pytest.raises(ValueError):
        on_gpu(cpu, torch.zeros(2, device="meta"))


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are compiled and run "
                    "only there (python -m pytest --noconftest "
                    "tests/test_torch_kernels.py -m cuda)")
    from veles_tpu_torch.backends import set_precision
    from veles_tpu_torch.config import root
    root.common.engine.precision_level = 2      # full f32: TF32 off
    set_precision()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("d", [8, 64])
@pytest.mark.parametrize("causal,q_off", [(True, 0), (False, 0),
                                          (True, 40)])
def test_flash_kernel_matches_plain_version_on_card(
        cuda_device, launches, causal, q_off, d, dtype, tol):
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype) for a in
               _arrays([(2, 77, 3, d)] * 3, seed=21, uniform_last=True))
    o, lse = port._flash_fwd(q, k, v, causal, q_off, 0)
    ref_o, ref_lse = port._mha_ref(q, k, v, causal, q_off, 0)
    torch.cuda.synchronize()
    assert launches["flash_fwd"] == 1
    assert o.dtype == dtype and lse.dtype == torch.float32
    torch.testing.assert_close(o.float(), ref_o.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("d", [8, 64])
@pytest.mark.parametrize("nq,row_step", [(1, 0), (5, 1)])
def test_decode_kernel_matches_plain_version_on_card(
        cuda_device, launches, nq, row_step, d, dtype, tol):
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype) for a in
               _arrays([(3, nq, 2, d), (3, 70, 2, d), (3, 70, 2, d)],
                       seed=22, uniform_last=True))
    lens = torch.tensor([1, 33, 66], dtype=torch.int32, device=cuda_device)
    out = port.decode_attention(q, k, v, lens, row_step=row_step)
    ref = (port._verify_ref if row_step else port._decode_ref)(q, k, v,
                                                               lens)
    torch.cuda.synchronize()
    assert launches["decode_attn"] == 1
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)


def _bwd_operands(device, dtype, sq, sk, d, causal, q_off, strided, seed):
    """(q, k, v, o, lse, do) on the card; q, k, v are strided views of
    one (b, s, 3, h, d) projection when ``strided``, as training makes
    them; o and lse come from the plain forward."""
    b, h = 2, 3
    if strided:
        x, do = _arrays([(b, sq, 3, h, d), (b, sq, h, d)], seed)
        x[:, :, 2] = numpy.random.default_rng(seed).uniform(
            -1.0, 1.0, x[:, :, 2].shape)
        qkv = torch.from_numpy(x).to(device, dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q, k, v, do = (torch.from_numpy(a).to(device, dtype) for a in
                       _arrays([(b, sq, h, d), (b, sk, h, d), (b, sk, h, d),
                                (b, sq, h, d)], seed, uniform_last=True))
    do = torch.as_tensor(do).to(device, dtype)
    o, lse = port._mha_ref(q, k, v, causal, q_off, 0)
    return q, k, v, o, lse, do


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, BWD_F32_TOL),
                                       (torch.bfloat16, BWD_BF16_TOL)])
# 7: rows of 14 bytes, the synchronous-load route of the bf16 body; 72
# and 128: head dims padded to 128 inside the tensor-core body; 100: the
# synchronous route at 128
@pytest.mark.parametrize("d", [7, 8, 64, 72, 100, 128])
@pytest.mark.parametrize("causal,q_off", [(True, 0), (False, 0),
                                          (True, 40)])
@pytest.mark.parametrize("sq,sk,strided", [(77, 77, True), (13, 29, False),
                                           (1000, 1000, True)])
def test_flash_bwd_kernels_match_plain_version_on_card(
        cuda_device, launches, sq, sk, strided, causal, q_off, d, dtype,
        tol):
    args = _bwd_operands(cuda_device, dtype, sq, sk, d, causal, q_off,
                         strided, seed=23)
    got = port._flash_bwd(*args, causal, q_off, 0)
    want = port._bwd_ref(*args, causal, q_off, 0)
    torch.cuda.synchronize()
    assert launches["flash_bwd_dq"] == 1 and launches["flash_bwd_dkv"] == 1
    for g, w, x in zip(got, want, args[:3]):
        assert g.dtype == dtype and g.shape == x.shape
        torch.testing.assert_close(g.float(), w.float(), atol=tol[0],
                                   rtol=tol[1])


@pytest.mark.cuda
def test_flash_bwd_kernels_are_deterministic_on_card(cuda_device, launches):
    """No atomics: two launches give the same bits."""
    args = _bwd_operands(cuda_device, torch.bfloat16, 1024, 1024, 64, True,
                         0, True, seed=24)
    first = port._flash_bwd(*args, True)
    second = port._flash_bwd(*args, True)
    torch.cuda.synchronize()
    assert launches["flash_bwd_dq"] == 2 and launches["flash_bwd_dkv"] == 2
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_bwd_unaligned_rows_on_card(cuda_device, launches):
    """q, k, v and do 2 bytes past a 16-byte boundary, d = 64: the
    tensor-core body fills its tiles by ordinary loads."""
    q, k, v, o, lse, do = _bwd_operands(cuda_device, torch.bfloat16, 77,
                                        77, 66, True, 0, False, seed=27)
    q, k, v, do = (x[..., 1:65] for x in (q, k, v, do))
    o, lse = port._mha_ref(q, k, v, True)
    got = port._flash_bwd(q, k, v, o, lse, do, True)
    want = port._bwd_ref(q, k, v, o, lse, do, True)
    torch.cuda.synchronize()
    assert q.data_ptr() % 16 == 2
    assert launches["flash_bwd_dq"] == 1 and launches["flash_bwd_dkv"] == 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(),
                                   atol=BWD_BF16_TOL[0],
                                   rtol=BWD_BF16_TOL[1])


@pytest.mark.cuda
def test_flash_bwd_body_follows_the_dtype_on_card(cuda_device, launches):
    """float32 launches run the FMA body and bfloat16 launches the
    tensor-core body (``*_kernel_tc``), never the other: the kernels'
    names as a profile of the backward records them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for dtype, tag in ((torch.float32, "_kernel<"),
                       (torch.bfloat16, "_kernel_tc<")):
        args = _bwd_operands(cuda_device, dtype, 77, 77, 64, True, 0, True,
                             seed=28)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            port._flash_bwd(*args, True)
            torch.cuda.synchronize()
        names = [ev.name for ev in prof.events()
                 if ev.device_type == DeviceType.CUDA
                 and "flash_bwd" in ev.name]
        assert len(names) == 2, names
        for kernel in ("flash_bwd_dq", "flash_bwd_dkv"):
            assert any(kernel + tag in n for n in names), names


@pytest.mark.cuda
def test_flash_attention_autograd_launches_the_kernels_on_card(
        cuda_device, launches):
    q, k, v, o, lse, do = _bwd_operands(cuda_device, torch.float32, 77, 77,
                                        64, True, 0, True, seed=25)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = port.flash_attention(*leaves, True)
    out.backward(do)
    want = port._bwd_ref(q, k, v, o, lse, do, True)
    torch.cuda.synchronize()
    assert launches == {"flash_fwd": 1, "flash_bwd_dq": 1,
                        "flash_bwd_dkv": 1, "decode_attn": 0,
                        "paged_decode_attn": 0}
    for leaf, w in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, w, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.cuda
def test_kernel_wrappers_raise_on_the_card(cuda_device, launches):
    """A CUDA tensor the kernel does not take raises; it never falls
    back to the plain version."""
    x = torch.zeros((1, 4, 2, 8), dtype=torch.float16, device=cuda_device)
    with pytest.raises(TypeError):
        port.flash_attention(x, x, x, causal=True)
    q = torch.zeros((1, 9, 2, 8), device=cuda_device)
    k = torch.zeros((1, 16, 2, 8), device=cuda_device)
    lens = torch.ones(1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="query rows"):
        port.decode_attention(q, k, k, lens)
    with pytest.raises(ValueError, match="int32"):
        port.decode_attention(q[:, :1], k, k, lens.long())
    assert not any(launches.values())


# -- the paged decode kernel (csrc/decode_attn.cu, second entry) ------------

def _paged_operands(device, dtype, bs, nq, row_step, d, seed, h=2, b=4,
                    max_blocks=None, fill=None):
    """q, shuffled-page pools, tables (trash 0 past each row's pages) and
    lengths of 1, a page edge -1 and +1, and a verify limit that reaches
    max_blocks·BS.  ``fill`` overwrites the trash and every unowned page
    (garbage that must never reach the output)."""
    max_blocks = max_blocks or 48 // bs
    rng = numpy.random.default_rng(seed)
    num_blocks = b * max_blocks + 3
    lengths = [1, bs - 1 if bs > 1 else 1, bs + 1,
               max_blocks * bs - row_step * (nq - 1)]
    q = rng.standard_normal((b, nq, h, d)).astype(numpy.float32)
    kp = rng.standard_normal((num_blocks, bs, h, d)).astype(numpy.float32)
    vp = rng.uniform(-1, 1, (num_blocks, bs, h, d)).astype(numpy.float32)
    pages = rng.permutation(numpy.arange(1, num_blocks))
    tables = numpy.zeros((b, max_blocks), numpy.int32)
    used = 0
    for i, n in enumerate(lengths):
        need = min(max_blocks, -(-(n + row_step * (nq - 1)) // bs))
        tables[i, :need] = pages[used:used + need]
        used += need
    if fill is not None:
        owned = numpy.zeros(num_blocks, bool)
        owned[tables[tables > 0]] = True
        kp[~owned] = fill
        vp[~owned] = fill
    return [torch.from_numpy(a).to(device, dtype) for a in (q, kp, vp)] + [
        torch.from_numpy(tables).to(device),
        torch.tensor(lengths, dtype=torch.int32, device=device)]


@pytest.mark.parametrize("bad,message", [
    (dict(dtype=torch.float16), "float32 or bfloat16"),
    (dict(nq=9), "query rows"),
    (dict(tables=torch.int64), "int32 tables"),
    (dict(lengths=torch.int64), "int32 lengths"),
    (dict(heads=3), "disagree"),
])
def test_paged_kernel_contract_is_checked_before_launch(bad, message):
    """What the paged kernel does not take is refused in Python, before
    any pointer is handed to it (so the check runs on the CPU too)."""
    q = torch.zeros((2, bad.get("nq", 1), 2, 8),
                    dtype=bad.get("dtype", torch.float32))
    pool = torch.zeros((5, 4, bad.get("heads", 2), 8),
                       dtype=bad.get("dtype", torch.float32))
    tables = torch.zeros((2, 3), dtype=bad.get("tables", torch.int32))
    lens = torch.ones(2, dtype=bad.get("lengths", torch.int32))
    with pytest.raises((TypeError, ValueError), match=message):
        port._paged_decode_cuda(q, pool, pool, tables, lens, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("d", [8, 64])
@pytest.mark.parametrize("bs", [4, 8, 16])
@pytest.mark.parametrize("nq,row_step", [(1, 0), (5, 1), (8, 1)])
def test_paged_kernel_matches_plain_version_on_card(
        cuda_device, launches, nq, row_step, bs, d, dtype, tol):
    q, kp, vp, tables, lens = _paged_operands(cuda_device, dtype, bs, nq,
                                              row_step, d, seed=bs + nq)
    out = port.paged_decode_attention(q, kp, vp, tables, lens,
                                      row_step=row_step)
    ref = port._paged_decode_ref(q, kp, vp, tables, lens, row_step)
    torch.cuda.synchronize()
    assert launches["paged_decode_attn"] == 1
    assert launches["decode_attn"] == 0
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq,row_step", [(1, 0), (5, 1)])
def test_paged_kernel_equals_contiguous_kernel_on_a_mirror_on_card(
        cuda_device, launches, nq, row_step, dtype):
    """A pool that mirrors a contiguous cache, page by page in shuffled
    order, gives the contiguous kernel's output bit for bit."""
    bs, max_blocks, b = 16, 8, 3
    rng = numpy.random.default_rng(60 + nq)
    k, v = (torch.from_numpy(rng.standard_normal(
        (b, max_blocks * bs, 2, 64)).astype(numpy.float32)).to(
            cuda_device, dtype) for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((b, nq, 2, 64)).astype(
        numpy.float32)).to(cuda_device, dtype)
    lens = torch.tensor([1, 77, max_blocks * bs - row_step * (nq - 1)],
                        dtype=torch.int32, device=cuda_device)
    tables = torch.from_numpy(rng.permutation(
        numpy.arange(1, b * max_blocks + 1)).reshape(b, max_blocks).astype(
            numpy.int32)).to(cuda_device)
    kp = torch.full((b * max_blocks + 1, bs, 2, 64), 1e4,
                    device=cuda_device, dtype=dtype)
    vp = kp.clone()
    kp[tables.long()] = k.reshape(b, max_blocks, bs, 2, 64)
    vp[tables.long()] = v.reshape(b, max_blocks, bs, 2, 64)
    paged = port.paged_decode_attention(q, kp, vp, tables, lens, row_step)
    contiguous = port.decode_attention(q, k, v, lens, row_step)
    torch.cuda.synchronize()
    assert launches["paged_decode_attn"] == launches["decode_attn"] == 1
    assert torch.equal(paged, contiguous)


@pytest.mark.cuda
@pytest.mark.parametrize("nq,row_step", [(1, 0), (8, 1)])
def test_paged_kernel_never_reads_trash_or_unowned_pages_on_card(
        cuda_device, launches, nq, row_step):
    args = dict(dtype=torch.float32, bs=4, nq=nq, row_step=row_step, d=64,
                seed=7)
    clean = _paged_operands(cuda_device, fill=0.0, **args)
    dirty = _paged_operands(cuda_device, fill=1e4, **args)
    a = port.paged_decode_attention(*clean, row_step=row_step)
    b = port.paged_decode_attention(*dirty, row_step=row_step)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_paged_kernel_wrapper_raises_on_the_card(cuda_device, launches):
    q, kp, vp, tables, lens = _paged_operands(cuda_device, torch.float32,
                                              8, 1, 0, 8, seed=3)
    with pytest.raises(TypeError):
        port.paged_decode_attention(q.half(), kp.half(), vp.half(), tables,
                                    lens)
    with pytest.raises(ValueError, match="int32 tables"):
        port.paged_decode_attention(q, kp, vp, tables.long(), lens)
    with pytest.raises(ValueError, match="query rows"):
        port.paged_verify_attention(torch.cat([q] * 9, dim=1), kp, vp,
                                    tables, lens)
    assert not any(launches.values())


# -- the GEMM and fused-GD kernels (csrc/gemm.cu) ----------------------------
#
# Every element within 1e-5 + 1e-5·|plain|: f32 on both sides (TF32 off),
# one product summed in another order (and 1/B multiplied in the kernels,
# divided in _gd_ref).

GEMM_TOL = (1e-5, 1e-5)
GEMM_ACTIVATIONS = [None, "tanh", "sigmoid", "relu", "strict_relu"]
GEMM_SHAPES = [(37, 70, 50), (100, 784, 100), (100, 100, 10)]
_GD_HP = (0.03, 0.03, 0.0005, 0.0005, 0.9, 0.9)


@pytest.fixture
def gemm_launches():
    from veles_tpu_torch.ops import gemm
    gemm.reset_launches()
    yield gemm.launches
    gemm.reset_launches()


def _gd_operands(device, batch, f, n, transposed, seed):
    rng = numpy.random.default_rng(seed)
    x, eo, y = (rng.standard_normal(s).astype(numpy.float32)
                for s in ((batch, f), (batch, n), (batch, n)))
    w = (rng.standard_normal((n, f) if transposed else (f, n))
         / numpy.sqrt(f)).astype(numpy.float32)
    b = rng.standard_normal(n).astype(numpy.float32)
    vw = (rng.standard_normal(w.shape) * 0.01).astype(numpy.float32)
    vb = (rng.standard_normal(n) * 0.01).astype(numpy.float32)
    return [torch.from_numpy(a).to(device) for a in (x, y, eo, w, b, vw, vb)]


@pytest.mark.cuda
@pytest.mark.parametrize("activation", GEMM_ACTIVATIONS)
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("w_transposed", [False, True])
@pytest.mark.parametrize("m,k,n", GEMM_SHAPES)
def test_matmul_kernel_matches_plain_version_on_card(
        cuda_device, gemm_launches, m, k, n, w_transposed, with_bias,
        activation):
    from veles_tpu_torch.ops import gemm
    rng = numpy.random.default_rng(31)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(
        numpy.float32)).to(cuda_device)
    w = torch.from_numpy((rng.standard_normal((n, k) if w_transposed
                                              else (k, n)) / numpy.sqrt(k))
                         .astype(numpy.float32)).to(cuda_device)
    w = w.t() if w_transposed else w
    bias = torch.from_numpy(rng.standard_normal(n).astype(
        numpy.float32)).to(cuda_device) if with_bias else None
    got = gemm.matmul(a, w, bias, activation)
    want = gemm._matmul_ref(a, w, bias, activation)
    torch.cuda.synchronize()
    assert gemm_launches["matmul"] == 1
    torch.testing.assert_close(got, want, atol=GEMM_TOL[0],
                               rtol=GEMM_TOL[1])


@pytest.mark.cuda
@pytest.mark.parametrize("activation", GEMM_ACTIVATIONS)
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("need_err_input", [True, False])
@pytest.mark.parametrize("has_bias", [True, False])
@pytest.mark.parametrize("batch,f,n", GEMM_SHAPES)
def test_gd_kernels_match_plain_version_on_card(
        cuda_device, gemm_launches, batch, f, n, has_bias, need_err_input,
        transposed, activation):
    from veles_tpu_torch.ops import gemm
    args = _gd_operands(cuda_device, batch, f, n, transposed, seed=32)
    flags = dict(activation=activation, need_err_input=need_err_input,
                 has_bias=has_bias, transposed=transposed)
    want = gemm._gd_ref(*args, *_GD_HP, **flags)
    got = gemm.gd_fused(*args, *_GD_HP, **flags)
    torch.cuda.synchronize()
    assert gemm_launches == {"matmul": 0, "gd_dx": int(need_err_input),
                             "gd_dw": 1, "gd_db": int(has_bias)}
    for name, g, w_ in zip(("w", "b", "vw", "vb", "err_input"), got, want):
        if w_ is None:
            assert g is None
            continue
        torch.testing.assert_close(g, w_, atol=GEMM_TOL[0],
                                   rtol=GEMM_TOL[1], msg=name)


@pytest.mark.cuda
def test_gemm_kernels_are_deterministic_on_card(cuda_device, gemm_launches):
    """No atomics, no split-K: two launches give the same bits."""
    from veles_tpu_torch.ops import gemm
    x, y, eo, w, b, vw, vb = _gd_operands(cuda_device, 100, 784, 100, False,
                                          seed=33)
    assert torch.equal(gemm.matmul(x, w, b, "tanh"),
                       gemm.matmul(x, w, b, "tanh"))
    runs = []
    for _ in range(2):
        params = [t.clone() for t in (w, b, vw, vb)]
        out = gemm.gd_fused(x, y, eo, params[0], params[1], params[2],
                            params[3], *_GD_HP, activation="tanh")
        runs.append(list(out))
    torch.cuda.synchronize()
    for first, second in zip(*runs):
        assert torch.equal(first, second)


@pytest.mark.cuda
def test_gd_dx_must_run_before_dw_on_card(cuda_device, gemm_launches):
    """dw updates W in place, so err_input is right only when dx is
    launched first: the reverse order must fail the tolerance."""
    from veles_tpu_torch.ops import gemm
    x, y, eo, w, b, vw, vb = _gd_operands(cuda_device, 100, 100, 10, False,
                                          seed=34)
    want = gemm._gd_ref(x, y, eo, w, b, vw, vb, *_GD_HP)[4]
    first = gemm._gd_dx_cuda(eo, y, w, None, False)
    gemm._gd_dw_cuda(x, eo, y, w, vw, 1.0 / 100, 0.03, 0.0005, 0.9, None,
                     False)
    late = gemm._gd_dx_cuda(eo, y, w, None, False)
    torch.cuda.synchronize()
    torch.testing.assert_close(first, want, atol=GEMM_TOL[0],
                               rtol=GEMM_TOL[1])
    assert not torch.allclose(late, want, atol=GEMM_TOL[0],
                              rtol=GEMM_TOL[1])


@pytest.mark.cuda
def test_gemm_wrappers_raise_on_the_card(cuda_device, gemm_launches):
    from veles_tpu_torch.ops import gemm
    a = torch.zeros((4, 6), dtype=torch.float64, device=cuda_device)
    with pytest.raises(TypeError, match="float32"):
        gemm.matmul(a, a.t(), None, None)
    a = torch.zeros((4, 6), device=cuda_device)
    with pytest.raises(ValueError, match="matmul: a is"):
        gemm.matmul(a, a, None, None)
    assert not any(gemm_launches.values())


# -- the gather kernels (csrc/gather.cu) -------------------------------------
# Gathers move bytes: exact.  gather_norm multiplies, then adds, each
# rounded (__fmul_rn, __fadd_rn) as the plain version's two torch ops do:
# exact as well.

#: (table dtype, table shape): MNIST's u8 and f32 data, its int32
#: labels, rows of 1 element and of 13 B (no 16-B or 4-B words)
GATHER_TABLES = [(torch.uint8, (7000, 784)), (torch.float32, (7000, 784)),
                 (torch.int32, (7000,)), (torch.uint8, (50, 1)),
                 (torch.uint8, (50, 13)), (torch.float32, (50, 3, 9, 9))]


@pytest.fixture
def gather_launches():
    from veles_tpu_torch.ops import gather
    gather.reset_launches()
    yield gather.launches
    gather.reset_launches()


def _gather_operands(device, dtype, shape, n_idx=100, seed=40):
    """A table and int32 indices with negative and out-of-range ones."""
    rng = numpy.random.default_rng(seed)
    if dtype == torch.float32:
        data = torch.from_numpy(rng.standard_normal(shape).astype(
            numpy.float32))
    else:
        high = 256 if dtype == torch.uint8 else 2 ** 20
        data = torch.from_numpy(rng.integers(0, high, shape)).to(dtype)
    idx = rng.integers(0, shape[0], n_idx).astype(numpy.int32)
    idx[[3, 17, n_idx - 1]] = -1
    idx[5] = shape[0]                    # out of range: a pad row too
    return data.to(device), torch.from_numpy(idx).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape", GATHER_TABLES)
@pytest.mark.parametrize("pad", [0, -1])
def test_gather_kernel_matches_plain_version_on_card(
        cuda_device, gather_launches, dtype, shape, pad):
    from veles_tpu_torch.ops import gather
    if dtype == torch.uint8 and pad == -1:
        pad = 255
    data, idx = _gather_operands(cuda_device, dtype, shape)
    got = gather.take_rows(data, idx, pad)
    want = gather._gather_ref(data, idx, pad)
    torch.cuda.synchronize()
    assert gather_launches == {"gather": 1, "gather_norm": 0}
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape", [
    t for t in GATHER_TABLES if t[0] != torch.int32 or len(t[1]) > 1]
    + [(torch.int32, (50, 784))])
@pytest.mark.parametrize("per_feature", [False, True])
def test_gather_norm_kernel_matches_plain_version_on_card(
        cuda_device, gather_launches, dtype, shape, per_feature):
    from veles_tpu_torch.ops import gather
    data, idx = _gather_operands(cuda_device, dtype, shape)
    f = int(numpy.prod(shape[1:]))
    rng = numpy.random.default_rng(41)
    if per_feature:
        norm = gather.affine_tensors(
            (rng.uniform(0.5, 2.0, f), rng.standard_normal(f)), cuda_device)
    else:
        norm = gather.affine_tensors((1.0 / 255.0, 0.0), cuda_device)
    got = gather.take_rows_norm(data, idx, norm)
    want = gather._gather_norm_ref(data, idx, *norm)
    torch.cuda.synchronize()
    assert gather_launches == {"gather": 0, "gather_norm": 1}
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    assert not got[idx < 0].any()


@pytest.mark.cuda
def test_gather_kernels_are_deterministic_on_card(cuda_device,
                                                  gather_launches):
    from veles_tpu_torch.ops import gather
    data, idx = _gather_operands(cuda_device, torch.uint8, (7000, 784))
    norm = gather.affine_tensors((1.0 / 255.0, 0.0), cuda_device)
    assert torch.equal(gather.take_rows(data, idx),
                       gather.take_rows(data, idx))
    assert torch.equal(gather.take_rows_norm(data, idx, norm),
                       gather.take_rows_norm(data, idx, norm))


@pytest.mark.cuda
def test_gather_kernels_replay_in_a_cuda_graph_on_card(cuda_device,
                                                       gather_launches):
    """Captured once, replayed with new index contents written into the
    captured buffer: each replay gathers the new rows."""
    from veles_tpu_torch.ops import gather
    data, idx = _gather_operands(cuda_device, torch.uint8, (7000, 784))
    norm = gather.affine_tensors((1.0 / 255.0, 0.0), cuda_device)
    gather.take_rows_norm(data, idx, norm)        # load the library
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        rows = gather.take_rows(data, idx)
        normed = gather.take_rows_norm(data, idx, norm)
    for seed in (42, 43):
        _, new = _gather_operands(cuda_device, torch.uint8, (7000, 784),
                                  seed=seed)
        idx.copy_(new)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(rows, gather._gather_ref(data, idx))
        assert torch.equal(normed,
                           gather._gather_norm_ref(data, idx, *norm))


@pytest.mark.cuda
def test_gather_wrappers_raise_on_the_card(cuda_device, gather_launches):
    from veles_tpu_torch.ops import gather
    data, idx = _gather_operands(cuda_device, torch.uint8, (50, 13))
    with pytest.raises(ValueError, match="int32 indices"):
        gather.take_rows(data, idx.long())
    with pytest.raises(ValueError, match="contiguous table"):
        gather.take_rows(data.t(), idx)
    with pytest.raises(TypeError, match="gather_norm takes"):
        gather.take_rows_norm(data.double(), idx, (1.0, 0.0))
    norm = gather.affine_tensors((numpy.ones(5), numpy.zeros(5)),
                                 cuda_device)
    with pytest.raises(ValueError, match="want 1 or 13"):
        gather.take_rows_norm(data, idx, norm)
    assert not any(gather_launches.values())


@pytest.mark.cuda
def test_gd_kernels_read_hyperparameters_at_replay_on_card(
        cuda_device, gemm_launches):
    """The stitched GD stage's form: hyperparameters as 0-d f32 tensors
    of one device block.  Captured once; a learning rate written into
    the block before a replay takes effect at that replay."""
    from veles_tpu_torch.ops import gemm
    args = _gd_operands(cuda_device, 100, 784, 100, False, seed=35)
    block = torch.tensor(_GD_HP, dtype=torch.float32, device=cuda_device)
    hp = [block[i] for i in range(6)]
    params = [t.clone() for t in args[3:]]
    gemm.gd_fused(*args[:3], *params, *hp, activation="tanh")   # warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gemm.gd_fused(*args[:3], *params, *hp, activation="tanh")
    for lr in (0.03, 0.015):
        block[0], block[1] = lr, lr
        before = [t.clone() for t in params]
        want = gemm._gd_ref(*args[:3], before[0], before[1], before[2],
                            before[3], lr, lr, *_GD_HP[2:],
                            activation="tanh")
        graph.replay()
        torch.cuda.synchronize()
        for name, got, ref in zip(("w", "b", "vw", "vb"), params, want):
            torch.testing.assert_close(got, ref, atol=GEMM_TOL[0],
                                       rtol=GEMM_TOL[1], msg=name)


# -- a stitched segment on the card (veles_tpu_torch.stitch) -----------------

@pytest.mark.cuda
def test_stitched_segment_recaptures_when_a_read_tensor_moves_on_card(
        cuda_device, gemm_launches):
    """The first layer's weights rebound to a new tensor mid-run: both
    segments read it (the forward as a parameter, the GD segment as a
    donated buffer), so each must recapture once, never replay against
    the old address, and the run must still give the CPU's results."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.samples import mnist

    def run(device):
        prng.seed_all(3)
        wf = mnist.create_workflow(device=device, max_epochs=2,
                                   native=True)
        head = wf.stitch_segments[0].stages[0]
        prelude, weights = head.prelude, wf.forwards[0].weights

        def moving():
            prelude()
            if wf.loader.samples_served == 2000:     # a train minibatch
                weights.bind(weights.devmem.clone())
        head.prelude = moving
        wf.run()
        return wf

    card, cpu = run(None), run("cpu")
    torch.cuda.synchronize()
    assert [r["recaptures"] for r in card.stitch_report()] == [1, 1]
    assert [h["n_err"] for h in card.decision.history] == \
        [h["n_err"] for h in cpu.decision.history]
    got, want = card.params_to_numpy(), cpu.params_to_numpy()
    for name, ref in want.items():
        err = float(numpy.abs(got[name] - ref).max())
        assert err <= 1e-4 * float(numpy.abs(ref).max()), (name, err)


# -- the int8 GEMM, the reduction and the uniform fill -----------------------
# qmatmul: f32 on both sides with TF32 off, one product summed in another
# order (and over a split K): within 1e-4 of max |plain|; bf16 output within
# 2e-2 (one bf16 rounding of outputs up to ~6).  reduce: max and min equal
# (NaN where the plain version has NaN), sums within 1e-6 of sum |a| plus one
# bf16 ulp for a bf16 output.  uniform: the same bits as the plain version.

QMM_CASES = [(4, 1024, 3072, torch.bfloat16), (20, 1024, 4096, torch.bfloat16),
             (4, 4096, 1024, torch.float32), (5, 200, 130, torch.float32),
             (300, 256, 192, torch.float32)]
QMM_ACTIVATIONS = [None, "tanh", "sigmoid", "relu", "strict_relu", "gelu"]


def _qmm_operands(device, m, k, n, dtype, seed):
    rng = numpy.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(
        numpy.float32)).to(device, dtype)
    q = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(
        numpy.int8)).to(device)
    scale = torch.from_numpy((rng.uniform(0.5, 1.5, n) / 127
                              / numpy.sqrt(k)).astype(numpy.float32)).to(
        device)
    bias = torch.from_numpy(rng.standard_normal(n).astype(
        numpy.float32)).to(device, dtype)
    return a, q, scale, bias


@pytest.mark.cuda
@pytest.mark.parametrize("activation", QMM_ACTIVATIONS)
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("m,k,n,dtype", QMM_CASES)
def test_qmatmul_kernel_matches_plain_version_on_card(
        cuda_device, m, k, n, dtype, with_bias, activation):
    from veles_tpu_torch.ops import qgemm
    a, q, scale, bias = _qmm_operands(cuda_device, m, k, n, dtype, 41)
    bias = bias if with_bias else None
    qgemm.reset_launches()
    got = qgemm.qmatmul(a, q, scale, bias, activation)
    want = qgemm._qmatmul_ref(a, q, scale, bias, activation)
    again = qgemm.qmatmul(a, q, scale, bias, activation)
    torch.cuda.synchronize()
    assert qgemm.launches["qmatmul"] == 2 and got.dtype == dtype
    assert torch.equal(got, again)              # no atomics: same bits
    err = float((got.float() - want.float()).abs().max())
    tol = F32_TOL * float(want.float().abs().max()) \
        if dtype == torch.float32 else BF16_TOL
    assert err <= tol, (err, tol)


@pytest.mark.cuda
def test_qmatmul_wrapper_raises_on_the_card(cuda_device):
    from veles_tpu_torch.ops import qgemm
    a, q, scale, _b = _qmm_operands(cuda_device, 4, 64, 32, torch.float32, 1)
    qgemm.reset_launches()
    with pytest.raises(TypeError, match="int8"):
        qgemm.qmatmul(a, q.float(), scale)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        qgemm.qmatmul(a.half(), q, scale)
    with pytest.raises(ValueError, match="scale"):
        qgemm.qmatmul(a, q, scale[:-1])
    assert not qgemm.launches["qmatmul"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(37, 53), (24, 256), (1, 5000),
                                   (5000, 1), (300, 1030)])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_reduce_kernel_matches_plain_version_on_card(cuda_device, op, axis,
                                                     shape, dtype):
    from veles_tpu_torch.ops import reduce
    a = numpy.random.default_rng(43).standard_normal(shape).astype(
        numpy.float32)
    if min(shape) > 1:
        a[0, -1], a[-1, 0], a[shape[0] // 2, shape[1] // 2] = \
            numpy.inf, -numpy.inf, numpy.nan
    t = torch.from_numpy(a).to(cuda_device, dtype)
    reduce.reset_launches()
    got = reduce.matrix_reduce(t, axis, op, use_pallas=True)
    want = reduce._reduce_ref(t, axis, op)
    torch.cuda.synchronize()
    assert reduce.launches["reduce"] == 1 and got.dtype == dtype
    g, w = got.float().cpu(), want.float().cpu()
    nan = torch.isnan(w)
    assert torch.equal(torch.isnan(g), nan)
    if op != "sum":
        assert torch.equal(g[~nan], w[~nan])
        return
    inf = torch.isinf(w)
    assert torch.equal(g[inf], w[inf])
    finite = t.float().cpu().nan_to_num(0.0, 0.0, 0.0).abs().sum(axis)
    tol = 1e-6 * finite + (2.0 ** -8 * w.abs()
                           if dtype == torch.bfloat16 else 0.0)
    ok = ~nan & ~inf
    assert bool(((g - w).abs()[ok] <= tol[ok]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,low,high", [((1000,), 0.0, 1.0),
                                            ((257, 33), -2.0, 3.0),
                                            ((3,), 0.1, 0.3)])
def test_uniform_kernel_matches_plain_version_on_card(cuda_device, shape,
                                                      low, high, dtype):
    from veles_tpu_torch.ops import random
    random.reset_launches()
    got = random.uniform_pallas(5, shape, dtype, low, high)
    torch.cuda.synchronize()
    assert random.launches["uniform"] == 1 and got.dtype == dtype
    assert torch.equal(got, random._uniform_ref(5, shape, dtype, low, high,
                                                device=cuda_device))
    assert torch.equal(got.cpu(), random.uniform_pallas(
        5, shape, dtype, low, high, device="cpu"))
    assert float(got.min()) >= low and float(got.max()) < high
