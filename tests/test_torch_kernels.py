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
_faults``).  In bfloat16 the flash forward, the flash backward and
qmatmul at M > 16 run on the tensor cores, in float32 (and qmatmul at
M <= 16) the FMA bodies: a profile of the launches names the kernels
that ran.
"""

import numpy
import pytest
import torch

from veles_tpu_torch.ops import attention as port
from veles_tpu_torch.ops.util import on_gpu

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

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


def _fwd_operands(device, b, sq, sk, h, d, seed, strided=False,
                  pad=0):
    """bf16 q, k, v on the card, V from U(-1, 1).  ``strided``: views of
    one (b, s, 3, h, d) projection, as prefill and training make them;
    ``pad``: columns [pad, pad + d) of rows d + 2 pad wide, so every row
    starts 2 pad bytes past a 16-byte boundary."""
    rng = numpy.random.default_rng(seed)
    width = d + 2 * pad
    if strided:
        x = rng.standard_normal((b, sq, 3, h, width)).astype(numpy.float32)
        x[:, :, 2] = rng.uniform(-1.0, 1.0, x[:, :, 2].shape)
        qkv = torch.from_numpy(x).to(device, torch.bfloat16)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q, k, v = (torch.from_numpy(a).to(device, torch.bfloat16) for a in
                   _arrays([(b, sq, h, width), (b, sk, h, width),
                            (b, sk, h, width)], seed, uniform_last=True))
    return tuple(x[..., pad:pad + d] for x in (q, k, v))


def _fwd_agrees(q, k, v, causal, q_off=0, k_off=0):
    o, lse = port._flash_fwd(q, k, v, causal, q_off, k_off)
    ref_o, ref_lse = port._mha_ref(q, k, v, causal, q_off, k_off)
    torch.cuda.synchronize()
    assert o.dtype == torch.bfloat16 and o.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == ref_lse.shape
    torch.testing.assert_close(o.float(), ref_o.float(), atol=BF16_TOL,
                               rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=BF16_TOL, rtol=0)
    return o, lse


@pytest.mark.cuda
# 7 and 100: rows not a whole number of 16-byte chunks, the ordinary-load
# route; 16 and 100 are zero-padded to 32 and 128
@pytest.mark.parametrize("d", [7, 16, 32, 64, 100, 128])
@pytest.mark.parametrize("s", [1, 7, 64, 65, 300, 2048])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_tensor_core_body_matches_plain_version_on_card(
        cuda_device, launches, causal, s, d):
    q, k, v = _fwd_operands(cuda_device, 1, s, s, 2, d, seed=s + d)
    _fwd_agrees(q, k, v, causal)
    assert launches["flash_fwd"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_tensor_core_body_on_a_chunk_on_card(cuda_device,
                                                        launches, causal):
    """A prefill chunk: 256 queries at q_offset 512 against 768 keys."""
    q, _k, _v = _fwd_operands(cuda_device, 2, 256, 256, 3, 64, seed=31)
    _q, k, v = _fwd_operands(cuda_device, 2, 768, 768, 3, 64, seed=32)
    _fwd_agrees(q, k, v, causal, q_off=512)
    assert launches["flash_fwd"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("pad", [0, 1])
@pytest.mark.parametrize("causal,q_off", [(True, 0), (False, 0),
                                          (True, 40)])
def test_flash_fwd_tensor_core_body_on_strided_views_on_card(
        cuda_device, launches, causal, q_off, pad):
    """Strided views of one projection (cp.async tiles); with ``pad`` the
    rows start 2 bytes past 16 (ordinary loads into the same tiles)."""
    q, k, v = _fwd_operands(cuda_device, 2, 300, 300, 3, 64, seed=33,
                            strided=True, pad=pad)
    assert (q.data_ptr() % 16 == 2) == bool(pad)
    _fwd_agrees(q, k, v, causal, q_off=q_off)
    assert launches["flash_fwd"] == 1


@pytest.mark.cuda
def test_flash_fwd_tensor_core_body_at_the_training_shape_on_card(
        cuda_device, launches):
    """(8, 2048, 16, 64) causal, strided views: the ``train`` step's."""
    q, k, v = _fwd_operands(cuda_device, 8, 2048, 2048, 16, 64, seed=34,
                            strided=True)
    first = _fwd_agrees(q, k, v, True)
    again = port._flash_fwd(q, k, v, True)
    torch.cuda.synchronize()
    assert launches["flash_fwd"] == 2
    # no atomics, a fixed order: a relaunch gives the same bits
    assert torch.equal(first[0], again[0])
    assert torch.equal(first[1], again[1])


def _profiled_kernel_names(fn, tag=""):
    """The names of the CUDA kernels holding ``tag`` that a profile of
    ``fn`` records."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [ev.name for ev in prof.events()
            if ev.device_type == DeviceType.CUDA and tag in ev.name]


@pytest.mark.cuda
def test_flash_fwd_body_follows_the_dtype_on_card(cuda_device, launches):
    """float32 runs the FMA body (``flash_fwd_kernel<``) and bfloat16 the
    tensor-core body (``flash_fwd_kernel_tc<``), never the other: the
    kernels' names as a profile records them (beside a PyTorch kernel,
    around which the profiler sees the card)."""
    for dtype, tag in ((torch.float32, "flash_fwd_kernel<"),
                       (torch.bfloat16, "flash_fwd_kernel_tc<")):
        q, k, v = (torch.from_numpy(a).to(cuda_device, dtype) for a in
                   _arrays([(2, 77, 3, 64)] * 3, seed=35, uniform_last=True))

        def run():
            o, _lse = port._flash_fwd(q, k, v, True)
            return o.float().sum()
        names = _profiled_kernel_names(run, "flash_fwd")
        assert len(names) == 1 and tag in names[0], names


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
    # the bias step rides in dw's launch: no launch of its own
    assert gemm_launches == {"matmul": 0, "matmul_bf16": 0,
                             "gd_dx": int(need_err_input),
                             "gd_dw": 1, "gd_db": 0}
    assert gemm.bias_in_dw == {"gd_db_in_dw": int(has_bias)}
    for name, g, w_ in zip(("w", "b", "vw", "vb", "err_input"), got, want):
        if w_ is None:
            assert g is None
            continue
        torch.testing.assert_close(g, w_, atol=GEMM_TOL[0],
                                   rtol=GEMM_TOL[1], msg=name)


#: the bf16 body against its plain version: one bf16 ulp (2^-7
#: relative) and 2^-8 absolute (another f32 summation order can round an
#: output near 0 the other way)
BF16_GEMM_TOL = (2.0 ** -8, 2.0 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("activation", GEMM_ACTIVATIONS)
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("view", [None, "a", "w"])
@pytest.mark.parametrize("m,k,n", GEMM_SHAPES + [(784, 100, 100)])
def test_bf16_matmul_kernel_matches_plain_version_on_card(
        cuda_device, gemm_launches, m, k, n, view, with_bias, activation):
    from veles_tpu_torch.ops import gemm
    rng = numpy.random.default_rng(41)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(
        numpy.float32)).to(cuda_device).bfloat16()
    w = torch.from_numpy((rng.standard_normal((k, n)) / numpy.sqrt(k))
                         .astype(numpy.float32)).to(cuda_device).bfloat16()
    if view == "a":
        a = a.t().contiguous().t()
    elif view == "w":
        w = w.t().contiguous().t()
    bias = torch.from_numpy(rng.standard_normal(n).astype(
        numpy.float32)).to(cuda_device).bfloat16() if with_bias else None
    got = gemm.matmul(a, w, bias, activation)
    want = gemm._matmul_ref(a, w, bias, activation)
    torch.cuda.synchronize()
    assert gemm_launches["matmul_bf16"] == 1 and gemm_launches["matmul"] == 0
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(),
                               atol=BF16_GEMM_TOL[0], rtol=BF16_GEMM_TOL[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_gradients_run_the_kernel_on_card(cuda_device, gemm_launches,
                                                 dtype):
    """The autograd matmul's backward products go through the same
    kernel (3 launches: the forward, da and dw) and agree with the CPU
    route's."""
    from veles_tpu_torch.ops import gemm
    rng = numpy.random.default_rng(42)
    host = [rng.standard_normal(s).astype(numpy.float32) * scale
            for s, scale in (((100, 100), 1.0), ((100, 10), 0.1),
                             ((10,), 1.0), ((100, 10), 1.0))]
    results = []
    for device in ("cpu", cuda_device):
        a, w, b, g = (torch.from_numpy(x).to(device).to(dtype) for x in host)
        leaves = [t.requires_grad_(True) for t in (a, w, b)]
        out = gemm.matmul(*leaves, "tanh")
        results.append([t.float().cpu() for t in
                        [out] + list(torch.autograd.grad(out, leaves, g))])
    torch.cuda.synchronize()
    name = "matmul_bf16" if dtype == torch.bfloat16 else "matmul"
    assert gemm_launches[name] == 3
    tol = BF16_GEMM_TOL if dtype == torch.bfloat16 else (1e-4, 1e-4)
    for got, want in zip(results[1], results[0]):
        torch.testing.assert_close(got, want, atol=tol[0] * 4,
                                   rtol=tol[1])


@pytest.mark.cuda
def test_gemm_kernels_are_deterministic_on_card(cuda_device, gemm_launches):
    """No atomics (K split over a cluster and summed in rank order): two
    launches give the same bits."""
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


#: (M, K, N) of the split body beyond GEMM_SHAPES: K shorter than split x
#: BK (split 2 over 20), and split 8 over 9 K tiles (chunks of 1 and 2)
GEMM_SPLIT_SHAPES = [(8, 20, 8), (30, 140, 30)]
#: every (tile, split) the C entries take; split tiles of 1 ... 8 ranks
GEMM_CONFIGS = [(0, 1), (0, 2), (0, 4), (0, 8), (1, 1)]
GEMM_BIG_TOL = (1e-4, 1e-4)          # a 4096-long sum in another order


def _gemm_case(device, m, k, n, seed, w_transposed=False, x_strided=False):
    """a (m, k) (a view with a row stride of 2k + 3 and every other
    column when ``x_strided``), w (k, n) (a transposed view of (n, k)
    storage when ``w_transposed``) scaled by 1/sqrt(k), bias (n,)."""
    rng = numpy.random.default_rng(seed)
    shape = (m, 2 * k + 3) if x_strided else (m, k)
    a = torch.from_numpy(rng.standard_normal(shape).astype(
        numpy.float32)).to(device)
    if x_strided:
        a = a[:, 1:2 * k:2]
    w = torch.from_numpy((rng.standard_normal((n, k) if w_transposed
                                              else (k, n)) / numpy.sqrt(k))
                         .astype(numpy.float32)).to(device)
    bias = torch.from_numpy(rng.standard_normal(n).astype(
        numpy.float32)).to(device)
    return a, (w.t() if w_transposed else w), bias


def _gemm_config_errors(device, m, k, n, tile_split, tol, seed):
    """matmul, gd_dx and gd_dw with the bias step (both storage layouts)
    forced onto one (tile, split), each against its plain version;
    returns the names of those outside ``tol`` and whether a relaunch
    gave the same bits."""
    from veles_tpu_torch.ops import gemm
    bad, same = [], True
    a, w, bias = _gemm_case(device, m, k, n, seed)
    want = gemm._matmul_ref(a, w, bias, "tanh")
    got = gemm._matmul_cuda(a, w, bias, "tanh", tile_split)
    same &= torch.equal(got, gemm._matmul_cuda(a, w, bias, "tanh",
                                               tile_split))
    if not torch.allclose(got, want, atol=tol[0], rtol=tol[1]):
        bad.append("matmul")
    # GD with batch m, f = k inputs, n neurons
    x, y, eo, w, b, vw, vb = _gd_operands(device, m, k, n, False, seed)
    want = gemm._gd_ref(x, y, eo, w, b, vw, vb, *_GD_HP, activation="tanh")
    dx = gemm._gd_dx_cuda(eo, y, w, "tanh", False, tile_split)
    same &= torch.equal(dx, gemm._gd_dx_cuda(eo, y, w, "tanh", False,
                                             tile_split))
    if not torch.allclose(dx, want[4], atol=tol[0], rtol=tol[1]):
        bad.append("gd_dx")
    for transposed in (False, True):
        if transposed:
            x, y, eo, w, b, vw, vb = _gd_operands(device, m, k, n, True, seed)
            want = gemm._gd_ref(x, y, eo, w, b, vw, vb, *_GD_HP,
                                activation="tanh", transposed=True)
        runs = []
        for _ in range(2):
            w1, vw1, b1, vb1 = w.clone(), vw.clone(), b.clone(), vb.clone()
            gemm._gd_dw_cuda(x, eo, y, w1, vw1, 1.0 / m, _GD_HP[0],
                             _GD_HP[2], _GD_HP[4], "tanh", transposed,
                             tile_split, bias=(b1, vb1, *_GD_HP[1::2]))
            runs.append((w1, vw1, b1, vb1))
        same &= all(torch.equal(p, q) for p, q in zip(*runs))
        for name, got_, ref in (("gd_dw w", runs[0][0], want[0]),
                                ("gd_dw vw", runs[0][1], want[2]),
                                ("gd_dw b", runs[0][2], want[1]),
                                ("gd_dw vb", runs[0][3], want[3])):
            if not torch.allclose(got_, ref, atol=tol[0], rtol=tol[1]):
                bad.append(name + (" transposed" if transposed else ""))
    torch.cuda.synchronize()
    return bad, same


@pytest.mark.cuda
@pytest.mark.parametrize("tile_split", GEMM_CONFIGS)
@pytest.mark.parametrize("m,k,n", GEMM_SHAPES + GEMM_SPLIT_SHAPES)
def test_gemm_every_config_matches_plain_version_on_card(
        cuda_device, gemm_launches, m, k, n, tile_split):
    """Each tile and split (the host rule's or not), bit-equal on a
    relaunch; a split of more ranks than K tiles leaves some empty."""
    bad, same = _gemm_config_errors(cuda_device, m, k, n, tile_split,
                                    GEMM_TOL, seed=36)
    assert not bad and same, (bad, same)


@pytest.mark.cuda
@pytest.mark.parametrize("tile_split", GEMM_CONFIGS)
def test_gemm_every_config_at_4096_on_card(cuda_device, gemm_launches,
                                           tile_split):
    bad, same = _gemm_config_errors(cuda_device, 4096, 4096, 4096,
                                    tile_split, GEMM_BIG_TOL, seed=37)
    assert not bad and same, (bad, same)


@pytest.mark.cuda
@pytest.mark.parametrize("activation", GEMM_ACTIVATIONS)
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("tile_split", GEMM_CONFIGS)
@pytest.mark.parametrize("m,k,n", GEMM_SHAPES + GEMM_SPLIT_SHAPES)
def test_gd_dw_bias_sums_follow_the_plan_on_card(
        cuda_device, gemm_launches, m, k, n, tile_split, transposed,
        activation):
    """dw's bias step (batch m, k inputs, n neurons) on every tile and
    split: with inv_batch 1, lr 1, decay 0 and momentum 0, vb comes out
    as minus the kernel's sums of delta, which must equal the plain
    model of their order (``_bias_sum_plan_ref``, delta computed by the
    plain version on the card) bit for bit, twice."""
    from veles_tpu_torch.ops import gemm
    x, y, eo, w, b, vw, vb = _gd_operands(cuda_device, m, k, n, transposed,
                                          seed=45)
    delta = eo * gemm._derivative(y, activation)
    want = gemm._bias_sum_plan_ref(delta, tile_split[1], tile_split[0])
    for _ in range(2):
        vb1 = vb.clone()
        gemm._gd_dw_cuda(x, eo, y, w.clone(), vw.clone(), 1.0, 0.03, 0.0,
                         0.9, activation, transposed, tile_split,
                         bias=(b.clone(), vb1, 1.0, 0.0, 0.0))
        torch.cuda.synchronize()
        assert torch.equal(-vb1, want)
    assert gemm.bias_in_dw == {"gd_db_in_dw": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("activation", GEMM_ACTIVATIONS)
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("m,k,n", GEMM_SPLIT_SHAPES)
def test_gemm_split_epilogues_match_plain_version_on_card(
        cuda_device, gemm_launches, m, k, n, transposed, activation):
    """Every epilogue and activation where the host rule splits K: the
    activation after the rank-order sum, and the momentum update of W
    and V by the one rank that owns each element."""
    from veles_tpu_torch.ops import gemm
    a, w, bias = _gemm_case(cuda_device, m, k, n, seed=38,
                            w_transposed=transposed)
    got = gemm.matmul(a, w, bias, activation)
    want = gemm._matmul_ref(a, w, bias, activation)
    args = _gd_operands(cuda_device, m, k, n, transposed, seed=39)
    flags = dict(activation=activation, transposed=transposed)
    want_gd = gemm._gd_ref(*args, *_GD_HP, **flags)
    got_gd = gemm.gd_fused(*args, *_GD_HP, **flags)
    torch.cuda.synchronize()
    dw_shape = (n, k, m) if transposed else (k, n, m)
    assert gemm.split_launches == {
        "matmul_split": 1, "gd_dx_split": int(gemm.plan(m, k, n)[1] > 1),
        "gd_dw_split": int(gemm.plan(*dw_shape)[1] > 1)}
    torch.testing.assert_close(got, want, atol=GEMM_TOL[0],
                               rtol=GEMM_TOL[1])
    for name, g, w_ in zip(("w", "b", "vw", "vb", "err_input"), got_gd,
                           want_gd):
        torch.testing.assert_close(g, w_, atol=GEMM_TOL[0],
                                   rtol=GEMM_TOL[1], msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(100, 784, 100), (37, 70, 50)])
def test_gemm_reads_a_strided_x_on_card(cuda_device, gemm_launches, m, k,
                                        n):
    """x as a view (row stride 2k + 3, every other column) for matmul's
    a and for gd_dw's x: masked scalar staging, same results."""
    from veles_tpu_torch.ops import gemm
    a, w, bias = _gemm_case(cuda_device, m, k, n, seed=40, x_strided=True)
    torch.testing.assert_close(gemm.matmul(a, w, bias, "tanh"),
                               gemm._matmul_ref(a, w, bias, "tanh"),
                               atol=GEMM_TOL[0], rtol=GEMM_TOL[1])
    _x, y, eo, w, b, vw, vb = _gd_operands(cuda_device, m, k, n, False,
                                           seed=41)
    want = gemm._gd_ref(a, y, eo, w, b, vw, vb, *_GD_HP, activation="tanh")
    got = gemm.gd_fused(a, y, eo, w, b, vw, vb, *_GD_HP, activation="tanh")
    torch.cuda.synchronize()
    for name, g, w_ in zip(("w", "b", "vw", "vb", "err_input"), got, want):
        torch.testing.assert_close(g, w_, atol=GEMM_TOL[0],
                                   rtol=GEMM_TOL[1], msg=name)


@pytest.mark.cuda
def test_gemm_split_launch_replays_in_a_cuda_graph_on_card(cuda_device,
                                                            gemm_launches):
    """Layer 1's forward (split 8) and dw (split 4), captured as cluster
    launches into one graph: a replay gives the eager call's bits."""
    from veles_tpu_torch.ops import gemm
    a, w, bias = _gemm_case(cuda_device, 100, 784, 100, seed=42)
    x, y, eo, w1, _b, vw1, _vb = _gd_operands(cuda_device, 100, 784, 100,
                                              False, seed=43)
    eager = gemm.matmul(a, w, bias, "tanh")
    w_eager, vw_eager = w1.clone(), vw1.clone()
    gemm._gd_dw_cuda(x, eo, y, w_eager, vw_eager, 0.01, *_GD_HP[0:5:2],
                     "tanh", False)
    torch.cuda.synchronize()
    w_graph, vw_graph = w1.clone(), vw1.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = gemm.matmul(a, w, bias, "tanh")
        gemm._gd_dw_cuda(x, eo, y, w_graph, vw_graph, 0.01,
                         *_GD_HP[0:5:2], "tanh", False)
    out.zero_()
    w_graph.copy_(w1)
    vw_graph.copy_(vw1)
    graph.replay()
    torch.cuda.synchronize()
    assert gemm.plan(100, 100, 784) == (gemm.SPLIT_TILE, 8)
    assert gemm.plan(784, 100, 100) == (gemm.SPLIT_TILE, 4)
    assert torch.equal(out, eager)
    assert torch.equal(w_graph, w_eager) and torch.equal(vw_graph, vw_eager)


@pytest.mark.cuda
def test_gemm_body_follows_the_plan_on_card(cuda_device, gemm_launches):
    """The split tile at layer 1's shape and the big tile at 4096^3, by
    the kernels' names in a profile: ``veles_gemm_kernel<KIND, TILE>``.
    The profiler may record none of a window's ctypes launches, so a
    window that saw no GEMM kernel is profiled again, up to three times;
    every kernel it does see must be the planned body."""
    from veles_tpu_torch.ops import gemm
    for size, tile in (((100, 784, 100), 0), ((4096, 4096, 4096), 1)):
        a, w, bias = _gemm_case(cuda_device, *size, seed=44)

        def run():
            for _ in range(8):
                out = gemm.matmul(a, w, bias, "tanh")
            return out.sum()
        for _ in range(3):
            names = _profiled_kernel_names(run, "veles_gemm_kernel")
            if names:
                break
        assert names and all("veles_gemm_kernel<0, %d>" % tile in name
                             for name in names), names


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
@pytest.mark.parametrize("per_feature", [False, True])
def test_gather_group_matches_plain_version_on_card(
        cuda_device, gather_launches, per_feature):
    """Every table kind in one launch: MNIST's f32 data (16-byte words),
    its u8 data normalized, int32 labels padded with -1 (4-byte words)
    and rows of 13 u8 (bytes), all over one index vector with negative
    and out-of-range indices; each output equals its plain version."""
    from veles_tpu_torch.ops import gather
    data, idx = _gather_operands(cuda_device, torch.float32, (7000, 784))
    raw, _ = _gather_operands(cuda_device, torch.uint8, (7000, 784), seed=41)
    labels, _ = _gather_operands(cuda_device, torch.int32, (7000,), seed=42)
    odd, _ = _gather_operands(cuda_device, torch.uint8, (7000, 13), seed=43)
    rng = numpy.random.default_rng(44)
    norm = gather.affine_tensors(
        (rng.uniform(0.5, 2.0, 784), rng.standard_normal(784))
        if per_feature else (1.0 / 255.0, 0.0), cuda_device)
    tables = [(data, 0), (raw, norm), (labels, -1), (odd, 7)]
    got = gather.take_rows_group(tables, idx)
    want = gather._gather_group_ref(tables, idx)
    torch.cuda.synchronize()
    assert gather_launches == {"gather": 0, "gather_norm": 1}
    assert gather.tables_served == {"gather_tables": 3,
                                    "gather_norm_tables": 1}
    for g, w_ in zip(got, want):
        assert g.dtype == w_.dtype and torch.equal(g, w_)
    # without the normalized table: one launch under "gather"
    got = gather.take_rows_group([tables[0], tables[2]], idx)
    torch.cuda.synchronize()
    assert gather_launches == {"gather": 1, "gather_norm": 1}
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[2])


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
    captured buffer and the outputs overwritten: each replay gathers the
    new rows and writes every row, pad rows included."""
    from veles_tpu_torch.ops import gather
    data, idx = _gather_operands(cuda_device, torch.uint8, (7000, 784))
    labels, _ = _gather_operands(cuda_device, torch.int32, (7000,), seed=44)
    norm = gather.affine_tensors((1.0 / 255.0, 0.0), cuda_device)
    gather.take_rows_norm(data, idx, norm)        # load the library
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        rows = gather.take_rows(data, idx)
        normed = gather.take_rows_norm(data, idx, norm)
        grouped = gather.take_rows_group([(data, norm), (labels, -1)], idx)
    for seed in (42, 43):
        _, new = _gather_operands(cuda_device, torch.uint8, (7000, 784),
                                  seed=seed)
        idx.copy_(new)
        for out in [rows, normed] + grouped:
            out.fill_(7)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(rows, gather._gather_ref(data, idx))
        assert torch.equal(normed,
                           gather._gather_norm_ref(data, idx, *norm))
        assert torch.equal(grouped[0], normed)
        assert torch.equal(grouped[1], gather._gather_ref(labels, idx, -1))


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


#: (offset, size) of the served launch over a 7000-row shuffled buffer, 100
#: rows: a whole batch, a short tail, one row, none, the buffer's last
#: row, a batch past the buffer's end, an offset at its end
SERVED_SPANS = [(0, 100), (940, 60), (3, 1), (500, 0), (6999, 1),
                (6960, 100), (7000, 100)]


def _served_operands(device, kind, seed=50):
    """The tables of one served launch (``kind``: the native head's u8
    data normalized, the f32 dataset's raw data, an int32 table
    normalized per feature; each with int32 labels) and a shuffled
    7000-row buffer."""
    from veles_tpu_torch.ops import gather
    rng = numpy.random.default_rng(seed)
    dtype = {"u8_norm": torch.uint8, "f32_raw": torch.float32,
             "int32_norm": torch.int32}[kind]
    data, _ = _gather_operands(device, dtype, (7000, 784), seed=seed)
    labels, _ = _gather_operands(device, torch.int32, (7000,), seed=seed + 1)
    how = 0 if kind == "f32_raw" else gather.affine_tensors(
        (1.0 / 255.0, 0.0) if kind == "u8_norm"
        else (rng.uniform(0.5, 2.0, 784), rng.standard_normal(784)), device)
    shuffled = torch.from_numpy(rng.permutation(7000).astype(
        numpy.int32)).to(device)
    return [(data, how), (labels, -1)], shuffled


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["u8_norm", "f32_raw", "int32_norm"])
@pytest.mark.parametrize("offset,size", SERVED_SPANS)
def test_gather_served_matches_plain_version_on_card(
        cuda_device, gather_launches, kind, offset, size):
    """One served launch (the index computed in it from the shuffled
    buffer and 0-d int32 scalars of one device block) against
    ``_gather_served_ref``, bit for bit; counted under the group's key
    and its own entry."""
    from veles_tpu_torch.ops import gather
    tables, shuffled = _served_operands(cuda_device, kind)
    block = torch.tensor([offset, size], dtype=torch.int32,
                         device=cuda_device)
    got = gather.take_rows_served(tables, shuffled, block[0], block[1], 100)
    want = gather._gather_served_ref(tables, shuffled, block[0], block[1],
                                     100)
    torch.cuda.synchronize()
    norm = kind != "f32_raw"
    assert gather_launches == {"gather": int(not norm),
                               "gather_norm": int(norm)}
    assert gather.entry_launches == {"veles_gather_group": 0,
                                     "veles_gather_served": 1}
    for g, w_ in zip(got, want):
        assert g.dtype == w_.dtype and torch.equal(g, w_)
    assert (got[1][size:] == -1).all()


@pytest.mark.cuda
def test_gather_served_reads_its_scalars_at_replay_on_card(
        cuda_device, gather_launches):
    """Captured once at one (offset, size); each replay after the
    scalars are rewritten in place, over outputs filled with 7, serves
    the new span: the launch reads them on the device."""
    from veles_tpu_torch.ops import gather
    tables, shuffled = _served_operands(cuda_device, "u8_norm")
    block = torch.tensor(SERVED_SPANS[0], dtype=torch.int32,
                         device=cuda_device)
    gather.take_rows_served(tables, shuffled, block[0], block[1], 100)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = gather.take_rows_served(tables, shuffled, block[0], block[1],
                                       100)
    for span in SERVED_SPANS[::-1]:
        block.copy_(torch.tensor(span, dtype=torch.int32))
        for out in outs:
            out.fill_(7)
        graph.replay()
        want = gather._gather_served_ref(tables, shuffled, block[0],
                                         block[1], 100)
        torch.cuda.synchronize()
        for g, w_ in zip(outs, want):
            assert torch.equal(g, w_), span


@pytest.mark.cuda
def test_gather_served_wrapper_raises_on_the_card(cuda_device,
                                                  gather_launches):
    from veles_tpu_torch.ops import gather
    tables, shuffled = _served_operands(cuda_device, "u8_norm")
    at = torch.tensor(0, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="mixed devices"):
        gather.take_rows_served(tables, shuffled, at,
                                torch.tensor(5, dtype=torch.int32), 100)
    with pytest.raises(ValueError, match="size as a 0-d int32"):
        gather.take_rows_served(tables, shuffled, at, at.long(), 100)
    with pytest.raises(ValueError, match="int32 indices"):
        gather.take_rows_served(tables, shuffled.long(), at, at, 100)
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
             (300, 256, 192, torch.float32)] + [
    # the tensor-core body (bf16 at M > 16): ragged M, K and N, rows of a
    # 200 bytes long (ordinary loads), one column or a ragged 100 of q
    (m, 100, n, torch.bfloat16) for m in (17, 33, 100, 2048) for n in (1, 100)]
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


def _qmm_variant(a, q, bias, variant):
    """The operands of one layout variant of the tensor-core body: a as
    columns of wider rows (lda > K: 16-byte aligned, or 2 bytes off),
    bias in f32 or none, q 1 byte past a 16-byte boundary."""
    m, k = a.shape
    if variant in ("lda", "lda_unaligned"):
        off = 1 if variant == "lda_unaligned" else 0
        lda = -(-k // 8) * 8 + 16           # a whole number of chunks
        wide = torch.zeros((m, lda), dtype=a.dtype, device=a.device)
        wide[:, off:off + k] = a
        a = wide[:, off:off + k]
    if variant == "bias_f32":
        bias = bias.float()
    if variant == "no_bias":
        bias = None
    if variant == "q_unaligned":
        flat = torch.zeros(q.numel() + 1, dtype=torch.int8, device=q.device)
        flat[1:] = q.reshape(-1)
        q = flat[1:].view(q.shape)
    return a, q, bias


@pytest.mark.cuda
@pytest.mark.parametrize("activation", QMM_ACTIVATIONS)
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("variant", ["lda", "lda_unaligned", "bias_f32",
                                     "no_bias", "q_unaligned"])
@pytest.mark.parametrize("m,k,n", [(33, 1024, 1024), (2048, 100, 100),
                                   (2048, 1024, 1024)])
def test_qmatmul_tensor_core_body_layouts_on_card(
        cuda_device, m, k, n, variant, out_dtype, activation):
    """The tensor-core body over every layout it takes: cp.async or
    ordinary loads of a and of q, bias f32, bf16 or none, f32 or bf16
    output, with and without a split K."""
    from veles_tpu_torch.ops import qgemm
    a, q, scale, bias = _qmm_operands(cuda_device, m, k, n, torch.bfloat16,
                                      44)
    a, q, bias = _qmm_variant(a, q, bias, variant)
    assert (a.data_ptr() % 16 == 2) == (variant == "lda_unaligned")
    assert (q.data_ptr() % 16 == 1) == (variant == "q_unaligned")
    qgemm.reset_launches()
    got = qgemm.qmatmul(a, q, scale, bias, activation, out_dtype)
    want = qgemm._qmatmul_ref(a, q, scale, bias, activation, out_dtype)
    torch.cuda.synchronize()
    assert qgemm.launches["qmatmul"] == 1 and got.dtype == out_dtype
    err = float((got.float() - want.float()).abs().max())
    tol = F32_TOL * float(want.float().abs().max()) \
        if out_dtype == torch.float32 else BF16_TOL
    assert err <= tol, (err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(2048, 1024, 1024), (2048, 1024, 4096),
                                   (256, 1024, 1024)])
def test_qmatmul_tensor_core_body_relaunch_is_bit_equal_on_card(
        cuda_device, m, k, n):
    """No atomics and a fixed order, split or not: a relaunch gives the
    same bits."""
    from veles_tpu_torch.ops import qgemm
    a, q, scale, bias = _qmm_operands(cuda_device, m, k, n, torch.bfloat16,
                                      45)
    first = qgemm.qmatmul(a, q, scale, bias, "gelu")
    again = qgemm.qmatmul(a, q, scale, bias, "gelu")
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.cuda
def test_qmatmul_body_follows_the_dtype_and_m_on_card(cuda_device):
    """bf16 at M > 16 runs the tensor-core body (``qmatmul_kernel_tc<``),
    bf16 at M <= 16 the decode body (``qmatmul_kernel_dec<``), f32 at any
    M the FMA body (``qmatmul_kernel<``): the kernels' names as a profile
    records them.  A profile of one such launch has seen none of it, so
    each shape runs 4 times in the window; at least one must be seen,
    and every one seen must be the body's."""
    from veles_tpu_torch.ops import qgemm
    for m, dtype, tag in ((4, torch.bfloat16, "qmatmul_kernel_dec<4, "),
                          (16, torch.bfloat16, "qmatmul_kernel_dec<16, "),
                          (4, torch.float32, "qmatmul_kernel<16>"),
                          (20, torch.float32, "qmatmul_kernel<64>"),
                          (17, torch.bfloat16, "qmatmul_kernel_tc<"),
                          (2048, torch.bfloat16, "qmatmul_kernel_tc<")):
        a, q, scale, bias = _qmm_operands(cuda_device, m, 256, 192, dtype, 46)

        def run():
            return [qgemm.qmatmul(a, q, scale, bias).float().sum()
                    for _ in range(4)]
        names = _profiled_kernel_names(run)
        ours = [n for n in names if "qmatmul_kernel" in n]
        assert ours and all(tag in n for n in ours), (m, dtype, names)


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


#: shapes of the reduce kernel's plans: the ops API's (4096, 4096) (axis 0
#: split 8), a ragged strip and a ragged split, one strip (4096, 64),
#: rows that are not 16-byte aligned (37, 53), one row, one column
REDUCE_PLAN_SHAPES = [(4096, 4096), (1000, 1030), (4096, 64), (37, 53),
                      (1, 5000), (5000, 1)]


def _reduce_specials(shape, seed):
    a = numpy.random.default_rng(seed).standard_normal(shape).astype(
        numpy.float32)
    if min(shape) > 1:
        m, n = shape
        a[0, -1], a[-1, 0], a[m // 2, n // 2] = numpy.inf, -numpy.inf, \
            numpy.nan
        a[m // 3, :] = numpy.inf
    return a


def _same_bits(got, want):
    """Equal values (±0 alike) with NaN at the same places."""
    g, w = got.float().cpu(), want.float().cpu()
    nan = torch.isnan(w)
    return bool(torch.equal(torch.isnan(g), nan)
                and torch.equal(g[~nan], w[~nan]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", REDUCE_PLAN_SHAPES)
@pytest.mark.parametrize("axis", [0, 1])
def test_reduce_kernel_follows_its_plan_at_every_split(cuda_device, axis,
                                                       shape, dtype):
    """At every split the kernel gives the bits of its plain model
    (``_reduce_plan_ref``: its order of the sum, fmax / fmin with NaN
    flags), on a relaunch too, and agrees with ``_reduce_ref``."""
    from veles_tpu_torch.ops import reduce
    t = torch.from_numpy(_reduce_specials(shape, 44)).to(cuda_device, dtype)
    for split in (1, 2, 4, 8):
        launch = reduce.launch_plan(t, axis, split)
        for op in ("sum", "max", "min"):
            got = reduce._reduce_cuda(t, axis, op, split)
            again = reduce._reduce_cuda(t, axis, op, split)
            torch.cuda.synchronize()
            assert _same_bits(got, again)
            assert _same_bits(got, reduce._reduce_plan_ref(t, axis, op,
                                                           launch)), \
                (split, op)
            if op != "sum":
                assert _same_bits(got, reduce._reduce_ref(t, axis, op))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("view", ["wide_aligned", "wide_odd", "column_off",
                                  "row_off"])
@pytest.mark.parametrize("axis", [0, 1])
def test_reduce_kernel_on_strided_views(cuda_device, axis, view, dtype):
    """Views with a row stride ``lda > n``, 16-byte aligned (1032) or not
    (1031), and starting one column or one row in: the vector path where
    every row starts aligned, the scalar one elsewhere; the model's bits
    and ``_reduce_ref``'s values either way."""
    from veles_tpu_torch.ops import reduce
    wide = {cols: torch.from_numpy(_reduce_specials((300, cols), 45)).to(
        cuda_device, dtype) for cols in (1031, 1032)}
    t = {"wide_aligned": wide[1032][:, :1000],
         "wide_odd": wide[1031][:, :1000],
         "column_off": wide[1032][:, 1:1025],
         "row_off": wide[1032][1:, :1024]}[view]
    launch = reduce.launch_plan(t, axis)
    assert (launch.vec > 1) == (view in ("wide_aligned", "row_off"))
    for op in ("sum", "max", "min"):
        got = reduce.matrix_reduce(t, axis, op, use_pallas=True)
        assert _same_bits(got, reduce._reduce_plan_ref(t, axis, op, launch))
        ref = reduce._reduce_ref(t, axis, op)
        if op != "sum":
            assert _same_bits(got, ref)
            continue
        ref, g = ref.float().cpu(), got.float().cpu()
        ok = torch.isfinite(ref)
        scale = t.float().cpu().nan_to_num(0.0, 0.0, 0.0).abs().sum(axis)
        tol = 1e-6 * scale + (2.0 ** -8 * ref.abs()
                              if dtype == torch.bfloat16 else 0.0)
        assert bool(((g - ref).abs()[ok] <= tol[ok]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,low,high", [((1000,), 0.0, 1.0),
                                            ((257, 33), -2.0, 3.0),
                                            ((3,), 0.1, 0.3),
                                            ((4098,), -1.0, 1.0),
                                            ((1025, 1023), 0.0, 1.0)])
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


# -- the decode kernels' cluster split over the keys -------------------------
# Each (batch, head) row's keys are split over a cluster of 1, 2, 4 or 8
# blocks (``decode_split`` by default; the wrappers take a forced split),
# rank r taking ``key_range(r, split, kend)``; tolerances as above.

#: lengths around the 32-key chunks and the ranks' edges at a 2048-key
#: cache (2048 keys are 64 chunks: 8 a rank at split 8); a length of 1
#: leaves every rank but the last empty
SPLIT_LENGTHS = [1, 31, 32, 33, 255, 256, 257, 2047, 2048]


def _split_operands(device, dtype, nq, row_step, d, seed, h=2):
    b, seq = len(SPLIT_LENGTHS), 2048
    q, k, v = (torch.from_numpy(a).to(device, dtype) for a in _arrays(
        [(b, nq, h, d), (b, seq, h, d), (b, seq, h, d)], seed,
        uniform_last=True))
    lengths = [min(n, seq - row_step * (nq - 1)) for n in SPLIT_LENGTHS]
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    return q, k, v, lens


def test_a_length_of_one_leaves_all_ranks_but_one_empty():
    ranges = [port.key_range(r, 8, 1) for r in range(8)]
    assert [end - begin for begin, end in ranges] == [0] * 7 + [1]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("d", [32, 64, 100, 128])
@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("nq,row_step", [(1, 0), (8, 1)])
def test_decode_split_matches_plain_version_on_card(
        cuda_device, launches, nq, row_step, split, d, dtype, tol):
    """Every forced split, lengths at chunk and rank edges, head dims of
    each template (100: the ordinary loads), and a relaunch bit-equal."""
    q, k, v, lens = _split_operands(cuda_device, dtype, nq, row_step, d,
                                    seed=70 + d + nq)
    out = port._decode_cuda(q, k, v, lens, row_step, split)
    again = port._decode_cuda(q, k, v, lens, row_step, split)
    ref = (port._verify_ref if row_step else port._decode_ref)(q, k, v,
                                                               lens)
    torch.cuda.synchronize()
    assert launches["decode_attn"] == 2
    assert torch.equal(out, again)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("nq", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("row_step", [0, 1])
def test_decode_split_every_row_count_on_card(cuda_device, launches, nq,
                                              row_step):
    """1 to 8 query rows, decode and verify masks, at the default
    split."""
    q, k, v, lens = _split_operands(cuda_device, torch.bfloat16, nq,
                                    row_step, 64, seed=90 + nq)
    out = port.decode_attention(q, k, v, lens, row_step=row_step)
    ref = (port._verify_ref if row_step else port._decode_ref)(q, k, v,
                                                               lens)
    torch.cuda.synchronize()
    assert launches["decode_attn"] == 1
    torch.testing.assert_close(out.float(), ref.float(), atol=BF16_TOL,
                               rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq,row_step", [(1, 0), (5, 1)])
def test_paged_split_equals_contiguous_split_on_card(
        cuda_device, launches, nq, row_step, dtype, split):
    """At every split a pool that mirrors a contiguous cache (pages
    shuffled, garbage 1e4 in the trash block and in every key past each
    row's length) gives the contiguous kernel's output bit for bit."""
    bs, max_blocks, h, d = 16, 128, 2, 64
    q, k, v, lens = _split_operands(cuda_device, dtype, nq, row_step, d,
                                    seed=110 + nq)
    b = q.shape[0]
    limit = (torch.arange(max_blocks * bs, device=cuda_device)[None, :]
             >= (lens + row_step * (nq - 1))[:, None])
    k_dirty, v_dirty = k.clone(), v.clone()
    k_dirty[limit], v_dirty[limit] = 1e4, 1e4
    rng = numpy.random.default_rng(120 + nq)
    tables = torch.from_numpy(rng.permutation(numpy.arange(
        1, b * max_blocks + 1)).reshape(b, max_blocks).astype(
            numpy.int32)).to(cuda_device)
    kp = torch.full((b * max_blocks + 1, bs, h, d), 1e4, dtype=dtype,
                    device=cuda_device)
    vp = kp.clone()
    kp[tables.long()] = k_dirty.reshape(b, max_blocks, bs, h, d)
    vp[tables.long()] = v_dirty.reshape(b, max_blocks, bs, h, d)
    paged = port._paged_decode_cuda(q, kp, vp, tables, lens, row_step,
                                    split)
    contiguous = port._decode_cuda(q, k, v, lens, row_step, split)
    torch.cuda.synchronize()
    assert launches["paged_decode_attn"] == launches["decode_attn"] == 1
    assert torch.equal(paged, contiguous)


@pytest.mark.cuda
def test_decode_split_is_checked_before_launch_on_card(cuda_device,
                                                      launches):
    q, k, v, lens = _split_operands(cuda_device, torch.float32, 1, 0, 8,
                                    seed=3)
    with pytest.raises(ValueError, match="1, 2, 4 or 8"):
        port._decode_cuda(q, k, v, lens, 0, 3)
    assert not any(launches.values())


# -- qmatmul's decode body (bf16 at M <= 16) ----------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("m", list(range(1, 17)))
@pytest.mark.parametrize("k,n", [(1000, 130), (64, 1), (4096, 1024),
                                 (200, 3072)])
def test_qmatmul_decode_body_every_m_on_card(cuda_device, m, k, n):
    """M 1 to 16 (the three row templates), ragged K and N (N % 16 != 0:
    ordinary q loads), a bias and gelu, each relaunch bit-equal."""
    from veles_tpu_torch.ops import qgemm
    a, q, scale, bias = _qmm_operands(cuda_device, m, k, n, torch.bfloat16,
                                      50 + m)
    qgemm.reset_launches()
    got = qgemm.qmatmul(a, q, scale, bias, "gelu")
    again = qgemm.qmatmul(a, q, scale, bias, "gelu")
    want = qgemm._qmatmul_ref(a, q, scale, bias, "gelu")
    torch.cuda.synchronize()
    assert qgemm.launches["qmatmul"] == 2 and torch.equal(got, again)
    err = float((got.float() - want.float()).abs().max())
    assert err <= BF16_TOL, err


@pytest.mark.cuda
@pytest.mark.parametrize("activation", QMM_ACTIVATIONS)
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_qmatmul_decode_body_every_activation_on_card(
        cuda_device, activation, with_bias, out_dtype):
    from veles_tpu_torch.ops import qgemm
    a, q, scale, bias = _qmm_operands(cuda_device, 4, 1024, 3072,
                                      torch.bfloat16, 51)
    bias = bias if with_bias else None
    got = qgemm.qmatmul(a, q, scale, bias, activation, out_dtype)
    want = qgemm._qmatmul_ref(a, q, scale, bias, activation, out_dtype)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tol = F32_TOL * float(want.float().abs().max()) \
        if out_dtype == torch.float32 else BF16_TOL
    assert got.dtype == out_dtype and err <= tol, (err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["lda", "lda_unaligned", "bias_f32",
                                     "q_unaligned"])
@pytest.mark.parametrize("m,k,n", [(4, 1024, 1024), (13, 200, 96)])
def test_qmatmul_decode_body_layouts_on_card(cuda_device, m, k, n,
                                             variant):
    """a with a wider row stride (aligned, or 2 bytes off: ordinary
    loads), an f32 bias, q 1 byte past a 16-byte boundary."""
    from veles_tpu_torch.ops import qgemm
    a, q, scale, bias = _qmm_operands(cuda_device, m, k, n, torch.bfloat16,
                                      52)
    a, q, bias = _qmm_variant(a, q, bias, variant)
    got = qgemm.qmatmul(a, q, scale, bias, "tanh")
    want = qgemm._qmatmul_ref(a, q, scale, bias, "tanh")
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    assert err <= BF16_TOL, err


@pytest.mark.cuda
@pytest.mark.parametrize("block_n", [128, 64])
@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("m,k,n", [(4, 4096, 1024), (16, 1024, 3072),
                                   (7, 100, 130)])
def test_qmatmul_decode_body_every_plan_on_card(cuda_device, m, k, n,
                                                split, block_n):
    """Every column tile and forced split (at K = 100 a split of 4 or 8
    leaves ranks without K rows), each relaunch bit-equal."""
    from veles_tpu_torch.ops import qgemm
    a, q, scale, bias = _qmm_operands(cuda_device, m, k, n, torch.bfloat16,
                                      53)
    plan = (block_n, split)
    got = qgemm._qmatmul_cuda(a, q, scale, bias, None, torch.bfloat16, plan)
    again = qgemm._qmatmul_cuda(a, q, scale, bias, None, torch.bfloat16,
                                plan)
    want = qgemm._qmatmul_ref(a, q, scale, bias)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    err = float((got.float() - want.float()).abs().max())
    assert err <= BF16_TOL, err


# -- epoch-scan windows and the prefetch ring on the card -----------------------

class _StageUnit(object):
    """The unit a hand-made stage names."""
    name = "served_probe"


@pytest.mark.cuda
def test_window_graph_serves_each_new_span_after_its_blocks_are_rewritten(
        cuda_device, gather_launches):
    """A 3-step window of the served launch (its rows summed as the
    window's metric): run eagerly, captured, then replayed with other
    spans written into its stacked block.  Each run's last rows equal
    the plain version's at its last span, and its accumulator the sum
    over its three spans: every step read its own row at replay."""
    from veles_tpu_torch.backends import CUDADevice
    from veles_tpu_torch.epoch_scan import ScanPlan, WindowGraph
    from veles_tpu_torch.memory import Vector
    from veles_tpu_torch.ops import gather
    from veles_tpu_torch.stitch import StitchStage
    tables, shuffled = _served_operands(cuda_device, "u8_norm")
    (data, norm), (labels, _pad) = tables
    device = CUDADevice(cuda_device)
    vecs = {"indices": Vector(shuffled.cpu().numpy()),
            "src": Vector(data.cpu().numpy()),
            "lbl": Vector(labels.cpu().numpy())}
    rows_vec = Vector(numpy.zeros((100, 784), numpy.float32))
    for vec in list(vecs.values()) + [rows_vec]:
        vec.initialize(device)
    span = [0, 0]

    def fn(t):
        rows, _lbl = gather.take_rows_served(
            [(t["src"], norm), (t["lbl"], -1)], t["indices"], t["offset"],
            t["size"], 100)
        return {"rows": rows, "total": rows.sum()}

    stage = StitchStage(_StageUnit(), fn, produces={"rows": rows_vec},
                        params=vecs, metrics=("total",),
                        scalars=lambda: {"offset": span[0],
                                         "size": span[1]})
    plan = ScanPlan([stage])
    window = WindowGraph(plan, 3, cuda_device, accum_index=0)
    runs = [[(0, 100), (940, 60), (3, 1)],
            [(6999, 1), (500, 0), (100, 100)],
            [(7000, 100), (6960, 100), (200, 7)],
            [(1000, 100), (1100, 100), (1200, 100)]]
    for spans in runs:
        rows = []
        for at, size in spans:
            span[:] = [at, size]
            rows.append(plan.fetch_scalars())
        accum, _lasts, _verdict = window.execute(rows, None)
        want = [gather._gather_served_ref(
            tables, shuffled, torch.tensor(at, dtype=torch.int32,
                                           device=cuda_device),
            torch.tensor(size, dtype=torch.int32, device=cuda_device),
            100)[0] for at, size in spans]
        total = torch.stack([w.sum() for w in want]).sum()
        torch.cuda.synchronize()
        assert torch.equal(rows_vec.devmem, want[-1]), spans
        assert float(accum) == float(total), spans
    graph = window.graph
    assert (window.runs, graph.captures, graph.replays,
            graph.recaptures) == (4, 1, 3, 0)
    assert graph.launches["veles_gather_served"] == 3
    # 3 eager launches, then 3 a replay
    assert gather_launches["gather_norm"] == 12


@pytest.mark.cuda
def test_per_step_replay_after_a_window_does_not_recapture(cuda_device):
    """The stitched MNIST route: per-step (its segment graphs captured),
    then windows, then per-step again, then windows again.  No segment
    and no window recaptures (the window writes the segments' captured
    output buffers, it does not rebind them), and the weights equal a
    run that was per-step throughout, bit for bit."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.samples import mnist
    eng = root.common.engine
    saved = {k: eng.get(k) for k in ("stitch", "loader", "epoch_scan")}
    try:
        eng.stitch, eng.loader = "on", "auto"

        def fresh():
            prng.seed_all(3)
            return mnist.create_workflow(device=cuda_device, max_epochs=2,
                                         native=True)
        mixed = fresh()
        for epochs, mode in ((2, "off"), (4, "auto"), (5, "off"),
                             (7, "auto")):
            eng.epoch_scan = mode
            mixed.decision.complete <<= False
            mixed.decision.max_epochs = epochs
            mixed.run()
        eng.epoch_scan = "off"
        ref = fresh()
        ref.decision.max_epochs = 7
        ref.run()
        torch.cuda.synchronize()
        report = mixed.epoch_scan_report()
        assert report["windows"] > 0
        assert all(g["captures"] == 1 and g["recaptures"] == 0
                   for g in report["graphs"].values())
        assert all(r["captures"] == 1 and r["recaptures"] == 0
                   for r in mixed.stitch_report())
        got, want = mixed.params_to_numpy(), ref.params_to_numpy()
        for name in want:
            numpy.testing.assert_array_equal(got[name], want[name], name)
        assert [h["n_err"] for h in mixed.decision.history] == \
            [h["n_err"] for h in ref.decision.history]
    finally:
        for key, value in saved.items():
            setattr(eng, key, value)


@pytest.mark.cuda
def test_staging_ring_reuses_no_slot_whose_copy_is_in_flight(cuda_device):
    """A slot's upload queued behind a long spin on the ring's side
    stream: acquiring that slot again waits for the copy, so the values
    written into it afterwards never reach the uploaded tensor."""
    from veles_tpu_torch.backends import CUDADevice
    from veles_tpu_torch.memory import StagingRing
    device = CUDADevice(cuda_device)
    ring = StagingRing((1024, 1024), numpy.float32, depth=2, pin=True)
    first = ring.acquire()
    first[...] = 1.0
    ring.upload(device, first).take()           # makes the side stream
    stream = next(iter(ring._streams.values()))
    second = ring.acquire()
    second[...] = 2.0
    with torch.cuda.stream(stream):
        torch.cuda._sleep(200_000_000)          # ~0.1 s on the side stream
    staged = ring.upload(device, second)
    assert not staged.event.query()             # the copy waits
    third = ring.acquire()                      # slot 0: its copy is done
    fourth = ring.acquire()                     # slot 1: waits for its copy
    assert fourth is second and staged.event.query()
    fourth[...] = 4.0
    got = staged.take()
    torch.cuda.synchronize()
    assert third is first
    assert bool((got == 2.0).all())
