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
"""

import numpy
import pytest
import torch

from veles_tpu_torch.ops import attention as port
from veles_tpu_torch.ops.util import on_gpu

F32_TOL = 1e-4
BF16_TOL = 2e-2


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
    assert launches == {"flash_fwd": 0, "decode_attn": 0}
