"""The port's one-launch minibatch gather (``ops.gather.take_rows_group``)
and the two loader routes that use it, against the JAX package, on the
CPU.

On the CPU the group takes its plain version, ``_gather_group_ref``:
``_gather_ref`` / ``_gather_norm_ref`` table by table.  Held here, on
the same numpy inputs:

- every table of a group against ``_gather_jnp`` / ``_gather_norm_jnp``
  (u8, f32 and int32 tables; rows of 784 and (3, 9, 9) elements; pads 0
  and -1; scalar and per-feature affines; negative indices and one past
  the table, which the port pads as it pads a negative one: its JAX
  reference is then taken on the index -1): raw tables exact, the
  normalized one exact against the port's own ``take_rows_norm`` and
  within 1e-6 of |x·scale| + |shift| of JAX's (XLA may fuse the
  multiply-add into one rounding, as ``tests/test_torch_stitch.py``
  says);
- the wrapper contract of the kernel route (at most four tables, one
  normalized, int32 indices, contiguous tables, scale and shift sizes),
  checked before any launch;
- the served rows (``take_rows_served``, the stitched head's one
  launch): its plain version ``_gather_served_ref`` against the JAX
  head's stage function at the same shuffled buffer, offsets and sizes
  (a short tail, size 0, the buffer's last row), for the native u8 head
  and the f32-dataset head, exactly; its out-of-range rule (a row past
  ``size`` or past the shuffled buffer, a served index past the table:
  pad rows) against a numpy model; and its wrapper contract (0-d int32
  scalars on the buffer's device) checked before any launch;
- both loader routes, each minibatch made by ONE gather call: the eager
  fill (``engine.stitch=off``, one ``take_rows_group``) against the JAX
  loader's fill, and the stitched head's stage function (native u8
  data, scale 1/255; one ``take_rows_served``) against the JAX head's at
  the same offsets and sizes, short tails included: minibatch data and
  labels exactly.

The kernel itself runs only on the card (``tests/test_torch_kernels.py``,
``cuda`` marker; ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu import prng as jax_prng
from veles_tpu.backends import CPUDevice as JaxCPUDevice
from veles_tpu.config import root as jax_root
from veles_tpu.ops import gather as jax_gather
from veles_tpu.samples import mnist as jax_mnist
from veles_tpu_torch import prng
from veles_tpu_torch.config import root
from veles_tpu_torch.loader import fullbatch
from veles_tpu_torch.ops import gather
from veles_tpu_torch.samples import mnist

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

SEED = 7
NORM_RTOL = 1e-6
ROWS = [(784,), (3, 9, 9)]
DTYPES = ["uint8", "float32", "int32"]


def _table(dtype, row, n=23, seed=0):
    """A table and 11 int32 indices: three -1 (one at the end) and one
    past the table."""
    rng = numpy.random.default_rng(seed)
    if dtype == "uint8":
        data = rng.integers(0, 256, (n,) + row)
    elif dtype == "int32":
        data = rng.integers(-2 ** 20, 2 ** 20, (n,) + row)
    else:
        data = rng.standard_normal((n,) + row)
    idx = rng.integers(0, n, 11).astype(numpy.int32)
    idx[[2, 7, 10]] = -1
    idx[5] = n
    return data.astype(dtype), idx


def _in_table(data, idx):
    """The JAX references' indices: one past the table becomes -1, the
    pad row the port gives it."""
    return numpy.where(idx >= len(data), -1, idx).astype(numpy.int32)


def _jax_rows(data, idx, pad):
    idx = _in_table(data, idx)
    rows = numpy.asarray(jax_gather._gather_jnp(data, idx))
    mask = (idx < 0).reshape((-1,) + (1,) * (data.ndim - 1))
    return numpy.where(mask, numpy.asarray(pad, data.dtype), rows)


def _torch(*arrays):
    return [torch.from_numpy(numpy.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("row", ROWS)
@pytest.mark.parametrize("pad", [0, -1])
@pytest.mark.parametrize("per_feature", [False, True])
def test_take_rows_group_matches_jax_table_by_table(dtype, row, pad,
                                                    per_feature):
    """A group of three: a raw ``dtype`` table, the normalized table (of
    ``dtype`` too) and int32 labels padded with -1."""
    data, idx = _table(dtype, row)
    source, _ = _table(dtype, row, seed=1)
    labels = numpy.random.default_rng(2).integers(0, 10, 23).astype(
        numpy.int32)
    f = int(numpy.prod(row))
    if per_feature:
        rng = numpy.random.default_rng(3)
        scale = rng.uniform(0.5, 2.0, f).astype(numpy.float32)
        shift = rng.standard_normal(f).astype(numpy.float32)
    else:
        scale, shift = numpy.float32(1.0 / 255.0), numpy.float32(0.25)
    pad = 255 if dtype == "uint8" and pad == -1 else pad
    t_data, t_source, t_labels, t_idx = _torch(data, source, labels, idx)
    norm = gather.affine_tensors((scale, shift), "cpu")
    gather.reset_launches()
    got = gather.take_rows_group(
        [(t_data, pad), (t_source, norm), (t_labels, -1)], t_idx)
    assert not any(gather.launches.values())
    raw, normed, got_labels = [g.numpy() for g in got]
    want = _jax_rows(data, idx, pad)
    assert raw.dtype == want.dtype and raw.shape == want.shape
    numpy.testing.assert_array_equal(raw, want)
    numpy.testing.assert_array_equal(got_labels,
                                     _jax_rows(labels, idx, -1))
    numpy.testing.assert_array_equal(
        normed, gather.take_rows_norm(t_source, t_idx, norm).numpy())
    ref = numpy.asarray(jax_gather._gather_norm_jnp(
        source, _in_table(source, idx), jnp.asarray(scale, jnp.float32),
        jnp.asarray(shift, jnp.float32)))
    assert normed.dtype == numpy.float32 and normed.shape == ref.shape
    rows = source[numpy.clip(idx, 0, 22)].reshape(len(idx), -1)
    terms = (numpy.abs(rows * numpy.float32(scale)) + numpy.abs(
        numpy.broadcast_to(numpy.float32(shift), rows.shape))).astype(
        numpy.float64)
    err = numpy.abs(normed.reshape(len(idx), -1).astype(numpy.float64)
                    - ref.reshape(len(idx), -1))
    assert (err <= NORM_RTOL * terms).all(), float(err.max())
    assert not normed[_in_table(source, idx) < 0].any()


def test_take_rows_group_serves_four_raw_tables():
    tables = [_table(dtype, (5,), seed=i)[0]
              for i, dtype in enumerate(DTYPES + ["uint8"])]
    idx = _table("uint8", (5,))[1]
    t_idx, = _torch(idx)
    got = gather.take_rows_group(
        [(t, pad) for t, pad in zip(_torch(*tables), (0, -1, 7, 3))], t_idx)
    for table, pad, out in zip(tables, (0, -1, 7, 3), got):
        numpy.testing.assert_array_equal(out.numpy(),
                                         _jax_rows(table, idx, pad))


def _norm(f=13):
    return (torch.ones(f), torch.zeros(f))


@pytest.mark.parametrize("bad,error,message", [
    ("five_tables", ValueError, "1 to 4 tables"),
    ("no_table", ValueError, "1 to 4 tables"),
    ("two_normalized", ValueError, "at most one table"),
    ("int64_indices", ValueError, "int32 indices"),
    ("strided_table", ValueError, "contiguous table"),
    ("f64_normalized", TypeError, "gather_norm takes"),
    ("scale_size", ValueError, "want 1 or 13"),
    ("f64_scale", ValueError, "f32 scale"),
])
def test_gather_group_contract_is_checked_before_launch(bad, error,
                                                        message):
    data = torch.zeros((50, 13), dtype=torch.uint8)
    idx = torch.zeros(7, dtype=torch.int32)
    tables = {
        "five_tables": [(data, 0)] * 5,
        "no_table": [],
        "two_normalized": [(data, _norm()), (data, _norm())],
        "int64_indices": [(data, 0)],
        "strided_table": [(data.t(), 0)],
        "f64_normalized": [(data.double(), _norm())],
        "scale_size": [(data, _norm(5))],
        "f64_scale": [(data, (torch.ones(13).double(), torch.zeros(13)))],
    }[bad]
    gather.reset_launches()
    with pytest.raises(error, match=message):
        gather._gather_group_cuda(
            tables, idx.long() if bad == "int64_indices" else idx)
    assert not any(gather.launches.values())
    assert not any(gather.tables_served.values())


# -- the served rows ---------------------------------------------------------

def _served_model(shuffled, offset, size, count):
    """The served indices, element by element: -1 after the tail and
    past the buffer."""
    return numpy.asarray(
        [shuffled[offset + i] if i < size and 0 <= offset + i < len(shuffled)
         else -1 for i in range(count)], numpy.int32)


@pytest.mark.parametrize("offset,size,count", [
    (45, 10, 12),      # rows 5..9 past the buffer, 10..11 past the tail
    (0, 50, 50), (0, 0, 8), (49, 1, 4), (50, 3, 3), (-2, 5, 6),
    (10, 60, 8),       # size above count: count rows, all served
])
def test_served_rows_pad_past_the_tail_and_the_buffer(offset, size, count):
    """``take_rows_served`` on CPU tensors is its plain version; row i is
    ``shuffled[offset + i]`` for i < size inside the buffer, else a pad
    row, and a served index past the table pads too."""
    rng = numpy.random.default_rng(11)
    data = rng.integers(0, 256, (40, 13)).astype(numpy.uint8)
    labels = rng.integers(0, 10, 40).astype(numpy.int32)
    shuffled = rng.integers(0, 40, 50).astype(numpy.int32)
    shuffled[[7, 46]] = 40                 # past the table
    t_data, t_labels, t_shuffled = _torch(data, labels, shuffled)
    norm = gather.affine_tensors((1.0 / 255.0, 0.25), "cpu")
    tables = [(t_data, norm), (t_labels, -1), (t_data, 3)]
    scalars = [torch.tensor(v, dtype=torch.int32) for v in (offset, size)]
    gather.reset_launches()
    got = gather.take_rows_served(tables, t_shuffled, *scalars, count)
    assert not any(gather.launches.values())
    assert not any(gather.entry_launches.values())
    idx = _served_model(shuffled, offset, size, count)
    numpy.testing.assert_array_equal(
        gather._served_indices(t_shuffled, *scalars, count).numpy(), idx)
    want = gather._gather_group_ref(tables, torch.from_numpy(idx))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape[0] == count
        assert torch.equal(g, w)
    numpy.testing.assert_array_equal(got[1].numpy(),
                                     _jax_rows(labels, idx, -1))
    numpy.testing.assert_array_equal(got[2].numpy(),
                                     _jax_rows(data, idx, 3))
    assert not got[0][torch.from_numpy(_in_table(data, idx)) < 0].any()


@pytest.mark.parametrize("bad,message", [
    ("offset_1d", "offset as a 0-d int32"),
    ("size_int64", "size as a 0-d int32"),
    ("offset_number", "offset as a 0-d int32"),
    ("shuffled_int64", "int32 indices"),
    ("five_tables", "1 to 4 tables"),
    ("negative_count", "count -1"),
])
def test_gather_served_contract_is_checked_before_launch(bad, message):
    data = torch.zeros((50, 13), dtype=torch.uint8)
    shuffled = torch.arange(50, dtype=torch.int32)
    offset = torch.tensor(3, dtype=torch.int32)
    size = torch.tensor(5, dtype=torch.int32)
    tables, count = [(data, _norm()), (data, 0)], 8
    if bad == "offset_1d":
        offset = offset.reshape(1)
    elif bad == "size_int64":
        size = size.long()
    elif bad == "offset_number":
        offset = 3
    elif bad == "shuffled_int64":
        shuffled = shuffled.long()
    elif bad == "five_tables":
        tables = [(data, 0)] * 5
    else:
        count = -1
    gather.reset_launches()
    with pytest.raises(ValueError, match=message):
        gather._gather_served_cuda(tables, shuffled, offset, size, count)
    assert not any(gather.launches.values())
    assert not any(gather.entry_launches.values())


# -- the loader routes -------------------------------------------------------

@pytest.fixture
def engines():
    """Both packages' engine knobs, restored afterwards; the JAX package
    on its XLA kernels."""
    jeng, teng = jax_root.common.engine, root.common.engine
    keys = (("kernels", "auto"), ("stitch", "on"), ("epoch_scan", "off"),
            ("loader", "auto"))
    jsaved = {k: jeng.get(k, d) for k, d in keys}
    tsaved = {k: teng.get(k, d) for k, d in keys[1:]}
    jeng.kernels = "xla"
    yield jeng, teng
    for key, value in jsaved.items():
        setattr(jeng, key, value)
    for key, value in tsaved.items():
        setattr(teng, key, value)


def _host(vec):
    vec.map_read()
    return numpy.array(vec.mem)


@pytest.fixture
def group_calls(monkeypatch):
    """Counts the loader's gather calls: ``("group", tables)`` for
    ``take_rows_group``, ``("served", tables)`` for
    ``take_rows_served``."""
    calls = []
    group, served = fullbatch.take_rows_group, fullbatch.take_rows_served

    def counted_group(tables, indices):
        calls.append(("group", len(tables)))
        return group(tables, indices)

    def counted_served(tables, *args):
        calls.append(("served", len(tables)))
        return served(tables, *args)
    monkeypatch.setattr(fullbatch, "take_rows_group", counted_group)
    monkeypatch.setattr(fullbatch, "take_rows_served", counted_served)
    return calls


@pytest.mark.parametrize("minibatch_size", [100, 96])
def test_eager_fill_gives_the_jax_loaders_rows(engines, group_calls,
                                               minibatch_size):
    """The eager route (stitch off): minibatch after minibatch, through
    the validation pass into the train pass (every class ends in a
    short batch at 96), one group call of data and labels a fill."""
    jeng, teng = engines
    jeng.stitch = teng.stitch = "off"
    jax_prng.seed_all(SEED)
    jwf = jax_mnist.create_workflow(device=JaxCPUDevice(), max_epochs=3,
                                    minibatch_size=minibatch_size)
    prng.seed_all(SEED)
    twf = mnist.create_workflow(device="cpu", max_epochs=3,
                                minibatch_size=minibatch_size)
    fills = 14
    for _ in range(fills):
        jwf.loader.run()
        twf.loader.run()
        assert twf.loader.minibatch_size == jwf.loader.minibatch_size
        assert twf.loader.minibatch_class == jwf.loader.minibatch_class
        for name in ("minibatch_data", "minibatch_labels"):
            got = _host(getattr(twf.loader, name))
            want = _host(getattr(jwf.loader, name))
            assert got.dtype == want.dtype and got.shape == want.shape
            numpy.testing.assert_array_equal(got, want, err_msg=name)
    assert group_calls == [("group", 2)] * fills


def _head_inputs(stage, offset, size, asarray):
    t = {name: vec.devmem for name, vec in stage.params.items()}
    t["offset"], t["size"] = asarray(offset), asarray(size)
    return t


HEAD_CASES = [(0, 100), (100, 100), (940, 60), (1000, 100), (6950, 50),
              (3, 1)]


def _heads(engines, native):
    """The JAX and the port's stitched head stages, each from its own
    MNIST workflow at seed 7."""
    jeng, teng = engines
    jeng.stitch = teng.stitch = "on"
    jax_prng.seed_all(SEED)
    jwf = jax_mnist.create_workflow(device=JaxCPUDevice(), max_epochs=3,
                                    native=native)
    prng.seed_all(SEED)
    twf = mnist.create_workflow(device="cpu", max_epochs=3, native=native)
    return jwf.loader.stitch_stage(), twf.loader.stitch_stage(), twf


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("offset,size", HEAD_CASES + [(500, 0), (6999, 1)])
def test_served_ref_gives_the_jax_heads_rows(engines, native, offset, size):
    """``_gather_served_ref`` over the port head's tables (the normalized
    u8 data and the labels; or the f32 dataset raw, pad 0) and shuffled
    buffer, against the JAX head's stage function at the same (offset,
    size): data and labels exactly, size 0 and the buffer's last row
    included."""
    jstage, tstage, twf = _heads(engines, native)
    want = jstage.fn(_head_inputs(jstage, offset, size,
                                  lambda v: jnp.asarray(v, jnp.int32)))
    loader = twf.loader
    how = loader._input_norm_dev_ if native else 0
    tables = [(loader.original_data.devmem, how),
              (loader.resident_labels.devmem, -1)]
    got = gather._gather_served_ref(
        tables, loader.shuffled_indices.devmem,
        torch.tensor(offset, dtype=torch.int32),
        torch.tensor(size, dtype=torch.int32),
        int(loader.max_minibatch_size))
    for name, g in zip(("minibatch_data", "minibatch_labels"), got):
        g, w = g.numpy(), numpy.asarray(want[name])
        assert g.dtype == w.dtype and g.shape == w.shape, name
        numpy.testing.assert_array_equal(g, w, err_msg=name)
    assert (got[1][size:] == -1).all() and not got[0][size:].any()


@pytest.mark.parametrize("offset,size", HEAD_CASES)
def test_stitched_head_gives_the_jax_heads_rows(engines, group_calls,
                                                offset, size):
    """The stitched native head (u8 dataset, scale 1/255 in the gather):
    its stage function against the JAX head's at one (offset, size) of
    the shuffled indices, a short batch's tail included; one served call
    of the normalized data and the labels, and no group call."""
    jstage, tstage, _twf = _heads(engines, True)
    want = jstage.fn(_head_inputs(jstage, offset, size,
                                  lambda v: jnp.asarray(v, jnp.int32)))
    got = tstage.fn(_head_inputs(
        tstage, offset, size,
        lambda v: torch.tensor(v, dtype=torch.int32)))
    assert sorted(got) == sorted(want) == ["minibatch_data",
                                           "minibatch_labels"]
    for name in got:
        g, w = got[name].numpy(), numpy.asarray(want[name])
        assert g.dtype == w.dtype and g.shape == w.shape, name
        numpy.testing.assert_array_equal(g, w, err_msg=name)
    assert got["minibatch_data"].dtype == torch.float32
    assert (got["minibatch_labels"][size:] == -1).all()
    assert group_calls == [("served", 2)]
