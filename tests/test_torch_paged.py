"""The port's paged KV cache, chunked prefill, prefix cache and
speculative decode (``veles_tpu_torch.gen``, the paged half of
``veles_tpu_torch.ops.attention``) against the JAX package's, on the CPU.

The same numpy inputs (and the same numpy weights, through
``params_from_numpy``) go through both packages:

- the paged attention's plain version against ``_paged_decode_jnp``, the
  dense verify path and the Pallas kernel in interpret mode (f32, atol =
  rtol = 1e-5, as ``test_torch_attention.py``), and bit for bit against
  the contiguous plain version on a pool that mirrors a contiguous cache;
- ``BlockPool`` and ``PrefixCache`` under the same operation sequences
  (ids, tables and refcounts exactly);
- each new model entry point (tokens exactly; K/V and pool pages other
  than the trash block within 1e-4: block 0 takes colliding writes whose
  winner neither package defines);
- TINY engine sessions in every configuration of the slice: token
  streams and counters exactly, and the JAX package's own gates within
  the port (paged == contiguous, chunked == whole, speculative == plain,
  lossless and deterministic preemption, prefix parity).

Each JAX session runs once per module (``_jax_session``).  On the CPU
the wrappers take their plain versions, so no kernel is launched; the
kernels are held against the plain versions on the card
(``test_torch_kernels.py``, ``chip_smoke.py``).
"""

import functools

import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu import gen as jax_gen
from veles_tpu.ops import attention as jax_attention
from veles_tpu.samples import transformer as jax_transformer
from veles_tpu_torch import gen as port_gen
from veles_tpu_torch.config import root
from veles_tpu_torch.gen import params_from_numpy
from veles_tpu_torch.ops import attention as port
from veles_tpu_torch.samples.transformer import TINY

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

CFG = dict(TINY, seq_len=64)
ATOL = RTOL = 1e-5
TOL = 1e-4
CPU = "cpu"
COUNTERS = ("preemptions_total", "prefix_shared_pages_total",
            "spec_dispatches", "spec_accepted_total")


def _close(got, want, tol=ATOL):
    numpy.testing.assert_allclose(numpy.asarray(got), numpy.asarray(want),
                                  atol=tol, rtol=tol)


@pytest.fixture
def launches():
    port.reset_launches()
    yield port.launches
    assert not any(port.launches.values())
    port.reset_launches()


# -- the paged attention ------------------------------------------------------

def _paged_operands(seed, b, nq, h, d, bs, max_blocks, lengths, row_step,
                    num_blocks=None):
    """q, a pool with its pages in shuffled order, tables (trash 0 past
    each row's allocation) and lengths, as numpy."""
    rng = numpy.random.default_rng(seed)
    num_blocks = num_blocks or b * max_blocks + 1
    q = rng.standard_normal((b, nq, h, d)).astype(numpy.float32)
    k_pool = rng.standard_normal((num_blocks, bs, h, d)).astype(
        numpy.float32)
    v_pool = rng.standard_normal((num_blocks, bs, h, d)).astype(
        numpy.float32)
    pages = rng.permutation(numpy.arange(1, num_blocks))
    tables = numpy.zeros((b, max_blocks), numpy.int32)
    used = 0
    for i, n in enumerate(lengths):
        need = min(max_blocks,
                   -(-(n + row_step * (nq - 1)) // bs))
        tables[i, :need] = pages[used:used + need]
        used += need
    return q, k_pool, v_pool, tables, numpy.asarray(lengths, numpy.int32)


def _torch(*arrays):
    return [torch.from_numpy(numpy.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("bs", [4, 8, 16])
@pytest.mark.parametrize("row_step,nq", [(0, 1), (0, 3), (1, 3), (1, 8)])
def test_paged_decode_ref_matches_jax(row_step, nq, bs):
    max_blocks = 48 // bs
    top = max_blocks * bs - row_step * (nq - 1)   # verify reaches the end
    lengths = [1, bs - 1, bs + 1, top]
    q, kp, vp, tables, lens = _paged_operands(bs + nq, 4, nq, 2, 8, bs,
                                              max_blocks, lengths, row_step)
    got = port._paged_decode_ref(*_torch(q, kp, vp, tables, lens),
                                 row_step=row_step)
    jargs = [jnp.asarray(a) for a in (q, kp, vp, tables, lens)]
    if row_step:
        want = jax_attention.paged_verify_attention(*jargs,
                                                    use_pallas=False)
    else:
        want = jax_attention._paged_decode_jnp(*jargs)
    assert got.shape == (4, nq, 2, 8)
    _close(got, want)
    if bs % 8 == 0:
        _close(got, jax_attention._paged_decode_pallas(
            *jargs, interpret=True, row_step=row_step))


@pytest.mark.parametrize("row_step,nq", [(0, 1), (1, 5)])
def test_paged_ref_equals_contiguous_ref_bitwise_on_a_mirror(row_step, nq):
    """A pool holding a contiguous cache's rows, page by page in shuffled
    order, reads back as that cache: the plain versions agree bit for
    bit (the CPU half of the kernels' mirror check)."""
    bs, max_blocks, b = 4, 12, 3
    rng = numpy.random.default_rng(40 + nq)
    k, v = (rng.standard_normal((b, max_blocks * bs, 2, 8)).astype(
        numpy.float32) for _ in range(2))
    q = rng.standard_normal((b, nq, 2, 8)).astype(numpy.float32)
    lens = numpy.asarray([1, 17, 48 - row_step * (nq - 1)], numpy.int32)
    pages = rng.permutation(numpy.arange(1, b * max_blocks + 1))
    tables = pages.reshape(b, max_blocks).astype(numpy.int32)
    kp = numpy.full((b * max_blocks + 1, bs, 2, 8), 1e4, numpy.float32)
    vp = kp.copy()
    for i in range(b):
        for j in range(max_blocks):
            kp[tables[i, j]] = k[i, j * bs:(j + 1) * bs]
            vp[tables[i, j]] = v[i, j * bs:(j + 1) * bs]
    paged = port._paged_decode_ref(*_torch(q, kp, vp, tables, lens),
                                   row_step=row_step)
    ref = port._verify_ref if row_step else port._decode_ref
    assert torch.equal(paged, ref(*_torch(q, k, v, lens)))


def test_paged_wrappers_on_cpu_take_the_plain_version(launches):
    q, kp, vp, tables, lens = _torch(*_paged_operands(
        3, 2, 4, 2, 8, 8, 4, [5, 20], 1))
    out = port.paged_decode_attention(q[:, :1], kp, vp, tables, lens)
    assert torch.equal(out, port._paged_decode_ref(q[:, :1], kp, vp, tables,
                                                   lens))
    squeezed = port.paged_decode_attention(q[:, 0], kp, vp, tables, lens)
    assert torch.equal(squeezed, out[:, 0])
    verify = port.paged_verify_attention(q, kp, vp, tables, lens)
    assert torch.equal(verify, port._paged_decode_ref(q, kp, vp, tables,
                                                      lens, row_step=1))
    with pytest.raises(ValueError):
        port.paged_decode_attention(q, kp, vp, tables, lens, row_step=2)


def test_verify_attention_is_decode_with_row_step_one(launches):
    q, k, v = _torch(*[numpy.random.default_rng(5).standard_normal(s)
                       .astype(numpy.float32)
                       for s in ((2, 5, 2, 8), (2, 24, 2, 8),
                                 (2, 24, 2, 8))])
    lens = torch.tensor([1, 19], dtype=torch.int32)
    got = port.verify_attention(q, k, v, lens)
    assert torch.equal(got, port._verify_ref(q, k, v, lens))
    _close(got, jax_attention.verify_attention(
        *(jnp.asarray(t.numpy()) for t in (q, k, v, lens)),
        use_pallas=False))


@pytest.mark.parametrize("start,chunk,seq", [(0, 8, 24), (8, 8, 24),
                                             (16, 16, 48), (5, 7, 19)])
def test_chunk_attention_matches_jax(launches, start, chunk, seq):
    rng = numpy.random.default_rng(start + seq)
    q = rng.standard_normal((1, chunk, 2, 8)).astype(numpy.float32)
    k, v = (rng.standard_normal((1, seq, 2, 8)).astype(numpy.float32)
            for _ in range(2))
    got = port.chunk_attention(*_torch(q, k, v), start)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    _close(got, jax_attention.chunk_attention(jq, jk, jv, start,
                                              use_pallas=False))
    pal_o, _lse = jax_attention._flash_fwd(
        jq, jk, jv, causal=True, block_q=8, block_k=8, interpret=True,
        q_offset=start)
    _close(got, pal_o)


# -- the block pool and the prefix cache -------------------------------------

def _pool_script(gen):
    """One operation sequence over a package's BlockPool and PrefixCache
    (the JAX package's unit tests' sequences, joined): every result,
    table and refcount goes into the log, and exhaustion is logged by
    its fields."""
    log = []

    def record(tag, value):
        log.append((tag, value.tolist() if hasattr(value, "tolist")
                    else value))

    pool = gen.BlockPool(slots=4, max_blocks=4, num_blocks=9, block_size=8)
    record("admit0", pool.admit(0, 17))
    record("admit1", pool.admit(1, 4))
    record("needs", (pool.needs_append(0, 20), pool.needs_append(0, 24)))
    record("append", pool.append(0, 24))
    record("tables", pool.tables)
    pool.incref(1)
    pool.incref(2)
    record("shared", pool.admit(2, 20, shared=(1, 2)))
    record("refs", [pool.refcount(b) for b in range(9)])
    record("saved", pool.pages_saved())
    record("truncate", pool.truncate(2, 16))
    record("release", pool.release(0))
    record("refs2", [pool.refcount(b) for b in range(9)])
    try:
        pool.admit(3, 60, shared=(1, 2))
    except gen.PoolExhausted as exc:
        record("exhausted", (exc.needed, exc.free))
    record("refs3", [pool.refcount(b) for b in range(9)])
    record("describe", sorted(pool.describe().items()))

    pool = gen.BlockPool(slots=2, max_blocks=8, num_blocks=17, block_size=4)
    cache = gen.PrefixCache(pool)
    toks = list(range(100, 117))
    bids = pool.admit(0, 17)
    record("insert", cache.insert(toks, bids[:4], tag="b0"))
    record("match", cache.match(toks, tag="b0"))
    record("match9", cache.match(toks[:9], tag="b0"))
    record("other_tag", cache.match(toks, tag="chunk8"))
    record("diverged", cache.match(toks[:6] + [999] + toks[7:], tag="b0"))
    record("pinned", (cache.cache_only_pages(), cache.reclaimable(),
                      cache.evict(4)))
    pool.release(0)
    record("free", (cache.cache_only_pages(), cache.reclaimable(),
                    cache.evict(2)))
    record("after_evict", cache.match(toks, tag="b0"))
    record("admit_full", pool.admit(0, 32))
    record("admit_reclaim", pool.admit(1, 32))   # the reclaimer evicts
    record("describe_cache", sorted(cache.describe().items()))
    record("clear", cache.clear())
    record("used", pool.blocks_used)
    return log


def test_block_pool_and_prefix_cache_match_jax():
    assert _pool_script(port_gen) == _pool_script(jax_gen)


def test_block_pool_refuses_a_pool_smaller_than_one_sequence():
    with pytest.raises(ValueError):
        port_gen.BlockPool(slots=1, max_blocks=4, num_blocks=4,
                           block_size=8)
    pool = port_gen.BlockPool(slots=1, max_blocks=4, num_blocks=5,
                              block_size=8)
    with pytest.raises(port_gen.PoolExhausted) as info:
        pool.admit(0, 33)
    assert (info.value.needed, info.value.free) == (5, 4)


# -- the model's new entry points --------------------------------------------

def _models(seed=0):
    host = jax_transformer.init_params(CFG, seed=seed)
    jp = {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()}
              if isinstance(v, dict) else jnp.asarray(v))
          for k, v in host.items()}
    return (jax_gen.TransformerGenModel(CFG), jp,
            port_gen.TransformerGenModel(CFG, device=CPU),
            params_from_numpy(host, CPU))


def _long(array):
    return torch.from_numpy(numpy.asarray(array).astype(numpy.int64))


def _pages_close(pcache, jcache):
    """Pool pages other than the trash block within TOL."""
    for key in ("k", "v"):
        _close(pcache[key][:, 1:], numpy.asarray(jcache[key])[:, 1:], TOL)


def test_paged_prefill_and_decode_match_jax():
    jm, jp, pm, pp = _models(seed=1)
    rng = numpy.random.default_rng(1)
    bs, mb = 8, 6
    jcache, pcache = jm.init_paged_cache(13, bs), pm.init_paged_cache(13, bs)
    tables = numpy.zeros((3, mb), numpy.int32)
    toks, lens = [], [11, 16]
    for slot, (n, ids) in enumerate(zip(lens, ([5, 2], [7, 1, 9]))):
        padded = numpy.zeros((1, 16), numpy.int32)
        padded[0, :n] = rng.integers(0, CFG["vocab"], n)
        block_ids = numpy.zeros(2, numpy.int32)
        block_ids[:min(2, len(ids))] = ids[:2]
        jcache, jtok = jm.paged_prefill(jp, jcache, jnp.asarray(padded),
                                        jnp.asarray(block_ids), n)
        _c, ptok = pm.paged_prefill(pp, pcache, _long(padded),
                                    _long(block_ids), n)
        assert int(ptok) == int(jtok)
        tables[slot, :len(ids)] = ids
        toks.append(int(jtok))
    _pages_close(pcache, jcache)
    # slot 2 idle: its write routes to the trash block
    tokens = numpy.asarray(toks + [0], numpy.int32)
    positions = numpy.asarray(lens + [0], numpy.int32)
    active = numpy.asarray([True, True, False])
    for _step in range(4):
        jcache, jout = jm.paged_decode(
            jp, jcache, jnp.asarray(tables), jnp.asarray(tokens),
            jnp.asarray(positions), jnp.asarray(active))
        _c, pout = pm.paged_decode(pp, pcache, torch.from_numpy(tables),
                                   _long(tokens), _long(positions),
                                   torch.from_numpy(active))
        assert pout.tolist()[:2] == numpy.asarray(jout).tolist()[:2]
        tokens = numpy.where(active, numpy.asarray(jout), 0).astype(
            numpy.int32)
        positions = positions + active
    _pages_close(pcache, jcache)


def _verify_inputs(rng, slots=3, k=4):
    tokens = rng.integers(0, CFG["vocab"], (slots, k + 1)).astype(
        numpy.int32)
    positions = numpy.asarray([9, 14, 0], numpy.int32)
    drafts = numpy.asarray([4, 2, 0], numpy.int32)
    active = numpy.asarray([True, True, False])
    return tokens, positions, drafts, active


def test_verify_matches_jax():
    jm, jp, pm, pp = _models(seed=2)
    rng = numpy.random.default_rng(2)
    jcache, pcache = jm.init_cache(3, 32), pm.init_cache(3, 32)
    for slot, n in ((0, 9), (1, 14)):
        padded = numpy.zeros((1, 16), numpy.int32)
        padded[0, :n] = rng.integers(0, CFG["vocab"], n)
        jcache, _t = jm.prefill(jp, jcache, jnp.asarray(padded), slot, n)
        pm.prefill(pp, pcache, _long(padded), slot, n)
    tokens, positions, drafts, active = _verify_inputs(rng)
    jcache, jout = jm.verify(jp, jcache, *(jnp.asarray(a) for a in (
        tokens, positions, drafts, active)))
    _c, pout = pm.verify(pp, pcache, _long(tokens), _long(positions),
                         _long(drafts), torch.from_numpy(active))
    assert pout.shape == (3, 5)
    assert pout[:2].tolist() == numpy.asarray(jout)[:2].tolist()
    for key in ("k", "v"):
        _close(pcache[key], jcache[key], TOL)


def test_paged_verify_matches_jax():
    jm, jp, pm, pp = _models(seed=3)
    rng = numpy.random.default_rng(3)
    bs = 8
    jcache, pcache = jm.init_paged_cache(13, bs), pm.init_paged_cache(13, bs)
    tables = numpy.zeros((3, 4), numpy.int32)
    tables[0, :2] = [3, 6]                 # 9 tokens + 4 drafts: 2 pages
    tables[1, :3] = [2, 8, 4]              # 14 tokens + 2 drafts: 3 pages
    for slot, n in ((0, 9), (1, 14)):
        padded = numpy.zeros((1, 16), numpy.int32)
        padded[0, :n] = rng.integers(0, CFG["vocab"], n)
        ids = tables[slot, :2]
        jcache, _t = jm.paged_prefill(jp, jcache, jnp.asarray(padded),
                                      jnp.asarray(ids), n)
        pm.paged_prefill(pp, pcache, _long(padded), _long(ids), n)
    tokens, positions, drafts, active = _verify_inputs(rng)
    jcache, jout = jm.paged_verify(jp, jcache, jnp.asarray(tables), *(
        jnp.asarray(a) for a in (tokens, positions, drafts, active)))
    _c, pout = pm.paged_verify(pp, pcache, torch.from_numpy(tables),
                               _long(tokens), _long(positions),
                               _long(drafts), torch.from_numpy(active))
    assert pout[:2].tolist() == numpy.asarray(jout)[:2].tolist()
    _pages_close(pcache, jcache)


def test_prefill_chunks_match_jax_in_both_layouts():
    jm, jp, pm, pp = _models(seed=4)
    rng = numpy.random.default_rng(4)
    n, chunk, bs = 21, 8, 4
    prompt = numpy.zeros(24, numpy.int32)
    prompt[:n] = rng.integers(0, CFG["vocab"], n)
    jc, pc = jm.init_cache(2, 32), pm.init_cache(2, 32)
    jpool, ppool = jm.init_paged_cache(17, bs), pm.init_paged_cache(17, bs)
    table = numpy.asarray([5, 11, 2, 14, 7, 9, 0, 0], numpy.int32)
    for start in range(0, n, chunk):
        toks = prompt[None, start:start + chunk]
        length = min(chunk, n - start)
        jc, jtok = jm.prefill_chunk(jp, jc, jnp.asarray(toks), 1, start,
                                    length)
        _c, ptok = pm.prefill_chunk(pp, pc, _long(toks), 1, start, length)
        assert int(ptok) == int(jtok)
        ids = table[start // bs:(start + chunk) // bs]
        jpool, jptok = jm.paged_prefill_chunk(
            jp, jpool, jnp.asarray(toks), jnp.asarray(ids),
            jnp.asarray(table), start, length)
        _c, pptok = pm.paged_prefill_chunk(pp, ppool, _long(toks),
                                           _long(ids), _long(table), start,
                                           length)
        assert int(pptok) == int(jptok) == int(jtok)
    for key in ("k", "v"):
        _close(pc[key], jc[key], TOL)
    _pages_close(ppool, jpool)


def test_analytic_flops_match_jax():
    jm, _jp, pm, _pp = _models()
    assert pm.prefill_chunk_flops(8, 48) == jm.prefill_chunk_flops(8, 48)
    assert pm.verify_flops(3, 4, 48) == jm.verify_flops(3, 4, 48)
    assert pm.paged_cache_nbytes(13, 8) == jm.paged_cache_nbytes(13, 8)


# -- engine sessions against the JAX engine's ---------------------------------

def mixed_workload(n=10, seed=0, max_prompt=16, max_new_hi=10):
    rng = numpy.random.default_rng(seed)
    return tuple((tuple(rng.integers(0, CFG["vocab"],
                                     int(rng.integers(1, max_prompt)))
                        .tolist()),
                  int(rng.integers(1, max_new_hi))) for _ in range(n))


def shared_workload(n=6, stem_len=13, max_new=6, first=20):
    stem = [(i * 7 + 3) % CFG["vocab"] for i in range(stem_len)]
    return tuple((tuple(stem + [first + i]), max_new) for i in range(n))


def spec_workload(n=4, max_new=10, first=30):
    stem = (list(range(2, 10)) * 3)[:18]
    return tuple((tuple(stem + [first + i]), max_new) for i in range(n))


WORKLOADS = {"mixed": mixed_workload(10), "mixed8": mixed_workload(8, 4),
             "shared": shared_workload(6), "spec": spec_workload(),
             "spec3": spec_workload(3, max_new=8),
             "spec3x6": spec_workload(3, max_new=6),
             "spec6": spec_workload(6, max_new=12)}
PAGED = (("kv", "paged"), ("block_size", 8))


def _run(gen, engine, workload, mode):
    if mode == "static":
        return gen.static_generate(engine, list(workload))[0]
    scheduler = gen.GenerativeScheduler(engine)
    if mode == "sequential":
        out = []
        for toks, max_new in workload:
            future = scheduler.submit(list(toks), max_new)
            scheduler.run_until_idle()
            out.append(future.result(0))
        return out
    futures = [scheduler.submit(list(toks), max_new)
               for toks, max_new in workload]
    scheduler.run_until_idle()
    return [f.result(0) for f in futures]


def _session(gen, workload, mode, buckets, options, adversary=None):
    kw = dict(options)
    if gen is port_gen:
        model = gen.TransformerGenModel(CFG, device=CPU)
        kw["device"] = CPU
    else:
        model = gen.TransformerGenModel(CFG)
    engine = gen.GenerativeEngine(model, max_slots=3, max_seq=48,
                                  prefill_buckets=buckets, seed=0, **kw)
    engine.warmup()
    if adversary is not None:
        engine.proposer = adversary
    streams = _run(gen, engine, WORKLOADS[workload], mode)
    counters = {name: getattr(engine, name) for name in COUNTERS}
    engine.close()
    return streams, counters


@functools.lru_cache(maxsize=None)
def _jax_session(workload, mode="continuous", buckets=(8, 16), options=(),
                 adversary=None):
    return _session(jax_gen, workload, mode, buckets, options,
                    _ADVERSARIES[adversary] if adversary else None)


def _port_session(workload, mode="continuous", buckets=(8, 16), options=(),
                  adversary=None):
    return _session(port_gen, workload, mode, buckets, options,
                    _ADVERSARIES[adversary] if adversary else None)


def _both(*args, **kwargs):
    got = _port_session(*args, **kwargs)
    assert got == _jax_session(*args, **kwargs)
    return got


@pytest.mark.parametrize("mode", ["continuous", "sequential", "static"])
def test_paged_sessions_match_jax_and_contiguous(mode):
    streams, counters = _both("mixed", mode, options=PAGED)
    assert counters["preemptions_total"] == 0     # full-capacity pool
    assert streams == _jax_session("mixed")[0]    # paged == contiguous
    assert streams == _port_session("mixed", mode)[0]
    assert [len(s) for s in streams] == [m for _t, m in WORKLOADS["mixed"]]


@pytest.mark.parametrize("options", [(("prefill_chunk", 8),),
                                     (("prefill_chunk", 8),) + PAGED],
                         ids=["contiguous", "paged"])
def test_chunked_sessions_match_jax_and_whole_prompt(options):
    streams, _counters = _both("mixed8", options=options)
    assert streams == _port_session("mixed8")[0]  # chunked == whole


@pytest.mark.parametrize("mode,options", [
    ("continuous", PAGED + (("prefix_cache", "on"),)),
    ("sequential", PAGED + (("prefix_cache", "on"),
                            ("prefill_chunk", 8)))], ids=["whole", "chunked"])
def test_prefix_cache_sessions_match_jax_and_plain(mode, options):
    streams, counters = _both("shared", mode, options=options)
    assert counters["prefix_shared_pages_total"] >= 1
    assert streams == _jax_session("shared", options=PAGED)[0]


@pytest.mark.parametrize("options", [(), PAGED], ids=["contiguous", "paged"])
def test_ngram_speculation_matches_jax_and_plain(options):
    spec = options + (("speculative", "ngram"), ("draft_k", 4))
    streams, counters = _both("spec", buckets=(8, 16, 32), options=spec)
    assert counters["spec_dispatches"] >= 1
    assert counters["spec_accepted_total"] >= 1
    assert streams == _port_session("spec", buckets=(8, 16, 32),
                                    options=options)[0]


@pytest.fixture
def draft_models():
    port_gen.register_draft_model(
        "tiny-draft", port_gen.TransformerGenModel(CFG, device=CPU))
    jax_gen.register_draft_model("tiny-draft",
                                 jax_gen.TransformerGenModel(CFG))
    yield
    port_gen.DRAFT_MODELS.pop("tiny-draft", None)
    jax_gen.DRAFT_MODELS.pop("tiny-draft", None)


def test_registered_draft_model_matches_jax_and_plain(draft_models):
    options = PAGED + (("speculative", "tiny-draft"), ("draft_k", 3))
    streams, counters = _both("spec3", buckets=(8, 16, 32),
                              options=options)
    assert counters["spec_dispatches"] >= 1
    assert streams == _port_session("spec3", buckets=(8, 16, 32),
                                    options=PAGED)[0]


class _Adversary(object):
    """A proposer wrong at every position: from a prefix it proposes
    the token greedy decode does NOT emit next."""

    def __init__(self, workload, plain):
        self.wrong = {}
        for (toks, _max_new), out in zip(workload, plain):
            full = list(toks) + [int(t) for t in out]
            for j in range(len(toks), len(full)):
                self.wrong[tuple(full[:j])] = (full[j] + 1) % CFG["vocab"]

    def propose(self, stream, k):
        return [self.wrong.get(tuple(int(t) for t in stream), 0)] * int(k)


_ADVERSARIES = {}


def test_zero_acceptance_adversary_matches_jax_and_plain():
    plain = _jax_session("spec3x6", buckets=(8, 16, 32), options=PAGED)[0]
    _ADVERSARIES["spec3x6"] = _Adversary(WORKLOADS["spec3x6"], plain)
    streams, counters = _both(
        "spec3x6", buckets=(8, 16, 32), adversary="spec3x6",
        options=PAGED + (("speculative", "ngram"), ("draft_k", 4)))
    assert counters["spec_accepted_total"] == 0
    assert counters["spec_dispatches"] >= 1
    assert streams == plain


def test_tight_pool_preempts_losslessly_and_deterministically():
    options = PAGED + (("num_blocks", 9), ("prefill_chunk", 8))
    first = _both("mixed", options=options)
    assert first[1]["preemptions_total"] >= 1
    assert _port_session("mixed", options=options) == first
    assert first[0] == _port_session("mixed", options=PAGED)[0]


def test_speculation_preempts_mid_draft_losslessly():
    options = PAGED + (("num_blocks", 11), ("speculative", "ngram"),
                       ("draft_k", 4))
    streams, counters = _both("spec6", buckets=(8, 16, 32),
                              options=options)
    assert counters["preemptions_total"] >= 1
    assert streams == _port_session("spec6", buckets=(8, 16, 32),
                                    options=PAGED)[0]


# -- the engine and scheduler around the pool ---------------------------------

def _engine(**kw):
    kw.setdefault("prefill_buckets", (8, 16))
    return port_gen.GenerativeEngine(
        port_gen.TransformerGenModel(CFG, device=CPU), max_slots=3,
        max_seq=48, seed=0, device=CPU, **kw)


@pytest.mark.parametrize("options", [
    dict(kv="paged", block_size=7),                    # 48 % 7
    dict(kv="paged", block_size=8, num_blocks=4),      # < one sequence
    dict(kv="nonsense"),
    dict(prefill_chunk=32),                            # 48 % 32
    dict(kv="paged", block_size=8, prefill_chunk=32),
    dict(prefix_cache="on"),                           # contiguous
    dict(prefix_cache="maybe", kv="paged"),
    dict(speculative="ngram", draft_k=8),              # > 7 drafts
    dict(speculative="no-such-draft-model"),
])
def test_engine_rejects_bad_geometry_and_options(options):
    with pytest.raises(ValueError):
        _engine(**options)


def test_config_knobs_drive_the_engine_defaults():
    gen = root.common.gen
    prior = {k: gen.get(k) for k in ("kv", "prefill_chunk", "block_size",
                                     "draft_k", "speculative")}
    gen.kv, gen.prefill_chunk, gen.block_size = "paged", 7, 8
    gen.speculative, gen.draft_k = "ngram", 3
    try:
        engine = _engine()
        assert engine.kv_mode == "paged" and engine.block_size == 8
        assert engine.prefill_chunk == 8          # rounded up to a page
        assert engine.draft_k == 3
        assert isinstance(engine.proposer, port_gen.NGramProposer)
        engine.close()
        engine = _engine(kv="contiguous", prefill_chunk=6,
                         speculative="off")       # keyword arguments win
        assert (engine.kv_mode, engine.prefill_chunk) == ("contiguous", 6)
        assert engine.proposer is None
        engine.close()
    finally:
        for key, value in prior.items():
            setattr(gen, key, value)


def test_paged_engine_ledger_describe_and_pricing():
    from veles_tpu_torch.memory import Watcher
    kv0 = Watcher.hbm_ledger()["by_category"].get("kv", {}).get("bytes", 0)
    engine = _engine(kv="paged", block_size=8, num_blocks=9,
                     prefill_buckets=(8, 16, 40))
    assert engine.kv_cache_bytes == 2 * 2 * 9 * 8 * 32 * 4
    held = Watcher.hbm_ledger()["by_category"]["kv"]["bytes"]
    assert held - kv0 == engine.kv_cache_bytes
    assert engine.prefill_buckets == (8, 16, 40)
    assert engine.can_admit(16)
    slot, _tok = engine.prefill(list(range(1, 40)))   # 39 -> 5 pages
    assert engine.blocks_free == 3 and engine.blocks_total == 8
    assert engine.can_admit(16) and not engine.can_admit(30)
    with pytest.raises(port_gen.PoolExhausted):
        engine.prefill(list(range(1, 31)))
    assert engine.free_slots == 2             # the failed admit's slot
    info = engine.describe()
    assert info["kv"] == "paged" and info["blocks_used"] == 5
    assert info["preemptions_total"] == 0
    assert engine.hbm_per_request_bytes() > 0
    engine.release_slot(slot)
    assert engine.blocks_free == 8
    # through the scheduler the blocked request waits (FIFO), then runs
    scheduler = port_gen.GenerativeScheduler(engine)
    long_future = scheduler.submit(list(range(1, 40)), 4)
    blocked = scheduler.submit(list(range(1, 31)), 2)
    scheduler.step()
    assert not blocked.done() and scheduler.queue_depth() == 1
    scheduler.run_until_idle()
    assert len(long_future.result(0)) == 4 and len(blocked.result(0)) == 2
    engine.close()
    after = Watcher.hbm_ledger()["by_category"].get("kv", {}).get("bytes", 0)
    assert after == kv0


def test_prefix_admission_prices_the_unshared_suffix():
    stem = [(i * 7 + 3) % CFG["vocab"] for i in range(25)]
    engine = _engine(kv="paged", block_size=8, num_blocks=7,
                     prefill_buckets=(8, 16, 32), prefix_cache="on")
    slot, _tok = engine.prefill(stem + [20])      # 4 of 6 usable pages
    follower = stem + [21]
    assert not engine.can_admit(len(follower))
    assert engine.can_admit(len(follower), follower)   # 3 shared
    engine.release_slot(slot)
    assert engine.blocks_free == 3            # the stem pages stay cached
    fresh = [(i * 5 + 1) % CFG["vocab"] for i in range(30)]  # unshared
    assert engine.can_admit(len(fresh))       # 3 free + 3 reclaimable
    slot2, _tok = engine.prefill(fresh)       # the reclaimer evicts a leaf
    assert len(engine._prefix.match(
        follower, engine._prefix_tag(len(follower)))) == 2
    assert engine.describe()["prefix_evicted_pages_total"] == 1
    engine.release_slot(slot2)
    engine.close()


def test_engine_counters_rates_and_scheduler_door():
    engine = _engine(kv="paged", block_size=8, prefix_cache="on",
                     speculative="ngram", draft_k=4,
                     prefill_buckets=(8, 16, 32)).warmup()
    assert engine.prefix_hit_rate() == 0.0
    assert engine.spec_accept_rate() == 0.0
    assert engine.spec_tokens_per_dispatch() == 0.0
    scheduler = port_gen.GenerativeScheduler(engine)
    with pytest.raises(ValueError):
        scheduler.submit([1] * 40, 16)        # past the 48-token slot
    futures = [scheduler.submit(list(t), m)
               for t, m in WORKLOADS["spec"] + WORKLOADS["shared"]]
    scheduler.run_until_idle()
    assert all(len(f.result(0)) == m for f, (_t, m) in
               zip(futures, WORKLOADS["spec"] + WORKLOADS["shared"]))
    info = engine.describe()
    assert info["prefix_hit_rate"] == round(engine.prefix_hit_rate(), 4) > 0
    assert 0 < info["spec_accept_rate"] <= 1
    assert info["spec_tokens_per_dispatch"] > 1
    assert scheduler.decode_steps == engine.spec_dispatches
    engine.close()


def test_the_slice_launches_no_kernel_on_the_cpu(launches):
    _port_session("spec", buckets=(8, 16, 32),
                  options=PAGED + (("speculative", "ngram"),
                                   ("prefix_cache", "on"),
                                   ("prefill_chunk", 8)))
