"""``python -m veles_tpu_torch.gen --smoke`` — the generative serving
gate of the port.

Mirrors the four phases of ``python -m veles_tpu.gen --smoke``: (1) a
tiny transformer engine is warmed (kernels built, every prefill bucket
and the decode step run once), then a seeded mixed-length
continuous-batching session must resolve every request with exactly its
budgeted token count; (2) the same workload runs through a PAGED
engine whose pool is too small for the mix, with chunked prefill: it
must preempt at least once and still give the contiguous session's
token streams; (3) an INT8 engine (``quantize_int8``, the qmatmul path)
must meet the same budgets with params at most 0.35x its float twin's,
the calibration drift gate green and ``describe()["quantize"] ==
"int8"``; (4) a PREFIX+SPEC engine (radix prefix cache and n-gram
speculation over the paged pool) must give a plain paged engine's
shared-prefix streams while sharing a page between two live slots,
keeping live pages out of eviction's reach and accepting at least one
drafted token.  The JAX smoke's "0 steady-state recompiles" lines have
no counterpart: PyTorch compiles nothing.  It runs on the CUDA card
unless ``--device cpu`` is given.  Exit code 0 on success; any violation
prints the failure and exits 1.
"""

import argparse
import sys
import time

import numpy


def make_parser():
    parser = argparse.ArgumentParser(
        prog="veles_tpu_torch.gen",
        description="Generative serving smoke gate of the PyTorch port "
                    "(warmup -> mixed-length continuous-batching "
                    "session -> paged preemption parity -> int8 -> "
                    "prefix + speculation).")
    parser.add_argument("--smoke", action="store_true",
                        help="run the smoke gate")
    parser.add_argument("--slots", type=int, default=4)
    parser.add_argument("--max-seq", type=int, default=48)
    parser.add_argument("--requests", type=int, default=16)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    return parser


def _session(engine, workload, label):
    """Warm ``engine`` and pump one seeded session through a scheduler:
    returns ``(streams, elapsed, scheduler, failures)``, a failure for
    each request that did not resolve with exactly its budget."""
    from veles_tpu_torch.gen import GenerativeScheduler

    engine.warmup()
    scheduler = GenerativeScheduler(engine, name=label)
    futures = [scheduler.submit(toks, max_new) for toks, max_new in workload]
    tic = time.perf_counter()
    scheduler.run_until_idle()
    elapsed = time.perf_counter() - tic
    results = [f.result(0) if f.done() else None for f in futures]
    failed = 0
    for got, (_toks, max_new) in zip(results, workload):
        if got is None:
            print("FAIL[%s]: request with budget %d never resolved"
                  % (label, max_new))
            failed += 1
        elif len(got) != max_new:
            print("FAIL[%s]: got %d tokens, budget %d"
                  % (label, len(got), max_new))
            failed += 1
    return results, elapsed, scheduler, failed


def smoke(slots=4, max_seq=48, requests=16, seed=0, device=None):
    from veles_tpu_torch.gen import GenerativeEngine, TransformerGenModel
    from veles_tpu_torch.samples.transformer import TINY

    cfg = dict(TINY, seq_len=max(64, max_seq))
    rng = numpy.random.default_rng(seed)
    workload = [
        (rng.integers(0, cfg["vocab"],
                      int(rng.integers(1, 30))).tolist(),
         int(rng.integers(1, 14)))
        for _ in range(requests)]

    def build(config=cfg, **kw):
        return GenerativeEngine(
            TransformerGenModel(config, device=device), max_slots=slots,
            max_seq=max_seq, prefill_buckets=(8, 16, 32), seed=seed,
            device=device, **kw)

    # phase 1: the contiguous session
    engine = build()
    results, elapsed, scheduler, failed = _session(engine, workload,
                                                   "smoke")
    engine.close()
    tokens = scheduler.tokens_total
    print("gen smoke[%s]: %d requests, %d tokens in %.2fs (%.1f tok/s), "
          "batch fill %.0f%%, %d prefills, %d decode steps"
          % (engine.device, len(workload), tokens, elapsed,
             tokens / elapsed if elapsed else 0.0,
             100.0 * scheduler.batch_fill(), engine.prefill_calls,
             engine.decode_calls))

    # phase 2: the same workload through the smallest block pool that
    # holds one whole sequence, too small for the mix (preemption must
    # fire and recover), chunked, giving the contiguous session's streams
    paged = build(kv="paged", block_size=8, num_blocks=max_seq // 8 + 1,
                  prefill_chunk=16)
    presults, pelapsed, pscheduler, pfailed = _session(paged, workload,
                                                       "smoke-paged")
    paged.close()
    failed += pfailed
    if presults != results:
        print("FAIL[paged]: token streams diverge from the contiguous "
              "session")
        failed += 1
    if paged.preemptions_total < 1:
        print("FAIL[paged]: the pool is sized for preemption but none "
              "fired")
        failed += 1
    print("gen smoke[%s, paged]: %d requests, %d tokens in %.2fs, %d "
          "pages, %d preemption(s) recovered losslessly, %d chunks, "
          "contiguous == paged"
          % (paged.device, len(workload), pscheduler.tokens_total,
             pelapsed, paged.blocks_total, paged.preemptions_total,
             paged.prefill_calls))

    # phase 3: an int8 engine (per-output-channel weights, the qmatmul
    # path) against its own float twin on an MLP-heavy config (TINY's
    # embedding would dominate the byte ratio): exact budgets, params at
    # most 0.35x the float twin's, and the calibration drift gate green
    # at the smoke's tolerance (a random-init model's logits are
    # near-uniform, so the default 1e-2 is too strict for it)
    cfg3 = dict(cfg, dim=64, mlp_ratio=4)
    fengine = build(cfg3)
    float_bytes = fengine.params_nbytes
    fresults, _fel, _fsch, ffailed = _session(fengine, workload,
                                              "smoke-int8-float")
    fengine.close()
    failed += ffailed
    int8 = build(cfg3)
    int8.quantize_int8(calibration_tokens=workload[0][0], tol=0.05)
    iresults, ielapsed, ischeduler, ifailed = _session(int8, workload,
                                                       "smoke-int8")
    failed += ifailed
    ratio = int8.params_nbytes / float(float_bytes)
    if ratio > 0.35:
        print("FAIL[int8]: params footprint %.3fx the float deploy "
              "(budget 0.35x)" % ratio)
        failed += 1
    if int8.describe()["quantize"] != "int8":
        print("FAIL[int8]: describe() does not surface the quant mode")
        failed += 1
    agree = sum(a == b for ft, it in zip(fresults, iresults)
                if ft and it for a, b in zip(ft, it))
    total = sum(len(t) for t in fresults if t)
    print("gen smoke[%s, int8]: %d requests, %d tokens in %.2fs, params "
          "%.3fx float, %d/%d tokens match the float session"
          % (int8.device, len(workload), ischeduler.tokens_total, ielapsed,
             ratio, agree, total))
    int8.close()

    # phase 4: a shared-prefix workload (every prompt extends one stem)
    # through a prefix-cached, n-gram-speculative paged engine must give
    # a plain paged engine's streams while (a) at least one page is
    # shared by two live slots, (b) eviction frees only pages no live
    # slot holds, and (c) the verify step accepts drafted tokens
    stem = (list(range(2, 10)) * 2)[:12]
    swork = [(stem + [11 + i] + stem[:4], 10) for i in range(slots)]
    plain4 = build(kv="paged", block_size=8)
    bresults, _bel, _bsch, bfailed = _session(plain4, swork,
                                              "smoke-spec-base")
    plain4.close()
    failed += bfailed
    spec4 = build(kv="paged", block_size=8, prefix_cache="on",
                  speculative="ngram", draft_k=4)
    pool4 = spec4._pool
    sresults, selapsed, sscheduler, sfailed = _session(spec4, swork,
                                                       "smoke-spec")
    failed += sfailed
    if sresults != bresults:
        print("FAIL[prefix+spec]: token streams diverge from the plain "
              "paged session")
        failed += 1
    if spec4.prefix_shared_pages_total < 1:
        print("FAIL[prefix+spec]: no admission adopted a cached page")
        failed += 1
    if spec4.spec_accepted_total < 1:
        print("FAIL[prefix+spec]: the verify step accepted no drafted "
              "token on a repetitive workload")
        failed += 1
    # co-residency: two fresh admissions of the cached stem hold at
    # least one common physical page (their last tokens lie in TINY's
    # vocabulary, which the JAX smoke's 90 and 91 do not: JAX clamps an
    # out-of-range index where torch raises)
    s1, _t1 = spec4.prefill(stem + [cfg["vocab"] - 2])
    s2, _t2 = spec4.prefill(stem + [cfg["vocab"] - 1])
    if not set(pool4.owned(s1)) & set(pool4.owned(s2)):
        print("FAIL[prefix+spec]: two live admissions of the same stem "
              "share no page")
        failed += 1
    # eviction safety: drain the cache against a full-pool deficit; every
    # page the two live slots hold must survive
    spec4._prefix.evict(pool4.blocks_total)
    for slot in (s1, s2):
        for bid in pool4.owned(slot):
            if pool4.refcount(bid) < 1:
                print("FAIL[prefix+spec]: eviction freed page %d out from "
                      "under live slot %d" % (bid, slot))
                failed += 1
        spec4.release_slot(slot)
    print("gen smoke[%s, prefix+spec]: %d requests, %d tokens in %.2fs, "
          "prefix hit rate %.0f%%, spec accept rate %.0f%% (%.2f "
          "tok/dispatch), plain == prefix+spec"
          % (spec4.device, len(swork), sscheduler.tokens_total, selapsed,
             100.0 * spec4.prefix_hit_rate(),
             100.0 * spec4.spec_accept_rate(),
             spec4.spec_tokens_per_dispatch()))
    spec4.close()
    return 1 if failed else 0


def main(argv=None):
    args = make_parser().parse_args(argv)
    if not args.smoke:
        make_parser().print_help()
        return 2
    return smoke(slots=args.slots, max_seq=args.max_seq,
                 requests=args.requests, seed=args.seed,
                 device=args.device)


if __name__ == "__main__":
    sys.exit(main())
