"""``python -m veles_tpu_torch.gen --smoke`` — the generative serving
gate of the port.

Mirrors phases 1 and 2 of ``python -m veles_tpu.gen --smoke``: a tiny
transformer engine is warmed (kernels built, every prefill bucket and
the decode step run once), then a seeded mixed-length
continuous-batching session must resolve every request with exactly its
budgeted token count.  Then the same workload runs through a PAGED
engine whose pool is too small for the mix, with chunked prefill: it
must preempt at least once and still give the contiguous session's
token streams.  It runs on the CUDA card unless ``--device cpu`` is
given.  Exit code 0 on success; any violation prints the failure and
exits 1.
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
                    "session -> exact token budgets).")
    parser.add_argument("--smoke", action="store_true",
                        help="run the smoke gate")
    parser.add_argument("--slots", type=int, default=4)
    parser.add_argument("--max-seq", type=int, default=48)
    parser.add_argument("--requests", type=int, default=16)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    return parser


def smoke(slots=4, max_seq=48, requests=16, seed=0, device=None):
    from veles_tpu_torch.gen import (GenerativeEngine,
                                     GenerativeScheduler,
                                     TransformerGenModel)
    from veles_tpu_torch.samples.transformer import TINY

    cfg = dict(TINY, seq_len=max(64, max_seq))
    rng = numpy.random.default_rng(seed)
    workload = [
        (rng.integers(0, cfg["vocab"],
                      int(rng.integers(1, 30))).tolist(),
         int(rng.integers(1, 14)))
        for _ in range(requests)]

    def session(label, **kw):
        engine = GenerativeEngine(
            TransformerGenModel(cfg, device=device), max_slots=slots,
            max_seq=max_seq, prefill_buckets=(8, 16, 32), seed=seed,
            device=device, **kw)
        engine.warmup()
        scheduler = GenerativeScheduler(engine, name=label)
        futures = [scheduler.submit(toks, max_new)
                   for toks, max_new in workload]
        tic = time.perf_counter()
        scheduler.run_until_idle()
        elapsed = time.perf_counter() - tic
        results = [f.result(0) if f.done() else None for f in futures]
        engine.close()
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
        return engine, scheduler, results, elapsed, failed

    # phase 1: the contiguous session
    engine, scheduler, results, elapsed, failed = session("smoke")
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
    paged, pscheduler, presults, pelapsed, pfailed = session(
        "smoke-paged", kv="paged", block_size=8,
        num_blocks=max_seq // 8 + 1, prefill_chunk=16)
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
