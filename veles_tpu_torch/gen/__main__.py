"""``python -m veles_tpu_torch.gen --smoke`` — the generative serving
gate of the port.

Mirrors phase 1 of ``python -m veles_tpu.gen --smoke``: a tiny
transformer engine is warmed (kernels built, every prefill bucket and
the decode step run once), then a seeded mixed-length
continuous-batching session must resolve every request with exactly its
budgeted token count.  It runs on the CUDA card unless ``--device cpu``
is given.  Exit code 0 on success; any violation prints the failure and
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

    engine = GenerativeEngine(
        TransformerGenModel(cfg, device=device), max_slots=slots,
        max_seq=max_seq, prefill_buckets=(8, 16, 32), seed=seed,
        device=device)
    engine.warmup()
    scheduler = GenerativeScheduler(engine, name="smoke")
    futures = [scheduler.submit(toks, max_new)
               for toks, max_new in workload]
    tic = time.perf_counter()
    scheduler.run_until_idle()
    elapsed = time.perf_counter() - tic
    failed = 0
    for future, (_toks, max_new) in zip(futures, workload):
        got = future.result(0) if future.done() else None
        if got is None:
            print("FAIL: request with budget %d never resolved" % max_new)
            failed += 1
        elif len(got) != max_new:
            print("FAIL: got %d tokens, budget %d" % (len(got), max_new))
            failed += 1
    tokens = scheduler.tokens_total
    print("gen smoke[%s]: %d requests, %d tokens in %.2fs (%.1f tok/s), "
          "batch fill %.0f%%, %d prefills, %d decode steps"
          % (engine.device, len(workload), tokens, elapsed,
             tokens / elapsed if elapsed else 0.0,
             100.0 * scheduler.batch_fill(), engine.prefill_calls,
             engine.decode_calls))
    engine.close()
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
