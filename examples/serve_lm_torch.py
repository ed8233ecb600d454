"""Batched LM serving on the PyTorch port, through ``repro_torch.api``'s
serve engine.

    PYTHONPATH=src python examples/serve_lm_torch.py [--arch zamba2_2p7b]
        [--device cuda|cpu]

The counterpart of ``examples/serve_lm.py``.  Submits more requests than
one batch holds to a continuous-batching ``ServeEngine``: requests queue at
admission, worker threads assemble dynamic batches up to ``--batch``, and
each request gets back only its own generated tokens.  SSM archs run the
same API; their prefill is a recurrent scan-in instead of attention
prefill.  ``--device`` defaults to ``cuda`` and raises where there is no
CUDA; ``--device cpu`` runs the plain PyTorch path.
"""
import argparse
import time

import numpy as np

from repro_torch.api import ARCH_IDS, ServeConfig, ServeEngine, get_config


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2_2p7b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)

    config = ServeConfig(arch=args.arch, smoke=True, max_batch=args.batch,
                         prompt_len=args.prompt_len, gen=args.gen,
                         device=args.device)
    rng = np.random.default_rng(0)
    with ServeEngine(config) as eng:
        vocab = get_config(args.arch, smoke=True).vocab
        prompts = [rng.integers(0, vocab, size=args.prompt_len)
                   .astype(np.int32) for _ in range(args.requests)]
        print(f"arch={args.arch}: {args.requests} requests, "
              f"batch ceiling {args.batch}")
        t0 = time.time()
        outs = eng.serve(prompts)
        dt = time.time() - t0
    total_tokens = args.requests * args.gen
    print(f"{total_tokens} tokens in {dt:.2f}s "
          f"({dt / total_tokens * 1e3:.1f} ms/token at batch {args.batch})")
    for b in range(min(args.requests, 3)):
        print(f"  req{b}: {outs[b][:10].tolist()}")


if __name__ == "__main__":
    main()
