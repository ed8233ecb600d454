"""Quickstart on the PyTorch port: build an assigned architecture, train a
few steps, decode.

    PYTHONPATH=src python examples/quickstart_torch.py [--arch llama3p2_3b]
        [--device cuda|cpu]

The counterpart of ``examples/quickstart.py`` through ``repro_torch.api``.
``--device`` defaults to ``cuda`` and raises where there is no CUDA;
``--device cpu`` runs the plain PyTorch path.
"""
import argparse

import torch

from repro_torch.api import (ARCH_IDS, DataConfig, SyntheticLMStream,
                             adamw_init, build_model, get_config,
                             make_local_mesh, make_train_step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3p2_3b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=15)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)

    # 1. every assigned architecture is a config away (smoke = CPU-sized)
    cfg = get_config(args.arch, smoke=True)
    model = build_model(cfg, device=args.device)
    print(f"arch={cfg.name} family={cfg.family} "
          f"params(full-config)={get_config(args.arch).n_params/1e9:.1f}B")

    # 2. train a few steps on the synthetic pipeline, on a one-rank mesh
    mesh = make_local_mesh(1, args.device)
    model.init(torch.Generator(device=model.device).manual_seed(0))
    step = make_train_step(model, mesh, lr=3e-3)
    opt = adamw_init(model.params())
    stream = SyntheticLMStream(DataConfig(
        vocab=cfg.vocab, global_batch=8, seq_len=64,
        frames_dim=cfg.d_model if cfg.family == "encdec" else 0,
        frames_len=cfg.enc_frames))
    for s in range(args.steps):
        opt, m = step(opt, stream.batch_at(s))
        if s % 5 == 0 or s == args.steps - 1:
            print(f"  step {s}: loss={float(m['loss']):.4f}")

    # 3. decode a few tokens with the KV/SSM cache
    cache = model.init_cache(2, 32)
    tok = torch.zeros((2,), dtype=torch.int32, device=model.device)
    out = []
    with torch.no_grad():
        for _ in range(8):
            cache, logits = model.decode_step(cache, tok)
            tok = torch.argmax(logits, -1).to(torch.int32)
            out.append(int(tok[0]))
    print("decoded:", out)


if __name__ == "__main__":
    main()
