"""Serving CLI (port of ``repro.launch.serve``): batched greedy decoding
from a (trained or fresh) global model, the downlink side of the FL
story.  It serves ``paper_lm`` at its full config, or the ``SMOKE``
config of any other arch; the prompt is prefilled token by token through
the decode step, then decoded greedily.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch paper_lm \\
        --restore ckpt.npz --batch 4 --steps 32

``--restore`` reads a checkpoint of the port (``repro_torch.checkpoint``,
the reference's npz format, e.g. ``launch.train --checkpoint``).
``--device`` defaults to ``cuda`` and the run fails without a card unless
``--device cpu`` is given; on the card every step ends with
``torch.cuda.synchronize()`` before the clock is read.
"""
from __future__ import annotations

import argparse
import time


def _parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper_lm")
    ap.add_argument("--restore", default="")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--window", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def _stats(xs):
    """(mean, p95) of the step times, the reference's nearest rank."""
    if not xs:
        return 0.0, 0.0
    xs = sorted(xs)
    mean = sum(xs) / len(xs)
    p95 = xs[min(len(xs) - 1, int(0.95 * (len(xs) - 1) + 0.5))]
    return mean, p95


def main(argv=None):
    """Runs the CLI; returns the served sequences (B, prompt + steps)."""
    args = _parse(argv)

    import torch

    from repro_torch import checkpoint
    from repro_torch.configs.registry import get_arch, get_smoke
    from repro_torch.device import resolve_device
    from repro_torch.models.model import Model

    device = resolve_device(args.device)
    cfg = get_arch(args.arch) if args.arch == "paper_lm" \
        else get_smoke(args.arch)
    model = Model(cfg)
    params = model.init(0, device)
    if args.restore:
        params = checkpoint.restore(args.restore, params)

    B = args.batch
    g = torch.Generator(device=device)
    g.manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (B, args.prompt_len),
                           generator=g, device=device)
    enc_len = cfg.frontend_tokens if cfg.family == "encdec" else 0
    cache = model.init_cache(B, args.cache_len, enc_len=enc_len,
                             device=device)
    sync = torch.cuda.synchronize if device.type == "cuda" else \
        (lambda: None)

    # prefill token by token (the simple reference path), then greedy
    # decode; each step's wall clock feeds the telemetry below, the first
    # step (one-time set-up, the reference's compile) reported on its own
    tok = prompt[:, :1]
    out = [tok]
    prefill_s, decode_s = [], []
    for t in range(args.prompt_len + args.steps - 1):
        t0 = time.perf_counter()
        logits, cache = model.decode(params, cache, tok, t,
                                     window=args.window)
        sync()
        dt = time.perf_counter() - t0
        (prefill_s if t + 1 < args.prompt_len else decode_s).append(dt)
        if t + 1 < args.prompt_len:
            tok = prompt[:, t + 1:t + 2]
        else:
            tok = torch.argmax(logits[:, -1:], dim=-1)
        out.append(tok)
    seqs = torch.cat(out, dim=1).cpu()
    print(f"arch={cfg.name} served {B} seqs x {seqs.shape[1]} tokens")
    for b in range(min(B, 2)):
        print(f"  seq{b}:", " ".join(str(int(x)) for x in seqs[b][:40]))

    # ------------------------------------------------- decode telemetry
    compile_s = prefill_s[0] if prefill_s else \
        (decode_s[0] if decode_s else 0.0)
    warm_prefill = prefill_s[1:]
    warm_decode = decode_s if prefill_s else decode_s[1:]
    pf_mean, pf_p95 = _stats(warm_prefill)
    dc_mean, dc_p95 = _stats(warm_decode)
    toks = B * len(warm_decode)
    wall = sum(warm_decode)
    print(f"decode telemetry: compile+first_step={compile_s * 1e3:.1f}ms")
    print(f"  prefill: {len(warm_prefill)} steps "
          f"mean={pf_mean * 1e3:.2f}ms p95={pf_p95 * 1e3:.2f}ms "
          f"({sum(warm_prefill):.3f}s total)")
    print(f"  decode:  {len(warm_decode)} steps "
          f"mean={dc_mean * 1e3:.2f}ms p95={dc_p95 * 1e3:.2f}ms "
          f"({wall:.3f}s total)")
    if wall > 0:
        print(f"  throughput: {toks / wall:.1f} tokens/sec "
              f"(batch {B} x {len(warm_decode)} warm decode steps)")
    return seqs


if __name__ == "__main__":
    main()
