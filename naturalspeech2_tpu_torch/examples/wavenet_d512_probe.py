"""K1b's ``bf16_matmul`` option at the scaled config's WaveNet body, the
counterpart of the JAX package's `examples/wavenet_d512_probe.py`.

    python -m naturalspeech2_tpu_torch.examples.wavenet_d512_probe

At b16 × n1024 × d512, 4 stacks × 8 layers (the scaled config's WaveNet
body, which the JAX dispatch runs on its plain twin), it times a chain of
ITERS bodies with a data dependency (x ← body(x)·1e-2 + x) three ways:
the plain body ``wavenet_body_torch`` (the counterpart of
`wavenet_body_xla`), K1b with ``bf16_matmul`` (every product on bf16
operands, f32 accumulation) and K1b in f32 (split TF32); each the best of
three chains by CUDA events, in ms per body. Then the largest difference
of the ``bf16_matmul`` body from the plain one, relative to the plain
body's largest entry. It runs on the card unless ``--device cpu`` (the
plain versions of both K1b calls, at the host's speed).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from naturalspeech2_tpu_torch.ops.wavenet_kernel import wavenet_body_lanes, wavenet_body_torch

B, N, D, S, L = 16, 1024, 512, 4, 8
ITERS = 20


def make_args(device, seed: int = 0, shape=(B, N, D, S, L)) -> tuple:
    """The body's inputs at ``shape`` (b, n, d, S, L), N(0, 0.05²) as the
    JAX probe draws them, from a generator seeded with ``seed``."""
    b, n, d, s, l = shape
    g = torch.Generator(device).manual_seed(seed)
    shapes = [(b, n, d), (s, l, 3 * d, d), (s, l, d), (s, l, d, d), (s, l, d), (l, d, d), (l, d),
              (b, s, l, 2 * d)]
    return tuple(torch.randn(sh, generator=g, device=device) * 0.05 for sh in shapes)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def bench(name: str, fn, args, iters: int = ITERS) -> float:
    """ms per body of a chain of ``iters`` bodies, best of three (CUDA
    events on a card, the host clock on the CPU), after one untimed chain."""
    x0, *rest = args
    device = x0.device

    def chain():
        x = x0
        for _ in range(iters):
            x = fn(x, *rest) * 1e-2 + x
        return x

    with torch.no_grad():
        start = time.perf_counter()
        s = float(chain().sum())
        print(f"{name}: first chain {time.perf_counter() - start:.2f} s (sum {s:.3e})",
              flush=True)
        best = float("inf")
        for _ in range(3):
            if device.type == "cuda":
                begin, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                begin.record()
                chain()
                end.record()
                end.synchronize()
                ms = begin.elapsed_time(end)
            else:
                start = time.perf_counter()
                chain()
                ms = (time.perf_counter() - start) * 1e3
            best = min(best, ms / iters)
    print(f"{name}: {best:.3f} ms per body (best of 3, {iters}-body chain)", flush=True)
    return best


def run(device="cuda", shape=(B, N, D, S, L), iters: int = ITERS, seed: int = 0) -> dict:
    """The three chains' ms per body and the ``bf16_matmul`` body's largest
    difference from the plain one, relative to its largest entry."""
    args = make_args(device, seed, shape)
    out = {
        "plain_ms": bench("plain body (wavenet_body_torch)", wavenet_body_torch, args, iters),
        "bf16_matmul_ms": bench("K1b bf16_matmul",
                                lambda *a: wavenet_body_lanes(*a, bf16_matmul=True), args, iters),
        "f32_ms": bench("K1b f32 (split TF32)", wavenet_body_lanes, args, iters),
    }
    with torch.no_grad():
        ref = wavenet_body_torch(*args)
        got = wavenet_body_lanes(*args, bf16_matmul=True)
        _sync(device)
        out["max_rel_diff"] = ((got - ref).abs().max() / ref.abs().max()).item()
    print(f"K1b bf16_matmul vs plain body: max rel diff {out['max_rel_diff']:.2e}")
    print(f"summary ms per body: plain {out['plain_ms']:.3f}, bf16_matmul "
          f"{out['bf16_matmul_ms']:.3f}, f32 K1b {out['f32_ms']:.3f}", flush=True)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--iters", type=int, default=ITERS)
    args = parser.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("wavenet_d512_probe: no CUDA device (pass --device cpu for the plain "
                         "versions)")
    if torch.device(args.device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        print(torch.cuda.get_device_name(args.device), flush=True)
    print(json.dumps(run(args.device, iters=args.iters)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
