"""A/B: formulations of the INT4 edge score, and the shipped kernel.

The port of ``benchmarks/ab_int4_layout.py``. Every row computes the
squared L2 distance of B queries to the R cached INT4 codes of each
query's current node, ``sum_d (q_d - s * c_d)^2`` [B, R], from tables of
``CAP`` rows:

  cur     interleaved bytes u8[CAP, R, D/2] (dim 2i in the low nibble,
          2i+1 in the high one: the host and disk format), decoded as
          ``ops/quantize.decode_int4_np`` decodes them, then (q - v)^2;
  planar  planar words i32[CAP, R, D/8] of the same codes (nibble slot s
          of word w holds dim s * D/8 + w), unpacked by shifts and masks,
          then (q - v)^2;
  dot     planar words, dot form |q|^2 - 2 s (q . c) + s^2 |c|^2 from
          per-slot partial dots, |c|^2 recomputed from the nibbles;
  dotn2   the dot form with s^2 |c|^2 read from a precomputed f32[CAP, R]
          table;
  kernel  the shipped kernel (``kernels/int4_frontier.py``,
          ``csrc/int4_frontier.cu``) on the planar words: it returns the
          L2 distance, so its row is squared.

``make_tables`` fills the tables on the device in chunks of random codes
and scales in [0.5, 1.5); the planar words are the same codes re-encoded
(``planar_from_interleaved``). ``check`` holds every row against
``decode_int4_np``'s distances of one random set of rows before any
timing: ``cur``, ``planar`` and ``kernel`` to rtol 1e-5. The dot forms
compute a distance of ~3,000 as a difference of terms of the same size
(|q|^2 ~ 128, s^2 |c|^2 ~ 2,700), so their f32 rounding is relative to
those terms, not to the result: their error relative to max(|d|, 1) is
printed and held under ``DOT_RTOL`` = 1e-4.

``time_rows`` times each row as a dependent chain (the next rows are this
round's argmin, as hops are) with ``utils/cuda_timing.slope_ms``: the
wall slope between ``ITERS_LO`` and ``ITERS_HI`` iterations, and the card
time an iteration.

The JAX script's ``cur`` row handed the interleaved bytes to the planar
``decode_int4`` and so decoded other values; this port decodes them as
bytes.

Run alone:

    python -m duckdb_lm_diskann_tpu_torch.experiments.ab_int4_layout \\
        [--device cuda]

(B = 1,024, R = 64, D = 128, 2^19 rows: ~4.5 GB of tables).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..common.types import MetricType
from ..kernels.int4_frontier import int4_frontier_scores
from ..ops.quantize import decode_int4_np
from ..utils.cuda_timing import slope_ms

B, R, D = 1024, 64, 128
CAP_LOG2 = 19
ITERS_LO, ITERS_HI = 64, 256
FLOAT_RTOL = 1e-5
DOT_RTOL = 1e-4


def _sign4(x):
    """4-bit two's-complement values of nibbles held in int32."""
    return (x ^ 8) - 8


def planar_from_interleaved(u8):
    """Interleaved bytes u8[..., D/2] -> planar words i32[..., D/8] of the
    same codes (``ops/quantize.i4_planar_from_packed_np`` on the device):
    byte j of chunk s (bytes s*DW/2 .. (s+1)*DW/2) holds dims s*DW + 2j
    (low) and s*DW + 2j + 1 (high), which become nibble slot s of words 2j
    and 2j + 1."""
    dw = u8.shape[-1] // 4
    u = u8.to(torch.int32).reshape(*u8.shape[:-1], 8, dw // 2)
    lo, hi = u & 0xF, u >> 4
    even = torch.zeros_like(lo[..., 0, :])
    odd = torch.zeros_like(even)
    for s in range(8):
        even |= lo[..., s, :] << (4 * s)
        odd |= hi[..., s, :] << (4 * s)
    return torch.stack([even, odd], dim=-1).reshape(*u8.shape[:-1], dw)


def unpack_planar(w):
    """Planar words i32[..., DW] -> signed codes f32[..., 8 * DW]."""
    return torch.cat([_sign4((w >> (4 * s)) & 0xF) for s in range(8)],
                     dim=-1).float()


def make_tables(device, cap_log2=CAP_LOG2, b=B, r=R, d=D,
                chunk_log2=16) -> dict:
    """The interleaved and planar tables of the same random codes, their
    scales, the s^2 |c|^2 table and ``b`` random queries, on ``device``."""
    dev = torch.device(device)
    cap = 1 << cap_log2
    ch = min(1 << chunk_log2, cap)
    gen = torch.Generator(device=dev).manual_seed(0)
    t = {
        "u8": torch.empty((cap, r, d // 2), dtype=torch.uint8, device=dev),
        "w": torch.empty((cap, r, d // 8), dtype=torch.int32, device=dev),
        "sc": torch.empty((cap, r), dtype=torch.float32, device=dev),
        "n2": torch.empty((cap, r), dtype=torch.float32, device=dev),
    }
    for off in range(0, cap, ch):
        u8 = torch.randint(0, 256, (ch, r, d // 2), dtype=torch.uint8,
                           device=dev, generator=gen)
        w = planar_from_interleaved(u8)
        sc = torch.rand((ch, r), device=dev, generator=gen) + 0.5
        c = unpack_planar(w)
        t["u8"][off : off + ch] = u8
        t["w"][off : off + ch] = w
        t["sc"][off : off + ch] = sc
        t["n2"][off : off + ch] = (c * c).sum(-1) * sc * sc
    q = torch.randn((b, d), device=dev, generator=gen)
    t["q"] = q
    t["qc"] = q.reshape(b, 8, d // 8)  # the query's planar chunks
    t["q2"] = (q * q).sum(-1)
    t["cap"] = cap
    return t


def score_cur(cur, t):
    u = t["u8"][cur].to(torch.int32)  # [B, R, D/2]
    lo, hi = _sign4(u & 0xF), _sign4(u >> 4)
    v = torch.stack([lo, hi], dim=-1).flatten(-2).float()
    v = v * t["sc"][cur][..., None]
    diff = t["q"][:, None, :] - v
    return (diff * diff).sum(-1)


def score_planar(cur, t):
    v = unpack_planar(t["w"][cur]) * t["sc"][cur][..., None]
    diff = t["q"][:, None, :] - v
    return (diff * diff).sum(-1)


def _partial_dots(cur, t):
    """(q . c, |c|^2) [B, R] summed over the eight nibble slots."""
    w = t["w"][cur]
    dot = n2 = 0.0
    for s in range(8):
        c = _sign4((w >> (4 * s)) & 0xF).float()  # [B, R, DW]
        dot = dot + torch.einsum("bw,brw->br", t["qc"][:, s], c)
        n2 = n2 + (c * c).sum(-1)
    return dot, n2


def score_dot(cur, t):
    s = t["sc"][cur]
    dot, n2 = _partial_dots(cur, t)
    return t["q2"][:, None] - 2.0 * s * dot + s * s * n2


def score_dotn2(cur, t):
    dot, _ = _partial_dots(cur, t)
    return t["q2"][:, None] - 2.0 * t["sc"][cur] * dot + t["n2"][cur]


def score_kernel(cur, t):
    d = int4_frontier_scores(cur, t["q"], t["w"], t["sc"],
                             metric=MetricType.L2)
    return d * d


SCORES = {"cur": score_cur, "planar": score_planar, "dot": score_dot,
          "dotn2": score_dotn2, "kernel": score_kernel}


def reference(cur, t) -> np.ndarray:
    """f64 squared distances of ``decode_int4_np`` of the rows' bytes."""
    idx = cur.long()
    v = decode_int4_np(t["u8"][idx].cpu().numpy(), t["sc"][idx].cpu().numpy(),
                       t["q"].shape[1]).astype(np.float64)
    diff = t["q"].cpu().numpy().astype(np.float64)[:, None, :] - v
    return (diff * diff).sum(-1)


def check(t) -> dict:
    """Every row on one random set of rows against ``reference``: max
    error relative to max(|ref|, 1), held to ``FLOAT_RTOL`` (``cur``,
    ``planar``, ``kernel``) or ``DOT_RTOL`` (the dot forms); raises
    otherwise."""
    gen = torch.Generator(device=t["q"].device).manual_seed(1)
    cur = torch.randint(0, t["cap"], (t["q"].shape[0],), dtype=torch.int32,
                        device=t["q"].device, generator=gen)
    ref = reference(cur, t)
    errs = {}
    for name, fn in SCORES.items():
        got = fn(cur, t).double().cpu().numpy()
        errs[name] = float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref),
                                                                  1.0)))
        tol = DOT_RTOL if name.startswith("dot") else FLOAT_RTOL
        if not errs[name] <= tol:
            raise AssertionError(f"ab_int4_layout {name}: max relative error "
                                 f"{errs[name]:.3g} > {tol}")
    return errs


def time_rows(t, iters=(ITERS_LO, ITERS_HI), reps=4, out=print) -> dict:
    """``slope_ms`` of each row's dependent chain: {row: {wall_ms,
    card_ms}} per iteration (card None off the card)."""
    cap, b, dev = t["cap"], t["q"].shape[0], t["q"].device
    gen = torch.Generator(device=dev).manual_seed(2)
    states = [(torch.randint(0, cap, (b,), dtype=torch.int32, device=dev,
                             generator=gen),
               torch.zeros((), device=dev)) for _ in range(3)]
    res = {}
    for name, fn in SCORES.items():
        def step(state, i, fn=fn):
            cur, acc = state
            d = fn(cur, t)
            nxt = (cur + d.argmin(-1).to(torch.int32) + 1) % cap
            return nxt, acc + d.sum()

        wall, card = slope_ms(step, states, *iters, reps=reps)
        res[name] = {"wall_ms": wall, "card_ms": card}
        out(f"{name:7s}: wall {wall * 1e3:9.1f} us/iter, card "
            + ("not measured" if card is None else f"{card * 1e3:9.1f} us/iter"))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(f"{torch.cuda.get_device_name(dev)}; torch {torch.__version__}",
              flush=True)
    t = make_tables(dev)
    errs = check(t)
    for name, err in errs.items():
        print(f"agree {name:7s}: max rel err {err:.2e}", flush=True)
    times = time_rows(t, out=lambda s: print(s, flush=True))
    print(json.dumps({"ab_int4_layout": {"max_rel_err": errs,
                                         "times": times}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
