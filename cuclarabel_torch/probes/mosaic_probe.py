"""P1: what one elementwise op costs on a large operand, and whether the
number of elements a thread carries at once changes it.  The counterpart
of the JAX package's `scripts/mosaic_probe.py`, on the hand-written
kernel `probe_chain_kernel` of `csrc/probes.cu`.

    python3 -m cuclarabel_torch.probes.mosaic_probe [N] [B]

On x, y of shape (N, N, B) f32, lane-major (default N = 83, B = 4096),
one round is r <- r * y + y, a multiply and an add, each rounded:

- A: o = 48 rounds applied to x;
- B: o = x, except o[3:, 3:] = 48 rounds applied to x[3:, 3:] with
  y[3:, 3:];
- C: four streams p_k = x * (1 + 0.5^(k+1)) of 11 rounds each, then
  o = (p0 + p1) + (p2 + p3): 95 operations per element (the reference
  prints 96);
- D, rows = 8, 16, 32: A's function.  The reference's TPU row chunk
  becomes the number of elements a thread carries through the chain at
  once; the output equals A's bit for bit.

Each variant prints its device time per launch (torch.profiler), its
rate and its share of the card's unfused f32 issue rate, beside its bound
and the SM clock the run saw.  It runs on the CUDA device unless
device="cpu" is passed; on the CPU the plain versions run once each and
nothing is timed.
"""

import re
import sys

import numpy as np
import torch

from .. import kernel_timing as kt
from ..device import resolve_device
from ..kkt import _build
from ..kkt.ldl import (LAUNCHES, PLAIN_CALLS, _check, _on_cpu, _raise_on,
                       _stream)

OPS = 96
ROUNDS = OPS // 2
WIN = 3
ILP_STREAMS = 4
ILP_ROUNDS = (OPS - ILP_STREAMS - (ILP_STREAMS - 1)) // (2 * ILP_STREAMS)
CHUNK_ROWS = (8, 16, 32)
# the kernel's variant id: A and D run one body, D with several elements
# per thread
KERNEL_VARIANT = {"A": 0, "B": 1, "C": 2, "D": 0}
# the reference's order and labels (scripts/mosaic_probe.py:100-104)
SWEEP = (("A", None, "A dep chain, full tile     "),
         ("B", None, "B dep chain, offset-3 win  "),
         ("C", None, "C 4-stream ILP, full tile  "),
         *(("D", r, f"D dep chain, {r:2d}-row chunks") for r in CHUNK_ROWS))
REPS = 20
F32 = torch.float32
MAX_ELEMENTS = 2 ** 31  # the kernel indexes in 32 bits


def name(variant, rows=None):
    """The variant's name in the launch counters and the sweep: "A", "B",
    "C", "D8", "D16", "D32"."""
    return variant if rows is None else f"{variant}{rows}"


def scales(streams):
    """1 + 0.5^(k+1) for each stream k: exact in f32."""
    return [1.0 + 0.5 ** (k + 1) for k in range(streams)]


def rounds_of(r, y, n):
    for _ in range(n):
        r = r * y + y
    return r


def inputs(shape, seed=None, device="cpu"):
    """x, y f32 of `shape`: the reference's constants 0.5 and 0.25 (seed
    None), or x uniform in (-1, 1) and y in (-0.9, 0.9) from numpy's
    generator with `seed`."""
    if seed is None:
        x, y = np.full(shape, 0.5), np.full(shape, 0.25)
    else:
        rng = np.random.default_rng(seed)
        x, y = rng.uniform(-1, 1, shape), rng.uniform(-0.9, 0.9, shape)
    return (torch.tensor(x, dtype=F32, device=device),
            torch.tensor(y, dtype=F32, device=device))


def _validate(variant, rows):
    if variant not in KERNEL_VARIANT:
        raise ValueError(f"variant must be one of {sorted(KERNEL_VARIANT)}, "
                         f"got {variant!r}")
    if variant == "D" and rows not in CHUNK_ROWS:
        raise ValueError(f"D takes rows in {CHUNK_ROWS}, got {rows!r}")
    if variant != "D" and rows is not None:
        raise ValueError(f"only D takes rows, got {variant!r} with {rows!r}")


def chain_plain(x, y, variant, rows=None):
    _validate(variant, rows)
    PLAIN_CALLS.add(f"probe_chain/{name(variant, rows)}")
    if variant == "B":
        o = x.clone()
        o[WIN:, WIN:] = rounds_of(x[WIN:, WIN:], y[WIN:, WIN:], ROUNDS)
        return o
    if variant == "C":
        p = [rounds_of(x * s, y, ILP_ROUNDS) for s in scales(ILP_STREAMS)]
        return (p[0] + p[1]) + (p[2] + p[3])
    return rounds_of(x, y, ROUNDS)


def chain(x, y, variant, rows=None):
    """The P1 function of `variant` ("A", "B", "C", or "D" with rows 8,
    16 or 32) on x, y (N, N, B) f32: the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    _validate(variant, rows)
    if x.dim() != 3 or x.shape[0] != x.shape[1] or x.numel() == 0:
        raise ValueError(f"x must be (N, N, B) with N, B >= 1, got "
                         f"{tuple(x.shape)}")
    if x.numel() >= MAX_ELEMENTS:
        raise ValueError(f"x has {x.numel()} elements; the kernel takes "
                         f"fewer than {MAX_ELEMENTS}")
    _check("x", x, x.shape, F32)
    _check("y", y, x.shape, F32)
    if _on_cpu(x, y):
        return chain_plain(x, y, variant, rows)
    N, _, B = x.shape
    o = torch.empty_like(x)
    lib = _build.load()
    with torch.cuda.device(x.device):
        rc = lib.cc_probe_chain(
            x.data_ptr(), y.data_ptr(), o.data_ptr(), N, B,
            KERNEL_VARIANT[variant], rows or 1,
            ILP_ROUNDS if variant == "C" else ROUNDS, _stream(x))
    _raise_on(rc, "probe_chain")
    LAUNCHES.add(f"probe_chain/{name(variant, rows)}", x.device)
    return o


def work(variant, N, B):
    """(bytes, operations) the variant does at (N, N, B): x read and o
    written whole, y read where the chain uses it; the operations
    executed (C: 95 per element)."""
    E = N * N * B
    if variant == "B":
        W = max(N - WIN, 0) ** 2 * B
        return 4 * (2 * E + W), OPS * W
    if variant == "C":
        ops = ILP_STREAMS + 2 * ILP_STREAMS * ILP_ROUNDS + ILP_STREAMS - 1
        return 12 * E, ops * E
    return 12 * E, OPS * E


def ptxas_by_template(log, kernel):
    """{(first, second template argument): ptxas' registers and spills}
    of `kernel`'s instantiations in a build's log."""
    pat = re.compile(kernel + r"ILi(\d+)ELi(\d+)E")
    out = {}
    for kname, rep in _build.ptxas_report(log).items():
        if m := pat.search(kname):
            out[(int(m.group(1)), int(m.group(2)))] = rep
    return out


def ptxas_text(rep):
    if not rep:
        return "ptxas report not in this build's log"
    return (f"ptxas {rep.get('registers')} registers, "
            f"{rep.get('stack_frame')} B stack frame, "
            f"{rep.get('spill_stores')} B spill stores, "
            f"{rep.get('spill_loads')} B spill loads")


def build_log(dev):
    """The log of the build this call makes or finds, for the ptxas
    report (none on the CPU)."""
    return _build.build()["log"] if dev.type == "cuda" else ""


def issue_row(row, ops, peak):
    """Add to `row` the rate (op/s) and its share of `peak` where `row`
    has a device time."""
    if row["ms"] is not None:
        row["op_per_s"] = ops / row["ms"] * 1e3
        row["issue_pct"] = 100.0 * row["op_per_s"] / peak
    return row


def bench(x, y, variant, rows=None, ptxas=None):
    """One variant on x, y (N, N, B): its device ms per launch (None on
    the CPU, where the plain version runs once), bound, rate and share of
    the card's f32 issue rate, the SM clocks nvidia-smi reads just after
    the timing, and ptxas' registers and spills where `ptxas` (from
    ptxas_by_template) has them."""
    N, _, B = x.shape
    nbytes, ops = work(variant, N, B)
    bms, by = kt.bound_ms(nbytes, ops, kt.PEAK_F32_PER_S)
    key = name(variant, rows)

    def fn():
        return chain(x, y, variant, rows)

    row = {"name": key, "N": N, "B": B, "bound_ms": bms, "bound_by": by,
           "gb": nbytes / 1e9, "gop": ops / 1e9,
           "ptxas": (ptxas or {}).get((KERNEL_VARIANT[variant], rows or 1))}
    if x.device.type == "cuda":
        row["ms"] = kt.device_ms({(key, "probe_chain_kernel"): fn}, REPS)[
            (key, "probe_chain_kernel")]
        row["sm_clock"] = kt.card_line("clocks.sm,clocks.max.sm")
    else:
        fn()
        row["ms"] = None
    return issue_row(row, ops, kt.PEAK_F32_PER_S)


def rate_text(row, peak_name):
    if row["ms"] is None:
        return "device not measured (CPU: plain version)"
    return (f"device {row['ms']:.4f} ms per launch, "
            f"{row['op_per_s'] / 1e12:.3f} T op/s = {row['issue_pct']:.1f}% "
            f"of {peak_name}, SM clock {row['sm_clock']} (now, max)")


def stream_ms(x, y):
    """Device ms per launch of torch.add(x, y, out=o) on a card: the bytes
    of A with one operation per element, the rate at which this card
    streams x and y in and o out; the yardstick of whether a variant
    overlaps its chain with its memory traffic."""
    o = torch.empty_like(x)
    key = ("add", "elementwise_kernel")
    return kt.device_ms({key: lambda: torch.add(x, y, out=o)}, REPS)[key]


def row_line(card, label, row):
    floor = ("" if row.get("stream_ms") is None else
             f", {row['ms'] / row['stream_ms']:.2f}x torch.add's "
             f"{row['stream_ms']:.4f} ms on the same bytes")
    return (f"[{card}] {label}: {rate_text(row, 'the f32 issue rate')}; "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
            f"{row['gb']:.4f} GB, {row['gop']:.4f} G op){floor}; "
            f"{ptxas_text(row['ptxas'])}")


def peak_text():
    return (f"unfused f32 issue rate {kt.PEAK_F32_PER_S / 1e12:.1f} T op/s "
            f"({kt.SMS} SMs x 128 lanes x {kt.SM_CLOCK_HZ / 1e9:.2f} GHz)")


def sweep(N=83, B=4096, device=None):
    """Every variant at (N, N, B) on the reference's constant inputs, in
    the reference's order, beside torch.add's time on the same bytes;
    prints one line each, with ptxas' registers and spills from the
    build's log.  Returns the rows."""
    dev = resolve_device(device)
    card = kt.card_line() if dev.type == "cuda" else "cpu"
    ptxas = ptxas_by_template(build_log(dev), "probe_chain_kernel")
    print(f"mosaic_probe N={N} B={B} on {card}; {peak_text()}", flush=True)
    x, y = inputs((N, N, B), device=dev)
    floor = stream_ms(x, y) if dev.type == "cuda" else None
    rows = []
    for variant, r, label in SWEEP:
        rows.append(bench(x, y, variant, r, ptxas=ptxas))
        rows[-1]["stream_ms"] = floor
        print(row_line(card, label, rows[-1]), flush=True)
    return rows


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    N = int(argv[0]) if len(argv) > 0 else 83
    B = int(argv[1]) if len(argv) > 1 else 4096
    sweep(N, B)
    return 0


if __name__ == "__main__":
    sys.exit(main())
