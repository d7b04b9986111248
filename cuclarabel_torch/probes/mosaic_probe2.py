"""P2: the issue rate of a dependent elementwise chain against the size of
the operand, and the size at which values fall out of registers.  The
counterpart of the JAX package's `scripts/mosaic_probe2.py`, on the
hand-written kernel `probe_issue_kernel` of `csrc/probes.cu`.

    python3 -m cuclarabel_torch.probes.mosaic_probe2

On x, y of shape (R, 128) f32, in one block (one SM, as the reference
runs one program on one TPU core): `streams` streams
p_k = x * (1 + 0.5^(k+1)), each taking rounds(ops, streams) rounds of
r <- r * y + y, then o = ((p0 + p1) + p2) + p3; real_ops(ops, streams)
operations per element (511 at ops = 512 for one stream and for four).
The sweep is the reference's (scripts/mosaic_probe2.py:57-60): R = 8,
32, 128, 512, 1024, 2048 at one stream and R = 8, 32, 512 at four; each
line gives the device time per launch, the rate against one SM's unfused
f32 issue rate, and ptxas' registers and spills of that instantiation.
It runs on the CUDA device unless device="cpu" is passed; on the CPU
the plain versions run once each and nothing is timed.
"""

import sys

import torch

from .. import kernel_timing as kt
from ..device import resolve_device
from ..kkt import _build
from ..kkt.ldl import (LAUNCHES, PLAIN_CALLS, _check, _on_cpu, _raise_on,
                       _stream)
from .mosaic_probe import (F32, build_log, inputs, issue_row,
                           ptxas_by_template, ptxas_text, rate_text, scales)

OPS = 512
LANES = 128
# the (R, streams) of the reference's sweep: the kernel's instantiations
SWEEP = (tuple((R, 1) for R in (8, 32, 128, 512, 1024, 2048))
         + tuple((R, 4) for R in (8, 32, 512)))
REPS = 20
# one SM's 128 f32 lanes at the boost clock: the rate one block can reach
SM_F32_PER_S = 128 * kt.SM_CLOCK_HZ


def rounds(ops, streams):
    return (ops - streams - (streams - 1)) // (2 * streams)


def real_ops(ops, streams):
    """Operations per element: the scalings, the rounds and the sums."""
    return streams + (streams - 1) + 2 * streams * rounds(ops, streams)


def name(R, streams):
    return f"R{R}s{streams}"


def make_plain(x, y, ops, streams):
    PLAIN_CALLS.add(f"probe_issue/{name(x.shape[0], streams)}")
    parts = [x * s for s in scales(streams)]
    for _ in range(rounds(ops, streams)):
        parts = [p * y + y for p in parts]
    r = parts[0]
    for p in parts[1:]:
        r = r + p
    return r


def run(x, y, ops, streams):
    """The P2 function on x, y (R, 128) f32 with (R, streams) one of
    SWEEP: the kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if x.dim() != 2 or (x.shape[0], streams) not in SWEEP:
        raise ValueError(f"x must be (R, {LANES}) with (R, streams) one of "
                         f"{SWEEP}, got {tuple(x.shape)} and {streams}")
    if ops < 2 * streams - 1:
        raise ValueError(f"ops must be at least {2 * streams - 1}, got {ops}")
    R = x.shape[0]
    _check("x", x, (R, LANES), F32)
    _check("y", y, (R, LANES), F32)
    if _on_cpu(x, y):
        return make_plain(x, y, ops, streams)
    o = torch.empty_like(x)
    lib = _build.load()
    with torch.cuda.device(x.device):
        rc = lib.cc_probe_issue(x.data_ptr(), y.data_ptr(), o.data_ptr(), R,
                                streams, rounds(ops, streams), _stream(x))
    _raise_on(rc, "probe_issue")
    LAUNCHES.add(f"probe_issue/{name(R, streams)}", x.device)
    return o


def bench(R, streams, device=None, ptxas=None):
    """One (R, streams) on the reference's constant inputs: its device ms
    per launch (None on the CPU, where the plain version runs once), the
    bound of the card and of one SM, the rate and its share of one SM's
    issue rate, and ptxas' registers and spills where `ptxas` (from
    ptxas_by_template) has them."""
    dev = resolve_device(device)
    x, y = inputs((R, LANES), device=dev)
    ops = real_ops(OPS, streams) * R * LANES
    nbytes = 3 * 4 * R * LANES
    bms, by = kt.bound_ms(nbytes, ops, kt.PEAK_F32_PER_S)
    key = name(R, streams)

    def fn():
        return run(x, y, OPS, streams)

    row = {"name": key, "R": R, "streams": streams, "bound_ms": bms,
           "bound_by": by, "sm_bound_ms": ops / SM_F32_PER_S * 1e3,
           "gb": nbytes / 1e9, "gop": ops / 1e9,
           "ptxas": (ptxas or {}).get((R, streams))}
    if dev.type == "cuda":
        row["ms"] = kt.device_ms({(key, "probe_issue_kernel"): fn}, REPS)[
            (key, "probe_issue_kernel")]
        row["sm_clock"] = kt.card_line("clocks.sm,clocks.max.sm")
    else:
        fn()
        row["ms"] = None
    return issue_row(row, ops, SM_F32_PER_S)


def row_line(card, row):
    return (f"[{card}] R={row['R']:5d} s={row['streams']}: "
            f"{rate_text(row, 'one SM')}; bound {row['sm_bound_ms']:.4f} ms "
            f"on one SM, {row['bound_ms']:.6f} ms on the card "
            f"({row['bound_by']}); {ptxas_text(row['ptxas'])}")


def sweep(device=None):
    """The reference's sweep; prints one line per (R, streams), with
    ptxas' registers and spills from the build's log.  Returns the
    rows."""
    dev = resolve_device(device)
    card = kt.card_line() if dev.type == "cuda" else "cpu"
    ptxas = ptxas_by_template(build_log(dev), "probe_issue_kernel")
    print(f"mosaic_probe2 ops={OPS} on {card}; one SM's unfused f32 issue "
          f"rate {SM_F32_PER_S / 1e9:.1f} G op/s (128 lanes x "
          f"{kt.SM_CLOCK_HZ / 1e9:.2f} GHz)", flush=True)
    rows = []
    for R, streams in SWEEP:
        rows.append(bench(R, streams, dev, ptxas))
        print(row_line(card, rows[-1]), flush=True)
    return rows


def main():
    sweep()
    return 0


if __name__ == "__main__":
    sys.exit(main())
